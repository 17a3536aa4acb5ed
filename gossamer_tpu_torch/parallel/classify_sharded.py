"""Read classification with the annotated set sharded over a mesh.

Counterpart of ``gossamer_tpu/parallel/classify_sharded.py``.  The xenome
classifier's scale story on one device is multipass: slice an index larger
than memory and OR the per-slice class bitmaps (``classify/xenome.py``
``ann_slices``, reference ``src/GossCmdGroupReads.cc:381-468``).  On a
mesh the same decomposition runs in space: shard ``s`` holds the s-th
slice of the sorted set, every shard joins the reads against its slice
with :func:`..classify.device.classify_batch` (its sort-join merges through
:func:`..ops.merge.merge_sorted`, the merge kernel on CUDA tensors), and
the per-shard blrg bitmaps are ORed, bit-exact with one device.

Read ids come from each batch's read starts, as on one device: an ``N``
inside a read does not start the next read (the JAX sharded classifiers
count it as a separator).
"""

from __future__ import annotations

import numpy as np
import torch

from ..classify.device import SENT, _batches, _flat_batch, _gather, classify_batch
from . import mesh as M


def shard_set(set_E: np.ndarray, n: int) -> np.ndarray:
    """Split the sorted E plane into n contiguous slices, padded to equal
    length with the port's sentinel 2^63 - 1 -> (n, m) uint64.  Padding
    matches no query (query keys are below 2^62) and sorts last."""
    m = max(1, -(-len(set_E) // n))
    out = np.full((n, m), SENT, np.uint64)
    for s in range(n):
        part = set_E[s * m : (s + 1) * m]
        out[s, : len(part)] = part
    return out


def _put_set(mesh: M.Mesh, set_E: np.ndarray) -> list[torch.Tensor]:
    """This process's slices of the set, each on its shard's device."""
    return M.put(mesh, shard_set(np.asarray(set_E, np.uint64),
                                 mesh.size).view(np.int64))


def _block(buf: list[np.ndarray], k: int, window: int, max_reads: int):
    """A batch of reads -> (codes padded to ``window + k - 1``, read starts
    padded to ``max_reads`` with ``window``, past every window).  An empty
    batch gets one start at 0: every window is invalid, so no read id
    matters."""
    if not buf:
        flat = np.full(window + k - 1, 255, np.uint8)
        starts = np.zeros(1, np.int64)
    else:
        flat, starts = _flat_batch(buf, k, window)
    padded = np.full(max_reads, window, np.int64)
    padded[: len(starts)] = starts
    return flat, padded


class ShardedClassifier:
    """The call shape of ``classify_codes_device`` with the set
    sharded across the mesh.  Reads are replicated: every shard classifies
    each batch against its slice, and one ``all_gather`` ORs the bitmaps."""

    def __init__(self, mesh: M.Mesh, set_E: np.ndarray, k: int,
                 window: int = 1 << 20):
        self.mesh = mesh
        self.k = k
        self.window = window
        # a fixed read capacity, so every batch has one shape; the fill
        # loop flushes on read count so the bound always holds
        self.max_reads = max(256, window // 32)
        self.shards = _put_set(mesh, set_E)

    def _step(self, flat: np.ndarray, starts: np.ndarray) -> torch.Tensor:
        """One batch on every shard -> the ORed blrg on the home device."""
        codes = torch.from_numpy(flat)
        st = torch.from_numpy(starts)
        blrg = [classify_batch(codes.to(d), st.to(d), s, self.k,
                               self.max_reads)
                for s, d in zip(self.shards, self.mesh.devices)]
        every = M.all_gather(self.mesh, blrg)[0]  # (n, max_reads)
        out = every[0]
        for i in range(1, self.mesh.size):
            out = out | every[i]
        return out

    def classify_codes(self, codes_list) -> np.ndarray:
        out_dev, out_counts = [], []
        for buf in _batches(codes_list, self.window, self.max_reads):
            out_dev.append(self._step(*_block(buf, self.k, self.window,
                                              self.max_reads)))
            out_counts.append(len(buf))
        return _gather(out_dev, out_counts)


class RingClassifier:
    """Ring read rotation (SURVEY.md section 5): every shard keeps its set
    slice resident and classifies its own block of reads, then the blocks,
    with their accumulated blrg bitmaps, rotate around the ring
    (``ppermute``) until each has met every slice; a last hop carries each
    block's bitmap home.  N blocks are in flight a cycle instead of one
    broadcast block, the data-parallel counterpart of the reference's
    serial multipass (``src/GossCmdGroupReads.cc:417-429``).  Read order
    is kept: block i is the i-th window of the stream."""

    def __init__(self, mesh: M.Mesh, set_E: np.ndarray, k: int,
                 window: int = 1 << 20):
        self.mesh = mesh
        self.k = k
        self.window = window
        self.max_reads = max(256, window // 32)
        self.shards = _put_set(mesh, set_E)

    def _cycle(self, blocks) -> list[torch.Tensor]:
        """This process's blocks of one cycle -> their blrg, per shard."""
        n = self.mesh.size
        perm = [(i, (i + 1) % n) for i in range(n)]
        devs = self.mesh.devices
        codes = [torch.from_numpy(f).to(d) for (f, _), d in zip(blocks, devs)]
        starts = [torch.from_numpy(s).to(d) for (_, s), d in zip(blocks, devs)]

        def classify():
            return [classify_batch(c, st, s, self.k, self.max_reads)
                    for c, st, s in zip(codes, starts, self.shards)]

        acc = classify()
        for _ in range(n - 1):
            codes = M.ppermute(self.mesh, codes, perm)
            starts = M.ppermute(self.mesh, starts, perm)
            acc = M.ppermute(self.mesh, acc, perm)
            acc = [a | b for a, b in zip(acc, classify())]
        return M.ppermute(self.mesh, acc, perm)

    def classify_codes(self, codes_list) -> np.ndarray:
        n = self.mesh.size
        bufs = list(_batches(codes_list, self.window, self.max_reads))
        while len(bufs) % n:  # pad the last cycle with empty blocks
            bufs.append([])
        out_dev, out_counts = [], []
        for c0 in range(0, len(bufs), n):
            mine = self.mesh.local(bufs[c0 : c0 + n])
            rows = self._cycle([_block(b, self.k, self.window,
                                       self.max_reads) for b in mine])
            every = M.all_gather(self.mesh, rows)[0]  # block i on row i
            for i, b in enumerate(bufs[c0 : c0 + n]):
                if b:
                    out_dev.append(every[i])
                    out_counts.append(len(b))
        return _gather(out_dev, out_counts)
