"""Electus: generalized read filtering against N reference k-mer sets
(``gossamer_tpu/classify/electus.py``).

Engine parity with ``src/ElectApp.cc:78-805``: each reference contributes
a bit in a per-k-mer mask; a read matches when the popcount of the OR of
its k-mers' masks reaches ``ref-threshold``.  (The reference's paired
loop compares the raw mask instead of its popcount for the second mate,
``ElectApp.cc:448``; like the JAX package, the port applies the documented
popcount semantics to both.)

Masks are numpy uint64 on the host (up to 64 references, bit 63
included).  :class:`DeviceRefMasks` computes them on the torch device, at
any k up to 62: the xenome classify engine resolves two annotated classes
a pass, so N references run in ceil(N / 2) passes.  :func:`read_masks` is
the host version, kept as the tests' oracle.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from ..core import kmer as K
from ..graph.kmer_set import KmerSet
from ..io.readers import Read
from .annotated_set import AnnotatedKmerSet, _as_sorted_unique
from .xenome import DeviceClassifier

SEP = np.uint8(255)


class RefMaskSet:
    """Union k-mer set + per-k-mer reference bitmask (up to 64 refs)."""

    def __init__(self, union: KmerSet, mask: np.ndarray, n_refs: int):
        self.union = union
        self.mask = mask
        self.n_refs = n_refs

    @classmethod
    def build(cls, sets: list[KmerSet]) -> "RefMaskSet":
        if len(sets) > 64:
            raise ValueError("electus supports at most 64 reference sets")
        k = sets[0].k
        lo = np.concatenate([s.lo for s in sets])
        hi = np.concatenate([s.hi for s in sets])
        lo, hi = _as_sorted_unique(lo, hi)
        union = KmerSet(k, lo, hi)
        mask = np.zeros(len(lo), dtype=np.uint64)
        for i, s in enumerate(sets):
            hit, _ = s.access_and_rank(lo, hi)
            mask |= np.where(hit, np.uint64(1 << i), np.uint64(0))
        return cls(union, mask, len(sets))


def read_masks(codes_list: list[np.ndarray], refs: RefMaskSet) -> np.ndarray:
    """OR of reference masks over each read's k-mers, on the host.  Each
    read is looked up on its own: a window holding an invalid base is
    skipped and the windows after it stay with their read."""
    k = refs.union.k
    n = len(codes_list)
    out = np.zeros(n, dtype=np.uint64)
    if n == 0:
        return out
    parts = []
    for c in codes_list:
        parts.append(c)
        parts.append(np.array([SEP], dtype=np.uint8))
    flat = np.concatenate(parts)
    if len(flat) < k:
        return out
    read_id = np.repeat(np.arange(n), [len(c) + 1 for c in codes_list])
    n_win = len(flat) - k + 1
    win_read = read_id[:n_win]
    lo = np.zeros(n_win, dtype=np.uint64)
    hi = np.zeros(n_win, dtype=np.uint64)
    valid = np.ones(n_win, dtype=bool)
    for j in range(k):
        b = flat[j : j + n_win]
        valid &= b < 4
        hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
        lo = (lo << np.uint64(2)) | (b.astype(np.uint64) & np.uint64(3))
    lo, hi, win_read = lo[valid], hi[valid], win_read[valid]
    nlo, nhi, _ = K.normalize(lo, hi, k)
    hit, r = refs.union.access_and_rank(nlo, nhi)
    r = r[hit]
    win_read = win_read[hit]
    np.bitwise_or.at(out, win_read, refs.mask[r])
    return out


class DeviceRefMasks:
    """The references of a :class:`RefMaskSet` held on ``device`` pair by
    pair: pass p annotates the union of references (2p, 2p + 1) with (lhs,
    rhs) membership bits as a :class:`.xenome.DeviceClassifier` (narrow E
    tensor for k <= 30, the wide lanes above), and the per-read blrg bits
    map back to per-reference hits.  An odd count leaves the last pass's
    second class empty."""

    def __init__(self, refs: RefMaskSet, device: torch.device):
        self.n_refs = refs.n_refs
        k = refs.union.k
        mask, lo, hi = refs.mask, refs.union.lo, refs.union.hi
        self.passes = []
        for p in range(0, refs.n_refs, 2):
            bit_a = np.uint64(1 << p)
            in_a = (mask & bit_a) != 0
            if p + 1 < refs.n_refs:
                bit_b = np.uint64(1 << (p + 1))
                in_b = (mask & bit_b) != 0
            else:
                bit_b = np.uint64(0)
                in_b = np.zeros_like(in_a)
            sel = in_a | in_b
            pair = AnnotatedKmerSet(KmerSet(k, lo[sel], hi[sel]), in_a[sel],
                                    in_b[sel])
            self.passes.append((bit_a, bit_b, DeviceClassifier([pair], device)))

    def masks(self, codes_list: list[np.ndarray]) -> np.ndarray:
        out = np.zeros(len(codes_list), dtype=np.uint64)
        for bit_a, bit_b, clf in self.passes:
            blrg = clf.blrg(codes_list)
            # cls = lhs<<1|rhs: A-hit -> cls 2 or 3; B-hit -> cls 1 or 3
            out |= np.where((blrg & 0b1100) != 0, bit_a, np.uint64(0))
            out |= np.where((blrg & 0b1010) != 0, bit_b, np.uint64(0))
        return out


def read_masks_device(codes_list: list[np.ndarray], refs: RefMaskSet,
                      device: torch.device) -> np.ndarray:
    """Device formulation of :func:`read_masks` (one-off: callers with many
    batches keep a :class:`DeviceRefMasks`)."""
    return DeviceRefMasks(refs, device).masks(codes_list)


def popcount64(x: np.ndarray) -> np.ndarray:
    return np.bitwise_count(x) if hasattr(np, "bitwise_count") else np.array(
        [bin(int(v)).count("1") for v in x]
    )


def filter_reads(
    reads: Iterable[Read], refs: RefMaskSet, threshold: int, *,
    device: torch.device, batch: int = 4096,
) -> Iterator[tuple[Read, bool]]:
    dev_refs = DeviceRefMasks(refs, device)
    buf: list[Read] = []
    for rd in reads:
        buf.append(rd)
        if len(buf) >= batch:
            yield from _flush(buf, dev_refs, threshold)
            buf = []
    if buf:
        yield from _flush(buf, dev_refs, threshold)


def _flush(buf, dev_refs: DeviceRefMasks, threshold):
    masks = dev_refs.masks([K.encode_bases(r.seq) for r in buf])
    match = popcount64(masks) >= threshold
    for rd, m in zip(buf, match):
        yield rd, bool(m)


def filter_pairs(
    pairs: Iterable[tuple[Read, Read]], refs: RefMaskSet, threshold: int, *,
    device: torch.device, batch: int = 4096,
) -> Iterator[tuple[Read, Read, bool]]:
    dev_refs = DeviceRefMasks(refs, device)
    buf: list[tuple[Read, Read]] = []
    for pr in pairs:
        buf.append(pr)
        if len(buf) >= batch:
            yield from _flush_pairs(buf, dev_refs, threshold)
            buf = []
    if buf:
        yield from _flush_pairs(buf, dev_refs, threshold)


def _flush_pairs(buf, dev_refs: DeviceRefMasks, threshold):
    masks = dev_refs.masks([K.encode_bases(r.seq) for pr in buf for r in pr])
    match = popcount64(masks[0::2] | masks[1::2]) >= threshold
    for (a, b), m in zip(buf, match):
        yield a, b, bool(m)
