"""Batched k-mer counting engine on one torch device (narrow keys).

Counterpart of ``gossamer_tpu/ops/engine.py`` ``SpectrumEngine`` for
packed input.  Each flush k-merizes a batch of packed chunks, canonicalizes,
masks invalid windows to the sentinel, sorts the batch (``torch.sort``)
and folds it into the packed device spectrum with
:func:`..fold.merge_fold`, the Hopper merge-fold kernel on CUDA tensors.

The spectrum is ``(keys int64[cap], counts int64[cap])``: distinct keys
ascending, then sentinels.  Flushes do not synchronize the host: each
flush's ``live`` stays a device tensor, and the host reads one only when
the bound ``checked live + lanes inserted since`` could pass ``cap``.
A spectrum outgrowing the device cap is pulled to host RAM as a sorted run
(the analog of the reference's RAM->disk spill,
``src/GossCmdBuildKmerSet.tcc:246-328``) and the runs are merged at
``finish()``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .canon import MODES, canonicalize
from .fold import SENT, merge_fold, merge_fold_reference
from .kmerize import kmerize_packed


def narrow_keys(rho: int) -> bool:
    return 2 * rho <= 62


def batch_step_packed(words, inval, s_keys, s_counts, rho: int, mode: str,
                      cap: int, C: int, fold: bool = True):
    """Fold one batch of packed chunks into the spectrum.

    ``words``: int32 view of uint32[B, C//16 + 2]; ``inval``: uint8[B, V].
    Returns ``(keys[cap], counts[cap], live)``.  ``fold=True`` sorts the
    batch and runs :func:`merge_fold`; ``fold=False`` runs the plain
    version on the unsorted batch (the JAX engine's XLA sort path).
    """
    keys, valid = kmerize_packed(words, inval, rho, C)
    valid = valid.reshape(-1)
    keys = torch.where(valid, canonicalize(keys.reshape(-1), rho, mode), SENT)
    if fold:
        keys = torch.sort(keys).values
        return merge_fold(s_keys, s_counts, keys,
                          (keys != SENT).to(torch.int64), cap)
    return merge_fold_reference(s_keys, s_counts, keys,
                                valid.to(torch.int64), cap)


def empty_spec(cap: int, device: torch.device):
    """All-sentinel spectrum of ``cap`` lanes."""
    return (torch.full((cap,), SENT, dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int64, device=device))


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":  # pinned, so the copy does not block the host
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_live(live: torch.Tensor) -> int:
    n = int(live)  # device sync
    if n < 0:
        raise RuntimeError("merge_fold inputs were not ascending (live = -1)")
    return n


class SpectrumEngine:
    """Host driver: stream packed chunks, keep a packed device spectrum.

    ``mode``: 'value' (min-by-value classes, for symmetric expansion),
    'ref' (the reference's FNV-order classes, for k-mer sets) or 'plain'
    (forward strand as is).  ``cap`` bounds the device-resident
    distinct-key working set; the device cap starts at the size of the
    first flush and grows by spilling and doubling.  With ``spill=False``
    overflowing ``cap`` raises at ``finish()``.  ``fold=False`` folds
    with the plain version instead of :func:`merge_fold`.
    """

    def __init__(self, rho: int, mode: str, chunk: int, device: torch.device,
                 batch: int = 8, cap: int = 1 << 23, spill: bool = True,
                 fold: bool = True, on_spill=None):
        if not narrow_keys(rho):
            raise ValueError(f"engine requires 2*rho <= 62 (rho={rho})")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.rho = rho
        self.mode = mode
        self.chunk = chunk
        self.device = torch.device(device)
        self.batch = batch
        self.fold = fold
        self.req_cap = cap
        self.cap = 0
        self.spill_enabled = spill
        self.on_spill = on_spill  # callback(run_index, run_len)
        self.spills = 0
        self.buf: list[tuple[np.ndarray, np.ndarray]] = []
        self.spec = None
        self.live_scalars: list[torch.Tensor] = []
        self.host_runs: list[tuple] = []
        # overflow bound: live <= checked_live + lanes inserted since
        self._checked_live = 0
        self._lanes_since_check = 0
        self.phases: dict[str, float] = {}  # seconds of the last finish

    def add_chunk_packed(self, words: np.ndarray, inval: np.ndarray) -> None:
        """Queue one packed chunk (see ``io.stream.pack_chunk``)."""
        self.buf.append((words, inval))
        if len(self.buf) >= self.batch:
            self._flush()

    def start_from(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        """Continue from a packed spectrum, e.g. one carried over from the
        JAX engine with ``convert.spectrum_from_planes``.  Its length
        becomes the device cap."""
        self.spec = (keys.to(self.device).contiguous(),
                     counts.to(self.device).contiguous())
        self.cap = keys.numel()
        self.req_cap = max(self.req_cap, self.cap)
        live = (self.spec[0] != SENT).sum()
        self.live_scalars = [live]
        self._checked_live = _read_live(live)
        self._lanes_since_check = 0

    def _flush(self, final: bool = False) -> None:
        """Fold the queued chunks.  The final flush skips the spill
        schedule: no batch follows it, and ``finish()`` checks every
        ``live`` against the cap."""
        if not self.buf:
            return
        words = _to_device(np.stack([w for w, _ in self.buf]).view(np.int32),
                           self.device)
        inval = _to_device(np.stack([v for _, v in self.buf]), self.device)
        batch_lanes = len(self.buf) * self.chunk
        self.buf = []
        want = min(self.req_cap, max(1 << 14, 2 * batch_lanes))
        if want > self.cap:
            if self.spec is not None and self.live_scalars:
                self._spill_to_host()
            self.cap = want
            self.spec = empty_spec(self.cap, self.device)
        elif self.spec is None:
            self.spec = empty_spec(self.cap, self.device)
        keys, counts, live = batch_step_packed(
            words, inval, *self.spec, self.rho, self.mode, self.cap,
            self.chunk, self.fold)
        self.spec = (keys, counts)
        self.live_scalars.append(live)
        if final or not self.spill_enabled:
            return  # overflow is caught by the max-live check at finish()
        self._lanes_since_check += batch_lanes
        bound = self._checked_live + self._lanes_since_check
        next_lanes = self.batch * self.chunk
        if bound + next_lanes > self.cap:
            self._checked_live = _read_live(live)
            self._lanes_since_check = 0
            if self._checked_live > self.cap:
                raise RuntimeError(
                    f"distinct keys of one batch ({self._checked_live}) "
                    f"exceeded cap ({self.cap}); raise --spectrum-cap "
                    f"or lower --buffer-size")
            if self._checked_live + next_lanes > self.cap:
                self._spill_to_host()
                if self.cap < self.req_cap:  # restart wider
                    self.cap = min(self.req_cap, 2 * self.cap)
                    self.spec = empty_spec(self.cap, self.device)

    def _spill_to_host(self) -> None:
        """Pull the packed device spectrum to host RAM and restart.  Runs
        are held varint-delta encoded (``src/EdgeAndCount.hh:78-112``),
        raw when the native codec is unavailable."""
        from ..io.native import NativeUnavailable, encode_spill_run

        lo, _hi, c = self._finish_planes(self.spec)
        try:
            self.host_runs.append(("eac", encode_spill_run(lo, c), len(lo)))
        except NativeUnavailable:
            self.host_runs.append(("raw", lo, c))
        self.spills += 1
        if self.on_spill is not None:
            self.on_spill(self.spills, len(lo))
        self.spec = empty_spec(self.cap, self.device)
        self.live_scalars = []
        self._checked_live = 0
        self._lanes_since_check = 0

    def _merged_host(self):
        """finish() result via host-RAM merge of the spilled runs."""
        from ..io.native import decode_spill_run

        runs = [decode_spill_run(a, b) if kind == "eac" else (a, b)
                for kind, a, b in self.host_runs]
        lo, _hi, c = self._finish_planes(self.spec)
        runs.append((lo, c))
        while len(runs) > 1:
            runs.sort(key=lambda r: len(r[0]))
            (alo, ac), (blo, bc) = runs.pop(0), runs.pop(0)
            lo = np.concatenate([alo, blo])
            c = np.concatenate([ac, bc])
            order = np.argsort(lo, kind="stable")
            lo, c = lo[order], c[order]
            new = np.ones(len(lo), bool)
            new[1:] = lo[1:] != lo[:-1]
            idx = np.cumsum(new) - 1
            out = np.zeros(int(idx[-1]) + 1 if len(idx) else 0, c.dtype)
            np.add.at(out, idx, c)
            runs.append((lo[new], out))
        lo, c = runs[0]
        return lo, np.zeros_like(lo), c

    def finish(self):
        """-> (lo u64, hi u64 zeros, counts i64), packed ascending."""
        self._flush(final=True)
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        if self.host_runs:
            return self._merged_host()
        return self._finish_planes(self.spec)

    def finish_expanded(self):
        """Finish and expand to the symmetric fwd+rc edge spectrum on the
        host (build-graph semantics; mode 'value')."""
        from .count import _expand_symmetric

        t0 = time.perf_counter()
        self._flush(final=True)
        _sync(self.device)
        self.phases = {"flush_tail": time.perf_counter() - t0}
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        t0 = time.perf_counter()
        if self.host_runs:
            lo, _hi, c = self._merged_host()
        else:
            lo, _hi, c = self._finish_planes(self.spec)
        self.phases["pull"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = _expand_symmetric(lo, c, self.rho)
        self.phases["expand"] = time.perf_counter() - t0
        return out

    def _finish_planes(self, spec):
        n_out = _read_live(self.live_scalars[-1]) if self.live_scalars else 0
        self._check_live()
        keys, counts = spec
        lo = keys[:n_out].cpu().numpy().view(np.uint64)
        return lo, np.zeros_like(lo), counts[:n_out].cpu().numpy()

    def _check_live(self) -> None:
        if not self.live_scalars:
            return
        lives = torch.stack(self.live_scalars).cpu()
        if int(lives.min()) < 0:
            raise RuntimeError("merge_fold inputs were not ascending "
                               "(live = -1)")
        max_live = int(lives.max())
        if max_live > self.cap:
            raise RuntimeError(
                f"spectrum working set ({max_live}) exceeded cap "
                f"({self.cap}); rerun with a larger --spectrum-cap")
