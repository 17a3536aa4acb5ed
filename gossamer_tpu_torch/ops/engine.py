"""Batched k-mer counting engine on one torch device (narrow keys).

Counterpart of ``gossamer_tpu/ops/engine.py`` ``SpectrumEngine``.  One
engine takes one input route: raw code chunks (:meth:`SpectrumEngine.
add_chunk`), packed chunks with an invalid-code bitmap
(:meth:`~SpectrumEngine.add_chunk_packed`, what both readers feed), with
the sparse positions of the invalid codes
(:meth:`~SpectrumEngine.add_chunk_packed_sparse`) or with fixed-length
reads (:meth:`~SpectrumEngine.add_chunk_packed_periodic`).  Each flush
k-merizes a batch of chunks, canonicalizes, masks invalid windows to the
sentinel, sorts the batch (``torch.sort``) and folds it into the packed
device spectrum with :func:`..fold.merge_fold`, the Hopper merge-fold
kernel on CUDA tensors.

The spectrum is ``(keys int64[cap], counts int64[cap])``: distinct keys
ascending, then sentinels.  Flushes do not synchronize the host: each
flush's ``live`` stays a device tensor, and the host reads one only when
the bound ``checked live + lanes inserted since`` could pass ``cap``.
A spectrum outgrowing the device cap is pulled to host RAM as a sorted run
(the analog of the reference's RAM->disk spill,
``src/GossCmdBuildKmerSet.tcc:246-328``).

The finish runs on the device when its lanes fit the cap: the live
lanes plus the spilled runs' for :meth:`SpectrumEngine.finish`, twice that
for :meth:`~SpectrumEngine.finish_expanded`, whose output holds up to
twice the keys.  The side is chosen once a finish.  On the device the runs
are merged two at a time, smallest first, with :func:`..merge.merge_sorted`
(the Hopper merge kernel on CUDA tensors) and a sum of the adjacent pairs
of equal keys in int64; the symmetric expansion of build-graph merges the
spectrum with its sorted reverse complements the same way, palindromes
left out of the second run and their counts doubled in int64.  Otherwise
the same steps run on the host in numpy.  :attr:`SpectrumEngine.
finish_log` says where each step ran.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .canon import MODES, canonicalize, rc
from .fold import SENT, merge_fold, merge_fold_reference
from .kmerize import (kmerize_packed, kmerize_packed_periodic,
                      kmerize_packed_sparse, kmerize_planes)
from .merge import merge_sorted


def narrow_keys(rho: int) -> bool:
    return 2 * rho <= 62


# ------------------------------------------------------------ batch steps
def _fold_batch(keys, valid, s_keys, s_counts, rho: int, mode: str, cap: int,
                fold: bool):
    """The tail of every batch step: canonicalize, mask invalid windows to
    the sentinel, fold into the spectrum -> ``(keys[cap], counts[cap],
    live)``.  ``fold=True`` sorts the batch and runs :func:`merge_fold`;
    ``fold=False`` runs its plain version on the unsorted batch (the JAX
    engine's XLA sort path)."""
    valid = valid.reshape(-1)
    keys = torch.where(valid, canonicalize(keys.reshape(-1), rho, mode), SENT)
    if fold:
        keys = torch.sort(keys).values
        return merge_fold(s_keys, s_counts, keys,
                          (keys != SENT).to(torch.int64), cap)
    return merge_fold_reference(s_keys, s_counts, keys,
                                valid.to(torch.int64), cap)


def batch_step(codes, s_keys, s_counts, rho: int, mode: str, cap: int):
    """Fold one batch of raw code chunks (uint8[B, C + rho - 1]) into the
    spectrum with the plain fold."""
    return _fold_batch(*kmerize_planes(codes, rho), s_keys, s_counts, rho,
                       mode, cap, False)


def batch_step_fold(codes, s_keys, s_counts, rho: int, mode: str, cap: int):
    """:func:`batch_step` through :func:`merge_fold` on the sorted batch."""
    return _fold_batch(*kmerize_planes(codes, rho), s_keys, s_counts, rho,
                       mode, cap, True)


def batch_step_packed(words, inval, s_keys, s_counts, rho: int, mode: str,
                      cap: int, C: int, fold: bool = True):
    """Fold one batch of packed chunks into the spectrum.

    ``words``: int32 view of uint32[B, C//16 + 2]; ``inval``: uint8[B, V].
    Returns ``(keys[cap], counts[cap], live)``.
    """
    return _fold_batch(*kmerize_packed(words, inval, rho, C), s_keys,
                       s_counts, rho, mode, cap, fold)


def batch_step_packed_sparse(words, invpos, nwin, s_keys, s_counts, rho: int,
                             mode: str, cap: int, C: int):
    """:func:`batch_step` over sparse-invalidity packed chunks (``invpos``:
    int32 view of uint32[B, P]; ``nwin``: int32[B])."""
    return _fold_batch(*kmerize_packed_sparse(words, invpos, nwin, rho, C),
                       s_keys, s_counts, rho, mode, cap, False)


def batch_step_fold_packed_sparse(words, invpos, nwin, s_keys, s_counts,
                                  rho: int, mode: str, cap: int, C: int):
    """:func:`batch_step_packed_sparse` through :func:`merge_fold`."""
    return _fold_batch(*kmerize_packed_sparse(words, invpos, nwin, rho, C),
                       s_keys, s_counts, rho, mode, cap, True)


def batch_step_packed_periodic(words, ph, bound, nwin, s_keys, s_counts,
                               rho: int, mode: str, cap: int, C: int, T: int):
    """:func:`batch_step` over periodic packed chunks (``ph``, ``bound``,
    ``nwin``: int32[B]; reads of period ``T``)."""
    return _fold_batch(
        *kmerize_packed_periodic(words, ph, bound, nwin, rho, C, T),
        s_keys, s_counts, rho, mode, cap, False)


def batch_step_fold_packed_periodic(words, ph, bound, nwin, s_keys, s_counts,
                                    rho: int, mode: str, cap: int, C: int,
                                    T: int):
    """:func:`batch_step_packed_periodic` through :func:`merge_fold`."""
    return _fold_batch(
        *kmerize_packed_periodic(words, ph, bound, nwin, rho, C, T),
        s_keys, s_counts, rho, mode, cap, True)


def batch_steps_fold_packed_scan(words, inval, s_keys, s_counts, rho: int,
                                 mode: str, cap: int, C: int):
    """F batches of packed chunks (``words`` [F, B, W], ``inval`` [F, B, V])
    folded one after another -> ``(keys, counts, max_live)``: the max of
    the F lives, the quantity the overflow check reads, or -1 when any fold
    saw its input out of order (a max alone would hide it)."""
    lives = []
    for f in range(words.shape[0]):
        s_keys, s_counts, live = batch_step_packed(
            words[f], inval[f], s_keys, s_counts, rho, mode, cap, C)
        lives.append(live)
    lives = torch.stack(lives)
    return s_keys, s_counts, torch.where((lives < 0).any(), -1, lives.max())


# --------------------------------------------------------------- spectra
def expand_step(keys, counts, rho: int):
    """Canonical-class spectrum of ``cap`` lanes (ascending, sentinel tail)
    -> the symmetric fwd+rc spectrum in ``2 * cap`` lanes, ``(keys, counts,
    live)``: the reverse complements sorted with their counts, then
    :func:`merge_fold` with the spectrum.  A palindrome sums to twice its
    count, mod 2^32 as every fold count."""
    r = torch.where(keys == SENT, SENT, rc(keys, rho))
    r, order = torch.sort(r)
    return merge_fold(keys, counts, r, counts[order], 2 * keys.numel())


def spectra_merge(a_keys, a_counts, b_keys, b_counts, cap: int):
    """Merge two packed spectra, counts of equal keys summed mod 2^32 ->
    ``(keys[cap], counts[cap], live)`` (:func:`merge_fold`)."""
    return merge_fold(a_keys, a_counts, b_keys, b_counts, cap)


def merge_runs(a_keys, a_counts, b_keys, b_counts):
    """Two ascending runs of distinct keys (int64 counts) -> their union,
    the counts of a key in both summed in int64: :func:`merge_sorted`, then
    the sum of each pair of equal adjacent lanes (at most two lanes share a
    key, one from each run)."""
    keys, counts = merge_sorted(a_keys, a_counts, b_keys, b_counts)
    dup = keys[1:] == keys[:-1]
    counts[:-1] += torch.where(dup, counts[1:], 0)
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = ~dup
    return keys[keep], counts[keep]


def expand_symmetric(keys, counts, rho: int):
    """Canonical classes (ascending distinct keys, int64 counts) -> the
    symmetric fwd+rc spectrum, as ``ops.count._expand_symmetric`` gives it
    on the host: a palindrome once with its count doubled in int64, every
    other key and its reverse complement with the same count.  The reverse
    complements of the non-palindromes are disjoint from the classes, so
    :func:`merge_sorted` of the two runs is exact."""
    r = rc(keys, rho)
    pal = r == keys
    r_keys, order = torch.sort(r[~pal])
    return merge_sorted(keys, torch.where(pal, 2 * counts, counts), r_keys,
                        counts[~pal][order])


def _host_merge(a_lo, a_c, b_lo, b_c):
    """:func:`merge_runs` of two host runs ``(lo u64, c i64)`` in numpy."""
    lo = np.concatenate([a_lo, b_lo])
    c = np.concatenate([a_c, b_c])
    order = np.argsort(lo, kind="stable")
    lo, c = lo[order], c[order]
    new = np.ones(len(lo), bool)
    new[1:] = lo[1:] != lo[:-1]
    idx = np.cumsum(new) - 1
    out = np.zeros(int(idx[-1]) + 1 if len(idx) else 0, c.dtype)
    np.add.at(out, idx, c)
    return lo[new], out


def empty_spec(cap: int, device: torch.device):
    """All-sentinel spectrum of ``cap`` lanes."""
    return (torch.full((cap,), SENT, dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int64, device=device))


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":  # pinned, so the copy does not block the host
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _stack(arrays, device: torch.device) -> torch.Tensor:
    """Host arrays of one shape -> one device tensor; uint32 travels as its
    int32 view (every consumer masks to 32 bits or holds values < 2^31)."""
    out = np.stack(arrays)
    return _to_device(out.view(np.int32) if out.dtype == np.uint32 else out,
                      device)


def _run_to_device(lo: np.ndarray, c: np.ndarray, device: torch.device):
    return (_to_device(np.ascontiguousarray(lo).view(np.int64), device),
            _to_device(np.ascontiguousarray(c, np.int64), device))


def _run_to_host(keys: torch.Tensor, counts: torch.Tensor):
    return keys.cpu().numpy().view(np.uint64), counts.cpu().numpy()


def _merge_all(runs: list, merge, log: list, side: str):
    """Merge ``runs`` two at a time, smallest first (as the JAX engine's
    ``_merged_host``) with ``merge`` -> one run; each merge logged."""
    while len(runs) > 1:
        runs.sort(key=lambda r: len(r[0]))
        a, b = runs.pop(0), runs.pop(0)
        log.append(f"merge of {len(a[0]):,} + {len(b[0]):,} keys {side}")
        runs.append(merge(*a, *b))
        del a, b  # the inputs go before the next merge
    return runs[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_live(live: torch.Tensor) -> int:
    n = int(live)  # device sync
    if n < 0:
        raise RuntimeError("merge_fold inputs were not ascending (live = -1)")
    return n


class SpectrumEngine:
    """Host driver: stream chunks, keep a packed device spectrum.

    ``mode``: 'value' (min-by-value classes, for symmetric expansion),
    'ref' (the reference's FNV-order classes, for k-mer sets) or 'plain'
    (forward strand as is).  ``cap`` bounds the device-resident
    distinct-key working set; the device cap starts at the size of the
    first flush and grows by spilling and doubling.  With ``spill=False``
    overflowing ``cap`` raises at ``finish()``.  ``fold=False`` folds
    with the plain version instead of :func:`merge_fold`.

    The arguments of the JAX engine keep their names: ``first_batch``
    chunks make the first flush (default ``batch``); ``period`` is the
    read period (read length + 1) of the periodic route.  ``scan_groups``
    is accepted and kept (1 with ``spill=True``, as in JAX) but changes
    nothing: the JAX engine folds that many batches in one compiled
    program to save launches, and here every batch is its own flush
    (:func:`batch_steps_fold_packed_scan` is the ported group step).
    """

    def __init__(self, rho: int, mode: str, chunk: int, device: torch.device,
                 batch: int = 8, cap: int = 1 << 23, spill: bool = True,
                 fold: bool = True, on_spill=None, scan_groups: int = 1,
                 period: int = 0, first_batch: int | None = None):
        if not narrow_keys(rho):
            raise ValueError(f"engine requires 2*rho <= 62 (rho={rho})")
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.rho = rho
        self.mode = mode
        self.chunk = chunk
        self.device = torch.device(device)
        self.batch = batch
        self.first_batch = first_batch if first_batch else batch
        self.scan_groups = 1 if spill else max(1, scan_groups)
        self.fold = fold
        self.req_cap = cap
        self.cap = 0
        self.spill_enabled = spill
        self.on_spill = on_spill  # callback(run_index, run_len)
        self.spills = 0
        # the input route, set by the first chunk: raw (packed False) or
        # packed with a bitmap, sparse positions or a period
        self.packed: bool | None = None
        self.sparse = False
        self.periodic = False
        self.period = int(period)
        self.buf: list = []
        self.spec = None
        self.live_scalars: list[torch.Tensor] = []
        self.host_runs: list[tuple] = []
        # overflow bound: live <= checked_live + lanes inserted since
        self._checked_live = 0
        self._lanes_since_check = 0
        self._nflush = 0
        self.phases: dict[str, float] = {}  # seconds of the last finish
        self.finish_log: list[str] = []  # where each finish step ran

    def _route(self, packed: bool, sparse: bool = False,
               periodic: bool = False) -> None:
        if self.packed is None:
            self.packed, self.sparse, self.periodic = packed, sparse, periodic
        elif (self.packed, self.sparse, self.periodic) != (packed, sparse,
                                                           periodic):
            raise ValueError("one engine takes one input route: raw, packed, "
                             "sparse or periodic chunks")

    def _trigger(self) -> int:
        """Chunks that trigger a flush (``first_batch`` for the first)."""
        return self.first_batch if self._nflush == 0 else self.batch

    def _queue(self, item) -> None:
        self.buf.append(item)
        if len(self.buf) >= self._trigger():
            self._flush()

    def add_chunk(self, codes: np.ndarray) -> None:
        """Queue one raw code chunk (uint8[chunk + rho - 1], see
        ``io.stream.flat_code_chunks``)."""
        self._route(False)
        if len(codes) != self.chunk + self.rho - 1:
            raise ValueError(f"chunk of {len(codes)} codes, expected "
                             f"{self.chunk + self.rho - 1}")
        self._queue(codes)

    def add_chunk_packed(self, words: np.ndarray, inval: np.ndarray) -> None:
        """Queue one packed chunk (see ``io.stream.pack_chunk``)."""
        self._route(True)
        self._queue((words, inval))

    def add_chunk_packed_sparse(self, words: np.ndarray, invpos: np.ndarray,
                                nwin: int) -> None:
        """Queue one sparse-invalidity packed chunk (see
        ``io.stream.pack_chunk_sparse``)."""
        self._route(True, sparse=True)
        self._queue((words, invpos, np.int32(nwin)))

    def add_chunk_packed_periodic(self, words: np.ndarray, ph: int,
                                  bound: int, nwin: int) -> None:
        """Queue one periodic packed chunk of fixed-length reads (see
        :func:`..kmerize.kmerize_packed_periodic`); needs ``period``."""
        if self.period <= 0:
            raise ValueError("periodic chunks need the engine's period "
                             "(read length + 1)")
        self._route(True, periodic=True)
        self._queue((words, np.int32(ph), np.int32(bound), np.int32(nwin)))

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

    def _step(self, stack):
        """The batch step of the engine's route and fold."""
        args = (*self.spec, self.rho, self.mode, self.cap)
        if self.periodic:
            step = (batch_step_fold_packed_periodic if self.fold
                    else batch_step_packed_periodic)
            return step(*stack, *args, self.chunk, self.period)
        if self.sparse:
            step = (batch_step_fold_packed_sparse if self.fold
                    else batch_step_packed_sparse)
            return step(*stack, *args, self.chunk)
        if self.packed:
            return batch_step_packed(*stack, *args, self.chunk, self.fold)
        return (batch_step_fold if self.fold else batch_step)(*stack, *args)

    def _flush(self, final: bool = False) -> None:
        """Fold the queued chunks.  The final flush skips the spill
        schedule: no batch follows it, and ``finish()`` checks every
        ``live`` against the cap."""
        if not self.buf:
            return
        if self.packed:
            stack = [_stack([t[i] for t in self.buf], self.device)
                     for i in range(len(self.buf[0]))]
        else:
            stack = [_stack(self.buf, self.device)]
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
        keys, counts, live = self._step(stack)
        self.spec = (keys, counts)
        self.live_scalars.append(live)
        self._nflush += 1
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

    def _finish_runs(self, factor: int):
        """The spilled runs and the spectrum's live lanes as runs, on the
        device when ``factor`` times their lanes fit the cap, else on the
        host -> ``(runs, on_device)``.  The cap-lane spectrum is freed."""
        from ..io.native import decode_spill_run

        n_out = _read_live(self.live_scalars[-1]) if self.live_scalars else 0
        self._check_live()
        live = tuple(t[:n_out].clone() for t in self.spec)
        self.spec = None
        runs = [decode_spill_run(a, b) if kind == "eac" else (a, b)
                for kind, a, b in self.host_runs]
        lanes = n_out + sum(len(r[0]) for r in runs)
        if factor * lanes <= self.req_cap:
            return [_run_to_device(*r, self.device) for r in runs] + [live], True
        return runs + [_run_to_host(*live)], False

    def _side(self, on_device: bool) -> str:
        return f"on {self.device}" if on_device else "on the host"

    def finish(self):
        """-> (lo u64, hi u64 zeros, counts i64), packed ascending."""
        self._flush(final=True)
        self.finish_log = []
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        runs, on_device = self._finish_runs(1)
        run = _merge_all(runs, merge_runs if on_device else _host_merge,
                         self.finish_log, self._side(on_device))
        lo, c = _run_to_host(*run) if on_device else run
        return lo, np.zeros_like(lo), c

    def finish_expanded(self):
        """Finish and expand to the symmetric fwd+rc edge spectrum
        (build-graph semantics; mode 'value' or 'ref'), on the device when
        twice the lanes fit the cap, else on the host (``ops.count.
        _expand_symmetric``).  Phases: ``flush_tail``, ``pull`` (the live
        spectrum and the merges of spilled runs), ``expand`` (the expansion
        and its copy to the host)."""
        from .count import _expand_symmetric

        t0 = time.perf_counter()
        self._flush(final=True)
        _sync(self.device)
        self.phases = {"flush_tail": time.perf_counter() - t0}
        self.finish_log = []
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        t0 = time.perf_counter()
        runs, on_device = self._finish_runs(2)
        side = self._side(on_device)
        run = _merge_all(runs, merge_runs if on_device else _host_merge,
                         self.finish_log, side)
        del runs
        _sync(self.device)
        self.phases["pull"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.finish_log.append(f"expansion of {len(run[0]):,} keys {side}")
        if on_device:
            lo, c = _run_to_host(*expand_symmetric(*run, self.rho))
            out = lo, np.zeros_like(lo), c
        else:
            out = _expand_symmetric(*run, self.rho)
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
