"""Batched k-mer counting engine on one torch device (narrow keys).

Counterpart of ``gossamer_tpu/ops/engine.py`` ``SpectrumEngine``.  One
engine takes one of two inputs: raw code chunks (:meth:`SpectrumEngine.
add_chunk`) or packed chunks with an invalid-code bitmap
(:meth:`~SpectrumEngine.add_chunk_packed`, what both readers feed).  Each
flush k-merizes a batch of chunks, canonicalizes, masks invalid windows to
the sentinel, sorts the batch (``torch.sort``) and folds it into the packed
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
finish_log` says where each step ran.  A spectrum pulled to the host (a
spill, a finish on the host) travels delta-packed, with its counts packed
into the keys' unused high bits or exact, by the JAX engine's rule
(:meth:`SpectrumEngine._pull_planes`); every copy between host and card
goes through :mod:`.transfer`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import profile
from .canon import MODES, canonicalize, rc
from .fold import SENT, merge_fold, merge_fold_reference
from .kmerize import kmerize_packed, kmerize_planes
from .merge import merge_sorted
from .transfer import (file_counts, file_counts_host, host_merge, merge_all,
                       planes_to_host, read_live, run_to_device, run_to_host,
                       stack_to_device, sync, to_host)


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


# --------------------------------------------------------------- spectra
def merge_runs(a_keys, a_counts, b_keys, b_counts):
    """Two ascending runs of distinct keys (int64 counts) -> their union, the
    counts of a key in both summed in int64: :func:`merge_sorted`, then
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


def empty_spec(cap: int, device: torch.device):
    """All-sentinel spectrum of ``cap`` lanes."""
    return (torch.full((cap,), SENT, dtype=torch.int64, device=device),
            torch.zeros(cap, dtype=torch.int64, device=device))


# ------------------------------------------------------- pulls to the host
# The JAX engine's constants (``gossamer_tpu/ops/engine.py``), names and
# values kept, so that the same spectra take the same pull.
_EXC_CAP = 1 << 18  # exception rows; more: the delta pull stops
_EXC_PIECE = 1 << 14  # the row buffers grow by pieces of rows up to _EXC_CAP
_DELTA_MIN = 1 << 19  # below this many keys the delta pull does not pay
M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their uint32 bits as int32 (reduced
    first: casting a value at or above 2^31 is not a wrap to rely on)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _exc_rows(lanes: int) -> int:
    """Rows of an exception buffer for ``lanes`` lanes: whole pieces of
    ``_EXC_PIECE`` rows, at most ``_EXC_CAP``."""
    return min(_EXC_CAP, -(-max(lanes, 1) // _EXC_PIECE) * _EXC_PIECE)


def _compact(mask: torch.Tensor, rows: int, planes):
    """The lanes where ``mask`` holds, in lane order, into the first
    ``rows`` rows of one buffer a plane (the rest 0) by a prefix sum and a
    scatter -> ``(buffers [len(planes), rows], their number)``, the number
    a 0-d device tensor that may pass ``rows``.  No host sync."""
    pos = torch.cumsum(mask, 0) - 1
    idx = torch.where(mask & (pos < rows), pos, rows)
    out = torch.zeros((len(planes), rows + 1), dtype=planes[0].dtype,
                      device=mask.device)
    for row, plane in zip(out, planes):
        row.scatter_(0, idx, plane)  # lanes out of the mask land on rows
    return out[:, :rows], mask.sum()


def _delta_pack(keys: torch.Tensor, counts: torch.Tensor):
    """Delta pack of spectrum lanes (ascending keys, sentinel tail) ->
    ``(d, cpack, exc, n_exc)``: ``d`` each key less the one before as
    uint32 (int32 bits; 2^32 - 1 at an exception), ``cpack`` the counts
    as uint8 (255 at an exception), ``exc`` the exception rows ``(lane,
    key >> 32, key & (2^32 - 1), count)`` in lane order (uint32 as int32,
    ``[4, rows]``) and ``n_exc`` their number (0-d).  Exceptions: lane 0,
    deltas of 2^32 or more and counts of 255 or more; sentinel lanes are
    none (JAX ``_delta_pack``, on one int64 key: no borrow)."""
    n = keys.numel()
    prev = torch.zeros_like(keys)
    prev[1:] = keys[:-1]
    diff = keys - prev
    lane = torch.arange(n, device=keys.device)
    exc = (((lane == 0) | (diff > M32) | (counts >= 255))
           & (keys != SENT))
    d = torch.where(exc, M32, diff & M32)
    cpack = torch.where(exc, 255, counts.clamp(max=254)).to(torch.uint8)
    rows, n_exc = _compact(exc, _exc_rows(n),
                           (lane, keys >> 32, keys & M32, counts))
    return _u32(d), cpack, _u32(rows), n_exc


def _delta_unpack(d: np.ndarray, cpack: np.ndarray, exc: np.ndarray,
                  n_exc: int, n_out: int):
    """Host decode of :func:`_delta_pack` (``d``, ``exc`` as uint32) ->
    ``(lo u64, counts i64)`` of the first ``n_out`` lanes: the native
    single-pass decoder, else its numpy form."""
    from ..io.native import (delta_unpack_plain, native_delta_unpack,
                             native_or_none)

    args = (d[:n_out], cpack[:n_out], *exc[:, :n_exc], n_out)
    out = native_or_none("delta unpack", native_delta_unpack, *args)
    return out if out is not None else delta_unpack_plain(*args)


def _slice_pieces_packed(keys: torch.Tensor, counts: torch.Tensor,
                         l1_bits: int):
    """Keys and counts as two uint32 planes (int32 bits): the count,
    saturated at ``2^(32 - l1_bits) - 1``, in the high bits of the key's
    high word above its ``l1_bits`` bits, and the key's low word (JAX
    ``_slice_pieces_packed``)."""
    sat = (1 << (32 - l1_bits)) - 1
    p1 = (counts.clamp(max=sat) << l1_bits) | (keys >> 32)
    return _u32(p1), _u32(keys & M32)


def _merge_on_device(a, b):
    return merge_runs(*a, *b)


class SpectrumEngine:
    """Host driver: stream chunks, keep a packed device spectrum.

    ``mode``: 'value' (min-by-value classes, for symmetric expansion),
    'ref' (the reference's FNV-order classes, for k-mer sets) or 'plain'
    (forward strand as is).  ``batch`` chunks make one flush.  ``cap``
    bounds the device-resident distinct-key working set; the device cap
    starts at the size of the first flush and grows by spilling and
    doubling.  With ``spill=False`` overflowing ``cap`` raises at
    ``finish()``.  ``fold=False`` folds with the plain version instead of
    :func:`merge_fold`.
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
        self.packed: bool | None = None  # the input, set by the first chunk
        self.buf: list = []
        self.spec = None
        self.live_scalars: list[torch.Tensor] = []
        self.host_runs: list[tuple] = []
        # overflow bound: live <= checked_live + lanes inserted since
        self._checked_live = 0
        self._lanes_since_check = 0
        self.phases: dict[str, float] = {}  # seconds of the last finish
        self.finish_log: list[str] = []  # where each finish step ran
        self.pulls: list[str] = []  # each spectrum pulled: keys, format
        self.hist = None  # finish_expanded's (mult, freq), where it made one

    def _route(self, packed: bool) -> None:
        if self.packed is None:
            self.packed = packed
        elif self.packed != packed:
            raise ValueError("one engine takes one input route: raw or "
                             "packed chunks")

    def _queue(self, item) -> None:
        self.buf.append(item)
        if len(self.buf) >= self.batch:
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
        self._checked_live = read_live(live)
        self._lanes_since_check = 0

    def _step(self, planes):
        """The batch step of the engine's input and fold."""
        args = (*self.spec, self.rho, self.mode, self.cap)
        if self.packed:
            return batch_step_packed(*planes, *args, self.chunk, self.fold)
        return (batch_step_fold if self.fold else batch_step)(*planes, *args)

    def _flush(self, final: bool = False) -> None:
        """Fold the queued chunks.  The final flush skips the spill
        schedule: no batch follows it, and ``finish()`` checks every
        ``live`` against the cap."""
        if not self.buf:
            return
        if self.packed:
            planes = [stack_to_device(p, self.device) for p in zip(*self.buf)]
        else:
            planes = [stack_to_device(self.buf, self.device)]
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
        keys, counts, live = self._step(planes)
        self.spec = (keys, counts)
        self.live_scalars.append(live)
        # overflow of a final flush or without spills is caught by the
        # max-live check at finish()
        if not final and self.spill_enabled:
            self._schedule_spill(live, batch_lanes)

    def _schedule_spill(self, live: torch.Tensor, batch_lanes: int) -> None:
        """Spill when the bound on the live keys could pass the cap at
        the next flush: the host reads ``live`` only then."""
        self._lanes_since_check += batch_lanes
        bound = self._checked_live + self._lanes_since_check
        next_lanes = self.batch * self.chunk
        if bound + next_lanes > self.cap:
            self._checked_live = read_live(live)
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

        with profile.context("spill"):
            lo, _hi, c = self._finish_planes(self.spec)
            try:
                self.host_runs.append(("eac", encode_spill_run(lo, c), len(lo)))
            except NativeUnavailable:
                self.host_runs.append(("raw", lo, c))
        self.spills += 1
        profile.count("spill_runs", 1)
        if self.on_spill is not None:
            self.on_spill(self.spills, len(lo))
        self.spec = empty_spec(self.cap, self.device)
        self.live_scalars = []
        self._checked_live = 0
        self._lanes_since_check = 0

    def _finish_runs(self, factor: int):
        """The spilled runs and the spectrum's live lanes as runs, on the
        device when ``factor`` times their lanes fit the cap, else on the
        host -> ``(runs, on_device)``.  The cap-lane spectrum is freed.
        Counts the lanes weighed, ``#finish_lanes``, and of them those
        finished on the device, ``#finish_lanes_card`` (0 on the host)."""
        from ..io.native import decode_spill_run

        n_out = read_live(self.live_scalars[-1]) if self.live_scalars else 0
        self._check_live()
        with profile.context("decode"):
            runs = [decode_spill_run(a, b) if kind == "eac" else (a, b)
                    for kind, a, b in self.host_runs]
        lanes = n_out + sum(len(r[0]) for r in runs)
        on_device = factor * lanes <= self.req_cap
        profile.count("finish_lanes", lanes)
        profile.count("finish_lanes_card", lanes if on_device else 0)
        if on_device:
            live = tuple(t[:n_out].clone() for t in self.spec)
            self.spec = None
            return [run_to_device(*r, self.device) for r in runs] + [live], True
        lo, _hi, c = self._pull_planes(self.spec, n_out)
        self.spec = None
        return runs + [(lo, c)], False

    def _side(self, on_device: bool) -> str:
        return f"on {self.device}" if on_device else "on the host"

    def _merged(self, runs: list, on_device: bool):
        """The runs merged into one on their side (scope ``merge``)."""
        with profile.context("merge"):
            return merge_all(runs, _merge_on_device if on_device
                             else host_merge, self.finish_log,
                             self._side(on_device))

    def finish(self):
        """-> (lo u64, hi u64 zeros, counts i64), packed ascending: the
        spectrum and the spilled runs merged."""
        self.phases = {}
        self._flush(final=True)
        self.finish_log = []
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        runs, on_device = self._finish_runs(1)
        run = self._merged(runs, on_device)
        lo, c = run_to_host(*run) if on_device else run
        return lo, np.zeros_like(lo), c

    def finish_expanded(self, graph_counts: bool = False):
        """Finish and expand to the symmetric fwd+rc edge spectrum
        (build-graph semantics; mode 'value' or 'ref'): on the device when
        twice the lanes fit the cap, else on the host
        (``ops.count._expand_symmetric``).  The phases' seconds are their
        scopes' (one clock reading each): ``flush_tail`` (the final
        flush), ``pull`` (the live spectrum and the merges of spilled
        runs), ``expand`` (the expansion and its copy to the host).

        ``graph_counts`` (build-graph's write): an expansion on the device
        pulls the counts as the graph file holds them, and their histogram
        into :attr:`hist` (:func:`.transfer.file_counts`); the host's
        expansion gives int64 counts and leaves :attr:`hist` None."""
        from .count import _expand_symmetric

        with profile.context("flush_tail", clock=True) as tail:
            self._flush(final=True)
            self.finish_log = []
            sync(self.device)
        self.phases = {"flush_tail": tail.seconds}
        self.hist = None
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        with profile.context("pull", clock=True) as pull:
            runs, on_device = self._finish_runs(2)
            run = self._merged(runs, on_device)
            del runs
            sync(self.device)
        self.phases["pull"] = pull.seconds
        with profile.context("expand", clock=True) as expand:
            self.finish_log.append(f"expansion of {len(run[0]):,} keys "
                                   f"{self._side(on_device)}")
            if on_device and graph_counts:
                keys, c = expand_symmetric(*run, self.rho)
                del run  # the classes go before the counts are narrowed
                c, hist = file_counts(c)
                lo, c, *hist = planes_to_host(keys, c, *hist)
                lo = lo.view(np.uint64)
                c, self.hist = file_counts_host(c, hist)
                out = lo, np.zeros_like(lo), c
            elif on_device:
                lo, c = run_to_host(*expand_symmetric(*run, self.rho))
                out = lo, np.zeros_like(lo), c
            else:
                out = _expand_symmetric(*run, self.rho)
        self.phases["expand"] = expand.seconds
        return out

    def _finish_planes(self, spec):
        n_out = read_live(self.live_scalars[-1]) if self.live_scalars else 0
        self._check_live()
        return self._pull_planes(spec, n_out)

    def _pull_planes(self, spec, n_out: int):
        """The first ``n_out`` lanes of ``spec`` to the host -> (lo u64,
        hi zeros, counts i64), by the JAX engine's rule: delta-packed
        (5 B a key) when there are ``_DELTA_MIN`` keys or more and the key
        space is dense enough for 32-bit deltas; else, when ``64 - 2 *
        rho >= 8``, the counts packed into the keys' unused high bits (8 B
        a key; the exact counts pulled again when one saturates); else
        exact.  :attr:`pulls` says which."""
        dense = n_out > 0 and (2 * self.rho <= 31
                               or n_out >= 1 << (2 * self.rho - 31))
        if n_out >= _DELTA_MIN and dense:
            out = self._pull_delta(spec, n_out)
            if out is not None:
                return out
        keys, counts = (t[:n_out] for t in spec)
        l1_bits = max(0, 2 * self.rho - 32)
        if 32 - l1_bits >= 8:
            sat = (1 << (32 - l1_bits)) - 1
            p1, l0 = (a.view(np.uint32) for a in planes_to_host(
                *_slice_pieces_packed(keys, counts, l1_bits)))
            l1 = p1 & np.uint32((1 << l1_bits) - 1)
            c = (p1 >> np.uint32(l1_bits)).astype(np.int64)
            lo = (l1.astype(np.uint64) << np.uint64(32)) | l0
            if n_out and c.max() >= sat:
                c = to_host(counts)
                self.pulls.append(f"{n_out:,} keys: packed counts, the "
                                  f"counts again (one saturates)")
            else:
                self.pulls.append(f"{n_out:,} keys: packed counts")
        else:
            lo, c = run_to_host(keys, counts)
            self.pulls.append(f"{n_out:,} keys: exact")
        return lo, np.zeros_like(lo), c

    def _pull_delta(self, spec, n_out: int):
        """The delta-packed pull of the first ``n_out`` lanes; None when
        the exceptions pass ``_EXC_CAP``."""
        d, cpack, exc, n_exc = planes_to_host(*_delta_pack(
            spec[0][:n_out], spec[1][:n_out]))
        n_exc = int(n_exc)
        if n_exc > _EXC_CAP:
            self.pulls.append(f"{n_out:,} keys: delta pull stopped, {n_exc:,} "
                              f"exceptions, more than {_EXC_CAP:,}")
            return None
        lo, c = _delta_unpack(d.view(np.uint32), cpack, exc.view(np.uint32),
                              n_exc, n_out)
        self.pulls.append(f"{n_out:,} keys: delta, {n_exc:,} exceptions")
        return lo, np.zeros_like(lo), c

    def _check_live(self) -> None:
        if not self.live_scalars:
            return
        with profile.context("sync"):
            lives = torch.stack(self.live_scalars).cpu()
        if int(lives.min()) < 0:
            raise RuntimeError("merge_fold inputs were not ascending "
                               "(live = -1)")
        max_live = int(lives.max())
        if max_live > self.cap:
            raise RuntimeError(
                f"spectrum working set ({max_live}) exceeded cap "
                f"({self.cap}); rerun with a larger --spectrum-cap")
