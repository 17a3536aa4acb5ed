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
finish_log` says where each step ran.  A spectrum pulled to the host (a
spill, a finish on the host) travels delta-packed, with its counts packed
into the keys' unused high bits or exact, by the JAX engine's rule
(:meth:`SpectrumEngine._pull_planes`); the planes of one pull from a card
land in one page-locked block, the host waiting once (:func:`_planes_to_host`).

The early pull (``early_pull_flush``, the JAX engine's): after that flush
the keys of the spectrum are delta-packed on the device and copied to
pinned host memory on a side stream while the next flushes run; a worker
thread decodes them and computes the order of the symmetric expansion
(``native_expand_order``).  The finish then pulls 1 B a key of counts
and the keys that are new since the snapshot, and applies the order on
the host (:meth:`SpectrumEngine._pull_reconciled`).  Nothing before the
finish's sync waits for the device: the packed exceptions and new keys
go into fixed buffers of ``_EXC_CAP`` rows by a prefix sum and a scatter,
their numbers stay device scalars.  Where the JAX engine's data
conditions stop the reconciled route, the finish runs as without it and
:attr:`SpectrumEngine.finish_log` says why.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils import profile
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
    profile.count("h2d_bytes", arr.nbytes)
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


_ALIGN = 64  # bytes: where each carved view of a pinned block starts


def _aligned(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _carve(block: torch.Tensor, tensors) -> list:
    """Views of the uint8 ``block``, one a tensor, of its dtype and shape,
    each starting on an ``_ALIGN``-byte boundary."""
    views, off = [], 0
    for t in tensors:
        views.append(block[off:off + t.nbytes].view(t.dtype).view(t.shape))
        off += _aligned(t.nbytes)
    return views


def _planes_to_host(*tensors: torch.Tensor) -> list:
    """Tensors pulled to host memory, the host waiting once for the work
    queued before the copies: scope ``to_host``, counter ``#d2h_bytes``.

    From a CUDA device the copies land in one page-locked block of torch's
    caching host allocator, carved by :func:`_carve` (counter
    ``#d2h_pinned_bytes``).  Each array's base is its view of the block,
    so the block goes back to the cache only when the last array is gone.
    CPU tensors come back as ``.numpy()``."""
    for t in tensors:
        profile.count("d2h_bytes", t.nbytes)
    with profile.context("to_host"):
        if tensors[0].device.type != "cuda":
            return [t.cpu().numpy() for t in tensors]
        size = sum(_aligned(t.nbytes) for t in tensors)
        block = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        dst = _carve(block, tensors)
        for d, t in zip(dst, tensors):
            profile.count("d2h_pinned_bytes", t.nbytes)
            d.copy_(t, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        return [d.numpy() for d in dst]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One tensor pulled to host memory by :func:`_planes_to_host`."""
    return _planes_to_host(t)[0]


def _run_to_host(keys: torch.Tensor, counts: torch.Tensor):
    k, c = _planes_to_host(keys, counts)
    return k.view(np.uint64), c


def _merge_all(runs: list, merge, log: list, side: str):
    """Merge ``runs`` two at a time, smallest first (as the JAX engine's
    ``_merged_host``) with ``merge`` -> one run; each merge logged."""
    with profile.context("merge"):
        while len(runs) > 1:
            runs.sort(key=lambda r: len(r[0]))
            a, b = runs.pop(0), runs.pop(0)
            log.append(f"merge of {len(a[0]):,} + {len(b[0]):,} keys {side}")
            runs.append(merge(*a, *b))
            del a, b  # the inputs go before the next merge
        return runs[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        with profile.context("sync"):
            torch.cuda.synchronize(device)


def _read_live(live: torch.Tensor) -> int:
    with profile.context("sync"):
        n = int(live)  # device sync
    if n < 0:
        raise RuntimeError("merge_fold inputs were not ascending (live = -1)")
    return n


# ------------------------------------------------------------- early pull
# The JAX engine's constants (``gossamer_tpu/ops/engine.py``), names and
# values kept, so that the same spectra take the same route.
_PIECE = 1 << 20  # the snapshot copies whole pieces of lanes
_EXC_CAP = 1 << 18  # exception rows and new keys; more: not reconciled
_EXC_PIECE = 1 << 14  # the row buffers grow by pieces of rows up to _EXC_CAP
_DELTA_MIN = 1 << 19  # below this many keys the delta pull does not pay
M32 = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their uint32 bits as int32 (reduced
    first: casting a value at or above 2^31 is not a wrap to rely on)."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _piece_lanes(n: int, cap: int) -> int:
    """Lanes of whole ``_PIECE`` pieces that cover ``n`` keys, at most
    ``cap`` (the JAX engine pulls pieces of a fixed grid)."""
    return min(cap, -(-max(n, 1) // _PIECE) * _PIECE)


def _exc_rows(lanes: int) -> int:
    """Rows of an exception buffer for ``lanes`` lanes: whole pieces of
    ``_EXC_PIECE`` rows, at most ``_EXC_CAP``."""
    return min(_EXC_CAP, -(-max(lanes, 1) // _EXC_PIECE) * _EXC_PIECE)


def _compact(mask: torch.Tensor, rows: int, planes, fill: int = 0):
    """The lanes where ``mask`` holds, in lane order, into the first
    ``rows`` rows of one buffer a plane (the rest ``fill``) by a prefix sum
    and a scatter -> ``(buffers [len(planes), rows], their number)``, the
    number a 0-d device tensor that may pass ``rows``.  No host sync."""
    pos = torch.cumsum(mask, 0) - 1
    idx = torch.where(mask & (pos < rows), pos, rows)
    out = torch.full((len(planes), rows + 1), fill, dtype=planes[0].dtype,
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


def _count_pack(keys: torch.Tensor, counts: torch.Tensor):
    """Counts alone -> ``(cpack, exc, n_exc)``: uint8 counts saturated at
    255 and the exception rows ``(lane, count)`` (uint32 as int32) of the
    counts of 255 or more, sentinel lanes left out (JAX ``_count_pack``)."""
    exc = (counts >= 255) & (keys != SENT)
    cpack = torch.where(exc, 255, counts.clamp(max=254)).to(torch.uint8)
    lane = torch.arange(keys.numel(), device=keys.device)
    rows, n_exc = _compact(exc, _exc_rows(keys.numel()), (lane, counts))
    return cpack, _u32(rows), n_exc


def _counts_from_pack(cpack: np.ndarray, exc: np.ndarray, n_exc: int,
                      n_out: int):
    """Host decode of :func:`_count_pack` (``exc`` as uint32) -> int64
    counts of the first ``n_out`` lanes; None when the exceptions passed
    ``_EXC_CAP``."""
    if n_exc > _EXC_CAP:
        return None
    c = cpack[:n_out].astype(np.int64)
    e_lane = exc[0][:n_exc].astype(np.int64)
    keep = e_lane < n_out
    c[e_lane[keep]] = exc[1][:n_exc][keep]
    return c


def _reconcile_new_keys(s_keys: torch.Tensor, f_keys: torch.Tensor):
    """Keys of the final spectrum ``f_keys`` absent from the snapshot
    ``s_keys`` (both ascending, sentinel tails) -> ``(new, n_new)``: the new
    keys ascending in ``rows`` int64 lanes (sentinel after ``n_new``) and
    their number (0-d).  The engine only adds keys between flushes, so this
    is every key found after the snapshot.  Each final key is searched in
    the snapshot (``torch.searchsorted``) and compared: no sort of the
    2 x cap lanes the JAX function tags and sorts."""
    idx = torch.searchsorted(s_keys, f_keys).clamp_(max=s_keys.numel() - 1)
    new = (s_keys[idx] != f_keys) & (f_keys != SENT)
    rows, n_new = _compact(new, _exc_rows(f_keys.numel()), (f_keys,), SENT)
    return rows[0], n_new


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


def _snapshot_keys(d: np.ndarray, exc: np.ndarray, n_exc: int, n1: int,
                   lanes: int):
    """The snapshot's keys from its pulled delta plane -> ``(lo, None)``,
    or ``(None, why)`` on the JAX engine's data conditions: the snapshot
    live count outside ``1..lanes`` (the lanes copied) or its exceptions
    past ``_EXC_CAP``."""
    if n1 <= 0 or n1 > lanes:
        return None, f"the snapshot's {n1:,} keys outside 1..{lanes:,}"
    if n_exc > _EXC_CAP:
        return None, (f"{n_exc:,} exceptions in the snapshot, more than "
                      f"{_EXC_CAP:,}")
    lo, _c = _delta_unpack(d.view(np.uint32), np.zeros(n1, np.uint8),
                           exc.view(np.uint32), n_exc, n1)
    return lo, None


def _slice_pieces_packed(keys: torch.Tensor, counts: torch.Tensor,
                         l1_bits: int):
    """Keys and counts as two uint32 planes (int32 bits): the count,
    saturated at ``2^(32 - l1_bits) - 1``, in the high bits of the key's
    high word above its ``l1_bits`` bits, and the key's low word (JAX
    ``_slice_pieces_packed``)."""
    sat = (1 << (32 - l1_bits)) - 1
    p1 = (counts.clamp(max=sat) << l1_bits) | (keys >> 32)
    return _u32(p1), _u32(keys & M32)


class _HostCopy:
    """Device tensors copied to host memory without blocking the host.
    On a CUDA device: into pinned buffers, on ``stream``, after the work
    queued so far on the current stream; :meth:`wait` blocks on that
    copy's event alone.  The device tensors are marked as used by
    ``stream``, so the allocator keeps them until the copy is done.  On
    the CPU: plain copies."""

    def __init__(self, tensors, stream):
        self.done = None
        if stream is None:
            self.host = [t.clone() for t in tensors]
            return
        ready = torch.cuda.current_stream(tensors[0].device).record_event()
        stream.wait_event(ready)
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors]
        with torch.cuda.stream(stream):
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
                t.record_stream(stream)
        self.done = stream.record_event()

    def wait(self) -> list:
        if self.done is not None:
            self.done.synchronize()
        return [h.numpy() for h in self.host]


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
    ``early_pull_flush`` takes the snapshot of the early pull after that
    flush (:meth:`snapshot_async`); ``expected_distinct``, a hint of the
    distinct keys, sizes its copy without a device sync.
    """

    def __init__(self, rho: int, mode: str, chunk: int, device: torch.device,
                 batch: int = 8, cap: int = 1 << 23, spill: bool = True,
                 fold: bool = True, on_spill=None, scan_groups: int = 1,
                 period: int = 0, first_batch: int | None = None,
                 early_pull_flush: int | None = None,
                 expected_distinct: int | None = None):
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
        self.pulls: list[str] = []  # each spectrum pulled: keys, format
        # the early pull: the snapshot (its keys on the device, the lanes
        # copied, their copy), the worker's (copy, future), the finish's
        # device results for the current spectrum and their copy
        self.early_pull_flush = early_pull_flush
        self.expected_distinct = expected_distinct
        self._snap = None
        self._snap_note = "none asked"
        self._prex = None
        self._prex_pool = None
        self._fin = None
        self._fin_pull = None
        self._last_reconcile = None
        self._stream = None

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
        self._fin = None  # the finish's results are for a spectrum before
        self.live_scalars.append(live)
        self._nflush += 1
        # overflow of a final flush or without spills is caught by the
        # max-live check at finish()
        if not final and self.spill_enabled:
            self._schedule_spill(live, batch_lanes)
        if self._nflush == self.early_pull_flush:
            self.snapshot_async()

    def _schedule_spill(self, live: torch.Tensor, batch_lanes: int) -> None:
        """Spill when the bound on the live keys could pass the cap at
        the next flush: the host reads ``live`` only then."""
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

        if self._snap is not None:
            self._snap_note = "cancelled by a spill"
        self._snap = self._prex = self._fin = self._fin_pull = None
        with profile.context("spill"):
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
        with profile.context("decode"):
            runs = [decode_spill_run(a, b) if kind == "eac" else (a, b)
                    for kind, a, b in self.host_runs]
        lanes = n_out + sum(len(r[0]) for r in runs)
        if factor * lanes <= self.req_cap:
            live = tuple(t[:n_out].clone() for t in self.spec)
            self.spec = None
            return [_run_to_device(*r, self.device) for r in runs] + [live], True
        lo, _hi, c = self._pull_planes(self.spec, n_out)
        self.spec = None
        return runs + [(lo, c)], False

    def _side(self, on_device: bool) -> str:
        return f"on {self.device}" if on_device else "on the host"

    def _start_finish(self) -> None:
        """The final flush and the finish's device work of the early pull
        (dispatched before any sync); the logs of the finish begin."""
        self._flush(final=True)
        self._prefetch_finish()
        self.finish_log = []
        if self.early_pull_flush is not None and self._snap is None:
            self.finish_log.append(f"early pull at flush "
                                   f"{self.early_pull_flush}: no snapshot "
                                   f"({self._snap_note})")

    def _end_snapshot(self) -> None:
        """Drop the early pull's state and stop its worker."""
        self._snap = self._prex = self._fin = self._fin_pull = None
        self._last_reconcile = None
        if self._prex_pool is not None:
            self._prex_pool.shutdown(wait=True)
            self._prex_pool = None

    def finish(self):
        """-> (lo u64, hi u64 zeros, counts i64), packed ascending: the
        reconciled pull when the early pull's snapshot holds, else the
        spectrum and the spilled runs merged."""
        self.phases = {}
        try:
            self._start_finish()
            if self.spec is None:
                z = np.zeros(0, np.uint64)
                return z, z.copy(), np.zeros(0, np.int64)
            if self._snap is not None and not self.host_runs:
                n_out = _read_live(self.live_scalars[-1])
                self._check_live()
                out = self._pull_reconciled(n_out)
                if out is not None:
                    return out
        finally:
            self._end_snapshot()
        runs, on_device = self._finish_runs(1)
        run = _merge_all(runs, merge_runs if on_device else _host_merge,
                         self.finish_log, self._side(on_device))
        lo, c = _run_to_host(*run) if on_device else run
        return lo, np.zeros_like(lo), c

    def finish_expanded(self):
        """Finish and expand to the symmetric fwd+rc edge spectrum
        (build-graph semantics; mode 'value' or 'ref').  With the early
        pull's snapshot and its worker: the reconciled pull and the
        expansion on the host by the snapshot's order
        (:meth:`_pull_reconciled_expanded`; phases ``sync``,
        ``reconcile``, ``fin_get``, ``prex_wait``, ``exp_split``,
        ``exp_apply``, ``exp_merge``, ``expand``).  Else, or where that
        route stops, on the device when twice the lanes fit the cap, else on
        the host (``ops.count._expand_symmetric``): phases ``pull`` (the
        live spectrum and the merges of spilled runs), ``expand`` (the
        expansion and its copy to the host).  ``flush_tail`` is the final
        flush."""
        from .count import _expand_symmetric

        try:
            with profile.context("flush_tail", clock=True) as tail:
                self._start_finish()
                _sync(self.device)
            self.phases = {"flush_tail": tail.seconds}
            if self.spec is None:
                z = np.zeros(0, np.uint64)
                return z, z.copy(), np.zeros(0, np.int64)
            if (self._snap is not None and self._prex is not None
                    and not self.host_runs):
                t0 = time.perf_counter()
                n_out = _read_live(self.live_scalars[-1])
                self._check_live()
                self.phases["sync"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                out = self._pull_reconciled_expanded(n_out)
                self.phases["reconcile"] = time.perf_counter() - t0
                if out is not None:
                    return out
        finally:
            self._end_snapshot()
        # the phases' seconds are their scopes' (one clock reading each)
        with profile.context("pull", clock=True) as pull:
            runs, on_device = self._finish_runs(2)
            side = self._side(on_device)
            run = _merge_all(runs, merge_runs if on_device else _host_merge,
                             self.finish_log, side)
            del runs
            _sync(self.device)
        self.phases["pull"] = pull.seconds
        with profile.context("expand", clock=True) as expand:
            self.finish_log.append(f"expansion of {len(run[0]):,} keys {side}")
            if on_device:
                lo, c = _run_to_host(*expand_symmetric(*run, self.rho))
                out = lo, np.zeros_like(lo), c
            else:
                out = _expand_symmetric(*run, self.rho)
        self.phases["expand"] = expand.seconds
        return out

    def _finish_planes(self, spec):
        n_out = _read_live(self.live_scalars[-1]) if self.live_scalars else 0
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
            p1, l0 = (a.view(np.uint32) for a in _planes_to_host(
                *_slice_pieces_packed(keys, counts, l1_bits)))
            l1 = p1 & np.uint32((1 << l1_bits) - 1)
            c = (p1 >> np.uint32(l1_bits)).astype(np.int64)
            lo = (l1.astype(np.uint64) << np.uint64(32)) | l0
            if n_out and c.max() >= sat:
                c = _to_host(counts)
                self.pulls.append(f"{n_out:,} keys: packed counts, the "
                                  f"counts again (one saturates)")
            else:
                self.pulls.append(f"{n_out:,} keys: packed counts")
        else:
            lo, c = _run_to_host(keys, counts)
            self.pulls.append(f"{n_out:,} keys: exact")
        return lo, np.zeros_like(lo), c

    def _pull_delta(self, spec, n_out: int):
        """The delta-packed pull of the first ``n_out`` lanes; None when
        the exceptions pass ``_EXC_CAP``."""
        d, cpack, exc, n_exc = _planes_to_host(*_delta_pack(
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

    # ------------------------------------------------------- early pull
    def _host_copy(self, tensors) -> _HostCopy:
        if self.device.type != "cuda":
            return _HostCopy(tensors, None)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return _HostCopy(tensors, self._stream)

    def _hinted_keys(self) -> int:
        """The keys ``expected_distinct`` bounds, as the JAX engine: 1.25
        times the hint and 2^16, at most the cap."""
        return min(self.cap, int(1.25 * self.expected_distinct) + (1 << 16))

    def snapshot_async(self) -> bool:
        """Snapshot the spectrum's keys and start their copy to the host.

        The spectrum only gains keys between flushes, so the snapshot holds
        a subset of the final keys.  Its delta-packed keys (4 B a key and
        the exception rows) are copied on a side stream while the next
        flushes run, and a worker decodes them and computes the
        expansion's order (modes 'value' and 'ref').  The finish then
        pulls the final counts (1 B a key) and the keys found since
        (:meth:`_pull_reconciled`).  Without ``expected_distinct`` the
        live count is read (a device sync) to size the copy.

        Returns False, as the JAX engine, with no spectrum, with spilled
        runs, below ``_DELTA_MIN`` keys, or in a key space too sparse for
        32-bit deltas."""
        if self.spec is None or self.host_runs or not self.live_scalars:
            self._snap_note = "no spectrum" if not self.host_runs else \
                "spilled runs"
            return False
        if self.expected_distinct is not None:
            n_bound = self._hinted_keys()
        else:
            n_bound = _read_live(self.live_scalars[-1])  # device sync
        dense = 2 * self.rho <= 31 or n_bound >= 1 << (2 * self.rho - 31)
        if n_bound < _DELTA_MIN or not dense:
            self._snap_note = (f"{n_bound:,} keys: " + (
                f"fewer than {_DELTA_MIN:,}" if n_bound < _DELTA_MIN
                else "a sparse key space"))
            return False
        lanes = _piece_lanes(n_bound, self.cap)
        keys = self.spec[0]
        d, _cpack, exc, n_exc = _delta_pack(keys[:lanes],
                                            self.spec[1][:lanes])
        pull = self._host_copy(
            [d, exc, torch.stack([n_exc, self.live_scalars[-1]])])
        self._snap = (keys, lanes, pull)
        if self.mode in ("value", "ref"):
            if self._prex_pool is None:
                self._prex_pool = ThreadPoolExecutor(
                    1, thread_name_prefix="goss-prex")
            self._prex = (pull, self._prex_pool.submit(self._prex_work,
                                                       pull, lanes))
        return True

    def _prex_work(self, pull: _HostCopy, lanes: int) -> dict:
        """Worker: wait for the snapshot's copy, decode its keys and
        compute the expansion's order (``native_expand_order``; without
        the native library no order, and the finish expands in full) ->
        ``{"n1", "lo_s", "out", "src", "dbl"}``, or ``{"n1", "why"}`` on
        the JAX engine's data conditions.  Any other error propagates to
        the finish."""
        from ..io.native import native_expand_order, native_or_none

        d, exc, (n_exc, n1) = pull.wait()
        n_exc, n1 = int(n_exc), int(n1)
        lo_s, why = _snapshot_keys(d, exc, n_exc, n1, lanes)
        if lo_s is None:
            return {"n1": n1, "why": why}
        out = {"n1": n1, "lo_s": lo_s}
        order = native_or_none("expansion order", native_expand_order, lo_s,
                               self.rho)
        if order is not None:
            out["out"], out["src"], out["dbl"] = order
        return out

    def _fin_programs(self):
        """The finish's device work against the snapshot, once a
        spectrum: the new keys (:func:`_reconcile_new_keys`) and the count
        pack (:func:`_count_pack`) -> ``(new, n_new, cpack, cexc,
        c_nexc)``."""
        keys, counts = self.spec
        if self._fin is not None and self._fin[0] is keys:
            return self._fin[1]
        out = (*_reconcile_new_keys(self._snap[0], keys),
               *_count_pack(keys, counts))
        self._fin = (keys, out)
        return out

    def _fin_copy(self, lanes: int) -> _HostCopy:
        new, n_new, cpack, cexc, c_nexc = self._fin_programs()
        return self._host_copy([new, cexc, torch.stack([n_new, c_nexc]),
                                cpack[:lanes]])

    def _prefetch_finish(self) -> None:
        """With ``expected_distinct``: dispatch the finish's device work
        right after the final flush and start its copy, sized by the hint,
        before the finish's sync."""
        if (self._snap is None or self.spec is None or self.host_runs
                or self.expected_distinct is None):
            return
        lanes = _piece_lanes(self._hinted_keys(), self.cap)
        self._fin_pull = (lanes, self._fin_copy(lanes))

    def _no_reconcile(self, why: str) -> None:
        self.finish_log.append(f"reconciled pull stopped: {why}; the finish "
                               f"without the early pull")

    def _pull_reconciled(self, n_out: int):
        """The finish's pull against the snapshot -> (lo, hi zeros, counts),
        or None on the JAX engine's data conditions (the snapshot's live
        count outside ``1..lanes`` or above ``n_out``, new keys not
        ``n_out - n1`` or more than ``_EXC_CAP``, count exceptions past
        ``_EXC_CAP``), the reason in :attr:`finish_log`."""
        _keys, lanes, pull = self._snap
        d, exc, (n_exc, n1) = pull.wait()
        n_exc, n1 = int(n_exc), int(n1)
        if n1 <= 0 or n1 > lanes or n_out < n1:
            return self._no_reconcile(f"the snapshot's {n1:,} keys outside "
                                      f"1..{min(lanes, n_out):,}")
        t0 = time.perf_counter()
        if self._fin_pull is not None and self._fin_pull[0] >= n_out:
            copy = self._fin_pull[1]
        else:
            copy = self._fin_copy(n_out)
        new, cexc, (n_new, c_nexc), cpack = copy.wait()
        self.phases["fin_get"] = time.perf_counter() - t0
        n_new, c_nexc = int(n_new), int(c_nexc)
        if n_new != n_out - n1 or n_new > _EXC_CAP:
            return self._no_reconcile(
                f"n1 {n1:,}, n_new {n_new:,} of {n_out:,} keys (at most "
                f"{_EXC_CAP:,} new keys)")
        c = _counts_from_pack(cpack, cexc.view(np.uint32), c_nexc, n_out)
        if c is None:
            return self._no_reconcile(f"{c_nexc:,} count exceptions, more "
                                      f"than {_EXC_CAP:,}")
        lo_s = prex = None
        if self._prex is not None and self._prex[0] is pull:
            t0 = time.perf_counter()
            prex = self._prex[1].result()
            self.phases["prex_wait"] = time.perf_counter() - t0
            if "lo_s" in prex and prex["n1"] == n1:
                lo_s = prex["lo_s"]
            else:
                prex = None
        if lo_s is None:
            lo_s, why = _snapshot_keys(d, exc, n_exc, n1, lanes)
            if lo_s is None:
                return self._no_reconcile(why)
        lo_n = new[:n_new].view(np.uint64)
        lo = np.insert(lo_s, np.searchsorted(lo_s, lo_n), lo_n) if n_new \
            else lo_s
        self.finish_log.append(f"reconciled pull of {n_out:,} keys: n1 "
                               f"{n1:,} from the snapshot, n_new {n_new:,}")
        self._last_reconcile = {"prex": prex, "n1": n1, "n_new": n_new,
                                "lo_s": lo_s, "lo_n": lo_n}
        return lo, np.zeros_like(lo), c

    def _pull_reconciled_expanded(self, n_out: int):
        """The reconciled pull, then the symmetric expansion on the host:
        by the worker's order (``native_split_counts`` of the counts into
        the snapshot's and the new keys', ``native_apply_order``, the new
        keys and their reverse complements merged in by
        ``native_insert_merge``; each with its numpy form without the
        native library), or without an order in full
        (``ops.count._expand_symmetric``).  None where the reconciled pull
        stops."""
        from ..core import kmer as K
        from ..io.native import (apply_order_plain, insert_merge_plain,
                                 native_apply_order, native_insert_merge,
                                 native_or_none, native_split_counts,
                                 split_counts_plain)
        from .count import _expand_symmetric

        out = self._pull_reconciled(n_out)
        if out is None:
            return None
        lo, _hi, c = out
        info = self._last_reconcile
        prex = info["prex"]
        t0 = time.perf_counter()
        if prex is None or "out" not in prex:
            self.finish_log.append(f"expansion of {n_out:,} keys on the "
                                   f"host: full")
            res = _expand_symmetric(lo, c, self.rho)
            self.phases["expand"] = time.perf_counter() - t0
            return res
        self.finish_log.append(f"expansion of {n_out:,} keys on the host: "
                               f"order")
        n1, n_new = info["n1"], info["n_new"]
        c_snap = c
        if n_new:
            # c is aligned with merge(lo_s, lo_n): split it in one pass
            t1 = time.perf_counter()
            idx = np.searchsorted(info["lo_s"], info["lo_n"])
            split = native_or_none("split counts", native_split_counts, idx,
                                   c, n1, n_new)
            c_snap, c_new = split if split is not None else \
                split_counts_plain(idx, c, n1, n_new)
            self.phases["exp_split"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out_lo = prex["out"]
        out_c = native_or_none("apply order", native_apply_order,
                               prex["src"], prex["dbl"], c_snap)
        if out_c is None:
            out_c = apply_order_plain(prex["src"], prex["dbl"], c_snap)
        self.phases["exp_apply"] = time.perf_counter() - t1
        if n_new:
            lo_n = info["lo_n"]
            rlo_n, _ = K.reverse_complement(lo_n, np.zeros_like(lo_n),
                                            self.rho)
            pal = rlo_n == lo_n
            add_lo = np.concatenate([lo_n, rlo_n[~pal]])
            add_c = np.concatenate([np.where(pal, 2 * c_new, c_new),
                                    c_new[~pal]])
            o2 = np.argsort(add_lo, kind="stable")
            add_lo, add_c = add_lo[o2], add_c[o2]
            t1 = time.perf_counter()
            args = (out_lo, out_c, add_lo, add_c)
            merged = native_or_none("insert merge", native_insert_merge, *args)
            out_lo, out_c = merged if merged is not None else \
                insert_merge_plain(*args)
            self.phases["exp_merge"] = time.perf_counter() - t1
        self.phases["expand"] = time.perf_counter() - t0
        return out_lo, np.zeros_like(out_lo), out_c.astype(np.int64)

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
