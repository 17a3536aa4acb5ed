"""Device-side read classification (the xenome and electus lookup engine)
on torch.

Counterpart of ``gossamer_tpu/classify/device.py``.  Narrow keys (k <= 30:
E = (key << 2) | class fits 62 bits) use the JAX package's sort-join with
the set kept sorted:

1. the annotated set is encoded once as E = (key << 2) | class, sorted
   (an int64 tensor on the device);
2. a batch's windows become queries E = (key << 2) | 3, or the sentinel
   2^63 - 1 where the window is not valid, each carrying its read id;
3. the queries are sorted and merged into the set with
   :func:`..ops.merge.merge_sorted` (set lanes first on equal E), which
   puts each query right after its potential set match: the (E, is_q)
   order of a stable sort of [set ++ queries];
4. a ``cumsum`` of the set lanes gives every query lane the rank of the
   latest set lane before it, and a query matches when that set entry
   holds its key;
5. per-read blrg is the OR of the matched class bits, scattered by read id.

Read ids come from the read start offsets of the batch, never from the
invalid-code positions: an ``N`` inside a read is invalid but does not
start a read (the JAX package's engines count it as a separator).

:func:`join_ranks_batch` is the same join for sets whose payload is an
annotation per key held on the host: it returns each window's rank in the
set (the taxonomy commands).

Wide keys (30 < k <= 62) hold E in the two-lane layout of
:mod:`..ops.engine_wide` (``hi``, ``lo`` with its top bit flipped).  There
is no two-lane merge kernel: :func:`classify_batch_wide` concatenates set
and queries, sorts by both lanes (stable, so a set lane precedes the
queries of its key) and fills forward by the same ``cumsum``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import kmer as K
from ..ops import device_kmer as dk
from ..ops import engine_wide as ew
from ..ops.kmerize import M32, kmerize_packed, kmerize_words
from ..ops.merge import merge_sorted
from ..utils import profile

SENT = (1 << 63) - 1


def encode_set(lo: np.ndarray, lhs: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Annotated set -> sorted E = (key << 2) | (lhs<<1|rhs) plane (uint64)."""
    cls = (lhs.astype(np.uint64) << np.uint64(1)) | rhs.astype(np.uint64)
    return (lo << np.uint64(2)) | cls


def _read_ids(starts: torch.Tensor, n: int) -> torch.Tensor:
    """Read id of each of ``n`` window positions: the last read whose start
    offset (ascending ``starts``) is at or before the position."""
    pos = torch.arange(n, dtype=torch.int64, device=starts.device)
    return torch.searchsorted(starts, pos, right=True) - 1


def _classify_join(set_E: torch.Tensor, qE: torch.Tensor, rid: torch.Tensor,
                   max_reads: int) -> torch.Tensor:
    """Sorted set E + query E + per-query read id -> blrg uint8[max_reads]."""
    if set_E.numel() == 0:
        return torch.zeros(max_reads, dtype=torch.uint8, device=qE.device)
    q_sorted, perm = torch.sort(qE)
    keys, pay = merge_sorted(set_E, torch.full_like(set_E, -1), q_sorted,
                             rid[perm])
    is_set = pay < 0
    # rank in the set of the latest set lane at or before each lane (a
    # cumsum: torch's cummax scan is ~100x slower on the card)
    r = torch.cumsum(is_set, 0) - 1
    s_key = set_E[r.clamp(min=0)]
    match = (~is_set & (r >= 0) & ((s_key >> 2) == (keys >> 2))
             & (keys != SENT))
    return _agg_blrg(torch.where(match, pay, -1), s_key & 3, max_reads)


def _agg_blrg(rid: torch.Tensor, cls: torch.Tensor, max_reads: int) -> torch.Tensor:
    """(read id per lane, -1 where the lane sets no bit; class per lane) ->
    per-read OR of the class one-hots, by scatter."""
    slot = torch.where(rid >= 0, rid * 4 + cls, max_reads * 4)
    hit = torch.zeros(max_reads * 4 + 1, dtype=torch.uint8, device=rid.device)
    hit.index_fill_(0, slot, 1)
    shift = torch.arange(4, dtype=torch.uint8, device=rid.device)
    return (hit[:-1].view(max_reads, 4) << shift).sum(1, dtype=torch.uint8)


def classify_batch(codes: torch.Tensor, starts: torch.Tensor,
                   set_E: torch.Tensor, k: int, max_reads: int) -> torch.Tensor:
    """codes uint8[W + k - 1] (255-separated reads, 255 also for invalid
    bases) + the start offset of each read (int64, ascending) -> blrg
    uint8[max_reads]."""
    W = codes.shape[0] - k + 1
    keys, valid = dk.kmerize_flat(codes, k)
    qE = torch.where(valid, (dk.normalize(keys, k) << 2) | 3, SENT)
    return _classify_join(set_E, qE, _read_ids(starts, W), max_reads)


def classify_batch_packed(words: torch.Tensor, inval: torch.Tensor,
                          starts: torch.Tensor, set_E: torch.Tensor, k: int,
                          max_reads: int, C: int) -> torch.Tensor:
    """:func:`classify_batch` over the packed format (``io.stream.pack_chunk``:
    int32 view of the 2-bit words, the invalid-code bitmap) of C windows.
    The bitmap gives the window validity; the read ids come from ``starts``."""
    keys, valid = kmerize_packed(words, inval, k, C)
    qE = torch.where(valid, (dk.normalize(keys, k) << 2) | 3, SENT)
    return _classify_join(set_E, qE, _read_ids(starts, C), max_reads)


def classify_batch_periodic(words: torch.Tensor, nwin: int, set_E: torch.Tensor,
                            k: int, max_reads: int, C: int, T: int) -> torch.Tensor:
    """:func:`classify_batch_packed` for reads of one length laid out with
    period T (T - 1 bases + 1 separator, reads starting at phase 0): only
    the words are needed.  Window q belongs to read q // T and is valid iff
    q % T <= T - 1 - k and q < nwin."""
    keys = kmerize_words(words.to(torch.int64) & M32, k, C)
    q = torch.arange(C, dtype=torch.int64, device=words.device)
    valid = (q % T <= T - 1 - k) & (q < nwin)
    qE = torch.where(valid, (dk.normalize(keys, k) << 2) | 3, SENT)
    return _classify_join(set_E, qE, q // T, max_reads)


def _default_window(codes_list, floor: int) -> int:
    """The window the JAX package's batching takes: ``floor`` lanes, or the whole input rounded
    up to a power of two (at least 2^12) when that is smaller."""
    window = floor
    if isinstance(codes_list, list):
        total = sum(len(c) + 1 for c in codes_list)
        if total < window:
            window = max(1 << 12, 1 << int(np.ceil(np.log2(max(total, 2)))))
    return window


def _batches(codes_list, window: int, max_reads: int):
    """Split the reads into batches of at most ``max_reads`` reads and
    ``window`` codes, separators included."""
    buf: list[np.ndarray] = []
    buf_len = 0
    for c in codes_list:
        if (buf_len + len(c) + 1 > window or len(buf) >= max_reads) and buf:
            yield buf
            buf, buf_len = [], 0
        buf.append(c)
        buf_len += len(c) + 1
    if buf:
        yield buf


def _flat_batch(buf: list[np.ndarray], k: int, window: int):
    """One batch -> (255-separated codes padded to ``window + k - 1``, the
    start offset of each read)."""
    parts = []
    for c in buf:
        parts.append(c)
        parts.append(np.array([255], np.uint8))
    flat = np.concatenate(parts)
    pad = window + k - 1 - len(flat)
    if pad < 0:
        raise ValueError("batch exceeds window; lower batch size")
    flat = np.concatenate([flat, np.full(pad, 255, np.uint8)])
    lens = np.array([len(c) + 1 for c in buf], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return flat, starts


def _valid_windows(flat: np.ndarray, k: int) -> int:
    """Windows of ``flat`` (a batch of :func:`_flat_batch`) whose ``k`` codes
    are all bases: over the runs between non-bases (separators, padding,
    N), each run's length less ``k - 1``."""
    cut = np.concatenate([[-1], np.flatnonzero(flat >= 4), [len(flat)]])
    runs = np.diff(cut) - k
    return int(runs[runs > 0].sum())


def _gather(out_dev, out_counts) -> np.ndarray:
    """Per-batch device results -> one host array (one copy at the end)."""
    if not out_dev:
        return np.zeros(0, np.uint8)
    with profile.context("classify/wait"):
        out = torch.cat([b[:n] for b, n in zip(out_dev, out_counts)])
        profile.count("d2h_bytes", out.nbytes)
        return out.cpu().numpy()


def classify_codes_device(codes_list, set_E: torch.Tensor, k: int,
                          window: int | None = None) -> np.ndarray:
    """Host driver: list of per-read code arrays -> blrg per read (numpy).

    The JAX package's batching rules: the window is at least 2^22 lanes and
    at least the set, rounded to a power of two, unless the whole input is
    smaller; ``max_reads = window // 32`` (at least 256) bounds the reads of
    a batch; a batch of reads of one length and no invalid base takes the
    periodic engine, any other the packed one (the flat-code engine only
    when the window is not a multiple of 16).  Per-batch results stay on
    the device; one copy to the host at the end.  While profiling is on,
    the counters ``#join_lanes`` (query lanes launched, padding included)
    and ``#join_windows`` (the valid windows among them) add up each batch.
    """
    from ..io.stream import pack_chunk

    device = set_E.device
    if window is None:
        window = _default_window(codes_list, max(1 << 22, 1 << int(np.ceil(
            np.log2(max(int(set_E.shape[0]), 1) + 1)))))
    max_reads = max(256, window // 32)
    packed_ok = window % 16 == 0
    out_dev = []
    out_counts = []

    def to_dev(a: np.ndarray) -> torch.Tensor:
        profile.count("h2d_bytes", a.nbytes)
        return torch.from_numpy(a).to(device)

    for buf in _batches(codes_list, window, max_reads):
        n_reads = len(buf)
        with profile.context("classify/pack"):
            flat, starts = _flat_batch(buf, k, window)
            L = len(buf[0])
            uniform = (packed_ok and all(len(c) == L for c in buf)
                       and bool((flat[: n_reads * (L + 1)].reshape(
                           n_reads, L + 1)[:, :L] < 4).all()))
            if packed_ok:
                words, inval = pack_chunk(flat, k, window)
            if profile.enabled():
                profile.count("join_lanes", window)
                profile.count("join_windows", _valid_windows(flat, k))
        with profile.context("classify/launch"):
            if uniform:
                # one length and no invalid base: position masks replace
                # the invalid-code bitmap and the read starts
                T = L + 1
                nwin = max(0, n_reads * T - k + 1)
                out_dev.append(classify_batch_periodic(
                    to_dev(words.view(np.int32)), nwin, set_E, k, max_reads,
                    window, T))
            elif packed_ok:
                out_dev.append(classify_batch_packed(
                    to_dev(words.view(np.int32)), to_dev(inval), to_dev(starts),
                    set_E, k, max_reads, window))
            else:
                out_dev.append(classify_batch(to_dev(flat), to_dev(starts),
                                              set_E, k, max_reads))
        out_counts.append(n_reads)
    return _gather(out_dev, out_counts)


# ------------------------------------------------------------ the rank join
def join_ranks_batch(codes: torch.Tensor, set_keys: torch.Tensor, k: int,
                     set_pay: torch.Tensor | None = None) -> torch.Tensor:
    """codes uint8[W + k - 1] (255-separated) -> int64[W]: for each window
    the rank of its normalized k-mer in the sorted plane ``set_keys`` (int64,
    distinct), or -1.  The sort-join for sets whose per-key payload stays on
    the host as ``annot[rank]`` (``annotate-kmers`` / ``classify-reads``):
    the sorted queries are merged into the set by
    :func:`..ops.merge.merge_sorted` (set lanes first on equal keys), a
    ``cumsum`` of the set lanes gives each query lane the rank of the latest
    set lane before it, and the ranks are scattered back to window order.
    ``set_pay``: a tensor of -1 as long as the set, to reuse across batches."""
    W = codes.shape[0] - k + 1
    keys, valid = dk.kmerize_flat(codes, k)
    out = torch.full((W + 1,), -1, dtype=torch.int64, device=codes.device)
    if set_keys.numel() == 0:
        return out[:W]
    if set_pay is None:
        set_pay = torch.full_like(set_keys, -1)
    q_sorted, perm = torch.sort(torch.where(valid, dk.normalize(keys, k), SENT))
    merged, pay = merge_sorted(set_keys, set_pay, q_sorted, perm)
    is_set = pay < 0
    r = torch.cumsum(is_set, 0) - 1
    match = (~is_set & (r >= 0) & (set_keys[r.clamp(min=0)] == merged)
             & (merged != SENT))
    # set lanes land in the spare slot W
    out.scatter_(0, torch.where(is_set, W, pay), torch.where(match, r, -1))
    return out[:W]


def join_ranks_device(codes_list, set_keys: torch.Tensor, k: int,
                      window: int | None = None):
    """Batching on the host: list of read code arrays -> (rid int64[M], rank
    int64[M]) over all MATCHED windows, read ids in input order.
    ``set_keys`` is the set's sorted int64 key plane on the device to run
    on (``convert.set_from_u64`` of ``KmerSet.lo``).  The window is the
    whole input rounded up to a power of two, between 2^12 and 2^22 lanes;
    a read longer than the window raises "batch exceeds window"."""
    device = set_keys.device
    if window is None:
        window = _default_window(codes_list, 1 << 22)
    set_pay = torch.full_like(set_keys, -1)
    out_dev = []
    rids = []
    rid_base = 0
    for buf in _batches(codes_list, window, max_reads=window + 1):
        with profile.context("classify/pack"):
            flat, starts = _flat_batch(buf, k, window)
            rids.append(rid_base + np.searchsorted(
                starts, np.arange(window, dtype=np.int64), side="right") - 1)
            rid_base += len(buf)
        with profile.context("classify/launch"):
            out_dev.append(join_ranks_batch(torch.from_numpy(flat).to(device),
                                            set_keys, k, set_pay))
    if not out_dev:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    with profile.context("classify/wait"):
        ranks = torch.cat(out_dev).cpu().numpy()
    m = ranks >= 0
    return np.concatenate(rids)[m], ranks[m]


# ------------------------------------------------------------------ wide keys
def encode_set_wide(lo, hi, lhs, rhs, k: int):
    """Annotated wide set (numpy uint64 ``lo``, ``hi`` planes, membership
    bits) -> ``(e_hi, e_lo)`` numpy uint64 planes of E = (key << 2) | class,
    sorted, with every class re-represented by its min-by-value k-mer, so
    queries skip the FNV hash."""
    lo = np.asarray(lo, np.uint64)
    hi = np.asarray(hi, np.uint64)
    rlo, rhi = K.reverse_complement(lo, hi, k)
    take = K.less128(rlo, rhi, lo, hi)
    vlo = np.where(take, rlo, lo)
    vhi = np.where(take, rhi, hi)
    order = np.lexsort((vlo, vhi))
    vlo, vhi = vlo[order], vhi[order]
    cls = ((np.asarray(lhs, np.uint64) << np.uint64(1))
           | np.asarray(rhs, np.uint64))[order]
    return ((vhi << np.uint64(2)) | (vlo >> np.uint64(62)),
            (vlo << np.uint64(2)) | cls)


def join_wide(set_hi: torch.Tensor, set_lo: torch.Tensor, q_hi: torch.Tensor,
              q_lo: torch.Tensor, low_bits: int = 0) -> torch.Tensor:
    """Rank in the sorted set (distinct keys, lanes of
    :mod:`..ops.engine_wide`) of the entry matching each query, -1 where
    none does.  The ``low_bits`` lowest bits of ``lo`` are ignored in the
    comparison (a class tag); queries must then carry the highest tag, so
    that a stable sort puts the set lane first in its key group."""
    n_set, n_q = set_hi.numel(), q_hi.numel()
    out = torch.full((n_q + 1,), -1, dtype=torch.int64, device=q_hi.device)
    if n_set == 0 or n_q == 0:
        return out[:n_q]
    src = torch.arange(n_set + n_q, dtype=torch.int64, device=q_hi.device)
    hi, lo, src = ew.sort_lanes(torch.cat([set_hi, q_hi]),
                                torch.cat([set_lo, q_lo]), src)
    is_set = src < n_set
    # rank of the latest set lane at or before each lane (a cumsum, not a
    # cummax of codes: torch's cummax scan is ~100x slower on the card)
    r = torch.cumsum(is_set, 0) - 1
    rc = r.clamp(min=0)
    match = (~is_set & (r >= 0) & (set_hi[rc] == hi)
             & ((set_lo[rc] >> low_bits) == (lo >> low_bits)))
    out.scatter_(0, torch.where(is_set, n_q, src - n_set),
                 torch.where(match, r, -1))
    return out[:n_q]


def classify_batch_wide(codes: torch.Tensor, starts: torch.Tensor,
                        set_hi: torch.Tensor, set_lo: torch.Tensor, k: int,
                        max_reads: int) -> torch.Tensor:
    """Wide-key :func:`classify_batch`: codes uint8[W + k - 1] and read start
    offsets, the set's E lanes (:func:`encode_set_wide` through
    ``convert.wide_set_from_u64``) -> blrg uint8[max_reads]."""
    W = codes.shape[0] - k + 1
    *limbs, valid = ew.kmerize_planes_wide(codes, k)
    n3, n2, n1, n0 = ew.canon_value_wide(*limbs, k)
    q_hi, q_lo = ew.to_lanes(((n3 << 2) | (n2 >> 30)) & M32,
                             ((n2 << 2) | (n1 >> 30)) & M32,
                             ((n1 << 2) | (n0 >> 30)) & M32,
                             ((n0 << 2) | 3) & M32)
    q_hi = torch.where(valid, q_hi, ew.SENT)
    q_lo = torch.where(valid, q_lo, ew.SENT)
    r = join_wide(set_hi, set_lo, q_hi, q_lo, low_bits=2)
    hit = (r >= 0) & valid
    cls = set_lo[r.clamp(min=0)] & 3 if set_lo.numel() else torch.zeros_like(r)
    return _agg_blrg(torch.where(hit, _read_ids(starts, W), -1), cls, max_reads)


def classify_codes_device_wide(codes_list, set_planes, k: int,
                               window: int | None = None) -> np.ndarray:
    """Batching for the wide classifier: list of per-read code arrays ->
    blrg per read (numpy); ``set_planes`` the set's ``(hi, lo)`` E lanes on
    the device to run on.  The JAX package's batching: the window is the whole
    input rounded up to a power of two, between 2^12 and 2^22 lanes, and
    ``max_reads = window // 32`` (at least 256).  A read longer than the
    window raises "batch exceeds window"."""
    set_hi, set_lo = set_planes
    device = set_hi.device
    if window is None:
        window = _default_window(codes_list, 1 << 22)
    max_reads = max(256, window // 32)
    out_dev = []
    out_counts = []
    for buf in _batches(codes_list, window, max_reads):
        with profile.context("classify/pack"):
            flat, starts = _flat_batch(buf, k, window)
        with profile.context("classify/launch"):
            out_dev.append(classify_batch_wide(
                torch.from_numpy(flat).to(device),
                torch.from_numpy(starts).to(device), set_hi, set_lo, k,
                max_reads))
        out_counts.append(len(buf))
    return _gather(out_dev, out_counts)
