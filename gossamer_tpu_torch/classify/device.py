"""Device-side read classification (the xenome lookup engine) on torch.

Counterpart of ``gossamer_tpu/classify/device.py`` for narrow keys
(k <= 30: 2k + 2 <= 62 bits).  The join is the JAX package's sort-join
with the set kept sorted:

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
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import device_kmer as dk
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


def classify_codes_device(codes_list, set_E: torch.Tensor, k: int,
                          window: int | None = None) -> np.ndarray:
    """Host driver: list of per-read code arrays -> blrg per read (numpy).

    The JAX package's batching rules: the window is at least 2^22 lanes and
    at least the set, rounded to a power of two, unless the whole input is
    smaller; ``max_reads = window // 32`` (at least 256) bounds the reads of
    a batch; a batch of reads of one length and no invalid base takes the
    periodic engine, any other the packed one (the flat-code engine only
    when the window is not a multiple of 16).  Per-batch results stay on
    the device; one copy to the host at the end.
    """
    from ..io.stream import pack_chunk

    device = set_E.device
    if window is None:
        total = sum(len(c) + 1 for c in codes_list) if isinstance(
            codes_list, list) else None
        window = max(1 << 22, 1 << int(np.ceil(np.log2(
            max(int(set_E.shape[0]), 1) + 1))))
        if total is not None and total < window:
            window = max(1 << 12, 1 << int(np.ceil(np.log2(max(total, 2)))))
    max_reads = max(256, window // 32)
    packed_ok = window % 16 == 0
    out_dev = []
    out_counts = []
    buf: list[np.ndarray] = []
    buf_len = 0

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    def flush(n_reads):
        with profile.context("classify/pack"):
            parts = []
            for c in buf:
                parts.append(c)
                parts.append(np.array([255], np.uint8))
            flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
            pad = window + k - 1 - len(flat)
            if pad < 0:
                raise ValueError("batch exceeds window; lower batch size")
            flat = np.concatenate([flat, np.full(pad, 255, np.uint8)])
            lens = np.array([len(c) + 1 for c in buf], np.int64)
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
            L = len(buf[0]) if buf else 0
            uniform = (packed_ok and buf
                       and all(len(c) == L for c in buf)
                       and bool((flat[: n_reads * (L + 1)].reshape(
                           n_reads, L + 1)[:, :L] < 4).all()))
            if packed_ok:
                words, inval = pack_chunk(flat, k, window)
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

    for c in codes_list:
        if (buf_len + len(c) + 1 > window or len(buf) >= max_reads) and buf:
            flush(len(buf))
            buf, buf_len = [], 0
        buf.append(c)
        buf_len += len(c) + 1
    if buf:
        flush(len(buf))
    if not out_dev:
        return np.zeros(0, np.uint8)
    with profile.context("classify/wait"):
        return torch.cat([b[:n] for b, n in zip(out_dev, out_counts)]).cpu().numpy()
