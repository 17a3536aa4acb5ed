"""Writers for the reference's on-disk artifacts (bidirectional interop);
host copy of ``gossamer_tpu/io/reference_write.py``.

Counterpart of :mod:`reference_format` (the readers): produces the FULL
reference file set — Elias-Fano ``SparseArray`` with both ``DenseSelect``
acceleration indexes, quantized-width ``IntegerArray`` low bits,
``VariableByteArray`` counts and the ``-counts-hist.txt`` — so graphs and
k-mer sets written by this engine open in the ORIGINAL gossamer binaries
(``Graph::open``/``Graph::LazyIterator``), and our artifacts get the
reference's compressed storage density (~2 + log2(U/n) bits per edge
instead of plain 8-16 B arrays).

Layouts replicated from (file:line citations, behavior re-implemented
vectorized in numpy):

* ``SparseArray::Builder`` — ``src/SparseArray.{hh:87-130,cc:40-133}``:
  D = clamp(ceil(log2(n / ((1+m)/ln 2))), 8, 128), quantizedD = next
  multiple of 8, high bits unary at ``(e >> D) + i``, end-padding with a
  zero for every possible ``i >> D`` (``SparseArray.cc:76-103``).
* ``WordyBitVector::Builder`` — ``src/WordyBitVector.{hh:54-133,cc:11-30}``:
  raw little-endian u64 words; ``pad(h); end()`` leaves
  ``(h + 1)//64 + 1`` words.
* ``DenseSelect::Builder`` — ``src/DenseArray.{hh:63-170,cc:446-690}``:
  4096-byte header region, 8192-entry blocks typed small (span < 2^16:
  u16 sample offsets), intermediate (span < 2^24: u32 sample offsets +
  u16 typed sub-block pointers + spill payloads), or full-spill
  (u32 relative / u64 absolute); 16-byte-aligned index and rank arrays
  appended, 128-byte header rewritten at offset 0.
* ``VariableByteArray::Builder`` — ``src/VariableByteArray.{hh:76-118,
  cc:22-43}``: ``.ord0`` low bytes, ``.ord1p``/``.ord2p`` rank
  SparseArrays (D sized from ``(numItems, numItems*0.001)``), ``.ord1``
  second bytes, ``.ord2`` u16 high parts.
* ``Graph::Builder`` — ``src/Graph.{hh:95-127,cc:116-192}``; KmerSet —
  ``src/KmerSet.hh:26-80``.

Validated by byte-identical round-trips against fixtures produced by the
reference's own builders (``scripts/baseline/make_ref_graph.cc``).
"""

from __future__ import annotations

import math
import struct

import numpy as np

from .factory import FileFactory
from .reference_format import (GRAPH_VERSION, KMER_SET_VERSION,
                               SPARSE_VERSION, _STACKED)

DENSE_SELECT_VERSION = 2012092701

# DenseSelect tuning constants (src/DenseArray.hh:81-97)
_LOG_BLOCK = 13
_BLOCK = 1 << _LOG_BLOCK            # ones per block
_LOG_SAMPLE = 6
_SAMPLE = 1 << _LOG_SAMPLE          # gap between samples
_SMALL_SPAN = 1 << 16               # sSmallBlock
_INTER_SPAN = 1 << 24               # sIntermediateBlock
_HEADER_REGION = 4096               # MAX_HEADER_SIZE

# block/sub-block type tags (src/DenseArray.hh:188-196)
_T_SMALL, _T_SPILL64, _T_SPILL32, _T_SPILL16, _T_SPILL8, _T_INTER = range(6)


def _align(buf: bytearray, mask: int) -> None:
    while len(buf) & mask:
        buf.append(0)


def write_dense_select(fac: FileFactory, name: str, positions: np.ndarray,
                       invert: bool) -> None:
    """Write one DenseSelect index over ``positions`` (sorted u64 bit
    positions of the indexed sense — ones for d1, zeros for d0)."""
    pos = np.ascontiguousarray(positions, dtype=np.uint64)
    buf = bytearray()
    stats = {
        "numBlocks": 0, "small": 0, "smallSize": 0, "inter": 0,
        "interSize": 0, "large": 0, "largeSize": 0,
    }
    index: list[int] = []
    rank: list[int] = []
    buf.extend(b"\0" * _HEADER_REGION)  # header + alignment pad

    n = len(pos)
    for start in range(0, n, _BLOCK):
        block = pos[start : start + _BLOCK]
        filepos = len(buf)
        pp = int(block[0])
        span = int(block[-1]) - pp
        if span >= _INTER_SPAN or len(block) < _BLOCK:
            # large block, or the (partial) last block
            if span < (1 << 32):
                buf.extend((block - np.uint64(pp)).astype("<u4").tobytes())
                index.append(filepos | _T_SPILL32)
            else:
                # absolute positions (historical quirk, DenseArray.cc:485)
                buf.extend(block.astype("<u8").tobytes())
                index.append(filepos | _T_SPILL64)
            stats["large"] += 1
            stats["largeSize"] += len(buf) - filepos
        elif span >= _SMALL_SPAN:
            # intermediate block: u32 sample offsets, u16 sub pointers,
            # then spill payloads for wide sub-blocks
            size0 = len(buf)
            samples = block.reshape(-1, _SAMPLE)
            sub_start = samples[:, 0]
            sub_range = (samples[:, -1] - samples[:, 0]).astype(np.int64)
            buf.extend((sub_start - np.uint64(pp)).astype("<u4").tobytes())
            n_sub = len(sub_start)
            base = n_sub * (4 + 2)
            base = (base + 7) & ~7
            ptrs = np.zeros(n_sub, dtype=np.uint16)
            for i in range(n_sub):
                r = int(sub_range[i])
                if r <= (_BLOCK >> _LOG_SAMPLE):
                    ptrs[i] = _T_SMALL  # null pointer: bit-scan fallback
                elif r < (1 << 8):
                    ptrs[i] = base | _T_SPILL8
                    base += _SAMPLE
                elif r < (1 << 16):
                    ptrs[i] = base | _T_SPILL16
                    base += _SAMPLE * 2
                else:
                    ptrs[i] = base | _T_SPILL32
                    base += _SAMPLE * 4
                base = (base + 7) & ~7
            if base > (1 << 16):
                raise ValueError("intermediate sub-blocks too large")
            buf.extend(ptrs.astype("<u2").tobytes())
            for i in range(n_sub):
                if not ptrs[i]:
                    continue
                _align(buf, 7)
                rel = samples[i] - sub_start[i]
                t = ptrs[i] & 7
                if t == _T_SPILL8:
                    buf.extend(rel.astype("<u1").tobytes())
                elif t == _T_SPILL16:
                    buf.extend(rel.astype("<u2").tobytes())
                else:
                    buf.extend(rel.astype("<u4").tobytes())
            index.append(filepos | _T_INTER)
            stats["inter"] += 1
            stats["interSize"] += len(buf) - size0
        else:
            # small block: u16 per-sample offsets from the block start
            offs = (block[::_SAMPLE] - np.uint64(pp)).astype("<u2")
            buf.extend(offs.tobytes())
            index.append(filepos | _T_SMALL)
            stats["small"] += 1
            stats["smallSize"] += len(offs) * 2
        rank.append(pp)
        _align(buf, 7)
        stats["numBlocks"] += 1

    _align(buf, 15)
    index_off = len(buf)
    buf.extend(np.asarray(index, dtype="<u8").tobytes())
    rank_off = len(buf)
    buf.extend(np.asarray(rank, dtype="<u8").tobytes())
    index_size = (len(index) + len(rank)) * 8

    flags = 1 if invert else 0
    header = struct.pack(
        "<16Q", DENSE_SELECT_VERSION, flags, index_off, rank_off,
        _LOG_BLOCK, _BLOCK, _LOG_SAMPLE, _SAMPLE,
        stats["numBlocks"], index_size,
        stats["small"], stats["smallSize"],
        stats["inter"], stats["interSize"],
        stats["large"], stats["largeSize"])
    buf[: len(header)] = header
    with fac.open_write(name) as f:
        f.write(bytes(buf))


def _write_integer_array(fac: FileFactory, base: str, bits: int,
                         values: np.ndarray) -> None:
    """IntegerArray file(s) of the given quantized width
    (``src/IntegerArray.cc:258-340`` builder dispatch)."""
    flat = {8: "<u1", 16: "<u2", 32: "<u4", 64: "<u8"}
    if bits in flat:
        with fac.open_write(base) as f:
            f.write(values.astype(flat[bits]).tobytes())
        return
    if bits not in _STACKED or bits > 64:
        raise ValueError(f"unsupported IntegerArray width {bits}")
    ub, lb = _STACKED[bits]
    _write_integer_array(fac, base + ".upr", ub,
                         values >> np.uint64(lb))
    _write_integer_array(fac, base + ".lwr", lb,
                         values & np.uint64((1 << lb) - 1))


def _choose_d(n_bits_or_value: float, m: int) -> int:
    """``SparseArray::Builder::d`` (``src/SparseArray.cc:48-71``)."""
    d0 = math.log2(n_bits_or_value / ((1 + m) * 1.4426950408889634))
    d = math.ceil(d0)
    return min(max(d, 8), 128)


def write_sparse_array(fac: FileFactory, base: str, lo: np.ndarray,
                       hi: np.ndarray, *, size_log2: int | None = None,
                       size: int | None = None, d_n: float | None = None,
                       d_m: int | None = None) -> None:
    """Write a full SparseArray (header, high-bits, low-bits, -d0, -d1).

    ``size`` (or ``size_log2``) is the value passed to ``end()`` — the
    total position space; ``d_n``/``d_m`` size the low-bit width D
    (default: the same n and the stored count, as Graph/KmerSet do).
    """
    count = len(lo)
    if size is None:
        size = 1 << size_log2
    n_f = float(size) if d_n is None else float(d_n)
    m = count if d_m is None else d_m
    D = _choose_d(n_f, m)
    qd = 8 * ((D + 7) // 8)
    if D >= 64:
        raise NotImplementedError("SparseArray D >= 64 (write)")
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    high = lo >> np.uint64(D)
    if D:
        high |= hi << np.uint64(64 - D)
    ones = high + np.arange(count, dtype=np.uint64)
    nd = size >> D
    h_total = nd + count + 2
    if count and int(ones[-1]) + 1 > h_total:
        raise ValueError("entry beyond declared size")

    # high-bits WordyBitVector: pad(h_total) + end -> (h+1)//64 + 1 words
    n_words = (h_total + 1) // 64 + 1
    bits = np.zeros(n_words * 64, dtype=np.uint8)
    bits[ones] = 1
    words = np.packbits(bits, bitorder="little").view("<u8")
    with fac.open_write(base + ".high-bits") as f:
        f.write(words.tobytes())

    # select indexes: d1 over ones, d0 over the zeros in [0, h_total)
    write_dense_select(fac, base + "-d1", ones, invert=False)
    all_pos = np.arange(h_total, dtype=np.uint64)
    zero_mask = np.ones(h_total, dtype=bool)
    zero_mask[ones] = False
    write_dense_select(fac, base + "-d0", all_pos[zero_mask], invert=True)

    low = lo & np.uint64((1 << D) - 1)
    _write_integer_array(fac, base + ".low-bits", qd, low)

    dmask = (1 << D) - 1
    header = struct.pack(
        "<QQQQQQQQ", SPARSE_VERSION, D, qd,
        dmask & ((1 << 64) - 1), dmask >> 64,
        size & ((1 << 64) - 1), size >> 64, count)
    with fac.open_write(base + ".header") as f:
        f.write(header)


def write_variable_byte_array(fac: FileFactory, base: str,
                              values: np.ndarray,
                              num_items: int | None = None) -> None:
    """Write a VariableByteArray (.ord0/.ord1p/.ord1/.ord2p/.ord2)."""
    v = np.ascontiguousarray(values, dtype=np.int64)
    if num_items is None:
        num_items = len(v)
    with fac.open_write(base + ".ord0") as f:
        f.write((v & 0xFF).astype("<u1").tobytes())
    m1 = (v >> 8) != 0
    p1 = np.nonzero(m1)[0].astype(np.uint64)
    v1 = v[m1] >> 8
    with fac.open_write(base + ".ord1") as f:
        f.write((v1 & 0xFF).astype("<u1").tobytes())
    m2 = (v1 >> 8) != 0
    p2 = np.nonzero(m2)[0].astype(np.uint64)
    with fac.open_write(base + ".ord2") as f:
        f.write(((v1[m2] >> 8) & 0xFFFF).astype("<u2").tobytes())
    zero = np.zeros_like(p1)
    d_m = int(num_items * 0.001)
    write_sparse_array(fac, base + ".ord1p", p1, zero[: len(p1)],
                       size=len(v), d_n=float(num_items), d_m=d_m)
    write_sparse_array(fac, base + ".ord2p", p2, np.zeros_like(p2),
                       size=len(v1), d_n=float(num_items), d_m=d_m)


def write_reference_graph(fac: FileFactory, base: str, k: int,
                          lo: np.ndarray, hi: np.ndarray,
                          counts: np.ndarray, *, asymmetric: bool = False,
                          num_edges: int | None = None) -> None:
    """Write a graph the original gossamer can ``Graph::open``."""
    if num_edges is None:
        num_edges = len(lo)
    header = struct.pack("<QQQ", GRAPH_VERSION, k, 1 if asymmetric else 0)
    with fac.open_write(base + ".header") as f:
        f.write(header)
    write_sparse_array(fac, base + "-edges", lo, hi,
                       size_log2=2 * k + 2, d_m=num_edges)
    write_variable_byte_array(fac, base + "-counts",
                              np.asarray(counts, dtype=np.int64),
                              num_items=num_edges)
    cnt = np.asarray(counts, dtype=np.int64)
    uniq, freq = np.unique(cnt, return_counts=True)
    lines = "".join(f"{int(u)}\t{int(f)}\n" for u, f in zip(uniq, freq))
    fac.write_text(base + "-counts-hist.txt", lines)


def write_reference_kmer_set(fac: FileFactory, base: str, k: int,
                             lo: np.ndarray, hi: np.ndarray) -> None:
    """Write a k-mer set the original gossamer can open."""
    header = struct.pack("<QQQ", KMER_SET_VERSION, k, len(lo))
    with fac.open_write(base + ".header") as f:
        f.write(header)
    write_sparse_array(fac, base + ".kmers", lo, hi, size_log2=2 * k)
