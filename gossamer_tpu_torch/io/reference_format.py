"""Readers for the reference's on-disk artifacts (interop); host copy of
``gossamer_tpu/io/reference_format.py``.

Opens graphs / k-mer sets written by the ORIGINAL gossamer binaries, so
a user can `goss upgrade-graph` (or read directly) and keep working:

* ``{base}.header`` — raw little-endian struct: Graph
  ``{u64 version(2011101014), u64 K, u64 flags}`` (``src/Graph.hh:
  65-83``); KmerSet ``{u64 version(2011101701), u64 K, u64 count}``
  (``src/KmerSet.hh:32-45``).
* ``{base}-edges`` / ``{base}.kmers`` — an Elias-Fano SparseArray
  (``src/SparseArray.hh:42-377``): 64-byte header ``{u64 version
  (2012030501), u64 D, u64 quantizedD, u128 DMask, u128 size, u64
  count}``; ``.high-bits`` = raw u64 words (bit i of the unary stream
  is bit ``i % 64`` of word ``i // 64``, ``src/WordyBitVector.hh``);
  ``.low-bits`` = an IntegerArray of width quantizedD (byte-quantized):
  flat little-endian array for widths {8,16,32,64}, recursively stacked
  ``.upr``/``.lwr`` raw arrays otherwise (``src/IntegerArray.cc:
  258-340``).  Entry i decodes as ``((select1(i) - i) << D) | low[i]``.
  The ``-d0``/``-d1`` DenseSelect files are acceleration indexes only
  and are ignored.
* ``{base}-counts`` — a VariableByteArray (``src/VariableByteArray.hh:
  59-284``): ``.ord0`` u8 low bytes; ``.ord1p`` SparseArray of ranks
  with a second byte in ``.ord1``; ``.ord2p`` SparseArray (in ord1
  coordinates) of entries with two more bytes in ``.ord2`` (u16 LE).

Generating test fixtures: ``scripts/baseline/make_ref_graph.cc``
compiles the reference's own Builders against the Boost shims and
writes genuine reference-format artifacts from dump-graph text.
"""

from __future__ import annotations

import struct

import numpy as np

from .factory import FileFactory

GRAPH_VERSION = 2011101014
KMER_SET_VERSION = 2011101701
SPARSE_VERSION = 2012030501

# IntegerArray width -> (upr_width, lwr_width) or None for flat storage
# (the builder() dispatch table, src/IntegerArray.cc:258-340)
_STACKED = {
    24: (8, 16), 40: (8, 32), 48: (16, 32), 56: (8, 48), 72: (8, 64),
    80: (16, 64), 88: (8, 80), 96: (32, 64), 104: (8, 96), 112: (16, 96),
    120: (24, 96), 128: (64, 64),
}
_FLAT_DTYPE = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}


def _read_bytes(fac: FileFactory, name: str) -> bytes:
    with fac.open_read(name) as f:
        return f.read()


def _read_integer_array(fac: FileFactory, base: str, bits: int) -> np.ndarray:
    """IntegerArray values as uint64 (widths above 64 unsupported)."""
    if bits in _FLAT_DTYPE:
        raw = np.frombuffer(_read_bytes(fac, base), dtype=_FLAT_DTYPE[bits])
        return raw.astype(np.uint64)
    if bits not in _STACKED:
        raise ValueError(f"unsupported IntegerArray width {bits}")
    ub, lb = _STACKED[bits]
    if bits > 64:
        raise NotImplementedError(
            f"IntegerArray width {bits} > 64 (low bits this wide need a "
            f"denser key space than any real graph)")
    upr = _read_integer_array(fac, base + ".upr", ub)
    lwr = _read_integer_array(fac, base + ".lwr", lb)
    return (upr << np.uint64(lb)) | lwr


def _select1_all(words: np.ndarray) -> np.ndarray:
    """Positions of all set bits, ascending (bit p = word[p//64] >> p%64)."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.uint64)


def read_sparse_array(fac: FileFactory, base: str):
    """-> (lo u64, hi u64) of the stored 128-bit positions, ascending."""
    hdr = _read_bytes(fac, base + ".header")
    version, d, qd = struct.unpack_from("<QQQ", hdr, 0)
    count = struct.unpack_from("<Q", hdr, 56)[0]
    if version != SPARSE_VERSION:
        raise ValueError(f"SparseArray version {version} != {SPARSE_VERSION}")
    words = np.frombuffer(_read_bytes(fac, base + ".high-bits"),
                          dtype=np.uint64)
    pos1 = _select1_all(words)[:count]
    high = pos1 - np.arange(count, dtype=np.uint64)
    low = _read_integer_array(fac, base + ".low-bits", int(qd))[:count]
    if d >= 64:
        raise NotImplementedError("SparseArray D >= 64")
    lo = (high << np.uint64(d)) | low
    hi = high >> np.uint64(64 - d) if d else np.zeros_like(high)
    return lo, hi


def read_variable_byte_array(fac: FileFactory, base: str) -> np.ndarray:
    """-> int64 values (the reference's edge counts)."""
    ord0 = np.frombuffer(_read_bytes(fac, base + ".ord0"), dtype=np.uint8)
    vals = ord0.astype(np.int64)
    p1, _ = read_sparse_array(fac, base + ".ord1p")
    if len(p1):
        ord1 = np.frombuffer(_read_bytes(fac, base + ".ord1"),
                             dtype=np.uint8).astype(np.int64)
        vals[p1] |= ord1[: len(p1)] << 8
        p2, _ = read_sparse_array(fac, base + ".ord2p")
        if len(p2):
            ord2 = np.frombuffer(_read_bytes(fac, base + ".ord2"),
                                 dtype="<u2").astype(np.int64)
            # ord2p positions are in ord1 coordinates
            vals[p1[p2]] |= ord2[: len(p2)] << 16
    return vals


def is_reference_graph(fac: FileFactory, base: str) -> bool:
    """True when ``base`` is a reference-format graph or k-mer set."""
    try:
        hdr = _read_bytes(fac, base + ".header")
    except Exception:
        return False
    if len(hdr) < 16:
        return False
    version = struct.unpack_from("<Q", hdr, 0)[0]
    return version in (GRAPH_VERSION, KMER_SET_VERSION)


def read_reference_graph(fac: FileFactory, base: str):
    """Reference-format graph -> our :class:`..graph.graph.Graph`
    (``Graph::open``, ``src/Graph.cc:200-260``)."""
    from ..graph.graph import Graph

    hdr = _read_bytes(fac, base + ".header")
    version, k, flags = struct.unpack_from("<QQQ", hdr, 0)
    if version != GRAPH_VERSION:
        raise ValueError(f"graph version {version} != {GRAPH_VERSION}")
    lo, hi = read_sparse_array(fac, base + "-edges")
    counts = read_variable_byte_array(fac, base + "-counts")[: len(lo)]
    return Graph(int(k), lo, hi, counts, asymmetric=bool(flags & 1))


def read_reference_kmer_set(fac: FileFactory, base: str):
    """Reference-format k-mer set -> our KmerSet (``src/KmerSet.hh``)."""
    from ..graph.kmer_set import KmerSet

    hdr = _read_bytes(fac, base + ".header")
    version, k, _count = struct.unpack_from("<QQQ", hdr, 0)
    if version != KMER_SET_VERSION:
        raise ValueError(f"kmer-set version {version} != {KMER_SET_VERSION}")
    lo, hi = read_sparse_array(fac, base + ".kmers")
    return KmerSet(int(k), lo, hi)
