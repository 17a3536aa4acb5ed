"""ctypes binding for the native IO library (``native/gossio.cpp``).

Counterpart of ``gossamer_tpu/io/native.py``, narrowed to what the
counting engines run: the packed chunk reader (narrow keys), the raw code
chunk reader (wide keys), the symmetric expansion and the 64-bit and
128-bit spill codecs; to what the graph queries run on narrow graphs:
the blocked rank search, the chain walks, the fused node degrees and the
fused successor table; to what threading runs: the read-aligned
block reader and the rolling k-merizer; and to the pull of a spilled
spectrum: the delta decoder, with its numpy form beside it.  The library
is compiled at first use from the checkout's ``native/gossio.cpp`` with
the flags of ``native/Makefile`` into ``gossamer_tpu_torch/_build/``, so it
is always built for the machine that loads it.  A checked-in ``native/libgossio.so``
is never loaded and ``native/`` is never written.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterator

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "gossio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# native/Makefile: CXXFLAGS and LDFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall"]
LD_FLAGS = ["-shared", "-lz", "-lpthread"]

FMT_CODE = {None: 0, "fasta": 1, "fastq": 2, "line": 3}

_log = logging.getLogger(__name__)


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def build_library() -> tuple[Path, float]:
    """Compile ``libgossio.so`` when missing or older than its source.
    Returns (path, build seconds); seconds is 0.0 when it was current."""
    so = BUILD_DIR / "libgossio.so"
    if not _SRC.exists():
        raise NativeUnavailable(f"native source missing: {_SRC}")
    if so.exists() and so.stat().st_mtime >= _SRC.stat().st_mtime:
        return so, 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("no C++ compiler to build libgossio.so")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"libgossio.so.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp),
                           *LD_FLAGS], capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeUnavailable(f"building libgossio.so failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0


@functools.cache
def _load() -> ctypes.CDLL | NativeUnavailable:
    try:
        so, _ = build_library()
        lib = ctypes.CDLL(str(so))
    except (NativeUnavailable, OSError) as e:
        return e if isinstance(e, NativeUnavailable) else NativeUnavailable(str(e))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gossio_open.restype = ctypes.c_void_p
    lib.gossio_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
    lib.gossio_next_packed.restype = ctypes.c_long
    lib.gossio_next_packed.argtypes = [ctypes.c_void_p, u32p, u8p,
                                       ctypes.c_long, ctypes.c_int]
    lib.gossio_next_chunk.restype = ctypes.c_long
    lib.gossio_next_chunk.argtypes = [ctypes.c_void_p, u8p, ctypes.c_long,
                                      ctypes.c_int]
    lib.gossio_close.restype = None
    lib.gossio_close.argtypes = [ctypes.c_void_p]
    lib.gossio_eac_encode.restype = ctypes.c_long
    lib.gossio_eac_encode.argtypes = [ctypes.c_long, u64p, i64p, u8p]
    lib.gossio_eac_decode.restype = ctypes.c_long
    lib.gossio_eac_decode.argtypes = [u8p, ctypes.c_long, ctypes.c_long,
                                      u64p, i64p]
    lib.gossio_eac_encode128.restype = ctypes.c_long
    lib.gossio_eac_encode128.argtypes = [ctypes.c_long, u64p, u64p, i64p, u8p]
    lib.gossio_eac_decode128.restype = ctypes.c_long
    lib.gossio_eac_decode128.argtypes = [u8p, ctypes.c_long, ctypes.c_long,
                                         u64p, u64p, i64p]
    lib.gossio_expand_symmetric.restype = ctypes.c_long
    lib.gossio_expand_symmetric.argtypes = [ctypes.c_long, u64p, i64p,
                                            ctypes.c_int, u64p, i64p]
    lib.gossio_rank_u64.restype = None
    lib.gossio_rank_u64.argtypes = [u64p, ctypes.c_long, u64p, ctypes.c_long,
                                    i64p, ctypes.c_int]
    lib.gossio_merge_rank_u64.restype = None
    lib.gossio_merge_rank_u64.argtypes = [u64p, ctypes.c_long, u64p,
                                          ctypes.c_long, i64p]
    lib.gossio_chains.restype = ctypes.c_long
    lib.gossio_chains.argtypes = [i64p, ctypes.c_long, i64p, i64p, i64p]
    lib.gossio_node_degrees_u64.restype = None
    lib.gossio_node_degrees_u64.argtypes = [u64p, ctypes.c_long, ctypes.c_int,
                                            u64p, ctypes.c_long, i64p, i64p,
                                            ctypes.c_int]
    lib.gossio_kmerize_u64.restype = None
    lib.gossio_kmerize_u64.argtypes = [u8p, ctypes.c_long, ctypes.c_int, u64p,
                                       u8p]
    lib.gossio_next_block.restype = ctypes.c_long
    lib.gossio_next_block.argtypes = [ctypes.c_void_p, u8p, ctypes.c_long]
    lib.gossio_successor_table_u64.restype = None
    lib.gossio_successor_table_u64.argtypes = [u64p, ctypes.c_long,
                                               ctypes.c_int, i64p, ctypes.c_int]
    lib.gossio_delta_unpack.restype = None
    lib.gossio_delta_unpack.argtypes = [ctypes.c_long, u32p, u8p,
                                        ctypes.c_long, u32p, u32p, u32p, u32p,
                                        u64p, i64p]
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library; raises :class:`NativeUnavailable` otherwise."""
    lib = _load()
    if isinstance(lib, NativeUnavailable):
        raise NativeUnavailable(str(lib))
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


@functools.cache
def _log_form(what: str, form: str) -> None:
    """One log line per (query, form): which implementation answers it."""
    _log.log(logging.WARNING if form != "native" else logging.INFO,
             "%s: %s", what, form)


def native_or_none(what: str, fn, *args):
    """``fn(*args)`` from the native library, or None when the library is
    unavailable, so that the caller runs its numpy form.  Only
    :class:`NativeUnavailable` is caught; which form answers ``what`` is
    logged once."""
    try:
        out = fn(*args)
    except NativeUnavailable as e:
        _log_form(what, f"numpy (native library unavailable: {e})")
        return None
    _log_form(what, "native")
    return out


def encode_spill_run(lo: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(ascending u64 keys, i64 counts) -> varint-delta bytes, the
    reference's spill-format design (``src/EdgeAndCount.hh:78-112``)."""
    lib = load_library()
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out = np.empty(20 * max(n, 1), np.uint8)
    m = lib.gossio_eac_encode(n, _ptr(lo, ctypes.c_uint64),
                              _ptr(c, ctypes.c_int64), _ptr(out, ctypes.c_uint8))
    return out[:m].copy()


def decode_spill_run(buf: np.ndarray, n: int):
    """Inverse of :func:`encode_spill_run` -> (lo u64, c i64)."""
    lib = load_library()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lo = np.empty(n, np.uint64)
    c = np.empty(n, np.int64)
    got = lib.gossio_eac_decode(_ptr(buf, ctypes.c_uint8), len(buf), n,
                                _ptr(lo, ctypes.c_uint64),
                                _ptr(c, ctypes.c_int64))
    if got != n:
        raise ValueError("truncated spill run")
    return lo, c


def encode_spill_run128(lo: np.ndarray, hi: np.ndarray,
                        c: np.ndarray) -> np.ndarray:
    """128-bit-key spill run (ascending by (hi, lo)) -> varint bytes: two
    delta limbs and the count per record, the reference codec's shape
    (``src/EdgeAndCount.hh:86-97``)."""
    lib = load_library()
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out = np.empty(30 * max(n, 1), np.uint8)
    m = lib.gossio_eac_encode128(n, _ptr(lo, ctypes.c_uint64),
                                 _ptr(hi, ctypes.c_uint64),
                                 _ptr(c, ctypes.c_int64),
                                 _ptr(out, ctypes.c_uint8))
    return out[:m].copy()


def decode_spill_run128(buf: np.ndarray, n: int):
    """Inverse of :func:`encode_spill_run128` -> (lo u64, hi u64, c i64)."""
    lib = load_library()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lo = np.empty(n, np.uint64)
    hi = np.empty(n, np.uint64)
    c = np.empty(n, np.int64)
    got = lib.gossio_eac_decode128(_ptr(buf, ctypes.c_uint8), len(buf), n,
                                   _ptr(lo, ctypes.c_uint64),
                                   _ptr(hi, ctypes.c_uint64),
                                   _ptr(c, ctypes.c_int64))
    if got != n:
        raise ValueError("truncated spill run")
    return lo, hi, c


def native_expand_symmetric(lo: np.ndarray, c: np.ndarray, rho: int):
    """Canonical spectrum -> symmetric fwd+rc spectrum via the C
    single-pass rc + radix sort + merge.  ``lo`` ascending uint64
    (< 2^62), ``c`` int64."""
    lib = load_library()
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out_lo = np.empty(2 * n, np.uint64)
    out_c = np.empty(2 * n, np.int64)
    m = lib.gossio_expand_symmetric(n, _ptr(lo, ctypes.c_uint64),
                                    _ptr(c, ctypes.c_int64), rho,
                                    _ptr(out_lo, ctypes.c_uint64),
                                    _ptr(out_c, ctypes.c_int64))
    return out_lo[:m], out_c[:m]


# ------------------------------------------- the pull of a spilled spectrum
def native_delta_unpack(d: np.ndarray, cpack_u8: np.ndarray,
                        e_lane: np.ndarray, e1: np.ndarray, e0: np.ndarray,
                        ec: np.ndarray, n_out: int):
    """Decode the delta-compressed pull in one pass -> ``(lo u64, counts
    i64)``: ``d`` the uint32 deltas, ``cpack_u8`` the saturated counts, the
    exception rows ``(e_lane, e1, e0, ec)`` (uint32, lanes ascending) exact
    keys ``e1 << 32 | e0`` and counts."""
    lib = load_library()
    d = np.ascontiguousarray(d, dtype=np.uint32)
    cpack_u8 = np.ascontiguousarray(cpack_u8, dtype=np.uint8)
    e_lane, e1, e0, ec = (np.ascontiguousarray(x, dtype=np.uint32)
                          for x in (e_lane, e1, e0, ec))
    lo = np.empty(n_out, np.uint64)
    c = np.empty(n_out, np.int64)
    u32 = ctypes.c_uint32
    lib.gossio_delta_unpack(n_out, _ptr(d, u32), _ptr(cpack_u8, ctypes.c_uint8),
                            len(e_lane), _ptr(e_lane, u32), _ptr(e1, u32),
                            _ptr(e0, u32), _ptr(ec, u32),
                            _ptr(lo, ctypes.c_uint64), _ptr(c, ctypes.c_int64))
    return lo, c


def delta_unpack_plain(d: np.ndarray, cpack_u8: np.ndarray,
                       e_lane: np.ndarray, e1: np.ndarray, e0: np.ndarray,
                       ec: np.ndarray, n_out: int):
    """numpy form of :func:`native_delta_unpack`: a cumulative sum of the
    deltas, rebased at each exception lane."""
    d = d[:n_out].astype(np.uint64)
    c = cpack_u8[:n_out].astype(np.int64)
    e_lane = e_lane.astype(np.int64)
    e_lo = (e1.astype(np.uint64) << np.uint64(32)) | e0
    e_c = ec.astype(np.int64)
    keep = e_lane < n_out
    e_lane, e_lo, e_c = e_lane[keep], e_lo[keep], e_c[keep]
    d[e_lane] = 0
    cs = np.cumsum(d)
    # lo[i] = exact(e) + (cs[i] - cs[e]) for the exception lane e governing i
    adj = np.zeros(n_out, np.uint64)
    patch = e_lo - cs[e_lane]
    adj[e_lane] = patch - np.concatenate([np.zeros(1, np.uint64), patch[:-1]])
    c[e_lane] = e_c
    return cs + np.cumsum(adj), c


def native_packed_chunks(
    paths: list[str], k: int, chunk: int = 1 << 22, fmt: str | None = None,
    threads: int = 1,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield ``(words, inval)`` packed chunks (see ``io.stream.pack_chunk``)
    straight from the native reader.  Requires ``chunk % 16 == 0`` and
    ``k <= 33``; ``threads`` parser threads decode whole files
    concurrently, so chunks of different files may interleave (fine for
    counting).  Raises :class:`NativeUnavailable` before reading anything
    when the library is missing."""
    lib = load_library()
    if chunk % 16 or k > 33:
        raise ValueError(f"packed chunks need chunk % 16 == 0 and k <= 33 "
                         f"(chunk={chunk}, k={k})")
    return _packed_chunks(lib, paths, k, chunk, fmt, threads)


def _packed_chunks(lib, paths, k, chunk, fmt, threads):
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.gossio_open(arr, len(paths), FMT_CODE.get(fmt, 0),
                             max(int(threads), 1))
    overlap = k - 1
    n_words = chunk // 16 + 2
    n_inval = (chunk + overlap + 7) // 8
    try:
        while True:
            words = np.empty(n_words, dtype=np.uint32)
            inval = np.empty(n_inval, dtype=np.uint8)
            n = lib.gossio_next_packed(handle, _ptr(words, ctypes.c_uint32),
                                       _ptr(inval, ctypes.c_uint8), chunk,
                                       overlap)
            if n < 0:
                raise RuntimeError("gossio_next_packed: bad geometry")
            if n == 0:
                break
            yield words, inval
    finally:
        lib.gossio_close(handle)


def native_flat_chunks(
    paths: list[str], k: int, chunk: int = 1 << 22, fmt: str | None = None,
    threads: int = 1,
) -> Iterator[np.ndarray]:
    """Native equivalent of ``io.stream.flat_code_chunks``: yields uint8
    arrays of ``chunk + k - 1`` raw codes (255 = separator or invalid base),
    the last one padded with 255.  Any ``k``; the wide engine's feed, since
    the packed reader stops at an overlap of 32 bases.  ``threads`` as in
    :func:`native_packed_chunks`.  Raises :class:`NativeUnavailable` before
    reading anything when the library is missing."""
    return _flat_chunks(load_library(), paths, k, chunk, fmt, threads)


def _flat_chunks(lib, paths, k, chunk, fmt, threads):
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.gossio_open(arr, len(paths), FMT_CODE.get(fmt, 0),
                             max(int(threads), 1))
    overlap = k - 1
    try:
        while True:
            buf = np.empty(chunk + overlap, dtype=np.uint8)
            n = lib.gossio_next_chunk(handle, _ptr(buf, ctypes.c_uint8), chunk,
                                      overlap)
            if n <= 0:
                break
            yield buf
    finally:
        lib.gossio_close(handle)


# ------------------------------------------------------- narrow graph queries
def native_rank_u64(a: np.ndarray, q: np.ndarray, threads: int = 2) -> np.ndarray:
    """lower_bound ranks of ``q`` in sorted ``a`` (both u64).  Sorted query
    streams take the O(n+m) linear-merge path automatically."""
    lib = load_library()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    q = np.ascontiguousarray(q, dtype=np.uint64)
    out = np.empty(len(q), dtype=np.int64)
    pa, pq = _ptr(a, ctypes.c_uint64), _ptr(q, ctypes.c_uint64)
    po = _ptr(out, ctypes.c_int64)
    # linear merge pays off when q is sorted and a is not much larger
    # (merge scans all of a; binary search costs m*log n probes)
    if (len(q) > 2 and len(a) <= 8 * len(q)
            and bool((q[1:] >= q[:-1]).all())):
        lib.gossio_merge_rank_u64(pa, len(a), pq, len(q), po)
    else:
        lib.gossio_rank_u64(pa, len(a), pq, len(q), po, threads)
    return out


def native_chains(nxt: np.ndarray):
    """Chain decomposition of a successor table: (start, pos, order,
    n_live) with cycle edges start = -1."""
    lib = load_library()
    nxt = np.ascontiguousarray(nxt, dtype=np.int64)
    n = len(nxt)
    start = np.empty(n, dtype=np.int64)
    pos = np.zeros(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    n_live = lib.gossio_chains(_ptr(nxt, ctypes.c_int64), n,
                               _ptr(start, ctypes.c_int64),
                               _ptr(pos, ctypes.c_int64),
                               _ptr(order, ctypes.c_int64))
    return start, pos, order[:n_live], n_live


def native_node_degrees(lo: np.ndarray, rho: int, nodes: np.ndarray,
                        threads: int = 2):
    """(out_degree, in_degree) of node keys against the sorted narrow
    edge array (2*rho <= 64)."""
    if 2 * rho > 64:
        raise ValueError(f"native node degrees need 2*rho <= 64 (rho={rho})")
    lib = load_library()
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    nodes = np.ascontiguousarray(nodes, dtype=np.uint64)
    out_d = np.empty(len(nodes), dtype=np.int64)
    in_d = np.empty(len(nodes), dtype=np.int64)
    lib.gossio_node_degrees_u64(_ptr(lo, ctypes.c_uint64), len(lo), rho,
                                _ptr(nodes, ctypes.c_uint64), len(nodes),
                                _ptr(out_d, ctypes.c_int64),
                                _ptr(in_d, ctypes.c_int64), threads)
    return out_d, in_d


def native_successor_table(lo: np.ndarray, rho: int,
                           threads: int = 2) -> np.ndarray:
    """Fused successor table over sorted narrow edges (2*rho <= 64)."""
    if 2 * rho > 64:
        raise ValueError(f"native successor table needs 2*rho <= 64 (rho={rho})")
    lib = load_library()
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    nxt = np.empty(len(lo), dtype=np.int64)
    lib.gossio_successor_table_u64(_ptr(lo, ctypes.c_uint64), len(lo), rho,
                                   _ptr(nxt, ctypes.c_int64), threads)
    return nxt


# ------------------------------------------------------------------ threading
def native_kmerize_u64(codes: np.ndarray, rho: int):
    """255-separated code stream -> (lo u64, valid u8) per window, in one
    sequential pass.  Narrow keys only (2*rho <= 64)."""
    if 2 * rho > 64:
        raise ValueError(f"native kmerize needs 2*rho <= 64 (rho={rho})")
    lib = load_library()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n_win = len(codes) - rho + 1
    if n_win <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint8)
    lo = np.empty(n_win, dtype=np.uint64)
    valid = np.empty(n_win, dtype=np.uint8)
    lib.gossio_kmerize_u64(_ptr(codes, ctypes.c_uint8), len(codes), rho,
                           _ptr(lo, ctypes.c_uint64), _ptr(valid, ctypes.c_uint8))
    return lo, valid


def native_read_blocks(paths: list[str], fmt: str | None = None,
                       threads: int = 1) -> Iterator[np.ndarray]:
    """Read-aligned code blocks (~4 MB each) straight from the native
    reader: each read's codes followed by 255.  A base other than ACGT is
    255 too, so a block alone does not tell read ends from ``N``s
    (:func:`read_lengths` does).  With ``threads`` above 1, blocks of
    different files interleave.  Raises :class:`NativeUnavailable` before
    reading anything when the library is missing."""
    return _read_blocks(load_library(), paths, fmt, threads)


def _read_blocks(lib, paths, fmt, threads):
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.gossio_open(arr, len(paths), FMT_CODE.get(fmt, 0),
                             max(int(threads), 1))
    cap = (4 << 20) + (1 << 16)
    try:
        while True:
            buf = np.empty(cap, dtype=np.uint8)
            n = lib.gossio_next_block(handle, _ptr(buf, ctypes.c_uint8), cap)
            if n == 0:
                break
            if n < 0:
                cap = -n
                continue
            yield buf[:n]
    finally:
        lib.gossio_close(handle)


def read_lengths(path: str, fmt: str) -> np.ndarray:
    """Lengths of the reads the native reader emits for one file, in
    order, by the line rules of its parser (``native/gossio.cpp``
    ``parseFile``/``handleLine``): lines end at ``\\n``, a trailing ``\\r``
    is dropped, FASTQ takes the second line of every four, FASTA joins the
    non-empty lines between headers, line format takes every non-empty
    line.  numpy over the file's bytes (gzip is inflated first)."""
    import gzip

    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    buf = np.frombuffer(raw, dtype=np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], nl + 1])
    ends = np.concatenate([nl, [len(buf)]])
    if starts[-1] == len(buf):  # no unterminated last line
        starts, ends = starts[:-1], ends[:-1]
    ln = ends - starts
    cr = ln > 0
    cr[cr] = buf[ends[cr] - 1] == ord("\r")
    ln = ln - cr
    if fmt == "fastq":
        ln = ln[1::4]
        return ln[ln > 0]
    if fmt == "fasta":
        head = np.zeros(len(ln), dtype=bool)
        head[ln > 0] = buf[starts[ln > 0]] == ord(">")
        seq = (ln > 0) & ~head
        group = np.cumsum(head)[seq]
        total = np.bincount(group, weights=ln[seq], minlength=1)
        return total[np.bincount(group, minlength=1) > 0].astype(np.int64)
    return ln[ln > 0]
