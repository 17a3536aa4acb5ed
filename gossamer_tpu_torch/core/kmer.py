"""128-bit k-mer arithmetic on the host (NumPy, vectorized).

Semantics tracked from the reference (cited per function):

* bases A=0, C=1, G=2, T=3 (``src/RankSelect.hh:299-315``)
* an *edge* is a (k+1)-mer ("rho-mer"); a *node* is a k-mer
  (``src/GossamerBaseEssentials`` / ``src/GraphEssentials.hh:60-70``)
* 128-bit values are two 64-bit words, little-endian word order
  (``src/BigInteger.hh`` ``mWords[0]`` = least significant)
* ``reverseComplement(k)`` = word-swapped base-4-reverse of the bitwise
  NOT, then right shift by ``128 - 2k`` (``src/BigInteger.hh:193-216``)
* the canonicalization hash is FNV-1a over the 16 little-endian bytes
  (``src/BigInteger.hh:528-536,572-582``), and ``normalize(k)`` picks the
  min by (hash, value) of the k-mer and its reverse complement
  (``src/RankSelect.hh:126-140``)

All functions are vectorized over parallel ``(lo, hi)`` uint64 arrays.
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

FNV_OFFSET = U64(14695981039346656037)
FNV_PRIME = U64(1099511628211)

BASE_CHARS = np.frombuffer(b"ACGT", dtype=np.uint8)

# Encode table: ASCII -> 2-bit code, 255 for invalid.
ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ENCODE_LUT[_c] = _i
    ENCODE_LUT[_c + 32] = _i  # lower case


def _make_rev2_lut() -> np.ndarray:
    b = np.arange(256, dtype=np.uint32)
    r = ((b & 0x33) << 2) | ((b >> 2) & 0x33)
    r = ((r & 0x0F) << 4) | ((r >> 4) & 0x0F)
    return r.astype(np.uint8)


_REV2_LUT = _make_rev2_lut()


def rev2(x: np.ndarray) -> np.ndarray:
    """Base-4 (2-bit group) reverse of each uint64. ``src/Utils.hh:377-396``.

    Byte-table formulation (reverse bytes + per-byte 2-bit reverse):
    ~7x the 5-pass u64 butterfly on numpy (one u8 gather vs 20 u64
    passes)."""
    x = np.ascontiguousarray(x, dtype=U64)
    if x.ndim != 1:  # scalars / nd arrays take the simple path
        b = _REV2_LUT[x[..., None].view(np.uint8)]
        return np.ascontiguousarray(b[..., ::-1]).view(U64).reshape(x.shape)
    b = _REV2_LUT[x.view(np.uint8).reshape(-1, 8)]
    return np.ascontiguousarray(b[:, ::-1]).view(U64).reshape(x.shape)


def reverse_complement(lo: np.ndarray, hi: np.ndarray, k: int):
    """Reverse complement of k-mers held as (lo, hi) 64-bit words.

    Mirrors ``BigInteger<2>::reverseComplement`` (``src/BigInteger.hh:193-216``):
    swap words, base-4-reverse the complement of each, shift right 128-2k.
    """
    if 2 * k <= 64 and not hi.any():
        # narrow fast path (one rev2 pass, hi plane untouched): with
        # hi == 0 the general formula reduces to rev2(~lo) >> (64 - 2k)
        r = rev2(~lo)
        if 2 * k < 64:
            r = r >> U64(64 - 2 * k)
        return r, np.zeros_like(lo)
    nlo = rev2(~hi)
    nhi = rev2(~lo)
    s = 128 - 2 * k
    if s == 0:
        return nlo, nhi
    if s < 64:
        lo2 = (nlo >> U64(s)) | (nhi << U64(64 - s))
        hi2 = nhi >> U64(s)
    elif s == 64:
        lo2 = nhi
        hi2 = np.zeros_like(nhi)
    else:
        lo2 = nhi >> U64(s - 64)
        hi2 = np.zeros_like(nhi)
    return lo2, hi2


def fnv_hash(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """FNV-1a over the 16 little-endian bytes (lo word first).

    Exact ``std::hash<BigInteger<2>>`` semantics
    (``src/BigInteger.hh:528-536`` calling ``wordHash`` at ``:572-582``).
    """
    seed = np.full(np.shape(lo), FNV_OFFSET, dtype=U64)
    mask = U64(0xFF)
    with np.errstate(over="ignore"):  # mod-2^64 wrap is intended
        for word in (np.asarray(lo, dtype=U64), np.asarray(hi, dtype=U64)):
            w = word.copy()
            for _ in range(8):
                seed = (seed ^ (w & mask)) * FNV_PRIME
                w = w >> U64(8)
    return seed


def less128(alo, ahi, blo, bhi):
    """a < b for 128-bit values as boolean array."""
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def normalize(lo: np.ndarray, hi: np.ndarray, k: int):
    """Canonicalize k-mers: min by (FNV hash, value) of kmer vs revcomp.

    ``Gossamer::position_type::normalize`` (``src/RankSelect.hh:126-140``).
    Returns (lo, hi, flipped) where flipped marks entries replaced by rc.
    """
    rlo, rhi = reverse_complement(lo, hi, k)
    h0 = fnv_hash(lo, hi)
    h1 = fnv_hash(rlo, rhi)
    take_rc = (h0 > h1) | ((h0 == h1) & less128(rlo, rhi, lo, hi))
    out_lo = np.where(take_rc, rlo, lo)
    out_hi = np.where(take_rc, rhi, hi)
    return out_lo, out_hi, take_rc


def encode_bases(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (255 = invalid base)."""
    if isinstance(seq, str):
        seq = seq.encode()
    if isinstance(seq, (bytes, bytearray)):
        seq = np.frombuffer(bytes(seq), dtype=np.uint8)
    return ENCODE_LUT[seq]


def string_to_kmer(s: str) -> tuple[int, int]:
    """One k-mer string -> (lo, hi) Python ints (for tests/small paths)."""
    v = 0
    for c in s:
        v = (v << 2) | int(ENCODE_LUT[ord(c)])
    return v & ((1 << 64) - 1), v >> 64


def kmer_to_string(k: int, lo, hi) -> str:
    """``Gossamer::kmerToString`` (``src/RankSelect.hh:299-308``)."""
    v = (int(hi) << 64) | int(lo)
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


def kmers_to_strings(k: int, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Vectorized k-mer -> fixed-width byte strings, shape (n, k) uint8."""
    n = len(lo)
    out = np.empty((n, k), dtype=np.uint8)
    lo = lo.astype(U64)
    hi = hi.astype(U64)
    for i in range(k):
        shift = 2 * (k - 1 - i)
        if shift >= 64:
            code = (hi >> U64(shift - 64)) & U64(3)
        elif shift > 0:
            # bits straddle only when shift in (62, 63) for odd splits; since
            # shift is even it is exactly 62 max below 64, plus bits from hi.
            code = ((lo >> U64(shift)) | (hi << U64(64 - shift))) & U64(3)
        else:
            code = lo & U64(3)
        out[:, i] = BASE_CHARS[code.astype(np.int64)]
    return out


def edge_from_node(lo, hi):
    """from(e) = e >> 2 (``src/GraphEssentials.hh:60-63``)."""
    lo = np.asarray(lo, dtype=U64)
    hi = np.asarray(hi, dtype=U64)
    return (lo >> U64(2)) | (hi << U64(62)), hi >> U64(2)


def edge_to_node(lo, hi, k: int):
    """to(e) = e & ((1<<2k)-1) (``src/GraphEssentials.hh:65-70``)."""
    lo = np.asarray(lo, dtype=U64)
    hi = np.asarray(hi, dtype=U64)
    if 2 * k >= 64:
        mask_hi = U64((1 << (2 * k - 64)) - 1)
        return lo, hi & mask_hi
    return lo & U64((1 << (2 * k)) - 1), np.zeros_like(hi)
