"""Small vectorized 128-bit helpers over (lo, hi) uint64 planes."""

from __future__ import annotations

import numpy as np

U64 = np.uint64


def shl(lo, hi, s: int):
    """(lo, hi) << s for 0 <= s < 64."""
    lo = np.asarray(lo, dtype=U64)
    hi = np.asarray(hi, dtype=U64)
    if s == 0:
        return lo, hi
    return lo << U64(s), (hi << U64(s)) | (lo >> U64(64 - s))


def shr(lo, hi, s: int):
    lo = np.asarray(lo, dtype=U64)
    hi = np.asarray(hi, dtype=U64)
    if s == 0:
        return lo, hi
    if s < 64:
        return (lo >> U64(s)) | (hi << U64(64 - s)), hi >> U64(s)
    if s == 64:
        return hi.copy(), np.zeros_like(hi)
    return hi >> U64(s - 64), np.zeros_like(hi)


def add_small(lo, hi, v: int):
    """(lo, hi) + v for small non-negative v."""
    lo = np.asarray(lo, dtype=U64)
    hi = np.asarray(hi, dtype=U64)
    nlo = lo + U64(v)
    carry = (nlo < lo).astype(U64)
    return nlo, hi + carry


def less(alo, ahi, blo, bhi):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def eq(alo, ahi, blo, bhi):
    return (alo == blo) & (ahi == bhi)


def to_int(lo, hi) -> int:
    return (int(hi) << 64) | int(lo)


def from_int(v: int):
    return U64(v & ((1 << 64) - 1)), U64(v >> 64)
