"""Reverse complement and canonicalization of narrow int64 keys.

Counterpart of ``gossamer_tpu/ops/engine.py`` ``_rev2_u32`` /
``rc_planes`` / ``canon_value`` / ``fnv_planes`` / ``canon_ref`` and the
modes ``"plain"``, ``"value"`` and ``"ref"``.  The 2-bit reverse and the
FNV hash run on 32-bit halves held in int64 and every result is masked,
so no value reaches bit 63 (``~x`` and ``>>`` on int64 are signed, and a
64-bit ``*`` on int64 overflows).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
MODES = ("plain", "value", "ref")
FNV_OFFSET = 14695981039346656037
FNV_MUL_LO = 0x1B3  # the FNV prime is 2^40 + 0x1B3


def _rev2_u32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 2-bit groups of each value in [0, 2^32)
    (``src/Utils.hh:377-396``)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def rc(keys: torch.Tensor, rho: int) -> torch.Tensor:
    """Reverse complement of 2*rho-bit keys (``src/BigInteger.hh:193-216``:
    NOT, 2-bit reverse, shift down).  Keys must lie in [0, 2^(2*rho))."""
    n1 = _rev2_u32((keys & M32) ^ M32)  # the 64-bit reverse swaps halves
    n0 = _rev2_u32((keys >> 32) ^ M32)
    s = 64 - 2 * rho
    if s < 32:
        return (n1 << (32 - s)) | (n0 >> s)
    if s == 32:
        return n1
    return n1 >> (s - 32)


def canon_value(keys: torch.Tensor, rho: int) -> torch.Tensor:
    """min(x, rc(x)) by value: a consistent class representative for
    symmetric spectra."""
    return torch.minimum(keys, rc(keys, rho))


def _fnv_step(h1: torch.Tensor, h0: torch.Tensor, byte=None):
    """One FNV-1a step on the state (h1, h0): xor a byte into the low
    word, multiply by 2^40 + 0x1B3 mod 2^64.  The products stay below
    2^42."""
    if byte is not None:
        h0 = h0 ^ byte
    p0 = h0 * FNV_MUL_LO
    n1 = (h1 * FNV_MUL_LO + (p0 >> 32) + (h0 << 8)) & M32
    return n1, p0 & M32


def fnv_planes(keys: torch.Tensor):
    """FNV-1a over the 16 little-endian bytes of the 128-bit value of each
    key (the hi word is zero for narrow keys), ``src/BigInteger.hh:528-536,
    572-582``.  Returns the hash as (hi32, lo32) int64 tensors; compare
    hashes as unsigned pairs."""
    h1 = torch.full_like(keys, FNV_OFFSET >> 32)
    h0 = torch.full_like(keys, FNV_OFFSET & M32)
    for i in range(8):
        h1, h0 = _fnv_step(h1, h0, (keys >> (8 * i)) & 0xFF)
    for _ in range(8):  # the zero bytes of the hi word
        h1, h0 = _fnv_step(h1, h0)
    return h1, h0


def canon_ref(keys: torch.Tensor, rho: int) -> torch.Tensor:
    """Reference canonicalization: min by (FNV hash, value) of the key and
    its reverse complement (``src/RankSelect.hh:126-140``).  A palindrome
    ties on both and stays as it is."""
    r = rc(keys, rho)
    fh, fl = fnv_planes(keys)
    rh, rl = fnv_planes(r)
    take = (rh < fh) | ((rh == fh) & ((rl < fl) | ((rl == fl) & (r < keys))))
    return torch.where(take, r, keys)


def canonicalize(keys: torch.Tensor, rho: int, mode: str) -> torch.Tensor:
    """Apply the engine's canonicalization ``mode``: ``"plain"`` (as is),
    ``"value"`` (min by value) or ``"ref"`` (the reference's FNV order,
    build-kmer-set)."""
    if mode == "value":
        return canon_value(keys, rho)
    if mode == "ref":
        return canon_ref(keys, rho)
    if mode == "plain":
        return keys
    raise ValueError(f"canonicalization mode {mode!r} not in {MODES}")
