"""Reverse complement and canonicalization of narrow int64 keys.

Counterpart of ``gossamer_tpu/ops/engine.py`` ``_rev2_u32`` /
``rc_planes`` / ``canon_value`` and the ``"plain"`` mode.  The 2-bit
reverse runs on 32-bit halves held in int64 and every result is masked,
so no value reaches bit 63 (``~x`` and ``>>`` on int64 are signed).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
MODES = ("plain", "value")


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


def canonicalize(keys: torch.Tensor, rho: int, mode: str) -> torch.Tensor:
    """Apply the engine's canonicalization ``mode``.  The reference FNV
    order (``"ref"``, build-kmer-set) is not ported yet."""
    if mode == "value":
        return canon_value(keys, rho)
    if mode == "plain":
        return keys
    raise NotImplementedError(
        f"canonicalization mode {mode!r} is not ported (have {MODES})")
