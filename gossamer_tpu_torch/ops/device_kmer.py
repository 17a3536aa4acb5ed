"""Device k-mer arithmetic (``gossamer_tpu/ops/device_kmer.py``).

* K-windows of flat code streams and their normalization on narrow int64
  keys (``kmerize_flat`` / ``normalize``): a narrow k-mer (2k <= 62 bits)
  is one non-negative int64 lane; the normalization is the reference's min
  by (FNV hash, value) (:func:`..canon.canon_ref`).
* 128-bit k-mers as ``(lo, hi)`` int64 pairs, each the bit pattern of the
  JAX function's uint64 lane (``rev2``, ``reverse_complement``,
  ``fnv_hash``, ``less128``).  They split each word into 32-bit limbs and
  run the arithmetic of :mod:`.canon` and :mod:`.engine_wide` on them.
"""

from __future__ import annotations

import torch

from .canon import M32, _rev2_u32, canon_ref
from .engine_wide import TOP, fnv_planes_wide, rc_planes_wide


def _halves(x: torch.Tensor):
    """int64 bit pattern -> its (hi32, lo32) halves in [0, 2^32)."""
    return (x >> 32) & M32, x & M32


def _join(hi32: torch.Tensor, lo32: torch.Tensor) -> torch.Tensor:
    """(hi32, lo32) halves -> the int64 with that bit pattern (the top half
    taken as signed, so nothing overflows)."""
    return ((hi32 ^ (1 << 31)) - (1 << 31)) * (1 << 32) + lo32


def rev2(x: torch.Tensor) -> torch.Tensor:
    """Base-4 reverse of each 64-bit lane (``src/Utils.hh:377-396``): the
    halves swap and each reverses its 2-bit groups."""
    hi, lo = _halves(x)
    return _join(_rev2_u32(lo), _rev2_u32(hi))


def reverse_complement(lo: torch.Tensor, hi: torch.Tensor, k: int):
    """``BigInteger<2>::reverseComplement`` of 2k-bit keys
    (``src/BigInteger.hh:193-216``) -> ``(lo, hi)``."""
    p3, p2, p1, p0 = rc_planes_wide(*_halves(hi), *_halves(lo), k)
    return _join(p1, p0), _join(p3, p2)


def fnv_hash(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """FNV-1a over the 16 little-endian bytes of ``(lo, hi)``
    (``src/BigInteger.hh:528-536,572-582``) -> the 64-bit hash as int64."""
    return _join(*fnv_planes_wide(*_halves(hi), *_halves(lo)))


def less128(alo, ahi, blo, bhi) -> torch.Tensor:
    """``(alo, ahi) < (blo, bhi)`` as unsigned 128-bit values."""
    ahi, bhi, alo, blo = (t ^ TOP for t in (ahi, bhi, alo, blo))
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def kmerize_flat(codes: torch.Tensor, k: int):
    """uint8[C + k - 1] codes (255 = separator or invalid base) -> (keys
    int64[C], valid bool[C]) for the C windows; window ``p`` holds codes
    ``[p, p + k)`` big-endian."""
    if 2 * k > 62:
        raise ValueError(f"narrow keys need 2*k <= 62 (k={k})")
    C = codes.shape[0] - k + 1
    keys = torch.zeros(C, dtype=torch.int64, device=codes.device)
    valid = torch.ones(C, dtype=torch.bool, device=codes.device)
    for j in range(k):
        b = codes[j : j + C]
        valid &= b < 4
        keys = (keys << 2) | (b & 3).to(torch.int64)
    return keys, valid


def normalize(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical min by (hash, value) (``src/RankSelect.hh:126-140``)."""
    return canon_ref(keys, k)
