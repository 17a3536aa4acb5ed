"""Packed-stream k-merization on int64 keys.

Counterpart of ``gossamer_tpu/ops/engine.py`` ``kmerize_packed`` /
``_kmerize_words``.  Windows come out in natural order (window ``p`` at
index ``p``), not the JAX package's phase-major order: every consumer
sorts.

Keys are built from 32-bit halves held in int64, so no intermediate
reaches bit 63: ``>>`` on int64 is arithmetic, and a value with bit 63
set would smear its sign into the key.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def kmerize_words(words: torch.Tensor, rho: int, C: int) -> torch.Tensor:
    """int64[..., C//16 + 2] packed words (values < 2^32) -> int64[..., C]
    keys: window ``p`` is bits ``[2p, 2p + 2*rho)`` of the big-endian
    2-bit stream (one funnel shift per phase)."""
    C16 = C // 16
    A = words[..., :C16]
    B = words[..., 1 : C16 + 1]
    Cw = words[..., 2 : C16 + 2]
    sh = 64 - 2 * rho  # narrow keys: 2 <= sh
    phases = []
    for ph in range(16):
        s = 2 * ph
        if s == 0:
            hi, lo = A, B
        else:
            hi = ((A << s) | (B >> (32 - s))) & M32
            lo = ((B << s) | (Cw >> (32 - s))) & M32
        if sh < 32:
            phases.append((hi << (32 - sh)) | (lo >> sh))
        elif sh == 32:
            phases.append(hi)
        else:
            phases.append(hi >> (sh - 32))
    # [..., C16, 16] -> natural window order p = 16*i + ph
    return torch.stack(phases, dim=-1).reshape(*words.shape[:-1], C)


def windows_without(inv: torch.Tensor, rho: int, C: int) -> torch.Tensor:
    """0/1 (or bool) flags of the C + rho - 1 codes on the last axis ->
    bool[..., C]: no flagged code in [p, p + rho)."""
    cnt = torch.cumsum(inv[..., : C + rho - 1], dim=-1, dtype=torch.int32)
    hi_cnt = cnt[..., rho - 1 : rho - 1 + C]
    lo_cnt = torch.cat([torch.zeros_like(cnt[..., :1]), cnt[..., : C - 1]],
                       dim=-1)
    return hi_cnt == lo_cnt


def window_valid(inval: torch.Tensor, rho: int, C: int) -> torch.Tensor:
    """uint8[..., V] invalid-code bitmap (little-endian, bit p set iff code
    p is not a base) -> bool[..., C]: no invalid code in [p, p + rho)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=inval.device)
    bits = (inval[..., :, None] >> shifts) & 1
    return windows_without(bits.reshape(*inval.shape[:-1], -1), rho, C)


def kmerize_packed(words_i32: torch.Tensor, inval: torch.Tensor, rho: int,
                   C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed chunks -> (keys int64[..., C], valid bool[..., C]).

    ``words_i32``: int32 view of uint32[..., C//16 + 2] (see
    ``io.stream.pack_chunk``); ``inval``: uint8[..., ceil((C+rho-1)/8)].
    """
    if C % 16:
        raise ValueError(f"packed chunks need C % 16 == 0 (C={C})")
    if 2 * rho > 62:
        raise ValueError(f"narrow keys need 2*rho <= 62 (rho={rho})")
    # uint32 words travel as an int32 view; widen to int64 in [0, 2^32)
    keys = kmerize_words(words_i32.to(torch.int64) & M32, rho, C)
    return keys, window_valid(inval, rho, C)


def kmerize_planes(codes: torch.Tensor, rho: int):
    """uint8[..., W] raw codes -> (keys int64[..., W - rho + 1], valid
    bool[...]) of the windows (``gossamer_tpu/ops/engine.py``
    ``kmerize_planes``, one int64 lane a key in place of two u32 planes).

    Bases A=0 C=1 G=2 T=3 (``src/GossReadBaseString.hh``); any code >= 4
    (separator 255 / N) invalidates the windows covering it.
    """
    if 2 * rho > 62:
        raise ValueError(f"narrow keys need 2*rho <= 62 (rho={rho})")
    C = codes.shape[-1] - rho + 1
    keys = torch.zeros(*codes.shape[:-1], C, dtype=torch.int64,
                       device=codes.device)
    valid = torch.ones(keys.shape, dtype=torch.bool, device=codes.device)
    for j in range(rho):
        b = codes[..., j : j + C]
        valid &= b < 4
        keys <<= 2
        keys |= b & 3
    return keys, valid

