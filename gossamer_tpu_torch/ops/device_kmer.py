"""K-windows of flat code streams and their normalization, on narrow int64
keys (``gossamer_tpu/ops/device_kmer.py`` ``kmerize_flat`` / ``normalize``).

A narrow k-mer (2k <= 62 bits) is one non-negative int64 lane; the
normalization is the reference's min by (FNV hash, value)
(:func:`..canon.canon_ref`).
"""

from __future__ import annotations

import torch

from .canon import canon_ref


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
