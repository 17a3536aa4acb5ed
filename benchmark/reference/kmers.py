"""k-mers as int64 values, the reference's semantics (data61/gossamer):

* bases A=0, C=1, G=2, T=3, the first base most significant
  (``src/RankSelect.hh:299-315``); a code of 4 or more is not a base;
* the reverse complement of a k-mer complements each base and reverses
  their order (``src/BigInteger.hh:193-216``);
* a k-mer's canonical form is the smaller, by (FNV-1a hash of the 16
  little-endian bytes of its 128-bit value, value), of the k-mer and its
  reverse complement (``src/RankSelect.hh:126-140``,
  ``src/BigInteger.hh:528-536,572-582``).

Every k here is at most 31, so a value fits a non-negative int64 and its
128-bit high word is zero.  Hash arithmetic wraps modulo 2^64 in int64.
"""

from __future__ import annotations

import torch

FNV_OFFSET = 14695981039346656037 - (1 << 64)  # as a signed 64-bit word
FNV_PRIME = 1099511628211
SIGN = -(1 << 63)


def window_keys(codes: torch.Tensor, k: int):
    """Codes uint8[rows, length] -> (int64 keys [rows, length - k + 1],
    bool valid: every base of the window is one of ACGT)."""
    if k > 31:
        raise ValueError(f"k = {k}: the reference holds k <= 31 in int64")
    c = codes.to(torch.int64)
    n_win = c.shape[1] - k + 1
    keys = torch.zeros(c.shape[0], n_win, dtype=torch.int64, device=c.device)
    for j in range(k):
        keys = keys * 4 + (c[:, j : j + n_win] & 3)
    bad = torch.cumsum((c >= 4).to(torch.int32), 1)
    bad = torch.nn.functional.pad(bad, (1, 0))
    valid = (bad[:, k:] - bad[:, :n_win]) == 0
    return keys, valid


def reverse_complement_codes(codes: torch.Tensor) -> torch.Tensor:
    """The other strand of each row; a code that is no base stays 4."""
    flipped = codes.flip(1)
    return torch.where(flipped < 4, 3 - flipped, torch.full_like(flipped, 4))


def reverse_complement(keys: torch.Tensor, k: int) -> torch.Tensor:
    x = keys
    r = torch.zeros_like(keys)
    for _ in range(k):
        r = r * 4 + (3 - (x & 3))
        x = x >> 2
    return r


def fnv1a(keys: torch.Tensor) -> torch.Tensor:
    """FNV-1a over the 16 little-endian bytes of each 128-bit value (the
    high word zero)."""
    h = torch.full_like(keys, FNV_OFFSET)
    for word in (keys, torch.zeros_like(keys)):
        for byte in range(8):
            h = (h ^ ((word >> (8 * byte)) & 0xFF)) * FNV_PRIME
    return h


def canonical(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Each k-mer or its reverse complement, the smaller by (unsigned FNV
    hash, value)."""
    rc = reverse_complement(keys, k)
    h0 = fnv1a(keys) ^ SIGN  # unsigned order as signed order
    h1 = fnv1a(rc) ^ SIGN
    take_rc = (h0 > h1) | ((h0 == h1) & (rc < keys))
    return torch.where(take_rc, rc, keys)


def lookup(sorted_keys: torch.Tensor, queries: torch.Tensor):
    """(index of each query in the ascending distinct ``sorted_keys``,
    clamped into range; whether it is there)."""
    if sorted_keys.numel() == 0:
        zero = torch.zeros_like(queries)
        return zero, torch.zeros_like(queries, dtype=torch.bool)
    r = torch.searchsorted(sorted_keys, queries).clamp(max=sorted_keys.numel() - 1)
    return r, sorted_keys[r] == queries
