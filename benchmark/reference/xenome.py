"""``xenome index`` and ``xenome classify`` of the original gossamer
(``src/XenoApp.cc``, ``src/GossCmdComputeNearKmers.cc``,
``src/GossCmdGroupReads.cc``), plain:

1. each reference's canonical k-mers, their union, and for every k-mer
   whether the graft (lhs) and the host (rhs) hold it;
2. near k-mers: a k-mer of one reference alone is marginal, and loses both
   bits, when a canonical probe ``x ^ (b << j)`` (b in 1..3, j in 0..k-1:
   a *bit* offset, as the reference shifts) is a k-mer of the other
   reference alone; every probe reads the bits before any is cleared;
3. a read's class bits: for each valid window whose canonical k-mer is in
   the index, the bit ``1 << (lhs << 1 | rhs)``, OR-ed over the read;
4. the output class of those bits (``GossCmdGroupReads.cc:606-621``).
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import canonical, lookup, window_keys

# output class files, in the order of CLASS_OF_BITS' values
CLASSES = ("neither", "both", "ambiguous", "graft", "host")
_N, _B, _A, _G, _H = range(5)
# bits 8 both, 4 graft alone, 2 host alone, 1 marginal
CLASS_OF_BITS = (_N, _B, _H, _H, _G, _G, _A, _A, _B, _B, _H, _H, _G, _G, _A, _A)

PROBE_BLOCK = 1 << 21
READ_BLOCK = 1 << 17


def kmer_set(codes: np.ndarray, k: int, device) -> torch.Tensor:
    """Ascending distinct canonical k-mers of one reference's codes."""
    keys, valid = window_keys(torch.from_numpy(codes[None, :]).to(device), k)
    return torch.unique(canonical(keys[valid], k), sorted=True)


def index(graft: np.ndarray, host: np.ndarray, k: int, device,
          near_kmers: bool = True):
    """(ascending int64 k-mers, int64 class lhs << 1 | rhs of each).
    ``near_kmers=False`` is the control: it keeps the marginal k-mers'
    bits, where the guarantee clears them."""
    g = kmer_set(graft, k, device)
    h = kmer_set(host, k, device)
    keys = torch.unique(torch.cat([g, h]), sorted=True)
    lhs = lookup(g, keys)[1]
    rhs = lookup(h, keys)[1]
    if near_kmers:
        gray = marginal(keys, lhs, rhs, k)
        lhs = lhs & ~gray
        rhs = rhs & ~gray
    return keys, lhs.to(torch.int64) * 2 + rhs.to(torch.int64)


def marginal(keys, lhs, rhs, k: int) -> torch.Tensor:
    """bool per k-mer: step 2 of the module's list."""
    excl = torch.nonzero(lhs != rhs).flatten()
    out = torch.zeros_like(lhs)
    for s in range(0, excl.numel(), PROBE_BLOCK):
        idx = excl[s : s + PROBE_BLOCK]
        x, x_lhs = keys[idx], lhs[idx]
        found = torch.zeros_like(x_lhs)
        for j in range(k):
            for b in (1, 2, 3):
                r, hit = lookup(keys, canonical(x ^ (b << j), k))
                found |= hit & (lhs[r] != rhs[r]) & (lhs[r] != x_lhs)
        out[idx] = found
    return out


def read_classes(reads: np.ndarray, keys, cls, k: int, device) -> np.ndarray:
    """Read codes uint8[n, length] -> uint8 index into CLASSES of each."""
    table = torch.tensor(CLASS_OF_BITS, dtype=torch.uint8, device=device)
    out = []
    for s in range(0, len(reads), READ_BLOCK):
        codes = torch.from_numpy(np.ascontiguousarray(reads[s : s + READ_BLOCK])).to(device)
        win, valid = window_keys(codes, k)
        r, hit = lookup(keys, canonical(win, k))
        hit &= valid
        c = cls[r]
        bits = torch.zeros(codes.shape[0], dtype=torch.int64, device=device)
        for v in range(4):
            bits |= (hit & (c == v)).any(dim=1).to(torch.int64) << v
        out.append(table[bits].cpu())
    return torch.cat(out).numpy()
