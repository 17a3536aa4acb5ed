"""The edge spectrum of ``goss build-graph``: every (k+1)-mer window of
every read whose bases are all ACGT, counted in both orientations
(``src/GossCmdBuildGraph.cc`` inserts each window and its reverse
complement, so a palindrome counts twice), as ascending distinct keys with
their counts."""

from __future__ import annotations

import numpy as np
import torch

from .kmers import reverse_complement_codes, window_keys

BLOCK_ROWS = 1 << 19


def edge_spectrum(reads: np.ndarray, rho: int, device,
                  drop_reads_with_n: bool = False):
    """Read codes uint8[n, length] -> (int64 keys ascending, int64 counts)
    on ``device``.  ``drop_reads_with_n`` is the control: it leaves out
    every read that holds an N, where the guarantee counts its other
    windows."""
    if drop_reads_with_n:
        reads = reads[~(reads >= 4).any(axis=1)]
    parts = []
    for s in range(0, len(reads), BLOCK_ROWS):
        codes = torch.from_numpy(np.ascontiguousarray(reads[s : s + BLOCK_ROWS])).to(device)
        for strand in (codes, reverse_complement_codes(codes)):
            keys, valid = window_keys(strand, rho)
            parts.append(keys[valid])
        del codes
    keys, counts = torch.unique(torch.cat(parts), sorted=True,
                                return_counts=True)
    return keys, counts.to(torch.int64)


def mismatched(ref_keys: torch.Tensor, ref_counts: torch.Tensor,
               got_keys: torch.Tensor, got_counts: torch.Tensor) -> int:
    """Edges whose (key, count) one side holds and the other does not: 0
    exactly when the two spectra are equal.  ``got`` may be out of order or
    hold a key twice; each such lane counts."""
    if (got_keys.shape == ref_keys.shape and torch.equal(got_keys, ref_keys)
            and torch.equal(got_counts, ref_counts)):
        return 0
    order = torch.sort(got_keys, stable=True).indices
    gk, gc = got_keys[order], got_counts[order]
    first = torch.ones_like(gk, dtype=torch.bool)
    first[1:] = gk[1:] != gk[:-1]
    if ref_keys.numel():
        r = torch.searchsorted(ref_keys, gk).clamp(max=ref_keys.numel() - 1)
        ok = (ref_keys[r] == gk) & (ref_counts[r] == gc) & first
    else:
        ok = torch.zeros_like(first)
    n_match = int(ok.sum())
    return (gk.numel() - n_match) + (ref_keys.numel() - n_match)
