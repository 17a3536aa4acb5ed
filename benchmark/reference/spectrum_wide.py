"""The edge spectrum of ``goss build-graph`` at a wide k, windows (edges) of
32 to 62 bases: every window of every read whose bases are all ACGT,
counted in both orientations (``src/GossCmdBuildGraph.cc`` inserts each
window and its reverse complement, so a palindrome counts twice), as
ascending distinct windows with their counts.

A window too long for one int64 is held as two halves, ``hi`` its first
``rho - rho // 2`` bases and ``lo`` its last ``rho // 2``, each a number
with its first base most significant (A=0, C=1, G=2, T=3): at most 31
bases, 62 bits, a half, so no value reaches bit 63, and ``(hi, lo)`` orders
like the window.  At rho 56 each half holds 28 bases.
"""

from __future__ import annotations

import numpy as np
import torch

from .kmers import reverse_complement_codes, window_keys

BLOCK_ROWS = 1 << 18
MAX_RHO = 62


def split(rho: int) -> tuple[int, int]:
    """-> (bases of ``hi``, bases of ``lo``) of a window of ``rho`` bases."""
    if not 31 < rho <= MAX_RHO:
        raise ValueError(f"rho = {rho}: two halves of at most 31 bases hold "
                         f"32 to {MAX_RHO}")
    return rho - rho // 2, rho // 2


def window_halves(codes: torch.Tensor, rho: int):
    """Codes uint8[rows, length] -> (int64 hi, int64 lo [rows, length - rho
    + 1], bool valid: every base of the window is one of ACGT)."""
    n_hi, n_lo = split(rho)
    n_win = codes.shape[1] - rho + 1
    hi, valid_hi = window_keys(codes[:, : n_win + n_hi - 1], n_hi)
    lo, valid_lo = window_keys(codes[:, n_hi:], n_lo)
    return hi, lo, valid_hi & valid_lo


def sort_pairs(hi: torch.Tensor, lo: torch.Tensor, *payloads: torch.Tensor):
    """Stable sort by ``(hi, lo)``: by ``lo``, then stably by ``hi``; the
    payloads travel with their pairs."""
    order = torch.sort(lo, stable=True).indices
    order = order[torch.sort(hi[order], stable=True).indices]
    return tuple(t[order] for t in (hi, lo, *payloads))


def edge_spectrum_wide(reads: np.ndarray, rho: int, device,
                       drop_reads_with_n: bool = False):
    """Read codes uint8[n, length] -> (int64 hi, int64 lo ascending by
    (hi, lo), int64 counts) on ``device``.  ``drop_reads_with_n`` is the
    control: it leaves out every read that holds an N, where the guarantee
    counts its other windows."""
    split(rho)
    if drop_reads_with_n:
        reads = reads[~(reads >= 4).any(axis=1)]
    his, los = [], []
    for s in range(0, len(reads), BLOCK_ROWS):
        codes = torch.from_numpy(np.ascontiguousarray(reads[s : s + BLOCK_ROWS])).to(device)
        for strand in (codes, reverse_complement_codes(codes)):
            hi, lo, valid = window_halves(strand, rho)
            his.append(hi[valid])
            los.append(lo[valid])
        del codes
    hi, lo = sort_pairs(torch.cat(his), torch.cat(los))
    del his, los
    first = torch.ones_like(hi, dtype=torch.bool)
    first[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    starts = torch.nonzero(first).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_tensor([hi.numel()])])
    return hi[starts], lo[starts], ends - starts


def mismatched_wide(ref, got) -> int:
    """Edges whose (window, count) one side holds and the other does not,
    each side ``(hi, lo, counts)``: 0 exactly when the two spectra are
    equal.  ``got`` may be out of order or hold a window twice; each such
    lane counts."""
    if (got[0].shape == ref[0].shape
            and all(torch.equal(g, r) for g, r in zip(got, ref))):
        return 0
    ghi, glo, gc = sort_pairs(*got)
    first = torch.ones_like(ghi, dtype=torch.bool)
    first[1:] = (ghi[1:] != ghi[:-1]) | (glo[1:] != glo[:-1])
    # the (window, count) triples of each side are distinct, so a triple
    # held by both sides is one pair of equal neighbours in their union
    hi, lo, c = (torch.cat([r, g[first]]) for r, g in zip(ref, (ghi, glo, gc)))
    order = torch.sort(c, stable=True).indices
    hi, lo, c = sort_pairs(hi[order], lo[order], c[order])
    n_match = int(((hi[1:] == hi[:-1]) & (lo[1:] == lo[:-1])
                   & (c[1:] == c[:-1])).sum())
    return (ghi.numel() - n_match) + (ref[0].numel() - n_match)
