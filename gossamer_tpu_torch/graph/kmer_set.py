"""Sorted 128-bit key search (``rank128`` of ``gossamer_tpu/graph/kmer_set.py``).

The port needs only the search that :class:`..graph.Graph` uses; the
``KmerSet`` artifact arrives with build-kmer-set.
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64


def rank128(set_lo: np.ndarray, set_hi: np.ndarray, qlo, qhi) -> np.ndarray:
    """searchsorted over 128-bit keys held as sorted (lo, hi) planes."""
    qlo = np.atleast_1d(np.asarray(qlo, dtype=U64))
    qhi = np.atleast_1d(np.asarray(qhi, dtype=U64))
    n = len(set_lo)
    if n == 0:
        return np.zeros(len(qlo), dtype=np.int64)
    if set_hi[-1] == 0:
        # all keys fit in 64 bits (k <= 31)
        r = np.searchsorted(set_lo, qlo, side="left")
        return np.where(qhi > 0, np.int64(n), r)
    # vectorized 128-bit binary search (log2 n rounds over all queries)
    lo_idx = np.zeros(len(qlo), dtype=np.int64)
    hi_idx = np.full(len(qlo), n, dtype=np.int64)
    rounds = int(np.ceil(np.log2(n + 1))) + 1
    for _ in range(rounds):
        active = lo_idx < hi_idx
        mid = (lo_idx + hi_idx) >> 1
        m = np.minimum(mid, n - 1)
        mlo = set_lo[m]
        mhi = set_hi[m]
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        lo_idx = np.where(active & less, mid + 1, lo_idx)
        hi_idx = np.where(active & ~less, mid, hi_idx)
    return lo_idx
