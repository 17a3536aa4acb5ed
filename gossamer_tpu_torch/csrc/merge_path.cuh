// Merge-path split search shared by fold.cu and merge.cu.
//
// Two ascending int64 runs A and B are merged with A first on equal keys
// (`take_a` of the TPU kernels).  The first `diag` lanes of the merged order
// hold merge_path(diag) lanes of A and diag - merge_path(diag) lanes of B,
// so a block that owns merged lanes [d0, d1) finds its slices of A and B by
// two binary searches and merges them without knowing any other block.

#pragma once

#include <stdint.h>

// Number of A lanes among the first `diag` lanes of the merged order, with A
// first on equal keys (lower bound).
template <typename I>
__device__ __forceinline__ I merge_path(const long long* a, I na, const long long* b, I nb,
                                        I diag) {
    I lo = diag > nb ? diag - nb : 0;
    I hi = diag < na ? diag : na;
    while (lo < hi) {
        I mid = (lo + hi) >> 1;
        if (a[mid] <= b[diag - 1 - mid]) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// The slices of A and B behind merged lanes [d0, d1), from the splits
// a0 = merge_path(d0) and a1 = merge_path(d1).  For ascending runs
// a0 <= a1 and the slices are a[a0, a0 + la) and b[d0 - a0, d0 - a0 + lb)
// with la + lb = d1 - d0.  Runs that are not ascending can give splits out of
// order; the lengths are then clamped so that a block never reads past its
// runs or writes past its d1 - d0 lanes of shared memory (its result is
// unspecified, and callers that accept such input report it another way).
struct TileSlices {
    long long a0, b0;
    int la, lb;
};

__device__ __forceinline__ TileSlices tile_slices(long long d0, long long d1, long long a0,
                                                  long long a1) {
    const long long len = d1 - d0;
    long long la = a1 - a0;
    la = la < 0 ? 0 : (la > len ? len : la);
    long long lb = (d1 - a1) - (d0 - a0);
    lb = lb < 0 ? 0 : (lb > len - la ? len - la : lb);
    return TileSlices{a0, d0 - a0, (int)la, (int)lb};
}
