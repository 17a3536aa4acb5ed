// Merge of two sorted int64 runs, payloads riding along, for Hopper (sm_90a).
//
// Replaces gossamer_tpu/ops/pallas_merge.py `_merge_kernel` (wrapper
// `merge_sorted_planes`).  Same result: two ascending runs A and B of
// (key, value) lanes become one ascending run of nA + nB lanes, values
// travelling with their keys, no dedup.  On equal keys A comes first and
// each run keeps its own order, so the result equals a stable sort of A ++ B.
//
// The TPU kernel walks a sequential grid, carrying a tile between steps and
// merging with a bitonic network.  Blocks on Hopper run in parallel and in
// no order, so each block owns TILE lanes of the merged order: a merge-path
// binary search (merge_path.cuh) over A and B in device memory finds its
// slices, which it loads into shared memory; each thread then finds its
// ITEMS lanes by a second merge-path search inside the tile and merges them
// into registers; the block writes the tile back through shared memory, so
// loads and stores are coalesced.  Nothing is carried between blocks and any
// length works (no tile multiple, no sentinel padding).
//
// The kernel is bound by device-memory bytes: 16 B read and 16 B written per
// lane, one pass.  The two split searches per block cost O(log n) reads each.
// TMA and a persistent schedule are left for later.
//
// Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (gossamer_tpu_torch/ops/merge.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // merged lanes per block
constexpr long long SENT = 0x7FFFFFFFFFFFFFFFLL;

__global__ void __launch_bounds__(THREADS)
merge_sorted_kernel(const long long* __restrict__ a, const long long* __restrict__ av,
                    long long na, const long long* __restrict__ b,
                    const long long* __restrict__ bv, long long nb,
                    long long* __restrict__ out_keys, long long* __restrict__ out_vals) {
    __shared__ long long skey[TILE];
    __shared__ long long sval[TILE];
    __shared__ long long split[2];
    const long long n = na + nb;
    const long long d0 = (long long)blockIdx.x * TILE;
    const long long d1 = d0 + TILE < n ? d0 + TILE : n;
    if (threadIdx.x == 0) split[0] = merge_path<long long>(a, na, b, nb, d0);
    if (threadIdx.x == 32) split[1] = merge_path<long long>(a, na, b, nb, d1);
    __syncthreads();
    const TileSlices sl = tile_slices(d0, d1, split[0], split[1]);
    for (int i = threadIdx.x; i < sl.la; i += THREADS) {
        skey[i] = a[sl.a0 + i];
        sval[i] = av[sl.a0 + i];
    }
    for (int i = threadIdx.x; i < sl.lb; i += THREADS) {
        skey[sl.la + i] = b[sl.b0 + i];
        sval[sl.la + i] = bv[sl.b0 + i];
    }
    __syncthreads();

    const long long* sa = skey;
    const long long* sb = skey + sl.la;
    const long long* va = sval;
    const long long* vb = sval + sl.la;
    const int len = sl.la + sl.lb;
    const int d = threadIdx.x * ITEMS;
    int i = 0;
    int j = 0;
    if (d < len) {
        i = merge_path<int>(sa, sl.la, sb, sl.lb, d);
        j = d - i;
    }
    long long key[ITEMS];
    long long val[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        if (d + r < len) {
            const bool take_a = i < sl.la && (j >= sl.lb || sa[i] <= sb[j]);
            key[r] = take_a ? sa[i] : sb[j];
            val[r] = take_a ? va[i] : vb[j];
            i += take_a;
            j += !take_a;
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        if (d + r < len) {
            skey[d + r] = key[r];
            sval[d + r] = val[r];
        }
    }
    __syncthreads();
    const int width = (int)(d1 - d0);
    for (int t = threadIdx.x; t < width; t += THREADS) {
        // lanes past `len` exist only for runs that were not ascending
        out_keys[d0 + t] = t < len ? skey[t] : SENT;
        out_vals[d0 + t] = t < len ? sval[t] : 0;
    }
}

}  // namespace

extern "C" {

int gossamer_merge_tile() { return TILE; }

const char* gossamer_merge_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// All pointers are device pointers on `device`; the kernel runs on `stream`
// and nothing synchronises.  out_keys and out_vals hold na + nb lanes.
// Returns cudaGetLastError().
int gossamer_merge_sorted(int device, const void* a_keys, const void* a_vals, long long na,
                          const void* b_keys, const void* b_vals, long long nb,
                          void* out_keys, void* out_vals, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long n = na + nb;
    const long long nblk = (n + TILE - 1) / TILE;
    if (nblk > 0) {
        merge_sorted_kernel<<<(unsigned)nblk, THREADS, 0, (cudaStream_t)stream>>>(
            (const long long*)a_keys, (const long long*)a_vals, na, (const long long*)b_keys,
            (const long long*)b_vals, nb, (long long*)out_keys, (long long*)out_vals);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
