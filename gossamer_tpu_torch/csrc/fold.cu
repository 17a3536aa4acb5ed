// Merge-fold of two sorted int64 key runs for Hopper (sm_90a).
//
// Replaces gossamer_tpu/ops/pallas_fold.py `_fold_kernel` (wrapper
// `merge_fold_planes`).  Same result: merge the packed spectrum A with the
// sorted batch B, sum the counts of equal keys mod 2^32, write the distinct
// non-sentinel keys ascending, and report `live`, the number of such groups
// (even past `cap`).  Lanes [live, cap) get the sentinel with count 0.
//
// The TPU kernel walks one sequential grid and carries the open group and a
// running count in SMEM.  Blocks on Hopper run in parallel and in no order,
// so this version carries nothing between blocks:
//
//   1. fold_reduce   each block takes TILE lanes of the merged order: a
//                    merge-path binary search (merge_path.cuh) finds its
//                    slices of A and B, which it merges from shared memory
//                    (A first on ties, `take_a` in the TPU kernel).  It
//                    writes its count total (mod 2^32) and its number of
//                    non-sentinel group ends.
//   2. fold_scan     one block turns the block totals into exclusive prefixes
//                    and writes `live`.
//   3. fold_scatter  each block merges its tile again, scans counts into the
//                    global running sum S (mod 2^32, the TPU kernel's trick)
//                    and group ends into destinations, and scatters the key
//                    and S of each group end below `cap`.
//   4. fold_finish   counts[g] = S_g - S_{g-1} mod 2^32, sentinel fill.
//
// A group that spans blocks needs no carry: S is global.  The kernels are
// bound by device-memory bytes: A and B are read twice (16 B a lane each
// time) and the output written once, about three passes over (nA+nB) x 16 B.
// Shared memory holds one tile (24 KB); TMA and tuning are left for later.
//
// Keys are int64 below 2^62 (2*rho <= 62); the sentinel is 2^63-1.  Counts
// are int64 holding values in [0, 2^32).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (gossamer_tpu_torch/ops/fold.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int TILE = THREADS * ITEMS;  // merged lanes per block
constexpr int WARPS = THREADS / 32;
constexpr long long SENT = 0x7FFFFFFFFFFFFFFFLL;

struct TileSmem {
    long long key[TILE];
    unsigned cnt[TILE];
    long long first[THREADS + 1];  // first key of each thread, then the tile's successor
    long long split[2];            // A lanes before the tile's first and past its last lane
    unsigned wsum[WARPS];
    long long wend[WARPS];
};

// Inclusive scan over the block; `total` receives the block's sum.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* warp_tot, T& total) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        T u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
        T w = lane < WARPS ? warp_tot[lane] : T(0);
#pragma unroll
        for (int d = 1; d < WARPS; d <<= 1) {
            T u = __shfl_up_sync(0xffffffffu, w, d);
            if (lane >= d) w += u;
        }
        if (lane < WARPS) warp_tot[lane] = w;
    }
    __syncthreads();
    if (warp > 0) v += warp_tot[warp - 1];
    total = warp_tot[WARPS - 1];
    __syncthreads();
    return v;
}

// Merge tile `tile` of the merged order into ITEMS consecutive lanes per
// thread.  Lanes past the end of the input read as (SENT, 0); `next` is the
// key of the lane after this thread's last one (SENT past the end).
__device__ __forceinline__ void merge_tile(const long long* __restrict__ a,
                                           const long long* __restrict__ ac, long long na,
                                           const long long* __restrict__ b,
                                           const long long* __restrict__ bc, long long nb,
                                           long long tile, long long (&key)[ITEMS],
                                           unsigned (&cnt)[ITEMS], long long& next,
                                           TileSmem& sm) {
    const long long n = na + nb;
    const long long d0 = tile * TILE;
    const long long d1 = d0 + TILE < n ? d0 + TILE : n;
    if (threadIdx.x == 0) sm.split[0] = merge_path<long long>(a, na, b, nb, d0);
    if (threadIdx.x == 32) {
        const long long a1 = merge_path<long long>(a, na, b, nb, d1);
        const long long b1 = d1 - a1;
        sm.split[1] = a1;
        long long succ = SENT;
        if (d1 < n) succ = (a1 < na && (b1 >= nb || a[a1] <= b[b1])) ? a[a1] : b[b1];
        sm.first[THREADS] = succ;
    }
    __syncthreads();
    const TileSlices sl = tile_slices(d0, d1, sm.split[0], sm.split[1]);
    const long long a0 = sl.a0;
    const long long b0 = sl.b0;
    const int la = sl.la;
    const int lb = sl.lb;
    for (int i = threadIdx.x; i < la; i += THREADS) {
        sm.key[i] = a[a0 + i];
        sm.cnt[i] = (unsigned)ac[a0 + i];
    }
    for (int i = threadIdx.x; i < lb; i += THREADS) {
        sm.key[la + i] = b[b0 + i];
        sm.cnt[la + i] = (unsigned)bc[b0 + i];
    }
    __syncthreads();
    const long long* sa = sm.key;
    const long long* sb = sm.key + la;
    const unsigned* ca = sm.cnt;
    const unsigned* cb = sm.cnt + la;
    const int len = la + lb;
    const int d = threadIdx.x * ITEMS;
    int i = 0;
    int j = 0;
    if (d < len) {
        i = merge_path<int>(sa, la, sb, lb, d);
        j = d - i;
    }
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        if (d + r < len) {
            const bool take_a = i < la && (j >= lb || sa[i] <= sb[j]);
            key[r] = take_a ? sa[i] : sb[j];
            cnt[r] = take_a ? ca[i] : cb[j];
            i += take_a;
            j += !take_a;
        } else {
            key[r] = SENT;
            cnt[r] = 0u;
        }
    }
    sm.first[threadIdx.x] = key[0];
    __syncthreads();
    next = sm.first[threadIdx.x + 1];
    __syncthreads();
}

// A lane ends a group when the next key differs; sentinel groups do not count.
__device__ __forceinline__ bool ends_group(long long k, long long following) {
    return k != following && k != SENT;
}

__global__ void __launch_bounds__(THREADS)
fold_reduce(const long long* __restrict__ a, const long long* __restrict__ ac, long long na,
            const long long* __restrict__ b, const long long* __restrict__ bc, long long nb,
            unsigned* __restrict__ blk_sum, long long* __restrict__ blk_ends) {
    __shared__ TileSmem sm;
    long long key[ITEMS];
    unsigned cnt[ITEMS];
    long long next;
    merge_tile(a, ac, na, b, bc, nb, blockIdx.x, key, cnt, next, sm);
    unsigned s = 0u;
    long long e = 0;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        s += cnt[r];
        e += ends_group(key[r], r + 1 < ITEMS ? key[r + 1] : next);
    }
    unsigned s_tot;
    long long e_tot;
    block_scan<unsigned>(s, sm.wsum, s_tot);
    block_scan<long long>(e, sm.wend, e_tot);
    if (threadIdx.x == 0) {
        blk_sum[blockIdx.x] = s_tot;
        blk_ends[blockIdx.x] = e_tot;
    }
}

// One block: block totals -> exclusive prefixes, in place; live = all ends.
__global__ void __launch_bounds__(THREADS)
fold_scan(unsigned* __restrict__ blk_sum, long long* __restrict__ blk_ends, long long nblk,
          long long* __restrict__ live) {
    __shared__ unsigned wsum[WARPS];
    __shared__ long long wend[WARPS];
    const long long per = (nblk + THREADS - 1) / THREADS;
    const long long beg = threadIdx.x * per;
    const long long end = beg + per < nblk ? beg + per : nblk;
    unsigned s = 0u;
    long long e = 0;
    for (long long t = beg; t < end; ++t) {
        s += blk_sum[t];
        e += blk_ends[t];
    }
    unsigned s_tot;
    long long e_tot;
    unsigned s_run = block_scan<unsigned>(s, wsum, s_tot) - s;
    long long e_run = block_scan<long long>(e, wend, e_tot) - e;
    for (long long t = beg; t < end; ++t) {
        const unsigned sv = blk_sum[t];
        const long long ev = blk_ends[t];
        blk_sum[t] = s_run;
        blk_ends[t] = e_run;
        s_run += sv;
        e_run += ev;
    }
    if (threadIdx.x == 0) *live = e_tot;
}

__global__ void __launch_bounds__(THREADS)
fold_scatter(const long long* __restrict__ a, const long long* __restrict__ ac, long long na,
             const long long* __restrict__ b, const long long* __restrict__ bc, long long nb,
             const unsigned* __restrict__ blk_sum, const long long* __restrict__ blk_ends,
             long long cap, long long* __restrict__ out_keys, unsigned* __restrict__ sbuf) {
    __shared__ TileSmem sm;
    long long key[ITEMS];
    unsigned cnt[ITEMS];
    long long next;
    merge_tile(a, ac, na, b, bc, nb, blockIdx.x, key, cnt, next, sm);
    unsigned s = 0u;
    long long e = 0;
    bool is_end[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        s += cnt[r];
        is_end[r] = ends_group(key[r], r + 1 < ITEMS ? key[r + 1] : next);
        e += is_end[r];
    }
    unsigned s_tot;
    long long e_tot;
    unsigned run = blk_sum[blockIdx.x] + block_scan<unsigned>(s, sm.wsum, s_tot) - s;
    long long dest = blk_ends[blockIdx.x] + block_scan<long long>(e, sm.wend, e_tot) - e;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        run += cnt[r];
        if (is_end[r]) {
            if (dest < cap) {
                out_keys[dest] = key[r];
                sbuf[dest] = run;
            }
            ++dest;
        }
    }
}

__global__ void __launch_bounds__(THREADS)
fold_finish(const long long* __restrict__ live, long long cap, const unsigned* __restrict__ sbuf,
            long long* __restrict__ out_keys, long long* __restrict__ out_cnt) {
    const long long n_live = *live;
    for (long long g = blockIdx.x * (long long)THREADS + threadIdx.x; g < cap;
         g += (long long)gridDim.x * THREADS) {
        if (g < n_live) {
            const unsigned prev = g > 0 ? sbuf[g - 1] : 0u;
            out_cnt[g] = (long long)(unsigned)(sbuf[g] - prev);
        } else {
            out_keys[g] = SENT;
            out_cnt[g] = 0;
        }
    }
}

}  // namespace

extern "C" {

int gossamer_fold_tile() { return TILE; }

const char* gossamer_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// All pointers are device pointers on `device`; the kernels run on `stream`
// and nothing synchronises.  Scratch: blk_sum[nblk], blk_ends[nblk] and
// sbuf[cap] with nblk = ceil((na + nb) / TILE).  Returns cudaGetLastError().
int gossamer_merge_fold(int device, const void* a_keys, const void* a_counts, long long na,
                        const void* b_keys, const void* b_counts, long long nb, long long cap,
                        void* out_keys, void* out_counts, void* live, void* blk_sum,
                        void* blk_ends, void* sbuf, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    const long long n = na + nb;
    const long long nblk = (n + TILE - 1) / TILE;
    const long long* a = (const long long*)a_keys;
    const long long* ac = (const long long*)a_counts;
    const long long* b = (const long long*)b_keys;
    const long long* bc = (const long long*)b_counts;
    unsigned* bs = (unsigned*)blk_sum;
    long long* be = (long long*)blk_ends;
    long long* ok = (long long*)out_keys;
    unsigned* sb = (unsigned*)sbuf;
    if (nblk > 0) fold_reduce<<<(unsigned)nblk, THREADS, 0, st>>>(a, ac, na, b, bc, nb, bs, be);
    fold_scan<<<1, THREADS, 0, st>>>(bs, be, nblk, (long long*)live);
    if (nblk > 0) {
        fold_scatter<<<(unsigned)nblk, THREADS, 0, st>>>(a, ac, na, b, bc, nb, bs, be, cap, ok,
                                                         sb);
    }
    if (cap > 0) {
        long long grid = (cap + THREADS - 1) / THREADS;
        if (grid > 65535LL * 16) grid = 65535LL * 16;
        fold_finish<<<(unsigned)grid, THREADS, 0, st>>>((const long long*)live, cap, sb, ok,
                                                        (long long*)out_counts);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
