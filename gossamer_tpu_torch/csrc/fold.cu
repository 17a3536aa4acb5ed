// Merge-fold of two sorted int64 key runs for Hopper (sm_90a), in one pass.
//
// Replaces gossamer_tpu/ops/pallas_fold.py `_fold_kernel` (wrapper
// `merge_fold_planes`).  Same result: merge the packed spectrum A with the
// sorted batch B, sum the counts of equal keys mod 2^32, write the distinct
// non-sentinel keys ascending, and report `live`, the number of such groups
// (even past `cap`).  Lanes [live, cap) get the sentinel with count 0, and
// `live` is -1 when A or B was not ascending.
//
// What bounds it: device-memory bytes.  Every lane of A and B is 16 B to
// read (int64 key, int64 count) and every output lane 16 B to write; the
// arithmetic per lane is a few dozen integer instructions.  So the design
// reads A and B once, writes the output once, and keeps everything else out
// of device memory:
//
//   fold_init   one thread per tile boundary: the merge-path split
//               (merge_path.cuh) of that diagonal, so no block of the main
//               kernel starts with a chain of ~26 dependent loads.  It also
//               resets the scratch (tile counter, flags, status words).
//   fold_tiles  the one pass.  A block takes the next tile id from an atomic
//               counter, copies its slices of A and B (keys and counts, four
//               contiguous runs) into shared memory with cp.async in 16-byte
//               pieces, all in flight together, and checks their order there
//               (each slice's first lane against the lane before it in its
//               run, and that the splits advance).  Each thread merges ITEMS
//               lanes into registers (A first on ties, `take_a` in the TPU
//               kernel).  A block scan over (group ends, sum of the open
//               group) gives every group end its place in the tile and its
//               count; the ends are compacted in shared memory and stored
//               coalesced from the tile's destination offset.
//   fold_fill   write-only: (SENT, 0) on [live, cap) with 16-byte stores, and
//               `live` itself (-1 if any block saw a violation).
//
// The TPU kernel walks a sequential grid and carries the open group and a
// running count from step to step.  Here the carry between tiles is the pair
// (ends, tail): the number of group ends so far and the count sum (mod 2^32)
// of the group still open, with
//   combine(x, y) = (x.ends + y.ends, y.ends ? y.tail : x.tail + y.tail),
// which is associative.  It travels by a single-pass chained scan (decoupled
// look-back): a tile publishes its own summary (flag 1), walks back over its
// predecessors, the whole block reading THREADS of them in one round trip,
// combining summaries until it meets an inclusive prefix (flag 2), then
// publishes its own inclusive prefix.  Tile ids come from the atomic counter,
// so a block only waits on blocks that already run.  A status is two 64-bit
// words (flag | ends, flag | tail) that carry their payload themselves; a
// reader spins until both show the same non-zero flag, so no fence is needed
// and `ends` is not limited to 30 bits.  Only the first group end of a tile
// needs the carried tail (it closes the group open at the tile's left edge);
// a group spanning many tiles is the tail adding up through tiles that have
// no end.
//
// What still holds it back (PERF.md): a tile cannot be stored before every
// earlier tile has published its summary, so tiles retire in order and a
// block spends close to half its life in the look-back, waiting for the
// slowest tile before it while it keeps its shared memory.  A block must not
// take a further tile id while it waits: its later tile's summary would then
// wait on its own look-back, and the waits chain up across blocks.
//
// Keys are int64 below 2^62 (2*rho <= 62); the sentinel is 2^63-1.  Counts
// are int64 holding values in [0, 2^32).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (-DFOLD_THREADS= and -DFOLD_ITEMS= choose the tile) and called through
// ctypes (gossamer_tpu_torch/ops/fold.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

// The tile: 128 threads x 27 lanes was the fastest of the shapes tried on an
// H100 (scripts/fold_bench.py): few threads with many lanes each keep the
// serial merge in registers busy, an odd lane count spreads the threads'
// shared-memory reads over the banks, and four 55 KB blocks fit an SM.
#ifndef FOLD_THREADS
#define FOLD_THREADS 128
#endif
#ifndef FOLD_ITEMS
#define FOLD_ITEMS 27
#endif

namespace {

typedef unsigned long long u64;

constexpr int THREADS = FOLD_THREADS;
constexpr int ITEMS = FOLD_ITEMS;
constexpr int TILE = THREADS * ITEMS;  // merged lanes per block
constexpr int WARPS = THREADS / 32;
constexpr int BUF = TILE + 4;  // two runs, each shifted by up to one lane and padded to 16 B
constexpr int SMEM_BYTES = 2 * BUF * 8;
constexpr long long SENT = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long BEFORE_ALL = -0x7FFFFFFFFFFFFFFFLL - 1;
constexpr unsigned FULL = 0xffffffffu;

static_assert(THREADS % 32 == 0 && THREADS >= 128 && THREADS <= 1024, "block size");
static_assert(ITEMS >= 1 && ITEMS <= 32, "lanes per thread");

// Scratch words (64-bit): a header, then split[ntiles + 1], then the two
// status words of every tile.
constexpr int W_COUNTER = 0;  // next tile id
constexpr int W_BAD = 1;      // some block saw input out of order
constexpr int W_TOTAL = 2;    // all group ends (written by the last tile)
constexpr int W_PROFILE = 4;  // FOLD_PROFILE: clock cycles of thread 0 by phase, summed over tiles
constexpr int W_HEADER = 12;

// -DFOLD_PROFILE adds up, over all tiles, the clock cycles thread 0 spends in
// each phase of fold_tiles (scripts/fold_bench.py --profile prints them).
#ifdef FOLD_PROFILE
#define PHASE(k)                                                      \
    do {                                                              \
        if (threadIdx.x == 0) {                                       \
            const long long now = clock64();                          \
            atomicAdd(scratch + W_PROFILE + (k), (u64)(now - mark));  \
            mark = now;                                               \
        }                                                             \
    } while (0)
#else
#define PHASE(k)
#endif

constexpr u64 ENDS_MASK = (1ULL << 62) - 1;

// The carry between lanes, threads, warps and tiles (see the header note).
template <typename E>
struct Carry {
    E ends;
    unsigned tail;
};

template <typename E>
__device__ __forceinline__ Carry<E> combine(Carry<E> x, Carry<E> y) {
    return Carry<E>{x.ends + y.ends, y.ends ? y.tail : x.tail + y.tail};
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Start the copy of src[0, len) into shared memory so that src[i] lands at
// dst[off + i], where off (0 or 1, returned) gives dst + off the alignment
// of src within 16 bytes; dst itself is 16-byte aligned.  All but a first
// and a last odd lane go in 16-byte pieces.
__device__ __forceinline__ int copy_run(long long* dst, const long long* src, int len) {
    const int off = (int)(((uintptr_t)src >> 3) & 1);
    const int head = off < len ? off : len;
    const int pairs = (len - head) >> 1;
    for (int p = threadIdx.x; p < pairs; p += THREADS) {
        cp_async16(dst + off + head + 2 * p, src + head + 2 * p);
    }
    if (threadIdx.x == 0 && head) cp_async8(dst + off, src);
    if (threadIdx.x == 32 && ((len - head) & 1)) cp_async8(dst + off + len - 1, src + len - 1);
    return off;
}

__global__ void __launch_bounds__(256)
fold_init(const long long* __restrict__ a, long long na, const long long* __restrict__ b,
          long long nb, long long ntiles, u64* __restrict__ scratch) {
    const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (t == 0) {
        scratch[W_COUNTER] = 0;
        scratch[W_BAD] = 0;
        scratch[W_TOTAL] = 0;
    }
    if (t < W_HEADER - W_PROFILE) scratch[W_PROFILE + t] = 0;
    if (t > ntiles) return;
    const long long n = na + nb;
    const long long diag = t * TILE < n ? t * TILE : n;
    long long* split = (long long*)scratch + W_HEADER;
    split[t] = merge_path<long long>(a, na, b, nb, diag);
    if (t < ntiles) {
        u64* status = scratch + W_HEADER + ntiles + 1;
        status[t] = 0;
        status[ntiles + t] = 0;
    }
}

// The carry of all tiles before `tile` > 0, by the whole block: thread i reads
// the status of tile look - i, each warp combines its 32 up to its nearest
// inclusive prefix, and every thread combines the warps' results up to the
// nearest warp that met one.  All threads return the same carry.
struct LookBackSmem {
    long long ends[WARPS];
    unsigned tail[WARPS];
    int done[WARPS];
};

__device__ __forceinline__ Carry<long long> look_back(const volatile u64* st_ends,
                                                      const volatile u64* st_tail,
                                                      long long tile, LookBackSmem& sm,
                                                      u64* scratch) {
#ifdef FOLD_PROFILE
    const long long began = clock64();
#endif
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    Carry<long long> nearer{0, 0u};  // tiles (look, tile), combined so far
    for (long long look = tile - 1;; look -= THREADS) {
        const long long idx = look - threadIdx.x;  // thread 0 reads the nearest tile
        u64 we = 0, wt = 0;
        unsigned flag = 2;  // before tile 0: an inclusive prefix of nothing
        if (idx >= 0) {
            do {
                we = st_ends[idx];
                wt = st_tail[idx];
                flag = (unsigned)(we >> 62);
            } while (flag == 0 || flag != (unsigned)(wt >> 32));
        }
#ifdef FOLD_PROFILE  // how long the tile just before this one took to publish its summary
        if (threadIdx.x == 0 && look == tile - 1) {
            atomicAdd(scratch + W_PROFILE + 7, (u64)(clock64() - began));
        }
#endif
        const unsigned done = __ballot_sync(FULL, flag == 2);
        const int last = done ? __ffs(done) - 1 : 32;  // nearest inclusive prefix
        Carry<long long> v{0, 0u};
        if (lane <= last) v = Carry<long long>{(long long)(we & ENDS_MASK), (unsigned)wt};
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {  // higher lanes hold earlier tiles
            Carry<long long> u;
            u.ends = __shfl_down_sync(FULL, v.ends, d);
            u.tail = __shfl_down_sync(FULL, v.tail, d);
            if (lane + d < 32) v = combine(u, v);
        }
        if (lane == 0) {
            sm.ends[warp] = v.ends;
            sm.tail[warp] = v.tail;
            sm.done[warp] = done != 0u;
        }
        __syncthreads();
        Carry<long long> window{0, 0u};
        bool found = false;
        for (int w = 0; w < WARPS && !found; ++w) {  // higher warps hold earlier tiles
            window = combine(Carry<long long>{sm.ends[w], sm.tail[w]}, window);
            found = sm.done[w];
        }
        nearer = combine(window, nearer);
        __syncthreads();
        if (found) return nearer;
    }
}

__device__ __forceinline__ void publish(volatile u64* st_ends, volatile u64* st_tail,
                                        long long tile, u64 flag, Carry<long long> c) {
    st_tail[tile] = (flag << 32) | c.tail;
    st_ends[tile] = (flag << 62) | (u64)c.ends;
}

__global__ void __launch_bounds__(THREADS)
fold_tiles(const long long* __restrict__ a, const long long* __restrict__ ac, long long na,
           const long long* __restrict__ b, const long long* __restrict__ bc, long long nb,
           long long cap, long long ntiles, long long* __restrict__ out_keys,
           long long* __restrict__ out_cnt, u64* scratch) {
    extern __shared__ __align__(16) long long dyn[];
    long long* kbuf = dyn;        // keys of the A slice, then of the B slice
    long long* cbuf = dyn + BUF;  // their counts
    __shared__ long long s_first[THREADS + 1];  // first key of each thread, then the successor
    __shared__ long long s_prev[2];             // the lane before the A slice and the B slice
    __shared__ int s_wends[WARPS];
    __shared__ unsigned s_wtail[WARPS];
    __shared__ long long s_tile;
    __shared__ LookBackSmem s_look;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
#ifdef FOLD_PROFILE
    long long mark = clock64();
#endif
    if (tid == 0) s_tile = (long long)atomicAdd(scratch + W_COUNTER, 1ULL);
    __syncthreads();
    const long long tile = s_tile;
    const long long n = na + nb;
    const long long d0 = tile * TILE;
    const long long d1 = d0 + TILE < n ? d0 + TILE : n;
    const long long* split = (const long long*)scratch + W_HEADER;
    const long long sp0 = split[tile];
    const long long sp1 = split[tile + 1];
    // ascending runs give splits that advance in A and in B
    bool bad = sp1 < sp0 || (d1 - sp1) < (d0 - sp0);
    const TileSlices sl = tile_slices(d0, d1, sp0, sp1);
    const long long a0 = sl.a0;
    const long long b0 = sl.b0;
    const int la = sl.la;
    const int lb = sl.lb;

    const int oak = copy_run(kbuf, a + a0, la);
    const int oac = copy_run(cbuf, ac + a0, la);
    const int kb = (oak + la + 1) & ~1;
    const int cb0 = (oac + la + 1) & ~1;
    const int obk = kb + copy_run(kbuf + kb, b + b0, lb);
    const int obc = cb0 + copy_run(cbuf + cb0, bc + b0, lb);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid == 32) {  // the key of the merged lane after the tile
        const long long ea = a0 + la;
        const long long eb = b0 + lb;
        long long succ = SENT;
        if (ea < na || eb < nb) {
            succ = (ea < na && (eb >= nb || a[ea] <= b[eb])) ? a[ea] : b[eb];
        }
        s_first[THREADS] = succ;
    }
    if (tid == 64) s_prev[0] = (la > 0 && a0 > 0) ? a[a0 - 1] : BEFORE_ALL;
    if (tid == 96) s_prev[1] = (lb > 0 && b0 > 0) ? b[b0 - 1] : BEFORE_ALL;
    PHASE(0);  // tile id, splits, copies started
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    PHASE(1);  // waiting for the slices

    const long long* sa = kbuf + oak;
    const long long* sb = kbuf + obk;
    const long long* ca = cbuf + oac;
    const long long* cb = cbuf + obc;
    for (int i = tid; i < la; i += THREADS) bad |= (i ? sa[i - 1] : s_prev[0]) > sa[i];
    for (int i = tid; i < lb; i += THREADS) bad |= (i ? sb[i - 1] : s_prev[1]) > sb[i];
    if (bad) *(volatile u64*)(scratch + W_BAD) = 1;

    // ITEMS consecutive merged lanes per thread; past the end (SENT, 0).  The
    // heads of both runs stay in registers, so a step reads one key and one
    // count from shared memory.
    const int len = la + lb;
    const int d = tid * ITEMS;
    int i = la;
    int j = lb;
    if (d < len) {
        i = merge_path<int>(sa, la, sb, lb, d);
        j = d - i;
    }
    long long head_a = sa[i];  // past the slice: a lane of the buffer that is never taken
    long long head_b = sb[j];
    long long key[ITEMS];
    unsigned cnt[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        if (d + r < len) {
            const bool take_a = i < la && (j >= lb || head_a <= head_b);
            key[r] = take_a ? head_a : head_b;
            cnt[r] = (unsigned)*(take_a ? ca + i : cb + j);
            i += take_a;
            j += !take_a;
            const long long following = *(take_a ? sa + i : sb + j);
            head_a = take_a ? following : head_a;
            head_b = take_a ? head_b : following;
        } else {
            key[r] = SENT;
            cnt[r] = 0u;
        }
    }
    s_first[tid] = key[0];
    __syncthreads();  // the slices are in registers: kbuf and cbuf are free
    const long long next = s_first[tid + 1];
    PHASE(2);  // order check and merge

    // A lane ends a group when the next key differs; sentinel groups do not count.
    unsigned end_mask = 0u;
    Carry<int> mine{0, 0u};
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        const long long following = r + 1 < ITEMS ? key[r + 1] : next;
        mine.tail += cnt[r];
        if (key[r] != following && key[r] != SENT) {
            end_mask |= 1u << r;
            ++mine.ends;
            mine.tail = 0u;
        }
    }
    Carry<int> inc = mine;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        Carry<int> u;
        u.ends = __shfl_up_sync(FULL, inc.ends, s);
        u.tail = __shfl_up_sync(FULL, inc.tail, s);
        if (lane >= s) inc = combine(u, inc);
    }
    Carry<int> exc;
    exc.ends = __shfl_up_sync(FULL, inc.ends, 1);
    exc.tail = __shfl_up_sync(FULL, inc.tail, 1);
    if (lane == 0) exc = Carry<int>{0, 0u};
    if (lane == 31) {
        s_wends[warp] = inc.ends;
        s_wtail[warp] = inc.tail;
    }
    __syncthreads();
    Carry<int> before_warp{0, 0u};
    Carry<int> agg{0, 0u};  // the tile's summary
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
        if (w == warp) before_warp = agg;
        agg = combine(agg, Carry<int>{s_wends[w], s_wtail[w]});
    }
    const Carry<int> pre = combine(before_warp, exc);  // the tile's lanes before this thread
    PHASE(3);  // block scan

    volatile u64* st_ends = scratch + W_HEADER + ntiles + 1;
    volatile u64* st_tail = st_ends + ntiles;
    const Carry<long long> own{agg.ends, agg.tail};
    if (tid == 0 && tile > 0) publish(st_ends, st_tail, tile, 1, own);

    // compact the tile's group ends in shared memory, counts without the
    // carried tail (only the first end of the tile needs it)
    unsigned* scnt = (unsigned*)cbuf;
    int pos = pre.ends;
    unsigned run = pre.tail;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
        run += cnt[r];
        if ((end_mask >> r) & 1u) {
            kbuf[pos] = key[r];
            scnt[pos] = run;
            ++pos;
            run = 0u;
        }
    }
    __syncthreads();
    PHASE(4);  // compaction

    Carry<long long> carried{0, 0u};
    if (tile > 0) carried = look_back(st_ends, st_tail, tile, s_look, scratch);
    if (tid == 0) {
        const Carry<long long> upto = combine(carried, own);
        publish(st_ends, st_tail, tile, 2, upto);
        if (tile == ntiles - 1) scratch[W_TOTAL] = (u64)upto.ends;
    }
    PHASE(5);  // look-back
    const long long dest = carried.ends;
    const unsigned open = carried.tail;
    for (int t = tid; t < agg.ends; t += THREADS) {
        const long long g = dest + t;
        if (g < cap) {
            out_keys[g] = kbuf[t];
            out_cnt[g] = (long long)(unsigned)(scnt[t] + (t == 0 ? open : 0u));
        }
    }
    PHASE(6);  // stores sent
}

__global__ void __launch_bounds__(256)
fold_fill(const u64* __restrict__ scratch, long long cap, long long* __restrict__ out_keys,
          long long* __restrict__ out_cnt, long long* __restrict__ live) {
    const long long total = (long long)scratch[W_TOTAL];
    if (blockIdx.x == 0 && threadIdx.x == 0) *live = scratch[W_BAD] ? -1 : total;
    const long long first = total < cap ? total : cap;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const bool vec = ((((uintptr_t)out_keys) | ((uintptr_t)out_cnt)) & 15) == 0;
    const longlong2 sent2 = make_longlong2(SENT, SENT);
    const longlong2 zero2 = make_longlong2(0, 0);
    for (long long p = (first >> 1) + blockIdx.x * (long long)blockDim.x + threadIdx.x;
         2 * p < cap; p += stride) {
        const long long g = 2 * p;
        if (vec && g >= first && g + 1 < cap) {
            ((longlong2*)out_keys)[p] = sent2;
            ((longlong2*)out_cnt)[p] = zero2;
        } else {
            if (g >= first) {
                out_keys[g] = SENT;
                out_cnt[g] = 0;
            }
            if (g + 1 < cap) {
                out_keys[g + 1] = SENT;
                out_cnt[g + 1] = 0;
            }
        }
    }
}

}  // namespace

extern "C" {

int gossamer_fold_tile() { return TILE; }

int gossamer_fold_threads() { return THREADS; }

// Where the FOLD_PROFILE cycle sums start in the scratch.
int gossamer_fold_profile_word() { return W_PROFILE; }

// 64-bit words of scratch that a call with na + nb = n needs.
long long gossamer_fold_scratch_words(long long n) {
    const long long ntiles = (n + TILE - 1) / TILE;
    return W_HEADER + 3 * ntiles + 1;
}

// Blocks of fold_tiles that one SM holds at a time (0 on error).
int gossamer_fold_blocks_per_sm() {
    int blocks = 0;
    if (cudaFuncSetAttribute(fold_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES) != cudaSuccess) {
        return 0;
    }
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fold_tiles, THREADS,
                                                      SMEM_BYTES) != cudaSuccess) {
        return 0;
    }
    return blocks;
}

const char* gossamer_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// All pointers are device pointers on `device`; the kernels run on `stream`
// and nothing synchronises.  `scratch` holds gossamer_fold_scratch_words(na +
// nb) 64-bit words, in any state.  Returns cudaGetLastError().
int gossamer_merge_fold(int device, const void* a_keys, const void* a_counts, long long na,
                        const void* b_keys, const void* b_counts, long long nb, long long cap,
                        void* out_keys, void* out_counts, void* live, void* scratch,
                        void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    const long long n = na + nb;
    const long long ntiles = (n + TILE - 1) / TILE;
    const long long* a = (const long long*)a_keys;
    const long long* b = (const long long*)b_keys;
    long long* ok = (long long*)out_keys;
    long long* oc = (long long*)out_counts;
    u64* sc = (u64*)scratch;
    fold_init<<<(unsigned)((ntiles + 256) / 256), 256, 0, st>>>(a, na, b, nb, ntiles, sc);
    if (ntiles > 0) {
        err = cudaFuncSetAttribute(fold_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        fold_tiles<<<(unsigned)ntiles, THREADS, SMEM_BYTES, st>>>(
            a, (const long long*)a_counts, na, b, (const long long*)b_counts, nb, cap, ntiles, ok,
            oc, sc);
    }
    long long grid = (cap + 2047) / 2048;
    grid = grid < 1 ? 1 : (grid > 132 * 16 ? 132 * 16 : grid);
    fold_fill<<<(unsigned)grid, 256, 0, st>>>(sc, cap, ok, oc, (long long*)live);
    return (int)cudaGetLastError();
}

}  // extern "C"
