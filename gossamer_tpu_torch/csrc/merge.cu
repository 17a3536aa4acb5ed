// Merge of two sorted int64 runs, payloads riding along, for Hopper (sm_90a).
//
// Replaces gossamer_tpu/ops/pallas_merge.py `_merge_kernel` (wrapper
// `merge_sorted_planes`).  Same result: two ascending runs A and B of
// (key, value) lanes become one ascending run of nA + nB lanes, values
// travelling with their keys, no dedup.  On equal keys A comes first and
// each run keeps its own order, so the result equals a stable sort of A ++ B.
// Any length works (no tile multiple, no sentinel padding).
//
// What bounds it: device-memory bytes.  Every lane is 16 B to read (int64
// key, int64 value) and 16 B to write, once; a few integer instructions a
// lane.  Tiles carry nothing between them, so the kernel is a copy that
// reorders lanes inside a tile, and the design keeps the copy engine busy:
//
//   merge_splits  a group of G lanes per tile boundary (MERGE_SPLIT_GROUP):
//                 the merge-path split of that diagonal, into `tiles + 1`
//                 lanes of scratch, so no block of the main kernel starts a
//                 tile with a chain of dependent loads from device memory.
//                 The group searches (G + 1) ways, so a search takes a few
//                 rounds of loads instead of a binary search's ~20.
//   merge_tiles   launched as merge_splits' programmatic dependent (its
//                 launch overlaps the split pass; it waits for the splits
//                 with griddepcontrol.wait), and persistent: as many blocks
//                 as the SMs hold at once, each walking the tile ids with a
//                 static stride.  A ring of
//                 STAGES buffers in dynamic shared memory: while tile t
//                 merges and stores, the copies of the next STAGES - 1 tiles
//                 of the block are in flight (cp.async in 16-byte pieces,
//                 four contiguous slices a tile: A's keys and values, B's
//                 keys and values; one commit group a tile).  Each thread
//                 finds its ITEMS lanes by a merge-path search inside the
//                 tile and merges them into registers (A first on ties,
//                 `take_a` in the TPU kernel); the tile is written back into
//                 its stage in merged order and stored with 16-byte stores
//                 (a tile starts at a multiple of TILE lanes, an even lane).
//                 TMA bulk stores of the stage, and 8-byte stores straight
//                 from registers, were slower on an H100 (PERF.md).
//
// The TPU kernel walks a sequential grid, carrying a tile between steps and
// merging with a bitonic network; here nothing is carried, so tiles retire
// in any order.  Runs that are not ascending give an unspecified result,
// but every read and write stays inside the buffers (tile_slices clamps).
//
// Keys are any int64 (the engine's sentinel 2^63 - 1 sorts last like any
// other key).  Built with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (-DMERGE_THREADS=, -DMERGE_ITEMS= and -DMERGE_STAGES= choose the tile and
// the ring, -DMERGE_SPLIT_GROUP= the split pass's lanes a boundary;
// -DMERGE_PROFILE counts clock cycles by phase) and called through ctypes
// (gossamer_tpu_torch/ops/merge.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

// The tile and the ring: 512 threads x 5 lanes, 3 stages (123 KB, one block
// an SM) was the fastest of the shapes tried on an H100 at all four shapes
// the paths give the merge (scripts/merge_bench.py; PERF.md).  An odd lane
// count a thread spreads the threads' shared-memory writes of the merged
// tile over the banks.
#ifndef MERGE_THREADS
#define MERGE_THREADS 512
#endif
#ifndef MERGE_ITEMS
#define MERGE_ITEMS 5
#endif
#ifndef MERGE_STAGES
#define MERGE_STAGES 3
#endif
// The split pass's lanes a tile boundary: 8 was within 1% of the best group
// (1 to 32) in the whole merge at each shape a path gives it, on an H100
// (scripts/merge_bench.py --groups; PERF.md).
#ifndef MERGE_SPLIT_GROUP
#define MERGE_SPLIT_GROUP 8
#endif

namespace {

constexpr int THREADS = MERGE_THREADS;
constexpr int ITEMS = MERGE_ITEMS;
constexpr int STAGES = MERGE_STAGES;
constexpr int TILE = THREADS * ITEMS;  // merged lanes a tile
constexpr int BUF = TILE + 4;          // two slices, each shifted by up to one lane and padded to 16 B
constexpr int STAGE_LANES = 2 * BUF;   // keys, then values
constexpr int SMEM_BYTES = STAGES * STAGE_LANES * 8;
constexpr long long SENT = 0x7FFFFFFFFFFFFFFFLL;
constexpr int MAX_DEVICES = 64;

static_assert(THREADS % 32 == 0 && THREADS >= 64 && THREADS <= 1024, "block size");
static_assert(ITEMS >= 1 && ITEMS <= 32, "lanes a thread");
static_assert(STAGES >= 2 && STAGES <= 8, "ring depth");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

// -DMERGE_PROFILE adds up, over all tiles, the clock cycles thread 0 of a
// block spends in each phase of merge_tiles (scripts/merge_bench.py
// --profile prints them).
constexpr int PROFILE_WORDS = 8;
__device__ unsigned long long g_profile[PROFILE_WORDS];

#ifdef MERGE_PROFILE
#define PHASE(k)                                                   \
    do {                                                           \
        if (threadIdx.x == 0) {                                    \
            const long long now = clock64();                       \
            atomicAdd(g_profile + (k), (unsigned long long)(now - mark)); \
            mark = now;                                            \
        }                                                          \
    } while (0)
#else
#define PHASE(k)
#endif

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Where a tile's slices sit in its stage, written by thread 0 when the
// copies start and read by all threads after they landed.
struct TileInfo {
    long long d0;  // first merged lane of the tile
    int width;     // merged lanes of the tile
    int la, lb;    // lanes of the A and B slices
    int oak, oav;  // first lane of the A slice in the key and value buffers
    int obk, obv;  // first lane of the B slice
};

constexpr int SPLIT_THREADS = 256;
constexpr int G = MERGE_SPLIT_GROUP;
constexpr unsigned FULL = 0xffffffffu;
static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "group of lanes");

// The split of one tile boundary t: the merge-path split of diagonal
// min(t * tile, na + nb) (A first on equal keys), by a group of G lanes
// searching (G + 1) ways.  Each round the G lanes probe G points that cut
// [lo, hi) into G + 1 parts (lane l at lo + (hi - lo) * (l + 1) / (G + 1)),
// each testing a[p] <= b[diag - 1 - p]; the first lane that fails bounds
// the split from above, the lane before it from below.  A range of r lanes
// shrinks to at most r / (G + 1) a round.  G = 1 is merge_path's binary
// search; wider groups take fewer rounds of dependent loads but more loads
// in all.  For ascending runs the result is merge_path's whatever G is; for
// any input every probe stays inside the runs.
__global__ void __launch_bounds__(SPLIT_THREADS)
merge_splits(const long long* __restrict__ a, long long na, const long long* __restrict__ b,
             long long nb, long long tile, long long ntiles, long long* __restrict__ splits) {
    // let merge_tiles, launched after this grid, start its launch now; it
    // waits for this grid's splits before it reads them (griddepcontrol.wait)
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    const long long t = (blockIdx.x * (long long)SPLIT_THREADS + threadIdx.x) / G;
    const int lane = threadIdx.x % G;
    const int base = (threadIdx.x & 31) & ~(G - 1);  // the group's first lane in the warp
    const long long n = na + nb;
    const long long diag = t * tile < n ? t * tile : n;
    long long lo = diag > nb ? diag - nb : 0;
    long long hi = diag < na ? diag : na;
    if (t > ntiles) hi = lo;  // past the last boundary: nothing to search
    // The whole warp goes round together, so the groups' loads of a round
    // are in flight at once; a group whose range has closed idles.
    while (__any_sync(FULL, lo < hi)) {
        const bool live = lo < hi;
        const long long p = lo + (hi - lo) * (lane + 1) / (G + 1);
        const bool take = live && a[p] <= b[diag - 1 - p];
        const unsigned mine = G == 32 ? FULL : ((1u << G) - 1u) << base;
        const unsigned fails = ~__ballot_sync(FULL, take) & mine;
        const int f = fails ? __ffs(fails) - 1 - base : G;  // the first lane that fails
        const long long below = __shfl_sync(FULL, p, base + (f > 0 ? f - 1 : 0));
        const long long above = __shfl_sync(FULL, p, base + (f < G ? f : G - 1));
        if (live && f > 0) lo = below + 1;
        if (live && f < G) hi = above;
    }
    if (t > ntiles) return;
    if (lane == 0) splits[t] = lo;
}

// Start the copies of tile `tile` (splits sp0, sp1) into stage `buf`.
__device__ __forceinline__ void start_tile(long long tile, long long sp0, long long sp1,
                                           long long n, const long long* a, const long long* av,
                                           const long long* b, const long long* bv,
                                           long long* buf, TileInfo* info) {
    const long long d0 = tile * TILE;
    const long long d1 = d0 + TILE < n ? d0 + TILE : n;
    const TileSlices sl = tile_slices(d0, d1, sp0, sp1);
    long long* kbuf = buf;
    long long* vbuf = buf + BUF;
    const int oak = copy_run(kbuf, a + sl.a0, sl.la);
    const int oav = copy_run(vbuf, av + sl.a0, sl.la);
    const int kb = (oak + sl.la + 1) & ~1;
    const int vb = (oav + sl.la + 1) & ~1;
    const int obk = kb + copy_run(kbuf + kb, b + sl.b0, sl.lb);
    const int obv = vb + copy_run(vbuf + vb, bv + sl.b0, sl.lb);
    if (threadIdx.x == 0) {
        *info = TileInfo{d0, (int)(d1 - d0), sl.la, sl.lb, oak, oav, obk, obv};
    }
}

__global__ void __launch_bounds__(THREADS)
merge_tiles(const long long* __restrict__ a, const long long* __restrict__ av, long long na,
            const long long* __restrict__ b, const long long* __restrict__ bv, long long nb,
            const long long* __restrict__ splits, long long ntiles,
            long long* __restrict__ out_keys, long long* __restrict__ out_vals) {
    extern __shared__ __align__(16) long long dyn[];
    __shared__ TileInfo s_info[STAGES];
    // launched as merge_splits' programmatic dependent: its splits are
    // complete and visible past this point
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int tid = threadIdx.x;
    const long long n = na + nb;
    const long long stride = gridDim.x;
#ifdef MERGE_PROFILE
    long long mark = clock64();
#endif

    // The ring: the block's k-th tile goes through stage k % STAGES.  Stages
    // 0 .. STAGES - 2 start here; each later tile starts once the stage it
    // reuses has been stored.  Every thread commits one group a tile (empty
    // past the block's last tile), so wait_group counts tiles.
    long long next = blockIdx.x;  // the next tile to start
    for (int s = 0; s < STAGES - 1; ++s, next += stride) {
        if (next < ntiles) {
            start_tile(next, splits[next], splits[next + 1], n, a, av, b, bv,
                       dyn + s * STAGE_LANES, s_info + s);
        }
        cp_async_commit();
    }
    long long sp0 = 0;  // the splits of `next`, loaded a tile ahead of their use
    long long sp1 = 0;
    if (next < ntiles) {
        sp0 = splits[next];
        sp1 = splits[next + 1];
    }
    PHASE(5);  // first copies started

    int stage = 0;
    for (long long tile = blockIdx.x; tile < ntiles; tile += stride) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // the tile's slices have landed; the previous stage is stored
        PHASE(0);

        const int reuse = stage == 0 ? STAGES - 1 : stage - 1;
        if (next < ntiles) {
            start_tile(next, sp0, sp1, n, a, av, b, bv, dyn + reuse * STAGE_LANES,
                       s_info + reuse);
        }
        cp_async_commit();
        next += stride;
        if (next < ntiles) {
            sp0 = splits[next];
            sp1 = splits[next + 1];
        }
        PHASE(1);

        const TileInfo in = s_info[stage];
        long long* kbuf = dyn + stage * STAGE_LANES;
        long long* vbuf = kbuf + BUF;
        const long long* sa = kbuf + in.oak;
        const long long* sb = kbuf + in.obk;
        const long long* va = vbuf + in.oav;
        const long long* vb = vbuf + in.obv;
        const int la = in.la;
        const int lb = in.lb;
        const int len = la + lb;  // == width unless the runs were out of order
        const int d = tid * ITEMS;
        int i = la;
        int j = lb;
        if (d < len) {
            i = merge_path<int>(sa, la, sb, lb, d);
            j = d - i;
        }
        // The heads of both runs stay in registers, so a step reads one key
        // and one value from shared memory.  A head past its slice reads a
        // lane of the stage that is never taken.
        long long head_a = sa[i];
        long long head_b = sb[j];
        long long key[ITEMS];
        long long val[ITEMS];
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) {
            if (d + r < len) {
                const bool take_a = i < la && (j >= lb || head_a <= head_b);
                key[r] = take_a ? head_a : head_b;
                val[r] = take_a ? va[i] : vb[j];
                i += take_a;
                j += !take_a;
                const long long following = take_a ? sa[i] : sb[j];
                head_a = take_a ? following : head_a;
                head_b = take_a ? head_b : following;
            }
        }
        PHASE(2);
        __syncthreads();  // every thread has read the stage
#pragma unroll
        for (int r = 0; r < ITEMS; ++r) {
            if (d + r < len) {
                kbuf[d + r] = key[r];
                vbuf[d + r] = val[r];
            }
        }
        for (int t = len + tid; t < in.width; t += THREADS) {  // only for runs out of order
            kbuf[t] = SENT;
            vbuf[t] = 0;
        }
        __syncthreads();
        PHASE(3);

        long long* ok = out_keys + in.d0;
        long long* ov = out_vals + in.d0;
        const int pairs = in.width >> 1;
        for (int p = tid; p < pairs; p += THREADS) {
            reinterpret_cast<longlong2*>(ok)[p] = reinterpret_cast<const longlong2*>(kbuf)[p];
            reinterpret_cast<longlong2*>(ov)[p] = reinterpret_cast<const longlong2*>(vbuf)[p];
        }
        if (tid == 0 && (in.width & 1)) {
            ok[in.width - 1] = kbuf[in.width - 1];
            ov[in.width - 1] = vbuf[in.width - 1];
        }
        PHASE(4);
        stage = stage + 1 == STAGES ? 0 : stage + 1;
    }
}

// Blocks of merge_tiles that one SM of `device` holds and the SMs of it,
// found once per device (the dynamic shared-memory limit is raised then).
int g_blocks[MAX_DEVICES];
int g_sms[MAX_DEVICES];

cudaError_t resident(int device, int* blocks, int* sms) {
    if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (g_blocks[device] == 0) {
        cudaError_t err = cudaFuncSetAttribute(
            merge_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
        if (err != cudaSuccess) return err;
        int per_sm = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_tiles, THREADS,
                                                            SMEM_BYTES);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        int count = 0;
        err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return err;
        g_sms[device] = count;
        g_blocks[device] = per_sm;
    }
    *blocks = g_blocks[device];
    *sms = g_sms[device];
    return cudaSuccess;
}

// The split pass: splits[t] for t = 0 .. ceil((na + nb) / tile).
int launch_splits(const long long* a, long long na, const long long* b, long long nb,
                  long long tile, long long* splits, cudaStream_t stream) {
    const long long ntiles = (na + nb + tile - 1) / tile;
    const long long blocks = ((ntiles + 1) * G + SPLIT_THREADS - 1) / SPLIT_THREADS;
    merge_splits<<<(unsigned)blocks, SPLIT_THREADS, 0, stream>>>(a, na, b, nb, tile, ntiles,
                                                                 splits);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gossamer_merge_tile() { return TILE; }

int gossamer_merge_threads() { return THREADS; }

int gossamer_merge_stages() { return STAGES; }

int gossamer_merge_smem_bytes() { return SMEM_BYTES; }

const char* gossamer_merge_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Blocks of merge_tiles that one SM of `device` holds, into *blocks.
int gossamer_merge_blocks_per_sm(int device, int* blocks) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    return (int)resident(device, blocks, &sms);
}

// The MERGE_PROFILE cycle sums (PROFILE_WORDS of them): reset to 0, or read
// into host memory.  The device is synchronised.
int gossamer_merge_profile(int device, void* host_words, int reset) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceSynchronize();
    if (err != cudaSuccess) return (int)err;
    if (reset) {
        static const unsigned long long zeros[PROFILE_WORDS] = {};
        return (int)cudaMemcpyToSymbol(g_profile, zeros, sizeof(zeros));
    }
    return (int)cudaMemcpyFromSymbol(host_words, g_profile,
                                     PROFILE_WORDS * sizeof(unsigned long long));
}

int gossamer_merge_split_group() { return G; }

// The split of every tile boundary: splits[t] = the A lanes among the first
// min(t * tile, na + nb) merged lanes, t = 0 .. ceil((na + nb) / tile).
// All pointers are device pointers on `device`; the kernel runs on `stream`
// and nothing synchronises.  Returns cudaGetLastError().
int gossamer_merge_splits(int device, const void* a_keys, long long na, const void* b_keys,
                          long long nb, long long tile, void* splits, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (tile < 1) return (int)cudaErrorInvalidValue;
    return launch_splits((const long long*)a_keys, na, (const long long*)b_keys, nb, tile,
                         (long long*)splits, (cudaStream_t)stream);
}

// The merge: merge_splits at this build's tile into `splits`
// (ceil((na + nb) / gossamer_merge_tile()) + 1 lanes), then merge_tiles as
// its programmatic dependent.  out_keys and out_vals hold na + nb lanes and
// are 16-byte aligned.  Device pointers, `stream`, no synchronisation.
// Returns the first error: of the split launch, the occupancy query, or the
// tiles' launch.
int gossamer_merge_sorted(int device, const void* a_keys, const void* a_vals, long long na,
                          const void* b_keys, const void* b_vals, long long nb, void* splits,
                          void* out_keys, void* out_vals, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long ntiles = (na + nb + TILE - 1) / TILE;
    if (ntiles == 0) return (int)cudaSuccess;
    const long long* a = (const long long*)a_keys;
    const long long* b = (const long long*)b_keys;
    long long* sp = (long long*)splits;
    cudaStream_t st = (cudaStream_t)stream;
    const int code = launch_splits(a, na, b, nb, TILE, sp, st);
    if (code != 0) return code;
    int blocks = 0;
    int sms = 0;
    err = resident(device, &blocks, &sms);
    if (err != cudaSuccess) return (int)err;
    const long long most = (long long)blocks * sms;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(ntiles < most ? ntiles : most));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, merge_tiles, a, (const long long*)a_vals, na, b,
                             (const long long*)b_vals, nb, (const long long*)sp, ntiles,
                             (long long*)out_keys, (long long*)out_vals);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
