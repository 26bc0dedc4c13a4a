// fused_sparse_backward for Hopper (sm_90a): the backward of the fused
// sparse step, IN PLACE. For every table t of a stacked bundle and every
// unique slot u >= 1 whose row id uids[t][u] is >= 0:
//
//   g     = the sum, over the positions n with inverse[t][n] == u, of
//           gs[t][n / L] * (ids[t][n] >= 0), in a fixed order (below), then
//           divided by max(counts[t][u], 1) under grad_averaging
//   the value row and the slot rows of row r = min(uids[t][u], C-1) go
//           through the optimizer's row function (sgd, adagrad, adam, adamw,
//           ftrl) and are written back; a bf16 value row rounds
//           stochastically with the row-keyed bits of (seed, uid, column).
//
// The sentinel slot (u = 0) and unclaimed slots (uids < 0) are never
// written. Valid uids are unique within a table, so no two blocks write one
// row. counts must be the forward's: counts[t][u] is the number of
// positions whose inverse is u.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/fused_lookup.py::
// fused_sparse_backward, which segment-sums all N positions in order into
// a [U, D] VMEM buffer, stages the touched value and slot rows in VMEM by
// DMA, runs the optimizer over the whole [U, D] stage and DMAs the rows
// back, one core walking everything in order. On Hopper the sum is split
// so that no warp, and no SM, walks a long chain, in a FIXED order that
// depends only on the set of positions of a slot, never on the slot's
// number, and that the plain version (ops/fused_lookup.py,
// _segment_sum_plain) follows exactly:
//   level 1: a slot's positions in ascending flat order, in chunks of 32,
//            each chunk summed in order from 0;
//   level 2: the chunk partials in runs of 8 chunks (256 positions), each
//            run summed in order from 0;
//   level 3: the runs' sums, in order from 0.
// A slot of at most 32 positions is one chunk, and its sum is the chunk's.
//
// Three launches and no memset, with nothing between them:
//   1. scan: one CTA per tile of 2,048 slots scans uids and counts (a
//      block scan) and writes, for the slots with positions, cursor[u] =
//      the exclusive prefix of counts within the tile (where u's region of
//      the placement starts, after the tile's base); the tile's list of
//      live slots of at most 32 positions; for the larger ("big") slots
//      their run base, their tasks (a task is one run) in the tile's task
//      list, and a count of tasks still to finish; and the tile's totals.
//      A consumer CTA scans the tiles' totals into shared memory first, so
//      no launch waits on a serial scan over U;
//   2. place: one thread per position appends its flat position (bit 31
//      set where its id is a pad) to its slot's region by an atomicAdd on
//      the slot's cursor (the positions of one slot in a warp take one
//      atomic). The order inside a region is the atomics' and changes from
//      run to run;
//   3. sum and apply: a grid of 12 CTAs of 8 warps per SM (3 resident),
//      each CTA looping over the tasks, then each warp over the small slots
//      (dealt from the last CTA back, away from the CTAs with a task). A task
//      sorts its slot's region through a bitmap of the flat positions in
//      shared memory (N positions, or windows of 2^18 at a time, so any N
//      works) and keeps the positions of its 256 ranks; its 8 warps sum a
//      chunk each, and the run sums the chunks in order into a run buffer.
//      The CTA that finishes a slot's last task (a fence and an atomic
//      count) adds the slot's runs in order, one thread per column, and
//      applies. A small slot's warp ranks its positions in registers (a
//      sort of 32 by counting), sums them in ascending order, and applies.
//
// What bounds it: the latency of the dependent loads (slot, region,
// gradient row, table row) more than bytes: the per-bag gradients (one row
// read per position, from L2), the positions (written once, read once, a
// big slot's region once per run), and one read and one write of each
// touched value row and slot row. The previous design issued about fifteen
// device operations per call (a stable torch.sort of inverse with an int64
// payload, a sorted search, prefix sums) and walked a zipf head's 1,100
// chunk partials in one warp. This one issues three launches, takes each
// slot's region from the forward's counts, spreads a zipf head (25,000
// positions, 100 runs) over as many CTAs with at most 32 positions in any
// warp's chain, loads 8 gradient rows before it adds them, and sizes its
// grid to the card, not to the budget U. What is left is latency: the
// sum-and-apply launch takes about 25 us even for a small group (PERF.md).
//
// Numerics: every operation rounds on its own (__fadd_rn, __fmul_rn,
// __fdiv_rn, __fsub_rn; the build adds -fmad=false), in the operation
// order of optim/sparse.py, with sqrtf, rsqrtf and powf where it calls
// torch.sqrt, torch.rsqrt and torch.pow (whose special exponents are
// special-cased as PyTorch's CUDA pow does). The scalar factors lr,
// Adam's bias-corrected lr and AdamW's lr * weight_decay arrive as a
// device array computed by the same torch expressions the plain version
// evaluates; the constant hyperparameters arrive as f32 arguments.
//
// Offsets are 64-bit. The launcher runs on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;       // positions per chunk (ops/fused_lookup.py _CHUNK)
constexpr int kRun = 8;          // chunks per run (ops/fused_lookup.py _RUN)
constexpr int kRunPos = kChunk * kRun;
constexpr int kWarps = 8;        // warps of a sum-and-apply CTA = chunks of a run
constexpr int kColsPerLane = 4;  // a warp's pass covers 128 columns
constexpr int kBatch = 8;        // gradient rows in flight per warp
constexpr int kScanThreads = 512;
constexpr int kScanItems = 4;    // slots per thread
constexpr int kTile = kScanThreads * kScanItems;  // slots per scan CTA
constexpr int kMaxTiles = 1024;  // U <= 2^21
constexpr int kThreads = 256;    // place and apply CTAs
constexpr int kBlocksPerSM = 3;
constexpr int kMaxWindowWords = 8192;  // the bitmap: at most 2^18 positions, 32 KB
constexpr int32_t kPadBit = (int32_t)0x80000000;  // a placed position whose id is a pad

enum Opt { kSgd = 0, kAdagrad = 1, kAdam = 2, kAdamW = 3, kFtrl = 4 };

struct Hyper {
    float b1, omb1, b2, omb2, eps, p, l2x2, l1;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// torch.pow(x, p) for a float tensor on CUDA: exponents 0, 1, 0.5, -0.5,
// -1, 2, 3 and -2 take PyTorch's special cases, the rest powf.
__device__ __forceinline__ float torch_pow(float x, float p) {
    if (p == 0.f) return 1.f;
    if (p == 1.f) return x;
    if (p == 0.5f) return sqrtf(x);
    if (p == -0.5f) return rsqrtf(x);
    if (p == -1.f) return __fdiv_rn(1.f, x);
    if (p == 2.f) return __fmul_rn(x, x);
    if (p == 3.f) return __fmul_rn(__fmul_rn(x, x), x);
    if (p == -2.f) return (float)(1.0 / (double)__fmul_rn(x, x));
    return powf(x, p);
}

__device__ __forceinline__ float sign(float x) { return (float)((0.f < x) - (x < 0.f)); }

// The optimizer's row function on one element, in optim/sparse.py's
// operation order. v is the value, g the gradient, s0/s1 the slots.
__device__ __forceinline__ float update(int opt, float v, float g, float& s0, float& s1,
                                        const float* scal, const Hyper& h) {
    const float lr = scal[0];
    switch (opt) {
        case kSgd:
            return __fsub_rn(v, __fmul_rn(lr, g));
        case kAdagrad: {
            const float acc = __fadd_rn(s0, __fmul_rn(g, g));
            s0 = acc;
            return __fsub_rn(v, __fmul_rn(__fmul_rn(lr, g), rsqrtf(fmaxf(acc, 1e-30f))));
        }
        case kAdam:
        case kAdamW: {
            const float m = __fadd_rn(__fmul_rn(h.b1, s0), __fmul_rn(h.omb1, g));
            const float vv = __fadd_rn(__fmul_rn(h.b2, s1), __fmul_rn(__fmul_rn(h.omb2, g), g));
            s0 = m;
            s1 = vv;
            const float den = __fadd_rn(sqrtf(vv), h.eps);
            if (opt == kAdam) return __fsub_rn(v, __fdiv_rn(__fmul_rn(scal[1], m), den));
            return __fsub_rn(__fsub_rn(v, __fmul_rn(scal[1], __fdiv_rn(m, den))),
                             __fmul_rn(scal[2], v));
        }
        case kFtrl: {
            const float na = __fadd_rn(s0, __fmul_rn(g, g));
            const float pn = torch_pow(na, h.p);
            const float sigma = __fdiv_rn(__fsub_rn(pn, torch_pow(s0, h.p)), lr);
            const float lin = __fsub_rn(__fadd_rn(s1, g), __fmul_rn(sigma, v));
            const float quad = __fadd_rn(__fdiv_rn(pn, lr), h.l2x2);
            s0 = na;
            s1 = lin;
            return fabsf(lin) > h.l1 ? __fdiv_rn(__fsub_rn(__fmul_rn(h.l1, sign(lin)), lin), quad)
                                     : 0.f;
        }
    }
    return v;
}

// Per-slot quantities the scan prefixes: positions, small slots, runs (a
// big slot's tasks are its runs, one each).
struct Three {
    int cnt, small, runs;
};

struct AddThree {
    __device__ __forceinline__ Three operator()(const Three& x, const Three& y) const {
        return Three{x.cnt + y.cnt, x.small + y.small, x.runs + y.runs};
    }
};

__device__ __forceinline__ Three slot_terms(int32_t uid, int32_t cnt) {
    const bool live = uid >= 0;
    return Three{cnt, live && cnt <= kChunk ? 1 : 0,
                 live && cnt > kChunk ? (cnt + kRunPos - 1) / kRunPos : 0};
}

// The workspace of one call (sizes in `workspace_sizes`). The scan cuts
// each table's slots into K tiles of kTile; every per-slot offset below is
// local to the slot's tile, and a consumer adds the tile's base, the
// exclusive prefix of the tiles' totals, which each consumer CTA scans
// into shared memory first. A run's number in the table is its row in runs
// and its task's number.
struct Work {
    int32_t* order;      // [T, N] positions grouped by slot
    int32_t* cursor;     // [T, U] region start in the tile; after the placement, its end
    int32_t* runbase;    // [T, U] a big slot's first run, in the tile
    int32_t* remaining;  // [T, U] a big slot's runs still to finish
    int4* small;         // [T, K, kTile] each tile's live slots of at most 32
                         // positions: (slot, uid, positions, region start in the tile)
    int32_t* tasks;      // [T, K, RC] the slot of each of a tile's runs
    Three* totals;       // [T, K] each tile's sums
    float* runs;         // [T, MR, D] run sums
    int64_t K, RC, MR;
};

struct Sizes {
    int64_t K, RC, MR, elems;
};

// RC and MR: at most one run per 256 positions and one per big slot (of a
// tile, of a table).
__host__ __device__ inline Sizes workspace_sizes(int64_t T, int64_t N, int64_t U, int64_t D) {
    Sizes z;
    z.K = (U + kTile - 1) / kTile;
    z.RC = kTile + N / kRunPos + 1;
    z.MR = N / kRunPos + N / kChunk + 2;
    z.elems = 4 * T * z.K * kTile + T * N + 3 * T * U + T * z.K * z.RC + 3 * T * z.K +
              T * z.MR * D;
    return z;
}

struct Args {
    const float* gs;       // [T, B, D]
    const int32_t* ids;    // [T, N]
    const int32_t* uids;   // [T, U]
    const int32_t* counts; // [T, U]
    Work w;
    void* values;          // [T, C, D] f32 or bf16
    float* s0;
    float* s1;
    const float* scal;
    Hyper h;
    uint32_t seed;
    int grad_averaging;
    int64_t B, L, C, D, U;
    int words;             // the bitmap window's words, a multiple of kThreads
};

// One column of a slot's rows: load the value and slot elements, then
// update them with the gradient sum `acc` and store them.
struct Elem {
    float v, s0, s1;
};

template <bool BF16>
__device__ __forceinline__ Elem load_col(const Args& a, int64_t off, int64_t col) {
    Elem e;
    if (BF16) {
        e.v = __uint_as_float(uint32_t(static_cast<const uint16_t*>(a.values)[off + col]) << 16);
    } else {
        e.v = static_cast<const float*>(a.values)[off + col];
    }
    e.s0 = a.s0 ? a.s0[off + col] : 0.f;
    e.s1 = a.s1 ? a.s1[off + col] : 0.f;
    return e;
}

template <bool BF16, int OPT>
__device__ __forceinline__ void store_col(const Args& a, int64_t off, int64_t col, Elem e,
                                          float acc, float cnt, uint32_t rowbits) {
    const float g = a.grad_averaging ? __fdiv_rn(acc, cnt) : acc;
    const float nv = update(OPT, e.v, g, e.s0, e.s1, a.scal, a.h);
    if (BF16) {
        const uint32_t bits = mix32(rowbits ^ mix32((uint32_t)col * 0x9E3779B9u));
        static_cast<uint16_t*>(a.values)[off + col] =
            (uint16_t)((__float_as_uint(nv) + (bits & 0xFFFFu)) >> 16);
    } else {
        static_cast<float*>(a.values)[off + col] = nv;
    }
    if (a.s0) a.s0[off + col] = e.s0;
    if (a.s1) a.s1[off + col] = e.s1;
}

// 1. One CTA per tile of kTile slots (see the header).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int32_t* __restrict__ uids, const int32_t* __restrict__ counts, Work w,
            int64_t U) {
    using Scan = cub::BlockScan<Three, kScanThreads, cub::BLOCK_SCAN_WARP_SCANS>;
    __shared__ typename Scan::TempStorage tmp;
    const int64_t t = blockIdx.y;
    const int64_t tile = blockIdx.x;
    const int64_t u0 = tile * kTile + (int64_t)threadIdx.x * kScanItems;
    int32_t uid[kScanItems], cnt[kScanItems];
    Three mine{0, 0, 0};
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
        const int64_t u = u0 + i;
        const bool in = u >= 1 && u < U;  // slot 0, the sentinel, has nothing
        uid[i] = in ? uids[t * U + u] : -1;
        cnt[i] = in ? counts[t * U + u] : 0;
        mine = AddThree()(mine, slot_terms(uid[i], cnt[i]));
    }
    Three pre, agg;
    Scan(tmp).ExclusiveScan(mine, pre, Three{0, 0, 0}, AddThree(), agg);
    int4* small = w.small + (t * w.K + tile) * kTile;
    int32_t* tasks = w.tasks + (t * w.K + tile) * w.RC;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
        const int64_t u = u0 + i;
        const Three f = slot_terms(uid[i], cnt[i]);
        if (cnt[i] > 0) w.cursor[t * U + u] = pre.cnt;
        if (f.small) small[pre.small] = make_int4((int)u, uid[i], cnt[i], pre.cnt);
        if (f.runs) {
            w.runbase[t * U + u] = pre.runs;
            w.remaining[t * U + u] = f.runs;
            for (int k = 0; k < f.runs; ++k) tasks[pre.runs + k] = (int32_t)u;
        }
        pre = AddThree()(pre, f);
    }
    if (threadIdx.x == 0) w.totals[t * w.K + tile] = agg;
}

// The tiles' bases of table t into base[0..K] (base[K] = the table's
// totals), by a block scan of kThreads threads over K <= kMaxTiles.
template <typename Temp>
__device__ __forceinline__ void tile_bases(const Work& w, int64_t t, Three* base, Temp& tmp) {
    using Scan = cub::BlockScan<Three, kThreads>;
    constexpr int kPer = kMaxTiles / kThreads;
    Three in[kPer], out[kPer], agg;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int64_t k = (int64_t)threadIdx.x * kPer + i;
        in[i] = k < w.K ? w.totals[t * w.K + k] : Three{0, 0, 0};
    }
    Scan(tmp).ExclusiveScan(in, out, Three{0, 0, 0}, AddThree(), agg);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int64_t k = (int64_t)threadIdx.x * kPer + i;
        if (k < w.K) base[k] = out[i];
    }
    if (threadIdx.x == 0) base[w.K] = agg;
    __syncthreads();
}

// 2. One thread per position: append it to its slot's region.
__global__ void __launch_bounds__(kThreads)
place_kernel(const int32_t* __restrict__ inverse, const int32_t* __restrict__ ids, Work w,
             int64_t N, int64_t U) {
    __shared__ int base[kMaxTiles + 1];
    __shared__ typename cub::BlockScan<int, kThreads>::TempStorage tmp;
    const int64_t t = blockIdx.y;
    {  // the tiles' position bases only
        constexpr int kPer = kMaxTiles / kThreads;
        int in[kPer], out[kPer], agg;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int64_t k = (int64_t)threadIdx.x * kPer + i;
            in[i] = k < w.K ? w.totals[t * w.K + k].cnt : 0;
        }
        cub::BlockScan<int, kThreads>(tmp).ExclusiveSum(in, out, agg);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int64_t k = (int64_t)threadIdx.x * kPer + i;
            if (k < w.K) base[k] = out[i];
        }
        __syncthreads();
    }
    const int64_t n = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    const int lane = threadIdx.x & 31;
    int32_t inv = n < N ? inverse[t * N + n] : 0;
    if (inv >= U || inv < 0) inv = 0;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, inv);
    const int leader = __ffs(peers) - 1;
    int32_t at = 0;
    if (inv > 0 && lane == leader) at = atomicAdd(w.cursor + t * U + inv, __popc(peers));
    at = __shfl_sync(0xFFFFFFFFu, at, leader);
    const int64_t dst =
        (int64_t)base[inv / kTile] + at + __popc(peers & ((1u << lane) - 1u));
    // the position, with bit 31 set where its id is a pad (mask 0)
    if (inv > 0 && dst >= 0 && dst < N)
        w.order[t * N + dst] = (int32_t)n | (ids[t * N + n] < 0 ? kPadBit : 0);
}

// Sum `n` (<= 32) positions of table t, given one per lane in my_pos
// (ascending by lane; a placed position, whose bit 31 marks a pad, or a
// bare one whose pad is read from ids), into acc for the columns of pass
// c0, in order from the value acc holds; kBatch gradient rows are loaded
// before they are added.
__device__ __forceinline__ void chunk_sum(const Args& a, int64_t t, int32_t my_pos, int n,
                                          int64_t c0, int lane, float* acc, bool placed) {
    int32_t my_b = 0;
    float my_w = 0.f;
    if (lane < n) {
        const int32_t pos = my_pos & ~kPadBit;
        my_b = (int32_t)(pos / a.L);
        const bool pad = placed ? (my_pos & kPadBit) != 0 : a.ids[t * a.B * a.L + pos] < 0;
        my_w = pad ? 0.f : 1.f;
    }
    const float* g_t = a.gs + t * a.B * a.D;
    for (int k0 = 0; k0 < n; k0 += kBatch) {
        float x[kBatch][kColsPerLane];
        float wk[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int k = k0 + j < n ? k0 + j : 0;
            const int64_t b = __shfl_sync(0xFFFFFFFFu, my_b, k);
            wk[j] = __shfl_sync(0xFFFFFFFFu, my_w, k);
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q) {
                const int64_t col = c0 + lane + 32 * q;
                x[j][q] = col < a.D ? __ldg(g_t + b * a.D + col) : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            if (k0 + j >= n) break;
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q)
                acc[q] = __fadd_rn(acc[q], __fmul_rn(x[j][q], wk[j]));
        }
    }
}

// The tile k falls in, by the prefix `sel` of base[0..K]: the last tile
// whose base is <= k.
template <int SEL>
__device__ __forceinline__ int64_t find_tile(const Three* base, int64_t K, int64_t k) {
    int64_t lo = 0, hi = K - 1;
    while (lo < hi) {
        const int64_t mid = (lo + hi + 1) >> 1;
        const int v = SEL == 0 ? base[mid].small : base[mid].runs;
        if (v <= k) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// 3. Sum and apply (see the header).
template <bool BF16, int OPT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
apply_kernel(Args a) {
    extern __shared__ uint32_t dyn[];
    uint32_t* bitmap = dyn;                             // a.words
    Three* base = reinterpret_cast<Three*>(dyn + a.words);  // K + 1
    __shared__ int32_t pos[kRunPos];
    __shared__ float part[kWarps][32 * kColsPerLane];
    __shared__ union {
        typename cub::BlockScan<Three, kThreads>::TempStorage three;
        typename cub::BlockScan<int, kThreads>::TempStorage one;
    } tmp;
    __shared__ int window_total;
    __shared__ int last;

    const int64_t t = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t U = a.U, D = a.D, N = a.B * a.L;
    const Work& w = a.w;
    const int32_t* uids = a.uids + t * U;
    const int32_t* counts = a.counts + t * U;
    tile_bases(w, t, base, tmp.three);
    const int64_t ntasks = base[w.K].runs;

    // the tasks of the big slots: a run each, a CTA each
    for (int64_t k = blockIdx.x; k < ntasks; k += gridDim.x) {
        const int64_t tile = find_tile<1>(base, w.K, k);
        const int64_t u = w.tasks[(t * w.K + tile) * w.RC + (k - base[tile].runs)];
        const int64_t r = k - base[tile].runs - w.runbase[t * U + u];  // run in slot
        const int64_t n = counts[u];
        const int32_t* region = w.order + t * N + base[tile].cnt + w.cursor[t * U + u] - n;
        const int64_t lo = r * kRunPos;
        const int64_t hi = lo + kRunPos < n ? lo + kRunPos : n;
        // sort: mark the region's positions in a bitmap of the window, rank
        // the marks by a block scan of popcounts, keep ranks lo..hi-1
        int64_t done = 0;
        const int per = a.words / kThreads;
        for (int64_t w0 = 0; w0 < N && done < hi; w0 += 32LL * a.words) {
            for (int i = threadIdx.x; i < a.words; i += kThreads) bitmap[i] = 0u;
            __syncthreads();
            for (int64_t i = threadIdx.x; i < n; i += kThreads) {
                const int64_t q = (region[i] & ~kPadBit) - w0;
                if (q >= 0 && q < 32LL * a.words) atomicOr(&bitmap[q >> 5], 1u << (q & 31));
            }
            __syncthreads();
            const int first = threadIdx.x * per;
            int mine = 0;
            for (int i = 0; i < per; ++i) mine += __popc(bitmap[first + i]);
            int pre, total;
            cub::BlockScan<int, kThreads>(tmp.one).ExclusiveSum(mine, pre, total);
            if (threadIdx.x == 0) window_total = total;
            int64_t q = done + pre;
            if (q < hi && q + mine > lo) {
                for (int i = 0; i < per; ++i) {
                    uint32_t bits = bitmap[first + i];
                    while (bits) {
                        const int b = __ffs(bits) - 1;
                        bits &= bits - 1;
                        if (q >= lo && q < hi)
                            pos[q - lo] = (int32_t)(w0 + 32LL * (first + i) + b);
                        ++q;
                    }
                }
            }
            __syncthreads();
            done += window_total;
        }
        // warp `warp` sums chunk `warp` of the run; the run sums the chunks
        // in order, a thread a column
        const int64_t nruns = (n + kRunPos - 1) / kRunPos;
        float* runs = w.runs + (t * w.MR + k - r) * D;  // the slot's first run
        const int m = (int)(hi - lo - warp * kChunk);  // this warp's positions
        for (int64_t c0 = 0; c0 < D; c0 += 32 * kColsPerLane) {
            float acc[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
            if (m > 0) {
                const int mm = m < kChunk ? m : kChunk;
                chunk_sum(a, t, lane < mm ? pos[warp * kChunk + lane] : 0, mm, c0, lane, acc,
                          false);
            }
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q) part[warp][lane + 32 * q] = acc[q];
            __syncthreads();
            if (threadIdx.x < 32 * kColsPerLane && c0 + threadIdx.x < D) {
                float run = 0.f;
                for (int c = 0; c < kRun && c * kChunk < hi - lo; ++c)
                    run = __fadd_rn(run, part[c][threadIdx.x]);
                runs[r * D + c0 + threadIdx.x] = run;
            }
            __syncthreads();
        }
        // the CTA that finishes the slot's last task sums the runs and applies
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) last = atomicSub(w.remaining + t * U + u, 1) == 1;
        __syncthreads();
        if (last) {
            __threadfence();
            const int32_t uid = uids[u];
            const int64_t row = uid < a.C ? uid : a.C - 1;
            const int64_t off = (t * a.C + row) * D;
            const float cnt = fmaxf((float)n, 1.f);
            const uint32_t rowbits = mix32((uint32_t)uid ^ mix32(a.seed));
            for (int64_t col = threadIdx.x; col < D; col += kThreads) {
                float g = 0.f;
                for (int64_t q = 0; q < nruns; ++q) g = __fadd_rn(g, __ldcg(runs + q * D + col));
                store_col<BF16, OPT>(a, off, col, load_col<BF16>(a, off, col), g, cnt, rowbits);
            }
        }
        __syncthreads();  // bitmap and pos are reused by the next task
    }

    // the small slots, a warp each, dealt from the last CTA back, so that
    // the CTAs that drew a task draw small slots last
    const int64_t nsmall = base[w.K].small;
    for (int64_t i = int64_t(gridDim.x - 1 - blockIdx.x) * kWarps + warp; i < nsmall;
         i += int64_t(gridDim.x) * kWarps) {
        const int64_t tile = find_tile<0>(base, w.K, i);
        const int4 rec = w.small[(t * w.K + tile) * kTile + (i - base[tile].small)];
        const int32_t uid = rec.y;
        const int n = rec.z;
        const int32_t* region = w.order + t * N + base[tile].cnt + rec.w;
        const int32_t p = lane < n ? region[lane] : 0x7FFFFFFF;
        const int32_t key = p & ~kPadBit;
        const int64_t row = uid < a.C ? uid : a.C - 1;
        const int64_t off = (t * a.C + row) * D;
        const float cnt = fmaxf((float)n, 1.f);
        const uint32_t rowbits = mix32((uint32_t)uid ^ mix32(a.seed));
        int rank = 0;  // positions are distinct: the count of smaller ones
        for (int k = 0; k < 32; ++k) rank += __shfl_sync(0xFFFFFFFFu, key, k) < key;
        int32_t mine = 0x7FFFFFFF;  // lane k takes the position of rank k
        for (int k = 0; k < n; ++k) {
            const int src = __ffs(__ballot_sync(0xFFFFFFFFu, lane < n && rank == k)) - 1;
            const int32_t pk = __shfl_sync(0xFFFFFFFFu, p, src);
            if (lane == k) mine = pk;
        }
        for (int64_t c0 = 0; c0 < D; c0 += 32 * kColsPerLane) {
            Elem e[kColsPerLane];  // the rows' loads overlap the gradient sum's
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q) {
                const int64_t col = c0 + lane + 32 * q;
                if (col < D) e[q] = load_col<BF16>(a, off, col);
            }
            float acc[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
            chunk_sum(a, t, mine, n, c0, lane, acc, true);
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q) {
                const int64_t col = c0 + lane + 32 * q;
                if (col < D) store_col<BF16, OPT>(a, off, col, e[q], acc[q], cnt, rowbits);
            }
        }
    }
}

// The sum-and-apply launch of one value type and optimizer, with `smem`
// bytes of dynamic shared memory (the bitmap window and the tiles' bases).
template <bool BF16, int OPT>
cudaError_t launch_apply(const Args& a, dim3 grid, size_t smem, cudaStream_t s) {
    const cudaError_t err = cudaFuncSetAttribute(
        apply_kernel<BF16, OPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    apply_kernel<BF16, OPT><<<grid, kThreads, smem, s>>>(a);
    return cudaGetLastError();
}

}  // namespace

// int32 elements of the workspace `fused_sparse_backward_launch` needs
// (its f32 run sums counted as 4-byte elements too).
extern "C" long long fused_sparse_backward_workspace(long long T, long long B, long long L,
                                                     long long D, long long U) {
    return (long long)workspace_sizes(T, (int64_t)B * (int64_t)L, U, D).elems;
}

// The whole backward on the caller's stream: three launches.
// values [T, C, D] (f32, or bf16 when bf16 != 0) and the slots s0, s1
// [T, C, D] f32 (null where the optimizer has fewer) updated in place;
// gs [T, B, D] f32 combiner-scaled gradients; ids and inverse [T, B*L],
// uids and counts [T, U] int32 from the forward; work: an int32 workspace
// of fused_sparse_backward_workspace(T, B, L, D, U) elements, its contents
// on entry do not matter; scal [3] f32 on the device (lr, Adam's
// bias-corrected lr, AdamW's lr * weight_decay); opt 0..4 = sgd, adagrad,
// adam, adamw, ftrl with their f32 constants; seed the low 32 bits.
extern "C" int fused_sparse_backward_launch(
    void* values, void* s0, void* s1, const void* gs, const void* ids, const void* inverse,
    const void* uids, const void* counts, const void* scal, void* work, long long T,
    long long B, long long L, long long C, long long D, long long U, int opt, float b1,
    float omb1, float b2, float omb2, float eps, float p, float l2x2, float l1,
    unsigned int seed, int grad_averaging, int bf16, void* stream) {
    const int64_t N = (int64_t)B * (int64_t)L;
    if (T <= 0 || U <= 1 || N <= 0) return 0;
    const Sizes z = workspace_sizes(T, N, U, D);
    if (C <= 0 || D <= 0 || T > 65535 || opt < kSgd || opt > kFtrl || N > 0x7FFFFFFFLL ||
        z.K > kMaxTiles)
        return (int)cudaErrorInvalidValue;
    const int nslots = opt == kSgd ? 0 : (opt == kAdagrad ? 1 : 2);
    if ((nslots >= 1 && s0 == nullptr) || (nslots == 2 && s1 == nullptr))
        return (int)cudaErrorInvalidValue;
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int32_t* base = static_cast<int32_t*>(work);
    Work w;
    w.K = z.K;
    w.RC = z.RC;
    w.MR = z.MR;
    w.small = reinterpret_cast<int4*>(base);  // first: 16-byte aligned
    w.order = base + 4 * T * z.K * kTile;
    w.cursor = w.order + T * N;
    w.runbase = w.cursor + T * U;
    w.remaining = w.runbase + T * U;
    w.tasks = w.remaining + T * U;
    w.totals = reinterpret_cast<Three*>(w.tasks + T * z.K * z.RC);
    w.runs = reinterpret_cast<float*>(w.totals + T * z.K);
    const int32_t* ui = static_cast<const int32_t*>(uids);
    const int32_t* ct = static_cast<const int32_t*>(counts);

    scan_kernel<<<dim3((unsigned int)z.K, (unsigned int)T), kScanThreads, 0, s>>>(ui, ct, w, U);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    place_kernel<<<dim3((unsigned int)((N + kThreads - 1) / kThreads), (unsigned int)T), kThreads,
                   0, s>>>(static_cast<const int32_t*>(inverse), static_cast<const int32_t*>(ids),
                           w, N, U);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

    Args a;
    a.gs = static_cast<const float*>(gs);
    a.ids = static_cast<const int32_t*>(ids);
    a.uids = ui;
    a.counts = ct;
    a.w = w;
    a.values = values;
    a.s0 = nslots >= 1 ? static_cast<float*>(s0) : nullptr;
    a.s1 = nslots == 2 ? static_cast<float*>(s1) : nullptr;
    a.scal = static_cast<const float*>(scal);
    a.h = Hyper{b1, omb1, b2, omb2, eps, p, l2x2, l1};
    a.seed = seed;
    a.grad_averaging = grad_averaging;
    a.B = B;
    a.L = L;
    a.C = C;
    a.D = D;
    a.U = U;
    // the bitmap window: N positions, at most 2^18, in whole words per thread
    const int64_t words = (N + 31) / 32 < kMaxWindowWords ? (N + 31) / 32 : kMaxWindowWords;
    a.words = (int)((words + kThreads - 1) / kThreads * kThreads);
    const size_t smem = ((size_t)a.words + 3 * (size_t)(z.K + 1)) * sizeof(uint32_t);
    // four times as many CTAs as the card holds at once (a CTA that draws a
    // long task leaves the rest to others), shared among the tables, and
    // never more warps than slots
    const int64_t fill = ((int64_t)sms * kBlocksPerSM * 4 + T - 1) / T;
    const int64_t need = (U - 1 + kWarps - 1) / kWarps;
    const dim3 grid((unsigned int)(fill < need ? fill : need), (unsigned int)T);
    switch (opt * 2 + (bf16 ? 1 : 0)) {
        case 0: err = launch_apply<false, kSgd>(a, grid, smem, s); break;
        case 1: err = launch_apply<true, kSgd>(a, grid, smem, s); break;
        case 2: err = launch_apply<false, kAdagrad>(a, grid, smem, s); break;
        case 3: err = launch_apply<true, kAdagrad>(a, grid, smem, s); break;
        case 4: err = launch_apply<false, kAdam>(a, grid, smem, s); break;
        case 5: err = launch_apply<true, kAdam>(a, grid, smem, s); break;
        case 6: err = launch_apply<false, kAdamW>(a, grid, smem, s); break;
        case 7: err = launch_apply<true, kAdamW>(a, grid, smem, s); break;
        case 8: err = launch_apply<false, kFtrl>(a, grid, smem, s); break;
        default: err = launch_apply<true, kFtrl>(a, grid, smem, s); break;
    }
    return (int)err;
}
