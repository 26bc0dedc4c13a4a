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
// written. Valid uids are unique within a table, so no two warps write one
// row.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/fused_lookup.py::
// fused_sparse_backward, which segment-sums all N positions in order into
// a [U, D] VMEM buffer, stages the touched value and slot rows in VMEM by
// DMA, runs the optimizer over the whole [U, D] stage and DMAs the rows
// back, one core walking everything in order. On Hopper the sum is split
// so that no warp walks a long chain, in a FIXED order the plain version
// (ops/fused_lookup.py) follows exactly:
//   - the wrapper sorts inverse stably (order: the flat positions grouped
//     by slot, in flat-position order inside a slot) and cuts each slot's
//     positions into chunks of 32 (start, nch, base: index bookkeeping);
//   - launch 1, partials: one warp per chunk sums its <= 32 positions in
//     order from 0 into part[t][chunk] (lanes over columns, 4 each);
//   - launch 2, apply: one warp per unique slot sums its chunks' partials
//     in order from 0, then runs the optimizer and writes the rows back.
// A zipf head id with 30,000 positions is then a chain of about 1,000
// partials, not of 30,000 positions.
//
// What bounds it: bytes — the per-bag gradients (read once per position,
// mostly from L2), the sorted positions and ids, the partials written and
// read once, and one read and one write of each touched value row and
// slot row.
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
// Offsets are 64-bit. The launchers run on the caller's stream, allocate
// nothing, do not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 32;       // positions per partial (ops/fused_lookup.py _CHUNK)
constexpr int kColsPerLane = 4;  // a pass covers 128 columns

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

// Launch 1: one warp per chunk c of table t. The chunk belongs to the last
// slot u whose first chunk base[u] is <= c; it covers the sorted positions
// start[u] + 32 (c - base[u]) onwards, at most 32 and not past start[u+1].
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
partials_kernel(const float* __restrict__ gs, const int32_t* __restrict__ ids,
                const int64_t* __restrict__ order, const int32_t* __restrict__ start,
                const int32_t* __restrict__ nch, const int32_t* __restrict__ base,
                float* __restrict__ part, int64_t B, int64_t L, int64_t D, int64_t U,
                int64_t M) {
    const int64_t c = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    const int64_t t = blockIdx.y;
    if (c >= M) return;
    const int32_t* bt = base + t * U;
    int64_t lo = 0, hi = U;  // upper bound of c in the non-decreasing bt
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (bt[mid] <= c) lo = mid + 1; else hi = mid;
    }
    const int64_t u = lo - 1;
    const int64_t j = c - bt[u];
    if (j >= nch[t * U + u]) return;  // past the table's last chunk
    const int64_t N = B * L;
    const int64_t s0 = start[t * (U + 1) + u] + (int64_t)kChunk * j;
    const int64_t end = start[t * (U + 1) + u + 1];
    const int n = end - s0 < kChunk ? (int)(end - s0) : kChunk;
    const int lane = threadIdx.x & 31;
    int64_t my_b = 0;
    float my_w = 0.f;
    if (lane < n) {
        const int64_t pos = order[t * N + s0 + lane];
        my_b = pos / L;
        my_w = ids[t * N + pos] >= 0 ? 1.f : 0.f;
    }
    const float* g_t = gs + t * B * D;
    float* out = part + (t * M + c) * D;
    for (int64_t c0 = 0; c0 < D; c0 += 32 * kColsPerLane) {
        float acc[kColsPerLane];
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.f;
        for (int k = 0; k < n; ++k) {
            const int64_t b = __shfl_sync(0xFFFFFFFFu, my_b, k);
            const float w = __shfl_sync(0xFFFFFFFFu, my_w, k);
            const float* grow = g_t + b * D;
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q) {
                const int64_t col = c0 + lane + 32 * q;
                if (col < D) acc[q] = __fadd_rn(acc[q], __fmul_rn(__ldg(grow + col), w));
            }
        }
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
            const int64_t col = c0 + lane + 32 * q;
            if (col < D) out[col] = acc[q];
        }
    }
}

// Launch 2: one warp per unique slot u >= 1: its chunks' partials in
// order, the optimizer, the write-back.
template <bool BF16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
apply_kernel(void* __restrict__ values, float* __restrict__ s0p, float* __restrict__ s1p,
             const float* __restrict__ part, const int32_t* __restrict__ nch,
             const int32_t* __restrict__ base, const int32_t* __restrict__ uids,
             const int32_t* __restrict__ counts, const float* __restrict__ scal, Hyper h,
             int opt, uint32_t seed, int grad_averaging, int64_t C, int64_t D, int64_t U,
             int64_t M) {
    const int64_t u = 1 + int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    const int64_t t = blockIdx.y;
    if (u >= U) return;
    const int32_t uid = uids[t * U + u];
    if (uid < 0) return;
    const int lane = threadIdx.x & 31;
    const int64_t row = uid < C ? uid : C - 1;
    const int64_t off = (t * C + row) * D;  // element offset of the row
    const float* p0 = part + (t * M + base[t * U + u]) * D;
    const int nc = nch[t * U + u];
    const float cnt = fmaxf((float)counts[t * U + u], 1.f);
    // row-keyed rounding bits: mix32(mix32(uid ^ mix32(seed)) ^ mix32(col * golden))
    const uint32_t rowbits = mix32((uint32_t)uid ^ mix32(seed));

    for (int64_t c0 = 0; c0 < D; c0 += 32 * kColsPerLane) {
        float acc[kColsPerLane];
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) acc[q] = 0.f;
#pragma unroll 4
        for (int jj = 0; jj < nc; ++jj) {
#pragma unroll
            for (int q = 0; q < kColsPerLane; ++q) {
                const int64_t col = c0 + lane + 32 * q;
                if (col < D) acc[q] = __fadd_rn(acc[q], p0[jj * D + col]);
            }
        }
#pragma unroll
        for (int q = 0; q < kColsPerLane; ++q) {
            const int64_t col = c0 + lane + 32 * q;
            if (col >= D) continue;
            const float g = grad_averaging ? __fdiv_rn(acc[q], cnt) : acc[q];
            float v;
            if (BF16) {
                v = __uint_as_float(uint32_t(static_cast<const uint16_t*>(values)[off + col]) << 16);
            } else {
                v = static_cast<const float*>(values)[off + col];
            }
            float a = s0p ? s0p[off + col] : 0.f;
            float b = s1p ? s1p[off + col] : 0.f;
            const float nv = update(opt, v, g, a, b, scal, h);
            if (BF16) {
                const uint32_t bits = mix32(rowbits ^ mix32((uint32_t)col * 0x9E3779B9u));
                static_cast<uint16_t*>(values)[off + col] =
                    (uint16_t)((__float_as_uint(nv) + (bits & 0xFFFFu)) >> 16);
            } else {
                static_cast<float*>(values)[off + col] = nv;
            }
            if (s0p) s0p[off + col] = a;
            if (s1p) s1p[off + col] = b;
        }
    }
}

inline unsigned int warp_blocks(int64_t n) {
    return (unsigned int)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

// Launch 1. gs [T, B, D] f32 combiner-scaled gradients; ids [T, B*L]
// int32; order [T, B*L] int64 (positions sorted stably by slot); start
// [T, U+1], nch and base [T, U] int32; part [T, M, D] f32 (out).
extern "C" int fused_sparse_backward_partials(const void* gs, const void* ids,
                                              const void* order, const void* start,
                                              const void* nch, const void* base, void* part,
                                              long long T, long long B, long long L,
                                              long long D, long long U, long long M,
                                              void* stream) {
    if (T <= 0 || M <= 0 || B <= 0 || L <= 0) return 0;
    if (D <= 0 || U < 1 || T > 65535 || M > (int64_t)0x7FFFFFFF * kWarpsPerBlock)
        return (int)cudaErrorInvalidValue;
    partials_kernel<<<dim3(warp_blocks(M), (unsigned int)T), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(gs), static_cast<const int32_t*>(ids),
        static_cast<const int64_t*>(order), static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(nch), static_cast<const int32_t*>(base),
        static_cast<float*>(part), B, L, D, U, M);
    return (int)cudaGetLastError();
}

// Launch 2. values [T, C, D] (f32, or bf16 when bf16 != 0) and the slots
// s0, s1 [T, C, D] f32 (null where the optimizer has fewer) updated in
// place; part [T, M, D] from launch 1; nch, base, uids and counts [T, U]
// int32; scal [3] f32 on the device (lr, Adam's bias-corrected lr, AdamW's
// lr * weight_decay); opt 0..4 = sgd, adagrad, adam, adamw, ftrl with
// their f32 constants; seed the low 32 bits.
extern "C" int fused_sparse_backward_apply(
    void* values, void* s0, void* s1, const void* part, const void* nch, const void* base,
    const void* uids, const void* counts, const void* scal, long long T, long long C,
    long long D, long long U, long long M, int opt, float b1, float omb1, float b2,
    float omb2, float eps, float p, float l2x2, float l1, unsigned int seed,
    int grad_averaging, int bf16, void* stream) {
    if (T <= 0 || U <= 1) return 0;
    if (C <= 0 || D <= 0 || T > 65535 || opt < kSgd || opt > kFtrl ||
        (U - 1) > (int64_t)0x7FFFFFFF * kWarpsPerBlock)
        return (int)cudaErrorInvalidValue;
    const int nslots = opt == kSgd ? 0 : (opt == kAdagrad ? 1 : 2);
    if ((nslots >= 1 && s0 == nullptr) || (nslots == 2 && s1 == nullptr))
        return (int)cudaErrorInvalidValue;
    const Hyper h{b1, omb1, b2, omb2, eps, p, l2x2, l1};
    const dim3 grid(warp_blocks(U - 1), (unsigned int)T);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* a = nslots >= 1 ? static_cast<float*>(s0) : nullptr;
    float* b = nslots == 2 ? static_cast<float*>(s1) : nullptr;
    const float* pt = static_cast<const float*>(part);
    const int32_t* nc = static_cast<const int32_t*>(nch);
    const int32_t* bs = static_cast<const int32_t*>(base);
    const int32_t* ui = static_cast<const int32_t*>(uids);
    const int32_t* ct = static_cast<const int32_t*>(counts);
    const float* sc = static_cast<const float*>(scal);
    if (bf16) {
        apply_kernel<true><<<grid, kWarpsPerBlock * 32, 0, s>>>(
            values, a, b, pt, nc, bs, ui, ct, sc, h, opt, seed, grad_averaging, C, D, U, M);
    } else {
        apply_kernel<false><<<grid, kWarpsPerBlock * 32, 0, s>>>(
            values, a, b, pt, nc, bs, ui, ct, sc, h, opt, seed, grad_averaging, C, D, U, M);
    }
    return (int)cudaGetLastError();
}
