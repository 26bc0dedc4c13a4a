// fused_gather_combine for Hopper (sm_90a): pooled bags straight out of a
// table, with the combiner carried in per-position weights, for a group of
// F features in one launch:
//
//   out_f[b] = sum over l (in l order) of w_f[b, l] * values_f[clip(row_ix_f[b, l], 0, C_f-1)]
//
// over the positions with row_ix_f[b, l] >= 0; a position < 0 adds nothing.
// Per feature f: values_f [C_f, D] f32 or bf16 (bf16 rows are upcast on
// load), row_ix_f [B, L_f] int32, w_f [B, L_f] f32, out_f [B, D] f32. The
// features of a group share the row dtype, D and B.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/fused_lookup.py:441
// fused_gather_combine. The TPU kernel walks block_b bags of one grid step
// position by position, double-buffering one row DMA from HBM to VMEM
// while it adds the previous row, because a TPU core moves one row per DMA
// and runs its grid in order. On Hopper every bag is independent.
//
// What bounds it: bytes. Each real position reads one row, every position
// reads 8 bytes of row_ix and w, and out is written once. Below about 4
// real positions per bag it is bound instead by latency: a bag is two
// dependent memory round trips (its indices, then its rows), and a launch
// of one small feature costs more than its bytes. What the design does:
//
// - One launch per group. blockIdx.y picks the feature, blockIdx.x the
//   tile of bags. The per-feature pointers and sizes travel by value in
//   the kernel's parameter struct (kMaxFeatures of them, about 3 KB of the
//   4 KB parameter space; no descriptor array on the device, so no copy
//   per request). A larger group takes several launches. A request of 26
//   one-hot features pays one launch and one pair of round trips, where it
//   paid 26.
// - The bag's indices up front. A group of S lanes (S the power of two
//   that covers the row's vectors, up to 32: a 16-wide f32 row keeps 4
//   lanes busy and a warp holds 8 groups) owns one bag, or nb = 32 / L
//   consecutive bags when a bag is shorter than 32 positions (at most 8,
//   and fewer where the launch would leave an SM without a block): their
//   positions are one contiguous span of row_ix and w. Lane sl loads
//   span positions sl, sl + S, ... of a chunk of kJ * S, all of its row_ix
//   and w loads issued before any row load. A ballot per kJ and a popcount
//   compact the real positions, in span order (bag by bag, l order within
//   a bag), into the group's list in shared memory. After that a pad costs
//   nothing: no shuffle, no branch.
// - Several row loads in flight. Each lane issues kK row loads of the list
//   back to back into registers (16-byte vectors for f32, 8-byte for bf16,
//   when D % 4 == 0 and every base is aligned, else one element per lane),
//   then applies the kK multiply-adds in order, storing a bag's sum when
//   the list moves on to the next bag. A bag of n real positions waits for
//   ceil(n / kK) round trips instead of n, and 8 one-hot bags share one.
//
// A pad is skipped without reading a row, where the Pallas kernel adds
// 0 * values[0]: the same bits for finite rows (the sum starts at +0 and
// never becomes -0, and x + (+-0) == x).
//
// Sums: nvcc is told not to contract (-fmad=false) and the arithmetic is
// __fmul_rn then __fadd_rn in l order, so every column's sum is exactly
// the plain version's (out = 0; out = out + w * row for l = 0..L-1, pads
// skipped). Rows >= C are clipped to C - 1.
//
// Row and output offsets are 64-bit; L and D must be below 2^30 (positions
// within a span are 32-bit). The launcher runs on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxFeatures = 64;  // features per launch (GROUP_CAPACITY in Python)
constexpr int kJ = 8;             // index loads per lane per chunk
constexpr int kK = 8;             // row loads in flight per lane
constexpr int64_t kMaxLD = 1 << 30;  // L and D: span positions stay 32-bit

struct Feature {
    const void* values;
    const int32_t* row_ix;
    const float* w;
    float* out;
    int64_t L;
    int64_t C;
};

struct Group {
    Feature f[kMaxFeatures];
};

// One lane's share of a row as loaded (raw) and as f32 (widen): 4
// elements when vectorised, else 1 (in .x).
template <typename T, bool VEC>
struct Row;

template <>
struct Row<float, true> {
    using raw = float4;
    static __device__ __forceinline__ raw load(const float* p) {
        return __ldg(reinterpret_cast<const float4*>(p));
    }
    static __device__ __forceinline__ float4 widen(raw v) { return v; }
};

template <>
struct Row<__nv_bfloat16, true> {
    using raw = uint2;
    static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const uint2*>(p));
    }
    static __device__ __forceinline__ float4 widen(raw v) {
        return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                           __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
    }
};

template <>
struct Row<float, false> {
    using raw = float;
    static __device__ __forceinline__ raw load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ float4 widen(raw v) { return make_float4(v, 0.f, 0.f, 0.f); }
};

template <>
struct Row<__nv_bfloat16, false> {
    using raw = unsigned short;
    static __device__ __forceinline__ raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    static __device__ __forceinline__ float4 widen(raw v) {
        return make_float4(__uint_as_float(uint32_t(v) << 16), 0.f, 0.f, 0.f);
    }
};

__device__ __forceinline__ float madd(float acc, float w, float x) {
    return __fadd_rn(acc, __fmul_rn(w, x));
}

// Bags per lane group: consecutive short bags share one pass, so their
// indices come in one chunk and their rows in one batch of kK loads; at
// most `cap`, which the launcher lowers until the launch fills the SMs.
__host__ __device__ __forceinline__ int64_t bags_per_group(int64_t L, int64_t cap) {
    const int64_t nb = L >= 32 ? 1 : (L <= 4 ? 8 : 32 / L);
    return nb < cap ? nb : cap;
}

// S lanes per group, 32 / S groups per warp; group g pools nb consecutive
// bags (bags_per_group), whose positions are one contiguous span of row_ix
// and w, in chunks of kJ * S. MULTI: some feature of the launch has nb > 1
// (without it nb is 1, the list carries no bag and the row loop stores
// nothing, so a launch of long bags keeps the registers of a one-bag loop).
// Every lane of a warp runs the same chunk loop (a feature's L, and so nb
// and the span, is uniform across the block; a lane past B only loads
// nothing), so the full-mask ballots are executed by the whole warp; the
// row loop runs each group's own count.
// The minimum of resident blocks is the register budget ptxas is given
// (65,536 / (256 * blocks)): 80 registers (3 blocks an SM) hold the kK rows
// of one bag a group, and bf16's several bags (left to itself, ptxas gives
// bf16 64 and spills); f32's several bags take 128 (2 blocks). Positions
// within a span, D and the clipped row are 32-bit (the launcher checks L
// and D), so the row loop keeps few 64-bit values; row offsets are 64-bit.
template <typename T, bool VEC, int S, bool MULTI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, (sizeof(T) == 2 || !MULTI) ? 3 : 2)
gather_combine_kernel(const __grid_constant__ Group group, int64_t B, int32_t D,
                      int64_t cap) {
    using R = Row<T, VEC>;
    constexpr int G = 32 / S;
    constexpr int CH = kJ * S;      // span positions of one group per chunk
    constexpr int STRIDE = CH + 1;  // group g's entry k sits in bank (g + k) % 32
    __shared__ int32_t s_ix[kWarpsPerBlock][G * STRIDE];
    __shared__ float s_w[kWarpsPerBlock][G * STRIDE];
    __shared__ int32_t s_bag[kWarpsPerBlock][MULTI ? G * STRIDE : 1];

    const int lane = threadIdx.x & 31;
    const int wib = threadIdx.x >> 5;
    const int sl = lane % S;
    const int g = lane / S;
    const Feature& f = group.f[blockIdx.y];
    const int32_t L = (int32_t)f.L;
    const int32_t cmax = f.C - 1 < 0x7FFFFFFF ? (int32_t)(f.C - 1) : 0x7FFFFFFF;
    const int32_t nb = MULTI ? (int32_t)bags_per_group(L, cap) : 1;
    const int64_t warp = int64_t(blockIdx.x) * kWarpsPerBlock + wib;
    if (warp * G * nb >= B) return;  // the whole warp lies past the last bag
    const int64_t bag0 = (warp * G + g) * nb;
    const int32_t bags = bag0 < B ? (int32_t)(B - bag0 < nb ? B - bag0 : nb) : 0;
    const int32_t span = bags * L;
    const int32_t* ix_p = f.row_ix + (bags ? bag0 * L : 0);
    const float* w_p = f.w + (bags ? bag0 * L : 0);
    const T* values = static_cast<const T*>(f.values);
    float* o = f.out + (bags ? bag0 : 0) * D;
    int32_t* list_ix = s_ix[wib] + g * STRIDE;
    float* list_w = s_w[wib] + g * STRIDE;
    int32_t* list_bag = s_bag[wib] + g * STRIDE;
    const unsigned below = (1u << lane) - 1u;  // lanes under this one
    const unsigned group_lanes = S == 32 ? 0xFFFFFFFFu : ((1u << (S % 32)) - 1u) << (g * S);
    const int32_t width = VEC ? D / 4 : D;
    const int32_t span_max = nb * L;  // the longest span of any group
    for (int32_t c0 = 0; c0 < width; c0 += S) {
        const int32_t c = c0 + sl;
        const bool col = c < width;
        const T* base = values + (VEC ? 4 * c : c);
        auto store = [&](int b, float4 v) {
            if (VEC) {
                reinterpret_cast<float4*>(o + int64_t(b) * D)[c] = v;
            } else {
                o[int64_t(b) * D + c] = v.x;
            }
        };
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 acc = zero;
        int cur = 0;          // the bag acc belongs to; bags below it are stored
        unsigned filled = 0;  // bit b: bag b has a real position (this lane's)
        for (int32_t l0 = 0; l0 < span_max; l0 += CH) {
            // the chunk's indices and weights: every load issued before any use
            int32_t ix[kJ];
            float wv[kJ];
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
                const int32_t q = l0 + j * S + sl;
                const bool ok = q < span;
                ix[j] = ok ? __ldg(ix_p + q) : -1;
                wv[j] = ok ? __ldg(w_p + q) : 0.f;
            }
            // the real positions, compacted in span order (bag by bag, l
            // order within a bag) into the group's list
            int n = 0;
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
                const unsigned real = __ballot_sync(0xFFFFFFFFu, ix[j] >= 0) & group_lanes;
                if (ix[j] >= 0) {
                    const int k = n + __popc(real & below);
                    list_ix[k] = ix[j];
                    list_w[k] = wv[j];
                    if (MULTI) {
                        const int32_t b = nb == 1 ? 0 : (l0 + j * S + sl) / L;
                        list_bag[k] = b;
                        filled |= 1u << b;
                    }
                }
                n += __popc(real);
            }
            __syncwarp();
            if (col) {
                for (int k0 = 0; k0 < n; k0 += kK) {
                    typename R::raw x[kK];
#pragma unroll
                    for (int j = 0; j < kK; ++j) {
                        if (k0 + j < n) {
                            const int32_t r = list_ix[k0 + j];
                            x[j] = R::load(base + int64_t(r < cmax ? r : cmax) * D);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < kK; ++j) {
                        if (k0 + j < n) {
                            if (MULTI) {
                                const int bk = list_bag[k0 + j];
                                if (bk != cur) {  // cur is complete
                                    store(cur, acc);
                                    acc = zero;
                                    cur = bk;
                                }
                            }
                            const float wk = list_w[k0 + j];
                            const float4 v = R::widen(x[j]);
                            acc.x = madd(acc.x, wk, v.x);
                            if (VEC) {
                                acc.y = madd(acc.y, wk, v.y);
                                acc.z = madd(acc.z, wk, v.z);
                                acc.w = madd(acc.w, wk, v.w);
                            }
                        }
                    }
                }
            }
            __syncwarp();  // the next chunk rewrites the list
        }
        if (MULTI) {
#pragma unroll
            for (int off = 1; off < S; off <<= 1) {
                filled |= __shfl_xor_sync(0xFFFFFFFFu, filled, off);
            }
        }
        if (col && bags) {  // the last bag with a row, then the bags with none
            store(cur, acc);
            for (int b = 1; MULTI && b < bags; ++b) {
                if (!(filled >> b & 1)) store(b, zero);
            }
        }
    }
}

template <typename T, bool VEC, int S>
cudaError_t launch_s(const Group& group, int nf, int64_t B, int64_t D, cudaStream_t stream) {
    constexpr int G = 32 / S;
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
        return cudaGetLastError();
    }
    // the most bags per group (8, 4, 2, 1) that still gives every SM a
    // block of work; the grid covers the feature that needs the most blocks
    int64_t cap = 8, blocks = 0;
    bool multi = false;
    for (;; cap /= 2) {
        int64_t work = 0;
        blocks = 0;
        multi = false;
        for (int i = 0; i < nf; ++i) {
            const int64_t nb = bags_per_group(group.f[i].L, cap);
            multi = multi || nb > 1;
            const int64_t warps = ((B + nb - 1) / nb + G - 1) / G;
            const int64_t need = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
            work += need;
            blocks = need > blocks ? need : blocks;
        }
        if (work >= sms || cap == 1) break;
    }
    if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
    const dim3 grid((unsigned int)blocks, (unsigned int)nf);
    if (multi) {
        gather_combine_kernel<T, VEC, S, true>
            <<<grid, kWarpsPerBlock * 32, 0, stream>>>(group, B, (int32_t)D, cap);
    } else {
        gather_combine_kernel<T, VEC, S, false>
            <<<grid, kWarpsPerBlock * 32, 0, stream>>>(group, B, (int32_t)D, cap);
    }
    return cudaGetLastError();
}


template <typename T, bool VEC>
cudaError_t launch_v(const Group& group, int nf, int64_t B, int64_t D, cudaStream_t stream) {
    const int64_t width = VEC ? D / 4 : D;
    if (width <= 1) return launch_s<T, VEC, 1>(group, nf, B, D, stream);
    if (width <= 2) return launch_s<T, VEC, 2>(group, nf, B, D, stream);
    if (width <= 4) return launch_s<T, VEC, 4>(group, nf, B, D, stream);
    if (width <= 8) return launch_s<T, VEC, 8>(group, nf, B, D, stream);
    if (width <= 16) return launch_s<T, VEC, 16>(group, nf, B, D, stream);
    return launch_s<T, VEC, 32>(group, nf, B, D, stream);
}

template <typename T>
cudaError_t launch_t(const Group& group, int nf, int64_t B, int64_t D, bool vec,
                     cudaStream_t stream) {
    return vec ? launch_v<T, true>(group, nf, B, D, stream)
               : launch_v<T, false>(group, nf, B, D, stream);
}

}  // namespace

// A group of F features: values[f] [C[f], D] (f32, or bf16 when bf16 != 0),
// row_ix[f] [B, L[f]] int32, w[f] [B, L[f]] f32, out[f] [B, D] f32; all
// contiguous. ceil(F / kMaxFeatures) launches, on `stream`.
extern "C" int fused_gather_combine_grouped_launch(
    const void* const* values, const void* const* row_ix, const void* const* w,
    void* const* out, const long long* L, const long long* C, int F, long long B,
    long long D, int bf16, void* stream) {
    if (F < 0) return (int)cudaErrorInvalidValue;
    if (F == 0 || B <= 0 || D <= 0) return 0;
    if (D > kMaxLD) return (int)cudaErrorInvalidValue;
    const uint64_t vbytes = (bf16 ? 2 : 4) * 4;  // one vector of 4 elements
    bool vec = D % 4 == 0;
    for (int i = 0; i < F; ++i) {
        if (L[i] < 0 || L[i] > kMaxLD || C[i] <= 0) return (int)cudaErrorInvalidValue;
        vec = vec && (uint64_t)(uintptr_t)values[i] % vbytes == 0 &&
              (uint64_t)(uintptr_t)out[i] % 16 == 0;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int f0 = 0; f0 < F; f0 += kMaxFeatures) {
        const int nf = F - f0 < kMaxFeatures ? F - f0 : kMaxFeatures;
        Group group;
        for (int i = 0; i < nf; ++i) {
            group.f[i] = Feature{values[f0 + i], static_cast<const int32_t*>(row_ix[f0 + i]),
                                 static_cast<const float*>(w[f0 + i]),
                                 static_cast<float*>(out[f0 + i]), L[f0 + i], C[f0 + i]};
        }
        const cudaError_t err =
            bf16 ? launch_t<__nv_bfloat16>(group, nf, B, D, vec, s)
                 : launch_t<float>(group, nf, B, D, vec, s);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
