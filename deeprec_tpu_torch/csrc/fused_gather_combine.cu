// fused_gather_combine for Hopper (sm_90a): pooled bags straight out of a
// table, with the combiner carried in per-position weights:
//
//   out[b] = sum over l (in l order) of w[b, l] * values[clip(row_ix[b, l], 0, C-1)]
//
// over the positions with row_ix[b, l] >= 0; a position < 0 adds nothing.
// values [C, D] f32 or bf16 (bf16 rows are upcast on load), row_ix [B, L]
// int32, w [B, L] f32, out [B, D] f32.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/fused_lookup.py::
// fused_gather_combine. The TPU kernel walks block_b bags of one grid step
// position by position, double-buffering one row DMA from HBM to VMEM
// while it adds the previous row, because a TPU core moves one row per DMA
// and runs its grid in order. On Hopper every bag is independent: a group
// of S lanes of one warp owns one bag (S the power of two that covers the
// row's vectors, up to 32, so a 16-wide f32 row keeps 4 lanes busy and a
// warp pools 8 bags), its lanes cover the columns, and the bag's row_ix
// and w come in S at a time, one per lane, and are broadcast to the group
// by width-S shuffles. No [B, L, D] intermediate exists anywhere.
//
// What bounds it: bytes, and at small bags the latency of the dependent
// row loads. Each non-pad position reads one row (distinct rows come from
// device memory once, repeats from L2), every position reads 8 bytes of
// row_ix and w, and out is written once. Rows move as 16-byte vectors per
// lane (8-byte for bf16) when D % 4 == 0 and the base is aligned, else one
// element per lane. A pad is skipped without reading a row, where the
// Pallas kernel adds 0 * values[0]: the same bits for finite rows (the sum
// starts at +0 and never becomes -0, and x + (+-0) == x), and most of the
// reads of a padded multi-hot bag saved.
//
// Sums: nvcc is told not to contract (-fmad=false) and the arithmetic is
// __fmul_rn then __fadd_rn, so every column's sum is exactly the plain
// version's (out = 0; out = out + w * row for l = 0..L-1, pads skipped).
//
// Offsets are 64-bit. The launcher runs on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __uint_as_float(uint32_t(__ldg(reinterpret_cast<const uint16_t*>(p))) << 16);
}

__device__ __forceinline__ float madd(float acc, float w, float x) {
    return __fadd_rn(acc, __fmul_rn(w, x));
}

// S lanes per bag, 32 / S bags per warp. Every lane of a warp runs the same
// loops (a lane past B or past the row's width only skips its loads and
// stores), so the full-mask shuffles are always executed by the whole warp.
template <typename T, bool VEC, int S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_combine_kernel(const T* __restrict__ values, const int32_t* __restrict__ row_ix,
                      const float* __restrict__ w, float* __restrict__ out, int64_t B,
                      int64_t L, int64_t C, int64_t D) {
    constexpr int G = 32 / S;
    const int lane = threadIdx.x & 31;
    const int sl = lane % S;
    const int64_t warp = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (warp * G >= B) return;  // the whole warp lies past the last bag
    const int64_t bag = warp * G + lane / S;
    const bool live = bag < B;
    const int64_t pos0 = (live ? bag : 0) * L;
    float* o = out + (live ? bag : 0) * D;
    const int64_t width = VEC ? D / 4 : D;
    for (int64_t c0 = 0; c0 < width; c0 += S) {
        const int64_t c = c0 + sl;
        const bool col = live && c < width;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int64_t l0 = 0; l0 < L; l0 += S) {
            int32_t my_ix = -1;
            float my_w = 0.f;
            if (live && l0 + sl < L) {
                my_ix = row_ix[pos0 + l0 + sl];
                my_w = w[pos0 + l0 + sl];
            }
            const int n = L - l0 < S ? (int)(L - l0) : S;
            for (int k = 0; k < n; ++k) {
                const int32_t ix = __shfl_sync(0xFFFFFFFFu, my_ix, k, S);
                const float wk = __shfl_sync(0xFFFFFFFFu, my_w, k, S);
                if (ix < 0 || !col) continue;
                const int64_t r = ix >= C ? C - 1 : (int64_t)ix;
                if (VEC) {
                    const float4 x = load4(values + r * D + 4 * c);
                    acc.x = madd(acc.x, wk, x.x);
                    acc.y = madd(acc.y, wk, x.y);
                    acc.z = madd(acc.z, wk, x.z);
                    acc.w = madd(acc.w, wk, x.w);
                } else {
                    acc.x = madd(acc.x, wk, load1(values + r * D + c));
                }
            }
        }
        if (col) {
            if (VEC) {
                reinterpret_cast<float4*>(o)[c] = acc;
            } else {
                o[c] = acc.x;
            }
        }
    }
}

template <typename T, bool VEC, int S>
cudaError_t launch_s(const void* values, const int32_t* row_ix, const float* w, float* out,
                     int64_t B, int64_t L, int64_t C, int64_t D, cudaStream_t stream) {
    constexpr int G = 32 / S;
    const int64_t warps = (B + G - 1) / G;
    const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
    gather_combine_kernel<T, VEC, S><<<(unsigned int)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const T*>(values), row_ix, w, out, B, L, C, D);
    return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_v(const void* values, const int32_t* row_ix, const float* w, float* out,
                     int64_t B, int64_t L, int64_t C, int64_t D, cudaStream_t stream) {
    const int64_t width = VEC ? D / 4 : D;
    if (width <= 1) return launch_s<T, VEC, 1>(values, row_ix, w, out, B, L, C, D, stream);
    if (width <= 2) return launch_s<T, VEC, 2>(values, row_ix, w, out, B, L, C, D, stream);
    if (width <= 4) return launch_s<T, VEC, 4>(values, row_ix, w, out, B, L, C, D, stream);
    if (width <= 8) return launch_s<T, VEC, 8>(values, row_ix, w, out, B, L, C, D, stream);
    if (width <= 16) return launch_s<T, VEC, 16>(values, row_ix, w, out, B, L, C, D, stream);
    return launch_s<T, VEC, 32>(values, row_ix, w, out, B, L, C, D, stream);
}

template <typename T>
cudaError_t launch_t(const void* values, const int32_t* row_ix, const float* w, float* out,
                     int64_t B, int64_t L, int64_t C, int64_t D, cudaStream_t stream) {
    const uint64_t vbytes = sizeof(T) * 4;  // one vector of 4 elements
    const bool vec = D % 4 == 0 && (uint64_t)(uintptr_t)values % vbytes == 0 &&
                     (uint64_t)(uintptr_t)out % 16 == 0;
    return vec ? launch_v<T, true>(values, row_ix, w, out, B, L, C, D, stream)
               : launch_v<T, false>(values, row_ix, w, out, B, L, C, D, stream);
}

}  // namespace

// values [C, D] (f32, or bf16 when bf16 != 0), row_ix [B, L] int32,
// w [B, L] f32, out [B, D] f32; all contiguous.
extern "C" int fused_gather_combine_launch(const void* values, const void* row_ix,
                                           const void* w, void* out, long long B,
                                           long long L, long long C, long long D, int bf16,
                                           void* stream) {
    if (B <= 0 || D <= 0) return 0;
    if (L < 0 || C <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* ix = static_cast<const int32_t*>(row_ix);
    const float* wp = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    const cudaError_t err =
        bf16 ? launch_t<__nv_bfloat16>(values, ix, wp, o, B, L, C, D, s)
             : launch_t<float>(values, ix, wp, o, B, L, C, D, s);
    return (int)err;
}
