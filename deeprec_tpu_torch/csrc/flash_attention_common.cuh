// Pieces shared by the flash attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the key compaction, the tile loads and stores,
// the one-instruction exp2 and the sums across a row's lanes.
//
// Arithmetic: the port builds every kernel with -fmad=false so that the
// bit-exact kernels round after each operation as their plain versions do.
// The flash kernels are held to a tolerance instead, so they ask for their
// fused multiply-adds by name (__fmaf_rn) and take exp2 from the MUFU.EX2
// unit (relative error about 2^-22), with log2(e) folded into the scale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' finite mask score
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kAll = 0xffffffffu;

// 2^x in one MUFU.EX2; ex2(-inf) = 0 and subnormal results flush to 0.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// The t-th group of 4 elements of src as f32: a 16-byte f32 vector, or 8
// bytes of bf16 widened.
__device__ __forceinline__ float4 load4(const float* src, int t) {
    return reinterpret_cast<const float4*>(src)[t];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* src, int t) {
    const uint2 x = reinterpret_cast<const uint2*>(src)[t];
    return make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xFFFF0000u),
                       __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xFFFF0000u));
}

__device__ __forceinline__ void store4(float* dst, int t, float4 x) {
    reinterpret_cast<float4*>(dst)[t] = x;
}

// bf16 rounded to nearest even, as JAX's `.astype` rounds.
__device__ __forceinline__ void store4(__nv_bfloat16* dst, int t, float4 x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    reinterpret_cast<uint2*>(dst)[t] = u;
}

// A row of D elements is split over G lanes by 16-byte groups, interleaved:
// lane gl holds the groups gl, gl + G, gl + 2G, ... (DL = D / G elements),
// so the G lanes read neighbouring 16 bytes of shared memory (no bank
// conflict) and of device memory.
template <int DL, int G, typename T>
__device__ __forceinline__ void load_part(float (&dst)[DL], const T* row, int gl) {
#pragma unroll
    for (int t = 0; t < DL / 4; ++t) {
        const float4 x = load4(row, t * G + gl);
        dst[4 * t] = x.x;
        dst[4 * t + 1] = x.y;
        dst[4 * t + 2] = x.z;
        dst[4 * t + 3] = x.w;
    }
}

template <int DL, int G, typename T>
__device__ __forceinline__ void store_part(T* row, int gl, const float (&src)[DL]) {
#pragma unroll
    for (int t = 0; t < DL / 4; ++t)
        store4(row, t * G + gl,
               make_float4(src[4 * t], src[4 * t + 1], src[4 * t + 2], src[4 * t + 3]));
}

// The sum of x over the G lanes of a row (butterfly: every lane gets the
// same bits). Needs the whole warp converged.
template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
    for (int o = 1; o < G; o <<= 1) x += __shfl_xor_sync(kAll, x, o);
    return x;
}

template <int DL>
__device__ __forceinline__ float dot(const float (&a)[DL], const float (&b)[DL]) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < DL; ++d) s = __fmaf_rn(a[d], b[d], s);
    return s;
}

// Key compaction. Warp 0 lists, ascending, the real keys of the mask row
// mb[0, end) whose rank among them is in [skip, skip + CAP), a ballot per
// 32 positions, and stores how many it listed in *count. Ends with
// __syncthreads.
template <int CAP>
__device__ __forceinline__ void compact(const uint8_t* mb, int end, int skip, int* idx,
                                        int* count) {
    if (threadIdx.x < 32) {
        const unsigned lane = threadIdx.x;
        int seen = 0;  // real keys before pos
        for (int pos = 0; pos < end && seen < skip + CAP; pos += 32) {
            const int j = pos + (int)lane;
            const bool real = j < end && mb[j];
            const unsigned ballot = __ballot_sync(kAll, real);
            const int rank = seen + __popc(ballot & ((1u << lane) - 1u)) - skip;
            if (real && rank >= 0 && rank < CAP) idx[rank] = j;
            seen += __popc(ballot);
        }
        if (lane == 0) *count = min(max(seen - skip, 0), CAP);
    }
    __syncthreads();
}

// The number of listed keys at or before position i (the keys a causal
// row i sees), by binary search of the ascending list.
__device__ __forceinline__ int count_upto(const int* idx, int n, int i) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (idx[mid] <= i) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Rows idx[0..n) of k and v (D elements each) into f32 shared memory as
// rows 0..n, zero rows from n to npad; K and V in one loop.
template <int D, int NT, typename T>
__device__ __forceinline__ void gather_kv(float* ks, float* vs, const T* k, const T* v,
                                          const int* idx, int n, int npad) {
    constexpr int V = D / 4;
    for (int t = threadIdx.x; t < npad * V; t += NT) {
        const int c = t / V, part = t % V;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (c < n) {
            const int row = idx[c] * D;
            kx = load4(k + row, part);
            vx = load4(v + row, part);
        }
        store4(ks, t, kx);
        store4(vs, t, vx);
    }
}

}  // namespace flash
