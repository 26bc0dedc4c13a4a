// Flash attention backward for Hopper (sm_90a): exact gradients from the
// saved log-sum-exp, in two kernels as the TPU version has two calls.
//
// Replaces the Pallas TPU kernels deeprec_tpu/ops/flash_attention.py
// ::_pallas_backward: _fa_bwd_dkdv_kernel (one K block owns the instance,
// Q blocks stream through the sequential grid axis, dk/dv accumulate in
// VMEM scratch) and _fa_bwd_dq_kernel (the forward's access pattern with ds
// in place of p). On Hopper the sequential grid axis becomes a loop inside
// the block:
//  - dkdv_kernel: one block owns (b*h, a tile of 128 keys), one thread one
//    key row (k, v, dk, dv in registers); tiles of q, do, lse and delta are
//    staged in shared memory and every row of a tile meets every key of the
//    block;
//  - dq_kernel: one block owns (b*h, a tile of 128 query rows), one thread
//    one query row (q, do, dq in registers); tiles of k, v and the key mask
//    are staged in shared memory.
// Each output element is written once by one thread: no atomics, so the
// result is deterministic.
//
// What bounds it: operations. The five products (s, dp recomputed in both
// kernels; dv, dk, dq) are 10*B*H*Lq*S*D = 42.9 GFLOP at the BST shape
// (B*H = 8192, Lq = S = 256, D = 8), 0.64 ms at the 67 TFLOP/s f32 rate of
// the CUDA cores, against 0.15 ms to move q, k, v, do, lse, delta and the
// three gradients (487 MB at 3.35 TB/s). Scores never leave registers.
//
// Semantics kept from the Pallas kernels (and the port's plain version,
// ops/flash_attention.py flash_backward_plain):
//  - p = exp(s - lse) with the dead-row guard of _probs_from_lse: a row
//    whose lse <= -5e29 (all its visible keys masked) has p = 0 everywhere;
//  - ds = p * (dp - delta) * scale, dv += p do, dk += ds q, dq += ds k;
//  - the causal skip at the caller's block sizes, as in the forward.
// A masked key (or a causally hidden one) of a live row has s = -1e30, so
// p = exp(-1e30 - lse) is exactly 0 and its terms are exactly zero: both
// kernels skip such pairs without computing them, which changes no bit.
//
// Types: q, k, v, do and the gradients are all f32 or all bf16. Every
// element is upcast to f32 on load, the computation is f32, and dq, dk and
// dv are stored in the inputs' type (bf16 rounded to nearest even, as JAX's
// `.astype`); lse and delta are f32 (delta from the stored, rounded o).
//
// Layout: q, do [BH, Lq, D]; k, v [BH, S, D]; lse, delta [BH, Lq] f32;
// mask [B, S] bytes indexed by b = bh / H; dq [BH, Lq, D], dk, dv [BH, S, D],
// all contiguous. D is one of 8, 16, 32, 64, 128.
//
// The launchers run on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 128;  // rows (keys or queries) per block, one per thread

__device__ __forceinline__ int64_t keys_run(int64_t i, int64_t S, int64_t block_q,
                                            int64_t block_k, int causal) {
    if (!causal) return S;
    const int64_t last = (i / block_q + 1) * block_q - 1;
    const int64_t n = (last / block_k + 1) * block_k;
    return n < S ? n : S;
}

__device__ __forceinline__ bool dead(float lse) { return lse <= kNegInf * 0.5f; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// n rows of D elements from device memory into f32 shared memory, 4
// elements per step (a 16-byte f32 vector, or 8 bytes of bf16 widened).
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int n,
                                          int tid, int nthreads) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int t = tid; t < n * D / 4; t += nthreads) d4[t] = s4[t];
}

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src, int n,
                                          int tid, int nthreads) {
    const uint2* s2 = reinterpret_cast<const uint2*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int t = tid; t < n * D / 4; t += nthreads) {
        const uint2 x = s2[t];
        d4[t] = make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xFFFF0000u),
                            __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xFFFF0000u));
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const uint8_t* __restrict__ mask,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk,
            T* __restrict__ dv, int64_t H, int64_t Lq, int64_t S,
            int64_t block_q, int64_t block_k, int causal, float scale) {
    constexpr int TQ = (4096 / D) < 128 ? (4096 / D) : 128;  // query rows per tile
    __shared__ __align__(16) float qs[TQ * D];
    __shared__ __align__(16) float dos[TQ * D];
    __shared__ float lses[TQ];
    __shared__ float dels[TQ];
    __shared__ int64_t runs[TQ];

    const int64_t ntiles = (S + kRows - 1) / kRows;
    const int64_t bh = blockIdx.x / ntiles;
    const int64_t j0 = (blockIdx.x % ntiles) * kRows;
    const int64_t j = j0 + threadIdx.x;
    const bool live = j < S;
    const bool real = live && mask[(bh / H) * S + j];

    float kr[D], vr[D], dkr[D], dvr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        kr[d] = real ? to_f32(k[(bh * S + j) * D + d]) : 0.f;
        vr[d] = real ? to_f32(v[(bh * S + j) * D + d]) : 0.f;
        dkr[d] = 0.f;
        dvr[d] = 0.f;
    }

    for (int64_t i0 = 0; i0 < Lq; i0 += TQ) {
        const int n = (int)(Lq - i0 < TQ ? Lq - i0 : TQ);
        // rows run keys [0, keys_run(i)), non-decreasing in i: a tile whose
        // last row runs none of this block's keys is skipped whole
        if (keys_run(i0 + n - 1, S, block_q, block_k, causal) <= j0) continue;
        __syncthreads();
        load_tile<D>(qs, q + (bh * Lq + i0) * D, n, threadIdx.x, kRows);
        load_tile<D>(dos, dout + (bh * Lq + i0) * D, n, threadIdx.x, kRows);
        for (int t = threadIdx.x; t < n; t += kRows) {
            lses[t] = lse[bh * Lq + i0 + t];
            dels[t] = delta[bh * Lq + i0 + t];
            runs[t] = keys_run(i0 + t, S, block_q, block_k, causal);
        }
        __syncthreads();
        if (!real) continue;
        for (int ii = 0; ii < n; ++ii) {
            const float l_i = lses[ii];
            if (j >= runs[ii] || dead(l_i) || (causal && j > i0 + ii)) continue;
            const float* qi = qs + ii * D;
            const float* doi = dos + ii * D;
            float dot = 0.f, dp = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) dot += qi[d] * kr[d];
#pragma unroll
            for (int d = 0; d < D; ++d) dp += doi[d] * vr[d];
            const float p = expf(dot * scale - l_i);
            const float ds = p * (dp - dels[ii]) * scale;
#pragma unroll
            for (int d = 0; d < D; ++d) {
                dvr[d] = dvr[d] + p * doi[d];
                dkr[d] = dkr[d] + ds * qi[d];
            }
        }
    }

    if (live) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            store(dk + (bh * S + j) * D + d, dkr[d]);
            store(dv + (bh * S + j) * D + d, dvr[d]);
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const uint8_t* __restrict__ mask,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int64_t H,
          int64_t Lq, int64_t S, int64_t block_q, int64_t block_k, int causal,
          float scale) {
    constexpr int TK = (4096 / D) < 128 ? (4096 / D) : 128;  // keys per tile
    __shared__ __align__(16) float ks[TK * D];
    __shared__ __align__(16) float vs[TK * D];
    __shared__ uint8_t ms[TK];

    const int64_t ntiles = (Lq + kRows - 1) / kRows;
    const int64_t bh = blockIdx.x / ntiles;
    const int64_t i0 = (blockIdx.x % ntiles) * kRows;
    const int64_t i = i0 + threadIdx.x;
    const bool live = i < Lq;
    const float l_i = live ? lse[bh * Lq + i] : kNegInf;
    const float del = live ? delta[bh * Lq + i] : 0.f;
    const bool work = live && !dead(l_i);
    const uint8_t* mb = mask + (bh / H) * S;

    float qr[D], dor[D], dqr[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        qr[d] = work ? to_f32(q[(bh * Lq + i) * D + d]) : 0.f;
        dor[d] = work ? to_f32(dout[(bh * Lq + i) * D + d]) : 0.f;
        dqr[d] = 0.f;
    }
    const int64_t nrun = work ? keys_run(i, S, block_q, block_k, causal) : 0;
    const int64_t ilast = (i0 + kRows < Lq ? i0 + kRows : Lq) - 1;
    const int64_t nblock = keys_run(ilast, S, block_q, block_k, causal);

    for (int64_t j0 = 0; j0 < nblock; j0 += TK) {
        const int n = (int)(nblock - j0 < TK ? nblock - j0 : TK);
        __syncthreads();
        load_tile<D>(ks, k + (bh * S + j0) * D, n, threadIdx.x, kRows);
        load_tile<D>(vs, v + (bh * S + j0) * D, n, threadIdx.x, kRows);
        for (int t = threadIdx.x; t < n; t += kRows) ms[t] = mb[j0 + t];
        __syncthreads();
        const int64_t left = nrun - j0;
        const int nj = (int)(left < n ? (left > 0 ? left : 0) : n);
        for (int jj = 0; jj < nj; ++jj) {
            if (!ms[jj] || (causal && j0 + jj > i)) continue;
            const float* kj = ks + jj * D;
            const float* vj = vs + jj * D;
            float dot = 0.f, dp = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) dot += qr[d] * kj[d];
#pragma unroll
            for (int d = 0; d < D; ++d) dp += dor[d] * vj[d];
            const float p = expf(dot * scale - l_i);
            const float ds = p * (dp - del) * scale;
#pragma unroll
            for (int d = 0; d < D; ++d) dqr[d] = dqr[d] + ds * kj[d];
        }
    }

    if (live) {
#pragma unroll
        for (int d = 0; d < D; ++d) store(dq + (bh * Lq + i) * D + d, dqr[d]);
    }
}

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const uint8_t* mask;
    const void* dout;
    const float* lse;
    const float* delta;
    int bf16;
};

template <typename T, int D>
cudaError_t launch_dkdv_t(const Args& a, void* dk, void* dv, int64_t blocks, int64_t H,
                          int64_t Lq, int64_t S, int64_t block_q, int64_t block_k,
                          int causal, float scale, cudaStream_t stream) {
    dkdv_kernel<T, D><<<(unsigned int)blocks, kRows, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.mask, static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk),
        static_cast<T*>(dv), H, Lq, S, block_q, block_k, causal, scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, int64_t blocks, int64_t H,
                        int64_t Lq, int64_t S, int64_t block_q, int64_t block_k,
                        int causal, float scale, cudaStream_t stream) {
    return a.bf16 ? launch_dkdv_t<__nv_bfloat16, D>(a, dk, dv, blocks, H, Lq, S, block_q,
                                                    block_k, causal, scale, stream)
                  : launch_dkdv_t<float, D>(a, dk, dv, blocks, H, Lq, S, block_q, block_k,
                                            causal, scale, stream);
}

template <typename T, int D>
cudaError_t launch_dq_t(const Args& a, void* dq, int64_t blocks, int64_t H, int64_t Lq,
                        int64_t S, int64_t block_q, int64_t block_k, int causal,
                        float scale, cudaStream_t stream) {
    dq_kernel<T, D><<<(unsigned int)blocks, kRows, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.mask, static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), H, Lq,
        S, block_q, block_k, causal, scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, int64_t blocks, int64_t H, int64_t Lq,
                      int64_t S, int64_t block_q, int64_t block_k, int causal,
                      float scale, cudaStream_t stream) {
    return a.bf16 ? launch_dq_t<__nv_bfloat16, D>(a, dq, blocks, H, Lq, S, block_q, block_k,
                                                  causal, scale, stream)
                  : launch_dq_t<float, D>(a, dq, blocks, H, Lq, S, block_q, block_k, causal,
                                          scale, stream);
}

int check(long long B, long long H, long long Lq, long long S, long long block_q,
          long long block_k, long long rows) {
    if (B <= 0 || H <= 0 || Lq <= 0 || S <= 0 || block_q <= 0 || block_k <= 0 ||
        Lq % block_q || S % block_k)
        return (int)cudaErrorInvalidValue;
    if ((int64_t)B * H * ((rows + kRows - 1) / kRows) > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    return 0;
}

Args args(const void* q, const void* k, const void* v, const void* mask,
          const void* dout, const void* lse, const void* delta, int bf16) {
    return Args{q, k, v, static_cast<const uint8_t*>(mask), dout,
                static_cast<const float*>(lse), static_cast<const float*>(delta), bf16};
}

}  // namespace

extern "C" int flash_attention_bwd_dkdv(
        const void* q, const void* k, const void* v, const void* mask,
        const void* dout, const void* lse, const void* delta, void* dk, void* dv,
        long long B, long long H, long long Lq, long long S, long long D,
        long long block_q, long long block_k, int causal, float scale, int bf16,
        void* stream) {
    if (int err = check(B, H, Lq, S, block_q, block_k, S)) return err;
    const Args a = args(q, k, v, mask, dout, lse, delta, bf16);
    const int64_t blocks = (int64_t)B * H * ((S + kRows - 1) / kRows);
    void* dkp = dk;
    void* dvp = dv;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return (int)launch_dkdv<8>(a, dkp, dvp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 16: return (int)launch_dkdv<16>(a, dkp, dvp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 32: return (int)launch_dkdv<32>(a, dkp, dvp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 64: return (int)launch_dkdv<64>(a, dkp, dvp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 128: return (int)launch_dkdv<128>(a, dkp, dvp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int flash_attention_bwd_dq(
        const void* q, const void* k, const void* v, const void* mask,
        const void* dout, const void* lse, const void* delta, void* dq,
        long long B, long long H, long long Lq, long long S, long long D,
        long long block_q, long long block_k, int causal, float scale, int bf16,
        void* stream) {
    if (int err = check(B, H, Lq, S, block_q, block_k, Lq)) return err;
    const Args a = args(q, k, v, mask, dout, lse, delta, bf16);
    const int64_t blocks = (int64_t)B * H * ((Lq + kRows - 1) / kRows);
    void* dqp = dq;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return (int)launch_dq<8>(a, dqp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 16: return (int)launch_dq<16>(a, dqp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 32: return (int)launch_dq<32>(a, dqp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 64: return (int)launch_dq<64>(a, dqp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        case 128: return (int)launch_dq<128>(a, dqp, blocks, H, Lq, S, block_q, block_k, causal, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
