// Flash attention forward for Hopper (sm_90a): masked online-softmax
// attention that saves the log-sum-exp.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/flash_attention.py
// ::_pallas_forward (kernel _fa_fwd_kernel). The TPU kernel walks a grid
// (BH, Q blocks, K blocks) in order on one core and carries the running
// (m, l, acc) in VMEM scratch from one K-block step to the next. Blocks of
// a CUDA grid run in parallel and in no order, so the K loop moves inside
// the block: one block owns (b*h, a tile of 128 query rows), one thread owns
// one query row and keeps q, acc[D], m and l in registers, and the block
// stages each tile of k, v and the key mask in shared memory for all its
// rows. Keys are folded into the running softmax 16 at a time (one rescale
// per 16 keys).
//
// What bounds it: operations. At the BST shape (B*H = 8192, Lq = S = 256,
// D = 8) the two products are 4*B*H*Lq*S*D = 17.2 GFLOP of f32 work on the
// CUDA cores (67 TFLOP/s) against 277 MB of q, k, v, mask, o and lse (3.35
// TB/s): 0.256 ms against 0.083 ms. The design keeps every score in
// registers (no [Lq, S] matrix anywhere) and reads each k and v tile from
// device memory once per 128 query rows.
//
// Semantics kept from the Pallas kernel, which the port's plain version
// (ops/flash_attention.py flash_forward_plain) shares:
//  - NEG_INF is the finite -1e30f. A masked score IS -1e30f, so a row whose
//    visible keys are all masked takes exp(s - m) = 1 for every key that
//    runs: its output is the mean of v over those keys, its lse -1e30.
//  - Under causal, key j runs for query row i only when its K block kb
//    satisfies kb*block_k <= (qb+1)*block_q - 1 at the CALLER's block sizes
//    (qb = i / block_q): the Pallas grid's skip, not this kernel's tiling.
//  - l_safe = max(l, 1e-30); o = acc / l_safe; lse = m + log(l_safe).
//
// Types: q, k, v and o are all f32 or all bf16, as the Pallas kernel takes
// either. Every element is upcast to f32 on load (bf16 tiles are widened
// into f32 shared memory), the whole computation is f32, and o is stored in
// q's type, bf16 rounded to nearest even as JAX's `.astype` rounds; lse
// stays f32.
//
// Layout: q [BH, Lq, D], k and v [BH, S, D], o [BH, Lq, D] contiguous;
// mask [B, S] bytes (torch.bool), indexed by b = bh / H; lse [BH, Lq] f32.
// D is one of 8, 16, 32, 64, 128 (the wrapper zero-pads other widths).
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kRows = 128;   // query rows per block, one per thread
constexpr int kChunk = 16;   // keys per online-softmax rescale

// Keys [0, n) that query row i runs: every key when not causal, else the
// keys of the caller's K blocks kb with kb*block_k <= (qb+1)*block_q - 1.
__device__ __forceinline__ int64_t keys_run(int64_t i, int64_t S, int64_t block_q,
                                            int64_t block_k, int causal) {
    if (!causal) return S;
    const int64_t last = (i / block_q + 1) * block_q - 1;
    const int64_t n = (last / block_k + 1) * block_k;
    return n < S ? n : S;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const uint8_t* __restrict__ mask,
           T* __restrict__ o, float* __restrict__ lse, int64_t H, int64_t Lq,
           int64_t S, int64_t block_q, int64_t block_k, int causal, float scale) {
    constexpr int TK = (4096 / D) < 128 ? (4096 / D) : 128;  // keys per tile
    __shared__ __align__(16) float ks[TK * D];
    __shared__ __align__(16) float vs[TK * D];
    __shared__ uint8_t ms[TK];

    const int64_t ntiles = (Lq + kRows - 1) / kRows;
    const int64_t bh = blockIdx.x / ntiles;
    const int64_t i0 = (blockIdx.x % ntiles) * kRows;
    const int64_t i = i0 + threadIdx.x;
    const bool live = i < Lq;
    const T* kb = k + bh * S * D;
    const T* vb = v + bh * S * D;
    const uint8_t* mb = mask + (bh / H) * S;

    float qr[D], acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        qr[d] = live ? to_f32(q[(bh * Lq + i) * D + d]) : 0.f;
        acc[d] = 0.f;
    }
    float m = kNegInf, l = 0.f;
    const int64_t nrun = live ? keys_run(i, S, block_q, block_k, causal) : 0;
    const int64_t ilast = (i0 + kRows < Lq ? i0 + kRows : Lq) - 1;
    const int64_t nblock = keys_run(ilast, S, block_q, block_k, causal);

    for (int64_t j0 = 0; j0 < nblock; j0 += TK) {
        const int n = (int)(nblock - j0 < TK ? nblock - j0 : TK);
        __syncthreads();  // the previous tile is no longer read
        const T* ksrc = kb + j0 * D;
        const T* vsrc = vb + j0 * D;
        // K and V in one loop: two separate loops took 7.7 % longer at BST's shape
        for (int t = threadIdx.x; t < n * D / 4; t += kRows) {
            reinterpret_cast<float4*>(ks)[t] = load4(ksrc, t);
            reinterpret_cast<float4*>(vs)[t] = load4(vsrc, t);
        }
        for (int t = threadIdx.x; t < n; t += kRows) ms[t] = mb[j0 + t];
        __syncthreads();

        const int64_t left = nrun - j0;
        const int nj = (int)(left < n ? (left > 0 ? left : 0) : n);
        for (int c0 = 0; c0 < nj; c0 += kChunk) {
            float s[kChunk];
            float cmax = kNegInf;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                const int jj = c0 + c;
                float sc = kNegInf;
                if (jj < nj) {
                    float dot = 0.f;
#pragma unroll
                    for (int d = 0; d < D; ++d) dot += qr[d] * ks[jj * D + d];
                    sc = dot * scale;
                    if (!ms[jj] || (causal && j0 + jj > i)) sc = kNegInf;
                }
                s[c] = sc;
                cmax = fmaxf(cmax, sc);
            }
            const float m_new = fmaxf(m, cmax);
            const float corr = expf(m - m_new);
            l = l * corr;
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = acc[d] * corr;
#pragma unroll
            for (int c = 0; c < kChunk; ++c) {
                const int jj = c0 + c;
                if (jj < nj) {
                    const float p = expf(s[c] - m_new);
                    l = l + p;
#pragma unroll
                    for (int d = 0; d < D; ++d) acc[d] = acc[d] + p * vs[jj * D + d];
                }
            }
            m = m_new;
        }
    }

    if (live) {
        const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
        for (int d = 0; d < D; ++d) store(o + (bh * Lq + i) * D + d, acc[d] / l_safe);
        lse[bh * Lq + i] = m + logf(l_safe);
    }
}

template <typename T, int D>
cudaError_t launch_t(const void* q, const void* k, const void* v, const void* mask,
                     void* o, void* lse, int64_t blocks, int64_t H, int64_t Lq,
                     int64_t S, int64_t block_q, int64_t block_k, int causal,
                     float scale, cudaStream_t stream) {
    fwd_kernel<T, D><<<(unsigned int)blocks, kRows, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const uint8_t*>(mask),
        static_cast<T*>(o), static_cast<float*>(lse), H, Lq, S, block_q,
        block_k, causal, scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask,
                   void* o, void* lse, int64_t blocks, int64_t H, int64_t Lq,
                   int64_t S, int64_t block_q, int64_t block_k, int causal,
                   float scale, int bf16, cudaStream_t stream) {
    return bf16 ? launch_t<__nv_bfloat16, D>(q, k, v, mask, o, lse, blocks, H, Lq, S,
                                             block_q, block_k, causal, scale, stream)
                : launch_t<float, D>(q, k, v, mask, o, lse, blocks, H, Lq, S, block_q,
                                     block_k, causal, scale, stream);
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
        const void* q, const void* k, const void* v, const void* mask, void* o,
        void* lse, long long B, long long H, long long Lq, long long S,
        long long D, long long block_q, long long block_k, int causal,
        float scale, int bf16, void* stream) {
    if (B <= 0 || H <= 0 || Lq <= 0) return 0;
    if (S <= 0 || block_q <= 0 || block_k <= 0 || Lq % block_q || S % block_k)
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = (int64_t)B * H * ((Lq + kRows - 1) / kRows);
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return (int)launch<8>(q, k, v, mask, o, lse, blocks, H, Lq, S, block_q, block_k, causal, scale, bf16, s);
        case 16: return (int)launch<16>(q, k, v, mask, o, lse, blocks, H, Lq, S, block_q, block_k, causal, scale, bf16, s);
        case 32: return (int)launch<32>(q, k, v, mask, o, lse, blocks, H, Lq, S, block_q, block_k, causal, scale, bf16, s);
        case 64: return (int)launch<64>(q, k, v, mask, o, lse, blocks, H, Lq, S, block_q, block_k, causal, scale, bf16, s);
        case 128: return (int)launch<128>(q, k, v, mask, o, lse, blocks, H, Lq, S, block_q, block_k, causal, scale, bf16, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
