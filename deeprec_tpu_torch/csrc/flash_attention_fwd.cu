// Flash attention forward for Hopper (sm_90a): masked online-softmax
// attention that saves the log-sum-exp.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/flash_attention.py
// ::_pallas_forward (kernel _fa_fwd_kernel). The TPU kernel walks a grid
// (BH, Q blocks, K blocks) in order on one core and carries the running
// (m, l, acc) in VMEM scratch from one K-block step to the next; it scores
// every key and gives a masked one the finite score -1e30. Blocks of a CUDA
// grid run in parallel and in no order, so the K loop moves inside the
// block: one block owns (b*h, a tile of query rows) and keeps each row's q,
// acc, m and l in registers.
//
// What bounds it: operations, and on this card the instructions issued per
// (row, key) pair more than the f32 FMA rate. At BST's shape (B*H = 8192,
// Lq = S = 256, D = 8, about 40 % of the keys real) the two products over
// the real pairs are 6.8 GFLOP, 0.10 ms at 67 TFLOP/s. The design:
//  - Only real keys. The block lists its batch row's real keys once per
//    tile (a ballot per 32 mask bytes, in the same launch) and stages just
//    those rows of k and v in shared memory; a row walks the listed keys it
//    sees. This is exact in value: once a row's running max is a real
//    score, a masked key's p = exp(-1e30 - m) is 0 in f32, and masked keys
//    seen before the first real one are wiped by corr = exp(-1e30 - m) = 0.
//  - Several rows per thread (R), so one broadcast load of a key's k and v
//    from shared memory feeds R rows' products; for D 64 and 128 a row's D
//    splits over G lanes (dot products summed by shuffles), so q and acc
//    stay in registers without spilling.
//  - FFMA products, and one MUFU.EX2 per score: q is scaled by
//    scale * log2(e) on load, so scores are already in log2 units; keys are
//    folded into the running softmax C at a time (one rescale per C keys).
//
// Semantics kept from the Pallas kernel, which the port's plain version
// (ops/flash_attention.py flash_forward_plain) shares:
//  - A row whose visible keys are all masked (a "dead" row: no real key at
//    all, or under causal none at or before it) scores -1e30 for every key
//    that runs and takes exp(s - m) = 1 for each: its output is the mean of
//    v over those keys, its lse -1e30. Such rows are rare; a separate
//    branch averages v from device memory for them.
//  - Under causal, key j runs for query row i only when its K block kb
//    satisfies kb*block_k <= (qb+1)*block_q - 1 at the CALLER's block sizes
//    (qb = i / block_q). That reaches every key j <= i, so it only decides
//    which keys a dead row averages.
//  - l_safe = max(l, 1e-30); o = acc / l_safe; lse = m + log(l_safe), in
//    natural-log units ((m2 + log2 l) ln 2 from the log2 units used here).
// The sums run over the real keys only and in another grouping than the
// plain version's, so results agree to a tolerance, not bit for bit.
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
// Offsets inside one b*h are 32-bit (the launcher checks Lq*D and S*D).
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

// Per head width: R rows per group of G lanes, NT threads a block, C keys
// per online-softmax rescale, W listed keys per shared-memory tile (k and
// v tiles of 32 KB at most).
template <int D> struct Cfg;
template <> struct Cfg<8> { static constexpr int R = 2, G = 1, NT = 128, C = 8, W = 256; };
template <> struct Cfg<16> { static constexpr int R = 2, G = 1, NT = 128, C = 16, W = 256; };
template <> struct Cfg<32> { static constexpr int R = 2, G = 1, NT = 128, C = 8, W = 128; };
template <> struct Cfg<64> { static constexpr int R = 1, G = 2, NT = 256, C = 16, W = 64; };
template <> struct Cfg<128> { static constexpr int R = 1, G = 4, NT = 256, C = 16, W = 32; };

template <int D>
constexpr int kRowsPerBlock = Cfg<D>::NT / Cfg<D>::G * Cfg<D>::R;

// Keys [0, n) that query row i runs: every key when not causal, else the
// keys of the caller's K blocks kb with kb*block_k <= (qb+1)*block_q - 1.
__device__ __forceinline__ int keys_run(int i, int S, int block_q, int block_k,
                                        int causal) {
    if (!causal) return S;
    const int last = (i / block_q + 1) * block_q - 1;
    const int n = (last / block_k + 1) * block_k;
    return n < S ? n : S;
}

// Keys c0 .. c0+C-1 of the tile into the running softmax of the thread's R
// rows. kPred: some row sees only the first nr[r] keys (scores past them
// are -inf, so p = 0); the tile is zero past its last key.
template <bool kPred, int D, int R, int G, int C>
__device__ __forceinline__ void fold_chunk(const float* ks, const float* vs, int c0, int gl,
                                           const float (&qr)[R][D / G],
                                           float (&acc)[R][D / G], float (&m)[R],
                                           float (&l)[R], const int (&nr)[R]) {
    constexpr int DL = D / G;
    float s[R][C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float kk[DL];
        load_part<DL, G>(kk, ks + (c0 + c) * D, gl);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float sc = group_sum<G>(dot<DL>(qr[r], kk));
            s[r][c] = (kPred && c0 + c >= nr[r]) ? -CUDART_INF_F : sc;
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        float mx = m[r];
#pragma unroll
        for (int c = 0; c < C; ++c) mx = fmaxf(mx, s[r][c]);
        const float corr = ex2(m[r] - mx);
        m[r] = mx;
        l[r] = l[r] * corr;
#pragma unroll
        for (int d = 0; d < DL; ++d) acc[r][d] = acc[r][d] * corr;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float vv[DL];
        load_part<DL, G>(vv, vs + (c0 + c) * D, gl);
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const float p = ex2(s[r][c] - m[r]);
            l[r] = l[r] + p;
#pragma unroll
            for (int d = 0; d < DL; ++d) acc[r][d] = __fmaf_rn(p, vv[d], acc[r][d]);
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(Cfg<D>::NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
           int H, int Lq, int S, int block_q, int block_k, int causal, float scale) {
    constexpr int R = Cfg<D>::R, G = Cfg<D>::G, NT = Cfg<D>::NT, C = Cfg<D>::C,
                  W = Cfg<D>::W, DL = D / G, RB = kRowsPerBlock<D>;
    static_assert(DL % 4 == 0 && W % C == 0, "tile shapes");
    __shared__ __align__(16) float ks[W * D];
    __shared__ __align__(16) float vs[W * D];
    __shared__ int idx[W];
    __shared__ int count;

    const int ntiles = (Lq + RB - 1) / RB;
    const int64_t bh = blockIdx.x / ntiles;
    const int i0 = (int)(blockIdx.x % ntiles) * RB;
    const int gl = threadIdx.x % G;
    const int ib = i0 + (int)threadIdx.x / G * R;  // the thread's first row
    const T* qb = q + bh * Lq * D;
    const T* kb = k + bh * S * D;
    const T* vb = v + bh * S * D;
    const uint8_t* mb = mask + bh / H * S;
    const float scale2 = scale * kLog2e;

    float qr[R][DL], acc[R][DL], m[R], l[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (ib + r < Lq) load_part<DL, G>(qr[r], qb + (ib + r) * D, gl);
#pragma unroll
        for (int d = 0; d < DL; ++d) {
            qr[r][d] = ib + r < Lq ? qr[r][d] * scale2 : 0.f;
            acc[r][d] = 0.f;
        }
        m[r] = kNegInf;
        l[r] = 0.f;
    }

    // keys past the block's last row are causally hidden from all its rows
    const int ilast = (i0 + RB < Lq ? i0 + RB : Lq) - 1;
    const int bound = causal ? (ilast + 1 < S ? ilast + 1 : S) : S;
    for (int skip = 0;; skip += W) {  // tiles of W listed keys
        __syncthreads();  // the previous tile is no longer read
        compact<W>(mb, bound, skip, idx, &count);
        const int n = count;
        if (n == 0) break;
        gather_kv<D, NT>(ks, vs, kb, vb, idx, n, (n + C - 1) / C * C);
        int nr[R], lo = n, hi = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = ib + r;
            nr[r] = i >= Lq ? 0 : causal ? count_upto(idx, n, i) : n;
            lo = min(lo, nr[r]);
            hi = max(hi, nr[r]);
        }
        __syncthreads();
        // warp-uniform bounds: every lane takes the same path (shuffles)
        lo = __reduce_min_sync(kAll, lo);
        hi = __reduce_max_sync(kAll, hi);
        int c0 = 0;
        for (; c0 + C <= lo; c0 += C)
            fold_chunk<false, D, R, G, C>(ks, vs, c0, gl, qr, acc, m, l, nr);
        for (; c0 < hi; c0 += C)
            fold_chunk<true, D, R, G, C>(ks, vs, c0, gl, qr, acc, m, l, nr);
        if (n < W) break;  // that was the last real key
    }

    T* ob = o + bh * Lq * D;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = ib + r;
        if (i >= Lq) continue;
        float out[DL];
        float lse_i;
        if (l[r] > 0.f) {  // l >= 1: the row saw a real key
            const float inv = 1.f / l[r];
#pragma unroll
            for (int d = 0; d < DL; ++d) out[d] = acc[r][d] * inv;
            lse_i = m[r] * kLn2 + logf(l[r]);
        } else {  // dead row: the mean of v over the keys it runs
            const int nrun = keys_run(i, S, block_q, block_k, causal);
#pragma unroll
            for (int d = 0; d < DL; ++d) out[d] = 0.f;
            for (int j = 0; j < nrun; ++j) {
                float vv[DL];
                load_part<DL, G>(vv, vb + j * D, gl);
#pragma unroll
                for (int d = 0; d < DL; ++d) out[d] = out[d] + vv[d];
            }
            const float cnt = (float)nrun;
#pragma unroll
            for (int d = 0; d < DL; ++d) out[d] = out[d] / cnt;
            lse_i = kNegInf + logf(cnt);
        }
        store_part<DL, G>(ob + i * D, gl, out);
        if (gl == 0) lse[bh * Lq + i] = lse_i;
    }
}

template <typename T, int D>
cudaError_t launch_t(const void* q, const void* k, const void* v, const void* mask,
                     void* o, void* lse, int64_t BH, int H, int Lq, int S, int block_q,
                     int block_k, int causal, float scale, cudaStream_t stream) {
    constexpr int RB = kRowsPerBlock<D>;
    const int64_t blocks = BH * ((Lq + RB - 1) / RB);
    if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
    fwd_kernel<T, D><<<(unsigned int)blocks, Cfg<D>::NT, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const uint8_t*>(mask), static_cast<T*>(o), static_cast<float*>(lse),
        H, Lq, S, block_q, block_k, causal, scale);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* o,
                   void* lse, int64_t BH, int H, int Lq, int S, int block_q, int block_k,
                   int causal, float scale, int bf16, cudaStream_t stream) {
    return bf16 ? launch_t<__nv_bfloat16, D>(q, k, v, mask, o, lse, BH, H, Lq, S, block_q,
                                             block_k, causal, scale, stream)
                : launch_t<float, D>(q, k, v, mask, o, lse, BH, H, Lq, S, block_q, block_k,
                                     causal, scale, stream);
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
    // offsets inside one b*h, and the head count, are 32-bit
    if (H > 0x7FFFFFFF || Lq * D > 0x7FFFFFFF || S * D > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    const int64_t BH = (int64_t)B * H;
    const int h = (int)H, lq = (int)Lq, s = (int)S, bq = (int)block_q, bk = (int)block_k;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return (int)launch<8>(q, k, v, mask, o, lse, BH, h, lq, s, bq, bk, causal, scale, bf16, st);
        case 16: return (int)launch<16>(q, k, v, mask, o, lse, BH, h, lq, s, bq, bk, causal, scale, bf16, st);
        case 32: return (int)launch<32>(q, k, v, mask, o, lse, BH, h, lq, s, bq, bk, causal, scale, bf16, st);
        case 64: return (int)launch<64>(q, k, v, mask, o, lse, BH, h, lq, s, bq, bk, causal, scale, bf16, st);
        case 128: return (int)launch<128>(q, k, v, mask, o, lse, BH, h, lq, s, bq, bk, causal, scale, bf16, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
