// Flash attention backward for Hopper (sm_90a): exact gradients from the
// saved log-sum-exp, in two kernels as the TPU version has two calls.
//
// Replaces the Pallas TPU kernels deeprec_tpu/ops/flash_attention.py
// ::_pallas_backward: _fa_bwd_dkdv_kernel (one K block owns the instance,
// Q blocks stream through the sequential grid axis, dk/dv accumulate in
// VMEM scratch) and _fa_bwd_dq_kernel (the forward's access pattern with ds
// in place of p). On Hopper the sequential grid axis becomes a loop inside
// the block, and both kernels work on the real keys only:
//  - dq_kernel (launched first): one block owns (b*h, a tile of query
//    rows), each thread R rows (q, do, dq in registers); the block lists
//    its batch row's real keys (a ballot per 32 mask bytes) and stages only
//    those rows of k and v in shared memory, as the forward does. It also
//    computes each row's delta = rowsum(do * o) from the stored o and
//    writes it for the second kernel;
//  - dkdv_kernel: block g of a b*h owns its batch row's real keys of rank
//    g*KB .. g*KB+KB-1 (listed by a ballot per 32 mask bytes), one per
//    thread (k, v, dk, dv in registers), and streams tiles of q, do, lse
//    and delta through shared memory, rows unrolled so that their latencies
//    overlap. A warp past the row's last real key skips the rows, and a
//    block past it stops at once. A masked key's dk
//    and dv are exactly 0 (p = 0 for it in every row), so block g writes
//    zeros for the masked keys among positions g*KB .. g*KB+KB-1, and they
//    stream nothing.
// Each output element is written once by one thread: no atomics, so the
// result is deterministic.
//
// What bounds it: operations, and on this card the instructions per real
// (row, key) pair. The five products (s and dp in both kernels; dv, dk,
// dq) over BST's real pairs (B*H = 8192, Lq = S = 256, D = 8, about 40 %
// real) are 17 GFLOP, 0.25 ms at 67 TFLOP/s. Each pair costs FFMAs for its
// products, one MUFU.EX2 (scale * log2(e) folded into q or k, lse taken to
// log2 units once per row) and a few scalar operations; in dQ one broadcast
// shared-memory load of a key feeds R rows. For wide heads a key's or
// row's D splits over G lanes (dot products summed by shuffles) so that the
// registers hold it.
//
// Semantics kept from the Pallas kernels (and the port's plain version,
// ops/flash_attention.py flash_backward_plain):
//  - p = exp(s - lse) with the dead-row guard of _probs_from_lse: a row
//    whose lse <= -5e29 (all its visible keys masked) has p = 0 everywhere,
//    so its dq is 0 and it adds nothing to dk and dv;
//  - ds = p * (dp - delta) * scale, dv += p do, dk += ds q, dq += ds k (the
//    scale is applied to dk and dq once, at the end);
//  - a masked key, or under causal a key j > i, has s = -1e30, so
//    p = exp(-1e30 - lse) is exactly 0 for a live row: the kernels skip
//    such pairs. The caller's causal block skip only hides keys j > i, so
//    it needs no test of its own here.
// The sums run in another order than the plain version's, so results agree
// to a tolerance, not bit for bit.
//
// Types: q, k, v, do, o and the gradients are all f32 or all bf16. Every
// element is upcast to f32 on load, the computation is f32, and dq, dk and
// dv are stored in the inputs' type (bf16 rounded to nearest even, as JAX's
// `.astype`); lse and delta are f32 (delta from the stored, rounded o).
//
// Layout: q, do, o [BH, Lq, D]; k, v [BH, S, D]; lse, delta [BH, Lq] f32;
// mask [B, S] bytes indexed by b = bh / H; dq [BH, Lq, D], dk, dv [BH, S, D],
// all contiguous. D is one of 8, 16, 32, 64, 128. Offsets inside one b*h
// are 32-bit (the launchers check Lq*D and S*D).
//
// The launchers run on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() so a refused launch is seen.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ bool dead(float lse) { return lse <= kNegInf * 0.5f; }

// ------------------------------------------------------------------ dQ

// Per head width: R rows per group of G lanes, NT threads a block, W listed
// keys per shared-memory tile. At D 32, 2 rows took 255 registers and ran
// no faster than 1.
template <int D> struct DqCfg;
template <> struct DqCfg<8> { static constexpr int R = 2, G = 1, NT = 128, W = 256; };
template <> struct DqCfg<16> { static constexpr int R = 2, G = 1, NT = 128, W = 256; };
template <> struct DqCfg<32> { static constexpr int R = 1, G = 1, NT = 128, W = 128; };
template <> struct DqCfg<64> { static constexpr int R = 1, G = 2, NT = 256, W = 64; };
template <> struct DqCfg<128> { static constexpr int R = 1, G = 4, NT = 256, W = 32; };

template <int D>
constexpr int kDqRowsPerBlock = DqCfg<D>::NT / DqCfg<D>::G * DqCfg<D>::R;

// Tile key c into the thread's R rows' dq. kPred: row r sees only the first
// nr[r] keys (p = 0 past them, and for dead or absent rows).
template <bool kPred, int D, int R, int G>
__device__ __forceinline__ void dq_key(const float* ks, const float* vs, int c, int gl,
                                       const float (&qr)[R][D / G],
                                       const float (&dor)[R][D / G],
                                       float (&dqr)[R][D / G], const float (&l2)[R],
                                       const float (&del)[R], const int (&nr)[R]) {
    constexpr int DL = D / G;
    float kk[DL], vv[DL];
    load_part<DL, G>(kk, ks + c * D, gl);
    load_part<DL, G>(vv, vs + c * D, gl);
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float s = group_sum<G>(dot<DL>(qr[r], kk));
        const float dp = group_sum<G>(dot<DL>(dor[r], vv));
        float p = ex2(s - l2[r]);
        if (kPred) p = c < nr[r] ? p : 0.f;
        const float ds = p * (dp - del[r]);
#pragma unroll
        for (int d = 0; d < DL; ++d) dqr[r][d] = __fmaf_rn(ds, kk[d], dqr[r][d]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(DqCfg<D>::NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const uint8_t* __restrict__ mask, const T* __restrict__ dout,
          const float* __restrict__ lse, const T* __restrict__ o, T* __restrict__ dq,
          float* __restrict__ delta, int H, int Lq, int S, int causal, float scale) {
    constexpr int R = DqCfg<D>::R, G = DqCfg<D>::G, NT = DqCfg<D>::NT,
                  W = DqCfg<D>::W, DL = D / G, RB = kDqRowsPerBlock<D>;
    static_assert(DL % 4 == 0, "tile shapes");
    __shared__ __align__(16) float ks[W * D];
    __shared__ __align__(16) float vs[W * D];
    __shared__ int idx[W];
    __shared__ int count;

    const int ntiles = (Lq + RB - 1) / RB;
    const int64_t bh = blockIdx.x / ntiles;
    const int i0 = (int)(blockIdx.x % ntiles) * RB;
    const int gl = threadIdx.x % G;
    const int ib = i0 + (int)threadIdx.x / G * R;  // the thread's first row
    const int64_t row0 = bh * Lq;
    const T* kb = k + bh * S * D;
    const T* vb = v + bh * S * D;
    const uint8_t* mb = mask + bh / H * S;
    const float scale2 = scale * kLog2e;

    float qr[R][DL], dor[R][DL], dqr[R][DL], l2[R], del[R];
    bool alive[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int i = ib + r;
        const bool live = i < Lq;
        float orow[DL];
        if (live) {
            load_part<DL, G>(qr[r], q + (row0 + i) * D, gl);
            load_part<DL, G>(dor[r], dout + (row0 + i) * D, gl);
            load_part<DL, G>(orow, o + (row0 + i) * D, gl);
        }
        float dsum = 0.f;
#pragma unroll
        for (int d = 0; d < DL; ++d) {
            qr[r][d] = live ? qr[r][d] * scale2 : 0.f;
            dor[r][d] = live ? dor[r][d] : 0.f;
            dsum = __fmaf_rn(dor[r][d], live ? orow[d] : 0.f, dsum);
            dqr[r][d] = 0.f;
        }
        del[r] = group_sum<G>(dsum);
        const float lse_i = live ? lse[row0 + i] : kNegInf;
        alive[r] = live && !dead(lse_i);
        l2[r] = alive[r] ? lse_i * kLog2e : 0.f;
        if (live && gl == 0) delta[row0 + i] = del[r];
    }

    // keys past the block's last row are causally hidden from all its rows
    const int ilast = (i0 + RB < Lq ? i0 + RB : Lq) - 1;
    const int bound = causal ? (ilast + 1 < S ? ilast + 1 : S) : S;
    for (int skip = 0;; skip += W) {  // tiles of W listed keys
        __syncthreads();  // the previous tile is no longer read
        compact<W>(mb, bound, skip, idx, &count);
        const int n = count;
        if (n == 0) break;
        gather_kv<D, NT>(ks, vs, kb, vb, idx, n, n);
        int nr[R], lo = n, hi = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            nr[r] = !alive[r] ? 0 : causal ? count_upto(idx, n, ib + r) : n;
            lo = min(lo, nr[r]);
            hi = max(hi, nr[r]);
        }
        __syncthreads();
        lo = __reduce_min_sync(kAll, lo);  // warp-uniform bounds (shuffles)
        hi = __reduce_max_sync(kAll, hi);
        int c = 0;
        for (; c < lo; ++c) dq_key<false, D, R, G>(ks, vs, c, gl, qr, dor, dqr, l2, del, nr);
        for (; c < hi; ++c) dq_key<true, D, R, G>(ks, vs, c, gl, qr, dor, dqr, l2, del, nr);
        if (n < W) break;  // that was the last real key
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (ib + r >= Lq) continue;
#pragma unroll
        for (int d = 0; d < DL; ++d) dqr[r][d] = dqr[r][d] * scale;
        store_part<DL, G>(dq + (row0 + ib + r) * D, gl, dqr[r]);
    }
}

// ------------------------------------------------------------------ dK/dV

// Per head width: one key per group of G lanes, NT threads a block (so
// KB = NT / G keys a block), TQ query rows per shared-memory tile, U rows
// unrolled (each unrolled row holds its q and do in registers). Two or four
// keys per thread ran slower at BST's shape (more registers, fewer warps).
template <int D> struct KvCfg;
template <> struct KvCfg<8> { static constexpr int G = 1, NT = 128, TQ = 256, U = 4; };
template <> struct KvCfg<16> { static constexpr int G = 2, NT = 128, TQ = 128, U = 4; };
template <> struct KvCfg<32> { static constexpr int G = 2, NT = 64, TQ = 128, U = 4; };
template <> struct KvCfg<64> { static constexpr int G = 4, NT = 128, TQ = 64, U = 2; };
template <> struct KvCfg<128> { static constexpr int G = 8, NT = 256, TQ = 32, U = 4; };

template <int D>
constexpr int kKeysPerBlock = KvCfg<D>::NT / KvCfg<D>::G;

// Tile row ii (query row i) into the thread's key's dk and dv. kPred: under
// causal, the key (position j) gets p = 0 when j > i.
template <bool kPred, int DL, int G>
__device__ __forceinline__ void kv_row(const float* qs, const float* dos, int ii, int i,
                                       float2 lse2_delta, int gl, const float (&kr)[DL],
                                       const float (&vr)[DL], float (&dkr)[DL],
                                       float (&dvr)[DL], int j) {
    constexpr int D = DL * G;
    float qv[DL], dov[DL];
    load_part<DL, G>(qv, qs + ii * D, gl);
    load_part<DL, G>(dov, dos + ii * D, gl);
    const float s = group_sum<G>(dot<DL>(qv, kr));
    const float dp = group_sum<G>(dot<DL>(dov, vr));
    float p = ex2(s - lse2_delta.x);
    if (kPred) p = j > i ? 0.f : p;
    const float ds = p * (dp - lse2_delta.y);
#pragma unroll
    for (int d = 0; d < DL; ++d) {
        dvr[d] = __fmaf_rn(p, dov[d], dvr[d]);
        dkr[d] = __fmaf_rn(ds, qv[d], dkr[d]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(KvCfg<D>::NT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const uint8_t* __restrict__ mask, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int H, int Lq, int S, int causal,
            float scale) {
    constexpr int G = KvCfg<D>::G, NT = KvCfg<D>::NT, TQ = KvCfg<D>::TQ, U = KvCfg<D>::U,
                  DL = D / G, KB = kKeysPerBlock<D>;
    static_assert(DL % 4 == 0 && NT % 32 == 0, "tile shapes");
    __shared__ __align__(16) float qs[TQ * D];
    __shared__ __align__(16) float dos[TQ * D];
    __shared__ float2 rowc[TQ];  // (lse in log2 units, delta) per row: one load
    __shared__ int idx[KB];
    __shared__ int count;

    const int ngroups = (S + KB - 1) / KB;
    const int64_t bh = blockIdx.x / ngroups;
    const int j0 = (int)(blockIdx.x % ngroups) * KB;  // first rank, and first zeroed position
    const int jend = j0 + KB < S ? j0 + KB : S;
    // under causal no query row (i < Lq) sees a key j >= Lq
    const int bound = causal ? (S < Lq ? S : Lq) : S;
    const int gl = threadIdx.x % G;
    const int c = (int)threadIdx.x / G;  // the thread's listed key
    const int64_t row0 = bh * Lq;
    const uint8_t* mb = mask + bh / H * S;
    T* dkb = dk + bh * S * D;
    T* dvb = dv + bh * S * D;

    compact<KB>(mb, bound, j0, idx, &count);
    const int n = count;
    // zeros for the keys among positions j0 .. jend-1 that no row sees
    for (int t = threadIdx.x; t < (jend - j0) * (D / 4); t += NT) {
        const int j = j0 + t / (D / 4);
        if (j >= bound || !mb[j]) {
            store4(dkb + j * D, t % (D / 4), make_float4(0.f, 0.f, 0.f, 0.f));
            store4(dvb + j * D, t % (D / 4), make_float4(0.f, 0.f, 0.f, 0.f));
        }
    }
    if (n == 0) return;

    const bool has = c < n;
    const int j = has ? idx[c] : 0x7FFFFFFF;
    const float scale2 = scale * kLog2e;
    float kr[DL], vr[DL], dkr[DL], dvr[DL];
    if (has) {
        load_part<DL, G>(kr, k + (bh * S + j) * D, gl);
        load_part<DL, G>(vr, v + (bh * S + j) * D, gl);
    }
#pragma unroll
    for (int d = 0; d < DL; ++d) {
        kr[d] = has ? kr[d] * scale2 : 0.f;
        vr[d] = has ? vr[d] : 0.f;
        dkr[d] = dvr[d] = 0.f;
    }
    const bool busy = __any_sync(kAll, has);  // the warp holds a real key
    // under causal, rows before the block's first real key see none of its
    // keys, and rows i < jmax (the warp's last key) need the per-key test
    const int jmax = causal ? __reduce_max_sync(kAll, has ? j : -1) : -1;
    const int first = causal ? idx[0] : 0;

    for (int i0 = first; i0 < Lq; i0 += TQ) {
        const int nq = Lq - i0 < TQ ? Lq - i0 : TQ;
        __syncthreads();  // the previous tile is no longer read
        for (int t = threadIdx.x; t < nq * (D / 4); t += NT) {
            store4(qs, t, load4(q + (row0 + i0) * D, t));
            store4(dos, t, load4(dout + (row0 + i0) * D, t));
        }
        for (int t = threadIdx.x; t < nq; t += NT) {
            const float l = lse[row0 + i0 + t];
            // a dead row gets +inf: p = ex2(-inf) = 0 for every key
            rowc[t] = make_float2(dead(l) ? CUDART_INF_F : l * kLog2e, delta[row0 + i0 + t]);
        }
        __syncthreads();
        if (!busy) continue;
        // under causal, rows before jmax need the per-key test; the rest
        // run without branches, unrolled so that rows overlap
        const int split = min(max(jmax - i0, 0), nq);
        int ii = 0;
        for (; ii < split; ++ii)
            kv_row<true, DL, G>(qs, dos, ii, i0 + ii, rowc[ii], gl, kr, vr, dkr, dvr, j);
#pragma unroll U
        for (; ii < nq; ++ii)
            kv_row<false, DL, G>(qs, dos, ii, i0 + ii, rowc[ii], gl, kr, vr, dkr, dvr, j);
    }

    if (has) {
#pragma unroll
        for (int d = 0; d < DL; ++d) dkr[d] = dkr[d] * scale;
        store_part<DL, G>(dkb + j * D, gl, dkr);
        store_part<DL, G>(dvb + j * D, gl, dvr);
    }
}

// ------------------------------------------------------------------ launchers

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const uint8_t* mask;
    const void* dout;
    const float* lse;
    int64_t BH;
    int H, Lq, S, causal;
    float scale;
};

template <typename T, int D>
cudaError_t launch_dq_t(const Args& a, const void* o, void* dq, void* delta,
                        cudaStream_t stream) {
    constexpr int RB = kDqRowsPerBlock<D>;
    const int64_t blocks = a.BH * ((a.Lq + RB - 1) / RB);
    if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
    dq_kernel<T, D><<<(unsigned int)blocks, DqCfg<D>::NT, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.mask, static_cast<const T*>(a.dout), a.lse, static_cast<const T*>(o),
        static_cast<T*>(dq), static_cast<float*>(delta), a.H, a.Lq, a.S, a.causal, a.scale);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkdv_t(const Args& a, const void* delta, void* dk, void* dv,
                          cudaStream_t stream) {
    constexpr int KB = kKeysPerBlock<D>;
    const int64_t blocks = a.BH * ((a.S + KB - 1) / KB);
    if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
    dkdv_kernel<T, D><<<(unsigned int)blocks, KvCfg<D>::NT, 0, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        a.mask, static_cast<const T*>(a.dout), a.lse, static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Lq, a.S, a.causal, a.scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const Args& a, long long D, const void* o, void* dq, void* delta,
                      cudaStream_t s) {
    switch (D) {
        case 8: return launch_dq_t<T, 8>(a, o, dq, delta, s);
        case 16: return launch_dq_t<T, 16>(a, o, dq, delta, s);
        case 32: return launch_dq_t<T, 32>(a, o, dq, delta, s);
        case 64: return launch_dq_t<T, 64>(a, o, dq, delta, s);
        case 128: return launch_dq_t<T, 128>(a, o, dq, delta, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t launch_dkdv(const Args& a, long long D, const void* delta, void* dk, void* dv,
                        cudaStream_t s) {
    switch (D) {
        case 8: return launch_dkdv_t<T, 8>(a, delta, dk, dv, s);
        case 16: return launch_dkdv_t<T, 16>(a, delta, dk, dv, s);
        case 32: return launch_dkdv_t<T, 32>(a, delta, dk, dv, s);
        case 64: return launch_dkdv_t<T, 64>(a, delta, dk, dv, s);
        case 128: return launch_dkdv_t<T, 128>(a, delta, dk, dv, s);
        default: return cudaErrorInvalidValue;
    }
}

// The shapes both kernels take; offsets inside one b*h are 32-bit.
int check(long long B, long long H, long long Lq, long long S, long long D,
          long long block_q, long long block_k) {
    if (B <= 0 || H <= 0 || Lq <= 0 || S <= 0 || block_q <= 0 || block_k <= 0 ||
        Lq % block_q || S % block_k)
        return (int)cudaErrorInvalidValue;
    if (H > 0x7FFFFFFF || Lq * D > 0x7FFFFFFF || S * D > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    return 0;
}

Args args(const void* q, const void* k, const void* v, const void* mask, const void* dout,
          const void* lse, long long B, long long H, long long Lq, long long S, int causal,
          float scale) {
    return Args{q, k, v, static_cast<const uint8_t*>(mask), dout,
                static_cast<const float*>(lse), (int64_t)B * H, (int)H, (int)Lq, (int)S,
                causal, scale};
}

}  // namespace

// dq, and delta = rowsum(do * o) for flash_attention_bwd_dkdv: launch first.
extern "C" int flash_attention_bwd_dq(
        const void* q, const void* k, const void* v, const void* mask,
        const void* dout, const void* lse, const void* o, void* dq, void* delta,
        long long B, long long H, long long Lq, long long S, long long D,
        long long block_q, long long block_k, int causal, float scale, int bf16,
        void* stream) {
    if (int err = check(B, H, Lq, S, D, block_q, block_k)) return err;
    const Args a = args(q, k, v, mask, dout, lse, B, H, Lq, S, causal, scale);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(bf16 ? launch_dq<__nv_bfloat16>(a, D, o, dq, delta, s)
                      : launch_dq<float>(a, D, o, dq, delta, s));
}

// dk and dv, from the delta that flash_attention_bwd_dq wrote.
extern "C" int flash_attention_bwd_dkdv(
        const void* q, const void* k, const void* v, const void* mask,
        const void* dout, const void* lse, const void* delta, void* dk, void* dv,
        long long B, long long H, long long Lq, long long S, long long D,
        long long block_q, long long block_k, int causal, float scale, int bf16,
        void* stream) {
    if (int err = check(B, H, Lq, S, D, block_q, block_k)) return err;
    const Args a = args(q, k, v, mask, dout, lse, B, H, Lq, S, causal, scale);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)(bf16 ? launch_dkdv<__nv_bfloat16>(a, D, delta, dk, dv, s)
                      : launch_dkdv<float>(a, D, delta, dk, dv, s));
}
