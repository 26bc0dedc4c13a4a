// fused_sparse_forward for Hopper (sm_90a): the budgeted bag lookup of the
// fused sparse step. For every table t of a stacked bundle, over the bag
// matrix ids[t] [B, L] of ROW indices (< 0 = pad) and a static budget U:
//
//   uids[t]    [U]    unique row ids; uids[t][0] = -1 (the reserved sentinel)
//   inverse[t] [B, L] position -> unique slot, 0 for pad and overflow
//   counts[t]  [U]    positions per unique slot (counts[t][0] = 0)
//   overflow[t]       distinct ids past the budget + unresolved probes
//   out[t]     [B, D] f32: out[b] = sum over l (in l order) of
//                     values[t][clip(ids[b, l], 0, C-1)] where the position
//                     is budgeted (pad and overflow add nothing)
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/fused_lookup.py::
// fused_sparse_forward. The TPU kernel inserts one id at a time into a
// probe table in VMEM, DMAs each unique row once into a [U, D] VMEM
// buffer and sums bags from there, because a TPU core runs its grid in
// order. On Hopper the grid runs in parallel, so the work is two launches
// of this library with one prefix sum between them (the wrapper,
// ops/fused_lookup.py):
//   1. probe: one thread per position claims its id in a global scratch
//      table of S = scratch_size(N) int32 keys per table (-1 = empty) with
//      atomicCAS: the hash mix32(fold64(id)), linear probing and the probe
//      bound of ops/dedup.py::hash_dedup; an unresolved position counts
//      as overflow;
//   -  the wrapper's torch.cumsum over scratch occupancy gives each
//      occupied slot its 1-based rank (hash_dedup's rank_compact);
//   2. finish: (a) an occupied slot of rank r < U publishes its id as
//      uids[r] — uids follow slot order, as in hash_dedup, so the SET of
//      budgeted ids follows its rule; (b) one thread per position writes
//      inverse and counts; (c) one warp per bag gathers each budgeted
//      position's row straight from values and sums the L positions in
//      l order in f32. No [U, D] buffer: a repeated row hits L2.
//
// What bounds it: bytes, and at small bags the latency of the dependent
// row loads. Per table: the ids (4 B each, read by the probe, the inverse
// pass and the bag pass), the scratch table and its rank (4 B x S each,
// mostly L2-resident), each position's row read (the unique rows come from
// device memory once, repeats from L2) and out written. Rows move as
// 16-byte vectors per lane (8-byte for bf16) when D % 4 == 0 and the base
// is aligned, else one element per lane.
//
// Sums: nvcc is told not to contract (-fmad=false) and the adds use
// __fadd_rn, so the order and rounding are exactly the plain version's
// (out = 0; out = out + row for l = 0..L-1).
//
// Offsets are 64-bit: a stacked bundle holds over 2^31 elements. The
// launchers run on the caller's stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ ids, int32_t* __restrict__ scratch,
             int32_t* __restrict__ slotpos, int32_t* __restrict__ overflow,
             int64_t N, int64_t S, int max_probes) {
    const int64_t n = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t t = blockIdx.y;
    if (n >= N) return;
    const int32_t id = ids[t * N + n];
    int32_t slot = -1;
    if (id >= 0) {
        int32_t* tab = scratch + t * S;
        const uint32_t h = mix32((uint32_t)id);  // fold64 of an int32 id
        const uint32_t mask = (uint32_t)(S - 1);
        for (int p = 0; p < max_probes; ++p) {
            const uint32_t pos = (h + (uint32_t)p) & mask;
            // a written slot never changes, so a non-empty read is final;
            // an empty read may be stale and the CAS settles it
            int32_t k = tab[pos];
            if (k == -1) k = atomicCAS(tab + pos, -1, id);
            if (k == -1 || k == id) {
                slot = (int32_t)pos;
                break;
            }
        }
        if (slot < 0) atomicAdd(overflow + t, 1);
    }
    slotpos[t * N + n] = slot;
}

__global__ void __launch_bounds__(kThreads)
uids_kernel(const int32_t* __restrict__ scratch, const int32_t* __restrict__ rank,
            int32_t* __restrict__ uids, int64_t S, int64_t U) {
    const int64_t s = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t t = blockIdx.y;
    if (s >= S) return;
    const int32_t k = scratch[t * S + s];
    if (k < 0) return;
    const int64_t r = rank[t * S + s];  // 1-based among occupied slots
    if (r < U) uids[t * U + r] = k;
}

__global__ void __launch_bounds__(kThreads)
inverse_kernel(const int32_t* __restrict__ slotpos, const int32_t* __restrict__ rank,
               int32_t* __restrict__ inverse, int32_t* __restrict__ counts,
               int32_t* __restrict__ overflow, int64_t N, int64_t S, int64_t U) {
    const int64_t n = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t t = blockIdx.y;
    if (n >= N) return;
    const int32_t slot = slotpos[t * N + n];
    int32_t inv = 0;
    if (slot >= 0) {
        const int32_t r = rank[t * S + slot];
        if (r < U) {
            inv = r;
            atomicAdd(counts + t * U + r, 1);
        }
    }
    inverse[t * N + n] = inv;
    if (n == 0) {  // distinct ids compacted out past the budget
        const int64_t occupied = rank[t * S + S - 1];
        if (occupied > U - 1) atomicAdd(overflow + t, (int32_t)(occupied - (U - 1)));
    }
}

__device__ __forceinline__ float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xFFFF0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xFFFF0000u));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __uint_as_float(uint32_t(__ldg(reinterpret_cast<const uint16_t*>(p))) << 16);
}

// One warp per bag. Lanes cover the columns (4 per lane per pass when VEC);
// the bag's ids and inverse come in 32 at a time, one per lane, and are
// broadcast by shuffles. Every position loads a row (pad and overflow
// positions load row 0 and add +0, which leaves the sum unchanged, as it
// never holds -0), so the loads do not wait on a branch.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
combine_kernel(const T* __restrict__ values, const int32_t* __restrict__ ids,
               const int32_t* __restrict__ inverse, float* __restrict__ out,
               int64_t B, int64_t L, int64_t C, int64_t D) {
    const int64_t bag = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    const int64_t t = blockIdx.y;
    if (bag >= B) return;
    const int lane = threadIdx.x & 31;
    const int64_t row0 = (t * B + bag) * L;
    const T* table = values + t * C * D;
    float* o = out + (t * B + bag) * D;
    const int64_t width = VEC ? D / 4 : D;
    for (int64_t c0 = 0; c0 < width; c0 += 32) {
        const int64_t c = c0 + lane;
        const bool col = c < width;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int64_t l0 = 0; l0 < L; l0 += 32) {
            int32_t my_id = 0, my_inv = 0;
            if (l0 + lane < L) {
                my_id = ids[row0 + l0 + lane];
                my_inv = inverse[row0 + l0 + lane];
            }
            const int n = L - l0 < 32 ? (int)(L - l0) : 32;
#pragma unroll 4
            for (int k = 0; k < n; ++k) {
                const int32_t id = __shfl_sync(0xFFFFFFFFu, my_id, k);
                const float w = __shfl_sync(0xFFFFFFFFu, my_inv, k) > 0 ? 1.f : 0.f;
                const int64_t r = id < 0 ? 0 : (id >= C ? C - 1 : (int64_t)id);
                if (!col) continue;
                if (VEC) {
                    const float4 x = load4(table + r * D + 4 * c);
                    acc.x = __fadd_rn(acc.x, w > 0.f ? x.x : 0.f);
                    acc.y = __fadd_rn(acc.y, w > 0.f ? x.y : 0.f);
                    acc.z = __fadd_rn(acc.z, w > 0.f ? x.z : 0.f);
                    acc.w = __fadd_rn(acc.w, w > 0.f ? x.w : 0.f);
                } else {
                    const float x = load1(table + r * D + c);
                    acc.x = __fadd_rn(acc.x, w > 0.f ? x : 0.f);
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

template <typename T>
cudaError_t launch_combine(const void* values, const int32_t* ids, const int32_t* inverse,
                           float* out, int64_t T_, int64_t B, int64_t L, int64_t C, int64_t D,
                           cudaStream_t stream) {
    const dim3 grid((unsigned int)((B + kWarpsPerBlock - 1) / kWarpsPerBlock), (unsigned int)T_);
    const uint64_t align = (uint64_t)(uintptr_t)values | (uint64_t)(uintptr_t)out;
    const bool vec = D % 4 == 0 && align % 16 == 0;
    const T* v = static_cast<const T*>(values);
    if (vec) {
        combine_kernel<T, true><<<grid, kWarpsPerBlock * 32, 0, stream>>>(v, ids, inverse, out, B, L, C, D);
    } else {
        combine_kernel<T, false><<<grid, kWarpsPerBlock * 32, 0, stream>>>(v, ids, inverse, out, B, L, C, D);
    }
    return cudaGetLastError();
}

inline unsigned int blocks_for(int64_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

// Launch 1: reset the scratch table (-1) and the overflow counts, then
// probe. ids [T, N] int32, scratch [T, S] int32 (S a power of two),
// slotpos [T, N] int32 (out: the position's scratch slot, -1 for pad or
// unresolved), overflow [T] int32.
extern "C" int fused_sparse_forward_probe(const void* ids, void* scratch, void* slotpos,
                                          void* overflow, long long T, long long N,
                                          long long S, int max_probes, void* stream) {
    if (T <= 0 || N <= 0) return 0;
    if (S <= 0 || (S & (S - 1)) != 0 || S > (1LL << 32) || T > 65535 ||
        N > (int64_t)0x7FFFFFFF * kThreads)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(scratch, 0xFF, (size_t)(T * S) * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(overflow, 0, (size_t)T * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    probe_kernel<<<dim3(blocks_for(N), (unsigned int)T), kThreads, 0, s>>>(
        static_cast<const int32_t*>(ids), static_cast<int32_t*>(scratch),
        static_cast<int32_t*>(slotpos), static_cast<int32_t*>(overflow), N, S, max_probes);
    return (int)cudaGetLastError();
}

// Launch 2: given rank [T, S] int32 (inclusive prefix count of occupied
// scratch slots), write uids [T, U], inverse [T, B*L], counts [T, U], add
// the budget overflow into overflow [T], and pool the bags into out
// [T, B, D] f32 from values [T, C, D] (f32, or bf16 when bf16 != 0).
extern "C" int fused_sparse_forward_finish(const void* values, const void* ids,
                                           const void* slotpos, const void* scratch,
                                           const void* rank, void* out, void* uids,
                                           void* inverse, void* counts, void* overflow,
                                           long long T, long long B, long long L, long long C,
                                           long long D, long long S, long long U, int bf16,
                                           void* stream) {
    const int64_t N = (int64_t)B * (int64_t)L;
    if (T <= 0 || N <= 0) return 0;
    if (U < 2 || C <= 0 || D <= 0 || T > 65535 || S > (int64_t)0x7FFFFFFF * kThreads ||
        N > (int64_t)0x7FFFFFFF * kThreads || B > (int64_t)0x7FFFFFFF * kWarpsPerBlock)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(uids, 0xFF, (size_t)(T * U) * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(counts, 0, (size_t)(T * U) * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    const int32_t* sc = static_cast<const int32_t*>(scratch);
    const int32_t* rk = static_cast<const int32_t*>(rank);
    uids_kernel<<<dim3(blocks_for(S), (unsigned int)T), kThreads, 0, s>>>(
        sc, rk, static_cast<int32_t*>(uids), S, U);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    inverse_kernel<<<dim3(blocks_for(N), (unsigned int)T), kThreads, 0, s>>>(
        static_cast<const int32_t*>(slotpos), rk, static_cast<int32_t*>(inverse),
        static_cast<int32_t*>(counts), static_cast<int32_t*>(overflow), N, S, U);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int32_t* id = static_cast<const int32_t*>(ids);
    const int32_t* inv = static_cast<const int32_t*>(inverse);
    float* o = static_cast<float*>(out);
    err = bf16 ? launch_combine<__nv_bfloat16>(values, id, inv, o, T, B, L, C, D, s)
               : launch_combine<float>(values, id, inv, o, T, B, L, C, D, s);
    return (int)err;
}
