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
// order. On Hopper the grid runs in parallel; the work is one memset and
// two launches, with nothing between them:
//   0. one cudaMemsetAsync fills the workspace's keys and its two per-table
//      counters with 0xFF bytes (-1);
//   1. probe: one thread per position claims its id in a scratch table of
//      S = scratch_size(N) int32 keys per table (-1 = empty) with
//      atomicCAS: the hash mix32(fold64(id)), linear probing and the probe
//      bound of ops/dedup.py::hash_dedup (the lanes of a warp that hold one
//      id probe once); an unresolved position counts as overflow. The
//      thread whose CAS claims a slot takes the table's next
//      rank from a counter that starts at -1 (the claims of one CTA take
//      one atomicAdd), so the first claim gets rank 1; it stores the
//      rank beside the slot and, when the rank is below U, writes
//      uids[rank] = id and counts[rank] = 0. Ranks follow CLAIM order, as
//      the TPU kernel's do (first-occurrence order there): the ORDER of
//      uids, and under overflow the SET of budgeted ids, follow the claim
//      race. The overflow COUNT is exact: claimed - (U - 1), plus the
//      unresolved probes;
//   2. bags: one warp per bag. Each lane resolves its position's rank
//      (inverse: the rank where it is below U, else 0), adds it to counts
//      (warp-aggregated integer atomics, exact in any order), and the warp
//      sums the budgeted positions' rows in l order in f32. Pads and
//      overflow positions load no row: the sum starts at +0 and never
//      holds -0, so skipping a +0 add keeps every bit. The same launch
//      fills uids with -1 and counts with 0 at slot 0 and past the claimed
//      ranks, and writes overflow.
// No [U, D] buffer: a repeated row hits L2.
//
// What bounds it: at the main path's shapes, the bag launch's dependent
// row loads (one warp per bag, L positions in order), and bytes: the ids
// (4 B each, read by both launches), the scratch keys and ranks (4 B x S
// each, mostly L2-resident), each budgeted position's row (the unique rows
// come from device memory once, repeats from L2) and out written. The
// design answers launch overhead with one memset and two launches per call
// (the previous design issued about ten device operations and a cumsum
// over the whole scratch table between them), and the row latency with a
// batch of four independent row loads in flight per warp. Rows move as
// 16-byte vectors per lane (8-byte for bf16) when D % 4 == 0 and the base
// is aligned, else one element per lane.
//
// Sums: nvcc is told not to contract (-fmad=false) and the adds use
// __fadd_rn, so the order and rounding are exactly the plain version's
// (out = 0; out = out + row for the budgeted l = 0..L-1).
//
// Offsets are 64-bit: a stacked bundle holds over 2^31 elements. The
// launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kBatch = 4;  // row loads in flight per warp

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

// The workspace of one call, int32: keys [T, S] and the counters claimed
// [T] and unresolved [T] (all -1 after the memset), then ranks [T, S] and
// slotpos [T, N], which the probe writes before anything reads them.
struct Work {
    int32_t* keys;
    int32_t* claimed;     // claimed distinct ids - 1
    int32_t* unresolved;  // unresolved positions - 1
    int32_t* ranks;
    int32_t* slotpos;     // the position's scratch slot, -1 for pad or unresolved
};

__global__ void __launch_bounds__(kThreads)
probe_kernel(const int32_t* __restrict__ ids, Work w, int32_t* __restrict__ uids,
             int32_t* __restrict__ counts, int64_t N, int64_t S, int64_t U, int max_probes) {
    __shared__ int32_t claims, first;
    const int64_t n = int64_t(blockIdx.x) * kThreads + threadIdx.x;
    const int64_t t = blockIdx.y;
    if (threadIdx.x == 0) claims = 0;
    __syncthreads();
    const int32_t id = n < N ? ids[t * N + n] : -1;
    // the lanes of one id probe once, by their lowest lane: a zipf head id
    // would otherwise send thousands of CASes to one address
    const int lane = threadIdx.x & 31;
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, id);
    const int leader = __ffs(peers) - 1;
    int32_t slot = -1;
    bool won = false;
    if (id >= 0 && lane == leader) {
        int32_t* tab = w.keys + t * S;
        const uint32_t h = mix32((uint32_t)id);  // fold64 of an int32 id
        const uint32_t mask = (uint32_t)(S - 1);
        for (int p = 0; p < max_probes; ++p) {
            const uint32_t pos = (h + (uint32_t)p) & mask;
            // a written key never changes, so a non-empty read is final;
            // an empty read may be stale and the CAS settles it
            int32_t k = tab[pos];
            if (k == -1) {
                k = atomicCAS(tab + pos, -1, id);
                won = k == -1;
            }
            if (k == -1 || k == id) {
                slot = (int32_t)pos;
                break;
            }
        }
        if (slot < 0) atomicAdd(w.unresolved + t, __popc(peers));
    }
    slot = __shfl_sync(0xFFFFFFFFu, slot, leader);
    // the CTA's claims take one atomicAdd on the table's counter
    const int32_t mine = won ? atomicAdd(&claims, 1) : 0;
    __syncthreads();
    if (threadIdx.x == 0 && claims > 0) first = atomicAdd(w.claimed + t, claims);
    __syncthreads();
    if (won) {
        const int32_t rank = first + 2 + mine;  // the table's first claim: 1
        w.ranks[t * S + slot] = rank;
        if (rank < U) {
            uids[t * U + rank] = id;
            counts[t * U + rank] = 0;
        }
    }
    if (n < N) w.slotpos[t * N + n] = slot;
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
// the bag's positions come in 32 at a time, one per lane (its clipped row
// and its rank), and are broadcast by shuffles. Every lane of a warp runs
// the same loops, so the full-mask shuffles are always executed whole.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
bags_kernel(const T* __restrict__ values, const int32_t* __restrict__ ids, Work w,
            float* __restrict__ out, int32_t* __restrict__ uids, int32_t* __restrict__ inverse,
            int32_t* __restrict__ counts, int32_t* __restrict__ overflow, int64_t B, int64_t L,
            int64_t C, int64_t D, int64_t S, int64_t U) {
    const int64_t t = blockIdx.y;
    const int64_t claimed = (int64_t)w.claimed[t] + 1;
    // slot 0 and the ranks nobody claimed: the sentinel and zero counts
    for (int64_t u = int64_t(blockIdx.x) * kThreads + threadIdx.x; u < U;
         u += int64_t(gridDim.x) * kThreads) {
        if (u == 0 || u > claimed) {
            uids[t * U + u] = -1;
            counts[t * U + u] = 0;
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        const int64_t past = claimed > U - 1 ? claimed - (U - 1) : 0;
        overflow[t] = (int32_t)(past + (int64_t)w.unresolved[t] + 1);
    }
    const int64_t bag = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (bag >= B) return;
    const int lane = threadIdx.x & 31;
    const int64_t N = B * L;
    const int64_t row0 = bag * L;
    const T* table = values + t * C * D;
    const int32_t* ranks = w.ranks + t * S;
    float* o = out + (t * B + bag) * D;
    const int64_t width = VEC ? D / 4 : D;
    for (int64_t c0 = 0; c0 < width; c0 += 32) {
        const int64_t c = c0 + lane;
        const bool col = c < width;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int64_t l0 = 0; l0 < L; l0 += 32) {
            int32_t my_row = 0, my_inv = 0;
            if (l0 + lane < L) {
                const int64_t n = t * N + row0 + l0 + lane;
                const int32_t id = ids[n];
                my_row = id < 0 ? 0 : (id >= C ? (int32_t)(C - 1) : id);
                const int32_t slot = w.slotpos[n];
                if (slot >= 0) {
                    const int32_t r = ranks[slot];
                    my_inv = r < U ? r : 0;
                }
                if (c0 == 0) inverse[n] = my_inv;
            }
            if (c0 == 0) {  // counts: one atomic per distinct rank in the warp
                const unsigned peers = __match_any_sync(0xFFFFFFFFu, my_inv);
                if (my_inv > 0 && lane == __ffs(peers) - 1)
                    atomicAdd(counts + t * U + my_inv, __popc(peers));
            }
            const int n = L - l0 < 32 ? (int)(L - l0) : 32;
            for (int k0 = 0; k0 < n; k0 += kBatch) {
                float4 x[kBatch] = {};
                bool on[kBatch];
#pragma unroll
                for (int j = 0; j < kBatch; ++j) {
                    const int k = k0 + j < n ? k0 + j : 0;
                    const int64_t r = __shfl_sync(0xFFFFFFFFu, my_row, k);
                    const int32_t iv = __shfl_sync(0xFFFFFFFFu, my_inv, k);
                    on[j] = col && k0 + j < n && iv > 0;
                    if (on[j]) {
                        if (VEC) {
                            x[j] = load4(table + r * D + 4 * c);
                        } else {
                            x[j].x = load1(table + r * D + c);
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < kBatch; ++j) {
                    if (!on[j]) continue;
                    acc.x = __fadd_rn(acc.x, x[j].x);
                    if (VEC) {
                        acc.y = __fadd_rn(acc.y, x[j].y);
                        acc.z = __fadd_rn(acc.z, x[j].z);
                        acc.w = __fadd_rn(acc.w, x[j].w);
                    }
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
cudaError_t launch_bags(const void* values, const int32_t* ids, const Work& w, float* out,
                        int32_t* uids, int32_t* inverse, int32_t* counts, int32_t* overflow,
                        int64_t T_, int64_t B, int64_t L, int64_t C, int64_t D, int64_t S,
                        int64_t U, cudaStream_t stream) {
    const dim3 grid((unsigned int)((B + kWarpsPerBlock - 1) / kWarpsPerBlock), (unsigned int)T_);
    const uint64_t align = (uint64_t)(uintptr_t)values | (uint64_t)(uintptr_t)out;
    const bool vec = D % 4 == 0 && align % 16 == 0;
    const T* v = static_cast<const T*>(values);
    if (vec) {
        bags_kernel<T, true><<<grid, kThreads, 0, stream>>>(v, ids, w, out, uids, inverse, counts,
                                                           overflow, B, L, C, D, S, U);
    } else {
        bags_kernel<T, false><<<grid, kThreads, 0, stream>>>(v, ids, w, out, uids, inverse, counts,
                                                            overflow, B, L, C, D, S, U);
    }
    return cudaGetLastError();
}

}  // namespace

// The whole forward on the caller's stream: one memset and two launches.
// values [T, C, D] (f32, or bf16 when bf16 != 0); ids [T, B*L] int32;
// work: int32 workspace of 2 T S + T N + 2 T elements (its contents on
// entry do not matter); out [T, B, D] f32, uids [T, U], inverse [T, B*L],
// counts [T, U] and overflow [T] int32 are written whole. S is
// scratch_size(B*L), a power of two.
extern "C" int fused_sparse_forward_launch(const void* values, const void* ids, void* work,
                                           void* out, void* uids, void* inverse, void* counts,
                                           void* overflow, long long T, long long B,
                                           long long L, long long C, long long D, long long S,
                                           long long U, int max_probes, int bf16,
                                           void* stream) {
    const int64_t N = (int64_t)B * (int64_t)L;
    if (T <= 0 || N <= 0) return 0;
    if (U < 2 || C <= 0 || D <= 0 || T > 65535 || S <= 0 || (S & (S - 1)) != 0 ||
        S > (1LL << 31) || N > 0x7FFFFFFFLL || U > 0x7FFFFFFFLL ||
        B > (int64_t)0x7FFFFFFF * kWarpsPerBlock)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int32_t* base = static_cast<int32_t*>(work);
    Work w{base, base + T * S, base + T * S + T, base + T * S + 2 * T, base + 2 * T * S + 2 * T};
    cudaError_t err = cudaMemsetAsync(base, 0xFF, (size_t)(T * S + 2 * T) * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    const int32_t* id = static_cast<const int32_t*>(ids);
    int32_t* ui = static_cast<int32_t*>(uids);
    int32_t* ct = static_cast<int32_t*>(counts);
    probe_kernel<<<dim3((unsigned int)((N + kThreads - 1) / kThreads), (unsigned int)T), kThreads,
                   0, s>>>(id, w, ui, ct, N, S, U, max_probes);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    float* o = static_cast<float*>(out);
    int32_t* inv = static_cast<int32_t*>(inverse);
    int32_t* ov = static_cast<int32_t*>(overflow);
    err = bf16 ? launch_bags<__nv_bfloat16>(values, id, w, o, ui, inv, ct, ov, T, B, L, C, D, S, U, s)
               : launch_bags<float>(values, id, w, o, ui, inv, ct, ov, T, B, L, C, D, S, U, s);
    return (int)err;
}
