// apply_rows_sr for Hopper (sm_90a): in place, for every (t, u) with
// 0 <= slot_ix[t, u] < C,
//     values[t, slot_ix[t, u], :] = SR(rows[t, u, :])
// where SR is the identity for a float32 table and stochastic rounding to
// bfloat16 for a bf16 table: add the low 16 bits of bits[t, u, e] to the
// float32 bit pattern, keep the high 16 bits.
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/fused_lookup.py::apply_rows_sr
// (every row write of training: the initializer scatter of new keys,
// embedding/table.py _resolve, and the value and optimizer-slot write-back,
// optim/apply.py apply_gradients). The TPU kernel walks the rows in order
// through a 2-slot VMEM buffer, one DMA per row, because a TPU core runs its
// grid in order. Valid slot indices are unique (the caller contract of
// ops/packed.py scatter_rows_any), so on Hopper every row is independent:
// one warp per row, no atomics, no shared memory.
//
// What bounds it: bytes. Each written row is one f32 row read (plus, for
// bf16, one row of 32-bit random bits) and one row written, plus 4 bytes of
// slot index per row, against 3.35 TB/s of device memory; it does one
// integer add and mask per element. Rows move as 16-byte vectors (float4, and
// uint4 of bits) when D % 4 == 0 and the bases are aligned; bf16 rows then
// store 8 bytes per vector. Odd widths (D = 1, 3, 7) take the scalar loop.
// The f32 branch never reads the bits.
//
// Layout: values [T, C, D] (f32 or bf16), slot_ix [T, U] int32, rows
// [T, U, D] f32, bits [T, U, D] 32-bit (bf16 only), all contiguous. Offsets
// are 64-bit: a full-width table stack holds 3.5e9 elements. Skipped rows
// (slot < 0, or past the end of the table) touch nothing.
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t sr_bf16(float x, uint32_t bits) {
    uint32_t u = __float_as_uint(x);
    u += bits & 0xFFFFu;  // a carry rounds up into the kept mantissa
    return u >> 16;       // truncate to the bf16 pattern
}

template <bool SR, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
apply_rows_sr_kernel(void* __restrict__ values, const int32_t* __restrict__ slot_ix,
                     const float* __restrict__ rows, const uint32_t* __restrict__ bits,
                     int64_t C, int64_t U, int64_t D, int64_t nrows) {
    const int64_t row = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= nrows) return;
    const int64_t slot = slot_ix[row];
    if (slot < 0 || slot >= C) return;
    const int lane = threadIdx.x & 31;
    const int64_t dst = ((row / U) * C + slot) * D;  // element offset in values
    const int64_t src = row * D;                     // element offset in rows, bits
    if (VEC) {
        const float4* r4 = reinterpret_cast<const float4*>(rows + src);
        const int64_t nvec = D >> 2;
        if (SR) {
            const uint4* b4 = reinterpret_cast<const uint4*>(bits + src);
            uint2* out = reinterpret_cast<uint2*>(static_cast<uint16_t*>(values) + dst);
            for (int64_t v = lane; v < nvec; v += 32) {
                const float4 x = __ldg(r4 + v);
                const uint4 b = __ldg(b4 + v);
                uint2 o;
                o.x = sr_bf16(x.x, b.x) | (sr_bf16(x.y, b.y) << 16);
                o.y = sr_bf16(x.z, b.z) | (sr_bf16(x.w, b.w) << 16);
                out[v] = o;
            }
        } else {
            float4* out = reinterpret_cast<float4*>(static_cast<float*>(values) + dst);
            for (int64_t v = lane; v < nvec; v += 32) out[v] = __ldg(r4 + v);
        }
    } else {
        for (int64_t e = lane; e < D; e += 32) {
            const float x = __ldg(rows + src + e);
            if (SR) {
                static_cast<uint16_t*>(values)[dst + e] =
                    (uint16_t)sr_bf16(x, __ldg(bits + src + e));
            } else {
                static_cast<float*>(values)[dst + e] = x;
            }
        }
    }
}

template <bool SR, bool VEC>
cudaError_t launch(void* values, const void* slot_ix, const void* rows, const void* bits,
                   int64_t C, int64_t U, int64_t D, int64_t nrows, cudaStream_t stream) {
    const int64_t blocks = (nrows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    apply_rows_sr_kernel<SR, VEC><<<(unsigned int)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        values, static_cast<const int32_t*>(slot_ix), static_cast<const float*>(rows),
        static_cast<const uint32_t*>(bits), C, U, D, nrows);
    return cudaGetLastError();
}

}  // namespace

extern "C" int apply_rows_sr_launch(void* values, const void* slot_ix, const void* rows,
                                    const void* bits, long long T, long long C,
                                    long long U, long long D, int bf16, void* stream) {
    const int64_t nrows = (int64_t)T * (int64_t)U;
    if (nrows <= 0 || D <= 0) return 0;
    if (nrows > (int64_t)0x7FFFFFFF * kWarpsPerBlock) return (int)cudaErrorInvalidValue;
    if (bf16 && bits == nullptr) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // 16-byte vectors need D % 4 == 0 and aligned bases: rows and bits 16 B,
    // values 16 B (f32 stores) or 8 B (bf16 stores of 4 elements).
    const uint64_t in_align = (uint64_t)(uintptr_t)rows | (uint64_t)(uintptr_t)bits;
    const uint64_t out_align = (uint64_t)(uintptr_t)values;
    const bool vec = D % 4 == 0 && in_align % 16 == 0 && out_align % (bf16 ? 8 : 16) == 0;
    cudaError_t err;
    if (bf16) {
        err = vec ? launch<true, true>(values, slot_ix, rows, bits, C, U, D, nrows, s)
                  : launch<true, false>(values, slot_ix, rows, bits, C, U, D, nrows, s);
    } else {
        err = vec ? launch<false, true>(values, slot_ix, rows, bits, C, U, D, nrows, s)
                  : launch<false, false>(values, slot_ix, rows, bits, C, U, D, nrows, s);
    }
    return (int)err;
}
