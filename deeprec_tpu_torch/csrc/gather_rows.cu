// gather_rows for Hopper (sm_90a): out[t, i, :] = values[t, clip(ix[t, i], 0, C-1), :]
//
// Replaces the Pallas TPU kernel deeprec_tpu/ops/fused_lookup.py::gather_rows
// (the row gather behind every serving lookup, embedding/table.py
// _finish_resolved). The TPU kernel streams one row per DMA through a 2-deep
// VMEM pipeline because a TPU core walks its grid in order; here every row is
// independent, so the design is one warp per output row and as many rows in
// flight as the card can hold.
//
// What bounds it: bytes. Each output row is one random row read plus one
// sequential row write, about 2 * T * n * D * itemsize bytes (plus 4 bytes of
// index per row) against 3.35 TB/s of device memory; it does no arithmetic.
// The design moves each row with 16-byte vector copies when the row's byte
// width is a multiple of 16 (f32 at D % 4 == 0, bf16 at D % 8 == 0), and
// 4- or 2-byte copies otherwise. The copy is dtype-blind, so the result is
// bit-exact for f32 and bf16 alike.
//
// Layout: values [T, C, D] and ix [T, n] (int32) and out [T, n, D], all
// contiguous. Each index is clipped to [0, C-1] within its own table BEFORE
// the t * C offset is added (the JAX clip semantics, fused_lookup.py:384).
// Offsets are 64-bit: a full-width table stack holds more than 2^31 elements.
//
// The launcher runs on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so a refused launch is seen.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename Vec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_kernel(const Vec* __restrict__ values, const int32_t* __restrict__ ix,
                   Vec* __restrict__ out, int64_t C, int64_t n, int64_t rows,
                   int64_t vecs_per_row) {
    const int64_t row = int64_t(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int lane = threadIdx.x & 31;
    const int64_t t = row / n;
    int64_t r = ix[row];
    r = r < 0 ? 0 : (r >= C ? C - 1 : r);
    const Vec* src = values + (t * C + r) * vecs_per_row;
    Vec* dst = out + row * vecs_per_row;
    for (int64_t v = lane; v < vecs_per_row; v += 32) {
        dst[v] = __ldg(src + v);
    }
}

template <typename Vec>
cudaError_t launch(const void* values, const void* ix, void* out, int64_t C,
                   int64_t n, int64_t rows, int64_t row_bytes, cudaStream_t stream) {
    const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    gather_rows_kernel<Vec><<<(unsigned int)blocks, kWarpsPerBlock * 32, 0, stream>>>(
        static_cast<const Vec*>(values), static_cast<const int32_t*>(ix),
        static_cast<Vec*>(out), C, n, rows, row_bytes / (int64_t)sizeof(Vec));
    return cudaGetLastError();
}

}  // namespace

extern "C" int gather_rows_launch(const void* values, const void* ix, void* out,
                                  long long T, long long C, long long n,
                                  long long row_bytes, void* stream) {
    const int64_t rows = (int64_t)T * (int64_t)n;
    if (rows <= 0 || row_bytes <= 0) return 0;
    if (rows > (int64_t)0x7FFFFFFF * kWarpsPerBlock) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // The widest copy that divides the row and both base addresses (a view
    // into a larger tensor may start at any element boundary).
    const uint64_t align = (uint64_t)row_bytes | (uint64_t)(uintptr_t)values |
                           (uint64_t)(uintptr_t)out;
    cudaError_t err;
    if (align % 16 == 0) {
        err = launch<int4>(values, ix, out, C, n, rows, row_bytes, s);
    } else if (align % 4 == 0) {
        err = launch<int32_t>(values, ix, out, C, n, rows, row_bytes, s);
    } else if (align % 2 == 0) {
        err = launch<int16_t>(values, ix, out, C, n, rows, row_bytes, s);
    } else {
        err = launch<int8_t>(values, ix, out, C, n, rows, row_bytes, s);
    }
    return (int)err;
}
