// Table-driven row gather for Hopper (sm_90a).
//
// Replaces repro/kernels/moe_gather.py::row_gather_pallas, the TPU
// scalar-prefetch kernel that DMAs one (1, block_d) tile of a source row per
// grid step.
//
//   src (T, d)    token or expert rows, any 2- or 4-byte dtype
//   idx (M,)      int32 source row per output row; < 0 marks an empty row
//   out (M, d)
//
// out[i] = src[min(idx[i], T-1)], or zeros where idx[i] < 0 — the semantics
// of row_gather_ref (jnp gathers clamp out-of-range ids). The MoE layer runs
// it twice: the dispatch moves token rows into the expert-capacity buffer
// (empty capacity slots are zero rows), the combine moves expert outputs back
// to (token, k) order (dropped assignments are zero rows).
//
// Bound: HBM bytes. No arithmetic: every valid output row reads its source
// row once and every output row is written once, so the op moves
// (valid rows + M) * row_bytes + 4 M bytes. At the mixtral-8x22b prefill
// dispatch of 8 groups of 1,024 tokens (T = 8,192, M = 20,480, d = 6,144
// bf16, 80% valid) that is ~453 MB, ~0.135 ms at 3.35 TB/s.
//
// Design against that bound:
//  * the op is a byte copy, so the kernel is dtype-agnostic: it moves 16-byte
//    vectors (int4); the wrapper requires a row to be a multiple of 16 bytes
//    and 16-byte aligned base pointers (d = 6,144 bf16 is 768 vectors);
//  * grid = (output rows, 16 KiB chunks of a row), 256 threads a block: one
//    block per output row at d <= 8,192 bf16, no (1, block_d) tiling;
//  * each thread issues all of its loads before any store (up to 4 x 16 B in
//    flight), neighbouring threads on neighbouring addresses, so every warp
//    access is four fully used 128-byte lines;
//  * offsets are 64-bit: T * row_bytes can exceed 2^31;
//  * the row's id is read once per block; an empty row is written with zeros
//    and its source is never touched.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr long long kChunkVecs = (long long)kThreads * kVecPerThread;  // 16 KiB

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int4* __restrict__ src,
                  const int32_t* __restrict__ idx,
                  int4* __restrict__ out,
                  long long num_src_rows,
                  long long row_vecs) {
  const long long i = blockIdx.x;  // output row
  const int32_t raw = __ldg(idx + i);
  const long long base = (long long)blockIdx.y * kChunkVecs + threadIdx.x;
  int4* dst = out + i * row_vecs;

  if (raw < 0) {
    const int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int v = 0; v < kVecPerThread; ++v) {
      const long long e = base + (long long)v * kThreads;
      if (e < row_vecs) dst[e] = z;
    }
    return;
  }

  const long long row = raw < num_src_rows ? raw : num_src_rows - 1;
  const int4* from = src + row * row_vecs;
  int4 r[kVecPerThread];
#pragma unroll
  for (int v = 0; v < kVecPerThread; ++v) {
    const long long e = base + (long long)v * kThreads;
    r[v] = e < row_vecs ? __ldg(from + e) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int v = 0; v < kVecPerThread; ++v) {
    const long long e = base + (long long)v * kThreads;
    if (e < row_vecs) dst[e] = r[v];
  }
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" int row_gather_launch(const void* src, const void* idx, void* out,
                                 long long num_out_rows,
                                 long long num_src_rows, long long row_bytes,
                                 void* stream) {
  if (num_out_rows == 0 || row_bytes == 0) return 0;
  const long long row_vecs = row_bytes / 16;
  const long long chunks = (row_vecs + kChunkVecs - 1) / kChunkVecs;
  if (num_out_rows > 0x7fffffffLL || chunks > 65535 || num_src_rows < 1 ||
      row_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)num_out_rows, (unsigned)chunks);
  row_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int4*>(src), static_cast<const int32_t*>(idx),
      static_cast<int4*>(out), num_src_rows, row_vecs);
  return (int)cudaGetLastError();
}
