// Table-driven row gather for Hopper (sm_90a).
//
// Replaces repro/kernels/moe_gather.py::row_gather_pallas, the TPU
// scalar-prefetch kernel that DMAs one (1, block_d) tile of a source row per
// grid step.
//
//   src (T, d)    token or expert rows, any 2- or 4-byte dtype
//   idx (M,)      int32 source row per output row; < 0 marks an empty row
//   inv (T*K,)    optional int32 inverse of idx: the K output rows source
//                 row t goes to are inv[t*K .. t*K+K), -1 where there is none
//   out (M, d)
//
// out[i] = src[min(idx[i], T-1)], or zeros where idx[i] < 0 — the semantics
// of row_gather_ref (jnp gathers clamp out-of-range ids). The MoE layer runs
// it twice: the dispatch moves token rows into the expert-capacity buffer
// (empty capacity slots are zero rows), the combine moves expert outputs back
// to (token, k) order (dropped assignments are zero rows).
//
// Bound: HBM bytes. No arithmetic: each distinct source row is read once and
// every output row is written once. At the mixtral-8x22b prefill dispatch of
// 8 groups of 1,024 tokens (T = 8,192, M = 20,480, d = 6,144 bf16, top-2,
// capacity factor 1.25) that is ~352 MB, 0.105 ms at 3.35 TB/s.
//
// Two routes, one launch each:
//  * gather (no inv): one block per output row reads its source row. At
//    top-2 every kept token row is then read twice, once for each expert
//    slot, so the gather moves (valid rows + M) * row_bytes (~453 MB at the
//    dispatch above), as index_select does; it reached 88% of 3.35 TB/s on
//    those bytes and could not get under index_select's time;
//  * read-once (inv given; the dispatch): blocks [0, T) each read source
//    row b once and store it to each of its K slots (its first 4 slots
//    loaded together, before the row); blocks [T, T + ceil(M / 2)) each
//    zero-fill the rows of their pair whose idx is negative (their source
//    is never read). That moves the bound's bytes. inv must be idx's
//    inverse (every i with idx[i] >= 0 is named once, at a position t*K + k
//    with t = idx[i], and no other i is named), as dispatch_tables' comb is
//    for its disp. The kernel does not check it: with another table the
//    output is undefined (a slot no entry names is never written; a slot
//    named for a negative idx gets a copy block's and a zero-fill block's
//    stores in no fixed order). A slot outside [0, M) is skipped, so no
//    table makes it write outside out.
//    The wrapper takes this route only where it spares >= 16 MiB of reads:
//    below that the gather's second reads come from the 50 MB L2 and its
//    blocks (one read, one store) beat these (one read, K stores) — at the
//    decode and 64-token prefill dispatches by ~0.3 us on an H100 SXM.
// Both: the op is a byte copy, so the kernel is dtype-agnostic: it moves
// 16-byte vectors (int4); the wrapper requires a row to be a multiple of 16
// bytes and 16-byte aligned base pointers (d = 6,144 bf16 is 768 vectors).
// grid.y cuts a row into 16 KiB chunks, 256 threads a block; each thread
// issues all of its loads before any store (up to 4 x 16 B in flight),
// neighbouring threads on neighbouring addresses, so every warp access is
// four fully used 128-byte lines. Offsets are 64-bit: T * row_bytes can
// exceed 2^31. Every output row is written by one block, so two launches
// give equal bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr long long kChunkVecs = (long long)kThreads * kVecPerThread;  // 16 KiB
constexpr int kSlotRegs = 4;  // slots of a source row held in registers
constexpr int kZeroRows = 2;  // output rows a zero-fill block checks

__device__ __forceinline__ void zero_chunk(int4* dst, long long base,
                                           long long row_vecs) {
  const int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int v = 0; v < kVecPerThread; ++v) {
    const long long e = base + (long long)v * kThreads;
    if (e < row_vecs) dst[e] = z;
  }
}

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
    zero_chunk(dst, base, row_vecs);
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

// Blocks [0, T): source row b to its slots inv[b*K ..]. Blocks [T, T + Z),
// Z = ceil(M / kZeroRows): zeros into the rows of their range whose idx is
// negative. A block does one job, so no block's share of the bytes is
// larger than a copy's (a short table's time is its slowest block).
__global__ void __launch_bounds__(kThreads)
row_gather_kernel_inv(const int4* __restrict__ src,
                      const int32_t* __restrict__ idx,
                      const int32_t* __restrict__ inv,
                      int4* __restrict__ out,
                      long long num_out_rows,
                      long long num_src_rows,
                      int k_slots,
                      long long row_vecs) {
  const long long b = blockIdx.x;
  const long long base = (long long)blockIdx.y * kChunkVecs + threadIdx.x;
  if (b >= num_src_rows) {
    // the range's ids are read together: one load latency
    const long long i0 = (b - num_src_rows) * kZeroRows;
    int32_t ids[kZeroRows];
#pragma unroll
    for (int r = 0; r < kZeroRows; ++r) {
      ids[r] = i0 + r < num_out_rows ? __ldg(idx + i0 + r) : 0;
    }
#pragma unroll
    for (int r = 0; r < kZeroRows; ++r) {
      if (ids[r] < 0) zero_chunk(out + (i0 + r) * row_vecs, base, row_vecs);
    }
    return;
  }

  // the first kSlotRegs slots are read together (one load latency, as the
  // gather's one id); a row with more slots reads the rest in turn
  const int32_t* slots = inv + b * k_slots;
  int32_t sl[kSlotRegs];
#pragma unroll
  for (int k = 0; k < kSlotRegs; ++k) {
    sl[k] = k < k_slots ? __ldg(slots + k) : -1;
  }
  auto kept = [&](int32_t s) { return s >= 0 && s < num_out_rows; };
  bool any = false;
#pragma unroll
  for (int k = 0; k < kSlotRegs; ++k) any |= kept(sl[k]);
  for (int k = kSlotRegs; k < k_slots; ++k) any |= kept(__ldg(slots + k));
  if (!any) return;  // a row whose every assignment was dropped is not read
  const int4* from = src + b * row_vecs;
  int4 r[kVecPerThread];
#pragma unroll
  for (int v = 0; v < kVecPerThread; ++v) {
    const long long e = base + (long long)v * kThreads;
    r[v] = e < row_vecs ? __ldg(from + e) : make_int4(0, 0, 0, 0);
  }
  auto store = [&](int32_t s) {
    int4* dst = out + (long long)s * row_vecs;
#pragma unroll
    for (int v = 0; v < kVecPerThread; ++v) {
      const long long e = base + (long long)v * kThreads;
      if (e < row_vecs) dst[e] = r[v];
    }
  };
#pragma unroll
  for (int k = 0; k < kSlotRegs; ++k) {
    if (kept(sl[k])) store(sl[k]);
  }
  for (int k = kSlotRegs; k < k_slots; ++k) {
    const int32_t s = __ldg(slots + k);
    if (kept(s)) store(s);
  }
}

}  // namespace

// C entry point, bound with ctypes. inv == nullptr takes the gather route,
// else the read-once route with k_slots = inv's length / num_src_rows.
// Launches on `stream` (PyTorch's current stream), does not synchronise,
// and returns cudaGetLastError() so that a refused launch is reported to
// the caller.
extern "C" int row_gather_launch(const void* src, const void* idx,
                                 const void* inv, void* out,
                                 long long num_out_rows,
                                 long long num_src_rows, int k_slots,
                                 long long row_bytes, void* stream) {
  if (num_out_rows == 0 || row_bytes == 0) return 0;
  const long long row_vecs = row_bytes / 16;
  const long long chunks = (row_vecs + kChunkVecs - 1) / kChunkVecs;
  const long long blocks =
      inv == nullptr
          ? num_out_rows
          : num_src_rows + (num_out_rows + kZeroRows - 1) / kZeroRows;
  if (num_out_rows > 0x7fffffffLL || blocks > 0x7fffffffLL ||
      chunks > 65535 || num_src_rows < 1 || row_bytes % 16 != 0 ||
      (inv != nullptr && k_slots < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)blocks, (unsigned)chunks);
  cudaStream_t s = (cudaStream_t)stream;
  if (inv == nullptr) {
    row_gather_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const int4*>(src), static_cast<const int32_t*>(idx),
        static_cast<int4*>(out), num_src_rows, row_vecs);
  } else {
    row_gather_kernel_inv<<<grid, kThreads, 0, s>>>(
        static_cast<const int4*>(src), static_cast<const int32_t*>(idx),
        static_cast<const int32_t*>(inv), static_cast<int4*>(out),
        num_out_rows, num_src_rows, k_slots, row_vecs);
  }
  return (int)cudaGetLastError();
}
