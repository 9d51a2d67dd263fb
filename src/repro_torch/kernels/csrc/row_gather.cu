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
//
// The gather-sum (row_gather_sum_launch), the gather's backward given its
// inverse table. It replaces no TPU kernel: row_gather_pallas has no
// backward, and the reference differentiates its take_along_axis and
// scatter through XLA. Here the plain backward would be a scatter-add;
// since inv names each source row's K output rows, every row of the
// gradient is instead one block's sum of its own K rows: no atomics, and
// a fixed order, so two launches give equal bits.
//
//   src (M, d)    the gather's output gradient
//   inv (T*K,)    int32, -1 where an entry is empty
//   out (T, d)    out[t] = sum_{k<K} src[inv[t*K+k]] over the entries
//                 >= 0 (an entry past M-1 reads row M-1, as the gather's
//                 ids clamp); a row with no entry is zero
//
// The MoE dispatch's backward is the gather-sum at K = top_k over comb
// (a token's gradient is the sum of its capacity slots'); the combine's
// has K = 1, a copy, which the wrapper runs on the gather kernel above.
// It sums in f32 in k order and rounds each element once to the row
// dtype (f32, bf16 or f16): at K = 2, 0 + a is exact and a + b rounds
// once, so it equals a scatter-add into zeros in the row dtype bit for
// bit. Bound: HBM bytes: each valid entry's row read once (no slot is
// named twice), every output row written once, inv read once; at the
// mixtral-8x22b training dispatch (8 groups of 1,024 tokens, d = 6,144
// bf16, top-2, cf 1.25) <= 16,384 rows read and 8,192 written, ~302 MB,
// 0.090 ms at 3.35 TB/s. Layout as the gather: grid.x an output row,
// grid.y its 16 KiB chunks, 256 threads, 16-byte vectors; the rows of up
// to 4 entries are loaded together before any is summed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// Row dtypes of the gather-sum (the codes of row_gather_sum_launch): each
// unpacks a 16-byte vector into f32 sums and packs the sums back, rounding
// to nearest even.
enum { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int D>
struct Vec;

template <>
struct Vec<kF32> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void add(float* acc, int4 v) {
    acc[0] += __int_as_float(v.x);
    acc[1] += __int_as_float(v.y);
    acc[2] += __int_as_float(v.z);
    acc[3] += __int_as_float(v.w);
  }
  __device__ __forceinline__ static int4 pack(const float* acc) {
    return make_int4(__float_as_int(acc[0]), __float_as_int(acc[1]),
                     __float_as_int(acc[2]), __float_as_int(acc[3]));
  }
};

// two 16-bit values a 32-bit word, the lower one first
template <int D>
struct Vec16 {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static float to_f32(uint32_t h) {
    if (D == kBF16) return __uint_as_float(h << 16);
    return __half2float(__ushort_as_half((unsigned short)h));
  }
  __device__ __forceinline__ static uint32_t from_f32(float f) {
    if (D == kBF16) return __bfloat16_as_ushort(__float2bfloat16_rn(f));
    return __half_as_ushort(__float2half_rn(f));
  }
  __device__ __forceinline__ static void add(float* acc, int4 v) {
    const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                           (uint32_t)v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += to_f32(w[i] & 0xffffu);
      acc[2 * i + 1] += to_f32(w[i] >> 16);
    }
  }
  __device__ __forceinline__ static int4 pack(const float* acc) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = from_f32(acc[2 * i]) | (from_f32(acc[2 * i + 1]) << 16);
    }
    return make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
};

template <>
struct Vec<kBF16> : Vec16<kBF16> {};
template <>
struct Vec<kF16> : Vec16<kF16> {};

template <int D>
__global__ void __launch_bounds__(kThreads)
row_gather_sum_kernel(const int4* __restrict__ src,
                      const int32_t* __restrict__ inv,
                      int4* __restrict__ out,
                      long long num_src_rows,
                      int k_slots,
                      long long row_vecs) {
  using V = Vec<D>;
  const long long t = blockIdx.x;  // output row
  const long long base = (long long)blockIdx.y * kChunkVecs + threadIdx.x;
  const int32_t* slots = inv + t * k_slots;
  float acc[kVecPerThread][V::kElems];
#pragma unroll
  for (int v = 0; v < kVecPerThread; ++v) {
#pragma unroll
    for (int j = 0; j < V::kElems; ++j) acc[v][j] = 0.0f;
  }
  // kSlotRegs entries at a time: their ids read together, then their rows,
  // then summed in k order
  for (int k0 = 0; k0 < k_slots; k0 += kSlotRegs) {
    long long row[kSlotRegs];
#pragma unroll
    for (int k = 0; k < kSlotRegs; ++k) {
      const int32_t s = k0 + k < k_slots ? __ldg(slots + k0 + k) : -1;
      row[k] = s < 0 ? -1 : (s < num_src_rows ? s : num_src_rows - 1);
    }
    int4 r[kSlotRegs][kVecPerThread];
#pragma unroll
    for (int k = 0; k < kSlotRegs; ++k) {
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) {
        const long long e = base + (long long)v * kThreads;
        r[k][v] = row[k] >= 0 && e < row_vecs
                      ? __ldg(src + row[k] * row_vecs + e)
                      : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kSlotRegs; ++k) {
      if (row[k] < 0) continue;
#pragma unroll
      for (int v = 0; v < kVecPerThread; ++v) V::add(acc[v], r[k][v]);
    }
  }
  int4* dst = out + t * row_vecs;
#pragma unroll
  for (int v = 0; v < kVecPerThread; ++v) {
    const long long e = base + (long long)v * kThreads;
    if (e < row_vecs) dst[e] = V::pack(acc[v]);
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

// C entry point of the gather-sum, bound with ctypes: out (num_out_rows,
// row_bytes) from src (num_src_rows, row_bytes) and inv (num_out_rows *
// k_slots,); dtype 0 f32, 1 bf16, 2 f16. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int row_gather_sum_launch(const void* src, const void* inv,
                                     void* out, long long num_out_rows,
                                     long long num_src_rows, int k_slots,
                                     long long row_bytes, int dtype,
                                     void* stream) {
  if (num_out_rows == 0 || row_bytes == 0) return 0;
  const long long row_vecs = row_bytes / 16;
  const long long chunks = (row_vecs + kChunkVecs - 1) / kChunkVecs;
  if (num_out_rows > 0x7fffffffLL || chunks > 65535 || num_src_rows < 1 ||
      row_bytes % 16 != 0 || k_slots < 1 || dtype < kF32 || dtype > kF16) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)num_out_rows, (unsigned)chunks);
  cudaStream_t s = (cudaStream_t)stream;
  const int4* in = static_cast<const int4*>(src);
  const int32_t* tab = static_cast<const int32_t*>(inv);
  int4* o = static_cast<int4*>(out);
  if (dtype == kF32) {
    row_gather_sum_kernel<kF32><<<grid, kThreads, 0, s>>>(
        in, tab, o, num_src_rows, k_slots, row_vecs);
  } else if (dtype == kBF16) {
    row_gather_sum_kernel<kBF16><<<grid, kThreads, 0, s>>>(
        in, tab, o, num_src_rows, k_slots, row_vecs);
  } else {
    row_gather_sum_kernel<kF16><<<grid, kThreads, 0, s>>>(
        in, tab, o, num_src_rows, k_slots, row_vecs);
  }
  return (int)cudaGetLastError();
}
