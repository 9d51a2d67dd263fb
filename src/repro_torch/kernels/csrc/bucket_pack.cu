// Gradient-bucket pack/unpack (table-driven tile gather) for Hopper (sm_90a).
//
// Replaces repro/kernels/bucket_pack.py::bucket_pack_pallas and
// bucket_unpack_pallas, the TPU scalar-prefetch kernel that DMAs one source
// tile per grid step (unpack is the same kernel with the other tables).
//
//   src   (src_tiles * tile,)  flat tile-aligned arena (pack) or the reduced
//                              buckets back to back (unpack); f32 or bf16
//   block (n_tiles,) int32     source tile of each destination tile
//   valid (n_tiles,) int32     elements of that tile that are data
//   out   (n_tiles * tile,)    out tile t = src tile block[t], elements
//                              >= valid[t] zero
//
// Bound: HBM bytes. The op does no arithmetic; it reads the valid prefix of
// each source tile once and writes every destination tile once:
// sum(valid) * elem + n_tiles * tile * elem (+ 8 B of tables a tile). At
// full olmo-1b width (f32, ~1.15 M tiles, arena ~4.7 GB) that is ~9.4 GB a
// direction, ~2.8 ms at 3.35 TB/s.
//
// Design against that bound:
//  * the op is a byte copy with a tail mask, so the kernel moves 16-byte
//    vectors (uint4) whatever the dtype; the wrapper requires tiles of a
//    multiple of 16 bytes and 16-byte aligned buffers. One f32 tile is 256
//    vectors, one bf16 tile 128;
//  * the output is viewed as one flat run of vectors; each block of 256
//    threads covers 4 x 256 consecutive vectors, each thread issuing its 4
//    loads before any store, neighbouring threads on neighbouring
//    addresses, so every warp access is fully used 128-byte lines and each
//    SM keeps enough bytes in flight. A thread finds its tile by division
//    and reads that tile's block/valid itself (no scalar prefetch; the
//    table entries of a warp coincide and come from L1);
//  * a vector wholly past valid[t] is written as zeros without reading the
//    source; the one vector that straddles valid[t] is loaded and masked
//    element by element (2-byte granularity, which covers f32 and bf16);
//  * offsets are 64-bit: at full width the arena is past 2^32 bytes;
//  * a block id outside [0, src_tiles) is clipped, so a bad table cannot
//    read outside the source (tables from build_tile_tables never are).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;

__device__ __forceinline__ uint4 load_tile_vec(
    const uint4* __restrict__ src, const int32_t* __restrict__ block,
    const int32_t* __restrict__ valid, long long t, long long j,
    long long tile_vecs, long long src_tiles, int elem_bytes) {
  const long long vb = (long long)__ldg(valid + t) * elem_bytes;
  const long long lo = j * 16;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (lo >= vb) return r;  // wholly past the data: zeros, source not read
  long long b = __ldg(block + t);
  b = b < 0 ? 0 : (b >= src_tiles ? src_tiles - 1 : b);
  r = __ldg(src + b * tile_vecs + j);
  if (lo + 16 > vb) {  // straddles valid[t]: zero the tail element-wise
    unsigned short* h = reinterpret_cast<unsigned short*>(&r);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (lo + 2 * k >= vb) h[k] = 0;
    }
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
bucket_pack_kernel(const uint4* __restrict__ src,
                   const int32_t* __restrict__ block,
                   const int32_t* __restrict__ valid,
                   uint4* __restrict__ out,
                   long long total_vecs, long long tile_vecs,
                   long long src_tiles, int elem_bytes) {
  const long long base =
      (long long)blockIdx.x * (kThreads * kVecPerThread) + threadIdx.x;
  uint4 r[kVecPerThread] = {};
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const long long g = base + (long long)i * kThreads;
    if (g < total_vecs) {
      const long long t = g / tile_vecs;
      r[i] = load_tile_vec(src, block, valid, t, g - t * tile_vecs,
                           tile_vecs, src_tiles, elem_bytes);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const long long g = base + (long long)i * kThreads;
    if (g < total_vecs) out[g] = r[i];
  }
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" int bucket_pack_launch(const void* src, const void* block,
                                  const void* valid, void* out,
                                  long long n_tiles, long long src_tiles,
                                  long long tile_bytes, int elem_bytes,
                                  void* stream) {
  if (n_tiles == 0) return 0;
  if (n_tiles < 0 || src_tiles < 1 || tile_bytes <= 0 || tile_bytes % 16 ||
      (elem_bytes != 2 && elem_bytes != 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tile_vecs = tile_bytes / 16;
  const long long total_vecs = n_tiles * tile_vecs;
  const long long per_block = (long long)kThreads * kVecPerThread;
  const long long blocks = (total_vecs + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bucket_pack_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const uint4*>(src), static_cast<const int32_t*>(block),
      static_cast<const int32_t*>(valid), static_cast<uint4*>(out),
      total_vecs, tile_vecs, src_tiles, elem_bytes);
  return (int)cudaGetLastError();
}
