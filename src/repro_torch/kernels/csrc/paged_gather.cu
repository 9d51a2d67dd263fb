// Paged KV-cache page gather for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_kv.py::paged_gather_pallas, the TPU
// scalar-prefetch kernel that DMAs one pool page per grid step.
//
//   pool  (NP, PS, KV, hd)   one layer's page pool, any 1-, 2- or 4-byte dtype
//   table (B, MAXP) int32    pool page id per (slot, logical page); < 0 unmapped
//   out   (B, MAXP*PS, KV, hd)
//
// Destination page t = b*MAXP + p receives pool page clip(table[t], 0, NP-1),
// or zeros where table[t] < 0 — the semantics of paged_gather_take, which is
// what the JAX package runs off-TPU.
//
// Bound: HBM bytes. The op does no arithmetic; it reads each mapped pool page
// once and writes every destination page once, so at most
// 2 * B * MAXP * PS * KV * hd * itemsize bytes move (less where pages are
// unmapped: those are only written). At the olmo-1b serve shape (f32 cache,
// B=4, MAXP=16, PS=16, KV=16, hd=128) that is ~16.8 MB, ~5 us at 3.35 TB/s.
//
// Design against that bound:
//  * the op is a byte copy, so the kernel is dtype-agnostic: it moves 16-byte
//    vectors (int4) and the wrapper requires a page's bytes to be a multiple
//    of 16 and 16-byte aligned base pointers;
//  * grid = (destination pages, 16 KiB chunks of a page): a page of 128 KiB
//    (f32) gives 8 blocks, so the 64 pages of the serve shape launch 512
//    blocks — enough to spread over all 132 SMs instead of one block a page;
//  * each thread issues all of its loads before any store (4 x 16 B in
//    flight per thread), neighbouring threads on neighbouring addresses, so
//    every warp access is four fully used 128-byte lines;
//  * offsets are 64-bit: a pool can exceed 2^31 bytes;
//  * the table entry is read once per block; an unmapped page is written
//    with zeros and its source is never touched.
// Nothing else is fused here: a paged decode-attention kernel that reads the
// pages in place, and so moves none of these bytes, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;
constexpr long long kChunkVecs = (long long)kThreads * kVecPerThread;  // 16 KiB

__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const int4* __restrict__ pool,
                    const int32_t* __restrict__ table,
                    int4* __restrict__ out,
                    int num_pages,
                    long long page_vecs) {
  const long long t = blockIdx.x;  // destination page
  const int32_t raw = __ldg(table + t);
  const long long base = (long long)blockIdx.y * kChunkVecs + threadIdx.x;
  int4* dst = out + t * page_vecs;

  if (raw < 0) {
    const int4 z = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const long long e = base + (long long)i * kThreads;
      if (e < page_vecs) dst[e] = z;
    }
    return;
  }

  const long long id = raw < num_pages ? raw : num_pages - 1;
  const int4* src = pool + id * page_vecs;
  int4 r[kVecPerThread];
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const long long e = base + (long long)i * kThreads;
    r[i] = e < page_vecs ? __ldg(src + e) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const long long e = base + (long long)i * kThreads;
    if (e < page_vecs) dst[e] = r[i];
  }
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` (PyTorch's current
// stream), does not synchronise, and returns cudaGetLastError() so that a
// refused launch is reported to the caller.
extern "C" int paged_gather_launch(const void* pool, const void* table,
                                   void* out, long long dst_pages,
                                   int num_pages, long long page_bytes,
                                   void* stream) {
  if (dst_pages == 0) return 0;
  const long long page_vecs = page_bytes / 16;
  const long long chunks = (page_vecs + kChunkVecs - 1) / kChunkVecs;
  if (dst_pages > 0x7fffffffLL || chunks > 65535 || num_pages < 1 ||
      page_bytes % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)dst_pages, (unsigned)chunks);
  paged_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int4*>(pool), static_cast<const int32_t*>(table),
      static_cast<int4*>(out), num_pages, page_vecs);
  return (int)cudaGetLastError();
}
