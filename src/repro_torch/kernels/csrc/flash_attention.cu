// Flash-attention forward for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas, the TPU
// kernel that walks the KV blocks of one (batch, head, query block) along a
// sequential grid axis, with the online-softmax state in VMEM scratch.
//
//   q   (B, Sq, H, hd)    the model's layout (the reference takes (B,H,Sq,hd));
//                         any strides over B, Sq, H; the last dim contiguous
//   k,v (B, Skv, KV, hd)  query head h reads KV head h / (H / KV) (GQA, MQA)
//   o   (B, Sq, H, hd)    contiguous, q's dtype
//   lse (B, H, Sq) f32    log-sum-exp of the masked, scaled logits
//   start (B,) int32      optional: keys < start[b] are masked (left pad)
//   hd                    64, 96, 112, 128 or 256
//
// Key kp is valid for query qp iff kp >= start[b], kp <= qp (causal),
// kp > qp - window (window > 0) and kp < Skv. Masked logits are the model's
// -1e30, so a row with no valid key (a pad row, qp < start[b]) has a uniform
// softmax: o is the mean of V over all Skv keys and lse is -1e30. The kernel
// handles those rows explicitly: it gives each of them logit 0 on every key
// < Skv, and a block holding one walks all the keys.
//
// Bound: at the olmo-1b training shape (B 8, S 1024, H 16, hd 128, bf16,
// causal) the tensor-core floor (4*B*H*hd*(S(S+1)/2) FLOPs at 989 TFLOP/s,
// 0.035 ms) and the HBM floor (q, k, v, o once and lse, 0.040 ms at
// 3.35 TB/s) are close: the kernel has to keep the tensor cores busy while
// it streams K and V.
//
// bf16 design (FlashAttention-3's dataflow):
//  * warp specialisation: an item is 128 query rows of one (b, h), split
//    between two consumer warpgroups of 64 rows; a third warpgroup is the
//    producer, of which one thread issues every load. setmaxnreg moves
//    registers from the producer (24) to the consumers (240). When Sq <= 64
//    (a short prefill) a variant runs one consumer warpgroup on 64-row
//    items and 64-key tiles;
//  * persistent blocks, one an SM: block i walks units i, i + grid, ...; a
//    unit is a pair of query blocks of one (b, h), the last and the first,
//    the second and the second to last, ..., so that every unit costs the
//    same under a causal mask (one query block a unit, the last first, when
//    pairs would leave SMs idle). The producer loads the next item's Q, K
//    and V while the consumers finish an item, so a block's start-up cost
//    is paid once. Consecutive units share (b, h): the units in flight read
//    the K and V of few heads, which stay in L2;
//  * TMA: the producer loads each item's Q once and then K and V tiles of
//    BN keys into a ring of 128-byte-swizzled tiles (3 stages, 2 at hd
//    256; 64 columns a box, so hd 96 and 112 take two boxes with the
//    columns past hd zero-filled). Each stage has full barriers for K and
//    for V and empty barriers that the consumers release, K once S is
//    done and V once O is. Tensor maps are encoded on the host per call
//    over the strided (B, S, H, hd) views and passed as __grid_constant__
//    parameters. Rows past Sq or Skv arrive as zeros, so no compute thread
//    computes an address or guards a row against 0 * NaN;
//  * wgmma: S = Q K^T is m64nBNk16 with both operands in shared memory;
//    O += P V is m64n{hd}k16 with P in registers: the f32 fragment of S,
//    packed to bf16 pairs, is the A fragment, and V stays row-major (key,
//    hd), read through wgmma's transpose of B;
//  * overlap: inside a warpgroup, S of tile i is issued together with O +=
//    P V of tile i-1, and the softmax of tile i runs while the second
//    product does; between the two warpgroups, named barriers make their
//    products alternate (ping-pong), so one's softmax runs beside the
//    other's products;
//  * online softmax in f32 in base 2 (ex2.approx) on the m16n8 C layout of
//    each warp's 16 rows, row max and sum across the 4 threads of a row by
//    shuffles; the per-element mask runs only on tiles that cross the
//    diagonal, the window edge, start or Skv, and for rows without keys;
//  * BN = 128 keys (64 at hd 256, where O alone takes 128 registers a
//    thread). At hd 128: Q 32 KB + 3 stages x (K + V) 192 KB, one block an
//    SM.
// f32 design: 64 query rows a block, 16 a warp, key tiles of 64 (32 at hd
// 256) in a two-stage cp.async ring, both products in FFMA (no TF32) so the
// f32 result matches the CPU's to rounding.
// Neither path uses atomics: every output is written once by one thread,
// so two launches give equal bits. Each launch returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the model's mask value
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const int* start;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, H, KV, Sq, Skv, causal, window;
  int paired;        // bf16: a block's unit is a pair of query blocks
  float scale_log2;  // log2(e) / sqrt(hd)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Valid keys of query qp are [lo, hi) (empty when lo >= hi).
__device__ __forceinline__ void row_range(const Args& a, int qp, int st,
                                          int& lo, int& hi) {
  lo = st > 0 ? st : 0;
  if (a.window > 0) lo = max(lo, qp - a.window + 1);
  hi = a.causal ? min(qp + 1, a.Skv) : a.Skv;
}

// Two floats as one bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// bf16: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------

// What query rows [q0, q1] (q0 <= q1 < Sq) need. The rows without a valid
// key are a prefix (qp < start, causal; all rows when start >= Skv) and a
// suffix (qp >= Skv + window - 1), so the two end rows decide any_empty.
// kbeg/kend bound the keys the rows read (all of them when a row has none);
// keys in [lo_max, hi_min) are valid for every row.
struct Rows {
  bool any_empty;
  int kbeg, kend, lo_max, hi_min;
};

__device__ __forceinline__ Rows rows_need(const Args& a, int q0, int q1,
                                          int st) {
  int lo0, hi0, lo1, hi1;
  row_range(a, q0, st, lo0, hi0);
  row_range(a, q1, st, lo1, hi1);
  Rows r;
  r.any_empty = lo0 >= hi0 || lo1 >= hi1;
  r.kbeg = r.any_empty ? 0 : lo0;
  r.kend = r.any_empty ? a.Skv : hi1;
  r.lo_max = lo1;
  r.hi_min = hi0;
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// One arrival that also expects `bytes` from the copies that follow.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity. (No
// timeout: a trap on this path makes ptxas spill the consumers' registers
// and serialise every wgmma.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait(addr, parity)) {
  }
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (barrier 0 is __syncthreads): each warpgroup waits on its own before it
// issues, and signals the other's after.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One TMA box of the rank-4 map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Matrix descriptor of a 128-byte-swizzled tile in shared memory: start
// address, leading and stride byte offsets in 16-byte units, layout type 1
// (128-byte swizzle) in bits 62-63. K-major tiles (Q, K): rows of 128 bytes,
// 8-row groups 1024 bytes apart (sbo 64), lbo unused (1). V, read through
// the transpose of B: lbo = the distance between 64-column boxes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving or reusing the registers of an operand or
// accumulator across the asynchronous products that read or write them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// 2^x in one MUFU op (flushes denormals, 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (m64nN f32, N/2 registers a thread) = or += A B in bf16. wgmma_ss: A and
// B K-major in shared memory; scale_d = 0 overwrites d. wgmma_rs: A from
// registers (the m16n8k16 A fragment of each warp's 16 rows), B read
// transposed (tile rows are K), always accumulating.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[48],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[56],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, {%56, "
      "%57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Register layout of S and O in each warp (that of mma.m16n8k16's C, which
// the m64nN accumulator repeats per warp): lane = 4*g + t; d[4*j + e] holds
// row g + 8*(e >> 1) of the warp's 16 rows and column 8*j + 2*t + (e & 1).

// Issue S = Q K^T: q_s a warpgroup's 64 rows of Q, k_s BN rows of K, both
// as 64-column boxes of 128-byte rows (box stride 64 and BN rows).
template <int HD, int BN>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t q_s,
                                         uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;  // 16 columns a step
    wgmma_ss(sc, sw128_desc(q_s + (kk >> 2) * 64 * 128 + col, 1, 64),
             sw128_desc(k_s + (kk >> 2) * BN * 128 + col, 1, 64), kk > 0);
  }
}

// Issue O += P V: P as bf16 A fragments, 16 keys a step; v_s BN rows of V.
template <int HD, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_s) {
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
    wgmma_rs(o, pa[kc], sw128_desc(v_s + kc * 16 * 128, BN * 8, 64));
}

// One thread's two rows of the online softmax.
struct RowState {
  int lo[2], hi[2];     // valid keys [lo, hi)
  bool emp[2];          // no valid key: logit 0 on every key < Skv
  float m[2];           // running max of the scaled logits (base 2)
  float l[2];           // this thread's part of the running sum
};

// Turn the tile's logits into probabilities in place and return each row's
// factor for O. The per-element mask runs only when `masked`; a row
// without a valid key sees logit 0 on every key < Skv (its uniform
// softmax). The scale is folded into the exponent.
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], RowState& rs,
                                             bool masked, int kt, int t,
                                             const Args& a,
                                             float (&alpha)[2]) {
  constexpr int NT = BN / 8;
  if (masked) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = kt + 8 * j + 2 * t + (e & 1);
        const bool ok =
            rs.emp[r] ? kp < a.Skv : (kp >= rs.lo[r] && kp < rs.hi[r]);
        sc[4 * j + e] = ok ? (rs.emp[r] ? 0.f : sc[4 * j + e]) : -INFINITY;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float mnew = fmaxf(rs.m[r], mx * a.scale_log2);
    const float base = mnew == -INFINITY ? 0.f : mnew;
    alpha[r] = ex2(rs.m[r] - base);
    rs.m[r] = mnew;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * j + 2 * r + c];
        x = ex2(fmaf(x, a.scale_log2, -base));
        sum += x;
      }
    }
    rs.l[r] = rs.l[r] * alpha[r] + sum;
  }
}

// P (f32 fragment of S) -> bf16 A fragments of m64k16, 16 keys a step.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 16][4],
                                       const float (&sc)[BN / 2]) {
#pragma unroll
  for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kc][i] = pack2(sc[8 * kc + 2 * i], sc[8 * kc + 2 * i + 1]);
}

template <int HD>
__device__ __forceinline__ void scale_o(float (&o)[HD / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    o[4 * n] *= alpha[0];
    o[4 * n + 1] *= alpha[0];
    o[4 * n + 2] *= alpha[1];
    o[4 * n + 3] *= alpha[1];
  }
}

// The work of a block. With a.paired, a unit is a pair of query blocks of
// one (b, h): block nq-1-j (the longer under a causal mask) and then block
// j, so that every unit costs about nq + 1 key tiles (the middle block of
// an odd nq is alone). Otherwise a unit is one query block, the last
// first. Consecutive units share (b, h), so the units in flight at one
// time read few heads' K and V, which stay in L2.
struct Item {
  int q0, h, b;
};

__host__ __device__ constexpr int units_of(int sq, int rows, int h, int b,
                                           bool paired) {
  return ((sq + rows - 1) / rows + (paired ? 1 : 0)) / (paired ? 2 : 1) * h *
         b;
}

__device__ __forceinline__ bool item_at(const Args& a, int rows, int unit,
                                        int half, Item& w) {
  const int nq = (a.Sq + rows - 1) / rows;
  const int nu = a.paired ? (nq + 1) / 2 : nq;  // units a (b, h)
  const int j = unit % nu;
  if (half == 1 && (!a.paired || 2 * j + 1 == nq)) return false;
  w.q0 = (half == 0 ? nq - 1 - j : j) * rows;
  w.h = unit / nu % a.H;
  w.b = unit / nu / a.H;
  return true;
}

// K/V stages of the ring: three up to hd 128 (at BN 128, 64 rows of Q a
// warpgroup: 225 KB of shared memory), two at hd 256.
__host__ __device__ constexpr int bf16_stages(int hd) {
  return hd <= 128 ? 3 : 2;
}

// Persistent: block i takes units i, i + gridDim.x, ... (gridDim.x at most
// the SM count), and its producer loads the next item's Q, K and V while
// the consumers finish the current one.
template <int HD, int BN, int NC>  // NC consumer warpgroups of 64 rows
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const Args a) {
  constexpr int kStages = bf16_stages(HD);
  constexpr int kRows = 64 * NC;          // query rows of an item
  constexpr int KB = (HD + 63) / 64;      // 64-column boxes a row
  constexpr int kQTile = KB * 64 * 128;   // a warpgroup's 64 rows of Q
  constexpr int kKVTile = KB * BN * 128;  // BN rows of K or V

  // full_*: the producer's loads landed; empty_*: every consumer thread is
  // done with Q (after the item's last S), a stage's K (after its S) or V
  // (after O += P V)
  __shared__ __align__(8) uint64_t bars[2 + 4 * kStages];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled tiles need 1024-byte alignment; the launch adds 1 KB of slack
  unsigned char* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sQ + NC * kQTile;   // [kStages][KB][BN][128 B]
  unsigned char* sV = sK + kStages * kKVTile;
  uint64_t* full_q = bars;
  uint64_t* empty_q = bars + 1;
  uint64_t* full_k = bars + 2;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  const int nunits = units_of(a.Sq, kRows, a.H, a.B, a.paired);

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 128 * NC);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_k[i], 128 * NC);
      mbar_init(&empty_v[i], 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler knows it is
  // uniform across the warp
  const int wg = __shfl_sync(kFull, (int)threadIdx.x / 128, 0);
  if (wg == NC) {
    // producer: one thread issues every load; g counts the block's K/V
    // tiles, which pass through the ring in order
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 128 * NC) return;
    int g = 0, n = 0;
    for (int unit = blockIdx.x; unit < nunits; unit += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        Item w;
        if (!item_at(a, kRows, unit, half, w)) continue;
        const int kvh = w.h / (a.H / a.KV);
        const int st = a.start != nullptr ? a.start[w.b] : 0;
        const Rows blk = rows_need(a, w.q0, min(w.q0 + kRows, a.Sq) - 1, st);
        const int kbeg = blk.kbeg / BN * BN;
        const int ntiles = (blk.kend - kbeg + BN - 1) / BN;
        if (n > 0) mbar_wait(empty_q, (n - 1) & 1);
        mbar_expect_tx(full_q, NC * kQTile);
        for (int c = 0; c < NC; ++c)
          for (int cb = 0; cb < KB; ++cb)
            tma_load(sQ + c * kQTile + cb * 64 * 128, &mq, full_q, 64 * cb,
                     w.q0 + 64 * c, w.h, w.b);
        for (int it = 0; it < ntiles; ++it, ++g) {
          const int s = g % kStages, kt = kbeg + it * BN;
          const int ph = (g / kStages - 1) & 1;  // the previous use's phase
          if (g >= kStages) mbar_wait(&empty_k[s], ph);
          mbar_expect_tx(&full_k[s], kKVTile);
          for (int cb = 0; cb < KB; ++cb)
            tma_load(sK + s * kKVTile + cb * BN * 128, &mk, &full_k[s],
                     64 * cb, kt, kvh, w.b);
          if (g >= kStages) mbar_wait(&empty_v[s], ph);
          mbar_expect_tx(&full_v[s], kKVTile);
          for (int cb = 0; cb < KB; ++cb)
            tma_load(sV + s * kKVTile + cb * BN * 128, &mv, &full_v[s],
                     64 * cb, kt, kvh, w.b);
        }
        ++n;
      }
    }
    return;
  }

  // consumer warpgroup wg: rows q0 + 64 wg .. + 63 of each item, 16 a warp,
  // 2 a thread
  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, t = lane & 3;
  const uint32_t q_s = smem_u32(sQ + wg * kQTile);
  const uint32_t k_s = smem_u32(sK), v_s = smem_u32(sV);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);

  // With two consumer warpgroups the products alternate, tile by tile:
  // warpgroup 0 issues, then warpgroup 1, so that one's softmax runs
  // beside the other's products. Warpgroup 1 lets warpgroup 0 start, and
  // warpgroup 0 takes that extra turn back at the end.
  auto my_turn = [&] {
    if constexpr (NC == 2) named_sync(1 + wg);
  };
  auto your_turn = [&] {
    if constexpr (NC == 2) named_arrive(2 - wg);
  };
  if constexpr (NC == 2)
    if (wg == 1) named_arrive(1);

  int g = 0, n = 0;
  for (int unit = blockIdx.x; unit < nunits; unit += gridDim.x) {
    for (int half = 0; half < 2; ++half) {
      Item w;
      if (!item_at(a, kRows, unit, half, w)) continue;
      const int st = a.start != nullptr ? a.start[w.b] : 0;
      const Rows blk = rows_need(a, w.q0, min(w.q0 + kRows, a.Sq) - 1, st);
      const int kbeg = blk.kbeg / BN * BN;
      const int ntiles = (blk.kend - kbeg + BN - 1) / BN;
      const int qw = w.q0 + 64 * wg;
      RowState rs;
      int qp[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        qp[r] = qw + 16 * warp + g8 + 8 * r;
        row_range(a, qp[r], st, rs.lo[r], rs.hi[r]);
        rs.emp[r] = rs.lo[r] >= rs.hi[r];
        rs.m[r] = -INFINITY;
        rs.l[r] = 0.f;
      }
      // a tile inside [lo_max, hi_min) is valid for every row: no mask
      bool mask_all = true;
      int lo_max = 0, hi_min = 0;
      if (qw < a.Sq) {
        const Rows mine = rows_need(a, qw, min(qw + 64, a.Sq) - 1, st);
        mask_all = mine.any_empty;
        lo_max = mine.lo_max;
        hi_min = mine.hi_min;
      }
      auto masked = [&](int kt) {
        return mask_all || kt < lo_max || kt + BN > hi_min;
      };

      float o[HD / 2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float sc[BN / 2], alpha[2];
      uint32_t pa[BN / 16][4];

      // tile 0: S, then P
      mbar_wait(full_q, n & 1);
      {
        const int s = g % kStages, ph = (g / kStages) & 1;
        mbar_wait(&full_k[s], ph);
        my_turn();
        wgmma_fence();
        issue_qk<HD, BN>(sc, q_s, k_s + s * kKVTile);
        wgmma_commit();
        your_turn();
        wgmma_wait<0>();
        reg_fence(sc);
        mbar_arrive(&empty_k[s]);
        if (ntiles == 1) mbar_arrive(empty_q);
        softmax_tile<BN>(sc, rs, masked(kbeg), kbeg, t, a, alpha);
        pack_p<BN>(pa, sc);
      }

      // tile it: S_it = Q K_it^T runs beside O += P_{it-1} V_{it-1}, and
      // the softmax of S_it beside the second product; O takes the factor
      // of tile it - 1 while S_it runs
      for (int it = 1; it < ntiles; ++it) {
        const int gi = g + it;
        const int s = gi % kStages, ph = (gi / kStages) & 1;
        const int sp = (gi - 1) % kStages, php = ((gi - 1) / kStages) & 1;
        const int kt = kbeg + it * BN;
        mbar_wait(&full_k[s], ph);
        my_turn();
        wgmma_fence();
        issue_qk<HD, BN>(sc, q_s, k_s + s * kKVTile);
        wgmma_commit();
        scale_o<HD>(o, alpha);
        mbar_wait(&full_v[sp], php);
        wgmma_fence();
        issue_pv<HD, BN>(o, pa, v_s + sp * kKVTile);
        wgmma_commit();
        your_turn();
        wgmma_wait<1>();  // S_it is done
        reg_fence(sc);
        mbar_arrive(&empty_k[s]);
        if (it == ntiles - 1) mbar_arrive(empty_q);  // the item's last S
        softmax_tile<BN>(sc, rs, masked(kt), kt, t, a, alpha);
        wgmma_wait<0>();  // O += P_{it-1} V_{it-1} is done
        reg_fence(o);
        reg_fence(pa);
        mbar_arrive(&empty_v[sp]);
        pack_p<BN>(pa, sc);
      }
      scale_o<HD>(o, alpha);
      {
        const int gl = g + ntiles - 1;
        const int s = gl % kStages, ph = (gl / kStages) & 1;
        mbar_wait(&full_v[s], ph);
        wgmma_fence();
        issue_pv<HD, BN>(o, pa, v_s + s * kKVTile);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        mbar_arrive(&empty_v[s]);
      }
      g += ntiles;
      ++n;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = rs.l[r];
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if (qp[r] >= a.Sq) continue;
        const float inv = sum > 0.f ? 1.f / sum : 0.f;
        __nv_bfloat16* orow =
            out + (((long long)w.b * a.Sq + qp[r]) * a.H + w.h) * HD + 2 * t;
#pragma unroll
        for (int c = 0; c < HD / 8; ++c)
          *reinterpret_cast<uint32_t*>(orow + 8 * c) =
              pack2(o[4 * c + 2 * r] * inv, o[4 * c + 2 * r + 1] * inv);
        if (t == 0)
          a.lse[((long long)w.b * a.H + w.h) * a.Sq + qp[r]] =
              rs.emp[r] ? kNegInf : (rs.m[r] + log2f(sum)) * kLn2;
      }
    }
  }
  if constexpr (NC == 2)
    if (wg == 0) my_turn();
}

// ---------------------------------------------------------------------------
// f32: cp.async tiles and FFMA products
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32BlockM = 16 * kF32Warps;  // query rows of a block

// 16 bytes global -> shared; zero-filled without a read when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Rows [row0, row0 + ROWS) of a (rows, HD) plane with row stride `stride`
// into shared memory (row pitch LD); rows >= nvalid are zero-filled.
template <int ROWS, int HD, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long stride, int row0,
                                          int nvalid, int tid) {
  constexpr int kChunks = HD / 4;  // 16-byte chunks a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kF32Threads - 1) / kF32Threads; ++i) {
    const int c = tid + i * kF32Threads;
    if (kTotal % kF32Threads == 0 || c < kTotal) {
      const int r = c / kChunks, col = (c % kChunks) * 4;
      const bool ok = row0 + r < nvalid;
      const float* s = ok ? src + (long long)(row0 + r) * stride + col : src;
      cp_async16(dst + r * LD + col, s, ok);
    }
  }
}

// s = Q K^T in f32 FFMA, in the register layout above (s[j][e]).
template <int HD, int NT, int LD>
__device__ __forceinline__ void scores_f32(float (&s)[NT][4],
                                           const float* q_s,
                                           const float* k_s, int g, int t) {
  const float* qa = q_s + g * LD;
  const float* qb = q_s + (g + 8) * LD;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(qa + d);
    const float4 x1 = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 y = *reinterpret_cast<const float4*>(
            k_s + (8 * j + 2 * t + e) * LD + d);
        float a = s[j][e], b = s[j][2 + e];
        a = fmaf(x0.x, y.x, a);
        a = fmaf(x0.y, y.y, a);
        a = fmaf(x0.z, y.z, a);
        a = fmaf(x0.w, y.w, a);
        b = fmaf(x1.x, y.x, b);
        b = fmaf(x1.y, y.y, b);
        b = fmaf(x1.z, y.z, b);
        b = fmaf(x1.w, y.w, b);
        s[j][e] = a;
        s[j][2 + e] = b;
      }
    }
  }
}

// acc += P V in f32 FFMA: each probability is broadcast from the thread of
// its row that holds it.
template <int HD, int NT, int LD>
__device__ __forceinline__ void pv_f32(float (&acc)[HD / 8][4],
                                       const float (&p)[NT][4],
                                       const float* v_s, int lane, int t) {
  const int quad = lane & ~3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int src = quad | (c >> 1);
      const float p0 = __shfl_sync(kFull, p[j][c & 1], src);
      const float p1 = __shfl_sync(kFull, p[j][2 + (c & 1)], src);
      const float* vr = v_s + (8 * j + c) * LD + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(vr + 8 * n);
        acc[n][0] = fmaf(p0, y.x, acc[n][0]);
        acc[n][1] = fmaf(p0, y.y, acc[n][1]);
        acc[n][2] = fmaf(p1, y.x, acc[n][2]);
        acc[n][3] = fmaf(p1, y.y, acc[n][3]);
      }
    }
  }
}

template <int HD, int BN>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const Args a) {
  constexpr int LD = HD + 4;  // row pitch, padded by 16 bytes
  constexpr int NT = BN / 8;  // 8-key column tiles of S
  constexpr int NO = HD / 8;  // 8-wide column tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kF32BlockM][LD]
  float* sK = sQ + kF32BlockM * LD;                // [2][BN][LD]
  float* sV = sK + 2 * BN * LD;                    // [2][BN][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF32BlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int st = a.start != nullptr ? a.start[b] : 0;

  const float* qg = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // this thread's two rows
  int qp[2], lo[2], hi[2];
  bool empty[2];
  int mine = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qp[r] = q0 + warp * 16 + g + 8 * r;
    row_range(a, qp[r], st, lo[r], hi[r]);
    empty[r] = lo[r] >= hi[r];
    mine |= (empty[r] && qp[r] < a.Sq) ? 1 : 0;
  }
  const bool any_empty = __syncthreads_or(mine) != 0;

  // the block's key range: lo and hi never decrease with qp
  int lo_first, hi_first, lo_last, hi_last;
  row_range(a, q0, st, lo_first, hi_first);
  row_range(a, min(q0 + kF32BlockM, a.Sq) - 1, st, lo_last, hi_last);
  int kbeg = any_empty ? 0 : lo_first;
  const int kend = any_empty ? a.Skv : hi_last;
  kbeg = (kbeg / BN) * BN;
  const int ntiles = (kend - kbeg + BN - 1) / BN;

  load_rows<kF32BlockM, HD, LD>(sQ, qg, a.q_ss, q0, a.Sq, tid);
  load_rows<BN, HD, LD>(sK, kg, a.k_ss, kbeg, a.Skv, tid);
  load_rows<BN, HD, LD>(sV, vg, a.v_ss, kbeg, a.Skv, tid);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kbeg + it * BN;
    const int stage = it & 1;
    if (it + 1 < ntiles) {
      load_rows<BN, HD, LD>(sK + (stage ^ 1) * BN * LD, kg, a.k_ss, kt + BN,
                            a.Skv, tid);
      load_rows<BN, HD, LD>(sV + (stage ^ 1) * BN * LD, vg, a.v_ss, kt + BN,
                            a.Skv, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // this tile (and q) have landed
    __syncthreads();
    const float* q_s = sQ + warp * 16 * LD;
    const float* k_s = sK + stage * BN * LD;
    const float* v_s = sV + stage * BN * LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    scores_f32<HD, NT, LD>(s, q_s, k_s, g, t);

    // scale into base 2 and mask; a row without a valid key sees logit 0
    // on every key < Skv (its uniform softmax)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = kt + 8 * j + 2 * t + (e & 1);
        const bool ok = empty[r] ? kp < a.Skv : (kp >= lo[r] && kp < hi[r]);
        const float x = empty[r] ? 0.f : s[j][e] * a.scale_log2;
        s[j][e] = ok ? x : -INFINITY;
      }
    }

    // online softmax
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float base = mx == -INFINITY ? 0.f : mx;
      const float alpha = exp2f(m[r] - base);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - base);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - base);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    pv_f32<HD, NT, LD>(acc, s, v_s, lane, t);
    __syncthreads();  // the next iteration refills this stage
  }

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (qp[r] >= a.Sq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    float* orow = o + (((long long)b * a.Sq + qp[r]) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qp[r]] =
          empty[r] ? kNegInf : (m[r] + log2f(sum)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int HD, int BN>
int launch_f32(const Args& a, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const int smem = (kF32BlockM + 4 * BN) * LD * (int)sizeof(float);
  static bool configured = false;  // once per instantiation, before capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<HD, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((a.Sq + kF32BlockM - 1) / kF32BlockM, a.H, a.B);
  flash_fwd_f32<HD, BN><<<grid, kF32Threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-4 map over a strided (B, S, heads, hd) bf16 view (strides in
// elements), boxes of 64 columns x `rows` rows with a 128-byte swizzle;
// elements out of bounds (rows past S, columns past hd) read as zero.
bool encode_map(CUtensorMap* map, const void* p, int B, int S, int heads,
                int hd, long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  // a dim of extent 1 is only read at 0, so its stride is free
  auto bytes = [](int n, long long s) {
    return (cuuint64_t)(n > 1 ? s * 2 : 16);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(S, ss), bytes(heads, sh),
                                 bytes(B, sb)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BN, int NC>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int KB = (HD + 63) / 64;
  constexpr int smem =
      1024 + NC * KB * 64 * 128 + bf16_stages(HD) * 2 * KB * BN * 128;
  static bool configured = false;  // once per instantiation, before capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<HD, BN, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (NC == 2) {
      // setmaxnreg moves 128 x 144 registers from the producer to the
      // consumers; that balances only from 168 at entry (384 threads, one
      // block an SM). Anything else would stall the block: refuse it.
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, flash_fwd_bf16<HD, BN, NC>);
      if (err != cudaSuccess) return (int)err;
      if (attr.numRegs != 168) return (int)cudaErrorInvalidConfiguration;
    }
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  if (!encode_map(&mq, a.q, a.B, a.Sq, a.H, HD, a.q_sb, a.q_ss, a.q_sh, 64) ||
      !encode_map(&mk, a.k, a.B, a.Skv, a.KV, HD, a.k_sb, a.k_ss, a.k_sh,
                  BN) ||
      !encode_map(&mv, a.v, a.B, a.Skv, a.KV, HD, a.v_sb, a.v_ss, a.v_sh,
                  BN))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // pairs balance a causal mask, but only while they fill every SM
  Args ap = a;
  ap.paired = units_of(a.Sq, 64 * NC, a.H, a.B, true) >= sms;
  const int units = units_of(a.Sq, 64 * NC, a.H, a.B, ap.paired);
  const int grid = units < sms ? units : sms;
  flash_fwd_bf16<HD, BN, NC><<<grid, 128 * (NC + 1), smem, stream>>>(
      mq, mk, mv, ap);
  return (int)cudaGetLastError();
}

// 128 query rows a block (two consumer warpgroups) and BN keys a tile, or
// 64 rows and 64 keys when Sq <= 64 (a short prefill).
template <int HD, int BN>
int launch_bf16_rows(const Args& a, cudaStream_t stream) {
  return a.Sq <= 64 ? launch_bf16<HD, 64, 1>(a, stream)
                    : launch_bf16<HD, BN, 2>(a, stream);
}

int dispatch(const Args& a, int hd, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch (hd) {
      case 64:
        return launch_f32<64, 64>(a, s);
      case 96:
        return launch_f32<96, 64>(a, s);
      case 112:
        return launch_f32<112, 64>(a, s);
      case 128:
        return launch_f32<128, 64>(a, s);
      case 256:
        return launch_f32<256, 32>(a, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 64:
        return launch_bf16_rows<64, 128>(a, s);
      case 96:
        return launch_bf16_rows<96, 128>(a, s);
      case 112:
        return launch_bf16_rows<112, 128>(a, s);
      case 128:
        return launch_bf16_rows<128, 128>(a, s);
      case 256:
        return launch_bf16_rows<256, 64>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements. dtype: 0 f32,
// 1 bf16. window <= 0: none. start may be null. Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* start, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int B, int H, int KV, int Sq, int Skv,
    int hd, int causal, int window, int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0 ||
      Sq < 1 || Skv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.start = static_cast<const int*>(start);
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.B = B;
  a.H = H;
  a.paired = 0;
  a.KV = KV;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  return dispatch(a, hd, dtype, (cudaStream_t)stream);
}
