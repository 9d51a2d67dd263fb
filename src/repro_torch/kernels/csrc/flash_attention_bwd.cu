// Flash-attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: flash_attention_pallas (repro/kernels/
// flash_attention.py) has no backward; the reference differentiates its
// XLA attention. This is the backward of csrc/flash_attention.cu's
// forward, so that a training step on the card runs no plain PyTorch
// version of it.
//
//   q    (B, Sq, H, hd)    the model's layout; any strides over B, Sq, H;
//                          the last dim contiguous
//   k,v  (B, Skv, KV, hd)  likewise; query head h reads KV head h / (H / KV)
//   o,dO (B, Sq, H, hd)    contiguous, q's dtype
//   lse  (B, H, Sq) f32    the forward's log-sum-exp, contiguous
//   delta (B, H, Sq) f32   scratch: rowsum(dO * O)
//   dq   (B, Sq, H, hd)    contiguous, q's dtype
//   dk,dv (B, Skv, KV, hd) contiguous, q's dtype (summed over the query
//                          heads of each KV group)
//   hd                     64, 96, 112, 128 or 256; f32 or bf16
//
// The masks are the forward's without start: key kp is valid for query qp
// iff kp <= qp (causal), kp > qp - window (window > 0) and kp < Skv. A row
// with no valid key (under a window, qp >= Skv + window - 1) had the
// forward's uniform softmax, P = 1 / Skv on every key: its output is the
// mean of V whatever q and k are, so it adds dO / Skv to every dV row and
// nothing to dQ or dK (dS = 0). Its lse is -1e30, which says nothing of
// 1 / Skv, so those rows are found by position, not through exp(s - lse).
//
// FlashAttention-2's dataflow in three launches, none with atomics:
//  1. delta: one warp a (b, s, h) row, D = rowsum(dO * O) in f32;
//  2. dK/dV: one block a (b, KV head, tile of BC keys); each warp owns 16
//     keys (and, at hd 256, half the columns: two warps share 16 keys).
//     The block walks the query heads of its KV group and, for each, the
//     tiles of BR queries that the mask lets read its keys (then the rows
//     without a valid key, if any), Q and dO double-buffered by cp.async.
//     A tile recomputes S^T = K Q^T and P^T = exp(S^T scale - lse), then
//     dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q.
//     dK (times scale) and dV are written once: the GQA sum stays in the
//     block's registers, in a fixed order;
//  3. dQ: one block a (b, head, tile of BM queries), a warp 16 rows; it
//     walks the key tiles its rows read (K and V double-buffered),
//     recomputes S, P, dP and dS, and writes dQ += dS K (times scale) once.
// bf16 products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
// f32 accumulators; P and dS rounded to bf16 as the A operand, as the
// plain version rounds them); the operands come from padded shared-memory
// rows by ldmatrix. f32 products run in FFMA (no TF32) in the same
// register layout, so the f32 result matches the CPU's to rounding. The
// softmax algebra is f32 in both.
//
// Bound: at the olmo-1b training shape (B 8, S 1024, H 16, hd 128, bf16,
// causal) the five products take 10 * B * H * hd * S(S+1)/2 FLOPs (0.087
// ms at 989 TFLOP/s) and q, k, v, o, dO, lse read once and dq, dk, dv
// written once take 0.080 ms at 3.35 TB/s: the kernel is bound by the
// tensor cores. This first version runs its products on mma.sync from
// ldmatrix operands, two to four warps a block; wgmma, TMA and warp
// specialisation (as the forward has) are later work. Two launches give
// equal bits. Each launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int B, H, KV, Sq, Skv, causal, window;
  int empty_from;    // rows >= this have no valid key (INT_MAX: none)
  float scale;       // 1 / sqrt(hd)
  float scale_log2;  // log2(e) / sqrt(hd)
  float inv_skv;     // an empty row's probability
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled without a read when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero when !pred.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of a (rows, HD) plane with row stride `stride`
// (elements) into shared memory at row pitch LD; rows >= nvalid are zeros.
template <typename T, int ROWS, int HD, int LD, int NTH>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int nvalid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;  // 16-byte chunks a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + NTH - 1) / NTH; ++i) {
    const int c = tid + i * NTH;
    if (kTotal % NTH == 0 || c < kTotal) {
      const int r = c / kChunks, col = (c % kChunks) * kVec;
      const bool ok = row0 + r < nvalid;
      const T* s = ok ? src + (long long)(row0 + r) * stride + col : src;
      cp_async16(dst + r * LD + col, s, ok);
    }
  }
}

// ROWS f32 values [row0, row0 + ROWS) of a vector; zeros from nvalid on.
template <int ROWS, int NTH>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int nvalid, int tid) {
  for (int r = tid; r < ROWS; r += NTH) {
    const bool ok = row0 + r < nvalid;
    cp_async4(dst + r, ok ? src + row0 + r : src, ok);
  }
}

// Two floats as one bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---------------------------------------------------------------------------
// Warp products. A warp holds a 16 x 8NT f32 tile in the m16n8 C layout:
// with g = lane / 4, t = lane % 4, acc[j][e] is row g + 8 (e / 2), column
// 8j + 2t + e % 2. Both types share it, so the masks and the softmax
// algebra are written once.
// ---------------------------------------------------------------------------

// Four 8x8 bf16 matrices; lanes 8m..8m+7 give the row addresses of matrix
// m. Plain: lane l holds row l/4, columns 2(l%4), +1 of each. trans: lane l
// holds rows 2(l%4), +1 of column l/4.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16x8 f32) += a (16x16 bf16, row) b (16x8 bf16, col).
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8NT) += A B^T over KD: A the warp's 16 rows, B 8NT rows, both
// [row][k] in shared memory at pitch ld (NT even).
template <int NT, int KD>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const bf16* A,
                                       const bf16* B, int ld, int lane) {
  const int a_off = (lane & 15) * ld + (lane >> 4) * 8;
  // matrices (rows +0, k +0), (+0, +8), (+8, +0), (+8, +8) = b0, b1 of
  // column tile 2q and b0, b1 of 2q + 1
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, A + a_off + k0);
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) {
      uint32_t b[4];
      ldsm_x4(b, B + b_off + q * 16 * ld + k0);
      mma16816(acc[2 * q], a, b[0], b[1]);
      mma16816(acc[2 * q + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x 8NN) += P B: P (16 x 8NK) an f32 tile in the C layout, rounded
// to bf16 here as the A operand; B (8NK x 8NN) [k][n] in shared memory at
// pitch ld, read by ldmatrix.trans (NK and NN even).
template <int NK, int NN>
__device__ __forceinline__ void mma_nn(float (&acc)[NN][4],
                                       const float (&p)[NK][4], const bf16* B,
                                       int ld, int lane) {
  const int off = ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < NK / 2; ++ks) {
    uint32_t a[4];
    a[0] = pack2(p[2 * ks][0], p[2 * ks][1]);
    a[1] = pack2(p[2 * ks][2], p[2 * ks][3]);
    a[2] = pack2(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    a[3] = pack2(p[2 * ks + 1][2], p[2 * ks + 1][3]);
#pragma unroll
    for (int pp = 0; pp < NN / 2; ++pp) {
      uint32_t b[4];
      ldsm_x4_t(b, B + off + ks * 16 * ld + pp * 16);
      mma16816(acc[2 * pp], a, b[0], b[1]);
      mma16816(acc[2 * pp + 1], a, b[2], b[3]);
    }
  }
}

// f32: acc += A B^T by FFMA, the same operands and layout as above.
template <int NT, int KD>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const float* A,
                                       const float* B, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* ra = A + g * ld;
  const float* rb = A + (g + 8) * ld;
#pragma unroll 2
  for (int d = 0; d < KD; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(ra + d);
    const float4 x1 = *reinterpret_cast<const float4*>(rb + d);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 y = *reinterpret_cast<const float4*>(
            B + (8 * j + 2 * t + e) * ld + d);
        float u = acc[j][e], w = acc[j][2 + e];
        u = fmaf(x0.x, y.x, u);
        u = fmaf(x0.y, y.y, u);
        u = fmaf(x0.z, y.z, u);
        u = fmaf(x0.w, y.w, u);
        w = fmaf(x1.x, y.x, w);
        w = fmaf(x1.y, y.y, w);
        w = fmaf(x1.z, y.z, w);
        w = fmaf(x1.w, y.w, w);
        acc[j][e] = u;
        acc[j][2 + e] = w;
      }
    }
  }
}

// f32: acc += P B by FFMA; each element of P is broadcast from the thread
// of its row that holds it.
template <int NK, int NN>
__device__ __forceinline__ void mma_nn(float (&acc)[NN][4],
                                       const float (&p)[NK][4],
                                       const float* B, int ld, int lane) {
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int src = quad | (c >> 1);
      const float p0 = __shfl_sync(kFull, p[j][c & 1], src);
      const float p1 = __shfl_sync(kFull, p[j][2 + (c & 1)], src);
      const float* br = B + (8 * j + c) * ld + 2 * t;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(br + 8 * n);
        acc[n][0] = fmaf(p0, y.x, acc[n][0]);
        acc[n][1] = fmaf(p0, y.y, acc[n][1]);
        acc[n][2] = fmaf(p1, y.x, acc[n][2]);
        acc[n][3] = fmaf(p1, y.y, acc[n][3]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// ---------------------------------------------------------------------------
// The masks
// ---------------------------------------------------------------------------

// The forward's probability of (qp, kp) from the raw score s and lq = lse
// log2(e): 0 where masked or out of range; 1 / Skv on a row without a
// valid key when `uniform` (the dK/dV pass: dV reads it), else 0 (dS is 0
// on such a row either way).
__device__ __forceinline__ float prob(const Args& a, int qp, int kp, float s,
                                      float lq, bool uniform) {
  if (qp >= a.Sq || kp >= a.Skv) return 0.f;
  if (qp >= a.empty_from) return uniform ? a.inv_skv : 0.f;
  const int lo = a.window > 0 ? qp - a.window + 1 : 0;
  const int hi = a.causal ? qp + 1 : a.Skv;
  return (kp >= lo && kp < hi) ? exp2f(fmaf(s, a.scale_log2, -lq)) : 0.f;
}

// Whether every (query, key) of [q0, q0 + nq) x [k0, k0 + nk) is valid, so
// that a tile needs no per-element mask.
__device__ __forceinline__ bool all_valid(const Args& a, int q0, int nq,
                                          int k0, int nk) {
  return q0 + nq <= a.Sq && k0 + nk <= a.Skv &&
         (!a.causal || k0 + nk - 1 <= q0) &&
         (a.window <= 0 || k0 > q0 + nq - 1 - a.window) &&
         q0 + nq <= a.empty_from;
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot16(const float* x, const float* y) {
  const float4 u = *reinterpret_cast<const float4*>(x);
  const float4 w = *reinterpret_cast<const float4*>(y);
  return fmaf(u.x, w.x, fmaf(u.y, w.y, fmaf(u.z, w.z, u.w * w.w)));
}

__device__ __forceinline__ float dot16(const bf16* x, const bf16* y) {
  const uint4 u = *reinterpret_cast<const uint4*>(x);
  const uint4 w = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* pu = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162* pw = reinterpret_cast<const __nv_bfloat162*>(&w);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fu = __bfloat1622float2(pu[i]);
    const float2 fw = __bfloat1622float2(pw[i]);
    s = fmaf(fu.x, fw.x, fmaf(fu.y, fw.y, s));
  }
  return s;
}

constexpr int kDeltaWarps = 8;

// One warp a row (b, s, h) of the contiguous (B, Sq, H, HD) o and dO.
template <typename T, int HD>
__global__ void __launch_bounds__(32 * kDeltaWarps)
    flash_bwd_delta(const Args a) {
  constexpr int kVec = 16 / sizeof(T);
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long row =
      (long long)blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* o = static_cast<const T*>(a.o) + row * HD;
  const T* d = static_cast<const T*>(a.dout) + row * HD;
  float s = 0.f;
#pragma unroll
  for (int c = lane * kVec; c < HD; c += 32 * kVec) s += dot16(o + c, d + c);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(kFull, s, m);
  if (lane == 0) {
    const int h = (int)(row % a.H);
    const long long bs = row / a.H;  // b * Sq + s
    const int sp = (int)(bs % a.Sq);
    const long long b = bs / a.Sq;
    a.delta[(b * a.H + h) * a.Sq + sp] = s;
  }
}

// ---------------------------------------------------------------------------
// 2. dK and dV
// ---------------------------------------------------------------------------

template <typename T, int HD, int BC, int BR, int NSPLIT>
__global__ void __launch_bounds__(32 * (BC / 16) * NSPLIT)
    flash_bwd_dkdv(const Args a) {
  constexpr int NTH = 32 * (BC / 16) * NSPLIT;
  constexpr int LD = HD + 16 / (int)sizeof(T);  // row pitch, 16 bytes pad
  constexpr int HDP = HD / NSPLIT;              // a warp's dK/dV columns
  constexpr int NT = BR / 8;                    // query tiles of S^T
  constexpr int NN = HDP / 8;                   // column tiles of dK, dV

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [BC][LD]
  T* sV = sK + BC * LD;                    // [BC][LD]
  T* sQ = sV + BC * LD;                    // [2][BR][LD]
  T* sO = sQ + 2 * BR * LD;                // [2][BR][LD] (dO)
  float* sL = reinterpret_cast<float*>(sO + 2 * BR * LD);  // [2][BR] lse
  float* sD = sL + 2 * BR;                                 // [2][BR] delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kw = warp / NSPLIT, part = warp % NSPLIT;
  const int k0 = blockIdx.x * BC;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.KV;

  // the query tiles that read keys [k0, k1]: [qa0, qa1) by the masks,
  // then [qb0, qb1), the rows without a valid key (they read every key)
  const int k1 = min(k0 + BC, a.Skv) - 1;
  const int qlo = a.causal ? k0 : 0;
  const int qhi = a.window > 0 ? min(a.Sq, k1 + a.window) : a.Sq;
  const int qa0 = qlo / BR;
  const int qa1 = qhi > qlo ? (qhi + BR - 1) / BR : qa0;
  int qb0 = qa1, qb1 = qa1;
  if (a.empty_from < a.Sq) {
    qb0 = max(qa1, a.empty_from / BR);
    qb1 = max(qb0, (a.Sq + BR - 1) / BR);
  }
  const int na = qa1 - qa0;
  const int per_head = na + (qb1 - qb0);
  const int items = per_head * rep;

  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const long long o_ss = (long long)a.H * HD;  // dO's row stride

  auto item_q0 = [&](int i) {
    const int j = i % per_head;
    return (j < na ? qa0 + j : qb0 + j - na) * BR;
  };
  auto load_item = [&](int i, int s) {
    const int h = kvh * rep + i / per_head, q0 = item_q0(i);
    const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* og = static_cast<const T*>(a.dout) +
                  ((long long)b * a.Sq * a.H + h) * HD;
    load_rows<T, BR, HD, LD, NTH>(sQ + s * BR * LD, qg, a.q_ss, q0, a.Sq,
                                  tid);
    load_rows<T, BR, HD, LD, NTH>(sO + s * BR * LD, og, o_ss, q0, a.Sq, tid);
    const long long row = ((long long)b * a.H + h) * a.Sq;
    load_vec<BR, NTH>(sL + s * BR, a.lse + row, q0, a.Sq, tid);
    load_vec<BR, NTH>(sD + s * BR, a.delta + row, q0, a.Sq, tid);
  };

  load_rows<T, BC, HD, LD, NTH>(sK, kg, a.k_ss, k0, a.Skv, tid);
  load_rows<T, BC, HD, LD, NTH>(sV, vg, a.v_ss, k0, a.Skv, tid);
  if (items > 0) load_item(0, 0);
  cp_async_commit();

  float dk[NN][4], dv[NN][4];
  zero(dk);
  zero(dv);
  const T* k_w = sK + kw * 16 * LD;
  const T* v_w = sV + kw * 16 * LD;
  const int kr = k0 + kw * 16 + g;  // this thread's keys kr, kr + 8

  for (int i = 0; i < items; ++i) {
    const int s = i & 1;
    if (i + 1 < items) load_item(i + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait_1();  // this item (and K, V) have landed
    __syncthreads();
    const int q0 = item_q0(i);
    const T* q_s = sQ + s * BR * LD;
    const T* o_s = sO + s * BR * LD;
    const float* l_s = sL + s * BR;
    const float* d_s = sD + s * BR;
    const bool full = all_valid(a, q0, BR, k0, BC);

    float p[NT][4];
    zero(p);
    mma_nt<NT, HD>(p, k_w, q_s, LD, lane);  // S^T: keys x queries
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float lq = l_s[qc] * kLog2e;
        p[j][e] = full ? exp2f(fmaf(p[j][e], a.scale_log2, -lq))
                       : prob(a, q0 + qc, kr + 8 * (e >> 1), p[j][e], lq,
                              true);
      }
    }
    mma_nn<NT, NN>(dv, p, o_s + part * HDP, LD, lane);  // dV += P^T dO

    float dp[NT][4];
    zero(dp);
    mma_nt<NT, HD>(dp, v_w, o_s, LD, lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * j + 2 * t + (e & 1);
        const float ds = p[j][e] * (dp[j][e] - d_s[qc]);
        p[j][e] = (full || q0 + qc < a.empty_from) ? ds : 0.f;
      }
    }
    mma_nn<NT, NN>(dk, p, q_s + part * HDP, LD, lane);  // dK += dS^T Q
    __syncthreads();  // the next item refills this stage
  }

  T* dkg = static_cast<T*>(a.dk);
  T* dvg = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = kr + 8 * r;
    if (kp >= a.Skv) continue;
    const long long base =
        (((long long)b * a.Skv + kp) * a.KV + kvh) * HD + part * HDP + 2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      store2(dkg + base + 8 * n, dk[n][2 * r] * a.scale,
             dk[n][2 * r + 1] * a.scale);
      store2(dvg + base + 8 * n, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ
// ---------------------------------------------------------------------------

template <typename T, int HD, int BM, int BN>
__global__ void __launch_bounds__(2 * BM) flash_bwd_dq(const Args a) {
  constexpr int NTH = 2 * BM;  // a warp 16 rows
  constexpr int LD = HD + 16 / (int)sizeof(T);
  constexpr int NT = BN / 8;  // key tiles of S
  constexpr int NN = HD / 8;  // column tiles of dQ

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BM][LD]
  T* sO = sQ + BM * LD;                    // [BM][LD] (dO)
  T* sK = sO + BM * LD;                    // [2][BN][LD]
  T* sV = sK + 2 * BN * LD;                // [2][BN][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the last query blocks first: under a causal mask they walk the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* og =
      static_cast<const T*>(a.dout) + ((long long)b * a.Sq * a.H + h) * HD;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // this thread's rows: their lse (times log2 e) and delta
  const long long row0 = ((long long)b * a.H + h) * a.Sq;
  int qp[2];
  float lq[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qp[r] = q0 + warp * 16 + g + 8 * r;
    const bool ok = qp[r] < a.Sq;
    lq[r] = ok ? a.lse[row0 + qp[r]] * kLog2e : 0.f;
    dd[r] = ok ? a.delta[row0 + qp[r]] : 0.f;
  }

  // the keys the block's rows read (none for rows without a valid key)
  const int q_last = min(q0 + BM, a.Sq) - 1;
  int kbeg = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kbeg = (kbeg / BN) * BN;
  const int kend = a.causal ? min(q_last + 1, a.Skv) : a.Skv;
  const int ntiles = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;

  load_rows<T, BM, HD, LD, NTH>(sQ, qg, a.q_ss, q0, a.Sq, tid);
  load_rows<T, BM, HD, LD, NTH>(sO, og, (long long)a.H * HD, q0, a.Sq, tid);
  if (ntiles > 0) {
    load_rows<T, BN, HD, LD, NTH>(sK, kg, a.k_ss, kbeg, a.Skv, tid);
    load_rows<T, BN, HD, LD, NTH>(sV, vg, a.v_ss, kbeg, a.Skv, tid);
  }
  cp_async_commit();

  float dq[NN][4];
  zero(dq);
  const T* q_w = sQ + warp * 16 * LD;
  const T* o_w = sO + warp * 16 * LD;

  for (int it = 0; it < ntiles; ++it) {
    const int kt = kbeg + it * BN;
    const int s = it & 1;
    if (it + 1 < ntiles) {
      load_rows<T, BN, HD, LD, NTH>(sK + (s ^ 1) * BN * LD, kg, a.k_ss,
                                    kt + BN, a.Skv, tid);
      load_rows<T, BN, HD, LD, NTH>(sV + (s ^ 1) * BN * LD, vg, a.v_ss,
                                    kt + BN, a.Skv, tid);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const T* k_s = sK + s * BN * LD;
    const T* v_s = sV + s * BN * LD;
    const bool full = all_valid(a, q0, BM, kt, BN);

    float p[NT][4];
    zero(p);
    mma_nt<NT, HD>(p, q_w, k_s, LD, lane);  // S: queries x keys
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        p[j][e] = full ? exp2f(fmaf(p[j][e], a.scale_log2, -lq[r]))
                       : prob(a, qp[r], kt + 8 * j + 2 * t + (e & 1), p[j][e],
                              lq[r], false);
      }
    }
    float dp[NT][4];
    zero(dp);
    mma_nt<NT, HD>(dp, o_w, v_s, LD, lane);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - dd[e >> 1];  // dS
    }
    mma_nn<NT, NN>(dq, p, k_s, LD, lane);  // dQ += dS K
    __syncthreads();  // the next tile refills this stage
  }

  T* dqg = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp[r] >= a.Sq) continue;
    const long long base = (((long long)b * a.Sq + qp[r]) * a.H + h) * HD +
                           2 * t;
#pragma unroll
    for (int n = 0; n < NN; ++n)
      store2(dqg + base + 8 * n, dq[n][2 * r] * a.scale,
             dq[n][2 * r + 1] * a.scale);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The three launches of one backward. dK/dV: blocks of BC keys, query
// tiles of BR, NSPLIT warps sharing 16 keys; dQ: blocks of BM queries, key
// tiles of BN.
template <typename T, int HD, int BC, int BR, int NSPLIT, int BM, int BN>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int LD = HD + 16 / (int)sizeof(T);
  constexpr int smem_kv =
      (2 * BC + 4 * BR) * LD * (int)sizeof(T) + 4 * BR * (int)sizeof(float);
  constexpr int smem_q = (2 * BM + 4 * BN) * LD * (int)sizeof(T);
  static bool configured = false;  // once per instantiation, before capture
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv<T, HD, BC, BR, NSPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq<T, HD, BM, BN>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_q);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_delta<T, HD>
      <<<(unsigned)((rows + kDeltaWarps - 1) / kDeltaWarps), 32 * kDeltaWarps,
         0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((a.Skv + BC - 1) / BC, a.KV, a.B);
  flash_bwd_dkdv<T, HD, BC, BR, NSPLIT>
      <<<grid_kv, 32 * (BC / 16) * NSPLIT, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((a.Sq + BM - 1) / BM, a.H, a.B);
  flash_bwd_dq<T, HD, BM, BN><<<grid_q, 2 * BM, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int hd, int dtype, cudaStream_t s) {
  if (dtype == 0) {  // f32: smaller tiles (4-byte elements)
    switch (hd) {
      case 64:
        return launch<float, 64, 64, 16, 1, 64, 32>(a, s);
      case 96:
        return launch<float, 96, 64, 16, 1, 64, 32>(a, s);
      case 112:
        return launch<float, 112, 64, 16, 1, 64, 32>(a, s);
      case 128:
        return launch<float, 128, 64, 16, 1, 64, 32>(a, s);
      case 256:
        return launch<float, 256, 32, 16, 2, 32, 16>(a, s);
    }
  } else if (dtype == 1) {
    // hd 256: dK and dV of 16 keys would take 256 accumulators a thread,
    // so two warps share 16 keys, each owning 128 columns
    switch (hd) {
      case 64:
        return launch<bf16, 64, 64, 64, 1, 64, 64>(a, s);
      case 96:
        return launch<bf16, 96, 64, 32, 1, 64, 64>(a, s);
      case 112:
        return launch<bf16, 112, 64, 32, 1, 64, 64>(a, s);
      case 128:
        return launch<bf16, 128, 64, 32, 1, 64, 64>(a, s);
      case 256:
        return launch<bf16, 256, 32, 32, 2, 64, 32>(a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point, bound with ctypes. Strides are in elements; o, dO, lse
// contiguous; delta a (B, H, Sq) f32 scratch. dtype: 0 f32, 1 bf16.
// window <= 0: none. Launches on `stream` (PyTorch's current stream), does
// not synchronise, and returns cudaGetLastError() so that a refused launch
// is reported to the caller.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, int B, int H, int KV, int Sq, int Skv, int hd, int causal,
    int window, int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || KV < 1 || H % KV != 0 ||
      Sq < 1 || Skv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
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
  a.KV = KV;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  // a window of Sq or more masks nothing (kp > qp - window for every qp <
  // Sq) and leaves no row empty: the same as none
  a.window = window > 0 && window < Sq ? window : 0;
  a.empty_from = a.window > 0 ? Skv + a.window - 1 : INT_MAX;
  a.scale = (float)(1.0 / sqrt((double)hd));
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  a.inv_skv = 1.0f / (float)Skv;
  return dispatch(a, hd, dtype, (cudaStream_t)stream);
}
