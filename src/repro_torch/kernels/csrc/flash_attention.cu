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
// 3.35 TB/s) are close: the kernel has to keep the tensor cores busy.
//
// Design (FlashAttention-2 dataflow, written simply):
//  * a block owns 64 query rows of one (b, h); each of its 4 warps owns 16
//    rows and walks the block's key range in tiles of 64 keys (32 at hd 256);
//    blocks start from the last query block, the longest under a causal mask;
//  * q, k and v tiles go to shared memory with 16-byte cp.async, rows padded
//    by 16 bytes so ldmatrix reads are free of bank conflicts; the next K/V
//    tile loads while the current one is used (two stages); rows past Sq or
//    Skv are zero-filled and never read into the sum (0 * NaN would poison
//    it);
//  * bf16: S = Q K^T and O += P V on the tensor cores (mma.sync m16n8k16,
//    f32 accumulators); P is rounded to bf16 for the second product;
//  * f32: the same tiles and the same register layout, but both products in
//    f32 FFMA (no TF32), so the f32 result matches the CPU's to rounding;
//  * online softmax in f32 in base 2, row max and sum across the 4 threads of
//    a row by shuffles; key tiles outside the block's valid range are skipped;
//  * no atomics: every output is written once by one thread, so two launches
//    give equal bits. hd 256 needs more than the 48 KB default of shared
//    memory; the launch sets cudaFuncAttributeMaxDynamicSharedMemorySize and
//    returns cudaGetLastError().
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows of a block, 16 a warp
constexpr float kNegInf = -1e30f;     // the model's mask value
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
  int H, KV, Sq, Skv, causal, window;
  float scale_log2;  // log2(e) / sqrt(hd)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a * b in bf16: a 16x16 (row), b 16x8 (col), d 16x8 f32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16 pair, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack2(x, y);
}

// Rows [row0, row0 + ROWS) of a (rows, HD) plane with row stride `stride`
// into shared memory (row pitch LD); rows >= nvalid are zero-filled.
template <typename T, int ROWS, int HD, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long stride, int row0,
                                          int nvalid, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;  // 16-byte chunks a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kTotal + kThreads - 1) / kThreads; ++i) {
    const int c = tid + i * kThreads;
    if (kTotal % kThreads == 0 || c < kTotal) {
      const int r = c / kChunks, col = (c % kChunks) * kVec;
      const bool ok = row0 + r < nvalid;
      const T* s = ok ? src + (long long)(row0 + r) * stride + col : src;
      cp_async16(dst + r * LD + col, s, ok);
    }
  }
}

// Register layout shared by both paths (that of mma.m16n8k16): lane = 4*g +
// t; s[j][e] holds row g + 8*(e >> 1) of the warp's 16 rows and column
// 8*j + 2*t + (e & 1) of the tile.

// s = Q K^T on the tensor cores. q_s: the warp's 16 rows; k_s: BN = 8*NT keys.
template <int HD, int NT, int LD>
__device__ __forceinline__ void scores_mma(float (&s)[NT][4],
                                           const __nv_bfloat16* q_s,
                                           const __nv_bfloat16* k_s,
                                           int lane) {
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    uint32_t qa[4];
    ldsm_x4(qa, q_s + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kb[4];
      ldsm_x4(kb, k_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      kc * 16 + ((lane >> 3) & 1) * 8);
      mma16816(s[2 * np], qa, kb[0], kb[1]);
      mma16816(s[2 * np + 1], qa, kb[2], kb[3]);
    }
  }
}

// acc += P V on the tensor cores, P (the probabilities in s) rounded to bf16.
template <int HD, int NT, int LD>
__device__ __forceinline__ void pv_mma(float (&acc)[HD / 8][4],
                                       const float (&p)[NT][4],
                                       const __nv_bfloat16* v_s, int lane) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    uint32_t pa[4];
    pa[0] = pack2(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack2(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack2(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack2(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t vb[4];
      ldsm_x4_t(vb, v_s + (kc * 16 + (lane & 15)) * LD + np * 16 +
                        (lane >> 4) * 8);
      mma16816(acc[2 * np], pa, vb[0], vb[1]);
      mma16816(acc[2 * np + 1], pa, vb[2], vb[3]);
    }
  }
}

// s = Q K^T in f32 FFMA, in the layout above.
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

// Valid keys of query qp are [lo, hi) (empty when lo >= hi).
__device__ __forceinline__ void row_range(const Args& a, int qp, int st,
                                          int& lo, int& hi) {
  lo = st > 0 ? st : 0;
  if (a.window > 0) lo = max(lo, qp - a.window + 1);
  hi = a.causal ? min(qp + 1, a.Skv) : a.Skv;
}

template <typename T, int HD, int BN>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int LD = HD + 16 / sizeof(T);  // row pitch, padded by 16 bytes
  constexpr int NT = BN / 8;               // 8-key column tiles of S
  constexpr int NO = HD / 8;               // 8-wide column tiles of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [kBlockM][LD]
  T* sK = sQ + kBlockM * LD;               // [2][BN][LD]
  T* sV = sK + 2 * BN * LD;                // [2][BN][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int st = a.start != nullptr ? a.start[b] : 0;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

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
  row_range(a, min(q0 + kBlockM, a.Sq) - 1, st, lo_last, hi_last);
  int kbeg = any_empty ? 0 : lo_first;
  const int kend = any_empty ? a.Skv : hi_last;
  kbeg = (kbeg / BN) * BN;
  const int ntiles = (kend - kbeg + BN - 1) / BN;

  load_rows<T, kBlockM, HD, LD>(sQ, qg, a.q_ss, q0, a.Sq, tid);
  load_rows<T, BN, HD, LD>(sK, kg, a.k_ss, kbeg, a.Skv, tid);
  load_rows<T, BN, HD, LD>(sV, vg, a.v_ss, kbeg, a.Skv, tid);
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
      load_rows<T, BN, HD, LD>(sK + (stage ^ 1) * BN * LD, kg, a.k_ss,
                               kt + BN, a.Skv, tid);
      load_rows<T, BN, HD, LD>(sV + (stage ^ 1) * BN * LD, vg, a.v_ss,
                               kt + BN, a.Skv, tid);
    }
    cp_async_commit();
    cp_async_wait_1();  // this tile (and q) have landed
    __syncthreads();
    const T* q_s = sQ + warp * 16 * LD;
    const T* k_s = sK + stage * BN * LD;
    const T* v_s = sV + stage * BN * LD;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kF32) {
      scores_f32<HD, NT, LD>(s, q_s, k_s, g, t);
    } else {
      scores_mma<HD, NT, LD>(s, q_s, k_s, lane);
    }

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

    if constexpr (kF32) {
      pv_f32<HD, NT, LD>(acc, s, v_s, lane, t);
    } else {
      pv_mma<HD, NT, LD>(acc, s, v_s, lane);
    }
    __syncthreads();  // the next iteration refills this stage
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (qp[r] >= a.Sq) continue;
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    T* orow = o + (((long long)b * a.Sq + qp[r]) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(orow + 8 * n, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qp[r]] =
          empty[r] ? kNegInf : (m[r] + log2f(sum)) * kLn2;
  }
}

template <typename T, int HD, int BN>
int launch_one(const Args& a, int B, cudaStream_t stream) {
  constexpr int LD = HD + 16 / sizeof(T);
  const int smem = (kBlockM + 4 * BN) * LD * (int)sizeof(T);
  static bool configured = false;  // once per instantiation, before capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((a.Sq + kBlockM - 1) / kBlockM, a.H, B);
  flash_fwd_kernel<T, HD, BN><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(const Args& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_one<T, 64, 64>(a, B, stream);
    case 128:
      return launch_one<T, 128, 64>(a, B, stream);
    case 256:
      return launch_one<T, 256, 32>(a, B, stream);
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
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Skv = Skv;
  a.causal = causal;
  a.window = window;
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)hd));
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_hd<float>(a, B, hd, s);
    case 1:
      return dispatch_hd<__nv_bfloat16>(a, B, hd, s);
  }
  return (int)cudaErrorInvalidValue;
}
