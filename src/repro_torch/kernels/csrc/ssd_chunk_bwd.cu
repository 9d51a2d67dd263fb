// Backward of the Mamba2 SSD intra-chunk step for Hopper (sm_90a): the FFMA
// route, for f32 inputs and for what the tensor-core route
// (ssd_chunk_bwd_tc.cu, which bf16 training takes) does not: chunks over
// 256, head_dim over 64, d_state over 128, rows not 16-byte aligned.
//
// Replaces no TPU kernel: repro/kernels/ssd_scan.py::ssd_chunk_pallas has no
// backward, and the reference trains by differentiating its einsums through
// XLA. This is the gradient of the port's ssd_chunk kernel (ssd_chunk.cu),
// so that SSM and hybrid training run a hand-written kernel on the card.
//
// Inputs, in the forward's layout:
//   x     (b, s, h, p)     bf16 or f32; strides over b, s, h, the last dim
//                          contiguous (the model passes a view of the conv
//                          output)
//   dt    (b, s, h)        f32, any strides
//   cum   (b, s, h)        f32 cumulative dt*A within each chunk, any strides
//   B, C  (b, s, g, n)     x's dtype; head hh reads group hh / (h / g)
//   dy    (b, s, h, p)     f32 gradient of y, the last dim contiguous
//   dst   (b, nc, h, n, p) f32 gradient of the states, contiguous (null:
//                          zeros)
// Outputs, all contiguous:
//   dx    (b, s, h, p)     x's dtype
//   ddt, dcum (b, s, h)    f32
//   dB, dC (b, s, g, n)    x's dtype (dC f32 where C came as f32 beside bf16
//                          x), summed over the heads of a group in f32 and
//                          then rounded once
//   part  (2, b, s, h, n)  f32 scratch: each head's dB, then dC rows
//
// Per (batch, head, chunk) of c rows, with i, j rows of the chunk:
//   L[i,j] = exp(cum_i - cum_j) for j <= i, else 0   (exp never above the
//            diagonal, where it can overflow: a masked inf would make the
//            zero cotangent NaN)
//   CB = C B^T,  W = CB o L o dt_j,  e_j = exp(cum_last - cum_j)
//   G = (dy x^T) o L,  M = G o CB o dt_j,  r_j = sum_q B[j,q] (x_j . dst[q])
//   dx   = W^T dy + (dt o e) o (B dst)
//   dC   = (G o dt_j) B
//   dB   = (G o dt_j)^T C + (dt o e) o (x dst^T)
//   ddt  = colsum(G o CB) + e o r
//   dcum = rowsum(M) - colsum(M) - dt o e o r,
//          dcum_last += sum_j dt_j e_j r_j
//
// Bound: HBM bytes. At the mamba2-780m training shape (b 8, s 1,024, h 48,
// p 64, g 1, n 128, chunk 256, x/B/C bf16) the inputs are 208.7 MB (dy 100.7
// and dst 50.3 of them in f32) and the outputs 57.7 MB, 0.080 ms at 3.35
// TB/s; the causal products are ~52 GFLOP, 0.052 ms at the bf16 tensor
// cores' 989 TFLOP/s.
//
// Design: right and simple first. One 256-thread block per (b, head,
// chunk), everything in f32 FFMA (no TF32, no tensor cores: dy and dst are
// f32, so the tensor cores would need hi/lo splits of both operands). The
// chunk is cut into 64-row tiles, each held transposed in shared memory
// ([feature][row], row stride 65: conflict-free both along rows and along
// features), and every 64 x 64 product is a 4 x 4 register tile a thread:
//  * pass 1, a loop over key tiles j: the state terms of tile j first (dst
//    in shared memory), then over query tiles i >= j: CB and dy x^T, the
//    masked W and G o dt_j into shared memory, and dx_j += W^T dy_i,
//    dB_j += (G o dt_j)^T C_i in registers; ddt_j and the column terms of
//    dcum_j are written when the key tile is done;
//  * pass 2, a loop over query tiles i, then over key tiles j <= i: CB and
//    dy x^T again, dC_i += (G o dt_j) B_j, and rowsum(M) added into
//    dcum_i (read back from pass 1 by the same block);
//  * each head's dB and dC rows go to `part` in f32; a second kernel of the
//    same launch sums them over the group's heads in a fixed order and
//    rounds once (the adjoint of the reference's repeat of B and C over
//    heads).
// Each (i, j) tile pair's two products are computed twice (once a pass), so
// the kernel does ~1.3x the FLOPs above at the FFMA rate: it cannot beat
// ~1 ms at the mamba2-780m shape. Every output element is written by one
// thread (no atomics), so two launches give equal bits. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kThreads = 256;    // 16 x 16: thread (ty, tx)
constexpr int kPad = kTile + 1;  // row stride of a transposed tile
constexpr int kMaxN = 128;
constexpr int kMaxP = 128;
constexpr int kVecs = 7;         // 64-float row vectors in shared memory

typedef __nv_bfloat16 bf16;

struct Args {
  const void* x;
  const float* dt;
  const float* cum;
  const void* B;
  const void* C;
  const float* dy;
  const float* dst;
  void* dx;
  float* ddt;
  float* dcum;
  float* part;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long cum_sb, cum_ss, cum_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long dy_sb, dy_ss, dy_sh;
  int batch, S, H, P, G, N, chunk, n_tiles;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_floats(int n, int p) {
  // xT, dyT [p][65]; BT, CT [n][65]; W, Gd [64][65]; the ddt reduction
  // [16][64]; the row vectors; the last row's scalar
  return 2 * (size_t)(p + n) * kPad + 2 * (size_t)kTile * kPad +
         16 * kTile + kVecs * kTile + 1;
}

// rows [r0, r0 + 64) of a (rows, width) matrix with row stride rs, into
// dst[k][r] (row stride kPad); zeros past the chunk
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* src,
                                       long long rs, long long row0, int r0,
                                       int chunk, int width) {
  for (int e = threadIdx.x; e < kTile * width; e += kThreads) {
    const int r = e / width, k = e - r * width;
    const int rl = r0 + r;
    dst[k * kPad + r] = rl < chunk ? to_f32(src[(row0 + rl) * rs + k]) : 0.f;
  }
}

// 16-lane sum (the lanes of one ty: lanes 0-15 and 16-31 of a warp)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// PC / NC: columns of p / n a thread owns (p <= 16 * PC, n <= 16 * NC)
template <typename T, int PC, int NC>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_bwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N;
  float* xT = smem;                  // x_j     [col][j]
  float* BT = xT + P * kPad;         // B_j     [q][j]
  float* dyT = BT + N * kPad;        // dy_i    [col][i]
  float* CT = dyT + P * kPad;        // C_i     [q][i]; dst over dyT + CT
  float* Ws = CT + N * kPad;         // W       [i][j]
  float* Gd = Ws + kTile * kPad;     // G o dt  [i][j]
  float* red = Gd + kTile * kPad;    // [16][64]
  float* dtj = red + 16 * kTile;     // dt_j
  float* cumj = dtj + kTile;         // cum_j
  float* cumi = cumj + kTile;        // cum_i
  float* ej = cumi + kTile;          // e_j
  float* dtej = ej + kTile;          // dt_j e_j
  float* rj = dtej + kTile;          // r_j
  float* term = rj + kTile;          // dt_j e_j r_j
  float* last = term + kTile;        // sum_j dt_j e_j r_j over the chunk
  float* dsts = dyT;                 // dst [q][col], row stride P + 1

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ci = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.H, hh = bh - b * a.H;
  const int grp = hh / (a.H / a.G);
  const int chunk = a.chunk;
  const long long row0 = (long long)ci * chunk;
  const long long nc = gridDim.x;

  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + hh * a.x_sh;
  const float* dt = a.dt + b * a.dt_sb + hh * a.dt_sh;
  const float* cum = a.cum + b * a.cum_sb + hh * a.cum_sh;
  const T* Bp = static_cast<const T*>(a.B) + b * a.B_sb + grp * a.B_sg;
  const T* Cp = static_cast<const T*>(a.C) + b * a.C_sb + grp * a.C_sg;
  const float* dy = a.dy + b * a.dy_sb + hh * a.dy_sh;
  const float* dst =
      a.dst == nullptr ? nullptr
                       : a.dst + (((long long)b * nc + ci) * a.H + hh) *
                                     (long long)N * P;
  const float cum_last = cum[(row0 + chunk - 1) * a.cum_ss];
  // (b, s, h, .) row offsets of this head
  auto at = [&](int rl, int width) {
    return (((long long)b * a.S + row0 + rl) * a.H + hh) * width;
  };
  float* part_b = a.part;
  float* part_c = a.part + (long long)a.batch * a.S * a.H * N;

  if (tid == 0) *last = 0.f;
  const int rows = a.n_tiles * kTile;

  // x, B, dt and cum of the key tile at j0, and e_j
  auto load_keys = [&](int j0) {
    load_t(xT, x, a.x_ss, row0, j0, chunk, P);
    load_t(BT, Bp, a.B_ss, row0, j0, chunk, N);
    if (tid < kTile) {
      const int jl = j0 + tid;
      const bool in = jl < chunk;
      const float d = in ? dt[(row0 + jl) * a.dt_ss] : 0.f;
      const float c = in ? cum[(row0 + jl) * a.cum_ss] : 0.f;
      const float e = in ? expf(cum_last - c) : 0.f;
      dtj[tid] = d;
      cumj[tid] = c;
      ej[tid] = e;
      dtej[tid] = d * e;
    }
  };
  // dy, C and cum of the query tile at i0
  auto load_queries = [&](int i0) {
    load_t(dyT, dy, a.dy_ss, row0, i0, chunk, P);
    load_t(CT, Cp, a.C_ss, row0, i0, chunk, N);
    if (tid < kTile) {
      const int il = i0 + tid;
      cumi[tid] = il < chunk ? cum[(row0 + il) * a.cum_ss] : 0.f;
    }
  };
  // s = C_i B_j^T and gr = dy_i x_j^T at (i, j) = (ty + 16r, tx + 16c)
  auto products = [&](float (&s)[4][4], float (&gr)[4][4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = gr[r][c] = 0.f;
    for (int k = 0; k < N; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = CT[k * kPad + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = BT[k * kPad + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
    }
    for (int k = 0; k < P; ++k) {
      float dv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = dyT[k * kPad + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = xT[k * kPad + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) gr[r][c] = fmaf(dv[r], xv[c], gr[r][c]);
    }
  };

  // ---- pass 1: key tiles j: dx, dB (this head), ddt, dcum's column terms
  for (int j0 = 0; j0 < rows; j0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_keys(j0);
    if (dst != nullptr) {
      for (int e = tid; e < N * P; e += kThreads) {
        const int q = e / P, col = e - q * P;
        dsts[q * (P + 1) + col] = dst[e];
      }
    }
    __syncthreads();
    float accx[4][PC], accb[4][NC];
    {
      float rp[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        rp[r] = 0.f;
#pragma unroll
        for (int c = 0; c < PC; ++c) accx[r][c] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) accb[r][c] = 0.f;
      }
      if (dst != nullptr) {
        // accx = B_j dst, accb = x_j dst^T at (j, col / q) = (ty + 16r,
        // tx + 16c)
        for (int q = 0; q < N; ++q) {
          float bv[4], dv[PC];
#pragma unroll
          for (int r = 0; r < 4; ++r) bv[r] = BT[q * kPad + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < PC; ++c) {
            const int col = tx + 16 * c;
            dv[c] = col < P ? dsts[q * (P + 1) + col] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < PC; ++c)
              accx[r][c] = fmaf(bv[r], dv[c], accx[r][c]);
        }
        for (int col = 0; col < P; ++col) {
          float xv[4], dv[NC];
#pragma unroll
          for (int r = 0; r < 4; ++r) xv[r] = xT[col * kPad + ty + 16 * r];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int q = tx + 16 * c;
            dv[c] = q < N ? dsts[q * (P + 1) + col] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              accb[r][c] = fmaf(xv[r], dv[c], accb[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = ty + 16 * r;
          const float w = dtej[j];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int q = tx + 16 * c;
            if (q < N) rp[r] = fmaf(BT[q * kPad + j], accb[r][c], rp[r]);
            accb[r][c] *= w;
          }
#pragma unroll
          for (int c = 0; c < PC; ++c) accx[r][c] *= w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = sum16(rp[r]);
        if (tx == 0) rj[ty + 16 * r] = v;
      }
    }
    float ddt_acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = j0; i0 < rows; i0 += kTile) {
      __syncthreads();  // dst, W and Gd readers are done
      load_queries(i0);
      __syncthreads();
      float s[4][4], gr[4][4];
      products(s, gr);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * r, j = tx + 16 * c;
          const int il = i0 + i, jl = j0 + j;
          float w = 0.f, gd = 0.f;
          if (jl <= il && il < chunk) {  // exp only on or below the diagonal
            const float L = expf(cumi[i] - cumj[j]);
            const float G = gr[r][c] * L;
            w = s[r][c] * L * dtj[j];
            gd = G * dtj[j];
            ddt_acc[c] = fmaf(G, s[r][c], ddt_acc[c]);
          }
          Ws[i * kPad + j] = w;
          Gd[i * kPad + j] = gd;
        }
      }
      __syncthreads();
      // dx_j += W^T dy_i, dB_j += Gd^T C_i at (j, col / q) = (ty + 16r,
      // tx + 16c)
      for (int i = 0; i < kTile; ++i) {
        float wv[4], gv[4], dv[PC], cv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wv[r] = Ws[i * kPad + ty + 16 * r];
          gv[r] = Gd[i * kPad + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int col = tx + 16 * c;
          dv[c] = col < P ? dyT[col * kPad + i] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int q = tx + 16 * c;
          cv[c] = q < N ? CT[q * kPad + i] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < PC; ++c)
            accx[r][c] = fmaf(wv[r], dv[c], accx[r][c]);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            accb[r][c] = fmaf(gv[r], cv[c], accb[r][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty * kTile + tx + 16 * c] = ddt_acc[c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jl = j0 + ty + 16 * r;
      if (jl >= chunk) continue;
      T* dxrow = static_cast<T*>(a.dx) + at(jl, P);
      float* dbrow = part_b + at(jl, N);
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int col = tx + 16 * c;
        if (col < P) store(dxrow + col, accx[r][c]);
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int q = tx + 16 * c;
        if (q < N) dbrow[q] = accb[r][c];
      }
    }
    __syncthreads();
    if (tid < kTile) {
      const int jl = j0 + tid;
      float t = 0.f;
      if (jl < chunk) {
        float cs = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) cs += red[k * kTile + tid];
        t = dtej[tid] * rj[tid];
        const long long o = at(jl, 1);
        a.ddt[o] = cs + ej[tid] * rj[tid];
        a.dcum[o] = -dtj[tid] * cs - t;
      }
      term[tid] = t;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = *last;
      for (int k = 0; k < kTile; ++k) acc += term[k];
      *last = acc;
    }
  }

  // ---- pass 2: query tiles i: dC (this head) and dcum's row terms --------
  for (int i0 = 0; i0 < rows; i0 += kTile) {
    __syncthreads();
    load_queries(i0);
    float accc[4][NC], mrow[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      mrow[r] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) accc[r][c] = 0.f;
    }
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      __syncthreads();  // Gd, x and B readers are done
      load_keys(j0);
      __syncthreads();
      float s[4][4], gr[4][4];
      products(s, gr);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * r, j = tx + 16 * c;
          const int il = i0 + i, jl = j0 + j;
          float gd = 0.f;
          if (jl <= il && il < chunk) {
            gd = gr[r][c] * expf(cumi[i] - cumj[j]) * dtj[j];
            mrow[r] = fmaf(gd, s[r][c], mrow[r]);
          }
          Gd[i * kPad + j] = gd;
        }
      }
      __syncthreads();
      // dC_i += Gd B_j at (i, q) = (ty + 16r, tx + 16c)
      for (int j = 0; j < kTile; ++j) {
        float gv[4], bv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) gv[r] = Gd[(ty + 16 * r) * kPad + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int q = tx + 16 * c;
          bv[c] = q < N ? BT[q * kPad + j] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            accc[r][c] = fmaf(gv[r], bv[c], accc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = i0 + ty + 16 * r;
      const float m = sum16(mrow[r]);
      if (il >= chunk) continue;
      float* dcrow = part_c + at(il, N);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int q = tx + 16 * c;
        if (q < N) dcrow[q] = accc[r][c];
      }
      if (tx == 0) {  // pass 1 wrote this element, in this block
        const long long o = at(il, 1);
        a.dcum[o] += m + (il == chunk - 1 ? *last : 0.f);
      }
    }
  }
}

// dB and dC: each head's f32 rows summed over its group's heads, in order,
// then rounded once. part (2, rows, H, N) -> out (rows, G, N), rows = b*s.
template <typename T, typename TC>
__global__ void __launch_bounds__(256)
ssd_group_sum_kernel(const float* part, T* dB, TC* dC, long long rows, int H,
                     int G, int N) {
  const int rep = H / G;
  const long long per = rows * G * N;
  const long long half = rows * H * N;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < 2 * per; e += (long long)gridDim.x * blockDim.x) {
    const int which = e >= per;
    const long long o = e - which * per;
    const int q = (int)(o % N);
    const long long rg = o / N;
    const int g = (int)(rg % G);
    const long long row = rg / G;
    const float* src = part + which * half + (row * H + (long long)g * rep) *
                                                 N + q;
    float acc = 0.f;
    for (int r = 0; r < rep; ++r) acc += src[(long long)r * N];
    if (which) {
      store(dC + o, acc);
    } else {
      store(dB + o, acc);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

template <typename T, int PC, int NC>
int launch(const Args& a, int batch, void* dB, void* dC, int dc_f32,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_bwd_kernel<T, PC, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(kMaxN, kMaxP)));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(a.S / a.chunk, batch * a.H);
  ssd_chunk_bwd_kernel<T, PC, NC>
      <<<grid, kThreads, sizeof(float) * smem_floats(a.N, a.P), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * a.S;
  const long long total = 2 * rows * a.G * a.N;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 8LL * sm_count() ? want : 8LL * sm_count());
  if (dc_f32) {
    ssd_group_sum_kernel<T, float><<<blocks, 256, 0, stream>>>(
        a.part, static_cast<T*>(dB), static_cast<float*>(dC), rows, a.H, a.G,
        a.N);
  } else {
    ssd_group_sum_kernel<T, T><<<blocks, 256, 0, stream>>>(
        a.part, static_cast<T*>(dB), static_cast<T*>(dC), rows, a.H, a.G,
        a.N);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int batch, void* dB, void* dC, int dc_f32,
             cudaStream_t s) {
  if (a.P <= 64) {
    return a.N <= 64 ? launch<T, 4, 4>(a, batch, dB, dC, dc_f32, s)
                     : launch<T, 4, 8>(a, batch, dB, dC, dc_f32, s);
  }
  return a.N <= 64 ? launch<T, 8, 4>(a, batch, dB, dC, dc_f32, s)
                   : launch<T, 8, 8>(a, batch, dB, dC, dc_f32, s);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 float32, 1 bfloat16 (x, B, C,
// dx and dB share it; dC too, or float32 where dc_f32 is 1). dst may be
// null (zeros). Launches on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dt, const void* cum, const void* B,
    const void* C, const void* dy, const void* dst, void* dx, void* ddt,
    void* dcum, void* dB, void* dC, void* part, long long x_sb,
    long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
    long long dt_sh, long long cum_sb, long long cum_ss, long long cum_sh,
    long long B_sb, long long B_ss, long long B_sg, long long C_sb,
    long long C_ss, long long C_sg, long long dy_sb, long long dy_ss,
    long long dy_sh, int batch, int S, int H, int P, int G, int N, int chunk,
    int dtype, int dc_f32, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || chunk < 1 || S % chunk != 0 ||
      (long long)batch * H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {};
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.cum = static_cast<const float*>(cum);
  a.B = B;
  a.C = C;
  a.dy = static_cast<const float*>(dy);
  a.dst = static_cast<const float*>(dst);
  a.dx = dx;
  a.ddt = static_cast<float*>(ddt);
  a.dcum = static_cast<float*>(dcum);
  a.part = static_cast<float*>(part);
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  a.x_sh = x_sh;
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  a.dt_sh = dt_sh;
  a.cum_sb = cum_sb;
  a.cum_ss = cum_ss;
  a.cum_sh = cum_sh;
  a.B_sb = B_sb;
  a.B_ss = B_ss;
  a.B_sg = B_sg;
  a.C_sb = C_sb;
  a.C_ss = C_ss;
  a.C_sg = C_sg;
  a.dy_sb = dy_sb;
  a.dy_ss = dy_ss;
  a.dy_sh = dy_sh;
  a.batch = batch;
  a.S = S;
  a.H = H;
  a.P = P;
  a.G = G;
  a.N = N;
  a.chunk = chunk;
  a.n_tiles = (chunk + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch<float>(a, batch, dB, dC, 0, s);
    case 1:
      return dispatch<bf16>(a, batch, dB, dC, dc_f32, s);
  }
  return (int)cudaErrorInvalidValue;
}
