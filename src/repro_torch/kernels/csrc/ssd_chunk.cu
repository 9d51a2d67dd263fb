// Mamba2 SSD intra-chunk step for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd_scan.py::ssd_chunk_pallas, the TPU kernel that
// holds one (batch*head, chunk) working set in VMEM per grid step and runs
// the chunk's three products on the MXU.
//
//   x     (b, s, h, p)   bf16 or f32; strides over b, s, h, the last dim
//                        contiguous (the model passes a view of the conv
//                        output, no copy)
//   dt    (b, s, h)      f32 step sizes, any strides
//   cum   (b, s, h)      f32 cumulative dt*A within each chunk, any strides
//   B, C  (b, s, g, n)   x's dtype; head hh reads group hh / (h / g), so the
//                        heads of a group share one row of B and C (no
//                        repeat over heads as kernels/ops.py does)
//   y     (b, s, h, p)   f32, contiguous: the intra-chunk output
//   st    (b, nc, h, n, p) f32, contiguous: each chunk's local state
//
// Per (batch, head, chunk) of `c` rows, with i, j rows of the chunk:
//   L[i,j] = exp(cum_i - cum_j) for j <= i, else 0
//   y[i]   = sum_j (C_i . B_j) * L[i,j] * dt_j * x_j
//   st     = sum_j (B_j * dt_j * exp(cum_last - cum_j))^T x_j
// all in f32, inputs upcast as they are read (as the Pallas kernel does).
// exp is taken only where j <= i: above the diagonal cum_i - cum_j > 0 and
// exp can overflow, so a masked weight is selected as 0, never an inf
// multiplied by 0.
//
// Bound: HBM bytes. At the mamba2-780m serve prefill (b 4, s 1,024, h 48,
// p 64, g 1, n 128, chunk 256, x/B/C bf16) the inputs and outputs are
// ~104 MB, 0.031 ms at 3.35 TB/s; the causal products are ~12.9 GFLOP,
// 0.013 ms at the 989 TFLOP/s of the bf16 tensor cores.
//
// Design (simple and right first):
//  * one 256-thread block per (b*h, chunk, 64-row query tile); it walks the
//    key tiles j0 <= i0 only (causal skip), heaviest query tiles first;
//  * C_i (transposed) stays in shared memory for the block; each key tile
//    loads B_j (transposed), x_j, dt_j and cum_j, forms the 64x64 weight
//    tile W = (C_i B_j^T) o L o dt_j, then y += W x_j; both products are
//    f32 FFMA, each thread owning a 4 x 4 tile of W and 4 rows x p/16
//    columns of y (rows ty + 16r, columns tx + 16c: conflict-free shared
//    reads); transposed tiles have a row stride of 65 floats;
//  * the state is ceil(n/64) more blocks per (b*h, chunk), each a 64-row
//    slice of n: the same accumulation with W[j][k] = B_j[k] dt_j
//    exp(cum_last - cum_j), over every key tile of the chunk;
//  * rows past the chunk are zero-filled; 64-bit offsets from strides;
//    every output is written once by one thread (no atomics), so two
//    launches give equal bits; up to 179 KB of dynamic shared memory
//    (n 256, p 128), set with cudaFuncSetAttribute.
// What bounds it now: f32 FFMA fed from shared memory (8 loads a 16 FMAs),
// ~15 GFLOP at the serve shape against 67 TFLOP/s of FFMA. Later work:
// the tensor cores (wgmma, bf16 operands with f32 accumulators), TMA
// loads, and sharing C B^T across the heads of a group (with g = 1 all 48
// heads recompute the same 256x256 product).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // rows of a query, key or state tile
constexpr int kThreads = 256;      // 16 x 16: thread (ty, tx)
constexpr int kPad = kTile + 1;    // row stride of a transposed tile
constexpr int kMaxN = 256;
constexpr int kMaxP = 128;

struct Args {
  const void* x;
  const float* dt;
  const float* cum;
  const void* B;
  const void* C;
  float* y;
  float* st;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long cum_sb, cum_ss, cum_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  int S, H, P, G, N, chunk, n_qtiles;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int n, int p) {
  // xs [64][p], Wt [64][65], dt/cum of the key tile and cum of the query
  // tile [64] each, Ct and Bt [n][65]
  return sizeof(float) *
         ((size_t)kTile * p + (size_t)kTile * kPad + 3 * kTile +
          2 * (size_t)n * kPad);
}

// PC: columns of y a thread owns (p <= 16 * PC)
template <typename T, int PC>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const Args a) {
  extern __shared__ float smem[];
  float* xs = smem;                   // x_j [j][col]
  float* Wt = xs + kTile * a.P;       // W [j][row] (row stride kPad)
  float* dts = Wt + kTile * kPad;     // dt_j
  float* cums = dts + kTile;          // cum_j
  float* cumq = cums + kTile;         // cum_i of the query rows
  float* Ct = cumq + kTile;           // C_i [k][i] (row stride kPad)
  float* Bt = Ct + a.N * kPad;        // B_j [k][j] (row stride kPad)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.z;
  const int b = bh / a.H, hh = bh - b * a.H;
  const int grp = hh / (a.H / a.G);
  const int ci = blockIdx.y;
  const long long row0 = (long long)ci * a.chunk;  // the chunk's first row

  const T* x = static_cast<const T*>(a.x) + b * a.x_sb + hh * a.x_sh;
  const float* dt = a.dt + b * a.dt_sb + hh * a.dt_sh;
  const float* cum = a.cum + b * a.cum_sb + hh * a.cum_sh;
  const T* Bp = static_cast<const T*>(a.B) + b * a.B_sb + grp * a.B_sg;
  const T* Cp = static_cast<const T*>(a.C) + b * a.C_sb + grp * a.C_sg;

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;

  // x_j, dt_j and cum_j of the key tile at chunk row j0 (zeros past it)
  auto load_keys = [&](int j0) {
    for (int e = tid; e < kTile * a.P; e += kThreads) {
      const int j = e / a.P, col = e - j * a.P;
      const int jl = j0 + j;
      xs[e] = jl < a.chunk ? to_f32(x[(row0 + jl) * a.x_ss + col]) : 0.f;
    }
    if (tid < kTile) {
      const int jl = j0 + tid;
      const bool in = jl < a.chunk;
      dts[tid] = in ? dt[(row0 + jl) * a.dt_ss] : 0.f;
      cums[tid] = in ? cum[(row0 + jl) * a.cum_ss] : 0.f;
    }
  };

  // acc[r][c] += sum_j Wt[j][ty + 16r] * xs[j][tx + 16c]
  auto accumulate = [&]() {
    for (int j = 0; j < kTile; ++j) {
      float wv[4], xv[PC];
#pragma unroll
      for (int r = 0; r < 4; ++r) wv[r] = Wt[j * kPad + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int col = tx + 16 * c;
        xv[c] = col < a.P ? xs[j * a.P + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
    }
  };

  if ((int)blockIdx.x < a.n_qtiles) {
    // ---- y for query rows [i0, i0 + 64) of the chunk ----------------------
    const int i0 = (a.n_qtiles - 1 - (int)blockIdx.x) * kTile;
    for (int e = tid; e < kTile * a.N; e += kThreads) {
      const int i = e / a.N, k = e - i * a.N;
      const int il = i0 + i;
      Ct[k * kPad + i] =
          il < a.chunk ? to_f32(Cp[(row0 + il) * a.C_ss + k]) : 0.f;
    }
    if (tid < kTile) {
      const int il = i0 + tid;
      cumq[tid] = il < a.chunk ? cum[(row0 + il) * a.cum_ss] : 0.f;
    }
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      __syncthreads();  // the previous key tile's readers are done
      load_keys(j0);
      for (int e = tid; e < kTile * a.N; e += kThreads) {
        const int j = e / a.N, k = e - j * a.N;
        const int jl = j0 + j;
        Bt[k * kPad + j] =
            jl < a.chunk ? to_f32(Bp[(row0 + jl) * a.B_ss + k]) : 0.f;
      }
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
      for (int k = 0; k < a.N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Ct[k * kPad + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bt[k * kPad + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ty + 16 * r, j = tx + 16 * c;
          const int il = i0 + i, jl = j0 + j;
          float w = 0.f;
          if (jl <= il && il < a.chunk) {  // exp only on or below the diagonal
            w = s[r][c] * expf(cumq[i] - cums[j]) * dts[j];
          }
          Wt[j * kPad + i] = w;
        }
      }
      __syncthreads();
      accumulate();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = i0 + ty + 16 * r;
      if (il >= a.chunk) continue;
      float* yrow = a.y + (((long long)b * a.S + row0 + il) * a.H + hh) * a.P;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int col = tx + 16 * c;
        if (col < a.P) yrow[col] = acc[r][c];
      }
    }
    return;
  }

  // ---- the chunk's local state, rows [k0, k0 + 64) of n --------------------
  const int k0 = ((int)blockIdx.x - a.n_qtiles) * kTile;
  const float cum_last = cum[(row0 + a.chunk - 1) * a.cum_ss];
  for (int j0 = 0; j0 < a.chunk; j0 += kTile) {
    __syncthreads();
    load_keys(j0);
    __syncthreads();
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int j = e / kTile, k = e - j * kTile;
      const int jl = j0 + j, kk = k0 + k;
      float w = 0.f;
      if (jl < a.chunk && kk < a.N) {
        w = to_f32(Bp[(row0 + jl) * a.B_ss + kk]) *
            (dts[j] * expf(cum_last - cums[j]));
      }
      Wt[j * kPad + k] = w;
    }
    __syncthreads();
    accumulate();
  }
  const long long nc = gridDim.y;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kk = k0 + ty + 16 * r;
    if (kk >= a.N) continue;
    float* srow =
        a.st + ((((long long)b * nc + ci) * a.H + hh) * a.N + kk) * a.P;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.P) srow[col] = acc[r][c];
    }
  }
}

template <typename T, int PC>
int launch_one(const Args& a, int batch, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxN, kMaxP));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_stiles = (a.N + kTile - 1) / kTile;
  const dim3 grid(a.n_qtiles + n_stiles, a.S / a.chunk, batch * a.H);
  ssd_chunk_kernel<T, PC><<<grid, kThreads, smem_bytes(a.N, a.P), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_p(const Args& a, int batch, cudaStream_t stream) {
  return a.P <= 64 ? launch_one<T, 4>(a, batch, stream)
                   : launch_one<T, 8>(a, batch, stream);
}

}  // namespace

// C entry point, bound with ctypes. dtype: 0 float32, 1 bfloat16 (x, B and
// C share it). Launches on `stream` (PyTorch's current stream), does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the caller.
extern "C" int ssd_chunk_launch(
    const void* x, const void* dt, const void* cum, const void* B,
    const void* C, void* y, void* st, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long cum_sb, long long cum_ss, long long cum_sh, long long B_sb,
    long long B_ss, long long B_sg, long long C_sb, long long C_ss,
    long long C_sg, int batch, int S, int H, int P, int G, int N, int chunk,
    int dtype, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 1 ||
      P > kMaxP || N < 1 || N > kMaxN || chunk < 1 || S % chunk != 0 ||
      (long long)batch * H > 65535 || S / chunk > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.cum = static_cast<const float*>(cum);
  a.B = B;
  a.C = C;
  a.y = static_cast<float*>(y);
  a.st = static_cast<float*>(st);
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
  a.S = S;
  a.H = H;
  a.P = P;
  a.G = G;
  a.N = N;
  a.chunk = chunk;
  a.n_qtiles = (chunk + kTile - 1) / kTile;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch_p<float>(a, batch, s);
    case 1:
      return dispatch_p<__nv_bfloat16>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}
