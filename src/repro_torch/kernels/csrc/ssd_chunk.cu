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
// exp is taken only where j <= i: above the diagonal cum_i - cum_j > 0 and
// exp can overflow, so a masked weight is selected as 0, never an inf
// multiplied by 0.
//
// Bound: HBM bytes. At the mamba2-780m serve prefill (b 4, s 1,024, h 48,
// p 64, g 1, n 128, chunk 256, x/B/C bf16) the inputs and outputs are
// ~104 MB (the f32 y 50 MB and states 25 MB of it), 0.031 ms at 3.35 TB/s;
// the causal products are ~12.9 GFLOP counted per head, 0.013 ms at the
// 989 TFLOP/s of the bf16 tensor cores.
//
// bf16, chunk <= 256: the tensor cores (ssd_chunk_kernel_bf16). What held
// the first design (below, now f32 only) at 35x its bound: f32 FFMA fed from
// shared memory, C B^T recomputed for every head (g = 1: 48 heads, the same
// 256x256x128 product), and tiles loaded a scalar at a time between
// __syncthreads. This design:
//  * one C B^T for many heads: a 128-thread block takes one (b, chunk,
//    group, 64-row query tile) and a set of that group's heads. Each warp
//    forms its 16 rows of S = C_i B_j^T for every key tile j <= i once, in
//    registers (up to 16 x 256 f32), then walks the heads: for each it
//    applies exp(cum_i - cum_j) (one ex2.approx) and dt_j to S in
//    registers, masking only the diagonal tile, and accumulates
//    y = W x_j. The heads a block takes
//    are chosen on the host: the most that still gives the grid >= 4
//    blocks an SM (two are resident): 8 of 48 at the first serve call (16
//    (b, chunk) pairs), 2 at the second (4 pairs: 64-token prompts in one
//    chunk of 256). Where that number does not divide a group's heads,
//    the group's last set is smaller;
//  * the products are mma.sync.m16n8k16 (bf16 x bf16 -> f32), not wgmma:
//    W is made in registers, elementwise from S, head by head, and
//    mma.sync takes A from registers in the very layout the S accumulator
//    has (m16n8 C fragment = half an m16k16 A fragment), with x read by
//    ldmatrix.trans from its natural (key, p) rows. The kernel's floor is
//    its bytes (13 GFLOP at even a third of the tensor-core peak is
//    ~0.04 ms), so wgmma's higher rate would not decide its time, while its
//    64-row warpgroup tiles and swizzled shared operands would cost the
//    per-head register pipeline;
//  * precision: S is exact products summed in f32. The f32 operand of each
//    value product is split into bf16 hi + lo and both halves are
//    multiplied (x and B are exact in bf16): W = S o L o dt for y, and
//    B o dt o exp(cum_last - cum) for the states (a 16 x 16 A fragment of
//    B^T, scaled per key). One bf16 W alone misses the 2e-5 tolerance by
//    ~140x; hi + lo is within ~2^-17 of each weight;
//  * loads: x, dt and cum of the next head come by cp.async into a
//    two-stage shared ring while the warps compute the current head; C and
//    the B key tiles come the same way (B in a three-slot ring) while S
//    is formed. A view whose base, strides or width are not 16-byte multiples
//    takes the same kernel with synchronous scalar loads (vec_x, vec_bc);
//  * the states are blocks of their own, one per (b, chunk, group, 64 rows
//    of n, head set), heaviest first with the query tiles: B^T hi/lo in
//    registers per 16-key step, x by ldmatrix.trans;
//  * stores: each warp writes its 16 rows x 8 columns of an mma tile as
//    float2, 32 contiguous bytes a row (whole sectors);
//  * shared memory: two x stages, the C tile and the B ring or the states'
//    B slice, and dt/cum: 112 KB at the serve shape, two blocks an SM.
// What bounds it now (0.12 ms at the serve shape on an H100 SXM at 700 W,
// 0.25 of the byte bound):
// latency at 8 warps an SM. S holds 128 of a thread's 254 registers, so
// no more warps fit; each waits in turn on its head's x and dt/cum (one
// head ahead) and on its own chain of exp, split and products; of these
// the loads weigh most. The levers: S in shared memory to free registers
// for more warps or a deeper load ring, and dt/cum for all of a block's
// heads in one pass (a head's values are 4 bytes every h * 4).
// f32, or a chunk longer than 256: ssd_chunk_kernel, the first design:
// one 256-thread block per (b*h, chunk, 64-row query tile) walking key
// tiles j0 <= i0 only, both products in f32 FFMA (no TF32) from transposed,
// padded shared tiles, plus ceil(n/64) state blocks.
// Every output is written once by one thread (no atomics), so two launches
// give equal bits. Offsets are 64-bit.

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
  // the tensor-core path only
  int chunk_pad, n_pad, n_ntiles, hpb, n_hsets, vec_x, vec_bc;
  long long units;  // batch * chunks * groups * head sets
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


// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTc = 128;            // threads: 4 warps of 16 rows
constexpr int kTcMaxChunk = 256;    // 4 key tiles of S in registers
constexpr int kKeyTiles = kTcMaxChunk / kTile;

using bf16 = __nv_bfloat16;

// Byte offsets of the regions of dynamic shared memory. Region 1 is x
// stage 0; region 2 starts at x stage 1 and holds, in the y blocks, first
// C and the three slots of the B ring (used before the first x of stage 1
// is loaded; four key tiles, which may be longer than an x stage); the
// state blocks keep their B slice after both x stages. dt and cum follow
// the longer of the two. Row strides are padded by 16
// bytes so that ldmatrix's eight row addresses hit distinct banks.
struct TcLayout {
  int x_ld, bc_ld, sb_ld;      // elements
  int x_stage, c_tile, sb, vec_off, total;  // bytes
};

__host__ __device__ __forceinline__ TcLayout tc_layout(int chunk_pad,
                                                       int n_pad, int p_pad) {
  TcLayout L;
  L.x_ld = p_pad + 8;
  L.bc_ld = n_pad + 8;
  L.sb_ld = kTile + 8;
  L.x_stage = chunk_pad * L.x_ld * 2;
  L.c_tile = kTile * L.bc_ld * 2;
  L.sb = chunk_pad * L.sb_ld * 2;
  const int p1 = 4 * L.c_tile;  // C and the three-slot B ring
  const int y_end = L.x_stage + (p1 > L.x_stage ? p1 : L.x_stage);
  const int st_end = 2 * L.x_stage + L.sb;
  L.vec_off = y_end > st_end ? y_end : st_end;
  L.total = L.vec_off + 2 * 2 * chunk_pad * 4;  // [stage][dt, cum][key]
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of copies are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// d (16x8 f32) += a (16x16 bf16, row) b (16x8 bf16, col). With g = lane/4,
// t = lane%4: a holds rows g, g+8 x columns 2t, 2t+1, 2t+8, 2t+9 (a0: row
// g, cols 2t..; a1: row g+8; a2: row g, cols 2t+8..; a3: row g+8, cols
// 2t+8..), b rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column g, d rows g
// (d0, d1) and g+8 (d2, d3) x columns 2t, 2t+1.
__device__ __forceinline__ void mma16816(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v0, v1) ~= hi + lo, each a bf16 pair (v0 in the low half): hi the
// rounded values, lo the rounded remainders.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The bf16 pair u scaled by (f0, f1), split as split2.
__device__ __forceinline__ void scale_split(uint32_t u, float f0, float f1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  split2(v.x * f0, v.y * f1, hi, lo);
}

// rows x cols_pad (a multiple of 8) of a bf16 tile into shared memory at row
// stride ld; element (r, c) is g[r * rs + c] where r < rows_valid and
// c < cols, zero elsewhere. vec: 16-byte cp.async (g 16-byte aligned, rs and
// cols multiples of 8); else synchronous scalar loads.
__device__ __forceinline__ void load_tile(bf16* s, int ld, const bf16* g,
                                          long long rs, int rows,
                                          int rows_valid, int cols,
                                          int cols_pad, bool vec) {
  const int pieces = cols_pad >> 3;  // 16-byte pieces a row
  for (int e = threadIdx.x; e < rows * pieces; e += kTc) {
    const int r = e / pieces, c = (e - r * pieces) << 3;
    bf16* dst = s + r * ld + c;
    const bf16* src = g + r * rs + c;
    if (vec) {
      const bool ok = r < rows_valid && c < cols;
      cp_async16(dst, ok ? src : g, ok ? 16 : 0);
    } else {
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c0 = c + 2 * q;
        const uint32_t lo =
            r < rows_valid && c0 < cols ? __ldg(s16 + 2 * q) : 0u;
        const uint32_t hi =
            r < rows_valid && c0 + 1 < cols ? __ldg(s16 + 2 * q + 1) : 0u;
        w[q] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// rows f32 values g[r * rs] into s[r], zero where r >= rows_valid.
__device__ __forceinline__ void load_col(float* s, const float* g,
                                         long long rs, int rows,
                                         int rows_valid) {
  for (int r = threadIdx.x; r < rows; r += kTc) {
    const bool ok = r < rows_valid;
    cp_async4(s + r, ok ? g + r * rs : g, ok ? 4 : 0);
  }
}

// Two adjacent f32 outputs at columns col, col + 1 (col even).
__device__ __forceinline__ void store2(float* row, int col, int P, float v0,
                                       float v1) {
  if (col + 1 < P && (P & 1) == 0) {
    *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    if (col < P) row[col] = v0;
    if (col + 1 < P) row[col + 1] = v1;
  }
}

// e^d as one MUFU op: ex2.approx (relative error ~2^-22) of d log2(e).
// d is an exact f32 difference of two cum values, so its product with
// log2(e) is off by 2^-24 of itself: for the weights that matter (d near
// 0) far below the tolerance; e^d that flushes to zero is below 2^-126.
__device__ __forceinline__ float exp_diff(float d) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(d * 1.4426950408889634f));
  return y;
}

// acc (16 x 8 PT) += (hi + lo) X for one 16-key step: X's rows at xrow
// (this lane's ldmatrix.trans address of column tile 0). The hi products
// of all column tiles go first, so no two products in a row share an
// accumulator.
template <int PT>
__device__ __forceinline__ void products(float (&acc)[PT][4],
                                         const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4],
                                         const bf16* xrow) {
  uint32_t xb[PT / 2][4];
#pragma unroll
  for (int pp = 0; pp < PT / 2; ++pp) ldsm_x4_t(xb[pp], xrow + pp * 16);
#pragma unroll
  for (int pp = 0; pp < PT / 2; ++pp) {
    mma16816(acc[2 * pp], hi, xb[pp][0], xb[pp][1]);
    mma16816(acc[2 * pp + 1], hi, xb[pp][2], xb[pp][3]);
  }
#pragma unroll
  for (int pp = 0; pp < PT / 2; ++pp) {
    mma16816(acc[2 * pp], lo, xb[pp][0], xb[pp][1]);
    mma16816(acc[2 * pp + 1], lo, xb[pp][2], xb[pp][3]);
  }
}

// PT: 8-column tiles of p (p_pad = 8 PT: 16, 32, 64 or 128)
template <int PT>
__global__ void __launch_bounds__(kTc, 2)
ssd_chunk_kernel_bf16(const Args a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  constexpr int kPPad = 8 * PT;
  const TcLayout L = tc_layout(a.chunk_pad, a.n_pad, kPPad);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // the item: level (state n-tiles first, then query tiles, heaviest
  // first), then (b, chunk, group, head set)
  const long long item = blockIdx.x;
  const int level = (int)(item / a.units);
  long long u = item - (long long)level * a.units;
  const int hset = (int)(u % a.n_hsets);
  u /= a.n_hsets;
  const int grp = (int)(u % a.G);
  u /= a.G;
  const int nc = a.S / a.chunk;
  const int ci = (int)(u % nc);
  const int b = (int)(u / nc);
  const int rep = a.H / a.G;
  const int h_lo = grp * rep + hset * a.hpb;
  const int nh = min(a.hpb, rep - hset * a.hpb);
  const long long row0 = (long long)ci * a.chunk;

  auto x_stage = [&](int stage) {
    return reinterpret_cast<bf16*>(smem + stage * L.x_stage);
  };
  float* vecs = reinterpret_cast<float*>(smem + L.vec_off);
  const bf16* xg =
      static_cast<const bf16*>(a.x) + b * a.x_sb + row0 * a.x_ss;
  const bf16* Bg = static_cast<const bf16*>(a.B) + b * a.B_sb +
                   row0 * a.B_ss + grp * a.B_sg;
  const bf16* Cg = static_cast<const bf16*>(a.C) + b * a.C_sb +
                   row0 * a.C_ss + grp * a.C_sg;
  const float* dtg = a.dt + b * a.dt_sb + row0 * a.dt_ss;
  const float* cumg = a.cum + b * a.cum_sb + row0 * a.cum_ss;

  // x, dt and cum of the block's head hi, keys [0, rows), into a stage
  auto load_head = [&](int hi, int stage, int rows) {
    const int hh = h_lo + hi;
    load_tile(x_stage(stage), L.x_ld, xg + hh * a.x_sh, a.x_ss, rows, a.chunk,
              a.P, kPPad, a.vec_x);
    float* v = vecs + stage * 2 * a.chunk_pad;
    load_col(v, dtg + hh * a.dt_sh, a.dt_ss, rows, a.chunk);
    load_col(v + a.chunk_pad, cumg + hh * a.cum_sh, a.cum_ss, rows, a.chunk);
    cp_async_commit();
  };
  // ldmatrix.trans row addresses of x for keys [k0, k0 + 16), columns
  // [16 pp, 16 pp + 16): matrices (keys +0, cols +0), (+8, +0), (+0, +8),
  // (+8, +8) = b0, b1 of column tile 2 pp and b0, b1 of 2 pp + 1
  const int x_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int x_col = (lane >> 4) * 8;

  if (level < a.n_ntiles) {
    // ---- the chunk's states, rows [n0, n0 + 64) of n ---------------------
    const int n0 = level * kTile;
    bf16* sb = reinterpret_cast<bf16*>(smem + 2 * L.x_stage);
    load_tile(sb, L.sb_ld, Bg + n0, a.B_ss, a.chunk_pad, a.chunk,
              min(kTile, a.N - n0), kTile, a.vec_bc);
    load_head(0, 0, a.chunk_pad);  // commits B's slice with it
    const int m0 = warp * 16;      // this warp's rows of the slice
    const bool live = n0 + m0 < a.N;
    const int kend = (a.chunk + 15) & ~15;
    for (int hi = 0; hi < nh; ++hi) {
      cp_async_wait<0>();
      __syncthreads();  // head hi landed; the other stage is free
      if (hi + 1 < nh) load_head(hi + 1, (hi + 1) & 1, a.chunk_pad);
      if (!live) continue;
      const bf16* xsm = x_stage(hi & 1);
      const float* dts = vecs + (hi & 1) * 2 * a.chunk_pad;
      const float* cums = dts + a.chunk_pad;
      const float cum_last = cums[a.chunk - 1];
      float acc[PT][4];
#pragma unroll
      for (int c = 0; c < PT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
      for (int k0 = 0; k0 < kend; k0 += 16) {
        // A = (B o f)^T: rows n, columns keys; ldmatrix.trans of the
        // (key, n) slice, matrices (keys +0, n +0), (+0, +8), (+8, +0),
        // (+8, +8) = a0..a3
        uint32_t bt[4], ahi[4], alo[4];
        ldsm_x4_t(bt, sb + (k0 + (lane & 7) + (lane >> 4) * 8) * L.sb_ld +
                          m0 + ((lane >> 3) & 1) * 8);
        const int j = k0 + 2 * t4;
        const float2 d01 = *reinterpret_cast<const float2*>(dts + j);
        const float2 d89 = *reinterpret_cast<const float2*>(dts + j + 8);
        const float2 c01 = *reinterpret_cast<const float2*>(cums + j);
        const float2 c89 = *reinterpret_cast<const float2*>(cums + j + 8);
        const float f0 = d01.x * exp_diff(cum_last - c01.x);
        const float f1 = d01.y * exp_diff(cum_last - c01.y);
        const float f8 = d89.x * exp_diff(cum_last - c89.x);
        const float f9 = d89.y * exp_diff(cum_last - c89.y);
        scale_split(bt[0], f0, f1, ahi[0], alo[0]);
        scale_split(bt[1], f0, f1, ahi[1], alo[1]);
        scale_split(bt[2], f8, f9, ahi[2], alo[2]);
        scale_split(bt[3], f8, f9, ahi[3], alo[3]);
        products(acc, ahi, alo, xsm + (k0 + x_row) * L.x_ld + x_col);
      }
      const int hh = h_lo + hi;
      float* st = a.st + (((long long)b * nc + ci) * a.H + hh) * a.N * a.P;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = n0 + m0 + g + 8 * half;
        if (n >= a.N) continue;
        float* row = st + (long long)n * a.P;
#pragma unroll
        for (int c = 0; c < PT; ++c) {
          store2(row, c * 8 + 2 * t4, a.P, acc[c][2 * half],
                 acc[c][2 * half + 1]);
        }
      }
    }
    return;
  }

  // ---- y for query rows [i0, i0 + 64) of the chunk ------------------------
  const int qt = a.n_qtiles - 1 - (level - a.n_ntiles);
  const int i0 = qt * kTile;
  const int nkeys = i0 + kTile;  // keys [0, nkeys) reach these rows
  bf16* cs = x_stage(1);         // C tile, then the B ring (region 2)
  auto b_slot = [&](int kt) { return cs + (1 + kt % 3) * kTile * L.bc_ld; };
  auto load_b = [&](int kt) {
    load_tile(b_slot(kt), L.bc_ld, Bg + kt * kTile * a.B_ss, a.B_ss, kTile,
              a.chunk - kt * kTile, a.N, a.n_pad, a.vec_bc);
    cp_async_commit();
  };
  load_head(0, 0, nkeys);
  load_tile(cs, L.bc_ld, Cg + i0 * a.C_ss, a.C_ss, kTile, a.chunk - i0, a.N,
            a.n_pad, a.vec_bc);
  load_b(0);  // commits C with it
  for (int kt = 1; kt <= qt && kt < 3; ++kt) load_b(kt);
  const int r_a = i0 + warp * 16 + g, r_b = r_a + 8;  // this thread's rows
  const bool live = i0 + warp * 16 < a.chunk;

  // S = C_i B_j^T of this warp's 16 rows, key tile kt, 8-key column tile
  float s[kKeyTiles][8][4];
#pragma unroll
  for (int kt = 0; kt < kKeyTiles; ++kt) {
    if (kt > qt) break;
    // B tiles kt + 1 and kt + 2 may stay in flight
    if (qt - kt >= 2) {
      cp_async_wait<2>();
    } else if (qt - kt == 1) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // C and B tile kt landed
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[kt][c][e] = 0.f;
    if (live) {
      const bf16* bt = b_slot(kt);
      for (int k0 = 0; k0 < a.n_pad; k0 += 16) {
        uint32_t af[4];
        ldsm_x4(af, cs + (warp * 16 + (lane & 15)) * L.bc_ld + k0 +
                        (lane >> 4) * 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // matrices (keys +0, n +0), (+0, +8), (+8, +0), (+8, +8) =
          // b0, b1 of key column tile 2q and b0, b1 of 2q + 1
          uint32_t bf[4];
          ldsm_x4(bf, bt + (q * 16 + (lane & 7) + (lane >> 4) * 8) * L.bc_ld +
                          k0 + ((lane >> 3) & 1) * 8);
          mma16816(s[kt][2 * q], af, bf[0], bf[1]);
          mma16816(s[kt][2 * q + 1], af, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // B ring slot kt % 3 is free again
    if (kt + 3 <= qt) load_b(kt + 3);
  }

  for (int hi = 0; hi < nh; ++hi) {
    cp_async_wait<0>();
    __syncthreads();  // head hi landed; the other stage is free
    if (hi + 1 < nh) load_head(hi + 1, (hi + 1) & 1, nkeys);
    if (!live) continue;
    const bf16* xsm = x_stage(hi & 1);
    const float* dts = vecs + (hi & 1) * 2 * a.chunk_pad;
    const float* cums = dts + a.chunk_pad;
    const float cum_a = cums[r_a], cum_b = cums[r_b];
    float acc[PT][4];
#pragma unroll
    for (int c = 0; c < PT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kKeyTiles; ++kt) {
      if (kt > qt) break;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (kt == qt && ks > warp) break;  // keys past this warp's rows
        const int j = kt * kTile + ks * 16 + 2 * t4;
        const float2 d01 = *reinterpret_cast<const float2*>(dts + j);
        const float2 d89 = *reinterpret_cast<const float2*>(dts + j + 8);
        const float2 c01 = *reinterpret_cast<const float2*>(cums + j);
        const float2 c89 = *reinterpret_cast<const float2*>(cums + j + 8);
        // W's A fragment: S column tiles 2 ks (keys j, j + 1) and 2 ks + 1
        // (keys j + 8, j + 9) of rows r_a and r_b
        float w[8] = {
            s[kt][2 * ks][0] * exp_diff(cum_a - c01.x) * d01.x,
            s[kt][2 * ks][1] * exp_diff(cum_a - c01.y) * d01.y,
            s[kt][2 * ks][2] * exp_diff(cum_b - c01.x) * d01.x,
            s[kt][2 * ks][3] * exp_diff(cum_b - c01.y) * d01.y,
            s[kt][2 * ks + 1][0] * exp_diff(cum_a - c89.x) * d89.x,
            s[kt][2 * ks + 1][1] * exp_diff(cum_a - c89.y) * d89.y,
            s[kt][2 * ks + 1][2] * exp_diff(cum_b - c89.x) * d89.x,
            s[kt][2 * ks + 1][3] * exp_diff(cum_b - c89.y) * d89.y};
        if (kt == qt) {
          // the diagonal tile: keys after the row are selected as 0 (their
          // exp may be inf). Elsewhere every key precedes every row; rows
          // past the chunk hold garbage and are never stored.
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int key = j + (e & 1) + (e >> 2) * 8;
            const int row = (e & 2) ? r_b : r_a;
            w[e] = key <= row ? w[e] : 0.f;
          }
        }
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split2(w[2 * q], w[2 * q + 1], ahi[q], alo[q]);
        products(acc, ahi, alo,
                 xsm + (kt * kTile + ks * 16 + x_row) * L.x_ld + x_col);
      }
    }
    const int hh = h_lo + hi;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_b : r_a;
      if (r >= a.chunk) continue;
      float* row = a.y + (((long long)b * a.S + row0 + r) * a.H + hh) * a.P;
#pragma unroll
      for (int c = 0; c < PT; ++c) {
        store2(row, c * 8 + 2 * t4, a.P, acc[c][2 * half],
               acc[c][2 * half + 1]);
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

template <int PT>
int launch_tc(Args a, int batch, cudaStream_t stream) {
  static int configured = 0;  // dynamic shared memory allowed so far
  const TcLayout L = tc_layout(a.chunk_pad, a.n_pad, 8 * PT);
  if (L.total > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel_bf16<PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_chunk_kernel_bf16<PT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return (int)err;
    configured = L.total;
  }
  const int rep = a.H / a.G;
  const long long per_set =
      (long long)batch * (a.S / a.chunk) * a.G * (a.n_ntiles + a.n_qtiles);
  // the most heads a block (the least recomputing of S) that still gives
  // the grid 4 blocks an SM; the last set of a group may be smaller
  const long long want = 4LL * sm_count();
  int hpb = rep;
  while (hpb > 1 && per_set * ((rep + hpb - 1) / hpb) < want) --hpb;
  a.hpb = hpb;
  a.n_hsets = (rep + a.hpb - 1) / a.hpb;
  a.units = (long long)batch * (a.S / a.chunk) * a.G * a.n_hsets;
  const long long blocks = a.units * (a.n_ntiles + a.n_qtiles);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_chunk_kernel_bf16<PT><<<(unsigned)blocks, kTc, L.total, stream>>>(a);
  return (int)cudaGetLastError();
}

bool vec_ok(const void* p, long long sb, long long ss, long long sh,
            int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0 && width % 8 == 0;
}

int dispatch_tc(Args a, int batch, cudaStream_t s) {
  a.chunk_pad = (a.chunk + kTile - 1) / kTile * kTile;
  a.n_qtiles = a.chunk_pad / kTile;
  a.n_pad = (a.N + 15) / 16 * 16;
  a.n_ntiles = (a.N + kTile - 1) / kTile;
  a.vec_x = vec_ok(a.x, a.x_sb, a.x_ss, a.x_sh, a.P);
  a.vec_bc = vec_ok(a.B, a.B_sb, a.B_ss, a.B_sg, a.N) &&
             vec_ok(a.C, a.C_sb, a.C_ss, a.C_sg, a.N);
  if (a.P <= 16) return launch_tc<2>(a, batch, s);
  if (a.P <= 32) return launch_tc<4>(a, batch, s);
  if (a.P <= 64) return launch_tc<8>(a, batch, s);
  return launch_tc<16>(a, batch, s);
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
  Args a = {};
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
      return chunk <= kTcMaxChunk ? dispatch_tc(a, batch, s)
                                  : dispatch_p<bf16>(a, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}
