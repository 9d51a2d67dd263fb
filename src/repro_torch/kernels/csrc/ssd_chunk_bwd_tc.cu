// Backward of the Mamba2 SSD intra-chunk step on Hopper's tensor cores
// (sm_90a): the route for bf16 x and B (C bf16, or f32 holding bf16
// values), chunk <= 256, head_dim <= 64, d_state <= 128, 16-byte aligned
// rows. Everything else takes the FFMA kernel in ssd_chunk_bwd.cu, which
// holds the formulas, the layouts and the bound.
//
// Replaces no TPU kernel: ssd_chunk_pallas has no backward (the reference
// differentiates its einsums through XLA). This is the gradient of
// ssd_chunk.cu, the port's counterpart of repro/kernels/ssd_scan.py:56.
//
// Bound: HBM bytes. At the mamba2-780m training shape (b 8, s 1,024, h 48,
// p 64, g 1, n 128, chunk 256) the inputs and outputs are 266.3 MB, 0.0795
// ms at 3.35 TB/s; the causal products ~52 GFLOP, 0.053 ms at 989 TFLOP/s.
//
// What held the FFMA kernel at 1% of that bound, and what this route does:
//  * f32 FFMA fed from shared memory at ~2 FMAs a float loaded: every
//    product here is mma.sync.m16n8k16 (bf16 x bf16 -> f32). An f32
//    operand is split into bf16 hi + lo (as in the forward): C B^T takes
//    one product (both exact in bf16); dy x^T, x dst^T, dst's share of dx,
//    Gd B and Gd^T C two (one operand exact); W^T dy three (hi hi, lo hi,
//    hi lo: both f32). Each split keeps 2^-17 of its value.
//  * C B^T and the dB / dC products once per head: a block takes one
//    (b, chunk, group) and a set of that group's heads, forms S = C B^T of
//    a tile pair once, and sums Gd = (dy x^T) o L o dt over its heads in
//    f32 registers before the one product with C or B (the heads of a
//    group share B and C, so the head sum commutes with it);
//  * both passes recomputing every product: three kernels split the
//    outputs by the loop order they need, all launched on the stream:
//      - dx, by key tile: a warp keeps S^T of its 16 key rows against
//        every later query tile in registers (as the forward keeps S) and
//        walks the heads: dx_j = W^T dy + (dt e B)_j dst, the dst term as
//        64-row tiles after the query tiles;
//      - the column terms, by key tile: x dst^T (dB's state term, r_j),
//        then per query tile S^T once and per head G^T, giving ddt,
//        dcum's column sums and dB = Gsum^T C;
//      - the row terms, by query tile: per key tile S once and per head G,
//        giving dcum's row sums of M and dC = Gsum B;
//      - a fixed-order finish: dB, dC summed over the head sets and
//        rounded once, dcum's row terms and the last row's state term;
//    so each tile pair's S is formed three times per head set (not twice
//    per head) and dy x^T twice per head;
//  * the per-head f32 part scratch (402.7 MB at mamba2-780m): only a head
//    set's sum per set (41.9 MB at 5 sets);
//  * tiles a scalar at a time between __syncthreads: a first pass splits
//    dy and dst into bf16 hi + lo arrays (each element once, not once per
//    warp that reads it) and lays dt and cum out by head; then every
//    operand tile comes by 16-byte cp.async, each thread at a fixed column
//    of the tile, into a ring (two stages, three for dx) while the current
//    (tile, head) item computes, and reaches the tensor cores by ldmatrix.
//    128-thread blocks, two an SM.
// Every output element is written by one thread or one fixed-order sum
// (no atomics), so two launches give equal bits. exp is taken only on and
// below the diagonal (above it the argument is -inf, whose ex2 is 0).
// Offsets are 64-bit.
//
// What bounds it now (1.0 ms at both training shapes on an H100 SXM at
// 700 W, 0.08 of the byte bound; the split pass 0.105 ms, dx 0.33, the
// column terms 0.34 (0.32 at zamba2-7b), the row terms 0.21 (0.24), the
// finish 0.02): latency at 8 warps an SM. Each kernel's loads alone and
// its products alone each take 0.45-0.75 of its time, and they overlap
// little; registers (220-255 a thread) allow no more warps. A warp owns
// 16 rows, so each of a block's 4 warps reads every B fragment of the
// tile (ldmatrix), and every item is one head of one tile pair. The
// levers: dy arrives as bf16 values in bf16 training (the model casts y
// to bf16), so its lo half is zero there and its products could be
// skipped; S^T out of the dx kernel's registers; dy x^T formed once for
// both the column and the row terms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a query, key or state tile
constexpr int kThreads = 128;    // 4 warps of 16 rows
constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / kTile;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxHeads = 24;    // heads a block: per-head row sums in smem

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* x;
  const float* dt;
  const float* cum;
  const bf16* B;
  const bf16* C;
  const float* dy;
  const float* dst;  // null: zeros
  // the first pass's output: dy and dst as bf16 hi + lo, contiguous
  // (b, s, h, p) and (b, nc, h, n, p); dt and cum as (b, h, s)
  bf16 *dy_hi, *dy_lo, *dst_hi, *dst_lo;
  float *dt_t, *cum_t;
  bf16* dx;
  float* ddt;
  float* dcum;
  float* part;  // (2, n_hsets, b, s, g, n): dB, dC of each head set
  float* mrow;  // (b, s, h): dcum's row sums
  float* tsum;  // (b, nc, h, nt): the state term's sum over a key tile
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long cum_sb, cum_ss, cum_sh;
  long long B_sb, B_ss, B_sg;
  long long C_sb, C_ss, C_sg;
  long long dy_sb, dy_ss, dy_sh;
  int batch, S, H, P, G, N, chunk;
  int nt, chunk_pad;  // 64-row tiles of a chunk, nt * 64
  int nw, pw;         // 16 ceil(N / 16), 16 ceil(P / 16)
  int hpb, n_hsets;   // heads a block, head sets a group
};

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// The bf16 pair u times f, split as split2.
__device__ __forceinline__ void scale_split(uint32_t u, float f,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  split2(v.x * f, v.y * f, hi, lo);
}

// The A fragment (hi, lo) of 16 rows x 16 columns [2ks, 2ks + 2) of an
// accumulator tile (columns of 8).
template <int T>
__device__ __forceinline__ void acc_to_a(const float (&v)[T][4], int ks,
                                         uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split2(v[2 * ks][0], v[2 * ks][1], hi[0], lo[0]);
  split2(v[2 * ks][2], v[2 * ks][3], hi[1], lo[1]);
  split2(v[2 * ks + 1][0], v[2 * ks + 1][1], hi[2], lo[2]);
  split2(v[2 * ks + 1][2], v[2 * ks + 1][3], hi[3], lo[3]);
}

// e^d as one MUFU op: ex2.approx (relative error ~2^-22) of d log2(e);
// -inf gives +0, which is how a weight off the causal triangle is made
// without taking the exp of a positive difference (which may overflow).
__device__ __forceinline__ float exp_diff(float d) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(d * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float masked(float d, bool ok) {
  return ok ? d : -INFINITY;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 64 rows of a bf16 matrix (row stride rs), kPieces 16-byte pieces wide (a
// power of two), into shared memory at row stride ld, each thread at a
// fixed column (the index arithmetic of a general loader costs as much as
// the copy): zeros at rows >= rows_valid and columns >= cols. g, rs and
// cols are multiples of 8 elements.
template <int kPieces>
__device__ __forceinline__ void load_tile(bf16* s, int ld, const bf16* g,
                                          long long rs, int rows_valid,
                                          int cols) {
  constexpr int kRowsPer = kThreads / kPieces;
  const int c = (threadIdx.x % kPieces) * 8;
  const bool col_ok = c < cols;
#pragma unroll
  for (int r = threadIdx.x / kPieces; r < kTile; r += kRowsPer) {
    const bool ok = col_ok && r < rows_valid;
    cp_async16(s + r * ld + c, ok ? g + r * rs + c : g, ok ? 16 : 0);
  }
}

// rows f32 values of a contiguous vector into s, zero from rows_valid on
// (a multiple of 4); g 16-byte aligned.
__device__ __forceinline__ void load_vec(float* s, const float* g, int rows,
                                         int rows_valid) {
  for (int r = threadIdx.x * 4; r < rows; r += kThreads * 4) {
    const bool ok = r < rows_valid;
    cp_async16(s + r, ok ? g + r : g, ok ? 16 : 0);
  }
}

// acc (16 x 64) += (A_hi + A_lo) (B_hi + B_lo)^T over K = kw: the warp's
// 16 rows of A against B's 64 rows, both bf16 [row][k] at their row
// strides; a null lo is zero (an operand exact in bf16). S = C B^T in
// either orientation, dy x^T in either, x dst^T.
__device__ __forceinline__ void gram(float (&acc)[8][4], const bf16* Ah,
                                     const bf16* Al, int lda, const bf16* Bh,
                                     const bf16* Bl, int ldb, int kw,
                                     int warp, int lane) {
  const int a_off = (warp * 16 + (lane & 15)) * lda + (lane >> 4) * 8;
  // matrices (rows +0, k +0), (+0, +8), (+8, +0), (+8, +8) = b0, b1 of
  // column tile 2q and b0, b1 of 2q + 1
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * ldb +
                    ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < kw; k0 += 16) {
    uint32_t ah[4], al[4];
    ldsm_x4(ah, Ah + a_off + k0);
    if (Al) ldsm_x4(al, Al + a_off + k0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t bh[4];
      ldsm_x4(bh, Bh + b_off + q * 16 * ldb + k0);
      mma16816(acc[2 * q], ah, bh[0], bh[1]);
      mma16816(acc[2 * q + 1], ah, bh[2], bh[3]);
      if (Al) {
        mma16816(acc[2 * q], al, bh[0], bh[1]);
        mma16816(acc[2 * q + 1], al, bh[2], bh[3]);
      }
      if (Bl) {
        uint32_t bl[4];
        ldsm_x4(bl, Bl + b_off + q * 16 * ldb + k0);
        mma16816(acc[2 * q], ah, bl[0], bl[1]);
        mma16816(acc[2 * q + 1], ah, bl[2], bl[3]);
      }
    }
  }
}

// acc (16 x 8 NT) += (hi + lo) V for one 16-row K step at row k0 of V
// ((k, n) rows, bf16, read by ldmatrix.trans); V_lo null is zero, else
// the products are hi V_hi, lo V_hi, hi V_lo.
template <int NT>
__device__ __forceinline__ void mma_kn(float (&acc)[NT][4],
                                       const uint32_t (&hi)[4],
                                       const uint32_t (&lo)[4],
                                       const bf16* Vh, const bf16* Vl,
                                       int ld, int k0, int lane) {
  // ldmatrix.trans of the (k, n) rows: b0, b1 of n tiles 2pp and 2pp + 1
  const int off = (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                  (lane >> 4) * 8;
#pragma unroll
  for (int pp = 0; pp < NT / 2; ++pp) {
    uint32_t vh[4];
    ldsm_x4_t(vh, Vh + off + pp * 16);
    mma16816(acc[2 * pp], hi, vh[0], vh[1]);
    mma16816(acc[2 * pp + 1], hi, vh[2], vh[3]);
    mma16816(acc[2 * pp], lo, vh[0], vh[1]);
    mma16816(acc[2 * pp + 1], lo, vh[2], vh[3]);
    if (Vl) {
      uint32_t vl[4];
      ldsm_x4_t(vl, Vl + off + pp * 16);
      mma16816(acc[2 * pp], hi, vl[0], vl[1]);
      mma16816(acc[2 * pp + 1], hi, vl[2], vl[3]);
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

// A block's place: (b, chunk, group, head set) and a 64-row tile, the
// tile fastest (so that one unit's blocks share its rows in L2), the
// heaviest tile first.
struct Place {
  int b, ci, grp, h_lo, nh, tile;
  long long row0;
};

__device__ __forceinline__ Place place(const Args& a, bool heavy_last) {
  Place pl;
  long long u = blockIdx.x;
  const int lvl = (int)(u % a.nt);
  u /= a.nt;
  const int hset = (int)(u % a.n_hsets);
  u /= a.n_hsets;
  pl.grp = (int)(u % a.G);
  u /= a.G;
  const int nc = a.S / a.chunk;
  pl.ci = (int)(u % nc);
  pl.b = (int)(u / nc);
  const int rep = a.H / a.G;
  pl.h_lo = pl.grp * rep + hset * a.hpb;
  pl.nh = min(a.hpb, rep - hset * a.hpb);
  pl.tile = heavy_last ? a.nt - 1 - lvl : lvl;
  pl.row0 = (long long)pl.ci * a.chunk;
  return pl;
}

// ---------------------------------------------------------------------------
// dx, by key tile: dx_j = sum_i W[i, j] dy_i + dt_j e_j (B_j dst)
// ---------------------------------------------------------------------------

// Shared memory: F = the key tile of B [64][136] bf16, the C tile of a
// query tile (same), three stages of a hi and a lo tile [64][8 PT + 8] bf16
// (dy rows i or dst rows q), and three head stages of dt and cum
// [chunk_pad]: items are issued two ahead.
struct DxLayout {
  int f_ld, t_ld, f_bytes, t_bytes, total;
};

__host__ __device__ __forceinline__ DxLayout dx_layout(int pw_t,
                                                       int chunk_pad) {
  DxLayout L;
  L.f_ld = kMaxN + 8;
  L.t_ld = pw_t + 8;
  L.f_bytes = kTile * L.f_ld * 2;
  L.t_bytes = kTile * L.t_ld * 2;
  L.total = 2 * L.f_bytes + 6 * L.t_bytes + 3 * 2 * chunk_pad * 4;
  return L;
}

// PT: 8-column tiles of p (p <= 8 PT)
template <int PT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dx_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DxLayout L = dx_layout(8 * PT, a.chunk_pad);
  bf16* F = reinterpret_cast<bf16*>(smem);
  bf16* Ct = reinterpret_cast<bf16*>(smem + L.f_bytes);
  bf16* tiles = reinterpret_cast<bf16*>(smem + 2 * L.f_bytes);
  float* vbuf = reinterpret_cast<float*>(smem + 2 * L.f_bytes +
                                         6 * L.t_bytes);
  // item k's hi tile; its lo tile follows
  auto tile = [&](int k) { return tiles + (k % 3) * 2 * kTile * L.t_ld; };
  auto vecs = [&](int hi) { return vbuf + (hi % 3) * 2 * a.chunk_pad; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Place pl = place(a, false);
  const int jt = pl.tile, j0 = jt * kTile;
  const int nd = a.nt - jt;                       // query tiles i >= j
  const int nq = a.dst ? (a.nw + kTile - 1) / kTile : 0;  // dst row tiles
  const int per_head = nd + nq;
  const int total = pl.nh * per_head;
  const int nc = a.S / a.chunk;

  const bf16* Bg = a.B + pl.b * a.B_sb + pl.row0 * a.B_ss + pl.grp * a.B_sg;
  const bf16* Cg = a.C + pl.b * a.C_sb + pl.row0 * a.C_ss + pl.grp * a.C_sg;
  const long long dy_ss = (long long)a.H * a.P;
  const long long dy0 = ((long long)pl.b * a.S + pl.row0) * dy_ss;
  const long long dst0 = ((long long)pl.b * nc + pl.ci) * a.H * a.N * a.P;

  // item k: head k / per_head; its piece: a dy tile, then the dst tiles
  auto issue = [&](int k) {
    const int hi = k / per_head, pc = k - hi * per_head;
    const int hh = pl.h_lo + hi;
    bf16* th = tile(k);
    bf16* tl = th + kTile * L.t_ld;
    if (pc < nd) {
      const int i0 = j0 + pc * kTile;
      const long long o = dy0 + hh * a.P + i0 * dy_ss;
      load_tile<PT>(th, L.t_ld, a.dy_hi + o, dy_ss, a.chunk - i0, a.P);
      load_tile<PT>(tl, L.t_ld, a.dy_lo + o, dy_ss, a.chunk - i0, a.P);
    } else {
      const int q0 = (pc - nd) * kTile;
      const long long o = dst0 + ((long long)hh * a.N + q0) * a.P;
      load_tile<PT>(th, L.t_ld, a.dst_hi + o, a.P, a.N - q0, a.P);
      load_tile<PT>(tl, L.t_ld, a.dst_lo + o, a.P, a.N - q0, a.P);
    }
    if (pc == 0) {
      float* v = vecs(hi);
      const long long o = ((long long)pl.b * a.H + hh) * a.S + pl.row0;
      load_vec(v, a.dt_t + o, a.chunk_pad, a.chunk);
      load_vec(v + a.chunk_pad, a.cum_t + o, a.chunk_pad, a.chunk);
    }
    cp_async_commit();
  };

  load_tile<kMaxN / 8>(F, L.f_ld, Bg + j0 * a.B_ss, a.B_ss, a.chunk - j0,
                       a.N);
  issue(0);  // the first two items land while S is formed
  if (total > 1) issue(1);
  const bool live = j0 + warp * 16 < a.chunk;
  const int r_a = j0 + warp * 16 + g, r_b = r_a + 8;  // chunk rows j

  // S^T[j, i] of this warp's 16 key rows, query tile jt + d
  float s[kMaxTiles][8][4];
#pragma unroll
  for (int d = 0; d < kMaxTiles; ++d) {
    if (d >= nd) break;
    const int i0 = j0 + d * kTile;
    __syncthreads();  // the previous C tile's readers are done
    load_tile<kMaxN / 8>(Ct, L.f_ld, Cg + i0 * a.C_ss, a.C_ss, a.chunk - i0,
                         a.N);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[d][c][e] = 0.f;
    if (live) {
      gram(s[d], F, nullptr, L.f_ld, Ct, nullptr, L.f_ld, a.nw, warp, lane);
    }
  }

  int k = 0;
  auto step = [&]() {
    if (k + 1 < total) {
      cp_async_wait_one();  // item k + 1 may stay in flight
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // item k landed; item k - 1's stage is free
    if (k + 2 < total) issue(k + 2);
  };
  for (int hi = 0; hi < pl.nh; ++hi) {
    float acc[PT][4];
#pragma unroll
    for (int c = 0; c < PT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
    const float* dts = vecs(hi);
    const float* cums = dts + a.chunk_pad;
#pragma unroll
    for (int d = 0; d < kMaxTiles; ++d) {
      if (d >= nd) break;
      step();
      if (live) {
        const bf16* th = tile(k);
        const float dt_a = dts[r_a], dt_b = dts[r_b];
        const float cj_a = cums[r_a], cj_b = cums[r_b];
        const int i0 = j0 + d * kTile;
        // the diagonal tile and a tile reaching past the chunk are masked
        const bool edge = d == 0 || i0 + kTile > a.chunk;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int i = i0 + ks * 16 + 2 * t4;  // columns i, i+1, i+8, i+9
          const float2 c01 = *reinterpret_cast<const float2*>(cums + i);
          const float2 c89 = *reinterpret_cast<const float2*>(cums + i + 8);
          float dd[8] = {c01.x - cj_a, c01.y - cj_a, c01.x - cj_b,
                         c01.y - cj_b, c89.x - cj_a, c89.y - cj_a,
                         c89.x - cj_b, c89.y - cj_b};
          if (edge) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int col = i + (e & 1) + (e >> 2) * 8;
              const int row = (e & 2) ? r_b : r_a;
              dd[e] = masked(dd[e], col >= row && col < a.chunk);
            }
          }
          // W^T[j, i] = S^T[j, i] L[i, j] dt_j: the A fragment of key rows
          // r_a, r_b and query columns i.. (see acc_to_a)
          float w[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            w[h][0] = s[d][2 * ks + h][0] * dt_a * exp_diff(dd[4 * h]);
            w[h][1] = s[d][2 * ks + h][1] * dt_a * exp_diff(dd[4 * h + 1]);
            w[h][2] = s[d][2 * ks + h][2] * dt_b * exp_diff(dd[4 * h + 2]);
            w[h][3] = s[d][2 * ks + h][3] * dt_b * exp_diff(dd[4 * h + 3]);
          }
          uint32_t ahi[4], alo[4];
          acc_to_a(w, 0, ahi, alo);
          mma_kn<PT>(acc, ahi, alo, th, th + kTile * L.t_ld, L.t_ld, ks * 16,
                     lane);
        }
      }
      ++k;
    }
    for (int qt = 0; qt < nq; ++qt) {
      step();
      if (live) {
        // (dt e B)_j dst: A = B's key rows scaled by dt_j e_j
        const bf16* th = tile(k);
        const float cl = cums[a.chunk - 1];
        const float f_a = dts[r_a] * exp_diff(cl - cums[r_a]);
        const float f_b = dts[r_b] * exp_diff(cl - cums[r_b]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int q0 = qt * kTile + ks * 16;
          if (q0 >= a.nw) break;  // dst rows past N are 0
          uint32_t bq[4], ahi[4], alo[4];
          ldsm_x4(bq, F + (warp * 16 + (lane & 15)) * L.f_ld + q0 +
                          (lane >> 4) * 8);
          scale_split(bq[0], f_a, ahi[0], alo[0]);
          scale_split(bq[1], f_b, ahi[1], alo[1]);
          scale_split(bq[2], f_a, ahi[2], alo[2]);
          scale_split(bq[3], f_b, ahi[3], alo[3]);
          mma_kn<PT>(acc, ahi, alo, th, th + kTile * L.t_ld, L.t_ld, ks * 16,
                     lane);
        }
      }
      ++k;
    }
    if (live) {
      const int hh = pl.h_lo + hi;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? r_b : r_a;
        if (r >= a.chunk) continue;
        bf16* row = a.dx + (((long long)pl.b * a.S + pl.row0 + r) * a.H +
                            hh) * a.P;
#pragma unroll
        for (int c = 0; c < PT; ++c) {
          const int col = c * 8 + 2 * t4;
          if (col < a.P) {
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(acc[c][2 * half], acc[c][2 * half + 1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the column terms (kCol, by key tile j) and the row terms (by query tile i)
// ---------------------------------------------------------------------------

// Shared memory: F = the block's fixed tile of B (kCol: key rows) or C
// (query rows), V = the moving tile of C or B [64][8 NT + 8] bf16; two
// item stages of { x tile, hi and lo tiles of dy or dst rows [64][72]
// bf16, dt and cum [chunk_pad] }; per-head row sums [hpb][64] f32 (kCol:
// sum_i G o S, e r and dt e r; else rowsum M).
struct GramLayout {
  int f_ld, x_ld, f_bytes, x_bytes, stage, red_off, total;
};

__host__ __device__ __forceinline__ GramLayout gram_layout(int nt8,
                                                           int chunk_pad,
                                                           int hpb,
                                                           bool col) {
  GramLayout L;
  L.f_ld = nt8 + 8;
  L.x_ld = kMaxP + 8;  // x, dy and dst tiles are loaded kMaxP wide
  L.f_bytes = kTile * L.f_ld * 2;
  L.x_bytes = kTile * L.x_ld * 2;
  L.stage = 3 * L.x_bytes + 2 * chunk_pad * 4;
  L.red_off = 2 * L.f_bytes + 2 * L.stage;
  L.total = L.red_off + (col ? 3 : 1) * hpb * kTile * 4;
  return L;
}

// NT: 8-column tiles of n (n <= 8 NT), the width of dB / dC a warp holds
template <bool kCol, int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_gram_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNq = (NT + 7) / 8;  // 64-row tiles of dst rows q
  const GramLayout L = gram_layout(8 * NT, a.chunk_pad, a.hpb, kCol);
  bf16* F = reinterpret_cast<bf16*>(smem);
  bf16* V = reinterpret_cast<bf16*>(smem + L.f_bytes);
  // item k's x tile; its hi and lo tiles follow, then dt and cum
  auto xt = [&](int k) {
    return reinterpret_cast<bf16*>(smem + 2 * L.f_bytes + (k & 1) * L.stage);
  };
  auto vv = [&](int k) {
    return reinterpret_cast<float*>(smem + 2 * L.f_bytes + (k & 1) * L.stage +
                                    3 * L.x_bytes);
  };
  const int tsz = kTile * L.x_ld;  // elements of a tile
  float* red = reinterpret_cast<float*>(smem + L.red_off);  // [.][hpb][64]
  float* red_er = red + a.hpb * kTile;
  float* red_t = red_er + a.hpb * kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Place pl = place(a, !kCol);
  const int t0 = pl.tile * kTile;  // the block's rows: key (kCol) or query
  const int nc = a.S / a.chunk;
  const int n_outer = kCol ? a.nt - pl.tile : pl.tile + 1;
  const int n0 = (kCol && a.dst) ? pl.nh * kNq : 0;  // the dst items
  const int total = n0 + n_outer * pl.nh;

  const bf16* xg = a.x + pl.b * a.x_sb + pl.row0 * a.x_ss;
  const bf16* Bg = a.B + pl.b * a.B_sb + pl.row0 * a.B_ss + pl.grp * a.B_sg;
  const bf16* Cg = a.C + pl.b * a.C_sb + pl.row0 * a.C_ss + pl.grp * a.C_sg;
  const long long dy_ss = (long long)a.H * a.P;
  const long long dy0 = ((long long)pl.b * a.S + pl.row0) * dy_ss;
  const long long dst0 = ((long long)pl.b * nc + pl.ci) * a.H * a.N * a.P;
  const long long v0 = (long long)pl.b * a.H * a.S + pl.row0;  // + hh S
  // the moving tile of outer step o: kCol C of query tile tile + o, else B
  // of key tile o
  const int o_tile0 = kCol ? pl.tile : 0;

  // item k: the dst items (head, q tile), then (outer step, head): x of
  // the key tile, dy of the query tile (or dst rows), dt and cum of the
  // head
  auto issue = [&](int k) {
    int hi, key_t, rows;
    const bf16 *src_hi, *src_lo;
    long long rs;
    if (k < n0) {
      hi = k / kNq;
      const int q0 = (k - hi * kNq) * kTile;
      key_t = pl.tile;
      const long long o = dst0 + ((long long)(pl.h_lo + hi) * a.N + q0) * a.P;
      src_hi = a.dst_hi + o;
      src_lo = a.dst_lo + o;
      rs = a.P;
      rows = a.N - q0;
    } else {
      const int o = (k - n0) / pl.nh;
      hi = k - n0 - o * pl.nh;
      key_t = kCol ? pl.tile : o;
      const int qry_t = kCol ? pl.tile + o : pl.tile;
      const long long off = dy0 + (pl.h_lo + hi) * a.P +
                            qry_t * kTile * dy_ss;
      src_hi = a.dy_hi + off;
      src_lo = a.dy_lo + off;
      rs = dy_ss;
      rows = a.chunk - qry_t * kTile;
    }
    const int hh = pl.h_lo + hi;
    bf16* x_s = xt(k);
    load_tile<kMaxP / 8>(x_s, L.x_ld,
                         xg + hh * a.x_sh + key_t * kTile * a.x_ss, a.x_ss,
                         a.chunk - key_t * kTile, a.P);
    load_tile<kMaxP / 8>(x_s + tsz, L.x_ld, src_hi, rs, rows, a.P);
    load_tile<kMaxP / 8>(x_s + 2 * tsz, L.x_ld, src_lo, rs, rows, a.P);
    load_vec(vv(k), a.dt_t + v0 + (long long)hh * a.S, a.chunk_pad, a.chunk);
    load_vec(vv(k) + a.chunk_pad, a.cum_t + v0 + (long long)hh * a.S,
             a.chunk_pad, a.chunk);
    cp_async_commit();
  };

  if (kCol) {
    load_tile<NT>(F, L.f_ld, Bg + t0 * a.B_ss, a.B_ss, a.chunk - t0, a.N);
  } else {
    load_tile<NT>(F, L.f_ld, Cg + t0 * a.C_ss, a.C_ss, a.chunk - t0, a.N);
  }
  issue(0);
  for (int e = threadIdx.x; e < (kCol ? 3 : 1) * a.hpb * kTile;
       e += kThreads) {
    red[e] = 0.f;
  }
  const bool live = t0 + warp * 16 < a.chunk;
  const int rl_a = warp * 16 + g, rl_b = rl_a + 8;  // tile rows
  const int r_a = t0 + rl_a, r_b = t0 + rl_b;       // chunk rows

  float acc[NT][4];  // dB (kCol) or dC rows of the head set
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;

  int k = 0;
  auto step = [&]() {
    cp_async_wait_all();
    __syncthreads();  // item k landed; the other stage is free
    if (k + 1 < total) issue(k + 1);
  };
  // a row pair's partial sums (rows r_a, r_b) over the quad, added by its
  // first lane to row_sums[.][tile row]
  auto add_rows = [&](float* row_sums, float va, float vb) {
    va += __shfl_xor_sync(0xffffffffu, va, 1);
    va += __shfl_xor_sync(0xffffffffu, va, 2);
    vb += __shfl_xor_sync(0xffffffffu, vb, 1);
    vb += __shfl_xor_sync(0xffffffffu, vb, 2);
    if (t4 == 0) {
      row_sums[rl_a] += va;
      row_sums[rl_b] += vb;
    }
  };

  if constexpr (kCol) {
    // ---- the state terms: XD = x dst^T, r_j = sum_q B XD, dB += dt e XD
    for (int hi = 0; hi < pl.nh && n0 > 0; ++hi) {
      float ra = 0.f, rb = 0.f, f_a = 0.f, f_b = 0.f, e_a = 0.f, e_b = 0.f;
#pragma unroll
      for (int qt = 0; qt < kNq; ++qt) {
        step();
        if (live) {
          const float* dts = vv(k);
          const float* cums = dts + a.chunk_pad;
          const float cl = cums[a.chunk - 1];
          e_a = exp_diff(cl - cums[r_a]);
          e_b = exp_diff(cl - cums[r_b]);
          f_a = dts[r_a] * e_a;
          f_b = dts[r_b] * e_b;
          float xd[8][4];
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) xd[c][e] = 0.f;
          const bf16* x_s = xt(k);
          gram(xd, x_s, nullptr, L.x_ld, x_s + tsz, x_s + 2 * tsz, L.x_ld,
               a.pw, warp, lane);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            if (qt * 8 + c >= NT) break;
            const int q = qt * kTile + c * 8 + 2 * t4;
            const float2 ba = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(F + rl_a * L.f_ld +
                                                         q));
            const float2 bb = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(F + rl_b * L.f_ld +
                                                         q));
            ra = fmaf(ba.x, xd[c][0], fmaf(ba.y, xd[c][1], ra));
            rb = fmaf(bb.x, xd[c][2], fmaf(bb.y, xd[c][3], rb));
            acc[qt * 8 + c][0] = fmaf(f_a, xd[c][0], acc[qt * 8 + c][0]);
            acc[qt * 8 + c][1] = fmaf(f_a, xd[c][1], acc[qt * 8 + c][1]);
            acc[qt * 8 + c][2] = fmaf(f_b, xd[c][2], acc[qt * 8 + c][2]);
            acc[qt * 8 + c][3] = fmaf(f_b, xd[c][3], acc[qt * 8 + c][3]);
          }
        }
        ++k;
      }
      if (live) {
        add_rows(red_er + hi * kTile, e_a * ra, e_b * rb);
        add_rows(red_t + hi * kTile, f_a * ra, f_b * rb);
      }
    }
  }

  for (int o = 0; o < n_outer; ++o) {
    const int m0 = (o_tile0 + o) * kTile;  // the moving tile's chunk rows
    __syncthreads();  // the previous moving tile's readers are done
    if (kCol) {
      load_tile<NT>(V, L.f_ld, Cg + m0 * a.C_ss, a.C_ss, a.chunk - m0, a.N);
    } else {
      load_tile<NT>(V, L.f_ld, Bg + m0 * a.B_ss, a.B_ss, a.chunk - m0, a.N);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // S of this warp's 16 rows against the moving tile: kCol S^T[j, i] =
    // B_j . C_i, else S[i, j] = C_i . B_j
    float s[8][4], gs[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = gs[c][e] = 0.f;
    if (live) {
      gram(s, F, nullptr, L.f_ld, V, nullptr, L.f_ld, a.nw, warp, lane);
    }
    // the diagonal tile pair and a query tile past the chunk are masked
    const bool edge =
        o_tile0 + o == pl.tile || (kCol ? m0 : t0) + kTile > a.chunk;
    for (int hi = 0; hi < pl.nh; ++hi) {
      step();
      if (live) {
        const float* dts = vv(k);
        const float* cums = dts + a.chunk_pad;
        float gp[8][4];  // kCol (dy x^T)^T[j, i], else dy x^T[i, j]
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) gp[c][e] = 0.f;
        const bf16* x_s = xt(k);
        if (kCol) {
          gram(gp, x_s, nullptr, L.x_ld, x_s + tsz, x_s + 2 * tsz, L.x_ld,
               a.pw, warp, lane);
        } else {
          gram(gp, x_s + tsz, x_s + 2 * tsz, L.x_ld, x_s, nullptr, L.x_ld,
               a.pw, warp, lane);
        }
        const float c_a = cums[r_a], c_b = cums[r_b];
        float va = 0.f, vb = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int m = m0 + c * 8 + 2 * t4;  // columns m, m + 1
          const float2 cm = *reinterpret_cast<const float2*>(cums + m);
          // L = exp(cum_i - cum_j), taken where j <= i < chunk
          float d[4];
          if (kCol) {  // rows j, columns i
            d[0] = masked(cm.x - c_a, !edge || (m >= r_a && m < a.chunk));
            d[1] = masked(cm.y - c_a,
                          !edge || (m + 1 >= r_a && m + 1 < a.chunk));
            d[2] = masked(cm.x - c_b, !edge || (m >= r_b && m < a.chunk));
            d[3] = masked(cm.y - c_b,
                          !edge || (m + 1 >= r_b && m + 1 < a.chunk));
          } else {  // rows i, columns j
            d[0] = masked(c_a - cm.x, !edge || (m <= r_a && r_a < a.chunk));
            d[1] = masked(c_a - cm.y,
                          !edge || (m + 1 <= r_a && r_a < a.chunk));
            d[2] = masked(c_b - cm.x, !edge || (m <= r_b && r_b < a.chunk));
            d[3] = masked(c_b - cm.y,
                          !edge || (m + 1 <= r_b && r_b < a.chunk));
          }
          if (kCol) {
            // G = G' L; sum_i G o S (ddt, dcum); Gd^T = G dt_j (row)
            const float dt_a = dts[r_a], dt_b = dts[r_b];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float G = gp[c][e] * exp_diff(d[e]);
              if (e < 2) {
                va = fmaf(G, s[c][e], va);
                gs[c][e] = fmaf(G, dt_a, gs[c][e]);
              } else {
                vb = fmaf(G, s[c][e], vb);
                gs[c][e] = fmaf(G, dt_b, gs[c][e]);
              }
            }
          } else {
            // Gd = G' L dt_j (column); rowsum M = sum_j Gd o S
            const float2 dm = *reinterpret_cast<const float2*>(dts + m);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float Gd =
                  gp[c][e] * exp_diff(d[e]) * ((e & 1) ? dm.y : dm.x);
              if (e < 2) {
                va = fmaf(Gd, s[c][e], va);
              } else {
                vb = fmaf(Gd, s[c][e], vb);
              }
              gs[c][e] += Gd;
            }
          }
        }
        add_rows(red + hi * kTile, va, vb);
      }
      ++k;
    }
    // the head set's product with the moving tile, once: kCol dB_j +=
    // sum_i Gsum^T[j, i] C_i, else dC_i += sum_j Gsum[i, j] B_j
    if (live) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ahi[4], alo[4];
        acc_to_a(gs, ks, ahi, alo);
        mma_kn<NT>(acc, ahi, alo, V, nullptr, L.f_ld, ks * 16, lane);
      }
    }
  }

  // ---- the block's outputs ------------------------------------------------
  if (live) {
    const long long per = (long long)a.batch * a.S * a.G * a.N;
    const int hset = (pl.h_lo - pl.grp * (a.H / a.G)) / a.hpb;
    float* out = a.part + ((kCol ? 0 : 1) * (long long)a.n_hsets + hset) *
                              per;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r_b : r_a;
      if (r >= a.chunk) continue;
      float* row =
          out + (((long long)pl.b * a.S + pl.row0 + r) * a.G + pl.grp) * a.N;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const int q = c * 8 + 2 * t4;
        if (q < a.N) {
          *reinterpret_cast<float2*>(row + q) =
              make_float2(acc[c][2 * half], acc[c][2 * half + 1]);
        }
      }
    }
  }
  __syncthreads();  // the row sums are complete
  for (int e = threadIdx.x; e < pl.nh * kTile; e += kThreads) {
    const int hi = e / kTile, rl = e - hi * kTile;
    const int r = t0 + rl;
    if (r >= a.chunk) continue;
    const int hh = pl.h_lo + hi;
    const long long o = ((long long)pl.b * a.S + pl.row0 + r) * a.H + hh;
    if (kCol) {
      // ddt_j = sum_i G o S + e r; dcum_j's column terms -dt_j sum_i G o S
      // - dt e r (the finish adds the row terms)
      const float cs = red[e];
      a.ddt[o] = cs + red_er[e];
      a.dcum[o] = -a.dt_t[v0 + (long long)hh * a.S + r] * cs - red_t[e];
    } else {
      a.mrow[o] = red[e];
    }
  }
  if (kCol && (int)threadIdx.x < pl.nh) {
    // the state term's sum over this key tile, for the chunk's last row
    const int hi = threadIdx.x;
    float sum = 0.f;
    for (int rl = 0; rl < kTile; ++rl) sum += red_t[hi * kTile + rl];
    a.tsum[(((long long)pl.b * nc + pl.ci) * a.H + pl.h_lo + hi) * a.nt +
           pl.tile] = sum;
  }
}

// The first pass: dy (any strides) and dst split into bf16 hi + lo,
// contiguous; dt and cum laid out by head, (b, h, s). Four elements of dy
// or dst a step (p is a multiple of 8 and the rows 16-byte aligned).
__device__ __forceinline__ void split4(const float4 v, bf16* hi, bf16* lo) {
  uint2 h, l;
  split2(v.x, v.y, h.x, l.x);
  split2(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

__global__ void __launch_bounds__(256) ssd_bwd_prep_kernel(const Args a) {
  const int nc = a.S / a.chunk;
  const long long n_dy = (long long)a.batch * a.S * a.H * (a.P / 4);
  const long long n_dst =
      a.dst ? (long long)a.batch * nc * a.H * a.N * (a.P / 4) : 0;
  const long long n_v = (long long)a.batch * a.H * a.S;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < n_dy + n_dst + n_v; e += (long long)gridDim.x * blockDim.x) {
    if (e < n_dy) {
      long long r = e / (a.P / 4);
      const int c = (int)(e - r * (a.P / 4)) * 4;
      const int hh = (int)(r % a.H);
      r /= a.H;
      const long long srow = r % a.S, b = r / a.S;
      const float4 v = *reinterpret_cast<const float4*>(
          a.dy + b * a.dy_sb + srow * a.dy_ss + hh * a.dy_sh + c);
      split4(v, a.dy_hi + 4 * e, a.dy_lo + 4 * e);
    } else if (e < n_dy + n_dst) {
      const long long o = 4 * (e - n_dy);
      split4(*reinterpret_cast<const float4*>(a.dst + o), a.dst_hi + o,
             a.dst_lo + o);
    } else {
      const long long o = e - n_dy - n_dst;  // (b, h, s)
      const long long srow = o % a.S, bh = o / a.S;
      const long long hh = bh % a.H, b = bh / a.H;
      a.dt_t[o] = a.dt[b * a.dt_sb + srow * a.dt_ss + hh * a.dt_sh];
      a.cum_t[o] = a.cum[b * a.cum_sb + srow * a.cum_ss + hh * a.cum_sh];
    }
  }
}

// dB and dC: the head sets' f32 sums in order, rounded once; dcum += the
// row terms, and on a chunk's last row the state terms' sum over the
// chunk, in key tile order.
template <typename TC>
__global__ void __launch_bounds__(256)
ssd_bwd_finish_kernel(const Args a, bf16* dB, TC* dC) {
  const long long rows = (long long)a.batch * a.S;
  const long long per = rows * a.G * a.N;
  const long long n_dcum = rows * a.H;
  const int nc = a.S / a.chunk;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < 2 * per + n_dcum; e += (long long)gridDim.x * blockDim.x) {
    if (e < 2 * per) {
      const int which = e >= per;
      const long long o = e - which * per;
      const float* src = a.part + (long long)which * a.n_hsets * per + o;
      float acc = 0.f;
      for (int hs = 0; hs < a.n_hsets; ++hs) acc += src[hs * per];
      if (which) {
        store(dC + o, acc);
      } else {
        store(dB + o, acc);
      }
    } else {
      const long long o = e - 2 * per;
      const int hh = (int)(o % a.H);
      const long long bs = o / a.H;
      const int srow = (int)(bs % a.S);
      const long long b = bs / a.S;
      float add = a.mrow[o];
      if (srow % a.chunk == a.chunk - 1) {
        const float* ts =
            a.tsum + ((b * nc + srow / a.chunk) * a.H + hh) * a.nt;
        float t = 0.f;
        for (int jt = 0; jt < a.nt; ++jt) t += ts[jt];
        add += t;
      }
      a.dcum[o] += add;
    }
  }
}

template <typename K>
int allow_smem(K kernel, int bytes, int& configured) {
  if (bytes <= configured) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  configured = bytes;
  return 0;
}

template <int PT>
int launch_dx(const Args& a, long long blocks, cudaStream_t s) {
  static int configured = 0;
  const DxLayout L = dx_layout(8 * PT, a.chunk_pad);
  const int err = allow_smem(ssd_bwd_dx_kernel<PT>, L.total, configured);
  if (err) return err;
  ssd_bwd_dx_kernel<PT><<<(unsigned)blocks, kThreads, L.total, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kCol, int NT>
int launch_gram(const Args& a, long long blocks, cudaStream_t s) {
  static int configured = 0;
  const GramLayout L = gram_layout(8 * NT, a.chunk_pad, a.hpb, kCol);
  const int err = allow_smem(ssd_bwd_gram_kernel<kCol, NT>, L.total,
                             configured);
  if (err) return err;
  ssd_bwd_gram_kernel<kCol, NT><<<(unsigned)blocks, kThreads, L.total, s>>>(
      a);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_grams(const Args& a, long long blocks, cudaStream_t s) {
  const int err = launch_gram<true, NT>(a, blocks, s);
  return err ? err : launch_gram<false, NT>(a, blocks, s);
}

bool aligned(const void* p, long long sb, long long ss, long long sh,
             int width, int elems) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % elems == 0 &&
         ss % elems == 0 && sh % elems == 0 && width % elems == 0;
}

}  // namespace

// C entry point, bound with ctypes. x, B, C, dx and dB bf16; dC bf16
// (dc_f32 0) or f32 (1); hpb heads a block (the caller sizes part for
// ceil((H / G) / hpb) head sets). Scratch the caller allocates: part (2,
// sets, b, s, g, n), mrow (b, s, h), tsum (b, nc, h, nt) and dt_t, cum_t
// (b, h, s) f32; dy_hi, dy_lo (b, s, h, p) and, unless dst is null,
// dst_hi, dst_lo (b, nc, h, n, p) bf16. Needs 16-byte aligned rows and
// bases, p and n multiples of 8, p <= 64, n <= 128, chunk a multiple of 4
// up to 256, dst contiguous or null. Launches five kernels on `stream`
// (PyTorch's current stream), does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported to the caller.
extern "C" int ssd_chunk_bwd_tc_launch(
    const void* x, const void* dt, const void* cum, const void* B,
    const void* C, const void* dy, const void* dst, void* dx, void* ddt,
    void* dcum, void* dB, void* dC, void* part, void* mrow, void* tsum,
    void* dy_hi, void* dy_lo, void* dst_hi, void* dst_lo, void* dt_t,
    void* cum_t, long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long cum_sb, long long cum_ss,
    long long cum_sh, long long B_sb, long long B_ss, long long B_sg,
    long long C_sb, long long C_ss, long long C_sg, long long dy_sb,
    long long dy_ss, long long dy_sh, int batch, int S, int H, int P, int G,
    int N, int chunk, int hpb, int dc_f32, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || P < 8 ||
      P > kMaxP || P % 8 != 0 || N < 8 || N > kMaxN || N % 8 != 0 ||
      chunk < 4 || chunk > kMaxChunk || chunk % 4 != 0 || S % chunk != 0 ||
      hpb < 1 ||
      hpb > kMaxHeads || !aligned(x, x_sb, x_ss, x_sh, P, 8) ||
      !aligned(B, B_sb, B_ss, B_sg, N, 8) ||
      !aligned(C, C_sb, C_ss, C_sg, N, 8) ||
      !aligned(dy, dy_sb, dy_ss, dy_sh, P, 4) ||
      reinterpret_cast<uintptr_t>(dst) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = {};
  a.x = static_cast<const bf16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.cum = static_cast<const float*>(cum);
  a.B = static_cast<const bf16*>(B);
  a.C = static_cast<const bf16*>(C);
  a.dy = static_cast<const float*>(dy);
  a.dst = static_cast<const float*>(dst);
  a.dx = static_cast<bf16*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dcum = static_cast<float*>(dcum);
  a.part = static_cast<float*>(part);
  a.mrow = static_cast<float*>(mrow);
  a.tsum = static_cast<float*>(tsum);
  a.dy_hi = static_cast<bf16*>(dy_hi);
  a.dy_lo = static_cast<bf16*>(dy_lo);
  a.dst_hi = static_cast<bf16*>(dst_hi);
  a.dst_lo = static_cast<bf16*>(dst_lo);
  a.dt_t = static_cast<float*>(dt_t);
  a.cum_t = static_cast<float*>(cum_t);
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
  a.nt = (chunk + kTile - 1) / kTile;
  a.chunk_pad = a.nt * kTile;
  a.nw = (N + 15) / 16 * 16;
  a.pw = (P + 15) / 16 * 16;
  a.hpb = hpb;
  a.n_hsets = (H / G + hpb - 1) / hpb;
  const long long blocks =
      (long long)batch * (S / chunk) * G * a.n_hsets * a.nt;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_prep =
      (long long)batch * S * H * (P / 4) * (dst ? 2 : 1) +
      (long long)batch * H * S;
  const long long prep_want = (n_prep + 255) / 256;
  ssd_bwd_prep_kernel<<<(int)(prep_want < 32LL * sm_count()
                                  ? prep_want
                                  : 32LL * sm_count()),
                        256, 0, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = P <= 32 ? launch_dx<4>(a, blocks, s) : launch_dx<8>(a, blocks, s);
  if (err) return err;
  err = N <= 32   ? launch_grams<4>(a, blocks, s)
        : N <= 64 ? launch_grams<8>(a, blocks, s)
                  : launch_grams<16>(a, blocks, s);
  if (err) return err;
  const long long total = 2LL * batch * S * G * N + (long long)batch * S * H;
  const long long want = (total + 255) / 256;
  const int fin = (int)(want < 8LL * sm_count() ? want : 8LL * sm_count());
  if (dc_f32) {
    ssd_bwd_finish_kernel<float><<<fin, 256, 0, s>>>(
        a, static_cast<bf16*>(dB), static_cast<float*>(dC));
  } else {
    ssd_bwd_finish_kernel<bf16><<<fin, 256, 0, s>>>(
        a, static_cast<bf16*>(dB), static_cast<bf16*>(dC));
  }
  return (int)cudaGetLastError();
}
