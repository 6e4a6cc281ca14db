// The Mamba2 SSD chunked scan, backward.
//
// The gradient of csrc/ssd_scan.cu, the port of the TPU kernel
// repro.kernels.ssd_scan.ssd_scan (src/repro/kernels/ssd_scan.py:83).  It
// replaces no TPU kernel: that Pallas kernel has no backward, and the JAX
// package trains through its XLA scan (repro.models.ssm.ssd_chunked),
// whose gradient XLA forms.  Per batch row b and head h, over
// chunks of q rows, with seg the chunk's cumulative sum of A dt, tot =
// seg[q-1], h_c the fp32 state entering chunk c and dy the output
// gradient:
//
//   g_c  = exp(tot_c) g_{c+1} + sum_i exp(seg_i) dy_i C_i^T   (g_nc = 0;
//          G_c := g_{c+1}, the gradient of the state leaving chunk c)
//   dx_j = dt_j [sum_{i>=j} (C_i.B_j) exp(seg_i - seg_j) dy_i
//                + exp(tot - seg_j) G_c B_j]
//   dB_j = sum_{i>=j} V_ij C_i + exp(tot - seg_j) dt_j G_c^T x_j
//   dC_i = sum_{j<=i} V_ij B_j + exp(seg_i) h_c^T dy_i
//          with V_ij = (dy_i.x_j) exp(seg_i - seg_j) dt_j,
//
// dB and dC summed over the heads of a group; dt's direct terms e1_j =
// sum_i (C_i.B_j) exp(seg_i - seg_j) (dy_i.x_j) and e2_j = exp(tot -
// seg_j) x_j.(G_c B_j); d(seg)_k = r_k - dt_k (e1_k + e2_k), r_k = the row
// sum of M_kj = (C_k.B_j) exp(seg_k - seg_j) dt_j (dy_k.x_j) plus
// exp(seg_k) C_k.(h_c^T dy_k) (dC_k's carried term dotted with C_k: no
// product of its own), and d(seg)_{q-1} += exp(tot) sum(G_c * h_c) +
// sum_j dt_j e2_j; then d(A dt) is d(seg)'s reverse cumulative sum within
// the chunk, ddt = e1 + e2 + A d(A dt) and dA = sum dt d(A dt).  The mask
// is applied before the exp.  ssd_scan.py's ssd_scan_backward_plain is the
// same computation in torch.
//
// Two routes, chosen on the host (ssd_scan.py's backward_route), both
// launched by one wrapper call and both ending in the same two passes:
//
//   finalize, one block per (chunk, head, batch row): d(seg), its reverse
//   cumulative sum, ddt and the chunk's part of dA, in fp64 (they cancel
//   heavily: the row sums of M from the query tiles and its column sums
//   from the key tiles, which the FMA route forms from the same fp32
//   values of M and adds in fp64, so that they cancel to fp64's rounding;
//   the wgmma route forms exp(seg_i - seg_j) from the difference, whose
//   rounding would otherwise reach dA);
//   reduce: dB and dC summed over a group's heads in head order (cast to
//   x's dtype; "wgmma": over its head slices, in slice order), dA over
//   batch rows and chunks in order.
//
// "wgmma" (bf16, hd 64, ds 64 or 128, q a multiple of 64 up to 256,
// 16-byte aligned rows and strides: mamba2-1.3b's and zamba2's training
// shapes).  Bound: at mamba2-1.3b's training shape (x [4, 2048, 64, 64]
// bf16, ds 128, chunk 256, one group of 64 heads) the function's least
// work is C B^T once a group, four causal products a head (dy x^T, W^T
// dy, V^T C, V B) and five [hd, ds] state products a head (the chunk
// state, the state gradient's share, G_c B, x G_c, h_c^T dy): 94.96
// GFLOP, 0.096 ms at the 989 TFLOP/s bf16 rate; its bytes (x, dy, B, C,
// dt read once, dx, dB, dC, ddt written once) are 0.21 GB, 0.064 ms.  So
// operations bound it.  The kernels:
//
//   1. seg, one warp per (batch row, head, chunk): seg (and the chunk's dt,
//      contiguous) into scratch;
//   2. scan, one block per (head, batch row): the chunk states h_c forward
//      and the state gradients G_c in reverse, the state in a warpgroup's
//      wgmma accumulator [64 x ds] across the chunks; each chunk's own term
//      ((exp(tot - seg_j) dt_j x_j)^T B_j, or (exp(seg_i) dy_i)^T C_i, the
//      rows scaled in shared memory) added by wgmma onto the state scaled
//      by exp(tot); h_c written in fp32 and bf16, G_c in bf16, and
//      sum(G_c * h_c) in fp64 for the finalize.  The chunk contributions
//      never leave the chip; the states go out staged through shared
//      memory, 16 bytes a store;
//   3. C B^T, one block per (query tile, chunk, group, batch row): the
//      causal 64 x 64 tiles of C B^T once per (batch row, group, chunk),
//      fp32 on mma.sync, written in both tile kernels' fragment orders
//      (8.4 MB each at mamba2's shape: they stay in L2);
//   4. keys, one block per (key tile j of 64 rows, head slice, group,
//      chunk, batch row): B_j, the query tiles' C_i and their C B^T tiles
//      stay in shared memory across the slice's heads, read once; a
//      producer warp brings each head's x_j, G_c (bf16), seg and dt into
//      one of two head stages and its dy_i tiles through a ring of three
//      (TMA, 128-byte swizzle; bulk copies), while one consumer warpgroup
//      runs every product on wgmma: S^T = x_j dy_i^T (both K-major); the
//      weights W^T = C B^T dec dt_j and V^T = S^T dec dt_j (dec = exp(seg_i
//      - seg_j), masked before the exp) scaled, masked and packed in
//      registers as the A operands of dx += W^T dy_i and dB += V^T C_i
//      (dy_i, C_i MN-major); then G_c B_j (K-major), e2, dx's carried term
//      and dB += (exp(tot - seg_j) dt_j x_j) G_c (the scaled x_j a register
//      A operand, G_c MN-major).  dx is staged through the consumed x tile
//      and written per head with e1, e2 and the column sums of M; dB is
//      summed over the slice's heads in registers, in head order;
//   5. queries, one block per (query tile i, head slice, group, chunk,
//      batch row), the mirror image: C_i, the key tiles' B_j and C B^T
//      resident; per head dy_i, h_c (bf16), seg, dt, and x_j through the
//      ring; S = dy_i x_j^T, V = S dec dt_j, the row sums of M, dC += V B_j;
//      then h_c^T dy_i (dy_i a register A operand, h_c MN-major), scaled by
//      exp(seg_i) into dC and dotted with C_i for d(seg); dC summed over
//      the slice's heads in registers.
//
// A head slice (the host's choice: ssd_scan.py's backward_head_slice)
// takes ~4 blocks an SM's worth of heads (at least 8):
// mamba2-1.3b's 64 heads are 5 slices of 13 (the last of 12), zamba2's
// 112 are 5 of 23 (the last of 20); each slice's dB and dC go to fp32
// scratch [slices, B, S, G, ds] (5/64 of per-head scratch), summed in
// slice order by the reduce (none with one slice).  What the three costs
// of the earlier design became: C B^T is formed once per (batch row,
// group, chunk), not once a head in each tile kernel (43 GFLOP then,
// 0.34 now); dB and dC are summed over a slice's heads on chip, not
// through 2 x [B, S, H, ds] fp32 scratch (2 x 268 MB, 1.07 GB of traffic
// for 4.2 MB of output); every tile comes through a TMA ring whose loads
// overlap the products, and the products run on wgmma, not mma.sync.  The
// work these kernels do at mamba2's shape: ~116 GFLOP against the bound's
// 95: full 64 x 64 tiles on the diagonal (1.25x the causal pairs), dy x^T
// formed in both tile kernels (21.5 GFLOP against the bound's 8.6), the
// scan's 14 chunk products a head against 16.  A consumer warpgroup
// takes all 255 registers a thread may have (the key kernel spills 12
// bytes), so a block is one consumer warpgroup and one producer warp
// (160 threads, no setmaxnreg: the producer is not a warpgroup), with
// ~221 KB of shared memory: one block an SM.
//
// "fma" (fp32, and every shape "wgmma" does not take: bf16 at another
// head dim or d_state, chunks not a multiple of 64 or past 256, rows not
// 16-byte aligned): 1. states, one block per (chunk, head, batch row): seg
// (stored), the chunk's own state contribution sum_j exp(tot - seg_j)
// dt_j x_j^T B_j and its share of the state gradient sum_i exp(seg_i)
// dy_i^T C_i, [hd, ds] each, in fp32 scratch; 2. pass, sequential over
// the chunks, one thread per state element: forward for h_c, in reverse
// for G_c, in place, fp32; 3. keys, one block per (key tile of 32 rows,
// chunk, head, batch row): dx, the head's dB rows (fp32 scratch [b, s, h,
// ds]) and e1, e2, walking the query tiles i >= j; 4. queries, one block
// per (query tile, chunk, head, batch row): the head's dC rows and r,
// walking the key tiles j <= i.  Tiles are fp32 in shared memory, the
// products plain fp32 FMA loops, accumulators in shared memory owned by
// one thread each; the reduce sums the per-head dB and dC in head order.
//
// On the wgmma route G_c and h_c are rounded to bf16 as operands, and so
// are the scaled weights; every sum, seg and the states stay fp32.  No
// atomics: every sum has one order, so two runs give the same bits.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/ssd_scan.py loads it with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 64;       // the C B^T kernel: rows of a tile
constexpr int kMmaThreads = 128;
constexpr int kFRows = 32;      // fma route: rows of a tile
constexpr int kFThreads = 256;
constexpr long long kMaxSmem = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, bf16* p) { *p = __float2bfloat16_rn(v); }

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;   // [B, S, H, hd] contiguous, x's dtype
  void* dx;         // [B, S, H, hd] contiguous, x's dtype
  float* ddt;       // [B, S, H]
  float* dA;        // [H]
  void* dB;         // [B, S, G, ds], x's dtype
  void* dC;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  int Bn, S, H, G, hd, ds, q;
  float* hst;       // [B, H, nc, hd, ds]: h_c
  float* gst;       // [B, H, nc, hd, ds]: G_c
  float* segs;      // [B, H, nc, q]
  double* aux;      // [B, H, nc, q, 4]: e1, e2, r, the column sums of M
  // "fma": [B, S, H, ds], per-head dB and dC; "wgmma": [slices,
  // B, S, G, ds], each head slice's sums (unused with one slice)
  float* dBp;
  float* dCp;
  double* dA_part;  // [B, H, nc]
  // "wgmma" only (null otherwise)
  bf16* hb;         // [B, H, nc, hd, ds]: h_c in bf16 (the query kernel's operand)
  bf16* gb;         // [B, H, nc, hd, ds]: G_c in bf16 (the key kernel's)
  float* dts;       // [B, H, nc, q]: each chunk's dt, contiguous
  float* cb;        // [B, G, nc, 2, q / 64, q / 64, 64 * 64]: C B^T tiles, fragment order
  double* gh;       // [B, H, nc]: sum(G_c * h_c), fp64 (the finalize's)
  int hs;           // heads of a tile kernel's slice
};

// the block's (chunk, head, batch row) pointers
struct Chunk {
  int c, h, b, g, nc;
  long long c0, bhc;
  __device__ Chunk(const Args& a, int c_, int h_, int b_) : c(c_), h(h_), b(b_) {
    g = h / (a.H / a.G);
    nc = a.S / a.q;
    c0 = static_cast<long long>(c) * a.q;
    bhc = (static_cast<long long>(b) * a.H + h) * nc + c;
  }
  template <typename T> __device__ const T* x(const Args& a) const {
    return static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  }
  template <typename T> __device__ const T* B(const Args& a) const {
    return static_cast<const T*>(a.Bm) + b * a.b_sb + g * a.b_sg + c0 * a.b_ss;
  }
  template <typename T> __device__ const T* C(const Args& a) const {
    return static_cast<const T*>(a.Cm) + b * a.c_sb + g * a.c_sg + c0 * a.c_ss;
  }
  // dy, dx and the per-head dB, dC rows: row stride H hd (or H ds)
  __device__ long long row(const Args& a, int i) const {
    return (static_cast<long long>(b) * a.S + c0 + i) * a.H + h;
  }
  __device__ const float* dt(const Args& a) const { return a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss; }
};

// seg = cumsum(A dt) over the chunk's q rows, by one warp
__device__ __forceinline__ void chunk_cumsum(const float* dtc, float A, float* seg, int q,
                                             int lane) {
  const int per = (q + 31) / 32;
  const int lo = lane * per, hi = min(q, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += A * dtc[i];
    seg[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const float base = incl - run;
  for (int i = lo; i < hi; ++i) seg[i] += base;
}

// bytes of dynamic shared memory of the fma route's tile kernels
__host__ __device__ inline long long fma_smem_bytes(int hd, int ds, int q) {
  const long long r = kFRows;
  return 8LL * q + 4LL * (3 * r * ds + 3 * r * hd + 4 * r * r + 2 * r) + 8LL * r;
}

// ================================================================ pass 2
constexpr int kPassUnroll = 8;  // chunks whose loads a thread has in flight at once

// one thread per element of a (batch row, head)'s [hd, ds] state: h_c
// forward over the chunks from the contributions in hst, G_c in reverse
// from the shares in gst, both in place.  The chain through the chunks is
// serial; each group of kPassUnroll chunks' loads are issued before the
// group's first use, so a thread waits on memory once a group, not once a
// chunk.
__global__ void bwd_pass(const Args a, int n) {
  constexpr int U = kPassUnroll;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int nc = a.S / a.q;
  const long long bh = static_cast<long long>(blockIdx.z) * a.H + blockIdx.y;
  float* hp = a.hst + bh * nc * n + e;
  float* gp = a.gst + bh * nc * n + e;
  const float* total = a.segs + bh * nc * a.q + (a.q - 1);
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += U) {
    float v[U], et[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = min(c0 + u, nc - 1);
      v[u] = hp[static_cast<long long>(c) * n];
      et[u] = expf(total[static_cast<long long>(c) * a.q]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u < nc) {
        hp[static_cast<long long>(c0 + u) * n] = run;
        run = __fadd_rn(__fmul_rn(et[u], run), v[u]);
      }
    }
  }
  run = 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= U) {
    float v[U], et[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = max(c1 - u, 0);
      v[u] = gp[static_cast<long long>(c) * n];
      et[u] = expf(total[static_cast<long long>(c) * a.q]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c1 - u >= 0) {
        gp[static_cast<long long>(c1 - u) * n] = run;
        run = __fadd_rn(__fmul_rn(et[u], run), v[u]);
      }
    }
  }
}

// ================================================================ pass 5
// one block per (chunk, head, batch row): d(seg), its reverse cumulative
// sum d(A dt), ddt and the chunk's share of dA
__global__ void __launch_bounds__(256) bwd_finalize(const Args a) {
  extern __shared__ double fsm64[];
  const Chunk ch(a, blockIdx.x, blockIdx.y, blockIdx.z);
  const int q = a.q, tid = threadIdx.x;
  double* aux = fsm64;                                   // [q][4]: e1, e2, r, cm
  double* red = aux + 4 * q;                             // [256]
  float* dtv = reinterpret_cast<float*>(red + 256);      // [q]
  const double* src = a.aux + ch.bhc * q * 4;
  const float* DT = ch.dt(a);
  for (int i = tid; i < 4 * q; i += 256) aux[i] = src[i];
  for (int i = tid; i < q; i += 256) dtv[i] = DT[i * a.dt_ss];
  // sum(G_c * h_c), in a fixed order (the wgmma route's scan gives it)
  if (a.gh != nullptr) {
    if (tid == 0) red[0] = a.gh[ch.bhc];
    __syncthreads();
  } else {
    const long long n = static_cast<long long>(a.hd) * a.ds;
    const float* G = a.gst + ch.bhc * n;
    const float* Hc = a.hst + ch.bhc * n;
    double p = 0.0;
    for (long long e = tid; e < n; e += 256) p += static_cast<double>(G[e]) * Hc[e];
    red[tid] = p;
    __syncthreads();
    for (int s = 128; s > 0; s >>= 1) {
      if (tid < s) red[tid] += red[tid + s];
      __syncthreads();
    }
  }
  if (tid == 0) {
    const double tot = a.segs[ch.bhc * q + q - 1];
    const double Ah = a.A[ch.h];
    double sum_e2 = 0.0;
    for (int j = 0; j < q; ++j) sum_e2 += dtv[j] * aux[4 * j + 1];
    const double dtot = exp(tot) * red[0] + sum_e2;
    // in fp64: d(seg)'s row and column sums of M, its reverse cumulative
    // sum and dA's part all cancel heavily
    double run = 0.0, dA = 0.0;
    for (int k = q - 1; k >= 0; --k) {
      double* r = aux + 4 * k;
      double dseg = r[2] - r[3] - dtv[k] * r[1];
      if (k == q - 1) dseg += dtot;
      run += dseg;                        // d(A dt)_k
      dA += dtv[k] * run;
      r[0] = r[0] + r[1] + Ah * run;      // ddt_k
    }
    a.dA_part[ch.bhc] = dA;
  }
  __syncthreads();
  for (int i = tid; i < q; i += 256) a.ddt[ch.row(a, i)] = static_cast<float>(aux[4 * i]);
}

// ================================================================ pass 6
// dB and dC [B, S, G, ds] as the sums of `parts` fp32 partials in order:
// element (bs, g, k)'s part r at bs sbs + g sg + k + r sp (the fma
// route's per-head sums: sbs = H ds, sg = (H / G) ds, sp = ds; the wgmma
// route's head slices': sbs = G ds, sg = ds, sp = B S G ds)
template <typename T>
__global__ void bwd_reduce_parts(const Args a, int parts, long long sbs, long long sg,
                                 long long sp) {
  const long long n = static_cast<long long>(a.Bn) * a.S * a.G * a.ds;
  T* dB = static_cast<T*>(a.dB);
  T* dC = static_cast<T*>(a.dC);
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long bsg = e / a.ds;
    const long long base = (bsg / a.G) * sbs + (bsg % a.G) * sg + e % a.ds;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < parts; ++r) {
      sb += a.dBp[base + r * sp];
      sc += a.dCp[base + r * sp];
    }
    store(sb, dB + e);
    store(sc, dC + e);
  }
}

__global__ void bwd_reduce_dA(const Args a) {
  const int nc = a.S / a.q;
  for (int h = threadIdx.x; h < a.H; h += blockDim.x) {
    double s = 0.0;
    for (int b = 0; b < a.Bn; ++b)
      for (int c = 0; c < nc; ++c) s += a.dA_part[(static_cast<long long>(b) * a.H + h) * nc + c];
    a.dA[h] = static_cast<float>(s);
  }
}

// ================================================================ "fma"
// pass 1: seg, the chunk's state contribution into hst and its share of
// the state gradient into gst, one thread an element of [hd, ds]
template <typename T>
__global__ void __launch_bounds__(kFThreads) bwd_states_fma(const Args a) {
  extern __shared__ float fsm[];
  const Chunk ch(a, blockIdx.x, blockIdx.y, blockIdx.z);
  const int q = a.q, hd = a.hd, ds = a.ds, tid = threadIdx.x;
  float* wx = fsm;      // [q] dt, then exp(tot - seg) dt
  float* wy = wx + q;   // [q] seg, then exp(seg)
  const float* DT = ch.dt(a);
  for (int i = tid; i < q; i += kFThreads) wx[i] = DT[i * a.dt_ss];
  __syncthreads();
  if (tid < 32) chunk_cumsum(wx, a.A[ch.h], wy, q, tid);
  __syncthreads();
  const float tot = wy[q - 1];
  __syncthreads();
  for (int i = tid; i < q; i += kFThreads) {
    a.segs[ch.bhc * q + i] = wy[i];
    wx[i] = expf(tot - wy[i]) * wx[i];
    wy[i] = expf(wy[i]);
  }
  __syncthreads();
  const T* X = ch.x<T>(a);
  const T* Bp = ch.B<T>(a);
  const T* Cp = ch.C<T>(a);
  const T* Y = static_cast<const T*>(a.dy) + ch.row(a, 0) * hd;
  const long long y_ss = static_cast<long long>(a.H) * hd;
  float* hs = a.hst + ch.bhc * hd * ds;
  float* gs = a.gst + ch.bhc * hd * ds;
  for (int e = tid; e < hd * ds; e += kFThreads) {
    const int p = e / ds, n = e % ds;
    float s = 0.f, u = 0.f;
    for (int j = 0; j < q; ++j) {
      s += wx[j] * to_f32(X[j * a.x_ss + p]) * to_f32(Bp[j * a.b_ss + n]);
      u += wy[j] * to_f32(Y[j * y_ss + p]) * to_f32(Cp[j * a.c_ss + n]);
    }
    hs[e] = s;
    gs[e] = u;
  }
}

// rows r0.. (R of them, zeros past `valid`) of a [rows][cols] source with
// row stride ld into fp32 shared memory [R][cols]
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long ld, int cols,
                                           int valid, int tid) {
  for (int e = tid; e < kFRows * cols; e += kFThreads) {
    const int r = e / cols, k = e % cols;
    dst[e] = r < valid ? to_f32(src[r * ld + k]) : 0.f;
  }
}

// pass 3, "fma": one block per (key tile of 32 rows, chunk, head, batch row)
template <typename T>
__global__ void __launch_bounds__(kFThreads) bwd_keys_fma(const Args a) {
  extern __shared__ float fsm[];
  constexpr int R = kFRows;
  const int q = a.q, hd = a.hd, ds = a.ds, tid = threadIdx.x;
  const int nt = (q + R - 1) / R;
  const Chunk ch(a, blockIdx.x / nt, blockIdx.y, blockIdx.z);
  const int j0 = (blockIdx.x % nt) * R, nj = min(R, q - j0);
  double* cm = reinterpret_cast<double*>(fsm);  // [R] the column sums of M, fp64
  float* seg = fsm + 2 * R;     // [q]
  float* dtv = seg + q;         // [q]
  float* Bj = dtv + q;          // [R][ds]
  float* Ci = Bj + R * ds;      // [R][ds]
  float* ab = Ci + R * ds;      // [R][ds] dB accumulators
  float* Xj = ab + R * ds;      // [R][hd]
  float* Yi = Xj + R * hd;      // [R][hd] (then G_c B_j)
  float* ax = Yi + R * hd;      // [R][hd] dx accumulators
  float* Wt = ax + R * hd;      // [R][R]
  float* Vt = Wt + R * R;       // [R][R]
  float* Em = Vt + R * R;       // [R][R]
  float* Mt = Em + R * R;       // [R][R] M, computed as the query tiles compute it
  float* e1 = Mt + R * R;       // [R]
  float* e2 = e1 + R;           // [R]
  const float* DT = ch.dt(a);
  for (int i = tid; i < q; i += kFThreads) {
    seg[i] = a.segs[ch.bhc * q + i];
    dtv[i] = DT[i * a.dt_ss];
  }
  const T* Bp = ch.B<T>(a);
  const T* Cp = ch.C<T>(a);
  const T* X = ch.x<T>(a);
  const T* Y = static_cast<const T*>(a.dy) + ch.row(a, 0) * hd;
  const long long y_ss = static_cast<long long>(a.H) * hd;
  stage_rows(Bj, Bp + j0 * a.b_ss, a.b_ss, ds, nj, tid);
  stage_rows(Xj, X + j0 * a.x_ss, a.x_ss, hd, nj, tid);
  for (int e = tid; e < R * ds; e += kFThreads) ab[e] = 0.f;
  for (int e = tid; e < R * hd; e += kFThreads) ax[e] = 0.f;
  if (tid < R) {
    e1[tid] = 0.f;
    cm[tid] = 0.0;
  }
  for (int i0 = j0; i0 < q; i0 += R) {
    const int ni = min(R, q - i0);
    __syncthreads();  // the previous query tile is consumed
    stage_rows(Ci, Cp + i0 * a.c_ss, a.c_ss, ds, ni, tid);
    stage_rows(Yi, Y + i0 * y_ss, y_ss, hd, ni, tid);
    __syncthreads();
    for (int e = tid; e < R * R; e += kFThreads) {
      const int jj = e / R, ii = e % R, j = j0 + jj, i = i0 + ii;
      float w = 0.f, v = 0.f, m = 0.f, mm = 0.f;
      if (jj < nj && ii < ni && i >= j) {
        float cb = 0.f, dx = 0.f;
        for (int n = 0; n < ds; ++n) cb += Bj[jj * ds + n] * Ci[ii * ds + n];
        for (int p = 0; p < hd; ++p) dx += Xj[jj * hd + p] * Yi[ii * hd + p];
        const float dec = expf(seg[i] - seg[j]);
        w = cb * dec * dtv[j];
        v = dx * dec * dtv[j];
        m = cb * dec * dx;
        mm = w * dx;  // the query tiles' M: the same bits, so their sums cancel in fp64
      }
      Wt[e] = w;
      Vt[e] = v;
      Em[e] = m;
      Mt[e] = mm;
    }
    __syncthreads();
    for (int e = tid; e < R * hd; e += kFThreads) {
      const int jj = e / hd, p = e % hd;
      float s = 0.f;
      for (int ii = 0; ii < R; ++ii) s += Wt[jj * R + ii] * Yi[ii * hd + p];
      ax[e] += s;
    }
    for (int e = tid; e < R * ds; e += kFThreads) {
      const int jj = e / ds, n = e % ds;
      float s = 0.f;
      for (int ii = 0; ii < R; ++ii) s += Vt[jj * R + ii] * Ci[ii * ds + n];
      ab[e] += s;
    }
    if (tid < R) {
      float s = 0.f;
      double sm = 0.0;
      for (int ii = 0; ii < R; ++ii) {
        s += Em[tid * R + ii];
        sm += Mt[tid * R + ii];
      }
      e1[tid] += s;
      cm[tid] += sm;
    }
  }
  // the carried state's terms, G_c read from scratch
  __syncthreads();
  const float* Gc = a.gst + ch.bhc * hd * ds;
  const float tot = seg[q - 1];
  for (int e = tid; e < R * hd; e += kFThreads) {
    const int jj = e / hd, p = e % hd;
    float s = 0.f;
    for (int n = 0; n < ds; ++n) s += Gc[p * ds + n] * Bj[jj * ds + n];
    Yi[e] = s;  // (G_c B_j)[p]
  }
  __syncthreads();
  if (tid < R) {
    const int j = j0 + tid;
    float s = 0.f;
    for (int p = 0; p < hd; ++p) s += Xj[tid * hd + p] * Yi[tid * hd + p];
    e2[tid] = j < q ? expf(tot - seg[j]) * s : 0.f;
    if (tid < nj) {
      double* o = a.aux + (ch.bhc * q + j) * 4;
      o[0] = e1[tid];
      o[1] = e2[tid];
      o[3] = cm[tid];
    }
  }
  T* DX = static_cast<T*>(a.dx);
  for (int e = tid; e < nj * hd; e += kFThreads) {
    const int jj = e / hd, p = e % hd, j = j0 + jj;
    const float sc = dtv[j] * expf(tot - seg[j]);
    store(ax[e] + sc * Yi[e], DX + ch.row(a, j) * hd + p);
  }
  for (int e = tid; e < nj * ds; e += kFThreads) {
    const int jj = e / ds, n = e % ds, j = j0 + jj;
    float s = 0.f;
    for (int p = 0; p < hd; ++p) s += Xj[jj * hd + p] * Gc[p * ds + n];
    a.dBp[ch.row(a, j) * ds + n] = ab[e] + expf(tot - seg[j]) * dtv[j] * s;
  }
}

// pass 4, "fma": one block per (query tile of 32 rows, chunk, head, batch row)
template <typename T>
__global__ void __launch_bounds__(kFThreads) bwd_queries_fma(const Args a) {
  extern __shared__ float fsm[];
  constexpr int R = kFRows;
  const int q = a.q, hd = a.hd, ds = a.ds, tid = threadIdx.x;
  const int nt = (q + R - 1) / R;
  const Chunk ch(a, blockIdx.x / nt, blockIdx.y, blockIdx.z);
  const int i0 = (blockIdx.x % nt) * R, ni = min(R, q - i0);
  double* rm = reinterpret_cast<double*>(fsm);  // [R] the row sums of M, fp64
  float* seg = fsm + 2 * R;     // [q]
  float* dtv = seg + q;         // [q]
  float* Ci = dtv + q;          // [R][ds]
  float* Bj = Ci + R * ds;      // [R][ds] (then h_c^T dy_i)
  float* ac = Bj + R * ds;      // [R][ds] dC accumulators
  float* Yi = ac + R * ds;      // [R][hd]
  float* Xj = Yi + R * hd;      // [R][hd]
  float* Vm = Xj + R * hd;      // [R][R]
  float* Mm = Vm + R * R;       // [R][R]
  const float* DT = ch.dt(a);
  for (int i = tid; i < q; i += kFThreads) {
    seg[i] = a.segs[ch.bhc * q + i];
    dtv[i] = DT[i * a.dt_ss];
  }
  const T* Bp = ch.B<T>(a);
  const T* Cp = ch.C<T>(a);
  const T* X = ch.x<T>(a);
  const T* Y = static_cast<const T*>(a.dy) + ch.row(a, 0) * hd;
  const long long y_ss = static_cast<long long>(a.H) * hd;
  stage_rows(Ci, Cp + i0 * a.c_ss, a.c_ss, ds, ni, tid);
  stage_rows(Yi, Y + i0 * y_ss, y_ss, hd, ni, tid);
  for (int e = tid; e < R * ds; e += kFThreads) ac[e] = 0.f;
  if (tid < R) rm[tid] = 0.0;
  for (int j0 = 0; j0 <= i0; j0 += R) {
    const int nj = min(R, q - j0);
    __syncthreads();
    stage_rows(Bj, Bp + j0 * a.b_ss, a.b_ss, ds, nj, tid);
    stage_rows(Xj, X + j0 * a.x_ss, a.x_ss, hd, nj, tid);
    __syncthreads();
    for (int e = tid; e < R * R; e += kFThreads) {
      const int ii = e / R, jj = e % R, i = i0 + ii, j = j0 + jj;
      float v = 0.f, m = 0.f;
      if (ii < ni && jj < nj && j <= i) {
        float cb = 0.f, dx = 0.f;
        for (int n = 0; n < ds; ++n) cb += Ci[ii * ds + n] * Bj[jj * ds + n];
        for (int p = 0; p < hd; ++p) dx += Yi[ii * hd + p] * Xj[jj * hd + p];
        const float dec = expf(seg[i] - seg[j]);
        v = dx * dec * dtv[j];
        m = cb * dec * dtv[j] * dx;
      }
      Vm[e] = v;
      Mm[e] = m;
    }
    __syncthreads();
    for (int e = tid; e < R * ds; e += kFThreads) {
      const int ii = e / ds, n = e % ds;
      float s = 0.f;
      for (int jj = 0; jj < R; ++jj) s += Vm[ii * R + jj] * Bj[jj * ds + n];
      ac[e] += s;
    }
    if (tid < R) {
      double s = 0.0;
      for (int jj = 0; jj < R; ++jj) s += Mm[tid * R + jj];
      rm[tid] += s;
    }
  }
  __syncthreads();
  const float* Hc = a.hst + ch.bhc * hd * ds;
  for (int e = tid; e < ni * ds; e += kFThreads) {
    const int ii = e / ds, n = e % ds, i = i0 + ii;
    float s = 0.f;
    for (int p = 0; p < hd; ++p) s += Hc[p * ds + n] * Yi[ii * hd + p];
    Bj[e] = s;  // (h_c^T dy_i)[n]
    a.dCp[ch.row(a, i) * ds + n] = ac[e] + expf(seg[i]) * s;
  }
  __syncthreads();
  if (tid < ni) {
    const int i = i0 + tid;
    float s = 0.f;
    for (int n = 0; n < ds; ++n) s += Ci[tid * ds + n] * Bj[tid * ds + n];
    a.aux[(ch.bhc * q + i) * 4 + 2] = rm[tid] + static_cast<double>(expf(seg[i]) * s);
  }
}

// ================================================================ "wgmma"
// The C B^T kernel's helpers (mma.sync, as ssd_scan.cu's ssd_cb): n rows
// of `cols` bf16 (row stride ld, 16-byte aligned) into shared memory at
// pitch cols + 8 with cp.async, zeros at or past `valid`
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int n,
                                          int cols, int valid, int tid) {
  const int pieces = cols / 8;
  for (int e = tid; e < n * pieces; e += kMmaThreads) {
    const int r = e / pieces, pc = e % pieces;
    const bool ok = r < valid;
    sm90::cp_async16(dst + r * (cols + 8) + 8 * pc, src + (ok ? r : 0) * ld + 8 * pc, ok ? 16 : 0);
  }
}
__device__ __forceinline__ void wait_rows() {
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
}

// acc[2 NG][4] += A . B^T for a warp's 16 rows r0..: A [rows][K] and B
// [n rows][K] both K-major in shared memory (pitches ap, bp); the output's
// 16-column groups g < ng of B's rows 16 g..
template <int NG>
__device__ __forceinline__ void mma_nt(float (&acc)[2 * NG][4], const bf16* As, int ap, int r0,
                                       const bf16* Bs, int bp, int K, int ng, int lane) {
  const int mi = lane / 8;
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    sm90::ldmatrix_x4(af, As + (r0 + 8 * (mi % 2) + lane % 8) * ap + 16 * kk + 8 * (mi / 2));
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (g < ng) {
        uint32_t bfr[4];
        sm90::ldmatrix_x4(bfr, Bs + (16 * g + 8 * (mi / 2) + lane % 8) * bp + 16 * kk + 8 * (mi % 2));
        sm90::mma_bf16_16816(acc[2 * g], af, bfr[0], bfr[1]);
        sm90::mma_bf16_16816(acc[2 * g + 1], af, bfr[2], bfr[3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

constexpr int kWT = 64;                  // rows of a tile and of the consumer warpgroup
constexpr int kWStages = 3;              // ring tiles in flight
constexpr int kWThreads = 160;           // a consumer warpgroup and a producer warp
constexpr int kTileBytes = kWT * 128;    // a [64][64] bf16 tile: 128-byte rows
constexpr int kCbFloats = kWT * kWT;     // a C B^T tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the key and query kernels (bytes from a 1024-aligned
// base; every tile 1024-aligned for the 128-byte swizzle): the block's own
// 64 rows of B (keys) or C (queries), the other side's tiles (C or B,
// [q / 64][ds / 64][64][64]), their C B^T tiles (fp32, fragment order),
// two head stages (x_j and G_c, or dy_i and h_c), the ring (dy_i or x_j
// tiles), the head stages' seg and dt, and the mbarriers.
struct TileSmem {
  int own, others, cbt, heads, ring, vecs, bars, total;
};
__host__ __device__ inline TileSmem tile_smem(int ds, int q) {
  const int nqt = q / kWT, tile = ds * 128;
  TileSmem m;
  m.own = 0;
  m.others = m.own + tile;
  m.cbt = m.others + nqt * tile;
  m.heads = m.cbt + nqt * kCbFloats * 4;
  m.ring = m.heads + 2 * (kTileBytes + tile);
  m.vecs = m.ring + kWStages * kTileBytes;
  m.bars = m.vecs + 2 * 2 * q * 4;
  m.total = 1024 + m.bars + (1 + 2 * 2 + 2 * kWStages) * 8;
  return m;
}

// the C B^T kernel's: a C and a B tile (padded rows) and a fp32 tile
__host__ __device__ inline int cb_smem(int ds) {
  return 2 * 2 * kRows * (ds + 8) + 4 * kRows * (kRows + 1);
}

__device__ __forceinline__ uint8_t* align1024(unsigned char* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// 2^x on the special-function unit (ex2.approx: relative error ~2^-22;
// 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of element (r, c) (c < 64) of a [rows][64] bf16 tile in the
// 128-byte swizzle: the 16-byte chunk c / 8 of row r sits at chunk
// (c / 8) ^ (r % 8) (sm90.cuh)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// the bf16 pair (r, c), (r, c + 1) (c even) of a swizzled 64-row tile
// ([c / 64 halves][64][64])
__device__ __forceinline__ float2 pair(const uint8_t* t, int r, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(t + (c >> 6) * kTileBytes + swz(r, c & 63)));
}

// a barrier of the consumer warpgroup alone (the producer warp has left)
__device__ __forceinline__ void named_barrier_consumers() { sm90::named_barrier(1, 128); }

template <int R>
__device__ __forceinline__ void zero1(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

template <int N, int TB, int TA>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    sm90::wgmma_ss_n64<TB, TA>(d, da, db, scale_d);
  } else {
    sm90::wgmma_ss_n128<TB, TA>(d, da, db, scale_d);
  }
}

// acc = A . B^T over K for two 64-row operands in shared memory, both
// K-major ([K / 64 halves][64 rows][64])
template <int K>
__device__ __forceinline__ void scores(float (&acc)[32], const uint8_t* sa, const uint8_t* sb) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int off = (kk / 4) * kTileBytes + (kk % 4) * 32;  // the half, then k16 inside it
    sm90::wgmma_ss_n64<0>(acc, sm90::desc(sa + off, 16, sm90::kAtomBytes),
                          sm90::desc(sb + off, 16, sm90::kAtomBytes), kk > 0);
  }
}

// acc += A . B: A in registers (4 k16 steps over the 64 rows of a tile),
// B a 64-row tile read MN-major ([N / 64 halves][64 rows][64])
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2], const uint32_t (&a)[4][4],
                                           const uint8_t* sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sm90::desc(sb + kk * 16 * 128, kTileBytes, sm90::kAtomBytes);
    if constexpr (N == 64) {
      sm90::wgmma_rs_n64<1>(acc, a[kk], db, 1);
    } else {
      sm90::wgmma_rs_n128<1>(acc, a[kk], db, 1);
    }
  }
}

template <int R>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) sm90::fence_regs(f[i]);
}

// the scaled rows of a warpgroup's 64 x 64 bf16 tile as the A operand of
// 4 k16 steps: rows r0 (times sa) and r0 + 8 (times sb), the thread's
// columns (sm90.cuh's register map)
__device__ __forceinline__ void scaled_frags(uint32_t (&f)[4][4], const uint8_t* t, int r0, int c2,
                                             float sa, float sb) {
#pragma unroll
  for (int grp = 0; grp < 8; ++grp) {
    const float2 u = pair(t, r0, 8 * grp + c2), v = pair(t, r0 + 8, 8 * grp + c2);
    f[grp / 2][2 * (grp % 2)] = sm90::pack_bf16(u.x * sa, u.y * sa);
    f[grp / 2][2 * (grp % 2) + 1] = sm90::pack_bf16(v.x * sb, v.y * sb);
  }
}

// the rows (r0, r0 + 8) of a warpgroup's accumulator [64 x N] at row_a and
// row_b: fp32 pairs, or bf16 pairs
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], float* row_a, float* row_b,
                                           int c2) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 4) {
    const int col = 8 * (i / 4) + c2;
    *reinterpret_cast<float2*>(row_a + col) = make_float2(acc[i], acc[i + 1]);
    *reinterpret_cast<float2*>(row_b + col) = make_float2(acc[i + 2], acc[i + 3]);
  }
}
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2], bf16* row_a, bf16* row_b,
                                           int c2) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 4) {
    const int col = 8 * (i / 4) + c2;
    *reinterpret_cast<uint32_t*>(row_a + col) = sm90::pack_bf16(acc[i], acc[i + 1]);
    *reinterpret_cast<uint32_t*>(row_b + col) = sm90::pack_bf16(acc[i + 2], acc[i + 3]);
  }
}

// the rows of a [rows][64] swizzled bf16 tile times w[row], in place (a
// row's chunks stay in the row: the swizzle does not matter)
__device__ __forceinline__ void scale_tile(uint8_t* t, const float* w, int rows, int tid) {
  for (int k = tid; k < rows * 8; k += 128) {
    uint4* p = reinterpret_cast<uint4*>(t + 16 * k);
    const uint4 v = *p;
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float wr = w[k / 8];
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(in[u]);
      op[u] = sm90::pack_bf16(f.x * wr, f.y * wr);
    }
    *p = o;
  }
}

// C B^T tile (query tile ti, key tile tj) of a (batch row, group, chunk)
// in one of the two fragment orders: 0 = the query kernel's (rows i,
// columns j), 1 = the key kernel's (rows j, columns i)
__device__ __forceinline__ long long cb_tile(long long bgc, int nqt, int order, int ti, int tj) {
  return (((bgc * 2 + order) * nqt + ti) * nqt + tj) * static_cast<long long>(kCbFloats);
}

// "wgmma" 3, C B^T: one block per (query tile, chunk, group, batch row):
// the tile's C rows against the key tiles up to it, C B^T in fp32 on
// mma.sync (as ssd_scan.cu's ssd_cb), written in both fragment orders:
// float e of the tile's thread t (sm90.cuh's accumulator map) at [e / 4]
// [t][e % 4], so that a consumer thread reads its 32 values as 8 float4s
// with no bank conflict.
__global__ void __launch_bounds__(kMmaThreads) bwd_cb(const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int q = a.q, ds = a.ds, BP = ds + 8, nqt = q / kWT, nc = a.S / q;
  const int ti = blockIdx.x % nqt, c = blockIdx.x / nqt, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane / 4, tq = lane % 4;
  bf16* Cs = reinterpret_cast<bf16*>(dsm);  // [64][ds + 8]
  bf16* Bs = Cs + kRows * BP;               // [64][ds + 8]
  float* T = reinterpret_cast<float*>(Bs + kRows * BP);  // [64][65]: C_i . B_j
  const long long c0 = static_cast<long long>(c) * q;
  const bf16* Bp = static_cast<const bf16*>(a.Bm) + b * a.b_sb + g * a.b_sg + c0 * a.b_ss;
  const bf16* Cp = static_cast<const bf16*>(a.Cm) + b * a.c_sb + g * a.c_sg + c0 * a.c_ss;
  const long long bgc = (static_cast<long long>(b) * a.G + g) * nc + c;
  load_rows(Cs, Cp + ti * kWT * a.c_ss, a.c_ss, kRows, ds, kRows, tid);
  for (int tj = 0; tj <= ti; ++tj) {
    __syncthreads();  // the previous tile is written out
    load_rows(Bs, Bp + tj * kWT * a.b_ss, a.b_ss, kRows, ds, kRows, tid);
    wait_rows();
    float sc[8][4];
    zero(sc);
    mma_nt<4>(sc, Cs, BP, 16 * w, Bs, BP, ds, 4, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* ra = T + (16 * w + gq) * (kRows + 1) + 8 * nt + 2 * tq;
      float* rb = ra + 8 * (kRows + 1);
      ra[0] = sc[nt][0];
      ra[1] = sc[nt][1];
      rb[0] = sc[nt][2];
      rb[1] = sc[nt][3];
    }
    __syncthreads();
    float* oq = a.cb + cb_tile(bgc, nqt, 0, ti, tj);
    float* ok = a.cb + cb_tile(bgc, nqt, 1, ti, tj);
    for (int slot = tid; slot < kCbFloats; slot += kMmaThreads) {
      const int grp = slot / 512, thr = (slot / 4) % 128, u = slot % 4;
      const int r = 16 * (thr / 32) + (thr % 32) / 4 + 8 * (u / 2);
      const int col = 8 * grp + 2 * (thr % 4) + u % 2;
      oq[slot] = T[r * (kRows + 1) + col];
      ok[slot] = T[col * (kRows + 1) + r];
    }
  }
}

// "wgmma" 1, seg: cumsum(A dt) of every (batch row, head, chunk),
// one warp each, into segs, with the chunk's dt copied contiguous into
// dts (the scan's and the tile kernels' producers load both with bulk
// copies)
__global__ void __launch_bounds__(128) bwd_seg(const Args a) {
  extern __shared__ float ssm[];
  const int q = a.q, nc = a.S / q, w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long bhc = static_cast<long long>(blockIdx.x) * 4 + w;
  if (bhc >= static_cast<long long>(a.Bn) * a.H * nc) return;
  const int c = static_cast<int>(bhc % nc), h = static_cast<int>((bhc / nc) % a.H);
  const int b = static_cast<int>(bhc / (static_cast<long long>(nc) * a.H));
  float* dtv = ssm + w * 2 * q;
  float* seg = dtv + q;
  const float* DT = a.dt + b * a.dt_sb + h * a.dt_sh + static_cast<long long>(c) * q * a.dt_ss;
  for (int i = lane; i < q; i += 32) dtv[i] = DT[i * a.dt_ss];
  __syncwarp();
  chunk_cumsum(dtv, a.A[h], seg, q, lane);
  __syncwarp();
  for (int i = lane; i < q; i += 32) {
    a.segs[bhc * q + i] = seg[i];
    a.dts[bhc * q + i] = dtv[i];
  }
}

// Shared memory of the scan: two stages of a chunk's x (or dy) rows
// ([q][64]), its B (or C) rows ([ds / 64][q][64]) and its seg and dt (a
// stage also stages the new state, [64][ds + 8] fp32, once consumed), the
// row weights, four warps' fp64 sums, the mbarriers.
struct ScanSmem {
  int stage, tile, rows, vecs, w, red, bars, total;
};
__host__ __device__ inline ScanSmem scan_smem(int ds, int q) {
  ScanSmem m;
  m.tile = 0;
  m.rows = q * 128;
  m.vecs = m.rows + q * ds * 2;
  m.stage = m.vecs + 8 * q;
  const int staged = kWT * (ds + 8) * 4;
  m.stage = ((m.stage > staged ? m.stage : staged) + 1023) / 1024 * 1024;
  m.w = 2 * m.stage;
  m.red = m.w + 4 * q;
  m.bars = m.red + 4 * 8;
  m.total = 1024 + m.bars + 4 * 8;
  return m;
}

// "wgmma" 2, the scan: the chunk states and the state gradients, one block
// per (head, batch row), walking the chunks forward (h_c) and then in
// reverse (G_c) with the state in a warpgroup's wgmma accumulator [64 x
// ds] (fp32).  At each chunk the state is scaled by exp(tot) and the
// chunk's own term added by wgmma: forward (exp(tot - seg_j) dt_j x_j)^T
// B_j, reverse (exp(seg_i) dy_i)^T C_i, the rows scaled in shared memory
// in place, A = x^T (or dy^T) read MN-major, B (or C) MN-major.  The new
// state is staged through the consumed stage and written with 16-byte
// stores: h_c in fp32 (read back by the reverse sweep) and bf16, G_c in
// bf16 (the tile kernels' operands), and sum(G_c * h_c) in fp64 (the
// finalize's) from the accumulator and h_c.  The producer warp streams
// each chunk's rows and seg, dt through a ring of two stages (TMA boxes of
// the chunk's q rows, bulk copies).  The chunk contributions never leave
// the chip.
template <int DS>
__global__ void __launch_bounds__(kWThreads, 1)
    bwd_scan_wgmma(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap cmap, const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  uint8_t* base = align1024(dsm);
  const int q = a.q, nc = a.S / q, steps = 2 * (nc - 1);
  const ScanSmem L = scan_smem(DS, q);
  const int bh = blockIdx.x, h = bh % a.H, b = bh / a.H, g = h / (a.H / a.G);
  const long long bh0 = static_cast<long long>(bh) * nc;  // the head's first chunk
  float* wts = reinterpret_cast<float*>(base + L.w);
  double* red = reinterpret_cast<double*>(base + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + 2;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // step k < nc - 1: forward over chunk k; then reverse over chunk
  // nc - 1 - (k - (nc - 1)) (the states past the last chunk and before
  // the first are not needed)
  if (tid >= 128) {  // the producer warp: its lane 0 starts every load
    if (tid == 128) {
      for (int k = 0; k < steps; ++k) {
        const bool rev = k >= nc - 1;
        const int s = k % 2, c = rev ? 2 * (nc - 1) - k : k;
        if (k >= 2) sm90::mbar_wait(&empty[s], (k / 2 + 1) & 1);
        uint8_t* st = base + s * L.stage;
        sm90::mbar_expect_tx(&full[s], q * 128 + q * DS * 2 + 8 * q);
        sm90::tma_load_4d(st + L.tile, rev ? &ymap : &xmap, &full[s], 0, c * q, h, b);
        for (int hf = 0; hf < DS / 64; ++hf)
          sm90::tma_load_4d(st + L.rows + hf * q * 128, rev ? &cmap : &bmap, &full[s], 64 * hf,
                            c * q, g, b);
        float* v = reinterpret_cast<float*>(st + L.vecs);
        sm90::bulk_load(v, a.segs + (bh0 + c) * q, 4 * q, &full[s]);
        sm90::bulk_load(v + q, a.dts + (bh0 + c) * q, 4 * q, &full[s]);
      }
    }
    return;
  }

  const int lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  // h_0 = 0 (fp32 and bf16), G_{nc-1} = 0 (bf16) and its sum 0
  {
    float* h32 = a.hst + bh0 * kWT * DS;
    bf16* h16 = a.hb + bh0 * kWT * DS;
    bf16* g16 = a.gb + (bh0 + nc - 1) * kWT * DS;
    for (int e = tid; e < kWT * DS / 8; e += 128) {
      reinterpret_cast<float4*>(h32)[2 * e] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(h32)[2 * e + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<uint4*>(h16)[e] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(g16)[e] = make_uint4(0, 0, 0, 0);
    }
    if (tid == 0) a.gh[bh0 + nc - 1] = 0.0;
  }
  float acc[DS / 2];
  zero1(acc);
  for (int k = 0; k < steps; ++k) {
    const bool rev = k >= nc - 1;
    const int s = k % 2, c = rev ? 2 * (nc - 1) - k : k;
    if (k == nc - 1) {
      zero1(acc);
      named_barrier_consumers();  // every h_c is written: the reverse sweep reads them
    }
    const long long o = (bh0 + (rev ? c - 1 : c + 1)) * kWT * DS;  // the new state's chunk
    float* h32 = a.hst + o;
    if (rev) {  // h_{c-1} (fp32, written long ago) into L2 while the chunk is scaled and multiplied
      for (int e = tid; e < kWT * DS / 32; e += 128)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(h32 + 32 * e));
    }
    uint8_t* st = base + s * L.stage;
    const float* seg = reinterpret_cast<const float*>(st + L.vecs);
    const float* dtv = seg + q;
    sm90::mbar_wait(&full[s], (k / 2) & 1);
    const float tot = seg[q - 1];
    for (int i = tid; i < q; i += 128)
      wts[i] = rev ? expf(seg[i]) : expf(tot - seg[i]) * dtv[i];
    named_barrier_consumers();
    scale_tile(st + L.tile, wts, q, tid);
    sm90::fence_proxy_async();
    named_barrier_consumers();
    const float et = expf(tot);
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) acc[i] *= et;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    for (int kk = 0; kk < q / 16; ++kk)
      mma_ss<DS, 1, 1>(acc, sm90::desc(st + L.tile + kk * 16 * 128, q * 128, sm90::kAtomBytes),
                       sm90::desc(st + L.rows + kk * 16 * 128, q * 128, sm90::kAtomBytes), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    // the state entering the next chunk (forward) or the gradient leaving
    // the previous one (reverse): staged through the consumed stage
    // ([64][ds + 8] fp32: no bank conflict), written 16 bytes a store
    float* stage = reinterpret_cast<float*>(st);
    store_rows<DS>(acc, stage + r0 * (DS + 8), stage + (r0 + 8) * (DS + 8), c2);
    named_barrier_consumers();
    bf16* b16 = (rev ? a.gb : a.hb) + o;
    double p = 0.0;  // reverse: sum(G_{c-1} * h_{c-1}), the thread's pieces in order
#pragma unroll 4
    for (int e = tid; e < kWT * DS / 8; e += 128) {
      const int row = e / (DS / 8), col = 8 * (e % (DS / 8));
      const float4 u = *reinterpret_cast<const float4*>(stage + row * (DS + 8) + col);
      const float4 v = *reinterpret_cast<const float4*>(stage + row * (DS + 8) + col + 4);
      float4* hp = reinterpret_cast<float4*>(h32 + row * DS + col);
      if (rev) {
        const float4 hu = hp[0], hv = hp[1];
        // a tree over the 8 products: a short dependent chain
        const double d0 = static_cast<double>(u.x) * hu.x + static_cast<double>(u.y) * hu.y;
        const double d1 = static_cast<double>(u.z) * hu.z + static_cast<double>(u.w) * hu.w;
        const double d2 = static_cast<double>(v.x) * hv.x + static_cast<double>(v.y) * hv.y;
        const double d3 = static_cast<double>(v.z) * hv.z + static_cast<double>(v.w) * hv.w;
        p += (d0 + d1) + (d2 + d3);
      } else {
        hp[0] = u;
        hp[1] = v;
      }
      *reinterpret_cast<uint4*>(b16 + row * DS + col) =
          make_uint4(sm90::pack_bf16(u.x, u.y), sm90::pack_bf16(u.z, u.w),
                     sm90::pack_bf16(v.x, v.y), sm90::pack_bf16(v.z, v.w));
    }
    sm90::fence_proxy_async();  // the stage's generic accesses before TMA's next
    sm90::mbar_arrive(&empty[s]);
    if (rev) {
      // the warp's and then the four warps' sums, in a fixed order
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) p += __shfl_xor_sync(kFull, p, off);
      if (lane == 0) red[warp] = p;
      named_barrier_consumers();
      if (tid == 0) a.gh[bh0 + c - 1] = ((red[0] + red[1]) + red[2]) + red[3];
    }
  }
}

// the block of a tile kernel: its tile (t, from the longest first), head
// slice, group, chunk and batch row
struct TileBlock {
  int t, n_sl, sl, g, c, b, h0, nh;
  __device__ TileBlock(const Args& a, bool keys) {
    const int nqt = a.q / kWT, nc = a.S / a.q, rep = a.H / a.G;
    const int per_tile = gridDim.x / nqt;
    n_sl = (rep + a.hs - 1) / a.hs;
    // keys: tile 0 sees every query tile; queries: the last sees every key tile
    t = keys ? blockIdx.x / per_tile : nqt - 1 - blockIdx.x / per_tile;
    int rem = blockIdx.x % per_tile;
    sl = rem % n_sl;
    rem /= n_sl;
    g = rem % a.G;
    rem /= a.G;
    c = rem % nc;
    b = rem / nc;
    h0 = g * rep + sl * a.hs;
    nh = min(a.hs, rep - sl * a.hs);
  }
};

// "wgmma" 4, keys: one block per (key tile of 64 rows, head slice, group,
// chunk, batch row).  B_j, the query tiles' C_i (i >= j) and their C B^T
// tiles stay in shared memory across the slice's heads; the producer warp
// loads each head's x_j, G_c (bf16), seg and dt into one of two head
// stages and its dy_i tiles through a ring of kWStages.  Per head and
// query tile: S^T = x_j dy_i^T (both K-major), then W^T = C B^T dec dt_j
// and V^T = S^T dec dt_j (dec = exp(seg_i - seg_j), masked before the
// exp), e1; dx += W^T dy_i and dB += V^T C_i with the weights as register
// A operands and dy_i, C_i read MN-major.  Per head: G_c B_j (K-major),
// e2, dx's carried term, dB += (exp(tot - seg_j) dt_j x_j) G_c (G_c
// MN-major); dx (bf16) and e1, e2, the column sums of M are written per
// head, dB summed over the slice's heads in registers.
template <int DS>
__global__ void __launch_bounds__(kWThreads, 1)
    bwd_keys_wgmma(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap ymap,
                   const __grid_constant__ CUtensorMap bmap,
                   const __grid_constant__ CUtensorMap cmap,
                   const __grid_constant__ CUtensorMap gmap, const Args a) {
  constexpr int T = DS * 128;  // a [ds / 64][64][64] tile
  extern __shared__ __align__(16) unsigned char dsm[];
  uint8_t* base = align1024(dsm);
  const int q = a.q, nqt = q / kWT, nc = a.S / q;
  const TileSmem L = tile_smem(DS, q);
  const TileBlock blk(a, true);
  const int t = blk.t, g = blk.g, c = blk.c, b = blk.b;
  const int nI = nqt - t, j0 = t * kWT, c0 = c * q;
  const long long bgc = (static_cast<long long>(b) * a.G + g) * nc + c;
  uint8_t* sB = base + L.own;
  uint8_t* sC = base + L.others;  // query tiles t.. ([nI][ds / 64][64][64])
  const float* sCB = reinterpret_cast<const float*>(base + L.cbt);
  uint8_t* ring = base + L.ring;
  float* vec = reinterpret_cast<float*>(base + L.vecs);
  uint64_t* own = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* hfull = own + 1;
  uint64_t* hempty = hfull + 2;
  uint64_t* full = hempty + 2;
  uint64_t* empty = full + kWStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(own, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&hfull[s], 1);
      sm90::mbar_init(&hempty[s], 128);
    }
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: its lane 0 starts every load
    if (tid == 128) {
      sm90::mbar_expect_tx(own, T + nI * (T + kCbFloats * 4));
      for (int hf = 0; hf < DS / 64; ++hf)
        sm90::tma_load_4d(sB + hf * kTileBytes, &bmap, own, 64 * hf, c0 + j0, g, b);
      for (int k = 0; k < nI; ++k) {
        for (int hf = 0; hf < DS / 64; ++hf)
          sm90::tma_load_4d(sC + k * T + hf * kTileBytes, &cmap, own, 64 * hf,
                            c0 + (t + k) * kWT, g, b);
        sm90::bulk_load(base + L.cbt + k * kCbFloats * 4, a.cb + cb_tile(bgc, nqt, 1, t + k, t),
                        kCbFloats * 4, own);
      }
      int it = 0;
      for (int k = 0; k < blk.nh; ++k) {
        const int h = blk.h0 + k, st = k % 2;
        if (k >= 2) sm90::mbar_wait(&hempty[st], (k / 2 + 1) & 1);
        uint8_t* hx = base + L.heads + st * (kTileBytes + T);
        float* hv = vec + st * 2 * q;
        const long long bhc = (static_cast<long long>(b) * a.H + h) * nc + c;
        sm90::mbar_expect_tx(&hfull[st], kTileBytes + T + 8 * q);
        sm90::tma_load_4d(hx, &xmap, &hfull[st], 0, c0 + j0, h, b);
        for (int hf = 0; hf < DS / 64; ++hf)
          sm90::tma_load_2d(hx + kTileBytes + hf * kTileBytes, &gmap, &hfull[st], 64 * hf,
                            static_cast<int>(bhc * kWT));
        sm90::bulk_load(hv, a.segs + bhc * q, 4 * q, &hfull[st]);
        sm90::bulk_load(hv + q, a.dts + bhc * q, 4 * q, &hfull[st]);
        for (int k2 = 0; k2 < nI; ++k2, ++it) {
          const int s = it % kWStages;
          if (it >= kWStages) sm90::mbar_wait(&empty[s], (it / kWStages + 1) & 1);
          sm90::mbar_expect_tx(&full[s], kTileBytes);
          sm90::tma_load_4d(ring + s * kTileBytes, &ymap, &full[s], 0, c0 + (t + k2) * kWT, h, b);
        }
      }
    }
    return;
  }

  const int lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int ja = j0 + r0, jb = ja + 8;  // the thread's key rows in the chunk
  float dB[DS / 2];
  zero1(dB);
  sm90::mbar_wait(own, 0);
  int it = 0;
  for (int k = 0; k < blk.nh; ++k) {
    const int h = blk.h0 + k, st = k % 2;
    sm90::mbar_wait(&hfull[st], (k / 2) & 1);
    const uint8_t* sX = base + L.heads + st * (kTileBytes + T);
    const uint8_t* sG = sX + kTileBytes;
    const float* seg = vec + st * 2 * q;
    const float* dtv = seg + q;
    const float sja = seg[ja], sjb = seg[jb];
    const float dta = dtv[ja], dtb = dtv[jb];
    float dx[32];
    zero1(dx);
    float e1a = 0.f, e1b = 0.f;
    for (int k2 = 0; k2 < nI; ++k2, ++it) {
      const int s = it % kWStages, ti = t + k2;
      const uint8_t* sY = ring + s * kTileBytes;
      sm90::mbar_wait(&full[s], (it / kWStages) & 1);
      float sc[32];
      zero1(sc);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      scores<64>(sc, sX, sY);  // x_j . dy_i: keys the rows, queries the columns
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      const float* cbt = sCB + k2 * kCbFloats;
      const bool diag = k2 == 0;
      uint32_t wa[4][4], va[4][4];
#pragma unroll
      for (int grp = 0; grp < 8; ++grp) {
        const float4 cb4 = *reinterpret_cast<const float4*>(cbt + grp * 512 + tid * 4);
        const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
        const int i = ti * kWT + 8 * grp + c2;  // columns i, i + 1
        const float2 si = *reinterpret_cast<const float2*>(seg + i);
        float wv[4], vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool lo = u < 2;  // row ja, else jb
          const int e = 4 * grp + u;
          const bool ok = !diag || i + (u & 1) >= (lo ? ja : jb);
          // seg_i - seg_j first: seg reaches -1e3 and beyond, where scaling
          // each by log2(e) first costs ~1e-4 of dec, which d(seg)'s
          // cancellations carry into dA
          const float dec = ok ? ex2(((u & 1 ? si.y : si.x) - (lo ? sja : sjb)) * kLog2e) : 0.f;
          const float cbd = cbv[u] * dec;
          if (lo) e1a += cbd * sc[e]; else e1b += cbd * sc[e];
          const float dtj = lo ? dta : dtb;
          wv[u] = cbd * dtj;
          vv[u] = sc[e] * dec * dtj;
        }
        wa[grp / 2][2 * (grp % 2)] = sm90::pack_bf16(wv[0], wv[1]);
        wa[grp / 2][2 * (grp % 2) + 1] = sm90::pack_bf16(wv[2], wv[3]);
        va[grp / 2][2 * (grp % 2)] = sm90::pack_bf16(vv[0], vv[1]);
        va[grp / 2][2 * (grp % 2) + 1] = sm90::pack_bf16(vv[2], vv[3]);
      }
      sm90::fence_regs(dx);
      sm90::fence_regs(dB);
      fence_frags(wa);
      fence_frags(va);
      sm90::wgmma_fence();
      accumulate<64>(dx, wa, sY);              // dx += W^T dy_i
      accumulate<DS>(dB, va, sC + k2 * T);     // dB += V^T C_i
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dx);
      sm90::fence_regs(dB);
      sm90::mbar_arrive(&empty[s]);
    }
    // the carried state's terms
    const float tot = seg[q - 1];
    const float eta = expf(tot - sja), etb = expf(tot - sjb);
    const float sa = eta * dta, sb = etb * dtb;
    float gb[32];
    zero1(gb);
    sm90::fence_regs(gb);
    sm90::wgmma_fence();
    scores<DS>(gb, sB, sG);  // (G_c B_j)[p]
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(gb);
    float xa = 0.f, xb = 0.f;
#pragma unroll
    for (int grp = 0; grp < 8; ++grp) {
      const float2 u = pair(sX, r0, 8 * grp + c2), v = pair(sX, r0 + 8, 8 * grp + c2);
      xa += u.x * gb[4 * grp] + u.y * gb[4 * grp + 1];
      xb += v.x * gb[4 * grp + 2] + v.y * gb[4 * grp + 3];
      dx[4 * grp] += sa * gb[4 * grp];
      dx[4 * grp + 1] += sa * gb[4 * grp + 1];
      dx[4 * grp + 2] += sb * gb[4 * grp + 2];
      dx[4 * grp + 3] += sb * gb[4 * grp + 3];
    }
    uint32_t xf[4][4];
    scaled_frags(xf, sX, r0, c2, sa, sb);
    sm90::fence_regs(dB);
    fence_frags(xf);
    sm90::wgmma_fence();
    accumulate<DS>(dB, xf, sG);  // dB += (exp(tot - seg_j) dt_j x_j) G_c
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dB);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      xa += __shfl_xor_sync(kFull, xa, off);
      xb += __shfl_xor_sync(kFull, xb, off);
      e1a += __shfl_xor_sync(kFull, e1a, off);
      e1b += __shfl_xor_sync(kFull, e1b, off);
    }
    // dx staged through the consumed x tile (bf16 pairs at their swizzled
    // places: no bank conflict), then written a 16-byte piece a thread
    named_barrier_consumers();  // every thread's reads of sX are done
    uint8_t* sDX = base + L.heads + st * (kTileBytes + T);
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int p = 8 * (i / 4) + c2;
      *reinterpret_cast<uint32_t*>(sDX + swz(r0, p)) = sm90::pack_bf16(dx[i], dx[i + 1]);
      *reinterpret_cast<uint32_t*>(sDX + swz(r0 + 8, p)) = sm90::pack_bf16(dx[i + 2], dx[i + 3]);
    }
    named_barrier_consumers();
    bf16* DX = static_cast<bf16*>(a.dx);
    for (int e = tid; e < kWT * 8; e += 128) {
      const int row = e / 8, p = 8 * (e % 8);
      const long long o = ((static_cast<long long>(b) * a.S + c0 + j0 + row) * a.H + h) * kWT + p;
      *reinterpret_cast<uint4*>(DX + o) = *reinterpret_cast<const uint4*>(sDX + swz(row, p));
    }
    sm90::fence_proxy_async();  // the stage's generic accesses before TMA's next
    sm90::mbar_arrive(&hempty[st]);
    if (lane % 4 == 0) {
      const long long bhc = (static_cast<long long>(b) * a.H + h) * nc + c;
      double* oa = a.aux + (bhc * q + ja) * 4;
      double* ob = a.aux + (bhc * q + jb) * 4;
      oa[0] = e1a;
      oa[1] = eta * xa;
      oa[3] = static_cast<double>(dta) * e1a;
      ob[0] = e1b;
      ob[1] = etb * xb;
      ob[3] = static_cast<double>(dtb) * e1b;
    }
  }
  // the slice's sum of dB over its heads
  const long long ra = (static_cast<long long>(b) * a.S + c0 + ja) * a.G + g;
  const long long rb = ra + 8LL * a.G;
  if (blk.n_sl == 1) {
    bf16* out = static_cast<bf16*>(a.dB);
    store_rows<DS>(dB, out + ra * DS, out + rb * DS, c2);
  } else {
    float* out = a.dBp + static_cast<long long>(blk.sl) * a.Bn * a.S * a.G * DS;
    store_rows<DS>(dB, out + ra * DS, out + rb * DS, c2);
  }
}

// "wgmma" 5, queries: one block per (query tile of 64 rows, head slice,
// group, chunk, batch row).  C_i, the key tiles' B_j (j <= i) and their
// C B^T tiles stay in shared memory across the slice's heads; the
// producer warp loads each head's dy_i, h_c (bf16), seg and dt into one
// of two head stages and its x_j tiles through a ring.  Per head and key
// tile: S = dy_i x_j^T, V = S dec dt_j, the row sums of M = C B^T V; dC
// += V B_j (V a register A operand, B_j MN-major).  Per head: the carried
// term exp(seg_i) h_c^T dy_i (the scaled dy_i a register A operand, h_c
// MN-major), added to dC and dotted with C_i for d(seg); r is written per
// head, dC summed over the slice's heads in registers.
template <int DS>
__global__ void __launch_bounds__(kWThreads, 1)
    bwd_queries_wgmma(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap ymap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ CUtensorMap cmap,
                      const __grid_constant__ CUtensorMap hmap, const Args a) {
  constexpr int T = DS * 128;
  extern __shared__ __align__(16) unsigned char dsm[];
  uint8_t* base = align1024(dsm);
  const int q = a.q, nqt = q / kWT, nc = a.S / q;
  const TileSmem L = tile_smem(DS, q);
  const TileBlock blk(a, false);
  const int t = blk.t, g = blk.g, c = blk.c, b = blk.b;
  const int nJ = t + 1, i0 = t * kWT, c0 = c * q;
  const long long bgc = (static_cast<long long>(b) * a.G + g) * nc + c;
  uint8_t* sC = base + L.own;
  uint8_t* sB = base + L.others;  // key tiles 0..t ([nJ][ds / 64][64][64])
  const float* sCB = reinterpret_cast<const float*>(base + L.cbt);
  uint8_t* ring = base + L.ring;
  float* vec = reinterpret_cast<float*>(base + L.vecs);
  uint64_t* own = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* hfull = own + 1;
  uint64_t* hempty = hfull + 2;
  uint64_t* full = hempty + 2;
  uint64_t* empty = full + kWStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(own, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&hfull[s], 1);
      sm90::mbar_init(&hempty[s], 128);
    }
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: its lane 0 starts every load
    if (tid == 128) {
      sm90::mbar_expect_tx(own, T + nJ * (T + kCbFloats * 4));
      for (int hf = 0; hf < DS / 64; ++hf)
        sm90::tma_load_4d(sC + hf * kTileBytes, &cmap, own, 64 * hf, c0 + i0, g, b);
      for (int k = 0; k < nJ; ++k) {
        for (int hf = 0; hf < DS / 64; ++hf)
          sm90::tma_load_4d(sB + k * T + hf * kTileBytes, &bmap, own, 64 * hf, c0 + k * kWT, g, b);
        sm90::bulk_load(base + L.cbt + k * kCbFloats * 4, a.cb + cb_tile(bgc, nqt, 0, t, k),
                        kCbFloats * 4, own);
      }
      int it = 0;
      for (int k = 0; k < blk.nh; ++k) {
        const int h = blk.h0 + k, st = k % 2;
        if (k >= 2) sm90::mbar_wait(&hempty[st], (k / 2 + 1) & 1);
        uint8_t* hy = base + L.heads + st * (kTileBytes + T);
        float* hv = vec + st * 2 * q;
        const long long bhc = (static_cast<long long>(b) * a.H + h) * nc + c;
        sm90::mbar_expect_tx(&hfull[st], kTileBytes + T + 8 * q);
        sm90::tma_load_4d(hy, &ymap, &hfull[st], 0, c0 + i0, h, b);
        for (int hf = 0; hf < DS / 64; ++hf)
          sm90::tma_load_2d(hy + kTileBytes + hf * kTileBytes, &hmap, &hfull[st], 64 * hf,
                            static_cast<int>(bhc * kWT));
        sm90::bulk_load(hv, a.segs + bhc * q, 4 * q, &hfull[st]);
        sm90::bulk_load(hv + q, a.dts + bhc * q, 4 * q, &hfull[st]);
        for (int k2 = 0; k2 < nJ; ++k2, ++it) {
          const int s = it % kWStages;
          if (it >= kWStages) sm90::mbar_wait(&empty[s], (it / kWStages + 1) & 1);
          sm90::mbar_expect_tx(&full[s], kTileBytes);
          sm90::tma_load_4d(ring + s * kTileBytes, &xmap, &full[s], 0, c0 + k2 * kWT, h, b);
        }
      }
    }
    return;
  }

  const int lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int ia = i0 + r0, ib = ia + 8;  // the thread's query rows in the chunk
  float dC[DS / 2];
  zero1(dC);
  sm90::mbar_wait(own, 0);
  int it = 0;
  for (int k = 0; k < blk.nh; ++k) {
    const int h = blk.h0 + k, st = k % 2;
    sm90::mbar_wait(&hfull[st], (k / 2) & 1);
    const uint8_t* sY = base + L.heads + st * (kTileBytes + T);
    const uint8_t* sH = sY + kTileBytes;
    const float* seg = vec + st * 2 * q;
    const float* dtv = seg + q;
    const float sia = seg[ia], sib = seg[ib];
    float rma = 0.f, rmb = 0.f;
    for (int k2 = 0; k2 < nJ; ++k2, ++it) {
      const int s = it % kWStages;
      const uint8_t* sX = ring + s * kTileBytes;
      sm90::mbar_wait(&full[s], (it / kWStages) & 1);
      float sc[32];
      zero1(sc);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      scores<64>(sc, sY, sX);  // dy_i . x_j: queries the rows, keys the columns
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      const float* cbt = sCB + k2 * kCbFloats;
      const bool diag = k2 == t;
      uint32_t va[4][4];
#pragma unroll
      for (int grp = 0; grp < 8; ++grp) {
        const float4 cb4 = *reinterpret_cast<const float4*>(cbt + grp * 512 + tid * 4);
        const float cbv[4] = {cb4.x, cb4.y, cb4.z, cb4.w};
        const int j = k2 * kWT + 8 * grp + c2;  // columns j, j + 1
        const float2 sj = *reinterpret_cast<const float2*>(seg + j);
        const float2 dj = *reinterpret_cast<const float2*>(dtv + j);
        float vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool lo = u < 2;  // row ia, else ib
          const int e = 4 * grp + u;
          const bool ok = !diag || j + (u & 1) <= (lo ? ia : ib);
          const float dec = ok ? ex2(((lo ? sia : sib) - (u & 1 ? sj.y : sj.x)) * kLog2e) : 0.f;
          const float v = sc[e] * dec * (u & 1 ? dj.y : dj.x);
          if (lo) rma += cbv[u] * v; else rmb += cbv[u] * v;
          vv[u] = v;
        }
        va[grp / 2][2 * (grp % 2)] = sm90::pack_bf16(vv[0], vv[1]);
        va[grp / 2][2 * (grp % 2) + 1] = sm90::pack_bf16(vv[2], vv[3]);
      }
      sm90::fence_regs(dC);
      fence_frags(va);
      sm90::wgmma_fence();
      accumulate<DS>(dC, va, sB + k2 * T);  // dC += V B_j
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dC);
      sm90::mbar_arrive(&empty[s]);
    }
    // dC's carried term exp(seg_i) h_c^T dy_i, and d(seg)'s, its dot with
    // C_i: the product from dy_i as it is (exact in bf16), scaled after
    const float esa = expf(sia), esb = expf(sib);
    uint32_t yf[4][4];
    scaled_frags(yf, sY, r0, c2, 1.f, 1.f);
    float hy[DS / 2];
    zero1(hy);
    sm90::fence_regs(hy);
    fence_frags(yf);
    sm90::wgmma_fence();
    accumulate<DS>(hy, yf, sH);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(hy);
    sm90::mbar_arrive(&hempty[st]);  // sY, sH, seg and dt are read
    float na = 0.f, nb = 0.f;
#pragma unroll
    for (int i = 0; i < DS / 2; i += 4) {
      const int n = 8 * (i / 4) + c2;
      const float2 u = pair(sC, r0, n), v = pair(sC, r0 + 8, n);
      na += u.x * hy[i] + u.y * hy[i + 1];
      nb += v.x * hy[i + 2] + v.y * hy[i + 3];
      dC[i] += esa * hy[i];
      dC[i + 1] += esa * hy[i + 1];
      dC[i + 2] += esb * hy[i + 2];
      dC[i + 3] += esb * hy[i + 3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      na += __shfl_xor_sync(kFull, na, off);
      nb += __shfl_xor_sync(kFull, nb, off);
      rma += __shfl_xor_sync(kFull, rma, off);
      rmb += __shfl_xor_sync(kFull, rmb, off);
    }
    if (lane % 4 == 0) {
      const long long bhc = (static_cast<long long>(b) * a.H + h) * nc + c;
      a.aux[(bhc * q + ia) * 4 + 2] = rma + esa * na;
      a.aux[(bhc * q + ib) * 4 + 2] = rmb + esb * nb;
    }
  }
  const long long ra = (static_cast<long long>(b) * a.S + c0 + ia) * a.G + g;
  const long long rb = ra + 8LL * a.G;
  if (blk.n_sl == 1) {
    bf16* out = static_cast<bf16*>(a.dC);
    store_rows<DS>(dC, out + ra * DS, out + rb * DS, c2);
  } else {
    float* out = a.dCp + static_cast<long long>(blk.sl) * a.Bn * a.S * a.G * DS;
    store_rows<DS>(dC, out + ra * DS, out + rb * DS, c2);
  }
}

template <typename K>
int set_smem(K kernel, long long bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

int after(cudaError_t) { return static_cast<int>(cudaGetLastError()); }

template <typename T>
int launch_fma_tiles(const Args& a, cudaStream_t s) {
  const int nc = a.S / a.q, nt = (a.q + kFRows - 1) / kFRows;
  const long long bytes = fma_smem_bytes(a.hd, a.ds, a.q);
  int err = set_smem(bwd_keys_fma<T>, bytes);
  if (err == 0) err = set_smem(bwd_queries_fma<T>, bytes);
  if (err != 0) return err;
  const dim3 grid(nc * nt, a.H, a.Bn);
  bwd_keys_fma<T><<<grid, kFThreads, bytes, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  bwd_queries_fma<T><<<grid, kFThreads, bytes, s>>>(a);
  return after(cudaSuccess);
}

// one [B, S, N, D] bf16 tensor (strides in elements) as a 4-D tensor map
// (innermost first: D, rows, N, B) with a box of 64 columns of `rows`
// rows of one head or group; a dimension of size 1 gets a packed stride
// (its coordinate is always 0)
int view_map(CUtensorMap* map, const void* p, long long sb, long long ss, long long sn, int D,
             int S, int N, int B, int rows) {
  uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                      static_cast<uint64_t>(N), static_cast<uint64_t>(B)};
  uint64_t strides[3] = {static_cast<uint64_t>(ss) * 2, static_cast<uint64_t>(sn) * 2,
                         static_cast<uint64_t>(sb) * 2};
  for (int i = 1; i < 4; ++i)
    if (dims[i] == 1) strides[i - 1] = i == 1 ? dims[0] * 2 : strides[i - 2] * dims[i - 1];
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return sm90_host::make_map(map, p, 4, dims, strides, box);
}

// the bf16 states [rows of 64][ds] as a 2-D map with a box of 64 x 64
int state_map(CUtensorMap* map, const void* p, int ds, long long rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(ds), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(ds) * 2};
  const uint32_t box[2] = {64, 64};
  return sm90_host::make_map(map, p, 2, dims, strides, box);
}

// kernels 1-5 of the wgmma route: seg, the scan (chunk states and state
// gradients), C B^T and the key and query tiles
template <int DS>
int launch_wgmma(const Args& a, cudaStream_t s) {
  const int q = a.q, nc = a.S / q, nqt = q / kWT, rep = a.H / a.G;
  const long long dy_ss = static_cast<long long>(a.H) * kWT;
  const long long dy_sb = static_cast<long long>(a.S) * dy_ss;
  // boxes of the chunk's q rows (states) and of 64 rows (tiles)
  CUtensorMap xq, yq, bq, cq, xt, yt, bt, ct, gm, hm;
  int err = view_map(&xq, a.x, a.x_sb, a.x_ss, a.x_sh, kWT, a.S, a.H, a.Bn, q);
  if (err == 0) err = view_map(&yq, a.dy, dy_sb, dy_ss, kWT, kWT, a.S, a.H, a.Bn, q);
  if (err == 0) err = view_map(&bq, a.Bm, a.b_sb, a.b_ss, a.b_sg, DS, a.S, a.G, a.Bn, q);
  if (err == 0) err = view_map(&cq, a.Cm, a.c_sb, a.c_ss, a.c_sg, DS, a.S, a.G, a.Bn, q);
  if (err == 0) err = view_map(&xt, a.x, a.x_sb, a.x_ss, a.x_sh, kWT, a.S, a.H, a.Bn, kWT);
  if (err == 0) err = view_map(&yt, a.dy, dy_sb, dy_ss, kWT, kWT, a.S, a.H, a.Bn, kWT);
  if (err == 0) err = view_map(&bt, a.Bm, a.b_sb, a.b_ss, a.b_sg, DS, a.S, a.G, a.Bn, kWT);
  if (err == 0) err = view_map(&ct, a.Cm, a.c_sb, a.c_ss, a.c_sg, DS, a.S, a.G, a.Bn, kWT);
  const long long state_rows = static_cast<long long>(a.Bn) * a.H * nc * kWT;
  if (err == 0) err = state_map(&gm, a.gb, DS, state_rows);
  if (err == 0) err = state_map(&hm, a.hb, DS, state_rows);
  if (err != 0) return err;
  // 1, 2. seg and dt of every chunk; the chunk states and the state
  // gradients in one scan
  const long long n_chunks = static_cast<long long>(a.Bn) * a.H * nc;
  bwd_seg<<<static_cast<int>((n_chunks + 3) / 4), 128, 4 * 2 * q * 4, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  const int sbytes = scan_smem(DS, q).total;
  if ((err = set_smem(bwd_scan_wgmma<DS>, sbytes)) != 0) return err;
  bwd_scan_wgmma<DS><<<a.Bn * a.H, kWThreads, sbytes, s>>>(xq, yq, bq, cq, a);
  if ((err = after(cudaSuccess)) != 0) return err;
  // 3. C B^T once a (batch row, group, chunk)
  const int cbytes = cb_smem(DS);
  if ((err = set_smem(bwd_cb, cbytes)) != 0) return err;
  bwd_cb<<<dim3(nc * nqt, a.G, a.Bn), kMmaThreads, cbytes, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  // 4, 5. the key and query tiles over the heads of a slice
  const int n_sl = (rep + a.hs - 1) / a.hs;
  const int tbytes = tile_smem(DS, q).total;
  if ((err = set_smem(bwd_keys_wgmma<DS>, tbytes)) != 0) return err;
  if ((err = set_smem(bwd_queries_wgmma<DS>, tbytes)) != 0) return err;
  const int blocks = nqt * n_sl * a.G * nc * a.Bn;
  bwd_keys_wgmma<DS><<<blocks, kWThreads, tbytes, s>>>(xt, yt, bt, ct, gm, a);
  if ((err = after(cudaSuccess)) != 0) return err;
  bwd_queries_wgmma<DS><<<blocks, kWThreads, tbytes, s>>>(xt, yt, bt, ct, hm, a);
  return after(cudaSuccess);
}

// wgmma: the wgmma route's kernels, else the fma route's
template <typename T>
int launch_all(const Args& a, bool wgmma, cudaStream_t s) {
  const int nc = a.S / a.q;
  const dim3 chunks(nc, a.H, a.Bn);
  int err = 0;
  if (wgmma) {
    // kernels 1-5
    err = a.ds == 128 ? launch_wgmma<128>(a, s) : launch_wgmma<64>(a, s);
    if (err != 0) return err;
  } else {
    // 1. the chunk states and the state gradients' shares
    const long long bytes = 8LL * a.q;
    if ((err = set_smem(bwd_states_fma<T>, bytes)) != 0) return err;
    bwd_states_fma<T><<<chunks, kFThreads, bytes, s>>>(a);
    if ((err = after(cudaSuccess)) != 0) return err;
    // 2. h_c forward, G_c in reverse
    const int n = a.hd * a.ds;
    bwd_pass<<<dim3((n + 255) / 256, a.H, a.Bn), 256, 0, s>>>(a, n);
    if ((err = after(cudaSuccess)) != 0) return err;
    // 3, 4. the key and query tiles
    if ((err = launch_fma_tiles<T>(a, s)) != 0) return err;
  }
  // 5. d(seg), ddt, dA's parts
  const long long fbytes = 8LL * (4 * a.q + 256) + 4LL * a.q;
  if ((err = set_smem(bwd_finalize, fbytes)) != 0) return err;
  bwd_finalize<<<chunks, 256, fbytes, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  // 6. the sums over heads (wgmma: over head slices, when there are
  // several), batch rows and chunks
  const long long m = static_cast<long long>(a.Bn) * a.S * a.G * a.ds;
  const long long want = (m + 255) / 256;
  const int grid = static_cast<int>(want < 4096 ? want : 4096);
  const long long ds = a.ds, rep = a.H / a.G;
  if (!wgmma) {
    bwd_reduce_parts<T><<<grid, 256, 0, s>>>(a, static_cast<int>(rep), a.H * ds, rep * ds, ds);
  } else {
    const int n_sl = static_cast<int>((rep + a.hs - 1) / a.hs);
    if (n_sl > 1) bwd_reduce_parts<T><<<grid, 256, 0, s>>>(a, n_sl, a.G * ds, ds, m);
  }
  if ((err = after(cudaSuccess)) != 0) return err;
  bwd_reduce_dA<<<1, 256, 0, s>>>(a);
  return after(cudaSuccess);
}

// bytes of dynamic shared memory of a route's largest kernel
long long route_smem_bytes(int hd, int ds, int q, bool wgmma) {
  if (!wgmma) return fma_smem_bytes(hd, ds, q);
  const long long tiles = tile_smem(ds, q).total, states = scan_smem(ds, q).total;
  const long long cb = cb_smem(ds);
  const long long m = tiles > states ? tiles : states;
  return m > cb ? m : cb;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the route's largest kernel (0 =
// "fma", 1 = "wgmma"), so that the host's checks can be held against the
// source.
long long repro_ssd_bwd_smem_bytes(int hd, int ds, int q, int route) {
  return route_smem_bytes(hd, ds, q, route == 1);
}

// Launches the backward on `stream` by `route` (0 = "fma", 1 = "wgmma");
// returns cudaGetLastError() (0 = ok), -1 for an unsupported dtype, -2
// for a shape the route does not take, -3 when its tiles do not fit a
// block's shared memory (or CUDA offers no TMA encoder), -4 when a TMA
// tensor map is refused.  x [B, S, H, hd], dt [B, S, H] (fp32), B and C
// [B, S, G, ds] are read through the strides given (elements; last
// dimensions contiguous; for "wgmma" 16-byte aligned rows and strides), A
// [H] fp32; dy, dx [B, S, H, hd], ddt [B, S, H] (fp32), dA [H] (fp32), dB
// and dC [B, S, G, ds] are contiguous.  dtype 0 = float32, 1 = bfloat16
// (x, B, C, dy, dx, dB, dC; "wgmma" takes bfloat16 only).  Scratch: hst
// [B, H, S / q, hd, ds] (fp32), segs [B, H, S / q, q] (fp32), aux [B, H,
// S / q, q, 4] (fp64), dA_part [B, H, S / q] (fp64); "fma": gst (as hst)
// and part 2 x [B, S, H, ds] (fp32, per-head dB, then dC); "wgmma": part
// 2 x [slices, B, S, G, ds] (fp32, each head slice's dB, then dC; none
// with one slice), hb and gb [B, H, S / q, hd, ds] (bf16), dts [B, H, S /
// q, q] (fp32), cb [B, G, S / q, 2, q / 64, q / 64, 4096] (fp32), gh [B,
// H, S / q] (fp64), hs the heads of a slice (ssd_scan.py's
// backward_head_slice).  A route's unused scratch may be null.
int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int B, int S, int H, int hd, int G, int ds, int q, int dtype, int route, int hs,
    void* hst, void* gst, void* hb, void* gb, void* segs, void* dts, void* cb, void* gh,
    void* aux, void* part, void* dA_part, void* stream) {
  if (H == 0) return 0;
  if (B == 0 || S == 0) return static_cast<int>(cudaMemsetAsync(
      dA, 0, sizeof(float) * H, static_cast<cudaStream_t>(stream)));
  if (q < 1 || S % q != 0 || H % G != 0 || hd % 2 != 0 || ds % 2 != 0) return -2;
  if (route != 0 && route != 1) return -2;
  const bool wgmma = route == 1;
  if (wgmma && (dtype != 1 || hd != kWT || (ds != 64 && ds != 128) || q % kWT != 0 ||
                q > 256 || hs < 1 || hb == nullptr || gb == nullptr || dts == nullptr ||
                cb == nullptr || gh == nullptr))
    return -2;
  if (route_smem_bytes(hd, ds, q, wgmma) > kMaxSmem) return -3;
  // part: the per-head sums ("fma") or the head slices' ("wgmma")
  float* p = static_cast<float*>(part);
  const long long half = wgmma
      ? static_cast<long long>((H / G + hs - 1) / hs) * B * S * G * ds
      : static_cast<long long>(B) * S * H * ds;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm, dy, dx,
               static_cast<float*>(ddt), static_cast<float*>(dA), dB, dC,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
               B, S, H, G, hd, ds, q,
               static_cast<float*>(hst), static_cast<float*>(gst), static_cast<float*>(segs),
               static_cast<double*>(aux), p, p == nullptr ? nullptr : p + half,
               static_cast<double*>(dA_part),
               static_cast<bf16*>(hb), static_cast<bf16*>(gb), static_cast<float*>(dts),
               static_cast<float*>(cb), static_cast<double*>(gh), hs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return wgmma ? -1 : launch_all<float>(a, false, s);
  if (dtype == 1) return launch_all<bf16>(a, wgmma, s);
  return -1;
}

}  // extern "C"
