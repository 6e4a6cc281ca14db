// The Mamba2 SSD chunked scan, backward.
//
// Replaces no TPU kernel: the JAX package trains through its XLA scan
// (repro.models.ssm.ssd_chunked), whose gradient XLA forms; the forward's
// Pallas kernel, repro.kernels.ssd_scan.ssd_scan, has no backward.  This
// is the gradient of csrc/ssd_scan.cu.  Per batch row b and head h, over
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
// Kernels, in launch order (one wrapper call):
//
//   1. states, one block per (chunk, head, batch row): seg (stored), the
//      chunk's own state contribution sum_j exp(tot - seg_j) dt_j x_j^T B_j
//      and its share of the state gradient sum_i exp(seg_i) dy_i^T C_i,
//      [hd, ds] each, in fp32 scratch (recomputed: the forward's bf16
//      chunk states are not kept);
//   2. pass, sequential over the chunks, one thread per state element:
//      forward for h_c, in reverse for G_c, in place, fp32;
//   3. keys, one block per (key tile, chunk, head, batch row): dx, the
//      head's dB rows (fp32 scratch [b, s, h, ds]) and e1, e2, walking the
//      query tiles i >= j;
//   4. queries, one block per (query tile, chunk, head, batch row): the
//      head's dC rows and r, walking the key tiles j <= i;
//   5. finalize, one block per (chunk, head, batch row): d(seg), its
//      reverse cumulative sum, ddt and the chunk's part of dA, in fp64
//      (they cancel heavily: the row sums of M from the query tiles and its
//      column sums from the key tiles, which the FMA route forms from the
//      same fp32 values of M and adds in fp64, so that they cancel to
//      fp64's rounding);
//   6. reduce: dB and dC summed over a group's heads in head order (cast
//      to x's dtype), dA over batch rows and chunks in order.
//
// Two routes for 1, 3 and 4, chosen on the host (ssd_scan.py's
// backward_route):
//
// "mma" (bf16, hd <= 64, ds <= 128 and a multiple of 16, q a multiple of
// 16, 16-byte aligned rows): 64-row tiles staged with cp.async in padded
// shared-memory rows; every product on mma.sync m16n8k16 (bf16 operands,
// fp32 sums) with ldmatrix, in the layouts ssd_scan.cu's forward kernels
// use (K-major pairs for C B^T and dy x^T, MN-major through ldmatrix.trans
// for the products with the weights).  Warp w owns 16 rows of the block's
// tile; the score tiles' weights are scaled, masked and packed into A
// fragments in registers.  G_c and h_c are rounded to bf16 as operands;
// every sum, seg and the states stay fp32.
//
// "fma" (fp32, and every other shape the forward takes): the same
// kernels on 32-row fp32 tiles in shared memory with plain fp32 FMA
// loops, accumulators in shared memory owned by one thread each.
//
// No atomics: every sum has one order, so two runs give the same bits.
//
// Bound.  At mamba2-1.3b's training shape (x [4, 2048, 64, 64] bf16, ds
// 128, chunk 256) the function's least work is C B^T once a group, four
// causal products a head (dy x^T, W^T dy, V^T C, V B) and five [hd, ds]
// state products a head (the chunk state, the state gradient's share,
// G_c B, x G_c, h_c^T dy): ~95 GFLOP, 0.096 ms at the bf16 tensor-core
// rate.  These kernels do more: C B^T per head and dy x^T in both tile
// kernels, and they move ~0.7 GB (x, dy, B, C read, dx, dB, dC written,
// the fp32 scratch of the states and the per-head dB, dC), 0.2 ms at
// 3.35 TB/s.
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
constexpr int kRows = 64;       // mma route: rows of a tile
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
  float* dBp;       // [B, S, H, ds]: per-head dB
  float* dCp;       // [B, S, H, ds]: per-head dC
  double* dA_part;  // [B, H, nc]
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

// bytes of dynamic shared memory of the route's largest kernel
__host__ __device__ inline long long smem_bytes(int hd, int ds, int q, bool mma) {
  if (mma) {
    const long long states = 2LL * q * (hd + 8) + 2LL * q * (ds + 8);
    const long long tiles = 4LL * kRows * (ds + 8) + 4LL * kRows * (hd + 8);
    return 8LL * q + (states > tiles ? states : tiles);
  }
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
  // sum(G_c * h_c), in a fixed order
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
template <typename T>
__global__ void bwd_reduce_heads(const Args a) {
  const long long n = static_cast<long long>(a.Bn) * a.S * a.G * a.ds;
  const int rep = a.H / a.G;
  T* dB = static_cast<T*>(a.dB);
  T* dC = static_cast<T*>(a.dC);
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(e % a.ds);
    const long long bsg = e / a.ds;
    const int g = static_cast<int>(bsg % a.G);
    const long long bs = bsg / a.G;
    const long long base = (bs * a.H + static_cast<long long>(g) * rep) * a.ds + k;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
      sb += a.dBp[base + static_cast<long long>(r) * a.ds];
      sc += a.dCp[base + static_cast<long long>(r) * a.ds];
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

// ================================================================ "mma"
// n rows of `cols` bf16 (row stride ld, 16-byte aligned) into shared
// memory at pitch cols + 8 with cp.async, zeros at or past `valid`
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

// fp32 [rows][cols] from global into bf16 shared rows of pitch cols + 8
__device__ __forceinline__ void load_state(bf16* dst, const float* src, int rows, int cols,
                                           int tid) {
  const int half = cols / 2;
  for (int e = tid; e < rows * half; e += kMmaThreads) {
    const int r = e / half, k = 2 * (e % half);
    const float2 v = *reinterpret_cast<const float2*>(src + r * cols + k);
    *reinterpret_cast<uint32_t*>(dst + r * (cols + 8) + k) = sm90::pack_bf16(v.x, v.y);
  }
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

// acc[2 NG][4] += A . B for one k16 step: A a fragment (16 rows, k
// k0..k0+15), B [k rows][n] MN-major in shared memory (ldmatrix.trans),
// its 16-column groups g < ng
template <int NG>
__device__ __forceinline__ void mma_pn(float (&acc)[2 * NG][4], const uint32_t (&pa)[4],
                                       const bf16* Bs, int bp, int k0, int ng, int lane) {
  const int mi = lane / 8;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (g < ng) {
      uint32_t vb[4];
      sm90::ldmatrix_x4_trans(vb, Bs + (k0 + 8 * (mi % 2) + lane % 8) * bp + 16 * g + 8 * (mi / 2));
      sm90::mma_bf16_16816(acc[2 * g], pa, vb[0], vb[1]);
      sm90::mma_bf16_16816(acc[2 * g + 1], pa, vb[2], vb[3]);
    }
  }
}

// acc += A . B with A [16 rows r0..][K] K-major in shared memory and B [K
// rows][n] MN-major
template <int NG>
__device__ __forceinline__ void mma_sn(float (&acc)[2 * NG][4], const bf16* As, int ap, int r0,
                                       int K, const bf16* Bs, int bp, int ng, int lane) {
  const int mi = lane / 8;
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    sm90::ldmatrix_x4(af, As + (r0 + 8 * (mi % 2) + lane % 8) * ap + 16 * kk + 8 * (mi / 2));
    mma_pn<NG>(acc, af, Bs, bp, 16 * kk, ng, lane);
  }
}

// the A fragment of a 16-column group of an accumulator tile (the
// accumulator's layout is the fragment's, pairwise)
__device__ __forceinline__ void pack_frag(uint32_t (&pa)[4], const float (&lo)[4],
                                          const float (&hi)[4]) {
  pa[0] = sm90::pack_bf16(lo[0], lo[1]);
  pa[1] = sm90::pack_bf16(lo[2], lo[3]);
  pa[2] = sm90::pack_bf16(hi[0], hi[1]);
  pa[3] = sm90::pack_bf16(hi[2], hi[3]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// out[p][n] = sum_j Xs[j][p] Bs[j][n] over the chunk's q rows ([hd, ds],
// fp32), cut into warp tiles of 16 x 64 (ssd_scan.cu's ssd_states)
__device__ __forceinline__ void rows_outer(const bf16* Xs, int xp, const bf16* Bs, int bp,
                                           float* out, int hd, int ds, int q, int w, int lane) {
  const int gq = lane / 4, tq = lane % 4, mi = lane / 8;
  const int nN = (ds + 63) / 64, nwt = (hd / 16) * nN;
  for (int wt = w; wt < nwt; wt += kMmaThreads / 32) {
    const int m0 = 16 * (wt / nN), n0 = 64 * (wt % nN);
    const int ng = min(4, (ds - n0) / 16);
    float acc[8][4];
    zero(acc);
    for (int kk = 0; kk < q / 16; ++kk) {
      uint32_t af[4];
      sm90::ldmatrix_x4_trans(af, Xs + (16 * kk + 8 * (mi / 2) + lane % 8) * xp + m0 + 8 * (mi % 2));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj < ng) {
          uint32_t bfr[4];
          sm90::ldmatrix_x4_trans(
              bfr, Bs + (16 * kk + 8 * (mi % 2) + lane % 8) * bp + n0 + 16 * jj + 8 * (mi / 2));
          sm90::mma_bf16_16816(acc[2 * jj], af, bfr[0], bfr[1]);
          sm90::mma_bf16_16816(acc[2 * jj + 1], af, bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * ng) {
        const int col = n0 + 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(out + (m0 + gq) * ds + col) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (m0 + gq + 8) * ds + col) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// the rows of Xs (q of them, hd values) scaled by w[r] in place
__device__ __forceinline__ void scale_rows(bf16* Xs, int xp, const float* w, int q, int hd,
                                           int tid) {
  const int pieces = hd / 8;
  for (int e = tid; e < q * pieces; e += kMmaThreads) {
    const int r = e / pieces, pc = e % pieces;
    const uint4 v = *reinterpret_cast<const uint4*>(Xs + r * xp + 8 * pc);
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float wr = w[r];
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(in[k]);
      op[k] = sm90::pack_bf16(f.x * wr, f.y * wr);
    }
    *reinterpret_cast<uint4*>(Xs + r * xp + 8 * pc) = o;
  }
}

// pass 1, "mma": one block per (chunk, head, batch row)
__global__ void __launch_bounds__(kMmaThreads) bwd_states_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const Chunk ch(a, blockIdx.x, blockIdx.y, blockIdx.z);
  const int q = a.q, ds = a.ds, hd = a.hd, XP = hd + 8, BP = ds + 8;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  float* wts = reinterpret_cast<float*>(dsm);    // [q] dt, then the row weights
  float* seg = wts + q;                          // [q]
  bf16* Xs = reinterpret_cast<bf16*>(seg + q);   // [q][hd + 8]
  bf16* Bs = Xs + q * XP;                        // [q][ds + 8]
  load_rows(Bs, ch.B<bf16>(a), a.b_ss, q, ds, q, tid);
  load_rows(Xs, ch.x<bf16>(a), a.x_ss, q, hd, q, tid);
  const float* DT = ch.dt(a);
  for (int i = tid; i < q; i += kMmaThreads) wts[i] = DT[i * a.dt_ss];
  __syncthreads();
  if (w == 0) chunk_cumsum(wts, a.A[ch.h], seg, q, lane);
  wait_rows();
  const float tot = seg[q - 1];
  for (int i = tid; i < q; i += kMmaThreads) {
    a.segs[ch.bhc * q + i] = seg[i];
    wts[i] = expf(tot - seg[i]) * wts[i];
  }
  __syncthreads();
  scale_rows(Xs, XP, wts, q, hd, tid);
  __syncthreads();
  rows_outer(Xs, XP, Bs, BP, a.hst + ch.bhc * hd * ds, hd, ds, q, w, lane);
  __syncthreads();  // Xs and Bs are consumed
  const bf16* Y = static_cast<const bf16*>(a.dy) + ch.row(a, 0) * hd;
  load_rows(Bs, ch.C<bf16>(a), a.c_ss, q, ds, q, tid);
  load_rows(Xs, Y, static_cast<long long>(a.H) * hd, q, hd, q, tid);
  for (int i = tid; i < q; i += kMmaThreads) wts[i] = expf(seg[i]);
  wait_rows();
  scale_rows(Xs, XP, wts, q, hd, tid);
  __syncthreads();
  rows_outer(Xs, XP, Bs, BP, a.gst + ch.bhc * hd * ds, hd, ds, q, w, lane);
}

constexpr int kDsGroups = 8;  // the mma route's d_state: up to 128 (8 groups of 16)

// pass 3, "mma": one block per (key tile of 64 rows, chunk, head, batch
// row); warp w owns the key rows j0 + 16 w ..
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) bwd_keys_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  constexpr int HG = HD / 16, XP = HD + 8;
  const int q = a.q, ds = a.ds, BP = ds + 8, dg = ds / 16;
  const int nqt = (q + kRows - 1) / kRows;
  const Chunk ch(a, blockIdx.x / nqt, blockIdx.y, blockIdx.z);
  const int j0 = (blockIdx.x % nqt) * kRows;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane / 4, tq = lane % 4;
  float* seg = reinterpret_cast<float*>(dsm);   // [q]
  float* dts = seg + q;                          // [q]
  bf16* Bj = reinterpret_cast<bf16*>(dts + q);   // [64][ds + 8] the key rows of B
  bf16* Ci = Bj + kRows * BP;                    // [64][ds + 8] a query tile's C (then G_c)
  bf16* Xj = Ci + kRows * BP;                    // [64][HD + 8] the key rows of x
  bf16* Yi = Xj + kRows * XP;                    // [64][HD + 8] a query tile's dy
  const float* DT = ch.dt(a);
  for (int i = tid; i < q; i += kMmaThreads) {
    seg[i] = a.segs[ch.bhc * q + i];
    dts[i] = DT[i * a.dt_ss];
  }
  const bf16* Cp = ch.C<bf16>(a);
  const bf16* Y = static_cast<const bf16*>(a.dy) + ch.row(a, 0) * HD;
  const long long y_ss = static_cast<long long>(a.H) * HD;
  load_rows(Bj, ch.B<bf16>(a) + j0 * a.b_ss, a.b_ss, kRows, ds, q - j0, tid);
  load_rows(Xj, ch.x<bf16>(a) + j0 * a.x_ss, a.x_ss, kRows, HD, q - j0, tid);
  wait_rows();

  const int r0 = 16 * w, ja = j0 + r0 + gq, jb = ja + 8;
  const float sja = ja < q ? seg[ja] : 0.f, sjb = jb < q ? seg[jb] : 0.f;
  const float dta = ja < q ? dts[ja] : 0.f, dtb = jb < q ? dts[jb] : 0.f;
  float ax[2 * HG][4], ab[2 * kDsGroups][4];
  zero(ax);
  zero(ab);
  float e1a = 0.f, e1b = 0.f;
  for (int i0 = j0; i0 < q; i0 += kRows) {
    __syncthreads();  // the previous query tile is consumed
    load_rows(Ci, Cp + i0 * a.c_ss, a.c_ss, kRows, ds, q - i0, tid);
    load_rows(Yi, Y + i0 * y_ss, y_ss, kRows, HD, q - i0, tid);
    wait_rows();
    float sc[8][4], sx[8][4];
    zero(sc);
    zero(sx);
    mma_nt<4>(sc, Bj, BP, r0, Ci, BP, ds, 4, lane);  // B_j . C_i
    mma_nt<4>(sx, Xj, XP, r0, Yi, XP, HD, 4, lane);  // x_j . dy_i
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * nt + 2 * tq + (e & 1);
        const int j = e < 2 ? ja : jb;
        const bool ok = j <= i && i < q && j < q;
        const float dec = ok ? expf(seg[i < q ? i : q - 1] - (e < 2 ? sja : sjb)) : 0.f;
        const float dtj = e < 2 ? dta : dtb;
        const float cbd = sc[nt][e] * dec;
        if (e < 2) e1a += cbd * sx[nt][e]; else e1b += cbd * sx[nt][e];
        sc[nt][e] = cbd * dtj;               // W
        sx[nt][e] = sx[nt][e] * dec * dtj;   // V
      }
    const int kg0 = i0 == j0 ? w : 0;  // on the diagonal tile, earlier queries are masked
#pragma unroll
    for (int kg = 0; kg < 4; ++kg) {
      if (kg < kg0) continue;
      uint32_t pa[4];
      pack_frag(pa, sc[2 * kg], sc[2 * kg + 1]);
      mma_pn<HG>(ax, pa, Yi, XP, 16 * kg, HG, lane);          // dx += W dy
      pack_frag(pa, sx[2 * kg], sx[2 * kg + 1]);
      mma_pn<kDsGroups>(ab, pa, Ci, BP, 16 * kg, dg, lane);   // dB += V C
    }
  }
  // the carried state's terms: G_c (bf16 operand) over the C tile's room
  __syncthreads();
  load_state(Ci, a.gst + ch.bhc * HD * ds, HD, ds, tid);
  __syncthreads();
  const float tot = seg[q - 1];
  const float eta = ja < q ? expf(tot - sja) : 0.f, etb = jb < q ? expf(tot - sjb) : 0.f;
  float xa = 0.f, xb = 0.f;
  {
    float gb[2 * HG][4];
    zero(gb);
    mma_nt<HG>(gb, Bj, BP, r0, Ci, BP, ds, HG, lane);  // (G_c B_j)[p]
#pragma unroll
    for (int nt = 0; nt < 2 * HG; ++nt) {
      const int p = 8 * nt + 2 * tq;
      const float2 u = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Xj + (r0 + gq) * XP + p));
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Xj + (r0 + gq + 8) * XP + p));
      xa += u.x * gb[nt][0] + u.y * gb[nt][1];
      xb += v.x * gb[nt][2] + v.y * gb[nt][3];
      ax[nt][0] += dta * eta * gb[nt][0];
      ax[nt][1] += dta * eta * gb[nt][1];
      ax[nt][2] += dtb * etb * gb[nt][2];
      ax[nt][3] += dtb * etb * gb[nt][3];
    }
  }
  {
    float xg[2 * kDsGroups][4];
    zero(xg);
    mma_sn<kDsGroups>(xg, Xj, XP, r0, HD, Ci, BP, dg, lane);  // (G_c^T x_j)[n]
#pragma unroll
    for (int nt = 0; nt < 2 * kDsGroups; ++nt) {
      ab[nt][0] += eta * dta * xg[nt][0];
      ab[nt][1] += eta * dta * xg[nt][1];
      ab[nt][2] += etb * dtb * xg[nt][2];
      ab[nt][3] += etb * dtb * xg[nt][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    xa += __shfl_xor_sync(kFull, xa, off);
    xb += __shfl_xor_sync(kFull, xb, off);
    e1a += __shfl_xor_sync(kFull, e1a, off);
    e1b += __shfl_xor_sync(kFull, e1b, off);
  }
  bf16* DX = static_cast<bf16*>(a.dx);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = hh == 0 ? ja : jb;
    if (j >= q) continue;
    bf16* o = DX + ch.row(a, j) * HD;
#pragma unroll
    for (int nt = 0; nt < 2 * HG; ++nt)
      *reinterpret_cast<uint32_t*>(o + 8 * nt + 2 * tq) =
          sm90::pack_bf16(ax[nt][2 * hh], ax[nt][2 * hh + 1]);
    float* ob = a.dBp + ch.row(a, j) * ds;
#pragma unroll
    for (int nt = 0; nt < 2 * kDsGroups; ++nt)
      if (nt < 2 * dg)
        *reinterpret_cast<float2*>(ob + 8 * nt + 2 * tq) =
            make_float2(ab[nt][2 * hh], ab[nt][2 * hh + 1]);
    if (tq == 0) {
      double* o4 = a.aux + (ch.bhc * q + j) * 4;
      const float e1 = hh == 0 ? e1a : e1b;
      o4[0] = e1;
      o4[1] = hh == 0 ? eta * xa : etb * xb;
      o4[3] = static_cast<double>(hh == 0 ? dta : dtb) * e1;
    }
  }
}

// pass 4, "mma": one block per (query tile of 64 rows, chunk, head, batch
// row); warp w owns the query rows i0 + 16 w ..
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) bwd_queries_mma(const Args a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  constexpr int XP = HD + 8;
  const int q = a.q, ds = a.ds, BP = ds + 8, dg = ds / 16;
  const int nqt = (q + kRows - 1) / kRows;
  const Chunk ch(a, blockIdx.x / nqt, blockIdx.y, blockIdx.z);
  const int i0 = (blockIdx.x % nqt) * kRows;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane / 4, tq = lane % 4;
  float* seg = reinterpret_cast<float*>(dsm);   // [q]
  float* dts = seg + q;                          // [q]
  bf16* Ci = reinterpret_cast<bf16*>(dts + q);   // [64][ds + 8] the query rows of C
  bf16* Bj = Ci + kRows * BP;                    // [64][ds + 8] a key tile's B (then h_c)
  bf16* Yi = Bj + kRows * BP;                    // [64][HD + 8] the query rows of dy
  bf16* Xj = Yi + kRows * XP;                    // [64][HD + 8] a key tile's x
  const float* DT = ch.dt(a);
  for (int i = tid; i < q; i += kMmaThreads) {
    seg[i] = a.segs[ch.bhc * q + i];
    dts[i] = DT[i * a.dt_ss];
  }
  const bf16* Bp = ch.B<bf16>(a);
  const bf16* X = ch.x<bf16>(a);
  const bf16* Y = static_cast<const bf16*>(a.dy) + ch.row(a, 0) * HD;
  const long long y_ss = static_cast<long long>(a.H) * HD;
  load_rows(Ci, ch.C<bf16>(a) + i0 * a.c_ss, a.c_ss, kRows, ds, q - i0, tid);
  load_rows(Yi, Y + i0 * y_ss, y_ss, kRows, HD, q - i0, tid);
  wait_rows();

  const int r0 = 16 * w, ia = i0 + r0 + gq, ib = ia + 8;
  const float sia = ia < q ? seg[ia] : 0.f, sib = ib < q ? seg[ib] : 0.f;
  float ac[2 * kDsGroups][4];
  zero(ac);
  float rma = 0.f, rmb = 0.f;
  for (int j0 = 0; j0 <= i0; j0 += kRows) {
    __syncthreads();
    load_rows(Bj, Bp + j0 * a.b_ss, a.b_ss, kRows, ds, q - j0, tid);
    load_rows(Xj, X + j0 * a.x_ss, a.x_ss, kRows, HD, q - j0, tid);
    wait_rows();
    float sc[8][4], sx[8][4];
    zero(sc);
    zero(sx);
    mma_nt<4>(sc, Ci, BP, r0, Bj, BP, ds, 4, lane);  // C_i . B_j
    mma_nt<4>(sx, Yi, XP, r0, Xj, XP, HD, 4, lane);  // dy_i . x_j
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * nt + 2 * tq + (e & 1);
        const int i = e < 2 ? ia : ib;
        const int jc = j < q ? j : q - 1;
        const bool ok = j <= i && i < q && j < q;
        const float dec = ok ? expf((e < 2 ? sia : sib) - seg[jc]) : 0.f;
        const float v = sx[nt][e] * dec * dts[jc];
        if (e < 2) rma += sc[nt][e] * v; else rmb += sc[nt][e] * v;
        sx[nt][e] = v;
      }
    const int nkg = j0 == i0 ? w + 1 : 4;  // on the diagonal tile, later keys are masked
#pragma unroll
    for (int kg = 0; kg < 4; ++kg) {
      if (kg < nkg) {
        uint32_t pa[4];
        pack_frag(pa, sx[2 * kg], sx[2 * kg + 1]);
        mma_pn<kDsGroups>(ac, pa, Bj, BP, 16 * kg, dg, lane);  // dC += V B
      }
    }
  }
  // the carried state's terms: h_c (bf16 operand) over the B tile's room
  __syncthreads();
  load_state(Bj, a.hst + ch.bhc * HD * ds, HD, ds, tid);
  __syncthreads();
  const float esa = ia < q ? expf(sia) : 0.f, esb = ib < q ? expf(sib) : 0.f;
  // dC's carried term e^seg_i (h_c^T dy_i), and d(seg)'s, its dot with C_i
  float na = 0.f, nb = 0.f;
  {
    float hy[2 * kDsGroups][4];
    zero(hy);
    mma_sn<kDsGroups>(hy, Yi, XP, r0, HD, Bj, BP, dg, lane);  // (h_c^T dy_i)[n]
#pragma unroll
    for (int nt = 0; nt < 2 * kDsGroups; ++nt) {
      if (nt < 2 * dg) {
        const int n = 8 * nt + 2 * tq;
        const float2 u = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Ci + (r0 + gq) * BP + n));
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Ci + (r0 + gq + 8) * BP + n));
        na += u.x * hy[nt][0] + u.y * hy[nt][1];
        nb += v.x * hy[nt][2] + v.y * hy[nt][3];
      }
      ac[nt][0] += esa * hy[nt][0];
      ac[nt][1] += esa * hy[nt][1];
      ac[nt][2] += esb * hy[nt][2];
      ac[nt][3] += esb * hy[nt][3];
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    na += __shfl_xor_sync(kFull, na, off);
    nb += __shfl_xor_sync(kFull, nb, off);
    rma += __shfl_xor_sync(kFull, rma, off);
    rmb += __shfl_xor_sync(kFull, rmb, off);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = hh == 0 ? ia : ib;
    if (i >= q) continue;
    float* oc = a.dCp + ch.row(a, i) * ds;
#pragma unroll
    for (int nt = 0; nt < 2 * kDsGroups; ++nt)
      if (nt < 2 * dg)
        *reinterpret_cast<float2*>(oc + 8 * nt + 2 * tq) =
            make_float2(ac[nt][2 * hh], ac[nt][2 * hh + 1]);
    if (tq == 0)
      a.aux[(ch.bhc * q + i) * 4 + 2] = hh == 0 ? rma + esa * na : rmb + esb * nb;
  }
}

template <typename K>
int set_smem(K kernel, long long bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

int after(cudaError_t) { return static_cast<int>(cudaGetLastError()); }

template <int HD>
int launch_mma_tiles(const Args& a, cudaStream_t s) {
  const int nc = a.S / a.q, nqt = (a.q + kRows - 1) / kRows;
  const long long tiles = 8LL * a.q + 4LL * kRows * (a.ds + 8) + 4LL * kRows * (HD + 8);
  int err = set_smem(bwd_keys_mma<HD>, tiles);
  if (err == 0) err = set_smem(bwd_queries_mma<HD>, tiles);
  if (err != 0) return err;
  const dim3 grid(nc * nqt, a.H, a.Bn);
  bwd_keys_mma<HD><<<grid, kMmaThreads, tiles, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  bwd_queries_mma<HD><<<grid, kMmaThreads, tiles, s>>>(a);
  return after(cudaSuccess);
}

template <typename T>
int launch_fma_tiles(const Args& a, cudaStream_t s) {
  const int nc = a.S / a.q, nt = (a.q + kFRows - 1) / kFRows;
  const long long bytes = smem_bytes(a.hd, a.ds, a.q, false);
  int err = set_smem(bwd_keys_fma<T>, bytes);
  if (err == 0) err = set_smem(bwd_queries_fma<T>, bytes);
  if (err != 0) return err;
  const dim3 grid(nc * nt, a.H, a.Bn);
  bwd_keys_fma<T><<<grid, kFThreads, bytes, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  bwd_queries_fma<T><<<grid, kFThreads, bytes, s>>>(a);
  return after(cudaSuccess);
}

template <typename T>
int launch_all(const Args& a, bool mma, cudaStream_t s) {
  const int nc = a.S / a.q;
  const dim3 chunks(nc, a.H, a.Bn);
  int err = 0;
  // 1. the chunk states and the state gradients' shares
  if (mma) {
    const long long bytes = 8LL * a.q + 2LL * a.q * (a.hd + 8) + 2LL * a.q * (a.ds + 8);
    if ((err = set_smem(bwd_states_mma, bytes)) != 0) return err;
    bwd_states_mma<<<chunks, kMmaThreads, bytes, s>>>(a);
  } else {
    const long long bytes = 8LL * a.q;
    if ((err = set_smem(bwd_states_fma<T>, bytes)) != 0) return err;
    bwd_states_fma<T><<<chunks, kFThreads, bytes, s>>>(a);
  }
  if ((err = after(cudaSuccess)) != 0) return err;
  // 2. h_c forward, G_c in reverse
  const int n = a.hd * a.ds;
  bwd_pass<<<dim3((n + 255) / 256, a.H, a.Bn), 256, 0, s>>>(a, n);
  if ((err = after(cudaSuccess)) != 0) return err;
  // 3, 4. the key and query tiles
  if (mma) {
    switch (a.hd) {
      case 16: err = launch_mma_tiles<16>(a, s); break;
      case 32: err = launch_mma_tiles<32>(a, s); break;
      case 64: err = launch_mma_tiles<64>(a, s); break;
      default: return -2;
    }
  } else {
    err = launch_fma_tiles<T>(a, s);
  }
  if (err != 0) return err;
  // 5. d(seg), ddt, dA's parts
  const long long fbytes = 8LL * (4 * a.q + 256) + 4LL * a.q;
  if ((err = set_smem(bwd_finalize, fbytes)) != 0) return err;
  bwd_finalize<<<chunks, 256, fbytes, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  // 6. the sums over heads, batch rows and chunks
  const long long m = static_cast<long long>(a.Bn) * a.S * a.G * a.ds;
  const long long want = (m + 255) / 256;
  bwd_reduce_heads<T><<<static_cast<int>(want < 4096 ? want : 4096), 256, 0, s>>>(a);
  if ((err = after(cudaSuccess)) != 0) return err;
  bwd_reduce_dA<<<1, 256, 0, s>>>(a);
  return after(cudaSuccess);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the route's largest kernel (mma: 1 or
// 0), so that the host's checks can be held against the source.
long long repro_ssd_bwd_smem_bytes(int hd, int ds, int q, int mma) {
  return smem_bytes(hd, ds, q, mma != 0);
}

// Launches the backward on `stream` by `route` (0 = "fma", 1 = "mma");
// returns cudaGetLastError() (0 = ok), -1 for an unsupported dtype, -2
// for a shape the route does not take, -3 when its tiles do not fit a
// block's shared memory.  x [B, S, H, hd], dt [B, S, H] (fp32), B and C
// [B, S, G, ds] are read through the strides given (elements; last
// dimensions contiguous; for "mma" 16-byte aligned rows), A [H] fp32; dy,
// dx [B, S, H, hd], ddt [B, S, H] (fp32), dA [H] (fp32), dB and dC [B, S,
// G, ds] are contiguous.  dtype 0 = float32, 1 = bfloat16 (x, B, C, dy,
// dx, dB, dC; "mma" takes bfloat16 only).  Scratch (fp32): hst and gst [B,
// H, S / q, hd, ds], segs [B, H, S / q, q], aux [B, H, S / q, q, 4]
// (fp64), part 2 x [B, S, H, ds] (per-head dB, then dC), dA_part [B, H, S /
// q] (fp64).
int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* dy, void* dx, void* ddt, void* dA, void* dB, void* dC,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int B, int S, int H, int hd, int G, int ds, int q, int dtype, int route,
    void* hst, void* gst, void* segs, void* aux, void* part, void* dA_part, void* stream) {
  if (H == 0) return 0;
  if (B == 0 || S == 0) return static_cast<int>(cudaMemsetAsync(
      dA, 0, sizeof(float) * H, static_cast<cudaStream_t>(stream)));
  if (q < 1 || S % q != 0 || H % G != 0 || hd % 2 != 0 || ds % 2 != 0) return -2;
  const bool mma = route == 1;
  if (mma && (dtype != 1 || (hd != 16 && hd != 32 && hd != 64) || ds % 16 != 0 ||
              ds > 16 * kDsGroups || q % 16 != 0))
    return -2;
  if (route != 0 && route != 1) return -2;
  if (smem_bytes(hd, ds, q, mma) > kMaxSmem) return -3;
  float* p = static_cast<float*>(part);
  const long long per_head = static_cast<long long>(B) * S * H * ds;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A), Bm, Cm, dy, dx,
               static_cast<float*>(ddt), static_cast<float*>(dA), dB, dC,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
               B, S, H, G, hd, ds, q,
               static_cast<float*>(hst), static_cast<float*>(gst), static_cast<float*>(segs),
               static_cast<double*>(aux), p, p + per_head, static_cast<double*>(dA_part)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return mma ? -1 : launch_all<float>(a, false, s);
  if (dtype == 1) return launch_all<bf16>(a, mma, s);
  return -1;
}

}  // extern "C"
