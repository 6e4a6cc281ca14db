// Attention backward: dq, dk and dv of flash_attention.cu's forward.
//
// The TPU kernel repro.kernels.flash_attention.flash_attention has no
// backward (the reference trains through XLA, whose model never calls
// it); this is the gradient of the same function, held against autograd
// through flash_attention.py's flash_attention_plain.  For each batch b,
// query head h (reading KV head h / (H / KV)) and query row i over keys j:
//
//   x_ij = scale * q_i . k_j,  s_ij = softcap * tanh(x_ij / softcap) (or x_ij)
//   P_ij = exp(s_ij - lse_i) for a visible key, 0 for a masked one
//   dV_j += P_ij dO_i          (P rounded to v's dtype first, as the
//                               plain forward rounds its weights)
//   dP_ij = dO_i . v_j,  dS_ij = P_ij (dP_ij - delta_i) (1 - tanh^2)
//   dQ_i += scale * dS_ij k_j,  dK_j += scale * dS_ij q_i
//
// with delta_i = dO_i . O_i and the softcap's factor 1 - tanh^2(x / softcap)
// only with a softcap.  Masks as in the forward: `causal` keeps j <= i,
// `window` keeps j > i - window.  The backward takes Sq == Sk and
// q_offset 0 (self-attention over a whole sequence), so every row sees
// at least its own key; the wrapper refuses anything else.
//
// Three kernels, launched in turn on the caller's stream:
//
//   * prep: one block per (64 query rows, head, batch) recomputes each
//     row's logsumexp under the mask and softcap (the forward keeps none)
//     with an online max and sum over key tiles, and delta_i =
//     rowsum(dO_i * O_i), both fp32, into [B, H, S] scratch;
//   * dkdv: one block per (64 keys, KV head, batch).  It loops over the
//     group's H / KV query heads and over the query tiles that can see
//     its keys (from the tile's first key under `causal`, to its last key
//     + window - 1 under `window`), recomputes P and dS for the tile, and
//     accumulates dV and dK for its 64 keys in registers: the group's sum
//     stays inside the block, in a fixed order;
//   * dq: one block per (64 query rows, head, batch) loops over the key
//     tiles its rows can see (the forward's key range), recomputes P and
//     dS and accumulates dQ in registers.
//
// Two forms of them, chosen by dtype:
//
//   * bf16 (bwd_prep_mma, bwd_dkdv_mma, bwd_dq_mma): 4 warps a block,
//     each warp 16 of its 64 rows, tiles of 64 in shared memory as bf16
//     (loaded with cp.async), every product on mma.sync m16n8k16 with
//     fp32 sums; P^T and dS^T (dS in dq) go from a product's accumulator
//     straight into the next product's A registers, rounded to bf16 (P as
//     the plain forward rounds its weights to v's dtype);
//   * fp32 (bwd_prep, bwd_dkdv, bwd_dq): plain fp32 FMAs through shared
//     memory (the layout of flash_attention.cu's tiled kernel: 256
//     threads, each with 4 rows by 2 columns of a score tile and 4 rows
//     by D / 16 columns of an output), so the fp32 gradients carry no
//     rounding but the sums' order.
//
// No atomics: two runs give the same bits.  Every tensor is addressed by
// strides (elements; the head dimension contiguous; for bf16, 16-byte
// aligned rows, which the wrapper checks), so the model's [B, S, N, D]
// projections, their gradients and the [B, S, H, D] output gradient are
// read and written in place.  D in {64, 80, 96, 112, 128}.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/flash_attention.py loads it with ctypes).

#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr float kMasked = -1e30f;  // the forward's masked score
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 2 columns
constexpr int kRows = 64;      // query rows (prep, dq) or keys (dkdv) of a block
constexpr int kCols = 32;      // keys (prep, dq) or query rows (dkdv) of a tile
constexpr int kPP = kCols + 1;

struct View {  // one [B, N, S, D] tensor: base and strides (elements)
  const void* p;
  long long sb, sh, ss;
};

struct Args {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;    // [B, H, S]
  float* delta;  // [B, H, S]
  int H, KV, S;
  float scale;
  float softcap;  // <= 0: none
  int causal;
  int window;  // <= 0: none
};

template <typename T>
__device__ __forceinline__ const T* row0(const View& t, int b, int n) {
  return static_cast<const T*>(t.p) + b * t.sb + n * t.sh;
}

__device__ __forceinline__ bool visible(const Args& a, int qp, int kp) {
  return qp < a.S && kp < a.S && (!a.causal || kp <= qp) &&
         (a.window <= 0 || kp > qp - a.window);
}

// the capped score s and d s / d x (1 - tanh^2, or 1) of a dot product
__device__ __forceinline__ float capped(const Args& a, float dot, float* dsdx) {
  const float x = dot * a.scale;
  if (a.softcap > 0.0f) {
    const float t = tanhf(x / a.softcap);
    *dsdx = 1.0f - t * t;
    return a.softcap * t;
  }
  *dsdx = 1.0f;
  return x;
}

// rows [r0, r0 + n) of one head of t into s[n][ld] (zeros past S)
template <int D>
__device__ __forceinline__ void load_rows(float* s, int ld, const float* t, long long ss, int r0,
                                          int n, int S) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, c = e % D, i = r0 + r;
    s[r * ld + c] = i < S ? t[i * ss + c] : 0.0f;
  }
}

// The keys [lo, hi] that query rows [qa, qb] can see (flash_attention.cu's
// key_range; no row is empty here, as Sq == Sk and q_offset == 0).
__device__ __forceinline__ void key_range(const Args& a, int qa, int qb, int* lo, int* hi) {
  *lo = (a.window > 0 && qa - a.window + 1 > 0) ? qa - a.window + 1 : 0;
  *hi = (a.causal && qb < a.S - 1) ? qb : a.S - 1;
}

// the sum over the 16 lanes of a half-warp (the lanes of one ty)
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// ------------------------------------------------------------------ prep
template <int D>
constexpr int prep_floats() {
  return kRows * (D + 1) + kCols * (D + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_prep(const Args a) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;           // [kRows][DP]
  float* sK = sQ + kRows * DP;  // [kCols][DP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / (a.H / a.KV);
  const float* Q = row0<float>(a.q, b, h);
  const float* K = row0<float>(a.k, b, kvh);
  const float* O = row0<float>(a.o, b, h);
  const float* dO = row0<float>(a.dout, b, h);
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;

  // delta = rowsum(dO * O), a row's columns over its 16 lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float part = 0.0f;
    if (row < a.S)
      for (int c = tx; c < D; c += 16)
        part = fmaf(dO[row * a.dout.ss + c], O[row * a.o.ss + c], part);
    part = half_sum(part);
    if (tx == 0 && row < a.S) a.delta[stat + row] = part;
  }

  load_rows<D>(sQ, DP, Q, a.q.ss, q0, kRows, a.S);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
  }
  const int q_last = (q0 + kRows < a.S ? q0 + kRows : a.S) - 1;
  int lo, hi;
  key_range(a, q0, q_last, &lo, &hi);
  for (int k0 = (lo / kCols) * kCols; k0 <= hi; k0 += kCols) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(sK, DP, K, a.k.ss, k0, kCols, a.S);
    __syncthreads();
    float s[4][2] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0v = sK[tx * DP + d], k1v = sK[(tx + 16) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sQ[(ty * 4 + i) * DP + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        float unused;
        // a key past S is no key: -inf gives it weight exactly 0
        s[i][jj] = kp >= a.S ? -INFINITY
                   : visible(a, qp, kp) ? capped(a, s[i][jj], &unused) : kMasked;
      }
      const float m_new = fmaxf(m[i], half_max(fmaxf(s[i][0], s[i][1])));
      const float rs = half_sum(expf(s[i][0] - m_new) + expf(s[i][1] - m_new));
      l[i] = l[i] * expf(m[i] - m_new) + rs;
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < a.S) a.lse[stat + row] = m[i] + logf(l[i]);
  }
}

// P and dS of one score tile entry
__device__ __forceinline__ void p_ds(const Args& a, bool vis, float dot, float dp, float lse,
                                     float delta, float* p_out, float* ds_out) {
  if (!vis) {
    *p_out = 0.0f;
    *ds_out = 0.0f;
    return;
  }
  float dsdx;
  const float s = capped(a, dot, &dsdx);
  const float p = expf(s - lse);
  *p_out = p;
  *ds_out = p * (dp - delta) * dsdx;
}

// ------------------------------------------------------------------ dk, dv
template <int D>
constexpr int dkdv_floats() {
  return 2 * kRows * D + 2 * kCols * (D + 1) + 2 * kRows * kPP + 2 * kCols;
}

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dkdv(const Args a) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sK = smem;               // [kRows][D]: this block's keys
  float* sV = sK + kRows * D;     // [kRows][D]
  float* sQ = sV + kRows * D;     // [kCols][DP]: a query tile
  float* sdO = sQ + kCols * DP;   // [kCols][DP]
  float* sP = sdO + kCols * DP;   // [kRows][kPP]: P^T
  float* sS = sP + kRows * kPP;   // [kRows][kPP]: dS^T
  float* sL = sS + kRows * kPP;   // [kCols]: the tile's lse
  float* sD = sL + kCols;         // [kCols]: the tile's delta
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kRows;
  const int G = a.H / a.KV;

  load_rows<D>(sK, D, row0<float>(a.k, b, kvh), a.k.ss, k0, kRows, a.S);
  load_rows<D>(sV, D, row0<float>(a.v, b, kvh), a.v.ss, k0, kRows, a.S);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  // the query rows that can see keys [k0, k_last]
  const int k_last = (k0 + kRows < a.S ? k0 + kRows : a.S) - 1;
  const int q_lo = a.causal ? k0 : 0;
  int q_hi = a.S - 1;
  if (a.window > 0 && k_last + a.window - 1 < q_hi) q_hi = k_last + a.window - 1;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* Q = row0<float>(a.q, b, h);
    const float* dO = row0<float>(a.dout, b, h);
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;
    for (int t0 = (q_lo / kCols) * kCols; t0 <= q_hi; t0 += kCols) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<D>(sQ, DP, Q, a.q.ss, t0, kCols, a.S);
      load_rows<D>(sdO, DP, dO, a.dout.ss, t0, kCols, a.S);
      if (threadIdx.x < kCols) {
        const int r = t0 + threadIdx.x;
        sL[threadIdx.x] = r < a.S ? a.lse[stat + r] : 0.0f;
        sD[threadIdx.x] = r < a.S ? a.delta[stat + r] : 0.0f;
      }
      __syncthreads();
      // S^T and dP^T for 4 keys x 2 query rows a thread
      float s[4][2] = {}, dp[4][2] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float q0v = sQ[tx * DP + d], q1v = sQ[(tx + 16) * DP + d];
        const float o0v = sdO[tx * DP + d], o1v = sdO[(tx + 16) * DP + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kv = sK[(ty * 4 + i) * D + d], vv = sV[(ty * 4 + i) * D + d];
          s[i][0] = fmaf(kv, q0v, s[i][0]);
          s[i][1] = fmaf(kv, q1v, s[i][1]);
          dp[i][0] = fmaf(vv, o0v, dp[i][0]);
          dp[i][1] = fmaf(vv, o1v, dp[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = tx + 16 * jj, qp = t0 + c;
          float p, ds;
          p_ds(a, visible(a, qp, kp), s[i][jj], dp[i][jj], sL[c], sD[c], &p, &ds);
          sP[(ty * 4 + i) * kPP + c] = p;
          sS[(ty * 4 + i) * kPP + c] = ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kCols; ++r) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[(ty * 4 + i) * kPP + r];
          sv[i] = sS[(ty * 4 + i) * kPP + r];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = sdO[r * DP + tx + 16 * c], qv = sQ[r * DP + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][c] = fmaf(pv[i], ov, dv[i][c]);
            dk[i][c] = fmaf(sv[i], qv, dk[i][c]);
          }
        }
      }
    }
  }

  float* dK = static_cast<float*>(const_cast<void*>(a.dk.p)) + b * a.dk.sb + kvh * a.dk.sh;
  float* dV = static_cast<float*>(const_cast<void*>(a.dv.p)) + b * a.dv.sb + kvh * a.dv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= a.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dK[kp * a.dk.ss + tx + 16 * c] = dk[i][c] * a.scale;
      dV[kp * a.dv.ss + tx + 16 * c] = dv[i][c];
    }
  }
}

// ------------------------------------------------------------------ dq
template <int D>
constexpr int dq_floats() {
  return 2 * kRows * (D + 1) + 2 * kCols * (D + 1) + kRows * kPP + 2 * kRows;
}

template <int D>
__global__ void __launch_bounds__(kThreads) bwd_dq(const Args a) {
  constexpr int DP = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;               // [kRows][DP]
  float* sdO = sQ + kRows * DP;   // [kRows][DP]
  float* sK = sdO + kRows * DP;   // [kCols][DP]: a key tile
  float* sV = sK + kCols * DP;    // [kCols][DP]
  float* sS = sV + kCols * DP;    // [kRows][kPP]: dS
  float* sL = sS + kRows * kPP;   // [kRows]
  float* sD = sL + kRows;         // [kRows]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kvh = h / (a.H / a.KV);
  const float* K = row0<float>(a.k, b, kvh);
  const float* V = row0<float>(a.v, b, kvh);
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;

  load_rows<D>(sQ, DP, row0<float>(a.q, b, h), a.q.ss, q0, kRows, a.S);
  load_rows<D>(sdO, DP, row0<float>(a.dout, b, h), a.dout.ss, q0, kRows, a.S);
  if (threadIdx.x < kRows) {
    const int r = q0 + threadIdx.x;
    sL[threadIdx.x] = r < a.S ? a.lse[stat + r] : 0.0f;
    sD[threadIdx.x] = r < a.S ? a.delta[stat + r] : 0.0f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;

  const int q_last = (q0 + kRows < a.S ? q0 + kRows : a.S) - 1;
  int lo, hi;
  key_range(a, q0, q_last, &lo, &hi);
  for (int k0 = (lo / kCols) * kCols; k0 <= hi; k0 += kCols) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(sK, DP, K, a.k.ss, k0, kCols, a.S);
    load_rows<D>(sV, DP, V, a.v.ss, k0, kCols, a.S);
    __syncthreads();
    float s[4][2] = {}, dp[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0v = sK[tx * DP + d], k1v = sK[(tx + 16) * DP + d];
      const float v0v = sV[tx * DP + d], v1v = sV[(tx + 16) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sQ[(ty * 4 + i) * DP + d], ov = sdO[(ty * 4 + i) * DP + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
        dp[i][0] = fmaf(ov, v0v, dp[i][0]);
        dp[i][1] = fmaf(ov, v1v, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        float p, ds;
        p_ds(a, visible(a, q0 + r, kp), s[i][jj], dp[i][jj], sL[r], sD[r], &p, &ds);
        sS[r * kPP + tx + 16 * jj] = ds;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kCols; ++j) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty * 4 + i) * kPP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[j * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
      }
    }
  }

  float* dQ = static_cast<float*>(const_cast<void*>(a.dq.p)) + b * a.dq.sb + h * a.dq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) dQ[row * a.dq.ss + tx + 16 * c] = acc[i][c] * a.scale;
  }
}


// ------------------------------------------------------- bf16: mma.sync
// The same three kernels for bf16 on the tensor cores: 4 warps a block,
// each warp 16 rows of the block's 64 (queries for prep and dq, keys for
// dkdv); the tiles sit in shared memory as bf16 (rows padded by 16
// bytes, so ldmatrix reads them without bank conflicts), loaded with
// cp.async; every product is mma.sync m16n8k16 with fp32 sums.  A score
// tile's accumulator becomes the A operand of the next product in
// registers (P^T or dS^T against dO or Q; dS against K), rounded to bf16
// as the products take it.
constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;  // rows of a block and of a tile of the other side
using bf16 = __nv_bfloat16;

template <int D>
__host__ __device__ constexpr int mma_ld() {
  return D + 8;
}

// rows [r0, r0 + 64) of one head (row stride ss) into s[64][LD] with
// cp.async, zeros past S
template <int D>
__device__ __forceinline__ void async_rows(bf16* s, const bf16* t, long long ss, int r0, int S) {
  constexpr int LD = mma_ld<D>(), CH = D / 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < kMmaRows * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH, i = r0 + r;
    const bool in = i < S;
    sm90::cp_async16(s + r * LD + c * 8, t + (in ? i : 0) * ss + c * 8, in ? 16 : 0);
  }
}

// the A fragment of the 16 x 16 block at (r0, c0) of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&f)[4], const bf16* s, int r0, int c0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  sm90::ldmatrix_x4(f, s + (r0 + (l & 7) + 8 * (mi & 1)) * LD + c0 + 8 * (mi >> 1));
}

// B fragments of the n8 tiles n0 and n0 + 8 at k0, from an [n][k] tile:
// f[0], f[1] for the first, f[2], f[3] for the second
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&f)[4], const bf16* s, int n0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  sm90::ldmatrix_x4(f, s + (n0 + (l & 7) + 8 * (mi >> 1)) * LD + k0 + 8 * (mi & 1));
}

// the same from a [k][n] tile (a transposed load)
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&f)[4], const bf16* s, int k0, int n0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  sm90::ldmatrix_x4_trans(f, s + (k0 + (l & 7) + 8 * (mi & 1)) * LD + n0 + 8 * (mi >> 1));
}

// acc[NT][4] (+)= A rows (r0, 16 of them) of sa . B^T over k = D, where
// B's rows (n) are n0 .. n0 + 8 NT of sb: both tiles [rows][D]
template <int D, int NT>
__device__ __forceinline__ void mma_rows(float (&acc)[NT][4], const bf16* sa, int r0,
                                         const bf16* sb, int n0) {
  constexpr int LD = mma_ld<D>();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    frag_a<LD>(af, sa, r0, 16 * kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      frag_b<LD>(bf, sb, n0 + 16 * np, 16 * kk);
      sm90::mma_bf16_16816(acc[2 * np], af, bf[0], bf[1]);
      sm90::mma_bf16_16816(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[D / 8][4] += A (registers: 2 k-steps over 32 rows of sb) . sb rows
// k0 .. k0 + 31, all D columns
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const uint32_t (&a)[2][4],
                                        const bf16* sb, int k0) {
  constexpr int LD = mma_ld<D>();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      frag_bt<LD>(bf, sb, k0 + 16 * kk, 16 * np);
      sm90::mma_bf16_16816(acc[2 * np], a[kk], bf[0], bf[1]);
      sm90::mma_bf16_16816(acc[2 * np + 1], a[kk], bf[2], bf[3]);
    }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// delta = rowsum(dO * O) of rows [q0, q0 + 64): each warp 16 rows
__device__ __forceinline__ void delta_rows(const Args& a, const bf16* O, const bf16* dO,
                                           long long stat, int q0, int D) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + 16 * w + r;
    float part = 0.0f;
    if (row < a.S)
      for (int c = l; c < D; c += 32)
        part = fmaf(__bfloat162float(dO[row * a.dout.ss + c]),
                    __bfloat162float(O[row * a.o.ss + c]), part);
    part = warp_sum(part);
    if (l == 0 && row < a.S) a.delta[stat + row] = part;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_prep_mma(const Args a) {
  constexpr int LD = mma_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* sK = sQ + kMmaRows * LD;                  // [64][LD]
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31, g = l >> 2, tq = l & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kMmaRows;
  const int kvh = h / (a.H / a.KV);
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;
  async_rows<D>(sQ, row0<bf16>(a.q, b, h), a.q.ss, q0, a.S);
  sm90::cp_async_commit();
  delta_rows(a, row0<bf16>(a.o, b, h), row0<bf16>(a.dout, b, h), stat, q0, D);
  const bf16* K = row0<bf16>(a.k, b, kvh);

  float m[2] = {kMasked, kMasked}, lsum[2] = {0.0f, 0.0f};
  const int q_last = (q0 + kMmaRows < a.S ? q0 + kMmaRows : a.S) - 1;
  int lo, hi;
  key_range(a, q0, q_last, &lo, &hi);
  for (int k0 = (lo / kMmaRows) * kMmaRows; k0 <= hi; k0 += kMmaRows) {
    __syncthreads();  // the previous tile's readers are done
    async_rows<D>(sK, K, a.k.ss, k0, a.S);
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();
    float s[8][4] = {};
    mma_rows<D, 8>(s, sQ, 16 * w, sK, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qp = q0 + 16 * w + g + 8 * i;
      float t = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * j + 2 * tq + e;
          float unused, v = s[j][2 * i + e];
          v = kp >= a.S ? -INFINITY : visible(a, qp, kp) ? capped(a, v, &unused) : kMasked;
          s[j][2 * i + e] = v;
          t = fmaxf(t, v);
        }
      const float m_new = fmaxf(m[i], quad_max(t));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) rs += expf(s[j][2 * i] - m_new) + expf(s[j][2 * i + 1] - m_new);
      lsum[i] = lsum[i] * expf(m[i] - m_new) + quad_sum(rs);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * w + g + 8 * i;
    if (tq == 0 && row < a.S) a.lse[stat + row] = m[i] + logf(lsum[i]);
  }
}

// P and dS of a 16 x 32 score tile (rows r, columns c), packed as the A
// fragments of two k-steps over its 32 columns: s and dp are the tile's
// scores and dO . v products in accumulator layout; qpos/kpos give the
// query and key position of (row half i, column); lse and delta come
// from shared memory by the query's index in its tile
template <bool KEY_ROWS>
__device__ __forceinline__ void p_ds_frags(const Args& a, const float (&s)[4][4],
                                           const float (&dp)[4][4], int row0, int col0,
                                           const float* sL, const float* sD, int stat_row0,
                                           int stat_col0, uint32_t (&pa)[2][4],
                                           uint32_t (&sa)[2][4]) {
  const int l = threadIdx.x & 31, g = l >> 2, tq = l & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float p[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + g + 8 * i, c = col0 + 8 * j + 2 * tq + e;
        // KEY_ROWS: rows are keys and columns queries (dk, dv); else the
        // rows are queries (dq)
        const int qp = KEY_ROWS ? c : r, kp = KEY_ROWS ? r : c;
        const int qi = KEY_ROWS ? stat_col0 + 8 * j + 2 * tq + e : stat_row0 + g + 8 * i;
        if (visible(a, qp, kp)) {
          float dsdx;
          const float sc = capped(a, s[j][2 * i + e], &dsdx);
          p[e] = expf(sc - sL[qi]);
          ds[e] = p[e] * (dp[j][2 * i + e] - sD[qi]) * dsdx;
        } else {
          p[e] = ds[e] = 0.0f;
        }
      }
      pa[j >> 1][(j & 1) * 2 + i] = sm90::pack_bf16(p[0], p[1]);
      sa[j >> 1][(j & 1) * 2 + i] = sm90::pack_bf16(ds[0], ds[1]);
    }
}

// rows (r0 + g, + 8) of acc [16 x D] scaled, as bf16 pairs into t
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], const View& t, int b,
                                           int n, int r0, int S, float scale) {
  const int l = threadIdx.x & 31, g = l >> 2, tq = l & 3;
  bf16* base = static_cast<bf16*>(const_cast<void*>(t.p)) + b * t.sb + n * t.sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(base + row * t.ss + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkdv_mma(const Args a) {
  constexpr int LD = mma_ld<D>(), NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]: this block's keys
  bf16* sV = sK + kMmaRows * LD;
  bf16* sQ = sV + kMmaRows * LD;                  // a query tile
  bf16* sdO = sQ + kMmaRows * LD;
  float* sL = reinterpret_cast<float*>(sdO + kMmaRows * LD);  // [64]
  float* sD = sL + kMmaRows;                                  // [64]
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kMmaRows;
  const int G = a.H / a.KV, kr = 16 * w;
  async_rows<D>(sK, row0<bf16>(a.k, b, kvh), a.k.ss, k0, a.S);
  async_rows<D>(sV, row0<bf16>(a.v, b, kvh), a.v.ss, k0, a.S);
  sm90::cp_async_commit();

  float dk[NT][4] = {}, dv[NT][4] = {};
  const int k_last = (k0 + kMmaRows < a.S ? k0 + kMmaRows : a.S) - 1;
  const int q_lo = a.causal ? k0 : 0;
  int q_hi = a.S - 1;
  if (a.window > 0 && k_last + a.window - 1 < q_hi) q_hi = k_last + a.window - 1;
  for (int gh = 0; gh < G; ++gh) {
    const int h = kvh * G + gh;
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;
    for (int t0 = (q_lo / kMmaRows) * kMmaRows; t0 <= q_hi; t0 += kMmaRows) {
      __syncthreads();  // the previous tile's readers are done
      async_rows<D>(sQ, row0<bf16>(a.q, b, h), a.q.ss, t0, a.S);
      async_rows<D>(sdO, row0<bf16>(a.dout, b, h), a.dout.ss, t0, a.S);
      sm90::cp_async_commit();
      if (threadIdx.x < kMmaRows) {
        const int r = t0 + threadIdx.x;
        sL[threadIdx.x] = r < a.S ? a.lse[stat + r] : 0.0f;
        sD[threadIdx.x] = r < a.S ? a.delta[stat + r] : 0.0f;
      }
      sm90::cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c0 = 32 * half;
        float s[4][4] = {}, dp[4][4] = {};
        mma_rows<D, 4>(s, sK, kr, sQ, c0);
        mma_rows<D, 4>(dp, sV, kr, sdO, c0);
        uint32_t pa[2][4], sa[2][4];
        p_ds_frags<true>(a, s, dp, k0 + kr, t0 + c0, sL, sD, 0, c0, pa, sa);
        mma_acc<D>(dv, pa, sdO, c0);
        mma_acc<D>(dk, sa, sQ, c0);
      }
    }
  }
  store_rows<D>(dk, a.dk, b, kvh, k0 + kr, a.S, a.scale);
  store_rows<D>(dv, a.dv, b, kvh, k0 + kr, a.S, 1.0f);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma(const Args a) {
  constexpr int LD = mma_ld<D>(), NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]: this block's queries
  bf16* sdO = sQ + kMmaRows * LD;
  bf16* sK = sdO + kMmaRows * LD;                 // a key tile
  bf16* sV = sK + kMmaRows * LD;
  float* sL = reinterpret_cast<float*>(sV + kMmaRows * LD);  // [64]
  float* sD = sL + kMmaRows;                                 // [64]
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kMmaRows;
  const int kvh = h / (a.H / a.KV), qr = 16 * w;
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.S;
  async_rows<D>(sQ, row0<bf16>(a.q, b, h), a.q.ss, q0, a.S);
  async_rows<D>(sdO, row0<bf16>(a.dout, b, h), a.dout.ss, q0, a.S);
  sm90::cp_async_commit();
  if (threadIdx.x < kMmaRows) {
    const int r = q0 + threadIdx.x;
    sL[threadIdx.x] = r < a.S ? a.lse[stat + r] : 0.0f;
    sD[threadIdx.x] = r < a.S ? a.delta[stat + r] : 0.0f;
  }
  const bf16* K = row0<bf16>(a.k, b, kvh);
  const bf16* V = row0<bf16>(a.v, b, kvh);

  float dq[NT][4] = {};
  const int q_last = (q0 + kMmaRows < a.S ? q0 + kMmaRows : a.S) - 1;
  int lo, hi;
  key_range(a, q0, q_last, &lo, &hi);
  for (int k0 = (lo / kMmaRows) * kMmaRows; k0 <= hi; k0 += kMmaRows) {
    __syncthreads();  // the previous tile's readers are done
    async_rows<D>(sK, K, a.k.ss, k0, a.S);
    async_rows<D>(sV, V, a.v.ss, k0, a.S);
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      float s[4][4] = {}, dp[4][4] = {};
      mma_rows<D, 4>(s, sQ, qr, sK, c0);
      mma_rows<D, 4>(dp, sdO, qr, sV, c0);
      uint32_t pa[2][4], sa[2][4];
      p_ds_frags<false>(a, s, dp, q0 + qr, k0 + c0, sL, sD, qr, 0, pa, sa);
      mma_acc<D>(dq, sa, sK, c0);
    }
  }
  store_rows<D>(dq, a.dq, b, h, q0 + qr, a.S, a.scale);
}

// ------------------------------------------------------------- dispatch
template <typename K>
cudaError_t smem_opt_in(K kernel, int bytes) {
  // the opt-in to more than 48 KB of dynamic shared memory (per device, so
  // it is set on every launch)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_fma(const Args& a, int B, cudaStream_t stream) {
  constexpr int prep_bytes = prep_floats<D>() * static_cast<int>(sizeof(float));
  constexpr int dkdv_bytes = dkdv_floats<D>() * static_cast<int>(sizeof(float));
  constexpr int dq_bytes = dq_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = smem_opt_in(bwd_prep<D>, prep_bytes);
  if (err == cudaSuccess) err = smem_opt_in(bwd_dkdv<D>, dkdv_bytes);
  if (err == cudaSuccess) err = smem_opt_in(bwd_dq<D>, dq_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.S + kRows - 1) / kRows;
  bwd_prep<D><<<dim3(tiles, a.H, B), kThreads, prep_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv<D><<<dim3(tiles, a.KV, B), kThreads, dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<D><<<dim3(tiles, a.H, B), kThreads, dq_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  constexpr int tile = kMmaRows * mma_ld<D>() * static_cast<int>(sizeof(bf16));
  constexpr int prep_bytes = 2 * tile;
  constexpr int bytes = 4 * tile + 2 * kMmaRows * static_cast<int>(sizeof(float));
  cudaError_t err = smem_opt_in(bwd_dkdv_mma<D>, bytes);
  if (err == cudaSuccess) err = smem_opt_in(bwd_dq_mma<D>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.S + kMmaRows - 1) / kMmaRows;
  bwd_prep_mma<D><<<dim3(tiles, a.H, B), kMmaThreads, prep_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_mma<D><<<dim3(tiles, a.KV, B), kMmaThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_mma<D><<<dim3(tiles, a.H, B), kMmaThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// fp32 on the FMA kernels; bf16 on mma.sync
template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_mma<D>(a, B, stream);
  } else {
    return launch_fma<D>(a, B, stream);
  }
}

template <typename T>
int dispatch(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, stream);
    case 80: return launch<T, 80>(a, B, stream);
    case 96: return launch<T, 96>(a, B, stream);
    case 112: return launch<T, 112>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Launches the three backward kernels on `stream`; returns
// cudaGetLastError() (0 = ok), -1 for a dtype other than 0 = float32 or
// 1 = bfloat16 and -2 for a head dimension other than 64, 80, 96, 112 or
// 128.  q, o, dout and dq are [B, H, S, D], k, v, dk and dv [B, KV, S, D]
// (H % KV == 0), device pointers addressed by the strides given
// (elements; the last dimension contiguous), all of one dtype; lse and
// delta are fp32 scratch of B * H * S values each.  softcap <= 0 and
// window <= 0 mean none.
int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, void* lse, void* delta,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int B, int H, int KV, int S, int D,
    float scale, float softcap, int causal, int window, int dtype, void* stream) {
  if (B == 0 || S == 0) return 0;
  const Args a{{q, q_sb, q_sh, q_ss},     {k, k_sb, k_sh, k_ss},
               {v, v_sb, v_sh, v_ss},     {o, o_sb, o_sh, o_ss},
               {dout, do_sb, do_sh, do_ss}, {dq, dq_sb, dq_sh, dq_ss},
               {dk, dk_sb, dk_sh, dk_ss}, {dv, dv_sb, dv_sh, dv_ss},
               static_cast<float*>(lse),  static_cast<float*>(delta),
               H, KV, S, scale, softcap, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return -1;
}

}  // extern "C"
