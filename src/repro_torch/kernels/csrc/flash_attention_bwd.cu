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
// lse is the forward's: flash_attention.cu's prefill kernels write each
// row's logsumexp when asked, in the natural domain (log sum_j exp(s_ij)),
// fp32, at lse[(b H + h) ls + i] with ls = S rounded up to 64 (so a tile
// of 64 rows is one aligned 256-byte copy; rows past S are never read
// unmasked).  The bf16 kernels work in the log2 domain of the forward's
// softmax: P = 2^(s log2 e - lse log2 e).  Nothing recomputes it.
//
// Launched in turn on the caller's stream:
//
//   * delta: delta_i = rowsum(dO_i * O_i) in fp32 into [B, H, ls] scratch
//     (zero past S), 8 lanes a row; bound by its bytes;
//   * dkdv: one block per key tile, KV head and batch.  It loops over the
//     group's H / KV query heads in order and over the query tiles that
//     can see its keys (from the tile's first key under `causal`, to its
//     last key + window - 1 under `window`), forms P^T and dS^T for the
//     tile and accumulates dV and dK for its keys in registers: the
//     group's sum stays inside the block, in a fixed order;
//   * dq: one block per query tile, head and batch loops over the key
//     tiles its rows can see (the forward's key range), forms dS and
//     accumulates dQ in registers.
//
// Two forms of dkdv and dq, chosen by dtype:
//
//   * bf16 (bwd_dkdv_wgmma, bwd_dq_wgmma): the forward's Hopper shape.
//     Bound by operations: 2.5 times the forward's 4 D flops per visible
//     pair (five products) at the 989 TFLOP/s bf16 rate; these kernels
//     form seven (S and dP twice, once a kernel, so no dS leaves the
//     chip and no dQ needs atomics), all on wgmma with fp32 sums.  A
//     block is two consumer warpgroups of 64 rows each (keys in dkdv,
//     queries in dq) and a producer warpgroup, which hands most of its
//     registers to the consumers (setmaxnreg: 232 a consumer thread, so
//     dK and dV stay in registers unspilled).  The producer's thread 0 loads
//     the block's own 128 rows once (K and V in dkdv, Q and dO in dq)
//     and streams the other side's 64-row tiles through a ring of
//     kStages stages with TMA (4-D tensor maps over the tensors' own
//     strides, 128-byte swizzle, zeros past the edges), each stage's
//     arrival counted on an mbarrier and its release on another; in dkdv
//     a stage also carries the query tile's lse and delta (two 256-byte
//     bulk copies).  dkdv: S^T = K Q^T and dP^T = V dO^T from shared
//     memory (both K-major); P^T and dS^T in registers (the mask, the
//     softcap's 1 - tanh^2, bf16 rounding, as the forward rounds P) are
//     at once the A operands of dV += P^T dO and dK += dS^T Q, whose B
//     (dO, Q) is read MN-major through the transpose flag.  dq: S = Q
//     K^T and dP = dO V^T, dS in registers, dQ += dS K with K read
//     MN-major.  Every warpgroup visits only the tiles its own rows see.
//     Under `causal` the blocks with the most tiles start first: key
//     tile 0 (which every later query sees) in dkdv, the last query
//     tile in dq.  D 80, 96 and 112 run the D = 128 layout over maps of
//     the true D (TMA fills the columns past it with zeros, which add
//     nothing; they are not stored), as the forward does;
//   * fp32 (bwd_dkdv, bwd_dq): plain fp32 FMAs through shared memory
//     (the layout of flash_attention.cu's tiled kernel: 256 threads,
//     each with 4 rows by 2 columns of a score tile and 4 rows by D / 16
//     columns of an output), so the fp32 gradients carry no rounding but
//     the sums' order.
//
// No atomics: two runs give the same bits.  Every tensor is addressed by
// strides (elements; the head dimension contiguous; for bf16, 16-byte
// aligned addresses and strides, which TMA needs and the wrapper checks),
// so the model's [B, S, N, D] projections, their gradients and the [B,
// S, H, D] output gradient are read and written in place.  D in {64, 80,
// 96, 112, 128}.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/flash_attention.py loads it with ctypes).

#include <math.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 2 columns
constexpr int kRows = 64;      // query rows (dq) or keys (dkdv) of a block
constexpr int kCols = 32;      // keys (dq) or query rows (dkdv) of a tile
constexpr int kPP = kCols + 1;

struct View {  // one [B, N, S, D] tensor: base and strides (elements)
  const void* p;
  long long sb, sh, ss;
};

struct Args {
  View q, k, v, o, dout, dq, dk, dv;
  const float* lse;  // [B, H, ls]: the forward's
  float* delta;      // [B, H, ls]
  int H, KV, S, D;
  int ls;  // the row stride of lse and delta: S rounded up to 64
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

// The query rows [lo, hi] that can see keys [ka, kb] (kb < S)
__device__ __forceinline__ void query_range(const Args& a, int ka, int kb, int* lo, int* hi) {
  *lo = a.causal ? ka : 0;
  *hi = (a.window > 0 && kb + a.window - 1 < a.S - 1) ? kb + a.window - 1 : a.S - 1;
}

// ----------------------------------------------------------------- delta
constexpr int kDeltaThreads = 256;  // 8 lanes a row, 32 rows a block

// delta[(b H + h) ls + i] = rowsum(dO_i * O_i) for i < S, 0 for S <= i < ls
template <typename T>
__global__ void __launch_bounds__(kDeltaThreads) bwd_delta(const Args a) {
  const int sub = threadIdx.x % 8;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int i = blockIdx.x * (kDeltaThreads / 8) + threadIdx.x / 8;
  float part = 0.0f;
  if (i < a.S) {
    const T* O = row0<T>(a.o, b, h) + i * a.o.ss;
    const T* dO = row0<T>(a.dout, b, h) + i * a.dout.ss;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      // 16-byte pieces (the wrapper checks bf16 rows' alignment)
      for (int c = 8 * sub; c < a.D; c += 64) {
        const uint4 ov = *reinterpret_cast<const uint4*>(O + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dO + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 of = __bfloat1622float2(o2[u]), df = __bfloat1622float2(d2[u]);
          part = fmaf(df.x, of.x, part);
          part = fmaf(df.y, of.y, part);
        }
      }
    } else {
      for (int c = sub; c < a.D; c += 8) part = fmaf(dO[c], O[c], part);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) part += __shfl_xor_sync(kFull, part, off);
  if (sub == 0 && i < a.ls) a.delta[static_cast<long long>(bh) * a.ls + i] = part;
}

// ------------------------------------------------------------------ fp32
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
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.ls;
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
  const long long stat = (static_cast<long long>(b) * a.H + h) * a.ls;

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



// ------------------------------------------------------------ bf16: wgmma
using bf16 = __nv_bfloat16;
constexpr int kGRows = 64;                 // rows of a consumer warpgroup
constexpr int kGroups = 2;                 // consumer warpgroups of a block
constexpr int kBRows = kGRows * kGroups;   // the block's own rows
constexpr int kTile = 64;                  // rows of a ring tile
constexpr int kStages = 3;                 // ring tiles in flight
constexpr int kWThreads = 128 * (kGroups + 1);  // and a producer warpgroup
// registers a thread: a block's 384 threads launch with 168 each; the
// producer warpgroup gives back all but 40, which lifts the consumers to
// 232 (dK and dV's 128 fp32 accumulators and two 64 x 64 score tiles)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx: relative error ~2^-22;
// 2^-inf = 0), as the forward's softmax
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the two kernels (D the layout's: 64 or 128): the
// block's own two operands ([halves][kBRows][64] each), then the ring;
// every tile 1024-byte aligned for the 128-byte swizzle.  A dkdv stage is
// Q and dO tiles and the tile's lse and delta (512 bytes, padded to
// 1024); a dq stage K and V tiles.
template <int D>
struct BLayout {
  static constexpr int kHalves = D / 64;
  static constexpr int kOwnBytes = kBRows * D * 2;
  static constexpr int kTileBytes = kTile * D * 2;
  static constexpr int kDkdvStage = 2 * kTileBytes + 1024;
  static constexpr int kDqStage = 2 * kTileBytes;
  static constexpr int kDkdvBar = 2 * kOwnBytes + kStages * kDkdvStage;
  static constexpr int kDqBar = 2 * kOwnBytes + kStages * kDqStage;
  // and 1024 bytes of room to align the tiles
  static constexpr int kDkdvBytes = 1024 + kDkdvBar + (1 + 2 * kStages) * 8;
  static constexpr int kDqBytes = 1024 + kDqBar + (1 + 2 * kStages) * 8;
};

// P (or P^T) and dS (or dS^T) of one 64 x 64 score tile in the
// accumulator layout of sm90.cuh, in place: sc holds the raw dot products
// and becomes P, dp holds dO . v and becomes dS.  l2 and dl give the
// logsumexp (log2 domain) and delta of element i's query.
template <bool CAP, typename LSE, typename DELTA>
__device__ __forceinline__ void tile_p_ds(const Args& a, float (&sc)[32], float (&dp)[32],
                                     LSE l2, DELTA dl) {
  const float scale2 = a.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float s2, dsdx = 1.0f;
    if constexpr (CAP) {
      const float t = tanhf(sc[i] * a.scale / a.softcap);
      s2 = a.softcap * kLog2e * t;
      dsdx = 1.0f - t * t;
    } else {
      s2 = sc[i] * scale2;
    }
    const float p = ex2(s2 - l2(i));
    sc[i] = p;
    dp[i] = p * (dp[i] - dl(i)) * dsdx;
  }
}

// the A operands of 4 k16 steps (64 columns of an accumulator) in bf16
__device__ __forceinline__ void pack_a(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) f[kk][q] = sm90::pack_bf16(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

// acc (+)= A . B over D for two 64-row operands in shared memory, both
// K-major ([halves][rows][64]): A's halves a_rows rows apart, B's b_rows
template <int D>
__device__ __forceinline__ void scores(float (&acc)[32], const uint8_t* sa, int a_rows,
                                       const uint8_t* sb, int b_rows) {
  using sm90::kAtomBytes;
  using sm90::kRowBytes;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int step = (kk % 4) * 32;  // k16 inside a 64-column half
    sm90::wgmma_ss_n64<0>(acc, sm90::desc(sa + (kk / 4) * a_rows * kRowBytes + step, 16, kAtomBytes),
                          sm90::desc(sb + (kk / 4) * b_rows * kRowBytes + step, 16, kAtomBytes),
                          kk > 0);
  }
}

// acc += A (registers: 4 k16 steps over 64 tile rows) . B, B a 64-row
// tile in shared memory read MN-major ([halves][64][64], D contiguous)
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                           const uint8_t* sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sm90::desc(sb + kk * 16 * sm90::kRowBytes, kTile * sm90::kRowBytes,
                                   sm90::kAtomBytes);
    if constexpr (D == 64) {
      sm90::wgmma_rs_n64<1>(acc, a[kk], db, 1);
    } else {
      sm90::wgmma_rs_n128<1>(acc, a[kk], db, 1);
    }
  }
}

// rows (r0, r0 + 8) of a warpgroup's accumulator [64 x D], times scale,
// as bf16 pairs into one head of t (rows past S and columns past the true
// D not stored)
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2], const View& t, int b, int n,
                                          int row0, int S, int true_d, float scale) {
  const int lane = threadIdx.x % 32, r0 = 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int c2 = 2 * (lane % 4);
  bf16* base = static_cast<bf16*>(const_cast<void*>(t.p)) + b * t.sb + n * t.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= true_d) break;
      *reinterpret_cast<__nv_bfloat162*>(base + row * t.ss + 8 * j + c2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap dmap, const Args a, int n_key_tiles) {
  using L = BLayout<D>;
  using sm90::kRowBytes;
  constexpr int kStageBytes = L::kDkdvStage;
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sK = base;  // [halves][kBRows][64]: this block's keys
  uint8_t* sV = sK + L::kOwnBytes;
  uint8_t* ring = sV + L::kOwnBytes;  // stages: Q, dO tiles, then lse and delta
  uint64_t* own_full = reinterpret_cast<uint64_t*>(base + L::kDkdvBar);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  // key tile slowest: under `causal` tile 0 (seen by every later query)
  // and the other long ones start first
  const int per_tile = gridDim.x / n_key_tiles;
  const int k0 = (blockIdx.x / per_tile) * kBRows;
  const int kvh = (blockIdx.x % per_tile) % a.KV, b = (blockIdx.x % per_tile) / a.KV;
  const int G = a.H / a.KV;
  int q_lo, q_hi;
  query_range(a, k0, min(k0 + kBRows, a.S) - 1, &q_lo, &q_hi);
  const int t_first = q_lo / kTile, n_t = q_hi / kTile - t_first + 1;
  const int n_iter = G * n_t;

  if (tid == 0) {
    sm90::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * kGroups);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128 * kGroups) {  // the producer warpgroup: its thread 0 starts every load
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kGroups) {
      sm90::mbar_expect_tx(own_full, 2 * L::kOwnBytes);
      for (int c = 0; c < L::kHalves; ++c) {
        sm90::tma_load_4d(sK + c * kBRows * kRowBytes, &kmap, own_full, 64 * c, k0, kvh, b);
        sm90::tma_load_4d(sV + c * kBRows * kRowBytes, &vmap, own_full, 64 * c, k0, kvh, b);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kStages;
        if (it >= kStages) sm90::mbar_wait(&empty[s], (it / kStages + 1) & 1);
        const int h = kvh * G + it / n_t, t0 = (t_first + it % n_t) * kTile;
        uint8_t* st = ring + s * kStageBytes;
        sm90::mbar_expect_tx(&full[s], 2 * L::kTileBytes + 2 * kTile * 4);
        for (int c = 0; c < L::kHalves; ++c) {
          sm90::tma_load_4d(st + c * kTile * kRowBytes, &qmap, &full[s], 64 * c, t0, h, b);
          sm90::tma_load_4d(st + L::kTileBytes + c * kTile * kRowBytes, &dmap, &full[s], 64 * c,
                            t0, h, b);
        }
        const long long stat = (static_cast<long long>(b) * a.H + h) * a.ls + t0;
        float* sst = reinterpret_cast<float*>(st + 2 * L::kTileBytes);
        sm90::bulk_load(sst, a.lse + stat, kTile * 4, &full[s]);
        sm90::bulk_load(sst + kTile, a.delta + stat, kTile * 4, &full[s]);
      }
    }
    return;
  }

  // consumer warpgroup g: keys kg0.. of the block; thread rows r0 and r0 +
  // 8, columns 8 j + c2 and + 1 of each accumulator (see sm90.cuh)
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int kg0 = k0 + g * kGRows;
  // the query tiles this warpgroup visits: those its own keys are seen by
  int g_first = t_first + n_t, g_last = -1;
  if (kg0 < a.S) {
    int lo, hi;
    query_range(a, kg0, min(kg0 + kGRows, a.S) - 1, &lo, &hi);
    g_first = lo / kTile;
    g_last = hi / kTile;
  }
  const uint8_t* sKg = sK + g * kGRows * kRowBytes;
  const uint8_t* sVg = sV + g * kGRows * kRowBytes;
  constexpr int NO = D / 2;
  float dk[NO], dv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.0f;
  sm90::mbar_wait(own_full, 0);

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % kStages;
    const int ti = t_first + it % n_t, t0 = ti * kTile;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);
    if (ti < g_first || ti > g_last) {
      sm90::mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* tQ = ring + s * kStageBytes;
    const uint8_t* tdO = tQ + L::kTileBytes;
    const float* sL = reinterpret_cast<const float*>(tdO + L::kTileBytes);
    const float* sD = sL + kTile;

    // S^T = K Q^T and dP^T = V dO^T: keys are the rows, queries the columns
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);
    sm90::wgmma_fence();
    scores<D>(st, sKg, kBRows, tQ, kTile);
    sm90::wgmma_commit();
    scores<D>(dpt, sVg, kBRows, tdO, kTile);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dpt);

    // element i's query is column 8 (i / 4) + c2 + i % 2 of the tile
    auto l2 = [&](int i) { return sL[8 * (i / 4) + c2 + i % 2] * kLog2e; };
    auto dl = [&](int i) { return sD[8 * (i / 4) + c2 + i % 2]; };
    if (a.softcap > 0.0f) {
      tile_p_ds<true>(a, st, dpt, l2, dl);
    } else {
      tile_p_ds<false>(a, st, dpt, l2, dl);
    }
    // masked element by element only where some pair of the tile is
    // masked: the diagonal, the window's edge, rows past S
    const bool edge = t0 + kTile > a.S || kg0 + kGRows > a.S ||
                      (a.causal && kg0 + kGRows - 1 > t0) ||
                      (a.window > 0 && kg0 <= t0 + kTile - 1 - a.window);
    if (edge) {
      const bool causal = a.causal != 0, windowed = a.window > 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = kg0 + r0 + 8 * ((i / 2) % 2);
        const int qp = t0 + 8 * (i / 4) + c2 + i % 2;
        const bool valid = (kp < a.S) & (qp < a.S) & (!causal | (kp <= qp)) &
                           (!windowed | (kp > qp - a.window));
        st[i] = valid ? st[i] : 0.0f;
        dpt[i] = valid ? dpt[i] : 0.0f;
      }
    }
    uint32_t pa[4][4], sa[4][4];
    pack_a(pa, st);
    pack_a(sa, dpt);

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      sm90::fence_regs(pa[kk]);
      sm90::fence_regs(sa[kk]);
    }
    sm90::wgmma_fence();
    accumulate<D>(dv, pa, tdO);
    sm90::wgmma_commit();
    accumulate<D>(dk, sa, tQ);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::mbar_arrive(&empty[s]);
  }
  store_acc<D>(dk, a.dk, b, kvh, kg0, a.S, a.D, a.scale);
  store_acc<D>(dv, a.dv, b, kvh, kg0, a.S, a.D, 1.0f);
}

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap dmap, const Args a, int n_q_tiles) {
  using L = BLayout<D>;
  using sm90::kRowBytes;
  constexpr int kStageBytes = L::kDqStage;
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = base;  // [halves][kBRows][64]: this block's queries
  uint8_t* sdO = sQ + L::kOwnBytes;
  uint8_t* ring = sdO + L::kOwnBytes;  // stages: K, V tiles
  uint64_t* own_full = reinterpret_cast<uint64_t*>(base + L::kDqBar);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  // query tile slowest and backwards: under `causal` the last tiles (which
  // see the most keys) start first
  const int per_tile = gridDim.x / n_q_tiles;
  const int q0 = (n_q_tiles - 1 - blockIdx.x / per_tile) * kBRows;
  const int h = (blockIdx.x % per_tile) % a.H, b = (blockIdx.x % per_tile) / a.H;
  const int kvh = h / (a.H / a.KV);
  int lo, hi;
  key_range(a, q0, min(q0 + kBRows, a.S) - 1, &lo, &hi);
  const int t_first = lo / kTile, n_t = hi / kTile - t_first + 1;

  if (tid == 0) {
    sm90::mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * kGroups);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128 * kGroups) {  // the producer warpgroup: its thread 0 starts every load
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == 128 * kGroups) {
      sm90::mbar_expect_tx(own_full, 2 * L::kOwnBytes);
      for (int c = 0; c < L::kHalves; ++c) {
        sm90::tma_load_4d(sQ + c * kBRows * kRowBytes, &qmap, own_full, 64 * c, q0, h, b);
        sm90::tma_load_4d(sdO + c * kBRows * kRowBytes, &dmap, own_full, 64 * c, q0, h, b);
      }
      for (int t = 0; t < n_t; ++t) {
        const int s = t % kStages;
        if (t >= kStages) sm90::mbar_wait(&empty[s], (t / kStages + 1) & 1);
        const int k0 = (t_first + t) * kTile;
        uint8_t* st = ring + s * kStageBytes;
        sm90::mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        for (int c = 0; c < L::kHalves; ++c) {
          sm90::tma_load_4d(st + c * kTile * kRowBytes, &kmap, &full[s], 64 * c, k0, kvh, b);
          sm90::tma_load_4d(st + L::kTileBytes + c * kTile * kRowBytes, &vmap, &full[s], 64 * c,
                            k0, kvh, b);
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int qg0 = q0 + g * kGRows, qmax = qg0 + kGRows - 1;
  int g_first = t_first + n_t, g_last = -1;
  float l2r[2] = {0.0f, 0.0f}, dlr[2] = {0.0f, 0.0f};
  if (qg0 < a.S) {
    int glo, ghi;
    key_range(a, qg0, min(qg0 + kGRows, a.S) - 1, &glo, &ghi);
    g_first = glo / kTile;
    g_last = ghi / kTile;
    // rows past S read lse's and delta's padding (ls >= qg0 + 64): their
    // dQ rows are not stored
    const long long stat = (static_cast<long long>(b) * a.H + h) * a.ls + qg0 + r0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l2r[r] = a.lse[stat + 8 * r] * kLog2e;
      dlr[r] = a.delta[stat + 8 * r];
    }
  }
  const uint8_t* sQg = sQ + g * kGRows * kRowBytes;
  const uint8_t* sdOg = sdO + g * kGRows * kRowBytes;
  constexpr int NO = D / 2;
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.0f;
  sm90::mbar_wait(own_full, 0);

  for (int t = 0; t < n_t; ++t) {
    const int s = t % kStages;
    const int tile = t_first + t, k0 = tile * kTile;
    sm90::mbar_wait(&full[s], (t / kStages) & 1);
    if (tile < g_first || tile > g_last) {
      sm90::mbar_arrive(&empty[s]);
      continue;
    }
    const uint8_t* tK = ring + s * kStageBytes;
    const uint8_t* tV = tK + L::kTileBytes;

    // S = Q K^T and dP = dO V^T: queries are the rows, keys the columns
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    scores<D>(sc, sQg, kBRows, tK, kTile);
    sm90::wgmma_commit();
    scores<D>(dp, sdOg, kBRows, tV, kTile);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    sm90::fence_regs(dp);

    // element i's query is row r0 + 8 ((i / 2) % 2)
    auto l2 = [&](int i) { return l2r[(i / 2) % 2]; };
    auto dl = [&](int i) { return dlr[(i / 2) % 2]; };
    if (a.softcap > 0.0f) {
      tile_p_ds<true>(a, sc, dp, l2, dl);
    } else {
      tile_p_ds<false>(a, sc, dp, l2, dl);
    }
    const bool edge = k0 + kTile > a.S || (a.causal && k0 + kTile - 1 > qg0) ||
                      (a.window > 0 && k0 <= qmax - a.window);
    if (edge) {
      const bool causal = a.causal != 0, windowed = a.window > 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qp = qg0 + r0 + 8 * ((i / 2) % 2);
        const int kp = k0 + 8 * (i / 4) + c2 + i % 2;
        const bool valid = (kp < a.S) & (!causal | (kp <= qp)) &
                           (!windowed | (kp > qp - a.window));
        dp[i] = valid ? dp[i] : 0.0f;
      }
    }
    uint32_t sa[4][4];
    pack_a(sa, dp);

    // dQ += dS K, K read MN-major
    sm90::fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(sa[kk]);
    sm90::wgmma_fence();
    accumulate<D>(dq, sa, tK);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dq);
    sm90::mbar_arrive(&empty[s]);
  }
  store_acc<D>(dq, a.dq, b, h, qg0, a.S, a.D, a.scale);
}

// ------------------------------------------------------------- dispatch
template <typename K>
cudaError_t smem_opt_in(K kernel, int bytes) {
  // the opt-in to more than 48 KB of dynamic shared memory (per device, so
  // it is set on every launch)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
cudaError_t launch_delta(const Args& a, int B, cudaStream_t stream) {
  bwd_delta<T><<<dim3(a.ls / (kDeltaThreads / 8), B * a.H), kDeltaThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
int launch_fma(const Args& a, int B, cudaStream_t stream) {
  constexpr int dkdv_bytes = dkdv_floats<D>() * static_cast<int>(sizeof(float));
  constexpr int dq_bytes = dq_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = smem_opt_in(bwd_dkdv<D>, dkdv_bytes);
  if (err == cudaSuccess) err = smem_opt_in(bwd_dq<D>, dq_bytes);
  if (err == cudaSuccess) err = launch_delta<float>(a, B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.S + kRows - 1) / kRows;
  bwd_dkdv<D><<<dim3(tiles, a.KV, B), kThreads, dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq<D><<<dim3(tiles, a.H, B), kThreads, dq_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// one [B, N, S, D] bf16 tensor as a 4-D tensor map (innermost first: the
// true D, rows, heads, batch) with its own strides, a box of 64 columns
// of `rows` rows of one head; a dimension of size 1 gets a packed stride
// (its coordinate is always 0)
int view_map(CUtensorMap* map, const View& t, int D, int S, int N, int B, int rows) {
  uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                      static_cast<uint64_t>(N), static_cast<uint64_t>(B)};
  uint64_t strides[3] = {static_cast<uint64_t>(t.ss) * 2, static_cast<uint64_t>(t.sh) * 2,
                         static_cast<uint64_t>(t.sb) * 2};
  for (int i = 1; i < 4; ++i)
    if (dims[i] == 1) strides[i - 1] = i == 1 ? dims[0] * 2 : strides[i - 2] * dims[i - 1];
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return sm90_host::make_map(map, t.p, 4, dims, strides, box);
}

// D is the layout's (64 or 128); the maps cover the true a.D
template <int D>
int launch_wgmma(const Args& a, int B, cudaStream_t stream) {
  using L = BLayout<D>;
  // dkdv: K and V 128-row boxes, Q and dO 64-row tiles; dq the other way
  CUtensorMap qt, dt, kb, vb, qb, db, kt, vt;
  int err = view_map(&qt, a.q, a.D, a.S, a.H, B, kTile);
  if (err == 0) err = view_map(&dt, a.dout, a.D, a.S, a.H, B, kTile);
  if (err == 0) err = view_map(&kb, a.k, a.D, a.S, a.KV, B, kBRows);
  if (err == 0) err = view_map(&vb, a.v, a.D, a.S, a.KV, B, kBRows);
  if (err == 0) err = view_map(&qb, a.q, a.D, a.S, a.H, B, kBRows);
  if (err == 0) err = view_map(&db, a.dout, a.D, a.S, a.H, B, kBRows);
  if (err == 0) err = view_map(&kt, a.k, a.D, a.S, a.KV, B, kTile);
  if (err == 0) err = view_map(&vt, a.v, a.D, a.S, a.KV, B, kTile);
  if (err != 0) return err;
  constexpr int dkdv_bytes = L::kDkdvBytes;
  constexpr int dq_bytes = L::kDqBytes;
  cudaError_t e = smem_opt_in(bwd_dkdv_wgmma<D>, dkdv_bytes);
  if (e == cudaSuccess) e = smem_opt_in(bwd_dq_wgmma<D>, dq_bytes);
  if (e == cudaSuccess) e = launch_delta<bf16>(a, B, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = (a.S + kBRows - 1) / kBRows;
  bwd_dkdv_wgmma<D><<<tiles * a.KV * B, kWThreads, dkdv_bytes, stream>>>(qt, kb, vb, dt, a,
                                                                         tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_wgmma<D><<<tiles * a.H * B, kWThreads, dq_bytes, stream>>>(qb, kt, vt, db, a, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, int D, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    // D 80, 96 and 112 run the 128-column layout over maps of the true D
    switch (D) {
      case 64: return launch_wgmma<64>(a, B, stream);
      case 80:
      case 96:
      case 112:
      case 128: return launch_wgmma<128>(a, B, stream);
      default: return -2;
    }
  } else {
    switch (D) {
      case 64: return launch_fma<64>(a, B, stream);
      case 80: return launch_fma<80>(a, B, stream);
      case 96: return launch_fma<96>(a, B, stream);
      case 112: return launch_fma<112>(a, B, stream);
      case 128: return launch_fma<128>(a, B, stream);
      default: return -2;
    }
  }
}

}  // namespace

extern "C" {

// Launches the backward kernels on `stream`; returns cudaGetLastError()
// (0 = ok), -1 for a dtype other than 0 = float32 or 1 = bfloat16, -2 for
// a head dimension other than 64, 80, 96, 112 or 128 or an lse stride
// that is not S rounded up to 64, and -3 or -4 when a TMA tensor map
// cannot be made (bf16).  q, o, dout and dq are [B, H, S, D], k, v, dk
// and dv [B, KV, S, D] (H % KV == 0), device pointers addressed by the
// strides given (elements; the last dimension contiguous), all of one
// dtype; lse is the forward's logsumexp and delta fp32 scratch, both [B,
// H, ls] with ls = S rounded up to 64.  softcap <= 0 and window <= 0 mean
// none.
int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, const void* lse, void* delta, int ls,
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
  if (ls != (S + 63) / 64 * 64) return -2;
  const Args a{{q, q_sb, q_sh, q_ss},     {k, k_sb, k_sh, k_ss},
               {v, v_sb, v_sh, v_ss},     {o, o_sb, o_sh, o_ss},
               {dout, do_sb, do_sh, do_ss}, {dq, dq_sb, dq_sh, dq_ss},
               {dk, dk_sb, dk_sh, dk_ss}, {dv, dv_sb, dv_sh, dv_ss},
               static_cast<const float*>(lse), static_cast<float*>(delta),
               H, KV, S, D, ls, scale, softcap, causal, window};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return -1;
}

}  // extern "C"
