// Attention forward with an online softmax, for prefill and for decode.
//
// Replaces the TPU kernel repro.kernels.flash_attention.flash_attention
// (Pallas body `_kernel`, src/repro/kernels/flash_attention.py), with the
// padding plumbing of repro.kernels.ops.flash_attention.  For each batch
// b, query head h and query row i:
//
//   s_j  = softcap(scale * q_i . k_j)          (tanh cap, when asked)
//   s_j  = -1e30 where key j is masked         (the TPU kernel's NEG_INF)
//   o_i  = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
//
// with q_pos = i + q_offset, k_pos = j, `causal` keeping k_pos <= q_pos
// and `window` keeping k_pos > q_pos - window.  m, l and the output sum
// are carried in fp32 over key tiles, as the TPU kernel carries them over
// its sequential KV grid axis; q, k and v are fp32 or bf16 and are
// converted to fp32 on load, so p . v is an fp32 product as in the TPU
// kernel (which upcasts v), not a product of bf16-rounded weights as in
// the XLA path (repro.models.layers._attend rounds p to v's dtype).
// Query head h reads KV head h / (H / KV): the TPU kernel takes K and V
// already repeated to H heads, this one reads the grouped heads itself,
// which is the same function and reads the KV cache once per group.
//
// Masking.  A key tile with no valid key for any row of the block is
// skipped: tiles past the causal edge and tiles before the window.  The
// result is the same as visiting them: a fully masked tile before the
// first valid key adds exp(0) terms that the correction exp(-1e30 - m)
// then sets to exactly 0, and one after it adds exp(-1e30 - m) = 0.  A
// row with no valid key at all (only when q_pos - window + 1 > Sk - 1)
// gets, as in the TPU kernel, the mean of v over all Sk keys; a block
// holding such a row visits every key tile.
//
// Two kernels, both plain fp32 FMA code (no tensor cores):
//
//   * tiled (prefill, any Sq): one block per (64 query rows, head, batch),
//     256 threads; Q, K, V and P tiles staged in shared memory as fp32;
//     each thread computes a 4x2 block of scores and a 4x(D/16) block of
//     the output.  Prefill is bound by operations: the least time on an
//     H100 is its 4*D flops per unmasked (q, k) pair at the 989 TFLOP/s
//     bf16 dense tensor-core rate, which fp32 FMAs (67 TFLOP/s) cannot
//     approach; skipping the tiles past the causal edge halves the work.
//     wgmma on bf16 tiles, with TMA loads, is the later speed-up.
//   * decode (Sq == 1, D in {64, 96, 128}): one block per (KV head, batch,
//     group of up to GC query heads), 8 warps.  Decode is bound by bytes:
//     the least time is the K and V positions it must read (0..q_pos, or
//     the window) at 3.35 TB/s.  The block reads each cached position
//     once for all the query heads of its group; warps take 4 keys at a
//     time (several loads in flight), lanes split the head dimension
//     (coalesced rows: lane + 32*e), and partial (m, l, acc) of the warps
//     are merged through shared memory at the end.  Only B * KV blocks
//     run (64 at the serving shape): splitting the keys over more blocks
//     is the later speed-up.
//
// q, k, v and o are addressed by strides (elements; the head dimension is
// contiguous), so the model's [B, S, N, D] projections and the [B, Smax,
// KV, D] cache are read in place.  The arithmetic uses expf and tanhf and
// IEEE division (no fast math).
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/flash_attention.py loads it with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // strides in elements: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, KV, Sq, Sk;
  float scale;
  float softcap;  // <= 0: none
  int causal;
  int window;  // <= 0: none
  int q_offset;
};

__device__ __forceinline__ bool key_valid(const Args& a, int qp, int kp) {
  return (!a.causal || kp <= qp) && (a.window <= 0 || kp > qp - a.window);
}

__device__ __forceinline__ float cap(const Args& a, float dot) {
  float x = dot * a.scale;
  if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
  return x;
}

// The keys [lo, hi] that the query positions [qa, qb] can see; every key
// when some row in [qa, qb] sees none (see the note on masking).
__device__ __forceinline__ void key_range(const Args& a, int qa, int qb,
                                          int* lo, int* hi) {
  *lo = 0;
  *hi = a.Sk - 1;
  const bool some_row_empty = a.window > 0 && qb - a.window + 1 > a.Sk - 1;
  if (some_row_empty) return;
  if (a.window > 0 && qa - a.window + 1 > 0) *lo = qa - a.window + 1;
  if (a.causal && qb < *hi) *hi = qb;
}

// ---------------------------------------------------------------- tiled
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // keys per tile
constexpr int kTiledThreads = 256;  // 16 x 16: ty owns 4 rows, tx 2 keys

template <int D>
constexpr int tiled_smem_floats() {
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTiledThreads, 2)
    flash_tiled(const Args a) {
  constexpr int DP = D + 1;  // padded rows: conflict-free column reads
  constexpr int PP = kBK + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [kBQ][DP]
  float* sK = sQ + kBQ * DP;   // [kBK][DP]
  float* sV = sK + kBK * DP;   // [kBK][D]
  float* sP = sV + kBK * D;    // [kBQ][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int kvh = h / (a.H / a.KV);
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < kBQ * D; e += kTiledThreads) {
    const int r = e / D, c = e % D, i = q0 + r;
    sQ[r * DP + c] = i < a.Sq ? to_f32(Q[i * a.q_ss + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = (q0 + kBQ < a.Sq ? q0 + kBQ : a.Sq) - 1;
  int lo, hi;
  key_range(a, q0 + a.q_offset, q_last + a.q_offset, &lo, &hi);

  for (int k0 = (lo / kBK) * kBK; k0 <= hi; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kTiledThreads) {
      const int r = e / D, c = e % D, j = k0 + r;
      const bool in = j < a.Sk;
      sK[r * DP + c] = in ? to_f32(K[j * a.k_ss + c]) : 0.0f;
      sV[r * D + c] = in ? to_f32(V[j * a.v_ss + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
      const float k0v = sK[tx * DP + d], k1v = sK[(tx + 16) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], k0v, s[i][0]);
        s[i][1] = fmaf(qv[i], k1v, s[i][1]);
      }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + a.q_offset;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int kp = k0 + tx + 16 * jj;
        // a key past Sk is no key: -inf gives it weight exactly 0
        s[i][jj] = kp >= a.Sk ? -INFINITY
                   : key_valid(a, qp, kp) ? cap(a, s[i][jj]) : kMasked;
      }
      // the row's 32 keys live in the 16 lanes of this half-warp
      float t = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        t = fmaxf(t, __shfl_xor_sync(kFull, t, off));
      const float m_new = fmaxf(m[i], t);
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      float rs = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(kFull, rs, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
      sP[(ty * 4 + i) * PP + tx] = p0;
      sP[(ty * 4 + i) * PP + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(acc[i][c] / denom, &O[row * a.o_ss + tx + 16 * c]);
  }
}

// --------------------------------------------------------------- decode
constexpr int kWarps = 8;
constexpr int kKeysPerStep = 4;  // keys a warp has in flight

template <typename T, int D, int GC>
__global__ void __launch_bounds__(kWarps * 32) flash_decode(const Args a) {
  constexpr int E = D / 32;  // values per lane: d = lane + 32 * e
  __shared__ float s_m[kWarps][GC];
  __shared__ float s_l[kWarps][GC];
  __shared__ float s_acc[kWarps][GC][D];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int G = a.H / a.KV;
  const int g0 = blockIdx.x * GC;
  const int gc = G - g0 < GC ? G - g0 : GC;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const T* Q = static_cast<const T*>(a.q) + b * a.q_sb + (kvh * G + g0) * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* O = static_cast<T*>(a.o) + b * a.o_sb + (kvh * G + g0) * a.o_sh;

  float q[GC][E], m[GC], l[GC], acc[GC][E];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kMasked;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      q[g][e] = g < gc ? to_f32(Q[g * a.q_sh + lane + 32 * e]) : 0.0f;
      acc[g][e] = 0.0f;
    }
  }

  const int qp = a.q_offset;  // Sq == 1
  int lo, hi;
  key_range(a, qp, qp, &lo, &hi);

  for (int j0 = lo + w * kKeysPerStep; j0 <= hi;
       j0 += kWarps * kKeysPerStep) {
    float kf[kKeysPerStep][E], vf[kKeysPerStep][E];
#pragma unroll
    for (int u = 0; u < kKeysPerStep; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kf[u][e] = j <= hi ? to_f32(K[j * a.k_ss + lane + 32 * e]) : 0.0f;
        vf[u][e] = j <= hi ? to_f32(V[j * a.v_ss + lane + 32 * e]) : 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= gc) break;
      float s[kKeysPerStep];
      float t = m[g];
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(q[g][e], kf[u][e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(kFull, dot, off);
        const int j = j0 + u;
        s[u] = j > hi ? -INFINITY : key_valid(a, qp, j) ? cap(a, dot) : kMasked;
        t = fmaxf(t, s[u]);
      }
      const float corr = expf(m[g] - t);
      float rs = 0.0f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < kKeysPerStep; ++u) {
        const float p = expf(s[u] - t);
        rs += p;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
      }
      l[g] = l[g] * corr + rs;
      m[g] = t;
    }
  }

#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (lane == 0) {
      s_m[w][g] = m[g];
      s_l[w][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[w][g][lane + 32 * e] = acc[g][e];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < gc * D; t += kWarps * 32) {
    const int g = t / D, d = t % D;
    float mx = s_m[0][g];
#pragma unroll
    for (int ww = 1; ww < kWarps; ++ww) mx = fmaxf(mx, s_m[ww][g]);
    float lsum = 0.0f, osum = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float f = expf(s_m[ww][g] - mx);
      lsum += s_l[ww][g] * f;
      osum += s_acc[ww][g][d] * f;
    }
    store(osum / fmaxf(lsum, 1e-30f), &O[g * a.o_sh + d]);
  }
}

// ------------------------------------------------------------- dispatch
template <typename T, int D>
int launch_tiled(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = tiled_smem_floats<D>() * static_cast<int>(sizeof(float));
  // the opt-in to more than 48 KB of dynamic shared memory (per device,
  // so it is set on every launch: it costs the host about a microsecond)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tiled<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_tiled<T, D><<<grid, kTiledThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_decode(const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 2) {
    flash_decode<T, D, 2><<<dim3(1, a.KV, B), kWarps * 32, 0, stream>>>(a);
  } else {
    flash_decode<T, D, 4>
        <<<dim3((G + 3) / 4, a.KV, B), kWarps * 32, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, int D, cudaStream_t stream) {
  if (a.Sq == 1) {
    switch (D) {
      case 64: return launch_decode<T, 64>(a, B, stream);
      case 96: return launch_decode<T, 96>(a, B, stream);
      case 128: return launch_decode<T, 128>(a, B, stream);
      default: break;
    }
  }
  switch (D) {
    case 16: return launch_tiled<T, 16>(a, B, stream);
    case 32: return launch_tiled<T, 32>(a, B, stream);
    case 64: return launch_tiled<T, 64>(a, B, stream);
    case 96: return launch_tiled<T, 96>(a, B, stream);
    case 128: return launch_tiled<T, 128>(a, B, stream);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Launches the attention kernel on `stream`; returns cudaGetLastError()
// (0 = ok), -1 for an unsupported dtype and -2 for an unsupported head
// dimension.  q [B, H, Sq, D], k and v [B, KV, Sk, D] and o [B, H, Sq, D]
// are device pointers addressed by the strides given (elements), with
// the last dimension contiguous; dtype 0 = float32, 1 = bfloat16 (all
// four arrays).  H % KV == 0; D in {16, 32, 64, 96, 128}; softcap <= 0
// and window <= 0 mean none; q_offset >= 0.
int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KV, int Sq, int Sk, int D,
    float scale, float softcap, int causal, int window, int q_offset,
    int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Args a{q, k, v, o,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
               v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
               H, KV, Sq, Sk, scale, softcap, causal, window, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, s);
  return -1;
}

}  // extern "C"
