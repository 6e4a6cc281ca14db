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
// its sequential KV grid axis.  Query head h reads KV head h / (H / KV):
// the TPU kernel takes K and V already repeated to H heads, this one reads
// the grouped heads itself, which is the same function and reads the KV
// cache once per group.
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
// Three kernels; the host chooses one from the dtype, Sq and D before the
// launch (flash_attention.py's route()):
//
//   * wgmma (bf16 prefill, Sq > 1, D in {64, 128}): one block per (192
//     query rows, head, batch): three consumer warpgroups of 64 rows and
//     one producer warp.  Prefill is bound by operations: the least time
//     on an H100 is its 4*D flops per unmasked (q, k) pair at the 989
//     TFLOP/s bf16 dense tensor-core rate.  So both products run on the
//     tensor cores.  The producer's lane 0 loads Q once and K and V tiles
//     of 64 keys through a ring of 4 stages with TMA (4-D tensor maps over
//     the tensors' own strides, 128-byte swizzle, zeros past the edges),
//     each stage's arrival counted on an mbarrier, its release on
//     another.  A warpgroup computes S = Q K^T with wgmma from shared
//     memory (K K-major), runs the online softmax in registers on the fp32
//     accumulator (a row's max and sum over the 4 lanes that share it),
//     packs P to bf16 straight into the A-operand registers and computes
//     O += P V with wgmma (V MN-major, the transposed descriptor).  P is
//     rounded to bf16 before the product, as flash_attention_plain rounds
//     p to v's dtype (repro.models.layers._attend does the same).  Only
//     tiles with a masked key for some row (the diagonal, the window's
//     edge, the keys past Sk, which TMA fills with zeros and which get
//     -inf) are masked element by element; each warpgroup visits the
//     tiles a block of its own 64 rows would, the others it lets pass.
//     Three warpgroups share each K and V tile, and while one waits on its
//     products the others' fill the tensor cores: each warpgroup's two
//     products and softmax run in turn.  The softmax's loops over a
//     thread's 32 scores hold no branch (uniform conditions are tested
//     outside them): a branch per score, with its convergence barrier,
//     doubled the kernel's time (flash_ablate.py measures it).
//   * tiled (fp32 prefill, and bf16 at D 16, 32 or 96): one block per (64
//     query rows, head, batch), 256 threads; Q, K, V and P tiles staged
//     in shared memory as fp32; each thread computes a 4x2 block of
//     scores and a 4x(D/16) block of the output, with plain fp32 FMAs, so
//     p . v is an fp32 product as in the TPU kernel (which upcasts v).
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
// KV, D] cache are read in place (TMA needs 16-byte aligned addresses and
// strides; the wrapper checks them).  The arithmetic uses expf and tanhf
// and IEEE division (no fast math); the wgmma kernel's softmax works on
// scores scaled by log2 e, with ex2.approx (relative error ~2^-22).
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/flash_attention.py loads it with ctypes).

#include <math.h>

#include <type_traits>

#include "sm90.cuh"

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

// ---------------------------------------------------------------- wgmma
constexpr int kWRows = 64;    // query rows of a consumer warpgroup
constexpr int kWGroups = 3;   // consumer warpgroups of a block
constexpr int kWQ = kWRows * kWGroups;  // query rows of a block
constexpr int kWK = 64;       // keys of a K or V tile
constexpr int kWStages = 4;   // K and V tiles in flight
constexpr int kWThreads = 128 * kWGroups + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx: relative error ~2^-22;
// 2^-inf = 0), for the softmax of the bf16 kernel
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
struct WLayout {
  static constexpr int kHalves = D / 64;  // 64-column halves of a row
  static constexpr int kQBytes = kWQ * D * 2;
  static constexpr int kTileBytes = kWK * D * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kWStages * kTileBytes;
  // 1024 bytes of room to align the tiles for the 128-byte swizzle
  static constexpr int kBytes = 1024 + kBarOffset + (1 + 2 * kWStages) * 8;
};

template <int D>
__global__ void __launch_bounds__(kWThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = WLayout<D>;
  using sm90::kAtomBytes;
  using sm90::kRowBytes;
  constexpr int NO = D / 2;  // output accumulators of a thread
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = base;                       // [halves][kWQ][64]
  uint8_t* sK = base + L::kQBytes;          // [stages][halves][kWK][64]
  uint8_t* sV = sK + kWStages * L::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* full = q_full + 1;         // a stage's K and V have landed
  uint64_t* empty = full + kWStages;   // the warpgroups are done with a stage

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWQ;  // the longest causal tiles first
  const int kvh = h / (a.H / a.KV);
  const int q_last = (q0 + kWQ < a.Sq ? q0 + kWQ : a.Sq) - 1;
  int lo, hi;
  key_range(a, q0 + a.q_offset, q_last + a.q_offset, &lo, &hi);
  const int t_first = lo / kWK;
  const int n_tiles = hi / kWK - t_first + 1;

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 128 * kWGroups);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (tid >= 128 * kWGroups) {  // the producer warp: its lane 0 issues every load
    if (tid == 128 * kWGroups) {
      sm90::mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kHalves; ++c)
        sm90::tma_load_4d(sQ + c * kWQ * kRowBytes, &qmap, q_full, 64 * c, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kWStages;
        if (t >= kWStages) sm90::mbar_wait(&empty[s], (t / kWStages + 1) & 1);
        sm90::mbar_expect_tx(&full[s], 2 * L::kTileBytes);
        const int k0 = (t_first + t) * kWK;
        for (int c = 0; c < L::kHalves; ++c) {
          const int off = s * L::kTileBytes + c * kWK * kRowBytes;
          sm90::tma_load_4d(sK + off, &kmap, &full[s], 64 * c, k0, kvh, b);
          sm90::tma_load_4d(sV + off, &vmap, &full[s], 64 * c, k0, kvh, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup g: query rows g0.. of the block; thread rows r0 and
  // r0 + 8, columns 8 j + c2 and 8 j + c2 + 1 of each accumulator (see
  // sm90.cuh)
  const int g = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int g0 = q0 + g * kWRows;
  const int qmin = g0 + a.q_offset, qmax = qmin + kWRows - 1;
  // the key tiles this warpgroup visits: those a block of its own rows
  // would visit (none when its rows are all past Sq), within the block's
  int g_first = t_first + n_tiles, g_last = -1;
  if (g0 < a.Sq) {
    int glo, ghi;
    key_range(a, qmin, (g0 + kWRows < a.Sq ? g0 + kWRows : a.Sq) - 1 + a.q_offset, &glo,
              &ghi);
    g_first = glo / kWK;
    g_last = ghi / kWK;
  }
  const uint8_t* sQg = sQ + g * kWRows * kRowBytes;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  // m: the rows' running max (log2 domain); l: this thread's share of the sums
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
  const float scale2 = a.scale * kLog2e;
  sm90::mbar_wait(q_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kWStages;
    const int tile = t_first + t, k0 = tile * kWK;
    const uint8_t* tK = sK + s * L::kTileBytes;
    const uint8_t* tV = sV + s * L::kTileBytes;
    sm90::mbar_wait(&full[s], (t / kWStages) & 1);
    if (tile < g_first || tile > g_last) {
      sm90::mbar_arrive(&empty[s]);
      continue;
    }

    // scores: S = Q K^T, both K-major in shared memory
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int step = (kk % 4) * 32;  // k16 inside a 64-column half
      sm90::wgmma_ss_n64<0>(
          sc, sm90::desc(sQg + (kk / 4) * kWQ * kRowBytes + step, 16, kAtomBytes),
          sm90::desc(tK + (kk / 4) * kWK * kRowBytes + step, 16, kAtomBytes), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // scores in the log2 domain (s log2 e), masked element by element only
    // where some key is masked for some row
    const bool edge = k0 + kWK > a.Sk || (a.causal && k0 + kWK - 1 > qmin) ||
                      (a.window > 0 && k0 <= qmax - a.window);
    // (branches on uniform conditions outside the loops over the
    // elements, and selects inside them, keep those loops straight)
    if (a.softcap > 0.0f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = cap(a, sc[i]) * kLog2e;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale2;
    }
    if (edge) {
      const bool causal = a.causal != 0, windowed = a.window > 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = k0 + 8 * (i / 4) + c2 + i % 2;
        const int qp = qmin + r0 + 8 * ((i / 2) % 2);
        const bool valid = (!causal | (kp <= qp)) & (!windowed | (kp > qp - a.window));
        // a key past Sk (zeros from TMA) is no key: -inf gives it weight 0
        sc[i] = kp >= a.Sk ? -INFINITY : valid ? sc[i] : kMasked;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    // P = 2^(S - m), rounded to bf16 in the A operand's registers
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
      l[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pa[kk][q] = sm90::pack_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1]);
    // the output moves to the new max only where some row's max moved
    if (__any_sync(kFull, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= corr[(i / 2) % 2];
    }

    // O += P V: V is MN-major (D contiguous), its halves kWK rows apart
    sm90::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) sm90::fence_regs(pa[kk]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      const uint64_t dv = sm90::desc(tV + kk * 16 * kRowBytes, kWK * kRowBytes, kAtomBytes);
      if constexpr (D == 64) {
        sm90::wgmma_rs_n64<1>(o, pa[kk], dv, 1);
      } else {
        sm90::wgmma_rs_n128<1>(o, pa[kk], dv, 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = g0 + r0 + 8 * r;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(&O[row * a.o_ss + 8 * j + c2]) = v;
    }
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

// q [B, H, Sq, D], k and v [B, KV, Sk, D] as 4-D tensor maps (innermost
// first: D, rows, heads, batch) with the tensors' own strides; a box is
// 64 columns of `rows` rows of one head.  A dimension of size 1 gets a
// packed stride (its coordinate is always 0).
int qkv_map(CUtensorMap* map, const void* p, int D, int S, int N, int B, long long ss,
            long long sh, long long sb, int rows) {
  uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(S),
                      static_cast<uint64_t>(N), static_cast<uint64_t>(B)};
  uint64_t strides[3] = {static_cast<uint64_t>(ss) * 2, static_cast<uint64_t>(sh) * 2,
                         static_cast<uint64_t>(sb) * 2};
  for (int i = 1; i < 4; ++i)
    if (dims[i] == 1) strides[i - 1] = i == 1 ? dims[0] * 2 : strides[i - 2] * dims[i - 1];
  const uint32_t box[4] = {64, static_cast<uint32_t>(rows), 1, 1};
  return sm90_host::make_map(map, p, 4, dims, strides, box);
}

template <int D>
int launch_wgmma(const Args& a, int B, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int err = qkv_map(&qm, a.q, D, a.Sq, a.H, B, a.q_ss, a.q_sh, a.q_sb, kWQ);
  if (err == 0) err = qkv_map(&km, a.k, D, a.Sk, a.KV, B, a.k_ss, a.k_sh, a.k_sb, kWK);
  if (err == 0) err = qkv_map(&vm, a.v, D, a.Sk, a.KV, B, a.v_ss, a.v_sh, a.v_sb, kWK);
  if (err != 0) return err;
  constexpr int bytes = WLayout<D>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.Sq + kWQ - 1) / kWQ, a.H, B);
  flash_wgmma<D><<<grid, kWThreads, bytes, stream>>>(qm, km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

// the route codes of the C interface (flash_attention.py's route())
constexpr int kRouteFma = 0;     // flash_tiled
constexpr int kRouteDecode = 1;  // flash_decode
constexpr int kRouteWgmma = 2;   // flash_wgmma

template <typename T>
int dispatch(const Args& a, int B, int D, int route, cudaStream_t stream) {
  if (route == kRouteDecode) {
    if (a.Sq != 1) return -2;
    switch (D) {
      case 64: return launch_decode<T, 64>(a, B, stream);
      case 96: return launch_decode<T, 96>(a, B, stream);
      case 128: return launch_decode<T, 128>(a, B, stream);
      default: return -2;
    }
  }
  if (route == kRouteWgmma) {
    if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
      return -1;
    } else {
      switch (D) {
        case 64: return launch_wgmma<64>(a, B, stream);
        case 128: return launch_wgmma<128>(a, B, stream);
        default: return -2;
      }
    }
  }
  if (route != kRouteFma) return -5;
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

// Launches the attention kernel of `route` on `stream`; returns
// cudaGetLastError() (0 = ok), -1 for a dtype the route does not take,
// -2 for a head dimension (or, for decode, Sq) it does not take, -3 or -4
// when a TMA tensor map cannot be made (no driver entry point; an address
// or stride not a multiple of 16 bytes) and -5 for an unknown route.
// q [B, H, Sq, D], k and v [B, KV, Sk, D] and o [B, H, Sq, D] are device
// pointers addressed by the strides given (elements), with the last
// dimension contiguous; dtype 0 = float32, 1 = bfloat16 (all four
// arrays).  H % KV == 0; softcap <= 0 and window <= 0 mean none;
// q_offset >= 0.  Routes: 0 = flash_tiled (D in {16, 32, 64, 96, 128}),
// 1 = flash_decode (Sq == 1, D in {64, 96, 128}), 2 = flash_wgmma
// (bfloat16, D in {64, 128}).
int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KV, int Sq, int Sk, int D,
    float scale, float softcap, int causal, int window, int q_offset,
    int dtype, int route, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Args a{q, k, v, o,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
               v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
               H, KV, Sq, Sk, scale, softcap, causal, window, q_offset};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, route, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, route, s);
  return -1;
}

}  // extern "C"
