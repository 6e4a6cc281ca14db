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
//   * wgmma (bf16 prefill, Sq > 1, D in {64, 80, 96, 112, 128}): one block per
//     (192 query rows, head, batch): three consumer warpgroups of 64 rows
//     and one producer warp.  Prefill is bound by operations: the least
//     time on an H100 is its 4*D flops per unmasked (q, k) pair at the 989
//     TFLOP/s bf16 dense tensor-core rate.  So both products run on the
//     tensor cores.  The producer's lane 0 loads Q once and K and V tiles
//     of 64 keys through a ring of 4 stages with TMA (4-D tensor maps over
//     the tensors' own strides, 128-byte swizzle, zeros past the edges),
//     each stage's arrival counted on an mbarrier, its release on
//     another.  D 80, 96 and 112 run the D = 128 kernel: the tensor maps keep
//     the true D, so TMA fills the columns past it with zeros, which add
//     nothing to Q K^T, and the output's columns past D are not stored.
//     A warpgroup computes S = Q K^T with wgmma from shared
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
//   * tiled (fp32 prefill, and bf16 at D 16 or 32): one block per (64
//     query rows, head, batch), 256 threads; Q, K, V and P tiles staged
//     in shared memory as fp32; each thread computes a 4x2 block of
//     scores and a 4x(D/16) block of the output, with plain fp32 FMAs, so
//     p . v is an fp32 product as in the TPU kernel (which upcasts v).
//     D in {16, 32, 64, 80, 96, 112, 128}.
//   * decode (Sq == 1, D in {64, 80, 96, 112, 128}): split keys.  Decode
//     is bound by bytes: the least time is the K and V positions it must
//     read (0..q_pos, or the window) at 3.35 TB/s, and the card needs
//     megabytes in flight to reach that rate.  The host computes the key
//     range [lo, hi] of the query (flash_attention.py's decode_plan, with
//     no sync) and cuts it into n_chunks chunks; each block reads each key
//     of its chunk once for all the query heads of its KV head (up to 16
//     in bf16, 8 in fp32; more take several blocks), and the blocks of one
//     chunk run side by side over the KV heads, so whole rows of the [B,
//     Smax, KV, D] cache are read together.  Two kernels:
//       - bf16 (flash_decode_mma): 4 warps; each streams 16-key tiles of
//         K and V into its own ring of 3 shared-memory stages with
//         cp.async, and runs S = Q K^T and O += P V on mma.sync m16n8k16,
//         the query heads as the 16 rows (see the kernel), so the work a
//         key costs does not grow with the query heads;
//       - fp32 (flash_decode): 8 warps; a warp is 32 / LPK sub-warps of
//         LPK lanes (LPK the power of two >= D / 4), a lane loads 16-byte
//         vectors of a key row (lanes past D / 4 idle), each sub-warp
//         walks its keys with U rows of K and of V in flight (U = 8, 4 or
//         2 as the group of query heads grows and registers fill), keeps
//         an online softmax per query head, and the block merges its
//         sub-warps in a fixed order (shuffles, then shared memory).
//     With one chunk (at most 256 keys: the serving ticks' positions) the
//     block writes the output and no merge runs; else it writes fp32 (m,
//     l, acc) to scratch the wrapper allocates, and flash_decode_merge,
//     one block per (head, batch), combines the chunks in chunk order:
//     the same bits on every run, no atomics.  A row with no valid key has
//     every chunk's m at -1e30, so the merge weights the chunks equally:
//     the mean of v over all Sk keys, as before.
//
// Every kernel also writes each query row's logsumexp when the caller
// passes an lse buffer: fp32, the natural domain, log sum_j exp(s_j) over
// the row's scaled, soft-capped and masked scores as above (the bf16
// kernels' m and l are in the log2 domain: (m + log2 l) ln 2), at
// lse[(b H + h) lse_stride + i].  The prefill kernels (wgmma, tiled) write
// it for training: flash_attention_bwd.cu reads it and recomputes nothing.
// The decode kernels write it for a query whose keys are split over ranks
// (a cache whose positions are sharded), whose (o, lse) pairs the caller
// merges: with one chunk the block that writes the output, else
// flash_decode_merge from the chunks' (m, l).  A row that sees no key has
// its m at -1e30, and its logsumexp, -1e30 + log(n keys), is written as
// -1e30 (row_lse), as the plain version's rounds in fp32.  Serving passes
// null: its outputs keep their bits.
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
  int D;  // the true head dimension (the wgmma kernel may run a wider layout)
  // decode: keys [lo, hi] cut into n_chunks chunks of `chunk` keys, and the
  // partial results' scratch when n_chunks > 1
  int lo, hi, chunk, n_chunks;
  float* part;
  // each row's logsumexp, natural domain (lse[(b H + h) lse_stride + i] =
  // log sum_j exp(s_ij) over the scores s of the note above, masked keys at
  // -1e30), or null (serving)
  float* lse;
  int lse_stride;
};

__device__ __forceinline__ bool key_valid(const Args& a, int qp, int kp) {
  return (!a.causal || kp <= qp) && (a.window <= 0 || kp > qp - a.window);
}

__device__ __forceinline__ float cap(const Args& a, float dot) {
  float x = dot * a.scale;
  if (a.softcap > 0.0f) x = a.softcap * tanhf(x / a.softcap);
  return x;
}

// A row's logsumexp from its natural-domain max m and sum l: m + log l,
// or -1e30 for a row that sees no key (m at the masked score, which the
// bf16 kernels' log2-domain m leaves at -1e30 ln 2).
__device__ __forceinline__ float row_lse(float m, float l) {
  return m < 0.5f * kMasked ? kMasked : m + logf(l);
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
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.lse_stride + row] = m[i] + logf(l[i]);
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
constexpr float kLn2 = 0.6931471805599453f;

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
    // the logsumexp leaves the log2 domain: (m + log2 l) ln 2
    if (a.lse != nullptr && c2 == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.lse_stride + row] =
          (m[r] + log2f(l[r])) * kLn2;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= a.D) break;  // columns past the true D (zeros) are not stored
      const __nv_bfloat162 v =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(&O[row * a.o_ss + 8 * j + c2]) = v;
    }
  }
}

// --------------------------------------------------------------- decode
// fp32 (see the note at the top); bf16 decodes on flash_decode_mma below
constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// The fp32 decode layout of D: V float4 vectors a row, a sub-warp of LPK
// lanes a key, KPW sub-warps a warp, U keys in flight a sub-warp (fewer
// as the GC query heads' registers grow).
template <int D, int GC>
struct DLayout {
  static constexpr int N = 4;
  static constexpr int V = D / N;
  static constexpr int LPK = pow2_at_least(V);
  static constexpr int KPW = 32 / LPK;
  static constexpr int NSUB = kDecWarps * KPW;
  static constexpr int U = GC >= 8 ? 2 : GC >= 4 ? 4 : 8;
  static_assert(D % N == 0 && LPK <= 32, "a key row must fit a warp in 16-byte vectors");
};

template <int D, int GC>
__global__ void __launch_bounds__(kDecThreads, GC <= 2 ? 2 : 1) flash_decode(const Args a) {
  using L = DLayout<D, GC>;
  constexpr int N = L::N, LPK = L::LPK, U = L::U;
  __shared__ float s_m[kDecWarps][GC];
  __shared__ float s_l[kDecWarps][GC];
  __shared__ float s_acc[kDecWarps][GC][D];

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int slot = lane % LPK;  // the 16-byte vector of the row this lane owns
  const bool active = slot < L::V;
  // an idle lane loads its sub-warp's last vector (its q is 0 and its sums
  // are never stored), so every load is unconditional and all of them
  // are in flight before the first is used
  const int lslot = active ? slot : L::V - 1;
  const int sub = w * L::KPW + lane / LPK;  // the block's sub-warp
  const int G = a.H / a.KV;
  const int n_groups = (G + GC - 1) / GC;
  // blocks of one chunk and batch row run side by side over the KV heads,
  // so the card reads whole rows of the [B, Smax, KV, D] cache together
  const int kvh = blockIdx.x / n_groups, g0 = (blockIdx.x % n_groups) * GC;
  const int gc = G - g0 < GC ? G - g0 : GC;
  const int c = blockIdx.y, b = blockIdx.z;
  const float* Q = static_cast<const float*>(a.q) + b * a.q_sb + (kvh * G + g0) * a.q_sh;
  const float* K = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh + lslot * N;
  const float* Vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh + lslot * N;

  float q[GC][N], m[GC], l[GC], acc[GC][N];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kMasked;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      q[g][i] = g < gc && active ? Q[g * a.q_sh + slot * N + i] : 0.0f;
      acc[g][i] = 0.0f;
    }
  }

  const int qp = a.q_offset;  // Sq == 1
  const int c0 = a.lo + c * a.chunk;
  const int c1 = min(a.hi, c0 + a.chunk - 1);
  // the loop runs on the warp's first key, so every lane of a warp makes
  // the same trips (the shuffles below need the whole warp); a sub-warp's
  // own keys past the chunk get -inf
  const int first = w * L::KPW, own = sub - first;
  for (int jw = c0 + first; jw <= c1; jw += L::NSUB * U) {
    const int jb = jw + own;
    // keys past the chunk load its last key (weight 0 below)
    float4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long j = min(jb + u * L::NSUB, c1);
      kr[u] = *reinterpret_cast<const float4*>(K + j * a.k_ss);
      vr[u] = *reinterpret_cast<const float4*>(Vp + j * a.v_ss);
    }
    float s[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float kf[N] = {kr[u].x, kr[u].y, kr[u].z, kr[u].w};
      const int j = jb + u * L::NSUB;
      const bool valid = key_valid(a, qp, j);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= gc) break;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) dot = fmaf(q[g][i], kf[i], dot);
        // the row's dot over the LPK lanes of this sub-warp
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
        // a key past the chunk is no key: -inf gives it weight exactly 0
        s[u][g] = j > c1 ? -INFINITY : valid ? cap(a, dot) : kMasked;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= gc) break;
      float t = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) t = fmaxf(t, s[u][g]);
      const float corr = expf(m[g] - t);
      float rs = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float vf[N] = {vr[u].x, vr[u].y, vr[u].z, vr[u].w};
        const float p = expf(s[u][g] - t);
        rs += p;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
      l[g] = l[g] * corr + rs;
      m[g] = t;
    }
  }

  // merge the warp's sub-warps (lanes LPK apart hold the same slot)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lx = __shfl_xor_sync(kFull, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float fa = expf(m[g] - mx), fb = expf(mo - mx);
      l[g] = l[g] * fa + lx * fb;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * fa + ao * fb;
      }
      m[g] = mx;
    }
  }
  // then the block's warps, through shared memory, in warp order
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (lane == 0) {
        s_m[w][g] = m[g];
        s_l[w][g] = l[g];
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < N; ++i) s_acc[w][g][slot * N + i] = acc[g][i];
      }
    }
  }
  __syncthreads();
  const int h0 = kvh * G + g0;
  const long long part_row = (static_cast<long long>(b) * a.H + h0) * a.n_chunks + c;
  const long long n_rows = static_cast<long long>(gridDim.z) * a.H * a.n_chunks;
  for (int t = threadIdx.x; t < gc * D; t += kDecThreads) {
    const int g = t / D, d = t % D;
    float mx = s_m[0][g];
#pragma unroll
    for (int ww = 1; ww < kDecWarps; ++ww) mx = fmaxf(mx, s_m[ww][g]);
    float lsum = 0.0f, osum = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kDecWarps; ++ww) {
      const float f = expf(s_m[ww][g] - mx);
      lsum += s_l[ww][g] * f;
      osum += s_acc[ww][g][d] * f;
    }
    if (a.n_chunks == 1) {
      float* O = static_cast<float*>(a.o) + b * a.o_sb + (h0 + g) * a.o_sh;
      O[d] = osum / fmaxf(lsum, 1e-30f);
      if (a.lse != nullptr && d == 0)
        a.lse[(static_cast<long long>(b) * a.H + h0 + g) * a.lse_stride] = row_lse(mx, lsum);
    } else {
      // scratch: acc [B, H, n_chunks, D], then m and l [B, H, n_chunks]
      const long long row = part_row + static_cast<long long>(g) * a.n_chunks;
      a.part[row * D + d] = osum;
      if (d == 0) {
        a.part[n_rows * D + row] = mx;
        a.part[n_rows * (D + 1) + row] = lsum;
      }
    }
  }
}

// ------------------------------------------------- decode, bf16 (mma.sync)
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaRows = 16;    // query heads of a block: the mma's M
constexpr int kMmaKeys = 16;    // keys of a warp's tile
constexpr int kMmaStages = 3;   // a warp's tiles in flight

template <int D>
struct MLayout {
  // a tile row is D values and 16 bytes of padding, so that ldmatrix's 8
  // rows fall in distinct banks
  static constexpr int kPitch = D + 8;
  static constexpr int kTile = kMmaKeys * kPitch;  // values of a K or V tile
  static constexpr int kStage = 2 * kTile;
  static constexpr int kWarpBytes = kMmaStages * kStage * 2;
  static constexpr int kRingBytes = kMmaWarps * kWarpBytes;
  // then the warps' merge: m and l [warps][16], acc [warps][16][D], fp32
  static constexpr int kMergeBytes = kMmaWarps * kMmaRows * (D + 2) * 4;
  static constexpr int kBytes = kRingBytes > kMergeBytes ? kRingBytes : kMergeBytes;
};

// One block per (KV head and up to 16 of its query heads, chunk, batch),
// 4 warps; warp w takes the chunk's key tiles w, w + 4, ... of 16 keys and
// streams each tile's K and V rows into its own ring of 3 shared-memory
// stages with cp.async (16-byte pieces; keys past the chunk read zeros;
// evict-first in L2, as each key is read once).
// S = Q K^T (the query heads as the mma's 16 rows, q held as A fragments)
// and O += P V run on mma.sync m16n8k16 (K through ldmatrix, V through
// ldmatrix.trans), the online softmax on the fp32 accumulators in the log2
// domain (a row's max over its 4 lanes), P rounded to bf16 as the plain
// version rounds p to v's dtype.  The warps are merged in warp order
// through shared memory at the end.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_decode_mma(const Args a) {
  using L = MLayout<D>;
  constexpr int KS = D / 16;  // k16 steps of q . k, and 16-column steps of P V
  constexpr int NT = D / 8;   // n8 tiles of the output
  extern __shared__ __align__(16) uint8_t dsm[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gq = lane / 4, tq = lane % 4;  // the mma fragments' row group, thread in group
  const int G = a.H / a.KV;
  const int n_groups = (G + kMmaRows - 1) / kMmaRows;
  // blocks of one chunk and batch row run side by side over the KV heads
  const int kvh = blockIdx.x / n_groups, g0 = (blockIdx.x % n_groups) * kMmaRows;
  const int gc = min(G - g0, kMmaRows);
  const int c = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + (kvh * G + g0) * a.q_sh;
  const __nv_bfloat16* K = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* Vg = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // q as A fragments: rows gq and gq + 8 are query heads g0 + row (zero past gc)
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = gq + 8 * (i % 2), col = 16 * kk + 2 * tq + 8 * (i / 2);
      qa[kk][i] = row < gc ? *reinterpret_cast<const uint32_t*>(Q + row * a.q_sh + col) : 0u;
    }

  const int c0 = a.lo + c * a.chunk;
  const int c1 = min(a.hi, c0 + a.chunk - 1);
  const int n_tiles = (c1 - c0 + kMmaKeys) / kMmaKeys;
  const int my_tiles = n_tiles > w ? (n_tiles - w + kMmaWarps - 1) / kMmaWarps : 0;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dsm + w * L::kWarpBytes);
  const uint64_t policy = sm90::evict_first_policy();  // the cache is read once
  auto load = [&](int it) {  // this warp's tile it into stage it % kMmaStages
    __nv_bfloat16* sK = ring + (it % kMmaStages) * L::kStage;
    __nv_bfloat16* sV = sK + L::kTile;
    const int k0 = c0 + (w + it * kMmaWarps) * kMmaKeys;
    constexpr int kPieces = D / 8;  // 16-byte pieces of a row
#pragma unroll
    for (int i = lane; i < kMmaKeys * kPieces; i += 32) {
      const int r = i / kPieces, pc = i % kPieces;
      const int key = k0 + r;
      const long long row = key <= c1 ? key : c1;
      const int n = key <= c1 ? 16 : 0;
      sm90::cp_async16_hint(sK + r * L::kPitch + 8 * pc, K + row * a.k_ss + 8 * pc, n, policy);
      sm90::cp_async16_hint(sV + r * L::kPitch + 8 * pc, Vg + row * a.v_ss + 8 * pc, n, policy);
    }
  };
#pragma unroll
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < my_tiles) load(st);
    sm90::cp_async_commit();
  }

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.0f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};  // rows gq, gq + 8 (log2 domain)
  const float scale2 = a.scale * kLog2e;
  const int qp = a.q_offset;  // Sq == 1
  const int mi = lane / 8;    // the matrix of an ldmatrix.x4 this lane addresses
  for (int it = 0; it < my_tiles; ++it) {
    if (it + kMmaStages - 1 < my_tiles) load(it + kMmaStages - 1);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kMmaStages - 1>();
    __syncwarp();
    const __nv_bfloat16* sK = ring + (it % kMmaStages) * L::kStage;
    const __nv_bfloat16* sV = sK + L::kTile;
    const int k0 = c0 + (w + it * kMmaWarps) * kMmaKeys;

    // S = Q K^T over the tile's 16 keys (two n8 tiles)
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      sm90::ldmatrix_x4(kb, sK + (8 * (mi / 2) + lane % 8) * L::kPitch + 16 * kk + 8 * (mi % 2));
      sm90::mma_bf16_16816(sc[0], qa[kk], kb[0], kb[1]);
      sm90::mma_bf16_16816(sc[1], qa[kk], kb[2], kb[3]);
    }
    // scores in the log2 domain; -1e30 for masked keys, -inf past the chunk
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * nt + 2 * tq + i % 2;
        const float x = a.softcap > 0.0f ? cap(a, sc[nt][i]) * kLog2e : sc[nt][i] * scale2;
        sc[nt][i] = key > c1 ? -INFINITY : key_valid(a, qp, key) ? x : kMasked;
      }
    float mx[2] = {m[0], m[1]}, corr[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], sc[nt][i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[nt][i] = ex2(sc[nt][i] - m[i / 2]);
        l[i / 2] += sc[nt][i];
      }
    // P as the A fragment of P V (k = the tile's 16 keys), rounded to bf16
    const uint32_t pa[4] = {sm90::pack_bf16(sc[0][0], sc[0][1]), sm90::pack_bf16(sc[0][2], sc[0][3]),
                            sm90::pack_bf16(sc[1][0], sc[1][1]), sm90::pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // O += P V, two n8 tiles of the output a transposed load
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      uint32_t vb[4];
      sm90::ldmatrix_x4_trans(vb, sV + (8 * (mi % 2) + lane % 8) * L::kPitch + 16 * j + 8 * (mi / 2));
      sm90::mma_bf16_16816(o[2 * j], pa, vb[0], vb[1]);
      sm90::mma_bf16_16816(o[2 * j + 1], pa, vb[2], vb[3]);
    }
    __syncwarp();  // the stage is read before a later load overwrites it
  }
  sm90::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }

  // the warps merged in warp order, through the rings' shared memory
  __syncthreads();
  float* s_m = reinterpret_cast<float*>(dsm);     // [warps][16]
  float* s_l = s_m + kMmaWarps * kMmaRows;        // [warps][16]
  float* s_o = s_l + kMmaWarps * kMmaRows;        // [warps][16][D]
  if (tq == 0) {
    s_m[w * kMmaRows + gq] = m[0];
    s_m[w * kMmaRows + gq + 8] = m[1];
    s_l[w * kMmaRows + gq] = l[0];
    s_l[w * kMmaRows + gq + 8] = l[1];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s_o[(w * kMmaRows + gq + 8 * (i / 2)) * D + 8 * j + 2 * tq + i % 2] = o[j][i];
  __syncthreads();
  const int h0 = kvh * G + g0;
  const long long part_row = (static_cast<long long>(b) * a.H + h0) * a.n_chunks + c;
  const long long n_rows = static_cast<long long>(gridDim.z) * a.H * a.n_chunks;
  for (int t = threadIdx.x; t < gc * D; t += kMmaThreads) {
    const int g = t / D, d = t % D;
    float mxw = s_m[g];
#pragma unroll
    for (int ww = 1; ww < kMmaWarps; ++ww) mxw = fmaxf(mxw, s_m[ww * kMmaRows + g]);
    float lsum = 0.0f, osum = 0.0f;
#pragma unroll
    for (int ww = 0; ww < kMmaWarps; ++ww) {
      const float f = ex2(s_m[ww * kMmaRows + g] - mxw);
      lsum += s_l[ww * kMmaRows + g] * f;
      osum += s_o[(ww * kMmaRows + g) * D + d] * f;
    }
    if (a.n_chunks == 1) {
      __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + (h0 + g) * a.o_sh;
      store(osum / fmaxf(lsum, 1e-30f), &O[d]);
      // (m + log2 l) ln 2, from the log2-domain max
      if (a.lse != nullptr && d == 0)
        a.lse[(static_cast<long long>(b) * a.H + h0 + g) * a.lse_stride] =
            row_lse(mxw * kLn2, lsum);
    } else {
      // the partials as the fp32 kernel writes them: m in the natural log domain
      const long long row = part_row + static_cast<long long>(g) * a.n_chunks;
      a.part[row * D + d] = osum;
      if (d == 0) {
        a.part[n_rows * D + row] = mxw * kLn2;
        a.part[n_rows * (D + 1) + row] = lsum;
      }
    }
  }
}

// The chunks' partial (m, l, acc) of one (head, batch) combined in chunk
// order; one thread per output column; thread 0 writes the row's
// logsumexp when asked (the partials' m is in the natural domain).
template <typename T>
__global__ void flash_decode_merge(const Args a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long n_rows = static_cast<long long>(gridDim.y) * a.H * a.n_chunks;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.n_chunks;
  const float* pm = a.part + n_rows * a.D + row0;
  const float* pl = a.part + n_rows * (a.D + 1) + row0;
  float mx = pm[0];
  for (int c = 1; c < a.n_chunks; ++c) mx = fmaxf(mx, pm[c]);
  float lsum = 0.0f, osum = 0.0f;
  for (int c = 0; c < a.n_chunks; ++c) {
    const float f = expf(pm[c] - mx);
    lsum += pl[c] * f;
    osum += a.part[(row0 + c) * a.D + d] * f;
  }
  T* O = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  store(osum / fmaxf(lsum, 1e-30f), &O[d]);
  if (a.lse != nullptr && d == 0)
    a.lse[(static_cast<long long>(b) * a.H + h) * a.lse_stride] = row_lse(mx, lsum);
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

// the chunks' merge, when there are several
template <typename T, int D>
cudaError_t launch_merge(const Args& a, int B, cudaStream_t stream) {
  if (a.n_chunks == 1) return cudaSuccess;
  flash_decode_merge<T><<<dim3(a.H, B), D, 0, stream>>>(a);
  return cudaGetLastError();
}

// The query heads of a KV head are read in groups of up to 8 (GC, the
// template's register arrays): G <= 2, <= 4 or more (several groups of 8).
template <int D, int GC>
int launch_decode_gc(const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const dim3 grid(a.KV * ((G + GC - 1) / GC), a.n_chunks, B);
  flash_decode<D, GC><<<grid, kDecThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_merge<float, D>(a, B, stream);
  return static_cast<int>(err);
}

template <int D>
int launch_decode_mma(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = MLayout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_decode_mma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.H / a.KV;
  const dim3 grid(a.KV * ((G + kMmaRows - 1) / kMmaRows), a.n_chunks, B);
  flash_decode_mma<D><<<grid, kMmaThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = launch_merge<__nv_bfloat16, D>(a, B, stream);
  return static_cast<int>(err);
}

// bf16 decodes on the tensor cores; fp32 on the FMA kernel
template <typename T, int D>
int launch_decode(const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (a.n_chunks < 1 || a.chunk < 1 || (a.n_chunks > 1 && a.part == nullptr)) return -2;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_decode_mma<D>(a, B, stream);
  } else {
    if (G <= 1) return launch_decode_gc<D, 1>(a, B, stream);
    if (G <= 2) return launch_decode_gc<D, 2>(a, B, stream);
    if (G <= 4) return launch_decode_gc<D, 4>(a, B, stream);
    return launch_decode_gc<D, 8>(a, B, stream);
  }
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
  // the maps cover the true D: columns past it (to the layout's D) read zeros
  int err = qkv_map(&qm, a.q, a.D, a.Sq, a.H, B, a.q_ss, a.q_sh, a.q_sb, kWQ);
  if (err == 0) err = qkv_map(&km, a.k, a.D, a.Sk, a.KV, B, a.k_ss, a.k_sh, a.k_sb, kWK);
  if (err == 0) err = qkv_map(&vm, a.v, a.D, a.Sk, a.KV, B, a.v_ss, a.v_sh, a.v_sb, kWK);
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
      case 80: return launch_decode<T, 80>(a, B, stream);
      case 96: return launch_decode<T, 96>(a, B, stream);
      case 112: return launch_decode<T, 112>(a, B, stream);
      case 128: return launch_decode<T, 128>(a, B, stream);
      default: return -2;
    }
  }
  if (route == kRouteWgmma) {
    if constexpr (!std::is_same<T, __nv_bfloat16>::value) {
      return -1;
    } else {
      // D 80, 96 and 112 run the 128-column layout over maps of the true D
      switch (D) {
        case 64: return launch_wgmma<64>(a, B, stream);
        case 80:
        case 96:
        case 112:
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
    case 80: return launch_tiled<T, 80>(a, B, stream);
    case 96: return launch_tiled<T, 96>(a, B, stream);
    case 112: return launch_tiled<T, 112>(a, B, stream);
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
// q_offset >= 0.  Routes: 0 = flash_tiled (D in {16, 32, 64, 80, 96, 112,
// 128}), 1 = flash_decode (Sq == 1, D in {64, 80, 96, 112, 128}), 2 =
// flash_wgmma (bfloat16, D in {64, 80, 96, 112, 128}).  Decode reads the keys
// [lo, hi] in n_chunks chunks of `chunk` keys; with n_chunks > 1, scratch
// holds B * H * n_chunks * (D + 2) floats (the other routes ignore these).
// lse, when not null (every route), receives each query row's logsumexp
// at lse[(b * H + h) * lse_stride + i], fp32, natural domain (-1e30 for a
// row that sees no key): the backward's input, and the decode's for a
// merge of key shards; serving passes null.
int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int KV, int Sq, int Sk, int D,
    float scale, float softcap, int causal, int window, int q_offset,
    int dtype, int route, int lo, int hi, int chunk, int n_chunks, void* scratch,
    void* lse, int lse_stride, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  const Args a{q, k, v, o,
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
               v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
               H, KV, Sq, Sk, scale, softcap, causal, window, q_offset,
               D, lo, hi, chunk, n_chunks, static_cast<float*>(scratch),
               static_cast<float*>(lse), lse_stride};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, D, route, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, D, route, s);
  return -1;
}

}  // extern "C"
