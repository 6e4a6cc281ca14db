// The MoE grouped GEMM (ragged_dot), backward.
//
// Replaces no TPU kernel: the JAX package trains through
// jax.lax.ragged_dot (src/repro/models/moe.py), whose gradient XLA forms;
// the forward's Pallas kernel, repro.kernels.moe_gemm.moe_gemm_padded, has
// no backward.  This is the gradient of csrc/moe_gemm.cu: x [T, D] holds
// token rows sorted by expert, expert e owns the next group_sizes[e] rows
// (clamped to T), out[r] = x[r] . w[e], and from dy [T, F]
//
//   dx[r]  = dy[r] . w[e]^T          (rows past sum(group_sizes): zero)
//   dw[e]  = sum over e's rows r of x[r]^T dy[r]   (no rows: zero)
//
// with fp32 sums, written in x's and w's dtypes.  The group sizes stay on
// the card, as in the forward: no host sync.
//
//   * dx is the forward's grouped GEMM over (row tile, D tile) with each
//     expert's weights read K-major (w[e] is [D, F], F contiguous, and dx
//     contracts over F).  bf16: moe_wgmma_dx, the forward's wgmma tiling
//     (128 rows x 128 columns, a ring of 4 TMA stages of 64 along F, two
//     consumer warpgroups and a producer warp); B is w[e]'s [128 D rows][64
//     F] box, K-major, so the descriptor is the same as x's and the
//     transpose flag 0: no copy or transpose of w in memory.  fp32:
//     moe_dx_fma, the forward's FMA tiling with w's slice staged
//     transposed in shared memory.  The forward's decode route has no
//     counterpart: a backward at T <= 4 E takes these routes too (its
//     tiles have few rows, and rows past a segment are masked).
//   * dw: every sum walks its expert's segment in row order, so it has
//     one order: no atomics, the same bits on every run.  bf16:
//     moe_wgmma_dw, a persistent grid (one block an SM) over the static
//     list of (expert, D tile of 128, F tile of 256) output tiles, F
//     fastest: the blocks running at one time work on one expert, whose
//     x and dy rows (a few MB at llama4's shape) stay in L2.  Each block
//     scans the group sizes once into shared memory; its producer warp
//     streams 64-row boxes of x and dy through a ring of 4 TMA stages,
//     running into the next tile while the warpgroups store this one;
//     two consumer warpgroups run dw_tile += x_box^T dy_box on wgmma with
//     both operands MN-major (the transpose flags: no copy in memory).
//     fp32: moe_dw_fma, one block per (F tile, D tile, expert), 64 x 64
//     tiles, 4 x 4 outputs a thread.
//
// Bound.  At llama4-scout's gate/up shape in training (T = 4096 routed
// rows, D 5120, F 8192, 16 experts) dx and dw each do the forward's 2 T D
// F = 344 GFLOP: 0.35 ms each at the 989 TFLOP/s bf16 tensor-core rate;
// dw also writes all E D F weights (1.34 GB, 0.40 ms at 3.35 TB/s), so
// dw is bound by its bytes.  Its tiles re-read x once per F tile and dy
// once per D tile: from L2, which the tile order keeps them in, and the
// 128 x 256 tile halves those reads against a 128 x 128 one.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/moe_gemm.py loads it with ctypes).

#include <algorithm>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, bf16* p) { *p = __float2bfloat16_rn(v); }

// 16-byte loads: 4 floats or 8 bf16 values
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

struct Args {
  const void* x;   // [T, D]
  const void* w;   // [E, D, F]
  const int* gs;   // [E]
  const void* dy;  // [T, F]
  void* dx;        // [T, D]
  void* dw;        // [E, D, F]
  int T, D, F, E;
};

// Warp 0 maps row tile `tile` (tiles of R rows) to its expert's rows, as
// the forward's map_tile: info = (expert, first row, rows), (-1, first
// row, rows) for a tile of the zero rows past sum(group_sizes), or expert
// -2 for no work.
template <int R>
__device__ __forceinline__ void map_tile(const Args& a, int tile, int lane, int* info) {
  if (lane == 0) info[0] = -2;
  __syncwarp();
  const int per = (a.E + 31) / 32;
  const int lo = lane * per, hi = min(a.E, lo + per);
  int rows = 0, tiles = 0;
  for (int e = lo; e < hi; ++e) {
    const int g = max(a.gs[e], 0);
    rows += g;
    tiles += (g + R - 1) / R;
  }
  int ri = rows, ti = tiles;
  for (int off = 1; off < 32; off <<= 1) {
    const int vr = __shfl_up_sync(kFull, ri, off);
    const int vt = __shfl_up_sync(kFull, ti, off);
    if (lane >= off) {
      ri += vr;
      ti += vt;
    }
  }
  const int tot_rows = __shfl_sync(kFull, ri, 31);
  const int tot_tiles = __shfl_sync(kFull, ti, 31);
  int r_base = ri - rows, t_base = ti - tiles;
  if (tile >= t_base && tile < t_base + tiles) {
    for (int e = lo; e < hi; ++e) {
      const int g = max(a.gs[e], 0);
      const int nt = (g + R - 1) / R;
      if (tile < t_base + nt) {
        const int k = tile - t_base;
        info[0] = e;
        info[1] = r_base + k * R;
        info[2] = min(R, g - k * R);
        break;
      }
      t_base += nt;
      r_base += g;
    }
  }
  if (lane == 0 && tile >= tot_tiles) {
    const int start = tot_rows + (tile - tot_tiles) * R;
    if (start < a.T) {
      info[0] = -1;
      info[1] = start;
      info[2] = min(R, a.T - start);
    }
  }
}

// Warp 0: expert e's first row and rows, min(sum_{e' < e} max(g, 0), T)
// and its group size clamped to what is left of T (the plain version's
// segments)
__device__ __forceinline__ void segment(const Args& a, int e, int lane, int* seg) {
  int run = 0;
  for (int i = lane; i < e; i += 32) run += max(a.gs[i], 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) run += __shfl_xor_sync(kFull, run, off);
  if (lane == 0) {
    const int start = min(run, a.T);
    seg[0] = start;
    seg[1] = max(min(a.gs[e], a.T - start), 0);
  }
}

// ------------------------------------------------------------ dx, fp32
constexpr int kRows = 64;     // rows of a tile
constexpr int kCols = 128;    // output (D) columns of a tile
constexpr int kDepth = 32;    // slice of F staged in shared memory
constexpr int kThreads = 256;
constexpr int kXPitch = kRows + 1;

// dx[r][n] = sum_k dy[r][k] w[e][n][k]: the forward's moe_gemm_kernel with
// dy for x, depth F, output width D, and w's slice [kDepth k][kCols n]
// loaded along k (contiguous in w[e]) and staged transposed
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) moe_dx_fma(const Args a) {
  constexpr int N = Vec<T>::N;
  constexpr int kWVecs = kDepth * kCols / N / kThreads;
  constexpr int kXVals = kDepth * kRows / kThreads;
  __shared__ __align__(16) float xs[kDepth * kXPitch];
  __shared__ __align__(16) float ws[kDepth * kCols];
  __shared__ int info[3];

  const int tid = threadIdx.x, lane = tid % 32;
  const int tile = blockIdx.y;
  const int n0 = blockIdx.x * kCols;
  const int K = a.F, NOUT = a.D;

  if (tid < 32) map_tile<kRows>(a, tile, lane, info);
  __syncthreads();
  const int e = info[0], row0 = info[1];
  if (e == -2 || row0 >= a.T) return;
  const int nrows = min(info[2], a.T - row0);
  T* out = static_cast<T*>(a.dx);
  if (e == -1) {
    for (int i = tid; i < nrows * kCols; i += kThreads) {
      const int r = i / kCols, c = n0 + i % kCols;
      if (c < NOUT) store(0.f, out + static_cast<long long>(row0 + r) * NOUT + c);
    }
    return;
  }
  const T* X = static_cast<const T*>(a.dy) + static_cast<long long>(row0) * K;
  const T* W = static_cast<const T*>(a.w) + static_cast<long long>(e) * a.D * a.F;
  const int ty = tid / 32, tx = lane;
  float xr[kXVals];
  float wr[kWVecs][N];

  auto load = [&](int k0) {
#pragma unroll
    for (int m = 0; m < kXVals; ++m) {
      const int v = tid + kThreads * m, r = v / kDepth, k = v % kDepth;
      xr[m] = (r < nrows && k0 + k < K) ? to_f32(X[static_cast<long long>(r) * K + k0 + k]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kWVecs; ++m) {
      const int v = tid + kThreads * m;
      const int n = v / (kDepth / N), k = (v % (kDepth / N)) * N;
      if (k0 + k < K && n0 + n < NOUT) {
        Vec<T>::load(W + static_cast<long long>(n0 + n) * a.F + k0 + k, wr[m]);
      } else {
#pragma unroll
        for (int u = 0; u < N; ++u) wr[m][u] = 0.f;
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int m = 0; m < kXVals; ++m) {
      const int v = tid + kThreads * m, r = v / kDepth, k = v % kDepth;
      xs[k * kXPitch + r] = xr[m];
    }
#pragma unroll
    for (int m = 0; m < kWVecs; ++m) {
      const int v = tid + kThreads * m;
      const int n = v / (kDepth / N), k = (v % (kDepth / N)) * N;
#pragma unroll
      for (int u = 0; u < N; ++u) ws[(k + u) * kCols + n] = wr[m][u];
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  load(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    const bool more = k0 + kDepth < K;
    if (more) load(k0 + kDepth);
#pragma unroll 4
    for (int k = 0; k < kDepth && ty < nrows; ++k) {
      float wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[k * kCols + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (ty + 8 * i < nrows) {
          const float xv = xs[k * kXPitch + ty + 8 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += xv * wv[j];
        }
      }
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r >= nrows) continue;
    T* o = out + static_cast<long long>(row0 + r) * NOUT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 32 * j;
      if (c < NOUT) store(acc[i][j], o + c);
    }
  }
}

// ------------------------------------------------------------ dx, bf16
constexpr int kGRows = 128;
constexpr int kGCols = 128;
constexpr int kGDepth = 64;
constexpr int kGStages = 4;
constexpr int kGThreads = 288;  // two warpgroups and the producer warp
constexpr int kGGroup = 8;
constexpr int kGABytes = kGRows * kGDepth * 2;  // dy slice [128 rows][64 F]
constexpr int kGBBytes = kGCols * kGDepth * 2;  // w slice [128 D rows][64 F], K-major
constexpr int kGStageBytes = kGABytes + kGBBytes;
constexpr int kGBarOffset = kGStages * kGStageBytes;
constexpr int kGSmem = 1024 + kGBarOffset + 2 * kGStages * 8;

__global__ void __launch_bounds__(kGThreads, 1)
    moe_wgmma_dx(const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap wmap,
                 const Args a, int n_row_tiles, int n_col_tiles) {
  using sm90::kAtomBytes;
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kGBarOffset);
  uint64_t* empty = full + kGStages;
  __shared__ int info[3];

  const int tid = threadIdx.x, lane = tid % 32;
  const int per_group = kGGroup * n_col_tiles;
  const int first = (blockIdx.x / per_group) * kGGroup;
  const int in_group = blockIdx.x % per_group;
  const int group_rows = min(kGGroup, n_row_tiles - first);
  const int tile = first + in_group % group_rows;
  const int n0 = (in_group / group_rows) * kGCols;

  if (tid < 32) map_tile<kGRows>(a, tile, lane, info);
  __syncthreads();
  const int e = info[0], row0 = info[1];
  if (e == -2 || row0 >= a.T) return;
  const int nrows = min(info[2], a.T - row0);
  bf16* out = static_cast<bf16*>(a.dx);
  if (e == -1) {
    for (int i = tid; i < nrows * kGCols; i += kGThreads) {
      const int r = i / kGCols, c = n0 + i % kGCols;
      if (c < a.D) out[static_cast<long long>(row0 + r) * a.D + c] = __float2bfloat16_rn(0.f);
    }
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  const int nk = (a.F + kGDepth - 1) / kGDepth;

  if (tid >= 256) {  // the producer warp: its lane 0 issues every load
    if (tid == 256) {
      for (int k = 0; k < nk; ++k) {
        const int s = k % kGStages;
        if (k >= kGStages) sm90::mbar_wait(&empty[s], (k / kGStages + 1) & 1);
        uint8_t* sa = base + s * kGStageBytes;
        uint8_t* sb = sa + kGABytes;
        sm90::mbar_expect_tx(&full[s], kGStageBytes);
        // dy rows past T and columns past F read zeros; so do w rows past
        // D and columns past F (a 3-D map: never expert e + 1's rows)
        sm90::tma_load_2d(sa, &ymap, &full[s], k * kGDepth, row0);
        sm90::tma_load_3d(sb, &wmap, &full[s], k * kGDepth, n0, e);
      }
    }
    return;
  }

  const int g = tid / 128, warp = (tid % 128) / 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % kGStages;
    const uint8_t* sa = base + s * kGStageBytes + g * 64 * sm90::kRowBytes;
    const uint8_t* sb = base + s * kGStageBytes + kGABytes;
    sm90::mbar_wait(&full[s], (k / kGStages) & 1);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGDepth / 16; ++kk) {
      // dy K-major; w[e] K-major too ([128 D rows][64 F]), transpose flag 0
      sm90::wgmma_ss_n128<0>(acc, sm90::desc(sa + kk * 32, 16, kAtomBytes),
                             sm90::desc(sb + kk * 32, 16, kAtomBytes), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
    if (k > 0) sm90::mbar_arrive(&empty[(k - 1) % kGStages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  const int rb = 64 * g + 16 * warp + (tid % 32) / 4, c2 = 2 * (tid % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rb + 8 * r;
    if (row >= nrows) continue;
    bf16* o = out + static_cast<long long>(row0 + row) * a.D;
#pragma unroll
    for (int j = 0; j < kGCols / 8; ++j) {
      const int c = n0 + 8 * j + c2;
      if (c < a.D)
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// dy [T, F] as a 2-D map with [64 columns][128 rows] boxes, w [E, D, F]
// as a 3-D map with [64 F][128 D][1] boxes (K-major B tiles)
int launch_wgmma_dx(const Args& a, cudaStream_t stream) {
  CUtensorMap ym, wm;
  const uint64_t ydims[2] = {static_cast<uint64_t>(a.F), static_cast<uint64_t>(a.T)};
  const uint64_t ystrides[1] = {static_cast<uint64_t>(a.F) * 2};
  const uint32_t ybox[2] = {kGDepth, kGRows};
  const uint64_t wdims[3] = {static_cast<uint64_t>(a.F), static_cast<uint64_t>(a.D),
                             static_cast<uint64_t>(a.E)};
  const uint64_t wstrides[2] = {static_cast<uint64_t>(a.F) * 2,
                                static_cast<uint64_t>(a.D) * a.F * 2};
  const uint32_t wbox[3] = {kGDepth, kGCols, 1};
  int err = sm90_host::make_map(&ym, a.dy, 2, ydims, ystrides, ybox);
  if (err == 0) err = sm90_host::make_map(&wm, a.w, 3, wdims, wstrides, wbox);
  if (err != 0) return err;
  const cudaError_t attr =
      cudaFuncSetAttribute(moe_wgmma_dx, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_row_tiles = (a.T + kGRows - 1) / kGRows + a.E;
  const int n_col_tiles = (a.D + kGCols - 1) / kGCols;
  moe_wgmma_dx<<<n_row_tiles * n_col_tiles, kGThreads, kGSmem, stream>>>(ym, wm, a, n_row_tiles,
                                                                          n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dw, bf16
constexpr int kDwRows = 64;      // segment rows of a ring stage (one box)
constexpr int kDwM = 128;        // D rows of an output tile: two warpgroups of 64
constexpr int kDwN = 256;        // F columns of an output tile: two n128 products
constexpr int kDwStages = 4;
constexpr int kDwThreads = 288;  // two warpgroups and the producer warp
constexpr int kDwXBytes = kDwRows * kDwM * 2;  // x box: [2 halves][64 rows][64 D]
constexpr int kDwYBytes = kDwRows * kDwN * 2;  // dy box: [4 halves][64 rows][64 F]
constexpr int kDwStageBytes = kDwXBytes + kDwYBytes;
constexpr int kDwBarOffset = kDwStages * kDwStageBytes;
constexpr int kDwSegOffset = kDwBarOffset + 2 * kDwStages * 8;
constexpr int kMaxSmem = 232448;  // an H100 block's shared memory, opted in

__host__ __device__ constexpr int dw_smem(int E) { return 1024 + kDwSegOffset + 8 * E; }

// 16 bytes of a bf16 row from the 4 lanes of a quad: lane t holds v[u] =
// columns 8 u + 2 t, + 1 of four 8-column blocks; returns block t's 8
// columns (a 4 x 4 transpose inside the quad, by shuffles)
__device__ __forceinline__ uint4 quad_row(const uint32_t (&v)[4], int t) {
  uint32_t w[4] = {v[0], v[1], v[2], v[3]};
  // w[t] = v[t] already; lane t ^ k sends its v[t] (its w-index t ^ k ^ k)
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int want = t ^ k;  // the block lane t ^ k needs
    const uint32_t send = want == 0 ? v[0] : want == 1 ? v[1] : want == 2 ? v[2] : v[3];
    const uint32_t got = __shfl_xor_sync(kFull, send, k);
#pragma unroll
    for (int u = 0; u < 4; ++u) w[u] = u == want ? got : w[u];
  }
  const uint32_t own = t == 0 ? v[0] : t == 1 ? v[1] : t == 2 ? v[2] : v[3];
#pragma unroll
  for (int u = 0; u < 4; ++u) w[u] = u == t ? own : w[u];
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// dw[e][d][f] = sum_r x[r][d] dy[r][f] over expert e's rows, in row order.
// A persistent grid: block i walks output tiles i, i + gridDim.x, ... of
// the static list (expert, D tile of 128, F tile of 256), F fastest, so
// the blocks running at one time share one expert's x and dy rows in L2.
// The producer warp's lane 0 streams each tile's segment in boxes of 64
// rows (x [64][128 D] and dy [64][256 F], TMA, 128-byte swizzle) through
// a ring of 4 stages, running ahead into the block's next tile while the
// warpgroups store this one; warpgroup g forms D rows 64 g.. of the tile,
// A = x^T (its x half, MN-major: the transpose flag, no copy) and B = dy
// (MN-major), two m64n128k16 products a k16 step.  A box reaching past
// the segment has the foreign rows of x zeroed in shared memory before
// its products (a row's 128 bytes stay in place under the swizzle); TMA
// gives zeros past T.  The fp32 sums go to bf16 and leave in 16-byte
// stores (quad_row).  An expert without rows stores zeros.
__global__ void __launch_bounds__(kDwThreads, 1)
    moe_wgmma_dw(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap,
                 const Args a, int n_d, int n_f) {
  using sm90::kAtomBytes;
  using sm90::kRowBytes;
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kDwBarOffset);
  uint64_t* empty = full + kDwStages;
  int* seg = reinterpret_cast<int*>(base + kDwSegOffset);  // [E][2]: first row, rows
  const int tid = threadIdx.x, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::fence_barrier_init();
  }
  if (tid < 32) {  // the segments, once: min(sum_{e' < e} max(g, 0), T), clamped sizes
    int run = 0;
    for (int e0 = 0; e0 < a.E; e0 += 32) {
      const int e = e0 + lane;
      const int g = e < a.E ? max(a.gs[e], 0) : 0;
      int inc = g;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(kFull, inc, off);
        if (lane >= off) inc += v;
      }
      if (e < a.E) {
        const int start = min(run + inc - g, a.T);
        seg[2 * e] = start;
        seg[2 * e + 1] = max(min(g, a.T - start), 0);
      }
      run += __shfl_sync(kFull, inc, 31);
    }
  }
  __syncthreads();
  const int per_e = n_d * n_f, n_tiles = a.E * per_e;

  if (tid >= 256) {  // the producer warp: its lane 0 starts every load
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int e = tile / per_e, rem = tile % per_e;
        const int d0 = (rem / n_f) * kDwM, f0 = (rem % n_f) * kDwN;
        const int start = seg[2 * e], rows = seg[2 * e + 1];
        for (int r = 0; r < rows; r += kDwRows, ++it) {
          const int s = it % kDwStages;
          if (it >= kDwStages) sm90::mbar_wait(&empty[s], (it / kDwStages + 1) & 1);
          uint8_t* sx = base + s * kDwStageBytes;
          uint8_t* sy = sx + kDwXBytes;
          sm90::mbar_expect_tx(&full[s], kDwStageBytes);
          for (int c = 0; c < kDwM / 64; ++c)
            sm90::tma_load_2d(sx + c * kDwRows * kRowBytes, &xmap, &full[s], d0 + 64 * c,
                              start + r);
          for (int c = 0; c < kDwN / 64; ++c)
            sm90::tma_load_2d(sy + c * kDwRows * kRowBytes, &ymap, &full[s], f0 + 64 * c,
                              start + r);
        }
      }
    }
    return;
  }

  const int g = tid / 128, warp = (tid % 128) / 32, t = lane % 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e = tile / per_e, rem = tile % per_e;
    const int d0 = (rem / n_f) * kDwM, f0 = (rem % n_f) * kDwN;
    const int rows = seg[2 * e + 1];
    float acc[2][64];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[n][i] = 0.f;
    int prev = -1;  // the stage of the product group still in flight
    for (int r = 0; r < rows; r += kDwRows, ++it) {
      const int s = it % kDwStages;
      uint8_t* sx = base + s * kDwStageBytes + g * kDwRows * kRowBytes;  // this warpgroup's x half
      const uint8_t* sy = base + s * kDwStageBytes + kDwXBytes;
      sm90::mbar_wait(&full[s], (it / kDwStages) & 1);
      const int valid = rows - r;
      if (valid < kDwRows) {  // the rows past the segment: zeros
        for (int i = tid % 128; i < (kDwRows - valid) * 8; i += 128)
          *reinterpret_cast<uint4*>(sx + (valid + i / 8) * kRowBytes + 16 * (i % 8)) =
              make_uint4(0, 0, 0, 0);
        sm90::fence_proxy_async();
        sm90::named_barrier(1 + g, 128);
      }
      sm90::fence_regs(acc[0]);
      sm90::fence_regs(acc[1]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDwRows / 16; ++kk) {
        // A = x^T: [16 rows][64 D] of the half, MN-major (a k16 step: 16 rows)
        const uint64_t da = sm90::desc(sx + kk * 16 * kRowBytes, kDwRows * kRowBytes, kAtomBytes);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          // B = dy: F columns 128 n.., two halves kDwRows rows apart, MN-major
          const uint64_t db = sm90::desc(sy + 2 * n * kDwRows * kRowBytes + kk * 16 * kRowBytes,
                                         kDwRows * kRowBytes, kAtomBytes);
          sm90::wgmma_ss_n128<1, 1>(acc[n], da, db, 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // the previous box's products are done: release its stage
      sm90::fence_regs(acc[0]);
      sm90::fence_regs(acc[1]);
      if (prev >= 0) sm90::mbar_arrive(&empty[prev]);
      prev = s;
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc[0]);
    sm90::fence_regs(acc[1]);
    if (prev >= 0) sm90::mbar_arrive(&empty[prev]);

    // rows 16 warp + lane / 4 (+ 8) of the warpgroup's 64; 16-byte stores
    bf16* DW = static_cast<bf16*>(a.dw) + static_cast<long long>(e) * a.D * a.F;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = d0 + 64 * g + 16 * warp + lane / 4 + 8 * hr;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
          uint32_t v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = 4 * jb + u;
            v[u] = sm90::pack_bf16(acc[n][4 * j + 2 * hr], acc[n][4 * j + 2 * hr + 1]);
          }
          const uint4 w = quad_row(v, t);  // every lane of the warp shuffles
          const int col = f0 + 128 * n + 8 * (4 * jb + t);
          if (row < a.D && col < a.F)
            *reinterpret_cast<uint4*>(DW + static_cast<long long>(row) * a.F + col) = w;
        }
      }
    }
  }
}

// x [T, D] and dy [T, F] as 2-D maps with [64 columns][64 rows] boxes;
// a persistent grid of one block per SM (or fewer tiles)
int launch_wgmma_dw(const Args& a, cudaStream_t stream) {
  const int bytes = dw_smem(a.E);
  if (bytes > kMaxSmem) return -2;
  CUtensorMap xm, ym;
  const uint64_t xdims[2] = {static_cast<uint64_t>(a.D), static_cast<uint64_t>(a.T)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(a.D) * 2};
  const uint64_t ydims[2] = {static_cast<uint64_t>(a.F), static_cast<uint64_t>(a.T)};
  const uint64_t ystrides[1] = {static_cast<uint64_t>(a.F) * 2};
  const uint32_t box[2] = {64, kDwRows};
  int err = sm90_host::make_map(&xm, a.x, 2, xdims, xstrides, box);
  if (err == 0) err = sm90_host::make_map(&ym, a.dy, 2, ydims, ystrides, box);
  if (err != 0) return err;
  cudaError_t e =
      cudaFuncSetAttribute(moe_wgmma_dw, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_d = (a.D + kDwM - 1) / kDwM, n_f = (a.F + kDwN - 1) / kDwN;
  const int n_tiles = a.E * n_d * n_f;
  moe_wgmma_dw<<<std::min(sms, n_tiles), kDwThreads, bytes, stream>>>(xm, ym, a, n_d, n_f);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ dw, fp32
constexpr int kFTile = 64;
constexpr int kFK = 16;

// the same sums on FMAs: 64 x 64 output tiles, 256 threads of 4 x 4
// outputs (rows ty + 16 i, columns tx + 16 j), rows staged 16 at a time
template <typename T>
__global__ void __launch_bounds__(256) moe_dw_fma(const Args a) {
  __shared__ float xs[kFK][kFTile];
  __shared__ float ys[kFK][kFTile];
  __shared__ int seg[2];
  const int f0 = blockIdx.x * kFTile, d0 = blockIdx.y * kFTile, e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  if (tid < 32) segment(a, e, tid, seg);
  __syncthreads();
  const int start = seg[0], rows = seg[1];
  const T* X = static_cast<const T*>(a.x);
  const T* DY = static_cast<const T*>(a.dy);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < rows; k0 += kFK) {
    for (int i = tid; i < kFK * kFTile; i += 256) {
      const int r = i / kFTile, c = i % kFTile;
      const bool ok = k0 + r < rows;
      const long long row = start + k0 + r;
      xs[r][c] = ok && d0 + c < a.D ? to_f32(X[row * a.D + d0 + c]) : 0.f;
      ys[r][c] = ok && f0 + c < a.F ? to_f32(DY[row * a.F + f0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kFK; ++k) {
      float xv[4], yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) yv[j] = ys[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += xv[i] * yv[j];
    }
    __syncthreads();
  }
  T* DW = static_cast<T*>(a.dw) + static_cast<long long>(e) * a.D * a.F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = d0 + ty + 16 * i;
    if (row >= a.D) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col < a.F) store(acc[i][j], DW + static_cast<long long>(row) * a.F + col);
    }
  }
}

template <typename T>
int launch_fma(const Args& a, cudaStream_t s) {
  if (a.dx != nullptr) {
    const dim3 grid((a.D + kCols - 1) / kCols, (a.T + kRows - 1) / kRows + a.E);
    moe_dx_fma<T><<<grid, kThreads, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.dw != nullptr) {
    const dim3 grid((a.F + kFTile - 1) / kFTile, (a.D + kFTile - 1) / kFTile, a.E);
    moe_dw_fma<T><<<grid, 256, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

int launch_bf16(const Args& a, cudaStream_t s) {
  if (a.dx != nullptr) {
    const int err = launch_wgmma_dx(a, s);
    if (err != 0) return err;
  }
  if (a.dw != nullptr) return launch_wgmma_dw(a, s);
  return 0;
}

}  // namespace

extern "C" {

// Launches the backward on `stream`; returns cudaGetLastError() (0 = ok),
// -1 for an unsupported dtype, -2 for D or F not a multiple of 8, -3 or
// -4 when a TMA tensor map cannot be made.  x [T, D], w [E, D, F], dy [T,
// F] and the outputs dx [T, D] and dw [E, D, F] are contiguous, 16-byte
// aligned device pointers, group_sizes [E] int32; dx or dw may be null
// (not computed).  dtype 0 = float32 (FMA kernels), 1 = bfloat16 (dx and
// dw on wgmma; -2 also when E is too large for dw's table of segments in
// shared memory: E > 4344).
int repro_moe_gemm_bwd(const void* x, const void* w, const void* group_sizes, const void* dy,
                       void* dx, void* dw, int T, int D, int F, int E, int dtype, void* stream) {
  if (D % 8 != 0 || F % 8 != 0) return -2;
  if (E == 0 || D == 0 || F == 0) return 0;
  const Args a{x, w, static_cast<const int*>(group_sizes), dy, dx, dw, T, D, F, E};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 0) {  // no rows: dw is zero
    if (dw != nullptr) {
      const size_t bytes = static_cast<size_t>(E) * D * F * (dtype == 1 ? 2 : 4);
      return static_cast<int>(cudaMemsetAsync(dw, 0, bytes, s));
    }
    return 0;
  }
  if (dtype == 0) return launch_fma<float>(a, s);
  if (dtype == 1) return launch_bf16(a, s);
  return -1;
}

}  // extern "C"
