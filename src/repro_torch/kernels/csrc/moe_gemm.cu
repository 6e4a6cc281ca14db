// The MoE grouped GEMM (ragged_dot), forward.
//
// Replaces the TPU kernel repro.kernels.moe_gemm.moe_gemm_padded (Pallas
// body `_kernel`, src/repro/kernels/moe_gemm.py) behind its wrapper
// repro.kernels.ops.moe_grouped_gemm.  x [T, D] holds token rows sorted
// by expert; expert e owns the next group_sizes[e] rows, and
//
//   out[r] = x[r] . w[e]   (fp32 sums, written in x's dtype)
//
// for every row r of its segment; rows past sum(group_sizes) are zero.
//
// Group sizes on the card.  The TPU kernel takes a host-built layout in
// which every 128-row block holds one expert (ops.padded_group_layout),
// with the expert id prefetched as a scalar.  Here the group sizes stay a
// device array and each block finds its own work: the grid runs over an
// upper bound of row tiles of R rows, ceil(T / R) + E (each segment
// needs ceil(g / R) tiles), and warp 0 of each block scans the E group
// sizes (a per-lane run, then a warp scan; map_tile) to map its tile to
// (expert, first row, rows), or to a tile of the zero rows past the sum,
// or to nothing, when it exits at once.  No host sync per call, and no
// weight of an expert without rows is read.
//
// Three kernels; the host chooses one from the dtype, T and E before the
// launch (moe_gemm.py's route()):
//
//   * moe_wgmma (bf16 with T > 4 E: prefill): R = 128 rows x 128 output
//     columns a block, two consumer warpgroups of 64 rows and one
//     producer warp.  The producer's lane 0 loads slices of 64 along D
//     through a ring of 4 stages with TMA: x as a 2-D map [T, D] (its
//     row stride), w as a 3-D map [E, D, F], so a slice past D reads
//     zeros and never expert e + 1's rows; each stage's arrival is
//     counted on an mbarrier, its release on another.  The warpgroups
//     multiply with wgmma m64n128k16 from shared memory, x K-major and w
//     MN-major (the transposed descriptor), fp32 accumulators in
//     registers, one slice's products in flight while the next is
//     issued.  A tile's x slice may hold the next expert's rows: only the
//     tile's own rows are stored.  Blocks walk 8 row tiles for each
//     column tile, so those in flight share x rows and w columns in L2.
//   * moe_stream (T <= 4 E, fp32 or bf16: a decode step, where an expert
//     gets one or a few rows): split D and a persistent grid.  The work is
//     every (row tile of at most 4 rows, 256-column tile, D slice of
//     `slice` rows, 512 at most) of the experts hit, all about the same
//     size.  The grid is as many blocks as fit on the card at once (the
//     occupancy query times the SMs), and block i takes items i, i + grid,
//     ...: whole waves, at most one item apart; consecutive blocks take
//     consecutive column tiles of the same rows, so the card reads whole
//     weight rows together.  Each block first scans the group sizes on
//     the card into a per-expert table of tiles and rows in shared memory
//     (no host sync), so an item finds its expert by a binary search.  It
//     stages the item's x rows for its slice in shared memory once (fp32),
//     then streams the [slice, 256] weight slab: each thread owns one
//     16-byte column vector (a warp a 512-byte run of a row) and every
//     (256 / V)-th row (V the vectors of a tile row), with 8 vector loads
//     in flight (evict-first in L2: the weights are read once), all
//     started before the first is used (no load is
//     conditional: past the edges they read row or column 0 and are not
//     used), and no barrier; the threads' shares are summed through
//     shared memory in a fixed order and the item's fp32 partial sums are
//     written to scratch [n_slices, T, F].  moe_stream_reduce then sums the
//     slices in slice order into the output, in x's dtype, and writes the
//     zero rows past sum(group_sizes): the same bits on every run, no
//     atomics.  Experts without rows have no items, so their weights are
//     never read.
//   * moe_gemm_kernel (fp32 with T > 4 E): R = 64 rows x 128 output
//     columns a block, 256 threads; each thread 8 rows (ty + 8 i) x 4
//     columns (tx + 32 j), summing over D in slices of 32 staged in
//     shared memory as fp32 (x transposed, w as is), the next slice
//     loaded into registers while the current one is used.
//
// Bound.  Decode: each call reads the weights of the distinct experts
// hit, 7 x 5120 x 8192 x 2 B = 587 MB for llama4-scout's gate or up at 8
// slots (0.175 ms at 3.35 TB/s), ~59 x 7168 x 2048 x 2 B = 1.7 GB for
// kimi-k2's at 8 slots x top-8 (~0.55 ms): bound by bytes, so the
// streaming kernel is built to keep megabytes of weight loads in flight
// over the whole card to the last wave.  Its scratch, n_slices x T x F
// fp32 (2.6 MB for llama4's gate, 7.3 MB for kimi-k2's), is a small share
// of those bytes.
// Prefill (T = 8192): 687 GFLOP per gate or up call, 0.69 ms at the 989
// TFLOP/s bf16 tensor-core rate: bound by operations, hence the tensor
// cores.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/moe_gemm.py loads it with ctypes).

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;     // rows of a tile
constexpr int kCols = 128;    // output columns of a tile
constexpr int kDepth = 32;    // slice of D staged in shared memory
constexpr int kThreads = 256;
constexpr int kXPitch = kRows + 1;  // x slice stored transposed, padded
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// 16-byte loads of weight rows: 4 floats or 8 bf16 values
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __device__ static void convert(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    convert(*reinterpret_cast<const uint4*>(p), out);
  }
  __device__ static void convert(const uint4& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

constexpr int kSmemFloats = kDepth * kXPitch + kDepth * kCols;

struct Args {
  const void* x;
  const void* w;
  const int* gs;
  void* out;
  long long x_rs;  // row stride of x (elements)
  int T, D, F, E;
};

// Warp 0 maps row tile `tile` (tiles of R rows) to its expert's rows from
// the group sizes: info = (expert, first row, rows), or (-1, first row,
// rows) for a tile of the zero rows past sum(group_sizes), or expert -2
// for no work.  Each lane sums a run of experts, then a warp scan.
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 3) moe_gemm_kernel(const Args a) {
  constexpr int N = Vec<T>::N;
  constexpr int kWVecs = kDepth * kCols / N / kThreads;  // w vectors a thread loads
  constexpr int kXVals = kDepth * kRows / kThreads;      // x values a thread loads
  // the x and w slices
  __shared__ __align__(16) float smem[kSmemFloats];
  __shared__ int info[3];  // expert (-1: zero rows, -2: nothing), first row, rows

  const int tid = threadIdx.x, lane = tid % 32;
  const int tile = blockIdx.y;
  const int f0 = blockIdx.x * kCols;

  // map this row tile to its expert's rows, from the group sizes
  if (tid < 32) map_tile<kRows>(a, tile, lane, info);
  __syncthreads();
  const int e = info[0], row0 = info[1];
  if (e == -2 || row0 >= a.T) return;
  const int nrows = min(info[2], a.T - row0);
  T* out = static_cast<T*>(a.out);
  if (e == -1) {  // rows past sum(group_sizes)
    for (int i = tid; i < nrows * kCols; i += kThreads) {
      const int r = i / kCols, c = f0 + i % kCols;
      if (c < a.F) store(0.f, out + static_cast<long long>(row0 + r) * a.F + c);
    }
    return;
  }

  const T* X = static_cast<const T*>(a.x) + static_cast<long long>(row0) * a.x_rs;
  const T* W = static_cast<const T*>(a.w) + static_cast<long long>(e) * a.D * a.F;
  T* O = out + static_cast<long long>(row0) * a.F;
  float* xs = smem;                   // [kDepth][kXPitch] x slice, transposed
  float* ws = smem + kDepth * kXPitch;  // [kDepth][kCols] w slice
  const int ty = tid / 32, tx = lane;
  float xr[kXVals];
  float wr[kWVecs][N];

  auto load = [&](int k0) {  // the slice k0.. into registers
#pragma unroll
    for (int m = 0; m < kXVals; ++m) {
      const int v = tid + kThreads * m, r = v / kDepth, k = v % kDepth;
      xr[m] = (r < nrows && k0 + k < a.D) ? to_f32(X[r * a.x_rs + k0 + k]) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kWVecs; ++m) {
      const int v = tid + kThreads * m;
      const int k = v / (kCols / N), c = (v % (kCols / N)) * N;
      if (k0 + k < a.D && f0 + c < a.F) {
        Vec<T>::load(W + static_cast<long long>(k0 + k) * a.F + f0 + c, wr[m]);
      } else {
#pragma unroll
        for (int u = 0; u < N; ++u) wr[m][u] = 0.f;
      }
    }
  };
  auto stage = [&]() {  // registers into shared memory
#pragma unroll
    for (int m = 0; m < kXVals; ++m) {
      const int v = tid + kThreads * m, r = v / kDepth, k = v % kDepth;
      xs[k * kXPitch + r] = xr[m];
    }
#pragma unroll
    for (int m = 0; m < kWVecs; ++m) {
      const int v = tid + kThreads * m;
      const int k = v / (kCols / N), c = (v % (kCols / N)) * N;
#pragma unroll
      for (int u = 0; u < N; u += 4)
        *reinterpret_cast<float4*>(&ws[k * kCols + c + u]) =
            make_float4(wr[m][u], wr[m][u + 1], wr[m][u + 2], wr[m][u + 3]);
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
  for (int k0 = 0; k0 < a.D; k0 += kDepth) {
    const bool more = k0 + kDepth < a.D;
    if (more) load(k0 + kDepth);
    // a warp with no rows in the tile only loads (uniform over the warp)
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
    T* o = O + static_cast<long long>(r) * a.F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + tx + 32 * j;
      if (c < a.F) store(acc[i][j], o + c);
    }
  }
}

// ------------------------------------------------------------ streaming
// The decode route (see the note at the top)
constexpr int kSRows = 4;  // rows of a streaming tile (moe_gemm.py's STREAM_ROWS)
constexpr int kSCols = 256;          // output columns of a work item
constexpr int kSThreads = 256;
constexpr int kSUnroll = 8;          // weight vectors a thread has in flight

// dynamic shared memory of moe_stream: the threads' shares (one group of
// V threads per kSThreads / V rows of a block step), the x rows of an
// item's slice, the per-expert tables (E + 1 tile and row prefixes)
inline int stream_smem_bytes(int E, int slice) {
  return static_cast<int>(sizeof(float)) * (kSThreads / 32 * kSRows * kSCols + kSRows * slice) +
         static_cast<int>(sizeof(int)) * 2 * (E + 1);
}

template <typename T>
__global__ void __launch_bounds__(kSThreads, 2) moe_stream(const Args a, int slice, int n_slices,
                                                        float* part) {
  constexpr int N = Vec<T>::N;
  constexpr int V = kSCols / N;          // column vectors of an item: 32 or 64
  constexpr int kStep = kSThreads / V;   // D rows a block step covers: 8 or 4
  static_assert(V % 32 == 0, "a warp's lanes own distinct columns");
  extern __shared__ __align__(16) float sm[];
  float* red = sm;                                 // [kStep][kSRows][kSCols]
  float* xs = red + kStep * kSRows * kSCols;       // [kSRows][slice]
  int* t_pre = reinterpret_cast<int*>(xs + kSRows * slice);  // [E + 1] tiles before expert e
  int* r_pre = t_pre + a.E + 1;                    // [E + 1] rows before expert e

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the experts' tile and row prefixes: a run of experts per lane, a warp scan
  if (warp == 0) {
    const int per = (a.E + 31) / 32;
    const int lo = lane * per, hi = min(a.E, lo + per);
    int rows = 0, tiles = 0;
    for (int e = lo; e < hi; ++e) {
      const int g = max(a.gs[e], 0);
      rows += g;
      tiles += (g + kSRows - 1) / kSRows;
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
    int r = ri - rows, t = ti - tiles;
    for (int e = lo; e < hi; ++e) {
      t_pre[e] = t;
      r_pre[e] = r;
      const int g = max(a.gs[e], 0);
      r += g;
      t += (g + kSRows - 1) / kSRows;
    }
    if (lane == 31) {
      t_pre[a.E] = ti;
      r_pre[a.E] = ri;
    }
  }
  __syncthreads();

  const int n_cols = (a.F + kSCols - 1) / kSCols;
  const long long n_items = static_cast<long long>(t_pre[a.E]) * n_slices * n_cols;
  const int v = tid % V, grp = tid / V;
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x) {
    // consecutive blocks take consecutive column tiles of the same rows
    const int col = static_cast<int>(item % n_cols);
    const long long rest = item / n_cols;
    const int sl = static_cast<int>(rest % n_slices);
    const int tile = static_cast<int>(rest / n_slices);
    // the expert e with t_pre[e] <= tile < t_pre[e + 1]
    int lo = 0, hi = a.E - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (t_pre[mid] <= tile) lo = mid; else hi = mid - 1;
    }
    const int e = lo;
    const int k = tile - t_pre[e];
    const int row0 = r_pre[e] + k * kSRows;
    if (row0 >= a.T) continue;  // rows past T (the group sizes sum past it)
    const int nrows = min(min(kSRows, max(a.gs[e], 0) - k * kSRows), a.T - row0);
    const int k0 = sl * slice, kn = min(slice, a.D - k0);
    const int f0 = col * kSCols;

    // the item's x rows over its slice, once, as fp32
    const T* X = static_cast<const T*>(a.x) + static_cast<long long>(row0) * a.x_rs + k0;
    for (int i = tid; i < nrows * kn; i += kSThreads) {
      const int r = i / kn, kk = i % kn;
      xs[r * slice + kk] = to_f32(X[r * a.x_rs + kk]);
    }
    __syncthreads();

    // a column vector past F loads column 0 (its sums are never stored),
    // and rows past the slice load its last row (their x is not used), so
    // every load is unconditional and all kSUnroll start before the first
    // is used
    const int c = f0 + v * N < a.F ? f0 + v * N : 0;
    const T* W = static_cast<const T*>(a.w) + (static_cast<long long>(e) * a.D + k0) * a.F + c;
    const uint64_t policy = sm90::evict_first_policy();  // the weights are read once
    float acc[kSRows][N];
#pragma unroll
    for (int r = 0; r < kSRows; ++r)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[r][j] = 0.f;
    for (int kb = grp; kb < kn; kb += kStep * kSUnroll) {
      uint4 raw[kSUnroll];
#pragma unroll
      for (int u = 0; u < kSUnroll; ++u) {
        const long long kk = min(kb + u * kStep, kn - 1);
        raw[u] = sm90::ld16_hint(W + kk * a.F, policy);
      }
#pragma unroll
      for (int u = 0; u < kSUnroll; ++u) {
        const int kk = kb + u * kStep;
        if (kk >= kn) break;
        float wv[N];
        Vec<T>::convert(raw[u], wv);
#pragma unroll
        for (int r = 0; r < kSRows; ++r) {
          if (r < nrows) {
            const float xv = xs[r * slice + kk];
#pragma unroll
            for (int j = 0; j < N; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSRows; ++r) {
      if (r < nrows) {
#pragma unroll
        for (int j = 0; j < N; ++j) red[(grp * kSRows + r) * kSCols + v * N + j] = acc[r][j];
      }
    }
    __syncthreads();
    // the groups' shares summed in group order
    float* P = part + (static_cast<long long>(sl) * a.T + row0) * a.F + f0;
    for (int i = tid; i < nrows * kSCols; i += kSThreads) {
      const int r = i / kSCols, cc = i % kSCols;
      if (f0 + cc >= a.F) continue;
      float sum = 0.f;
#pragma unroll
      for (int gi = 0; gi < kStep; ++gi) sum += red[(gi * kSRows + r) * kSCols + cc];
      P[static_cast<long long>(r) * a.F + cc] = sum;
    }
    __syncthreads();  // red and xs are free for the next item
  }
}

// out[r] = the sum of the slices' partials in slice order for the rows
// below sum(group_sizes) (clamped to T), zero past it; 4 columns a thread.
template <typename T>
__global__ void __launch_bounds__(256) moe_stream_reduce(const Args a, int n_slices,
                                                         const float* part) {
  __shared__ int s_tot[8];
  int tot = 0;
  for (int e = threadIdx.x; e < a.E; e += blockDim.x) tot += max(a.gs[e], 0);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) tot += __shfl_xor_sync(kFull, tot, off);
  if (threadIdx.x % 32 == 0) s_tot[threadIdx.x / 32] = tot;
  __syncthreads();
  tot = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) tot += s_tot[w];
  const long long rows = min(static_cast<long long>(tot), static_cast<long long>(a.T));
  const long long n4 = static_cast<long long>(a.T) * a.F / 4;
  const long long stride = static_cast<long long>(a.T) * a.F;
  T* out = static_cast<T*>(a.out);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = 4 * i / a.F;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      for (int sl = 0; sl < n_slices; ++sl) {
        const float4 p = reinterpret_cast<const float4*>(part + sl * stride)[i];
        sum.x += p.x;
        sum.y += p.y;
        sum.z += p.z;
        sum.w += p.w;
      }
    }
    store(sum.x, out + 4 * i);
    store(sum.y, out + 4 * i + 1);
    store(sum.z, out + 4 * i + 2);
    store(sum.w, out + 4 * i + 3);
  }
}

// the persistent grid: as many blocks as fit on the card at once
template <typename T>
int launch_stream(const Args& a, int slice, int n_slices, float* part, cudaStream_t stream) {
  if (slice < 1 || n_slices < 1 || static_cast<long long>(slice) * n_slices < a.D ||
      part == nullptr)
    return -2;
  const int bytes = stream_smem_bytes(a.E, slice);
  cudaError_t err = cudaFuncSetAttribute(moe_stream<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, moe_stream<T>, kSThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = sms * per_sm > 0 ? sms * per_sm : 1;
  moe_stream<T><<<grid, kSThreads, bytes, stream>>>(a, slice, n_slices, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = static_cast<long long>(a.T) * a.F / 4;
  const long long want = (n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4 * sms ? want : 4 * sms);
  moe_stream_reduce<T><<<blocks > 0 ? blocks : 1, 256, 0, stream>>>(a, n_slices, part);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- wgmma
// The bf16 prefill route (see the note at the top)
constexpr int kGRows = 128;
constexpr int kGCols = 128;
constexpr int kGDepth = 64;
constexpr int kGStages = 4;
constexpr int kGThreads = 288;  // two warpgroups and the producer warp
constexpr int kGGroup = 8;      // row tiles a group of blocks walks before the next columns
constexpr int kGABytes = kGRows * kGDepth * 2;  // x slice [128][64]
constexpr int kGBBytes = kGDepth * kGCols * 2;  // w slice: two [64][64] halves
constexpr int kGStageBytes = kGABytes + kGBBytes;
constexpr int kGBarOffset = kGStages * kGStageBytes;
constexpr int kGSmem = 1024 + kGBarOffset + 2 * kGStages * 8;

__global__ void __launch_bounds__(kGThreads, 1)
    moe_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
              const Args a, int n_row_tiles, int n_col_tiles) {
  using sm90::kAtomBytes;
  using sm90::kRowBytes;
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kGBarOffset);
  uint64_t* empty = full + kGStages;
  __shared__ int info[3];

  // blocks walk kGGroup row tiles for each column tile, so the blocks in
  // flight share their x rows and w columns in L2
  const int tid = threadIdx.x, lane = tid % 32;
  const int per_group = kGGroup * n_col_tiles;
  const int first = (blockIdx.x / per_group) * kGGroup;
  const int in_group = blockIdx.x % per_group;
  const int group_rows = min(kGGroup, n_row_tiles - first);
  const int tile = first + in_group % group_rows;
  const int f0 = (in_group / group_rows) * kGCols;

  if (tid < 32) map_tile<kGRows>(a, tile, lane, info);
  __syncthreads();
  const int e = info[0], row0 = info[1];
  if (e == -2 || row0 >= a.T) return;
  const int nrows = min(info[2], a.T - row0);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  if (e == -1) {  // rows past sum(group_sizes)
    for (int i = tid; i < nrows * kGCols; i += kGThreads) {
      const int r = i / kGCols, c = f0 + i % kGCols;
      if (c < a.F) out[static_cast<long long>(row0 + r) * a.F + c] = __float2bfloat16_rn(0.f);
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
  const int nk = (a.D + kGDepth - 1) / kGDepth;

  if (tid >= 256) {  // the producer warp: its lane 0 issues every load
    if (tid == 256) {
      for (int k = 0; k < nk; ++k) {
        const int s = k % kGStages;
        if (k >= kGStages) sm90::mbar_wait(&empty[s], (k / kGStages + 1) & 1);
        uint8_t* sa = base + s * kGStageBytes;
        uint8_t* sb = sa + kGABytes;
        sm90::mbar_expect_tx(&full[s], kGStageBytes);
        // x rows past T, and columns past D, read zeros; so do w rows
        // past D and columns past F (a 3-D map: expert e's slice never
        // reads expert e + 1's rows)
        sm90::tma_load_2d(sa, &xmap, &full[s], k * kGDepth, row0);
        sm90::tma_load_3d(sb, &wmap, &full[s], f0, k * kGDepth, e);
        sm90::tma_load_3d(sb + kGDepth * kRowBytes, &wmap, &full[s], f0 + 64, k * kGDepth, e);
      }
    }
    return;
  }

  // consumer warpgroup g: rows 64 g.. of the tile
  const int g = tid / 128, warp = (tid % 128) / 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < nk; ++k) {
    const int s = k % kGStages;
    const uint8_t* sa = base + s * kGStageBytes + g * 64 * kRowBytes;
    const uint8_t* sb = base + s * kGStageBytes + kGABytes;
    sm90::mbar_wait(&full[s], (k / kGStages) & 1);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGDepth / 16; ++kk) {
      // x K-major; w MN-major, its two 64-column halves kGDepth rows apart
      sm90::wgmma_ss_n128<1>(acc, sm90::desc(sa + kk * 32, 16, kAtomBytes),
                             sm90::desc(sb + kk * 16 * kRowBytes, kGDepth * kRowBytes,
                                        kAtomBytes),
                             1);
    }
    sm90::wgmma_commit();
    // the previous slice's products are done: release its stage
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
    if (k > 0) sm90::mbar_arrive(&empty[(k - 1) % kGStages]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);

  // store the tile's own rows (the slices may hold the next expert's)
  const int rb = 64 * g + 16 * warp + (tid % 32) / 4, c2 = 2 * (tid % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = rb + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* o = out + static_cast<long long>(row0 + row) * a.F;
#pragma unroll
    for (int j = 0; j < kGCols / 8; ++j) {
      const int c = f0 + 8 * j + c2;
      if (c < a.F)
        *reinterpret_cast<__nv_bfloat162*>(o + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

// x [T, D] (row stride x_rs) as a 2-D map with [64 columns][128 rows]
// boxes, w [E, D, F] as a 3-D map with [64 columns][64 rows] boxes; then
// the launch over every (row tile, column tile) pair
int launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap xm, wm;
  const uint64_t xdims[2] = {static_cast<uint64_t>(a.D), static_cast<uint64_t>(a.T)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(a.x_rs) * 2};
  const uint32_t xbox[2] = {kGDepth, kGRows};
  const uint64_t wdims[3] = {static_cast<uint64_t>(a.F), static_cast<uint64_t>(a.D),
                             static_cast<uint64_t>(a.E)};
  const uint64_t wstrides[2] = {static_cast<uint64_t>(a.F) * 2,
                                static_cast<uint64_t>(a.D) * a.F * 2};
  const uint32_t wbox[3] = {64, kGDepth, 1};
  int err = sm90_host::make_map(&xm, a.x, 2, xdims, xstrides, xbox);
  if (err == 0) err = sm90_host::make_map(&wm, a.w, 3, wdims, wstrides, wbox);
  if (err != 0) return err;
  const cudaError_t attr =
      cudaFuncSetAttribute(moe_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_row_tiles = (a.T + kGRows - 1) / kGRows + a.E;
  const int n_col_tiles = (a.F + kGCols - 1) / kGCols;
  moe_wgmma<<<n_row_tiles * n_col_tiles, kGThreads, kGSmem, stream>>>(xm, wm, a, n_row_tiles,
                                                                        n_col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the grouped GEMM on `stream` by `route`; returns
// cudaGetLastError() (0 = ok), -1 for a dtype the route does not take,
// -3 or -4 when a TMA tensor map cannot be made (no driver entry point; an
// address or stride not a multiple of 16 bytes) and -5 for an unknown
// route.  x [T, D] (row stride x_rs, last dimension contiguous), w [E, D,
// F] contiguous, group_sizes [E] int32 and out [T, F] contiguous are
// device pointers; dtype 0 = float32, 1 = bfloat16 (x, w and out).
// F % 8 == 0.  Routes: 0 = moe_gemm_kernel (64-row tiles of fp32 FMAs),
// 1 = moe_wgmma (bfloat16, 128-row
// tiles on the tensor cores), 2 = moe_stream (D in n_slices slices of
// `slice` rows, partial sums in `scratch`, n_slices * T * F floats, then
// moe_stream_reduce; -2 for a split that does not cover D); the other
// routes ignore slice, n_slices and scratch.
int repro_moe_gemm(const void* x, const void* w, const void* group_sizes,
                   void* out, long long x_rs, int T, int D, int F, int E,
                   int dtype, int route, int slice, int n_slices, void* scratch,
                   void* stream) {
  if (T == 0 || F == 0) return 0;
  const Args a{x, w, static_cast<const int*>(group_sizes), out, x_rs, T, D, F, E};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  if (route == 1) return dtype == 1 ? launch_wgmma(a, s) : -1;
  if (route == 2) {
    if (dtype == 0) return launch_stream<float>(a, slice, n_slices, part, s);
    if (dtype == 1) return launch_stream<__nv_bfloat16>(a, slice, n_slices, part, s);
    return -1;
  }
  if (route != 0) return -5;
  const dim3 grid((F + kCols - 1) / kCols, (T + kRows - 1) / kRows + E);
  if (dtype == 0) {
    moe_gemm_kernel<float><<<grid, kThreads, 0, s>>>(a);
  } else if (dtype == 1) {
    moe_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
