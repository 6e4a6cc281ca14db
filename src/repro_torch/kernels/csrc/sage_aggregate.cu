// GraphSAGE masked neighbour mean on Hopper: the forward as a register
// gather on every SM, and a deterministic backward over a transposed CSR.
//
// Replaces the TPU kernel repro.kernels.sage_aggregate.sage_aggregate
// (Pallas body `_kernel`, src/repro/kernels/sage_aggregate.py), the
// aggregation of every GraphSAGE layer.  For each output row m:
//
//   out[m, :] = (sum over j = 0..K-1 with idx[m, j] >= 0 of x[idx[m, j], :])
//               / max(count, 1)
//
// accumulated in fp32 from 0 in j order, divided in IEEE fp32 (no fast
// math), and stored in x's type (fp32, or bf16 rounded to nearest even).
// Rows whose K ids are all padding (-1) give 0.  The sum visits the rows
// in the same order as the plain version (repro_torch/kernels/
// sage_aggregate.py::sage_aggregate_plain) and the Pallas kernel, with no
// multiply to contract, so in fp32 the result equals theirs bit for bit.
//
// What bounds it on an H100: bytes.  Each valid id pulls one feature row
// and adds it once; the ids of one batch name each distinct row ~4.4
// times, so most gathered bytes come out of L2, not HBM, and the gather's
// rate out of L2 and its latency are what the design works on:
//
//   * Forward: a persistent grid (as many 256-thread blocks as fit on the
//     card) walks tiles of R output rows by W values; a thread takes one
//     (row, vector) pair, R = 256 / (vectors a row), so at F = 100 in fp32
//     250 of 256 threads work (a warp a row leaves 7 of 32 lanes idle)
//     and 2000 rows spread over every SM.  Each thread issues the loads of
//     its vector of up to 8 rows before its first add, with the widest
//     access the row allows (16, 8, 4 or 2 bytes: bf16 at F = 100 moves 8
//     bytes a lane), and fetches the next 8 ids before adding, so their
//     latency hides behind the rows'.  Forwards that gather the rows by
//     1-D TMA bulk copies into a ring of shared-memory stages (the Hopper
//     form of the Pallas kernel's per-row make_async_copy) or by cp.async
//     into per-thread shared-memory rings (csrc/sage_gather_probes.cu)
//     were slower at each of the main path's three shapes on an H100, and
//     so was this kernel with L2 policies (x evict-last, the output
//     evict-first) inside a training step (sage_ablate.py).
//   * The gather probe: the same loads, with no arithmetic and no stores.
//   * Backward (fp32): grad_x[r] = sum over the flat positions p = m K + j
//     with idx[m, j] == r, ascending in p, of grad_out[m] / max(count_m, 1).
//     Four kernels around a scan of the counts (torch.cumsum, between the
//     first two): `bwd_prep` counts each row's ids (integer atomics: the
//     counts are exact) and scales grad_out by each output row's count;
//     `bwd_fill` groups the positions by row (atomics again, so a
//     segment's order is arbitrary); `bwd_long` gives each segment of more
//     than 32 positions a block, which sorts it by a bitmap of the flat
//     positions in shared memory (one pass over M K / 32 words; a bitonic
//     network in device memory when the bitmap does not fit) and streams
//     its rows through a two-stage cp.async ring, so that a hub named
//     thousands of times costs the bytes of its rows, not n^2; `bwd_sum`
//     gives each (row, column chunk) of a shorter segment a warp, which
//     sorts the positions in its registers (one a lane) and gathers the
//     scaled rows with 16-byte loads, four positions in flight.  The
//     segments of a batch are short (4.4 positions on average at layer
//     0).  Ascending p is the order in which the CPU's index_add_ adds,
//     so fp32 gradients equal the plain version's
//     (sage_aggregate_backward_plain) bit for bit and repeat run to run;
//     nothing syncs with the host.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/sage_aggregate.py loads it with ctypes;
// forward_plan there picks the access width and the tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"  // cp.async

namespace {

constexpr int kThreads = 256;  // threads of every block of this file
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// VEC consecutive values of type T, moved as one access of their size
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <int B> struct Word;
template <> struct Word<16> { using type = uint4; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<4> { using type = unsigned; };
template <> struct Word<2> { using type = unsigned short; };

// VEC values at p as one load of their size through the read-only path (x
// is read-only in the kernel, so the loads may be scheduled together)
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  using Wd = typename Word<sizeof(T) * VEC>::type;
  const Wd w = __ldg(reinterpret_cast<const Wd*>(p));
  Pack<T, VEC> out;
  memcpy(&out, &w, sizeof(w));
  return out;
}

// the mean of the sums: acc / max(cnt, 1) rounded to T, stored at p
template <typename T, int VEC>
__device__ __forceinline__ void store_mean(T* p, const float (&acc)[VEC], int cnt) {
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  Pack<T, VEC> q;
#pragma unroll
  for (int v = 0; v < VEC; ++v) from_f32(acc[v] / denom, &q.v[v]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = q;
}

// the tiles: row group g (R rows) times column chunk c (W values), in
// order t = g * C + c, block b taking t = b, b + gridDim.x, ...
struct Tiles {
  int C;          // column chunks
  long long n;    // tiles
  __device__ Tiles(int M, int F, int W, int R)
      : C((F + W - 1) / W), n(static_cast<long long>((M + R - 1) / R) * C) {}
  __device__ int row0(long long t, int R) const { return static_cast<int>(t / C) * R; }
  __device__ int col0(long long t, int W) const { return static_cast<int>(t % C) * W; }
};

constexpr int kIds = 8;  // ids a thread loads rows for before its first add

// ids j0 .. j0 + kIds - 1 of output row m (-1 past the row's end or M)
__device__ __forceinline__ void load_ids(int (&id)[kIds], const int* idx, int m, int M,
                                         int K, int j0) {
  const int* row = idx + static_cast<size_t>(m) * K;
#pragma unroll
  for (int u = 0; u < kIds; ++u) id[u] = m < M && j0 + u < K ? __ldg(row + j0 + u) : -1;
}

// The forward.  A block's 256 threads map to (row r, vector v) pairs of a
// tile of R rows by W values (L = W / VEC vectors a row, R = 256 / L); the
// grid is persistent, as many blocks as fit on the card, walking the
// tiles.  Each thread issues the loads of its vector of up to kIds rows,
// then adds them in j order; the next kIds ids (this tile's or the next
// tile's) are fetched before the adds, so their latency hides behind
// this chunk's.  PROBE: the same loads, folded into one register and never stored (the
// gather probe: the loads' cost without the arithmetic).
template <typename T, int VEC, bool PROBE>
__global__ void __launch_bounds__(kThreads)
    sage_fwd(const T* __restrict__ x, const int* __restrict__ idx, T* __restrict__ out, int N,
             int M, int K, int F, int W, int R) {
  const Tiles tiles(M, F, W, R);
  const int L = W / VEC;
  const int r = threadIdx.x / L, v = threadIdx.x - r * L;
  if (r >= R || blockIdx.x >= tiles.n) return;
  unsigned fold = 0;
  int id[kIds];
  long long t = blockIdx.x;
  load_ids(id, idx, tiles.row0(t, R) + r, M, K, 0);
  for (; t < tiles.n; t += gridDim.x) {
    const int m = tiles.row0(t, R) + r, col = tiles.col0(t, W) + v * VEC;
    const bool active = m < M && col < F;
    const T* src = x + (active ? col : 0);
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    int cnt = 0;
    for (int j0 = 0;;) {
      // padding loads row 0 (unused): no branch between the loads
      Pack<T, VEC> p[kIds];
      if (N > 0) {
#pragma unroll
        for (int u = 0; u < kIds; ++u)
          p[u] = load_pack<T, VEC>(src + static_cast<size_t>(id[u] > 0 ? id[u] : 0) * F);
      }
      int cur[kIds];
#pragma unroll
      for (int u = 0; u < kIds; ++u) cur[u] = id[u];
      const bool more = j0 + kIds < K;
      load_ids(id, idx, more ? m : tiles.row0(t + gridDim.x, R) + r, M, K,
               more ? j0 + kIds : 0);
      if (N > 0) {
#pragma unroll
        for (int u = 0; u < kIds; ++u) {
          if (cur[u] < 0) continue;  // padding adds nothing
          ++cnt;
          if (PROBE) {
            fold ^= __float_as_uint(to_f32(p[u].v[0]));
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] += to_f32(p[u].v[e]);
          }
        }
      }
      if (!more) break;
      j0 += kIds;
    }
    if (!PROBE && active)
      store_mean<T, VEC>(out + static_cast<size_t>(m) * F + col, acc, cnt);
  }
  if (PROBE && fold == 0x7fc00001u) out[0] = T();  // never (keeps the loads)
}

// Backward 1: a warp per output row m counts its valid ids into count[id]
// and writes g[m] = grad_out[m] / max(count_m, 1)
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    sage_bwd_prep(const float* __restrict__ go, const int* __restrict__ idx,
                  int* __restrict__ count, float* __restrict__ g, int M, int K, int F) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int m = blockIdx.x * kWarps + (threadIdx.x >> 5); m < M; m += warps) {
    int cnt = 0;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int j = j0 + lane;
      const int id = j < K ? idx[static_cast<size_t>(m) * K + j] : -1;
      if (id >= 0) atomicAdd(count + id, 1);
      cnt += __popc(__ballot_sync(kFull, id >= 0));
    }
    const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
    for (int c = lane * VEC; c < F; c += 32 * VEC) {
      Pack<float, VEC> p =
          *reinterpret_cast<const Pack<float, VEC>*>(go + static_cast<size_t>(m) * F + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) p.v[e] = p.v[e] / denom;
      *reinterpret_cast<Pack<float, VEC>*>(g + static_cast<size_t>(m) * F + c) = p;
    }
  }
}

// Backward 2: each valid flat position p into its row's segment
// [incl[id] - count0[id], incl[id]) of `pos` (count is left at 0)
__global__ void __launch_bounds__(kThreads)
    sage_bwd_fill(const int* __restrict__ idx, const int* __restrict__ incl,
                  int* __restrict__ count, int* __restrict__ pos, int n) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n; p += gridDim.x * kThreads) {
    const int id = idx[p];
    if (id >= 0) pos[incl[id] - atomicSub(count + id, 1)] = p;
  }
}

constexpr int kShort = 32;      // segments bwd_sum takes (a position a lane), at most
constexpr int kWindow = 1024;   // columns bwd_long stages at once, at most

// copies of 4 or 16 bytes from global to shared memory, not waited for
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    sm90::cp_async16(dst, src, 16);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sm90::smem_u32(dst)),
                 "l"(src)
                 : "memory");
  }
}

// the exclusive prefix sum of v over the block's threads (all of them call it)
__device__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();  // warp_sums is rewritten by the next scan
  return before + incl - v;
}

// seg[0 .. n) (distinct flat positions below MK) replaced by their output
// rows (position / K) in ascending order of position, by the block.  With
// a bitmap of the positions in shared memory (bits, ceil(MK / 32) words)
// when `bits` is not null: each thread then reads out the set bits of its
// run of words at its offset (a scan of the runs' counts).  Else a
// bitonic network in place, through L2, whose comparators all put the
// smaller value first (each merge starts by comparing i with its mirror)
// over the next power of two P >= n; an index past n holds +infinity, so
// a comparator that reaches one does nothing.
__device__ void sort_rows(int* seg, int n, int K, int MK, unsigned* bits, int* warp_sums) {
  if (bits != nullptr) {
    const int words = (MK + 31) / 32;
    for (int w = threadIdx.x; w < words; w += kThreads) bits[w] = 0u;
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int p = __ldcg(seg + k);
      atomicOr(bits + (p >> 5), 1u << (p & 31));
    }
    __syncthreads();
    const int per = (words + kThreads - 1) / kThreads;
    const int w0 = threadIdx.x * per, w1 = w0 + per < words ? w0 + per : words;
    int mine = 0;
    for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
    int at = block_exclusive_scan(mine, warp_sums);
    for (int w = w0; w < w1; ++w)
      for (unsigned b = bits[w]; b != 0u; b &= b - 1u)
        __stcg(seg + at++, (w * 32 + __ffs(b) - 1) / K);
    __syncthreads();
    return;
  }
  int P = 2 * kShort;
  while (P < n) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < P / 2; t += kThreads) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j of i clear
        const int q = j == k >> 1 ? i ^ (k - 1) : i + j;
        if (q >= n) continue;
        const int x = __ldcg(seg + i), y = __ldcg(seg + q);
        if (x > y) {
          __stcg(seg + i, y);
          __stcg(seg + q, x);
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += kThreads) __stcg(seg + i, __ldcg(seg + i) / K);
  __syncthreads();
}

// Backward 3: each segment longer than kShort, put in order and summed by
// a block.  Block b reads the lengths of rows b, b + gridDim.x, ... 256 at
// a time (so that neighbouring hubs fall to different blocks) and takes
// the long ones among them one by one: it sorts the positions into output
// rows (sort_rows; pos is scratch), then streams the rows' columns, a
// window of up to kWindow at a time, through a two-stage ring of D rows
// in shared memory by cp.async copies of VB bytes, which need no registers,
// so a stage's D rows are in flight while the other stage is summed, a
// thread a column in order.  Dynamic shared memory: the ring (2 D kWindow
// floats, or 2 D F when F is smaller), then the bitmap (ceil(MK / 32)
// words, MK = M K) when `bitmap` is set.
template <int VB>
__global__ void __launch_bounds__(kThreads)
    sage_bwd_long(const float* __restrict__ g, const int* __restrict__ incl, int* pos,
                  float* __restrict__ gx, int N, int F, int K, int MK, int D, int bitmap) {
  extern __shared__ __align__(16) float rows_smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned long_rows[kWarps];
  constexpr int VEC = VB / 4;
  const int Wmax = F < kWindow ? F : kWindow;
  unsigned* bits = bitmap ? reinterpret_cast<unsigned*>(rows_smem + 2 * D * Wmax) : nullptr;
  const long long G = gridDim.x;
  for (long long i0 = 0; blockIdx.x + i0 * G < N; i0 += kThreads) {
    const long long r = blockIdx.x + (i0 + threadIdx.x) * G;
    const int n = r < N ? incl[r] - (r > 0 ? incl[r - 1] : 0) : 0;
    const unsigned found = __ballot_sync(kFull, n > kShort);
    if ((threadIdx.x & 31) == 0) long_rows[threadIdx.x >> 5] = found;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      for (unsigned lr = long_rows[w]; lr != 0u; lr &= lr - 1u) {
        const long long row = blockIdx.x + (i0 + w * 32 + __ffs(lr) - 1) * G;
        const int start = row > 0 ? incl[row - 1] : 0, len = incl[row] - start;
        int* seg = pos + start;
        sort_rows(seg, len, K, MK, bits, warp_sums);
        for (int c0 = 0; c0 < F; c0 += kWindow) {
          const int W = F - c0 < kWindow ? F - c0 : kWindow;
          const int pieces = W / VEC;  // a row's copies in this window
          const int rounds = (len + D - 1) / D;
          // round i's rows into stage i % 2
          auto issue = [&](int i) {
            float* stage = rows_smem + (i & 1) * D * Wmax;
            const int k0 = i * D, here = len - k0 < D ? len - k0 : D;
            for (int q = threadIdx.x; q < here * pieces; q += kThreads) {
              const int k = q / pieces, e = (q - k * pieces) * VEC;
              cp_async<VB>(stage + k * W + e,
                           g + static_cast<size_t>(seg[k0 + k]) * F + c0 + e);
            }
            sm90::cp_async_commit();
          };
          float acc[kWindow / kThreads];
#pragma unroll
          for (int h = 0; h < kWindow / kThreads; ++h) acc[h] = 0.0f;
          issue(0);
          for (int i = 0; i < rounds; ++i) {
            if (i + 1 < rounds) {
              issue(i + 1);
              sm90::cp_async_wait<1>();
            } else {
              sm90::cp_async_wait<0>();
            }
            __syncthreads();  // round i has landed, every thread's copies
            const float* stage = rows_smem + (i & 1) * D * Wmax;
            const int here = len - i * D < D ? len - i * D : D;
#pragma unroll
            for (int h = 0; h < kWindow / kThreads; ++h) {
              const int c = h * kThreads + threadIdx.x;
              if (c < W)
                for (int k = 0; k < here; ++k) acc[h] += stage[k * W + c];
            }
            __syncthreads();  // stage i % 2 is read: round i + 2 may take it
          }
#pragma unroll
          for (int h = 0; h < kWindow / kThreads; ++h) {
            const int c = h * kThreads + threadIdx.x;
            if (c < W) gx[static_cast<size_t>(row) * F + c0 + c] = acc[h];
          }
        }
      }
    }
    __syncthreads();  // long_rows is rewritten next round
  }
}

// v across the warp's lanes, ascending from lane 0 (a bitonic network of
// shuffles)
__device__ __forceinline__ int warp_sort(int v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int o = __shfl_xor_sync(kFull, v, j);
      v = ((lane & j) == 0) == ((lane & k) == 0) ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// Backward 4: a warp per (row r, chunk of 64 VEC columns) of a row whose
// segment of pos, [incl[r - 1], incl[r]), holds at most kShort positions
// (bwd_long writes the others), two accesses a lane: the positions are
// loaded one a lane and sorted in registers, each one's output row
// broadcast U at a time and the U scaled rows loaded before the first add.
// The next item's segment is fetched while this one is summed.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    sage_bwd_sum(const float* __restrict__ g, const int* __restrict__ incl,
                 const int* __restrict__ pos, float* __restrict__ gx, int N, int F, int K) {
  constexpr int U = 4;
  constexpr int W = 64 * VEC;
  const int lane = threadIdx.x & 31;
  const int C = (F + W - 1) / W;
  const long long items = static_cast<long long>(N) * C;
  const int warps = gridDim.x * kWarps;
  // item i's segment length n (warp-uniform) and its position `lane`
  // (INT_MAX past the end, or for a long segment)
  auto segment = [&](long long i, int& n, int& mine) {
    const int r = static_cast<int>((i < items ? i : 0) / C);
    const int start = r > 0 ? incl[r - 1] : 0;
    n = i < items ? incl[r] - start : 0;
    mine = lane < n && n <= kShort ? pos[start + lane] : INT_MAX;
  };
  long long it = blockIdx.x * kWarps + (threadIdx.x >> 5);
  int n, mine;
  segment(it, n, mine);
  for (; it < items; it += warps) {
    int next_n, next_mine;
    segment(it + warps, next_n, next_mine);
    if (n <= kShort) {  // warp-uniform
      const int r = static_cast<int>(it / C), c0 = static_cast<int>(it % C) * W;
      mine = warp_sort(mine, lane);
      const int row = mine == INT_MAX ? 0 : mine / K;  // past the end: row 0, not added
      int col[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) col[h] = c0 + (h * 32 + lane) * VEC;
      float acc[2][VEC];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] = 0.0f;
      for (int u0 = 0; u0 < n; u0 += U) {
        int ms[U];
#pragma unroll
        for (int u = 0; u < U; ++u) ms[u] = __shfl_sync(kFull, row, u0 + u);
        Pack<float, VEC> val[U][2];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            val[u][h] = *reinterpret_cast<const Pack<float, VEC>*>(
                g + static_cast<size_t>(ms[u]) * F + (col[h] < F ? col[h] : 0));
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u0 + u >= n) break;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[h][e] += val[u][h].v[e];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (col[h] >= F) continue;
        Pack<float, VEC> q;
#pragma unroll
        for (int e = 0; e < VEC; ++e) q.v[e] = acc[h][e];
        *reinterpret_cast<Pack<float, VEC>*>(gx + static_cast<size_t>(r) * F + col[h]) = q;
      }
    }
    n = next_n;
    mine = next_mine;
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// a persistent grid: as many blocks as fit on the card at once, at most
// one a unit of work
template <typename Kernel>
int persistent_blocks(Kernel kernel, long long work) {
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long cap = static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(work < cap ? work : cap);
}

template <typename T, int VEC>
int launch_fwd(const void* x, const void* idx, void* out, int N, int M, int K, int F, int W,
               int R, int probe, cudaStream_t stream) {
  auto kernel = probe ? sage_fwd<T, VEC, true> : sage_fwd<T, VEC, false>;
  const long long tiles = static_cast<long long>((M + R - 1) / R) * ((F + W - 1) / W);
  kernel<<<persistent_blocks(kernel, tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx), static_cast<T*>(out), N, M, K, F,
      W, R);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_vec(const void* x, const void* idx, void* out, int N, int M, int K, int F, int W,
                   int R, int vec_bytes, int probe, cudaStream_t stream) {
  switch (vec_bytes / static_cast<int>(sizeof(T))) {
    case 1: return launch_fwd<T, 1>(x, idx, out, N, M, K, F, W, R, probe, stream);
    case 2: return launch_fwd<T, 2>(x, idx, out, N, M, K, F, W, R, probe, stream);
    case 4: return launch_fwd<T, 4>(x, idx, out, N, M, K, F, W, R, probe, stream);
    case 8:
      if constexpr (sizeof(T) == 2) {
        return launch_fwd<T, 8>(x, idx, out, N, M, K, F, W, R, probe, stream);
      }
      return -1;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// The forward on `stream`; returns cudaGetLastError() (0 = ok) or -1 for
// an argument the kernel does not take.  Device pointers to C-contiguous
// arrays: x [N, F] (dtype 0 = float32, 1 = bfloat16), idx [M, K] int32
// with ids in [0, N) or -1, out [M, F] of x's dtype.  The plan comes from
// the caller (sage_aggregate.py::forward_plan): accesses of vec_bytes
// (16, 8, 4 or 2; F, x and out aligned to them), tiles of R rows by W
// values (R W / (values an access) <= 256).  probe = 1 issues the loads
// alone and writes nothing (the gather probe).
int repro_sage_aggregate(const void* x, const void* idx, void* out, int N, int M, int K, int F,
                         int dtype, int vec_bytes, int W, int R, int probe, void* stream) {
  if (M == 0 || F == 0) return 0;
  const int elt = dtype == 0 ? 4 : 2;
  if (vec_bytes < elt || vec_bytes % elt != 0 || W <= 0 || W % (vec_bytes / elt) != 0 ||
      R <= 0 || R * (W / (vec_bytes / elt)) > kThreads)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_vec<float>(x, idx, out, N, M, K, F, W, R, vec_bytes, probe, st);
  if (dtype == 1)
    return launch_fwd_vec<__nv_bfloat16>(x, idx, out, N, M, K, F, W, R, vec_bytes, probe, st);
  return -1;
}

// Backward 1 (fp32): count (int32 [N], zeroed by the caller) += each valid
// id of idx [M, K]; g [M, F] = grad_out [M, F] / max(row count, 1);
// grad_out and g accessed `vec` floats at a time (1, 2 or 4).
int repro_sage_bwd_prep(const void* go, const void* idx, void* count, void* g, int M, int K,
                        int F, int vec, void* stream) {
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(go);
  const int* i = static_cast<const int*>(idx);
  int* c = static_cast<int*>(count);
  float* o = static_cast<float*>(g);
  const long long work = (M + kWarps - 1) / kWarps;
  if (vec == 4) {
    sage_bwd_prep<4><<<persistent_blocks(sage_bwd_prep<4>, work), kThreads, 0, st>>>(
        a, i, c, o, M, K, F);
  } else if (vec == 2) {
    sage_bwd_prep<2><<<persistent_blocks(sage_bwd_prep<2>, work), kThreads, 0, st>>>(
        a, i, c, o, M, K, F);
  } else if (vec == 1) {
    sage_bwd_prep<1><<<persistent_blocks(sage_bwd_prep<1>, work), kThreads, 0, st>>>(
        a, i, c, o, M, K, F);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward 2: pos [n] (n = M K) gets each valid flat position of idx in
// its row's segment; incl [N] is the inclusive scan of the counts, which
// `count` holds on entry and 0 on exit.
int repro_sage_bwd_fill(const void* idx, const void* incl, void* count, void* pos, int n,
                        void* stream) {
  if (n == 0) return 0;
  const int blocks = persistent_blocks(sage_bwd_fill, (n + kThreads - 1) / kThreads);
  sage_bwd_fill<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int*>(incl), static_cast<int*>(count),
      static_cast<int*>(pos), n);
  return static_cast<int>(cudaGetLastError());
}

// Backward 3: the rows of grad_x [N, F] (fp32) whose segment of pos
// holds more than 32 positions, from g [M, F]; pos is left with those
// segments' output rows in order.  incl [N] as for the fill, MK = M K;
// `vec` 4 when F % 4 == 0 and g is 16-byte aligned (16-byte copies), else
// 1.  A stage of the ring holds D rows (of at most 1024 columns); the
// bitmap takes ceil(MK / 32) words of shared memory, and is left out (the
// sort then runs in device memory) when `bitmap` is 0.
int repro_sage_bwd_long(const void* g, const void* incl, void* pos, void* gx, int N, int F,
                        int K, int MK, int D, int bitmap, int vec, void* stream) {
  if (N == 0 || F == 0) return 0;
  const int Wmax = F < kWindow ? F : kWindow;
  const long long smem = 2LL * D * Wmax * 4 + (bitmap ? (MK + 31LL) / 32 * 4 : 0);
  if (D <= 0 || smem > 220 * 1024 || (vec != 4 && vec != 1)) return -1;
  auto kernel = vec == 4 ? sage_bwd_long<16> : sage_bwd_long<4>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                static_cast<size_t>(smem));
  const long long work = (N + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(work < cap ? work : cap), kThreads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(incl), static_cast<int*>(pos),
      static_cast<float*>(gx), N, F, K, MK, D, bitmap);
  return static_cast<int>(cudaGetLastError());
}

// Backward 4: the other rows of grad_x [N, F] (fp32), those whose
// segment holds at most 32 positions, from g [M, F], the scan incl [N] and
// the segments pos; `vec` floats an access (1, 2 or 4; g and grad_x
// 16-byte aligned for 4).
int repro_sage_bwd_sum(const void* g, const void* incl, const void* pos, void* gx, int N, int F,
                       int K, int vec, void* stream) {
  if (N == 0 || F == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(g);
  const int* s = static_cast<const int*>(incl);
  const int* p = static_cast<const int*>(pos);
  float* o = static_cast<float*>(gx);
  const long long items = static_cast<long long>(N) * ((F + 64 * vec - 1) / (64 * vec));
  const long long work = (items + kWarps - 1) / kWarps;
  if (vec == 4) {
    sage_bwd_sum<4><<<persistent_blocks(sage_bwd_sum<4>, work), kThreads, 0, st>>>(
        a, s, p, o, N, F, K);
  } else if (vec == 2) {
    sage_bwd_sum<2><<<persistent_blocks(sage_bwd_sum<2>, work), kThreads, 0, st>>>(
        a, s, p, o, N, F, K);
  } else if (vec == 1) {
    sage_bwd_sum<1><<<persistent_blocks(sage_bwd_sum<1>, work), kThreads, 0, st>>>(
        a, s, p, o, N, F, K);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
