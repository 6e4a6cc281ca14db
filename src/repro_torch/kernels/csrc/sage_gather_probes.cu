// Ablations, not kernels of the port: GraphSAGE's forward with its rows
// gathered by Hopper's asynchronous copies, whole and the copies alone.
//
// Two forms of the Pallas kernel's per-row make_async_copy
// (src/repro/kernels/sage_aggregate.py) on this card, each as a whole
// forward (fp32, 16-byte rows: the same sums in the same order, so equal
// to the plain version bit for bit) and as its copies alone:
//
//   * `bulk_mean` / `bulk_gather`: one block a tile walk over tiles of R
//     output rows by a chunk of the row, each valid id's chunk fetched by
//     one 1-D TMA bulk copy (cp.async.bulk) into a ring of S shared-memory
//     stages, completion counted in bytes on the stage's mbarrier; the
//     mean sums each stage from shared memory with the register kernel's
//     (row, 16-byte vector) thread map;
//   * `async_mean` / `async_gather`: the register kernel's tiles and
//     thread map, each thread copying its vectors of up to kIds (whole)
//     or kRingIds (copies alone) rows by cp.async into a ring of S
//     stages of its own, waiting on its own copy groups.
//
// sage_ablate.py compiles this file appended to a copy of
// sage_aggregate.cu (the whole forms use that file's tiles, id loads and
// stores, and its anonymous namespace) and times all four against the
// register forward at the main path's shapes.  Built with nvcc for sm_90a
// into a shared library with a plain C interface, like the port's kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBarBytes = 128;  // the bulk rings' mbarriers, at most 16
constexpr int kRingIds = 16;    // the cp.async probe's slots a stage, at most

// the bulk rings' dynamic shared memory: S mbarriers (kBarBytes), the ids
// of S stages (S x R K ints, rounded up to 128 bytes), then the chunks of
// S stages (S x R K slots of `chunk` bytes)
__device__ __forceinline__ unsigned char* bulk_rows(unsigned char* smem, int S, int RK) {
  return smem + kBarBytes + ((S * RK * 4 + 127) / 128) * 128;
}

// Tile i of this block (R rows by a chunk of `chunk` bytes at c0) into
// stage s: every thread fetches the ids of its slots (contiguous in idx)
// and copies their chunks, each copy first adding its bytes to the
// stage's expected count; one arrival after all of them opens the phase's
// completion.  Padding copies nothing.
__device__ __forceinline__ void bulk_issue(const char* x, const int* idx, uint64_t* bar,
                                           int* ids, unsigned char* rows, long long first,
                                           long long last, int RK, int row_bytes, int c0,
                                           unsigned bytes, int chunk) {
  for (int q = threadIdx.x; q < RK; q += kThreads) {
    const int id = first + q < last ? idx[first + q] : -1;
    ids[q] = id;
    if (id >= 0) {
      sm90::mbar_expect_tx_only(bar, bytes);
      sm90::bulk_load(rows + static_cast<size_t>(q) * chunk,
                      x + static_cast<size_t>(id) * row_bytes + c0, bytes, bar);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) sm90::mbar_arrive(bar);
}

// The whole forward by bulk copies (fp32, F % 4 == 0, x 16-byte aligned):
// tiles of R rows by `chunk` values (C chunks a row); thread (r, v) sums
// vector v of row r of the stage in j order, skipping padding, and
// stores the mean; the stage then takes the tile S later.
__global__ void __launch_bounds__(kThreads)
    bulk_mean(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
              int M, int K, int F, int chunk, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int RK = R * K;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* ids = reinterpret_cast<int*>(smem + kBarBytes);
  unsigned char* rows = bulk_rows(smem, S, RK);
  const int C = (F + chunk - 1) / chunk;
  const long long n_tiles = static_cast<long long>((M + R - 1) / R) * C;
  const int n_mine = blockIdx.x < n_tiles
                         ? static_cast<int>((n_tiles - 1 - blockIdx.x) / gridDim.x + 1)
                         : 0;
  const int L = chunk / 4;
  const int r = threadIdx.x / L, v = threadIdx.x - r * L;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) sm90::mbar_init(&bars[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int i) {
    const long long t = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    const int s = i % S, c0 = static_cast<int>(t % C) * chunk;
    const int w = chunk < F - c0 ? chunk : F - c0;
    bulk_issue(reinterpret_cast<const char*>(x), idx, &bars[s], ids + s * RK,
               rows + static_cast<size_t>(s) * RK * chunk * 4, (t / C) * R * K,
               static_cast<long long>(M) * K, RK, F * 4, c0 * 4, static_cast<unsigned>(w * 4),
               chunk * 4);
  };
  for (int i = 0; i < S && i < n_mine; ++i) issue(i);
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % S;
    sm90::mbar_wait(&bars[s], (i / S) & 1);
    const long long t = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    const int m = static_cast<int>(t / C) * R + r;
    const int col = static_cast<int>(t % C) * chunk + v * 4;
    if (r < R && m < M && col < F) {
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int cnt = 0;
      const int* id = ids + s * RK + r * K;
      const float* src =
          reinterpret_cast<const float*>(rows) + (static_cast<size_t>(s) * RK + r * K) * chunk +
          v * 4;
      for (int j = 0; j < K; ++j) {
        if (id[j] < 0) continue;  // padding adds nothing
        ++cnt;
        const float4 p = *reinterpret_cast<const float4*>(src + static_cast<size_t>(j) * chunk);
        acc[0] += p.x;
        acc[1] += p.y;
        acc[2] += p.z;
        acc[3] += p.w;
      }
      store_mean<float, 4>(out + static_cast<size_t>(m) * F + col, acc, cnt);
    }
    __syncthreads();  // stage s is read: it may take tile i + S
    if (i + S < n_mine) issue(i + S);
  }
}

// The bulk ring's copies alone: the same tiles and stages, no adds, no
// stores.
__global__ void __launch_bounds__(kThreads)
    bulk_gather(const char* __restrict__ x, const int* __restrict__ idx, int M, int K,
                int row_bytes, int chunk, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int RK = R * K;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* ids = reinterpret_cast<int*>(smem + kBarBytes);
  unsigned char* rows = bulk_rows(smem, S, RK);
  const int C = (row_bytes + chunk - 1) / chunk;
  const long long n_tiles = static_cast<long long>((M + R - 1) / R) * C;
  const int n_mine = blockIdx.x < n_tiles
                         ? static_cast<int>((n_tiles - 1 - blockIdx.x) / gridDim.x + 1)
                         : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) sm90::mbar_init(&bars[s], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  auto issue = [&](int i) {
    const long long t = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    const int s = i % S, c0 = static_cast<int>(t % C) * chunk;
    bulk_issue(x, idx, &bars[s], ids + s * RK, rows + static_cast<size_t>(s) * RK * chunk,
               (t / C) * R * K, static_cast<long long>(M) * K, RK, row_bytes, c0,
               static_cast<unsigned>(min(chunk, row_bytes - c0)), chunk);
  };
  for (int i = 0; i < S && i < n_mine; ++i) issue(i);
  for (int i = 0; i < n_mine; ++i) {
    sm90::mbar_wait(&bars[i % S], (i / S) & 1);
    __syncthreads();  // stage i % S may take tile i + S
    if (i + S < n_mine) issue(i + S);
  }
}

// The whole forward by cp.async (fp32, 16-byte accesses): the register
// kernel's tiles of R rows by W values and thread map, each thread's row
// loads going by cp.async into a ring of S stages of its own in shared
// memory ([stage][slot][thread], J = min(K, kIds) slots a stage), so they
// hold no registers and S - 1 items stay in flight while one is summed.
// An item is a tile's chunk of kIds ids; the ids of the next item are
// fetched while this one is issued.  A thread reads back only what it
// copied: cp.async.wait_group, no block barrier.  Padding copies nothing
// and is skipped by the stage's mask.
template <int S>
__global__ void __launch_bounds__(kThreads, 1)
    async_mean(const float* __restrict__ x, const int* __restrict__ idx, float* __restrict__ out,
               int M, int K, int F, int W, int R) {
  constexpr int VEC = 4;
  extern __shared__ __align__(16) uint4 ring[];  // S x J x kThreads, then S x kThreads masks
  const int J = K < kIds ? K : kIds;
  unsigned* masks = reinterpret_cast<unsigned*>(ring + static_cast<size_t>(S) * J * kThreads);
  const Tiles tiles(M, F, W, R);
  const int L = W / VEC;
  const int tid = threadIdx.x;
  const int r = tid / L, v = tid - r * L;
  if (r >= R || blockIdx.x >= tiles.n) return;
  const int chunks = (K + kIds - 1) / kIds;
  const long long n_items = ((tiles.n - 1 - blockIdx.x) / gridDim.x + 1) * chunks;
  // item i: tile blockIdx.x + (i / chunks) gridDim.x, ids (i % chunks) kIds ...
  auto row_of = [&](long long i) {
    return tiles.row0(blockIdx.x + (i / chunks) * gridDim.x, R) + r;
  };
  auto col_of = [&](long long i) {
    return tiles.col0(blockIdx.x + (i / chunks) * gridDim.x, W) + v * VEC;
  };
  int id[kIds];
  load_ids(id, idx, row_of(0), M, K, 0);
  auto issue = [&](long long i) {
    if (i < n_items) {
      const int s = static_cast<int>(i % S);
      const int col = col_of(i);
      uint4* slot = ring + static_cast<size_t>(s) * J * kThreads + tid;
      unsigned mask = 0;
      if (col < F) {
#pragma unroll
        for (int u = 0; u < kIds; ++u) {
          if (u == J) break;
          const bool take = id[u] >= 0;
          mask |= static_cast<unsigned>(take) << u;
          sm90::cp_async16(slot + u * kThreads,
                           x + static_cast<size_t>(take ? id[u] : 0) * F + col, take ? 16 : 0);
        }
      }
      masks[s * kThreads + tid] = mask;
      const long long next = i + 1;
      load_ids(id, idx, next < n_items ? row_of(next) : M, M, K,
               static_cast<int>(next % chunks) * kIds);
    }
    sm90::cp_async_commit();  // one group an item, empty past the end
  };
  for (int i = 0; i < S; ++i) issue(i);
  float acc[VEC];
  int cnt = 0;
  for (long long i = 0; i < n_items; ++i) {
    sm90::cp_async_wait<S - 1>();  // item i has landed
    const int s = static_cast<int>(i % S), c = static_cast<int>(i % chunks);
    if (c == 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
      cnt = 0;
    }
    const uint4* slot = ring + static_cast<size_t>(s) * J * kThreads + tid;
    const unsigned mask = masks[s * kThreads + tid];
    for (int u = 0; u < J; ++u) {
      if (!((mask >> u) & 1u)) continue;  // padding adds nothing
      ++cnt;
      const uint4 w = slot[u * kThreads];
      acc[0] += __uint_as_float(w.x);
      acc[1] += __uint_as_float(w.y);
      acc[2] += __uint_as_float(w.z);
      acc[3] += __uint_as_float(w.w);
    }
    const int m = row_of(i), col = col_of(i);
    if (c == chunks - 1 && m < M && col < F)
      store_mean<float, VEC>(out + static_cast<size_t>(m) * F + col, acc, cnt);
    issue(i + S);  // into the stage just read (this thread's own slots)
  }
}

// The cp.async ring's copies alone: rows of row_bytes, R rows a tile, a
// thread a 16-byte vector, an item a tile's chunk of kRingIds ids.
template <int S>
__global__ void __launch_bounds__(kThreads, 1)
    async_gather(const char* __restrict__ x, const int* __restrict__ idx, int M, int K,
                 int row_bytes, int R) {
  extern __shared__ __align__(16) uint4 ring[];
  const int J = K < kRingIds ? K : kRingIds;
  const int L = row_bytes / 16;
  const int tid = threadIdx.x, r = tid / L, v = tid - r * L;
  const long long n_tiles = (M + R - 1) / R;
  if (r >= R || blockIdx.x >= n_tiles) return;
  const int chunks = (K + kRingIds - 1) / kRingIds;
  const long long n_items = ((n_tiles - 1 - blockIdx.x) / gridDim.x + 1) * chunks;
  auto issue = [&](long long i) {
    if (i < n_items) {
      const int m = static_cast<int>((blockIdx.x + (i / chunks) * gridDim.x) * R) + r;
      const int j0 = static_cast<int>(i % chunks) * kRingIds;
      uint4* slot = ring + static_cast<size_t>(i % S) * J * kThreads + tid;
      for (int u = 0; u < J; ++u) {
        const int id = m < M && j0 + u < K ? idx[static_cast<size_t>(m) * K + j0 + u] : -1;
        sm90::cp_async16(slot + u * kThreads,
                         x + static_cast<size_t>(id > 0 ? id : 0) * row_bytes + 16 * v,
                         id >= 0 ? 16 : 0);
      }
    }
    sm90::cp_async_commit();
  };
  for (int i = 0; i < S; ++i) issue(i);
  unsigned fold = 0;
  for (long long i = 0; i < n_items; ++i) {
    sm90::cp_async_wait<S - 1>();
    const uint4* slot = ring + static_cast<size_t>(i % S) * J * kThreads + tid;
    for (int u = 0; u < J; ++u) fold ^= slot[u * kThreads].x;
    issue(i + S);
  }
  asm volatile("" ::"r"(fold));  // keeps the copies read
}

// launches `kernel` with `smem` bytes of dynamic shared memory on as many
// blocks as fit on the card at once, at most one a tile
template <typename Kernel, typename... Args>
int launch_ring(Kernel kernel, int smem, long long tiles, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  const long long cap = static_cast<long long>(sm_count()) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(tiles < cap ? tiles : cap), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// the cp.async kernels' ring depths (their template cases)
using MeanFn = void (*)(const float*, const int*, float*, int, int, int, int, int);
using GatherFn = void (*)(const char*, const int*, int, int, int, int);
MeanFn async_mean_of(int S) {
  switch (S) {
    case 2: return async_mean<2>;
    case 3: return async_mean<3>;
    case 4: return async_mean<4>;
    case 5: return async_mean<5>;
    case 6: return async_mean<6>;
    case 8: return async_mean<8>;
    default: return nullptr;
  }
}
GatherFn async_gather_of(int S) {
  switch (S) {
    case 2: return async_gather<2>;
    case 3: return async_gather<3>;
    case 4: return async_gather<4>;
    case 5: return async_gather<5>;
    case 6: return async_gather<6>;
    case 8: return async_gather<8>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The whole bulk forward on `stream` (fp32): x [N, F] with F % 4 == 0 and
// x 16-byte aligned, idx [M, K] int32 (-1 = padding), out [M, F]; tiles
// of R rows by `chunk` values (a multiple of 4, R chunk / 4 <= 256), S
// stages (at most 16) in `smem` bytes of dynamic shared memory.  Returns
// cudaGetLastError() (0 = ok) or -1 for arguments it does not take.
int repro_sage_bulk_mean(const void* x, const void* idx, void* out, int M, int K, int F,
                         int chunk, int R, int S, int smem, void* stream) {
  if (M == 0 || F == 0) return 0;
  if (F % 4 != 0 || chunk % 4 != 0 || chunk <= 0 || R <= 0 || R * (chunk / 4) > kThreads ||
      S < 1 || S > kBarBytes / 8 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return -1;
  const long long tiles = static_cast<long long>((M + R - 1) / R) * ((F + chunk - 1) / chunk);
  return launch_ring(bulk_mean, smem, tiles, static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(x), static_cast<const int*>(idx),
                     static_cast<float*>(out), M, K, F, chunk, R, S);
}

// The bulk copies alone: rows of row_bytes (a multiple of 16, x 16-byte
// aligned), chunks of at most `chunk` bytes (a multiple of 16).
int repro_sage_bulk_probe(const void* x, const void* idx, int M, int K, int row_bytes,
                          int chunk, int R, int S, int smem, void* stream) {
  if (M == 0 || K == 0 || row_bytes == 0) return 0;
  if (row_bytes % 16 != 0 || chunk % 16 != 0 || chunk <= 0 || R <= 0 || S < 1 ||
      S > kBarBytes / 8 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return -1;
  const long long tiles =
      static_cast<long long>((M + R - 1) / R) * ((row_bytes + chunk - 1) / chunk);
  return launch_ring(bulk_gather, smem, tiles, static_cast<cudaStream_t>(stream),
                     static_cast<const char*>(x), static_cast<const int*>(idx), M, K, row_bytes,
                     chunk, R, S);
}

// The whole cp.async forward (fp32, 16-byte accesses: F % 4 == 0, x and
// out 16-byte aligned) on the register kernel's tiles of R rows by W
// values; S stages (2, 3, 4, 5, 6 or 8) in `smem` bytes (S min(K, 8) 256
// 16-byte slots and S 256 masks).
int repro_sage_async_mean(const void* x, const void* idx, void* out, int M, int K, int F,
                          int W, int R, int S, int smem, void* stream) {
  if (M == 0 || F == 0) return 0;
  const MeanFn kernel = async_mean_of(S);
  if (kernel == nullptr || F % 4 != 0 || W % 4 != 0 || R <= 0 || R * (W / 4) > kThreads ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return -1;
  const long long tiles = static_cast<long long>((M + R - 1) / R) * ((F + W - 1) / W);
  return launch_ring(kernel, smem, tiles, static_cast<cudaStream_t>(stream),
                     static_cast<const float*>(x), static_cast<const int*>(idx),
                     static_cast<float*>(out), M, K, F, W, R);
}

// The cp.async copies alone: rows of row_bytes (a multiple of 16, x
// 16-byte aligned, row_bytes / 16 <= 256), R rows a tile, S stages (2,
// 3, 4, 5, 6 or 8) of min(K, 16) slots a thread in `smem` bytes.
int repro_sage_async_probe(const void* x, const void* idx, int M, int K, int row_bytes, int R,
                           int S, int smem, void* stream) {
  if (M == 0 || K == 0 || row_bytes == 0) return 0;
  const GatherFn kernel = async_gather_of(S);
  if (kernel == nullptr || row_bytes % 16 != 0 || R <= 0 || R * (row_bytes / 16) > kThreads ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return -1;
  return launch_ring(kernel, smem, (M + R - 1) / R, static_cast<cudaStream_t>(stream),
                     static_cast<const char*>(x), static_cast<const int*>(idx), M, K, row_bytes,
                     R);
}

}  // extern "C"
