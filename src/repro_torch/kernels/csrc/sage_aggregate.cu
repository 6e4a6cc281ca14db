// GraphSAGE masked neighbour mean, one warp per output row.
//
// Replaces the TPU kernel repro.kernels.sage_aggregate.sage_aggregate
// (Pallas body `_kernel`, src/repro/kernels/sage_aggregate.py), the
// aggregation of every GraphSAGE layer.  For each output row m:
//
//   out[m, :] = (sum over j = 0..K-1 with idx[m, j] >= 0 of x[idx[m, j], :])
//               / max(count, 1)
//
// accumulated in fp32 in j order, divided in IEEE fp32 (no fast math),
// and stored in x's type (fp32, or bf16 rounded to nearest even).  Rows
// whose K ids are all padding (-1) give 0.  The sum visits the rows in
// the same order as the plain version (repro_torch/kernels/
// sage_aggregate.py::sage_aggregate_plain) and the Pallas kernel, with
// no multiply to contract, so in fp32 the result equals theirs bit for
// bit.
//
// What bounds it on an H100: bytes.  Each valid id pulls one feature row
// (F values) from device memory, and the arithmetic is one add per
// value.  The design keeps every load wide and coalesced: the warp's 32
// lanes stride over F, 16 bytes a lane where F and the base address
// allow it (4 fp32 or 8 bf16 values), so a gathered row is read in as
// few transactions as its size permits.  The warp reads its K ids with
// one coalesced load (lane j holds id j) and broadcasts them with
// shuffles; the row loads for different j are independent, so the
// unrolled loop keeps several in flight.  The Pallas kernel's one-row
// DMA per neighbour becomes this gather; M rows need no padding to a
// block multiple, and the ragged last block masks itself.  Pipelining
// the gathers deeper (cp.async or TMA gather into shared memory) is
// left for later work.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/sage_aggregate.py loads it with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // output rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// VEC consecutive values of type T, moved as one 16-byte access when
// VEC * sizeof(T) == 16 and as single elements when VEC == 1.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void sage_kernel(const T* __restrict__ x,
                            const int* __restrict__ idx, T* __restrict__ out,
                            int M, int K, int F) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;  // the whole warp leaves together
  const int* ids = idx + static_cast<size_t>(m) * K;
  T* orow = out + static_cast<size_t>(m) * F;
  // every lane runs every chunk (the shuffles need the whole warp); a
  // lane past the row's end only takes part in them
  for (int c0 = 0; c0 < F; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < F;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    int cnt = 0;
    for (int j0 = 0; j0 < K; j0 += 32) {
      const int mine = j0 + lane < K ? ids[j0 + lane] : -1;
      const int n = K - j0 < 32 ? K - j0 : 32;
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) {
        const int r = __shfl_sync(0xffffffffu, mine, jj);
        if (r < 0) continue;  // padding adds nothing (r is warp-uniform)
        ++cnt;
        if (!active) continue;
        const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(
            x + static_cast<size_t>(r) * F + c);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] += to_f32(p.v[v]);
      }
    }
    if (!active) continue;
    const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
    Pack<T, VEC> q;
#pragma unroll
    for (int v = 0; v < VEC; ++v) from_f32(acc[v] / denom, &q.v[v]);
    *reinterpret_cast<Pack<T, VEC>*>(orow + c) = q;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* idx, void* out, int M, int K, int F,
           void* stream) {
  const int blocks = (M + kWarps - 1) / kWarps;
  sage_kernel<T, VEC><<<blocks, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(idx),
      static_cast<T*>(out), M, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok),
// or -1 for an unsupported dtype.  All pointers are device pointers to
// C-contiguous arrays: x [N, F] (dtype 0 = float32, 1 = bfloat16),
// idx [M, K] int32 with ids in [0, N) or -1, out [M, F] of x's dtype.
// `wide` selects 16-byte accesses; the caller sets it only when F is a
// multiple of the values per 16 bytes (4 fp32, 8 bf16) and x and out are
// 16-byte aligned.
int repro_sage_aggregate(const void* x, const void* idx, void* out, int M,
                         int K, int F, int dtype, int wide, void* stream) {
  if (M == 0 || F == 0) return 0;
  if (dtype == 0) {
    return wide ? launch<float, 4>(x, idx, out, M, K, F, stream)
                : launch<float, 1>(x, idx, out, M, K, F, stream);
  }
  if (dtype == 1) {
    return wide ? launch<__nv_bfloat16, 8>(x, idx, out, M, K, F, stream)
                : launch<__nv_bfloat16, 1>(x, idx, out, M, K, F, stream);
  }
  return -1;
}

}  // extern "C"
