// Sequential priority waterfill of NIC capacity, one thread per instance.
//
// Replaces the TPU kernel repro.kernels.waterfill.waterfill_fill (Pallas
// body `_kernel`, src/repro/kernels/waterfill.py), the rate pass of the
// fifo and mrtf policies in the batched event engine.  For each instance b
// the thread walks order[b, :]; each eligible flow i gets
// min(rem_in[dst[i]], rem_out[src[i]]) if that exceeds EPS, else 0, and the
// grant is subtracted from both NICs.  The arithmetic is one compare and
// two subtractions per grant, with no multiply-add to contract, so the
// result equals the plain version and the Pallas kernel bit for bit.
//
// What bounds it on an H100: latency.  Within an instance each grant
// depends on the NIC remainders the previous grants left, so the
// dependent chain is EG steps long (order -> flow -> remainders), while
// the bytes moved are few (three int32 and one bool row in, one float64
// row out).  The design keeps the chain's state where it is cheapest to
// reach: the thread's M ingress and M egress remainders sit in shared
// memory, laid out [m][thread] so neighbouring threads use neighbouring
// banks, and everything stays in float64.  Instances are independent, so
// B threads run B chains at once.  Shortening the chain (prefetching the
// next flow's ids, one warp per instance) is left for later work.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/waterfill.py loads it with ctypes).

#include <cuda_runtime.h>

namespace {

constexpr double kEps = 1e-9;  // repro_torch.core.engine.EPS
constexpr int kThreads = 32;   // instances per block

__global__ void waterfill_kernel(const int* __restrict__ order,
                                 const int* __restrict__ src,
                                 const int* __restrict__ dst,
                                 const bool* __restrict__ elig,
                                 const double* __restrict__ cap_in,
                                 const double* __restrict__ cap_out,
                                 double* __restrict__ out, int B, int EG,
                                 int M) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int b = blockIdx.x * T + tid;
  if (b >= B) return;
  double* rem_in = smem;                           // [M][T]
  double* rem_out = smem + static_cast<size_t>(M) * T;  // [M][T]
  const size_t row_m = static_cast<size_t>(b) * M;
  for (int m = 0; m < M; ++m) {
    rem_in[m * T + tid] = cap_in[row_m + m];
    rem_out[m * T + tid] = cap_out[row_m + m];
  }
  const size_t row = static_cast<size_t>(b) * EG;
  for (int i = 0; i < EG; ++i) out[row + i] = 0.0;
  for (int k = 0; k < EG; ++k) {
    const int i = order[row + k];
    // the three loads are independent, so they are issued together and
    // the step waits for one memory latency, not two
    const bool e = elig[row + i];
    const int d = dst[row + i];
    const int s = src[row + i];
    if (!e) continue;
    const double a = rem_in[d * T + tid];
    const double c = rem_out[s * T + tid];
    // a NaN remainder grants nothing, as min() propagates NaN and
    // NaN > EPS is false in the reference
    if (a != a || c != c) continue;
    const double give = a < c ? a : c;
    if (!(give > kEps)) continue;
    out[row + i] = give;
    rem_in[d * T + tid] = a - give;
    rem_out[s * T + tid] = c - give;
  }
}

}  // namespace

extern "C" {

// Threads per block, so the caller can size the shared memory it checks.
int repro_waterfill_threads() { return kThreads; }

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// All pointers are device pointers to C-contiguous arrays:
// order/src/dst [B, EG] int32, elig [B, EG] bool, caps [B, M] float64,
// out [B, EG] float64.  Machine ids must lie in [0, M) and order must
// hold indices in [0, EG).
int repro_waterfill_fill(const void* order, const void* src, const void* dst,
                         const void* elig, const void* cap_in,
                         const void* cap_out, void* out, int B, int EG, int M,
                         void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  const size_t smem = 2 * static_cast<size_t>(M) * kThreads * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        waterfill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  waterfill_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const bool*>(elig),
      static_cast<const double*>(cap_in), static_cast<const double*>(cap_out),
      static_cast<double*>(out), B, EG, M);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
