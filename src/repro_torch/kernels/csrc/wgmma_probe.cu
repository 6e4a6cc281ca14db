// One block of wgmma products on TMA-loaded tiles, for testing the
// descriptors, fragment maps and tensor maps of sm90.cuh on the card
// against torch.matmul (tests/test_torch_cuda.py).  Not on any model
// path: the attention and grouped-GEMM kernels use the same helpers.
//
//   mode 0: out [64, 64]  = a [64, 128] . b^T, b [64, 128] (K-major B),
//           m64n64k16 with both operands in shared memory (attention's
//           scores, D = 128);
//   mode 1: out [64, 128] = a [64, 128] . b, b [128, 128] (MN-major B),
//           m64n128k16 with both operands in shared memory (the grouped
//           GEMM);
//   mode 2: as mode 1 with a taken from registers (attention's P . V);
//   mode 3: out [64, 128] = a^T . b, a [128, 64] (MN-major A: the
//           transpose flag of A) and b as in mode 1 (the grouped GEMM's
//           dw = x^T dy).
//
// The MN-major B descriptor takes the leading and stride byte offsets
// given (the layout's are 16384, between the two 64-column halves, and
// 1024, between 8-row groups).

#include "sm90.cuh"

namespace {

constexpr int kABytes = 64 * 128 * 2;
constexpr int kSmem = 1024 + kABytes + 128 * 128 * 2;

__global__ void __launch_bounds__(128) wgmma_probe(const __grid_constant__ CUtensorMap amap,
                                                   const __grid_constant__ CUtensorMap bmap,
                                                   const __nv_bfloat16* a, float* out, int mode,
                                                   int lbo, int sbo) {
  extern __shared__ uint8_t raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sA = base;
  uint8_t* sB = base + kABytes;
  __shared__ uint64_t bar;
  const int tid = threadIdx.x;
  const int brows = mode == 0 ? 64 : 128;
  if (tid == 0) {
    sm90::mbar_init(&bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(&bar, kABytes + 2 * brows * sm90::kRowBytes);
    for (int h = 0; h < 2; ++h) {
      // mode 3: a is one [128 k rows][64 m] box
      if (mode != 3 || h == 0)
        sm90::tma_load_2d(sA + h * 64 * sm90::kRowBytes, &amap, &bar, 64 * h, 0);
      sm90::tma_load_2d(sB + h * brows * sm90::kRowBytes, &bmap, &bar, 64 * h, 0);
    }
  }
  sm90::mbar_wait(&bar, 0);
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  if (mode == 0) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    sm90::fence_regs(d);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int off = (kk / 4) * 64 * sm90::kRowBytes + (kk % 4) * 32;
      sm90::wgmma_ss_n64<0>(d, sm90::desc(sA + off, 16, sm90::kAtomBytes),
                            sm90::desc(sB + off, 16, sm90::kAtomBytes), 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(d);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[(r0 + 8 * ((i / 2) % 2)) * 64 + 8 * (i / 4) + c2 + i % 2] = d[i];
    return;
  }
  uint32_t af[8][4] = {};
  if (mode == 2) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // rows r0, r0 + 8; columns c2, c2 + 8
        const __nv_bfloat16* p = a + (r0 + 8 * (q % 2)) * 128 + 16 * kk + 8 * (q / 2) + c2;
        af[kk][q] = *reinterpret_cast<const uint32_t*>(p);
      }
    }
  }
  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  sm90::fence_regs(d);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) sm90::fence_regs(af[kk]);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t db = sm90::desc(sB + kk * 16 * sm90::kRowBytes, lbo, sbo);
    if (mode == 1) {
      const int off = (kk / 4) * 64 * sm90::kRowBytes + (kk % 4) * 32;
      sm90::wgmma_ss_n128<1>(d, sm90::desc(sA + off, 16, sm90::kAtomBytes), db, 1);
    } else if (mode == 3) {  // a k16 step: 16 rows of a's [k][m] tile
      const uint64_t da = sm90::desc(sA + kk * 16 * sm90::kRowBytes, lbo, sbo);
      sm90::wgmma_ss_n128<1, 1>(d, da, db, 1);
    } else {
      sm90::wgmma_rs_n128<1>(d, af[kk], db, 1);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    out[(r0 + 8 * ((i / 2) % 2)) * 128 + 8 * (i / 4) + c2 + i % 2] = d[i];
}

}  // namespace

extern "C" {

// a [64, 128] (mode 3: [128, 64]) and b ([64, 128] for mode 0, else
// [128, 128]) contiguous bf16, out fp32 [64, 64 or 128], all device
// pointers; returns 0 or an error code (sm90_host's, or
// cudaGetLastError()).
int repro_wgmma_probe(const void* a, const void* b, void* out, int mode, int lbo, int sbo,
                      void* stream) {
  CUtensorMap amap, bmap;
  const uint64_t adims[2] = {mode == 3 ? 64u : 128u, mode == 3 ? 128u : 64u};
  const uint64_t bdims[2] = {128, mode == 0 ? 64u : 128u};
  const uint64_t stride[1] = {256}, astride[1] = {mode == 3 ? 128u : 256u};
  const uint32_t abox[2] = {64, mode == 3 ? 128u : 64u}, bbox[2] = {64, mode == 0 ? 64u : 128u};
  int err = sm90_host::make_map(&amap, a, 2, adims, astride, abox);
  if (err == 0) err = sm90_host::make_map(&bmap, b, 2, bdims, stride, bbox);
  if (err != 0) return err;
  const cudaError_t attr =
      cudaFuncSetAttribute(wgmma_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wgmma_probe<<<1, 128, kSmem, static_cast<cudaStream_t>(stream)>>>(
      amap, bmap, static_cast<const __nv_bfloat16*>(a), static_cast<float*>(out), mode, lbo, sbo);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
