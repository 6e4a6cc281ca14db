// The Mamba2 SSD chunked scan (state-space duality), forward.
//
// Replaces the TPU kernel repro.kernels.ssd_scan.ssd_scan (Pallas body
// `_kernel`, src/repro/kernels/ssd_scan.py), with the wrapper of
// repro.kernels.ops.ssd_scan.  For batch row b and head h, over chunks of
// q rows, with seg the chunk's inclusive cumulative sum of A_h dt_t and
// total = seg[q-1]:
//
//   y_i = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//         + exp(seg_i) (C_i . h)                       (h: [hd, ds])
//   h'  = exp(total) h + sum_j exp(total - seg_j) dt_j x_j^T B_j
//
// with the fp32 state h starting at 0, which is the exact recurrence
// h_t = exp(A dt_t) h_{t-1} + dt_t x_t^T B_t, y_t = h_t C_t of the
// oracle repro.kernels.ref.ssd_ref, summed in the TPU kernel's order.
// The causal mask is applied before the exp (a masked weight is 0, not
// exp of a positive difference); y is rounded to x's dtype once, from
// the fp32 sum of both terms.
//
// Layout.  One block per (head, batch row): 256 threads.  The TPU walks
// the chunks as its sequential innermost grid axis with h in VMEM; here
// the block walks them in a loop with h in shared memory (hd x ds fp32:
// 32 KB for mamba2-1.3b), so nothing carries between blocks.  B and C are
// read as [B, S, G, ds] through strides: head h reads group h / (H / G),
// so the model's projections go in as views and are never repeated over
// the heads.
//
// Tiles.  A [q, q] fp32 tile of C B^T * decay for mamba2-1.3b's chunk of
// 256 is 256 KB, more than the 227 KB a block may hold, so each chunk is
// done in query tiles of 64 rows; for each, the key tiles j0 <= i0 are
// streamed through shared memory (B and x rows), the 64 x 64 weights
// formed in shared memory and multiplied into the 64 x hd outputs kept in
// registers (each thread 4 rows x hd/16 columns).  Shared memory: the
// state, a C tile, a B tile, an x tile and the weights, ~134 KB at hd 64
// and ds 128.  The state update streams the key tiles once more after all
// query tiles of the chunk have read the old state.
//
// Bound.  At mamba2-1.3b's prefill shape (x [4, 2048, 64, 64] bf16, ds
// 128, chunk 256) the least time on an H100 is about even between the
// ~140 MB the scan must move (0.042 ms at 3.35 TB/s) and its ~43 GFLOP
// of products counted at the 989 TFLOP/s bf16 tensor-core rate.  This
// kernel is plain fp32 FMA code fed from shared memory, one block per
// SM: well below either bound.  wgmma on the C B^T, W x and state
// products is the later speed-up.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/ssd_scan.py loads it with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows of a query or key tile
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
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  int S, H, G, ds, q;
};

// floats of dynamic shared memory for head dimension hd
__host__ __device__ inline long long smem_floats(int hd, int ds, int q) {
  const long long dsp = ds + 1;
  return hd * dsp + 2LL * kTile * dsp + 1LL * kTile * hd + 1LL * kTile * kTile + 2LL * q;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const Args a) {
  extern __shared__ float smem[];
  constexpr int NC = HD / 16;  // output columns per thread
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int ds = a.ds, dsp = a.ds + 1, q = a.q;
  float* hs = smem;                 // [HD][dsp]    the state h
  float* ct = hs + HD * dsp;        // [kTile][dsp] C rows of the query tile
  float* bt = ct + kTile * dsp;     // [kTile][dsp] B rows of the key tile
  float* xt = bt + kTile * dsp;     // [kTile][HD]  x rows of the key tile
  float* wt = xt + kTile * HD;      // [kTile][kTile] weights
  float* seg = wt + kTile * kTile;  // [q] cumulative A dt
  float* dtc = seg + q;             // [q] dt

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float A = a.A[h];
  const T* X = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* Bp = static_cast<const T*>(a.Bm) + b * a.b_sb + g * a.b_sg;
  const T* Cp = static_cast<const T*>(a.Cm) + b * a.c_sb + g * a.c_sg;
  const float* DT = a.dt + b * a.dt_sb + h * a.dt_sh;
  T* Y = static_cast<T*>(a.y) + (static_cast<long long>(b) * a.S * a.H + h) * HD;
  const long long y_ss = static_cast<long long>(a.H) * HD;

  for (int e = tid; e < HD * dsp; e += kThreads) hs[e] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += q) {
    __syncthreads();  // the previous chunk's state update is complete
    for (int i = tid; i < q; i += kThreads) dtc[i] = DT[(c0 + i) * a.dt_ss];
    __syncthreads();
    if (tid < 32) {  // seg = cumsum(A dt): runs per lane, then a warp scan
      const int per = (q + 31) / 32;
      const int lo = tid * per, hi = min(q, lo + per);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += A * dtc[i];
        seg[i] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(kFull, incl, off);
        if (tid >= off) incl += v;
      }
      const float base = incl - run;
      for (int i = lo; i < hi; ++i) seg[i] += base;
    }
    __syncthreads();
    const float total = seg[q - 1];

    for (int i0 = 0; i0 < q; i0 += kTile) {
      const int ni = min(kTile, q - i0);
      for (int e = tid; e < kTile * ds; e += kThreads) {
        const int r = e / ds, n = e % ds;
        ct[r * dsp + n] = r < ni ? to_f32(Cp[(c0 + i0 + r) * a.c_ss + n]) : 0.f;
      }
      __syncthreads();
      // the carried state's term: exp(seg_i) C_i . h[p]
      float acc[4][NC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < ds; ++n) {
        float cv[4], hv[NC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ct[(ty + 16 * r) * dsp + n];
#pragma unroll
        for (int c = 0; c < NC; ++c) hv[c] = hs[(tx + 16 * c) * dsp + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] += cv[r] * hv[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float es = i < ni ? expf(seg[i0 + i]) : 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] *= es;
      }
      // the chunk's own rows: key tiles up to the diagonal one
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int nj = min(kTile, q - j0);
        for (int e = tid; e < kTile * ds; e += kThreads) {
          const int r = e / ds, n = e % ds;
          bt[r * dsp + n] = r < nj ? to_f32(Bp[(c0 + j0 + r) * a.b_ss + n]) : 0.f;
        }
        for (int e = tid; e < kTile * HD; e += kThreads) {
          const int r = e / HD, p = e % HD;
          xt[e] = r < nj ? to_f32(X[(c0 + j0 + r) * a.x_ss + p]) : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
        for (int n = 0; n < ds; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = ct[(ty + 16 * r) * dsp + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = bt[(tx + 16 * c) * dsp + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] += cv[r] * bv[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int gi = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int gj = j0 + tx + 16 * c;
            wt[(ty + 16 * r) * kTile + tx + 16 * c] =
                (gi < q && gj <= gi) ? s[r][c] * expf(seg[gi] - seg[gj]) * dtc[gj] : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < nj; ++j) {
          float wv[4], xv[NC];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[r] = wt[(ty + 16 * r) * kTile + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) xv[c] = xt[j * HD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[r][c] += wv[r] * xv[c];
        }
        __syncthreads();  // the next key tile overwrites bt, xt and wt
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= ni) continue;
        T* yr = Y + (c0 + i0 + i) * y_ss;
#pragma unroll
        for (int c = 0; c < NC; ++c) store(acc[r][c], yr + tx + 16 * c);
      }
      __syncthreads();  // the next query tile overwrites ct
    }

    // h = exp(total) h + sum_j (exp(total - seg_j) dt_j x_j)^T B_j; each
    // thread owns the same elements of h throughout
    const float et = expf(total);
    for (int e = tid; e < HD * ds; e += kThreads) hs[(e / ds) * dsp + e % ds] *= et;
    for (int j0 = 0; j0 < q; j0 += kTile) {
      const int nj = min(kTile, q - j0);
      __syncthreads();  // the previous tile is consumed
      for (int e = tid; e < kTile * ds; e += kThreads) {
        const int r = e / ds, n = e % ds;
        bt[r * dsp + n] = r < nj ? to_f32(Bp[(c0 + j0 + r) * a.b_ss + n]) : 0.f;
      }
      for (int e = tid; e < kTile * HD; e += kThreads) {
        const int r = e / HD, p = e % HD;
        xt[e] = r < nj ? to_f32(X[(c0 + j0 + r) * a.x_ss + p]) *
                             (expf(total - seg[j0 + r]) * dtc[j0 + r])
                       : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < HD * ds; e += kThreads) {
        const int p = e / ds, n = e % ds;
        float s = 0.f;
        for (int r = 0; r < nj; ++r) s += xt[r * HD + p] * bt[r * dsp + n];
        hs[p * dsp + n] += s;
      }
    }
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(HD, a.ds, a.q);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<T, HD><<<dim3(a.H, B), kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& a, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Launches the scan on `stream`; returns cudaGetLastError() (0 = ok), -1
// for an unsupported dtype, -2 for an unsupported head dimension and -3
// when the state and tiles do not fit a block's shared memory.  x [B, S,
// H, hd], dt [B, S, H] (fp32), B and C [B, S, G, ds] are device pointers
// addressed by the strides given (elements; the last dimension of x, B
// and C contiguous), A [H] fp32 contiguous, y [B, S, H, hd] contiguous.
// dtype 0 = float32, 1 = bfloat16 (x, B, C and y).  H % G == 0; hd in
// {16, 32, 64, 128}; S % q == 0.
int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int B, int S, int H, int hd, int G, int ds, int q, int dtype,
    void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (sizeof(float) * smem_floats(hd, ds, q) > 232448) return -3;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               Bm, Cm, y,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
               S, H, G, ds, q};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, hd, s);
  return -1;
}

}  // extern "C"
