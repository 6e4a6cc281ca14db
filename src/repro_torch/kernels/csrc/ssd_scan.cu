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
// Bound.  At mamba2-1.3b's prefill shape (x [4, 2048, 64, 64] bf16, ds
// 128, chunk 256) the least time on an H100 is the ~140 MB the scan must
// move (0.042 ms at 3.35 TB/s); its products, with C B^T counted once per
// group of heads (as the "mma" route forms it), are ~26 GFLOP, 0.026 ms
// at the 989 TFLOP/s bf16 tensor-core rate.
//
// Two routes, chosen on the host by dtype and shape
// (kernels/ssd_scan.py, route()):
//
// "mma" (bf16; hd in {16, 32, 64, 128}, ds a multiple of 16 up to 256, q
// a multiple of 16, 16-byte aligned rows): the chunked decomposition the
// recurrence allows, in four kernels, so that the chunks run in parallel
// and the products run on the tensor cores:
//
//   1. ssd_states, one block per (chunk, head, batch row): the chunk's
//      seg (stored for ssd_outputs) and its own state contribution
//      s_c = sum_j exp(total - seg_j) dt_j x_j^T B_j, an [hd, ds] product
//      over the chunk's q rows, into fp32 scratch [b, h, nc, hd, ds];
//   2. ssd_cb, one block per (query tile of 64 rows, chunk, group, batch
//      row): C B^T up to the diagonal, once for the group's heads (they
//      share B and C; mamba2-1.3b's 64 heads are one group), into fp32
//      scratch [b, G, nc, q, q];
//   3. ssd_pass, sequential over the chunks and parallel over (b, h, hd
//      ds): h_c = exp(total_{c-1}) h_{c-1} + s_{c-1}, h_0 = 0, carried in
//      fp32 and written in bf16 (ssd_outputs' operand) to a second scratch
//      [b, h, nc, hd, ds] (a fused elementwise pass: one load, one
//      exp-scaled add and one store an element and chunk, so a CUDA loop
//      serves as well as Triton would);
//   4. ssd_outputs, one block per (query tile of 64 rows, chunk, head,
//      batch row): y = exp(seg_i) (C_i . h_c) + (tril(C B^T * decay) *
//      dt) x, the key tiles of 64 rows up to the diagonal (their C B^T
//      from pass 2, their x rows) streamed through shared memory.
//
//   Every tile is copied to shared memory with cp.async, all of a phase's
//   16-byte pieces in flight at once (a load loop that waits for each
//   piece would pay a memory latency per piece).
//
//   The products run on mma.sync m16n8k16 (bf16 operands, fp32 sums)
//   with ldmatrix from padded shared-memory tiles (a row is its values
//   and 16 bytes, so the 8 rows of an ldmatrix fall in distinct banks).
//   mma.sync and not wgmma: the products are narrow and of every width
//   from 16 to 256 (hd and ds), and between C B^T and W x each weight is
//   scaled, masked and rounded in registers, where a warp's 16 rows of
//   weights pack straight into the A fragments of W x (as
//   flash_decode_mma does with P); wgmma would need 64-row warpgroup tiles
//   through TMA's 64-column swizzled boxes and its asynchronous
//   accumulators around that step.  C, B and x are bf16 already, so their
//   products are exact; the fp32 weights W, the scaled rows
//   exp(total - seg_j) dt_j x_j and the carried state h are rounded to
//   bf16 only as operands of their products; the state itself, seg,
//   C B^T and every sum stay fp32.  No atomics: two runs give the same
//   bits.
//
// "fma" (fp32, whose 1e-4 checks exclude bf16 operands and TF32, and
// shapes the tiles above do not take): one block per (head, batch row),
// 256 threads, walking the chunks in order with h in shared memory
// (hd x ds fp32), plain fp32 FMA code.  Each chunk is done in query
// tiles of 64 rows; for each, the key tiles j0 <= i0 are streamed through
// shared memory (B and x rows), the 64 x 64 weights formed in shared
// memory and multiplied into the 64 x hd outputs kept in registers (each
// thread 4 rows x hd/16 columns).  Shared memory: the state, a C tile, a
// B tile, an x tile and the weights, ~134 KB at hd 64 and ds 128.  The
// state update streams the key tiles once more after all query tiles of
// the chunk have read the old state.
//
// Both read B and C as [B, S, G, ds] through strides: head h reads group
// h / (H / G), so the model's projections go in as views and are never
// repeated over the heads.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/ssd_scan.py loads it with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

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
  int S, H, G, hd, ds, q;
};

// seg = cumsum(A dt) over the chunk's q rows, by one warp: runs per lane,
// then a warp scan of the runs
__device__ __forceinline__ void chunk_cumsum(const float* dtc, float A, float* seg, int q,
                                             int lane) {
  const int per = (q + 31) / 32;
  const int lo = lane * per, hi = min(q, lo + per);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += A * dtc[i];
    seg[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  const float base = incl - run;
  for (int i = lo; i < hi; ++i) seg[i] += base;
}

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
    if (tid < 32) chunk_cumsum(dtc, A, seg, q, tid);
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

// ------------------------------------------------------------ "mma" route
using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kRows = 64;         // query rows of an ssd_outputs block, key rows of its tiles
constexpr long long kMaxSmem = 232448;

// bytes of dynamic shared memory of the two tiled kernels (a bf16 tile
// row is its values and 8 more)
__host__ __device__ inline long long states_bytes(int hd, int ds, int q) {
  return 8LL * q + 2LL * q * (hd + 8) + 2LL * q * (ds + 8);
}
__host__ __device__ inline long long cb_bytes(int ds) { return 4LL * kRows * (ds + 8); }
// ssd_outputs: dt and seg, then the C tile and the state (the carried
// state's product), whose room the CB and x tiles of the key loop reuse
__host__ __device__ inline long long outputs_bytes(int hd, int ds, int q) {
  const long long inter = 2LL * (kRows + hd) * (ds + 8);
  const long long keys = 4LL * kRows * (kRows + 8) + 2LL * kRows * (hd + 8);
  return 8LL * q + (inter > keys ? inter : keys);
}

// n rows of `cols` bf16 (row stride ld elements, 16-byte aligned) into
// shared memory at pitch cols + 8, with cp.async (16 bytes a piece, all
// in flight at once; zeros for rows at or past `valid`); wait_rows
// commits them, waits and syncs the block
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int n,
                                          int cols, int valid, int tid) {
  const int pieces = cols / 8;
  for (int e = tid; e < n * pieces; e += kMmaThreads) {
    const int r = e / pieces, pc = e % pieces;
    const bool ok = r < valid;
    sm90::cp_async16(dst + r * (cols + 8) + 8 * pc, src + (ok ? r : 0) * ld + 8 * pc, ok ? 16 : 0);
  }
}
__device__ __forceinline__ void wait_rows() {
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();
}

// Pass 1, one block per (chunk, head, batch row): the chunk's seg into
// segs [b, h, nc, q] and its state contribution
// s_c[p][n] = sum_j (exp(total - seg_j) dt_j x_j[p]) B_j[n] into st [b, h,
// nc, hd, ds].  The [hd, ds] output is cut into warp tiles of 16 x 64; a
// warp's tile runs over the chunk's rows in k16 steps, A = the scaled x
// rows (ldmatrix.trans of [j][p]), B = the B rows (ldmatrix.trans of
// [j][n]).
__global__ void __launch_bounds__(kMmaThreads)
    ssd_states(const Args a, float* __restrict__ st, float* __restrict__ segs) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, q = a.q, ds = a.ds, hd = a.hd;
  const int XP = hd + 8, BP = ds + 8;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  float* dts = reinterpret_cast<float*>(dsm);  // [q] dt, then the row weights
  float* seg = dts + q;                         // [q]
  bf16* Xs = reinterpret_cast<bf16*>(seg + q);  // [q][hd + 8] the scaled x rows
  bf16* Bs = Xs + q * XP;                       // [q][ds + 8]
  const long long c0 = static_cast<long long>(c) * q;
  const bf16* X = static_cast<const bf16*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  const bf16* Bp = static_cast<const bf16*>(a.Bm) + b * a.b_sb + g * a.b_sg + c0 * a.b_ss;
  const float* DT = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  load_rows(Bs, Bp, a.b_ss, q, ds, q, tid);
  load_rows(Xs, X, a.x_ss, q, hd, q, tid);
  for (int i = tid; i < q; i += kMmaThreads) dts[i] = DT[i * a.dt_ss];
  __syncthreads();
  if (w == 0) chunk_cumsum(dts, a.A[h], seg, q, lane);
  wait_rows();
  const float total = seg[q - 1];
  const long long bhc = (static_cast<long long>(b) * a.H + h) * nc + c;
  for (int i = tid; i < q; i += kMmaThreads) {
    segs[bhc * q + i] = seg[i];
    dts[i] = expf(total - seg[i]) * dts[i];
  }
  __syncthreads();
  const int pieces = hd / 8;  // the x rows scaled in place
  for (int e = tid; e < q * pieces; e += kMmaThreads) {
    const int r = e / pieces, pc = e % pieces;
    const uint4 v = *reinterpret_cast<const uint4*>(Xs + r * XP + 8 * pc);
    const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float wr = dts[r];
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(in[k]);
      op[k] = sm90::pack_bf16(f.x * wr, f.y * wr);
    }
    *reinterpret_cast<uint4*>(Xs + r * XP + 8 * pc) = o;
  }
  __syncthreads();

  const int gq = lane / 4, tq = lane % 4, mi = lane / 8;
  const int nN = (ds + 63) / 64, nwt = (hd / 16) * nN;
  float* out = st + bhc * hd * ds;
  for (int wt = w; wt < nwt; wt += kMmaThreads / 32) {
    const int m0 = 16 * (wt / nN), n0 = 64 * (wt % nN);
    const int ng = min(4, (ds - n0) / 16);  // 16-column groups of the tile
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    for (int kk = 0; kk < q / 16; ++kk) {
      uint32_t af[4];
      sm90::ldmatrix_x4_trans(af, Xs + (16 * kk + 8 * (mi / 2) + lane % 8) * XP + m0 + 8 * (mi % 2));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (jj < ng) {
          uint32_t bfr[4];
          sm90::ldmatrix_x4_trans(
              bfr, Bs + (16 * kk + 8 * (mi % 2) + lane % 8) * BP + n0 + 16 * jj + 8 * (mi / 2));
          sm90::mma_bf16_16816(acc[2 * jj], af, bfr[0], bfr[1]);
          sm90::mma_bf16_16816(acc[2 * jj + 1], af, bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * ng) {
        const int col = n0 + 8 * nt + 2 * tq;
        *reinterpret_cast<float2*>(out + (m0 + gq) * ds + col) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(out + (m0 + gq + 8) * ds + col) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
  }
}

// Pass 2, one block per (query tile of 64 rows, chunk, group, batch row):
// C B^T of the tile's rows against every key up to the tile's last row,
// formed once for the group's heads (they share B and C), into cb [b, G,
// nc, q, q] fp32 (key tiles past the diagonal one are neither written nor
// read).  Warp w's rows 16 w .. 16 w + 15 are the mma's 16 rows, A = C
// rows and B = B rows, both K-major.
__global__ void __launch_bounds__(kMmaThreads) ssd_cb(const Args a, float* __restrict__ cb) {
  extern __shared__ __align__(16) unsigned char dsm[];
  const int q = a.q, ds = a.ds, CP = ds + 8;
  const int nqt = (q + kRows - 1) / kRows, nc = a.S / q;
  const int c = blockIdx.x / nqt, i0 = (blockIdx.x % nqt) * kRows;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane / 4, tq = lane % 4, mi = lane / 8;
  bf16* Cs = reinterpret_cast<bf16*>(dsm);  // [64][ds + 8] the query tile's C rows
  bf16* Bs = Cs + kRows * CP;               // [64][ds + 8] a key tile's B rows
  const long long c0 = static_cast<long long>(c) * q;
  const bf16* Bp = static_cast<const bf16*>(a.Bm) + b * a.b_sb + g * a.b_sg + c0 * a.b_ss;
  const bf16* Cp = static_cast<const bf16*>(a.Cm) + b * a.c_sb + g * a.c_sg + c0 * a.c_ss;
  float* out = cb + ((static_cast<long long>(b) * a.G + g) * nc + c) * q * q;
  load_rows(Cs, Cp + i0 * a.c_ss, a.c_ss, kRows, ds, q - i0, tid);
  const int r0 = 16 * w, ia = i0 + r0 + gq, ib = ia + 8;
  for (int j0 = 0; j0 <= i0; j0 += kRows) {
    __syncthreads();  // the previous key tile is consumed
    load_rows(Bs, Bp + j0 * a.b_ss, a.b_ss, kRows, ds, q - j0, tid);
    wait_rows();
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = 0.f;
    for (int kk = 0; kk < ds / 16; ++kk) {
      uint32_t af[4];
      sm90::ldmatrix_x4(af, Cs + (r0 + 8 * (mi % 2) + lane % 8) * CP + 16 * kk + 8 * (mi / 2));
#pragma unroll
      for (int kg = 0; kg < 4; ++kg) {
        uint32_t bfr[4];
        sm90::ldmatrix_x4(bfr, Bs + (16 * kg + 8 * (mi / 2) + lane % 8) * CP + 16 * kk + 8 * (mi % 2));
        sm90::mma_bf16_16816(sc[2 * kg], af, bfr[0], bfr[1]);
        sm90::mma_bf16_16816(sc[2 * kg + 1], af, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int j = j0 + 8 * nt + 2 * tq;
      if (j < q && ia < q)
        *reinterpret_cast<float2*>(out + ia * q + j) = make_float2(sc[nt][0], sc[nt][1]);
      if (j < q && ib < q)
        *reinterpret_cast<float2*>(out + ib * q + j) = make_float2(sc[nt][2], sc[nt][3]);
    }
  }
}

// Pass 3, sequential over the chunks, one thread per element of a (batch
// row, head)'s [hd, ds] state: from the chunk contributions in st, the
// state entering each chunk, h_c = exp(total_{c-1}) h_{c-1} + s_{c-1},
// h_0 = 0, carried in fp32 and written to hb [b, h, nc, hd, ds] rounded
// to bf16 (pass 4's operand).
__global__ void ssd_pass(const float* __restrict__ st, bf16* __restrict__ hb,
                         const float* __restrict__ segs, int nc, int q, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long bh = static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
  const float* p = st + bh * nc * n + e;
  bf16* o = hb + bh * nc * n + e;
  const float* total = segs + bh * nc * q + (q - 1);
  float run = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float s = p[static_cast<long long>(c) * n];
    o[static_cast<long long>(c) * n] = __float2bfloat16_rn(run);
    run = __fadd_rn(__fmul_rn(expf(total[static_cast<long long>(c) * q]), run), s);
  }
}

// Pass 4, one block per (query tile of 64 rows, chunk, head, batch row);
// warp w owns the tile's rows 16 w .. 16 w + 15 as the mma's 16 rows.
// First the carried state: acc = exp(seg_i) (C_i . h_c) (A = C rows, B =
// h_c rounded to bf16, [p][n] read as K-major).  Then per key tile up to
// the diagonal: the tile of C B^T from cb (fp32, copied to shared memory),
// the weights C B^T exp(seg_i - seg_j) dt_j masked to j <= i before the
// exp, packed into A fragments (bf16) in the accumulator layout, and acc
// += W x (x rows through ldmatrix.trans).  y = acc rounded to bf16 once.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    ssd_outputs(const Args a, const bf16* __restrict__ hb, const float* __restrict__ segs,
                const float* __restrict__ cb) {
  extern __shared__ __align__(16) unsigned char dsm[];
  constexpr int NT = HD / 8, XP = HD + 8;
  constexpr int KP = kRows + 8;  // pitch of the C B^T tile (fp32)
  const int q = a.q, ds = a.ds, CP = ds + 8;
  const int nqt = (q + kRows - 1) / kRows, nc = a.S / q;
  const int c = blockIdx.x / nqt, i0 = (blockIdx.x % nqt) * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gq = lane / 4, tq = lane % 4, mi = lane / 8;
  float* seg = reinterpret_cast<float*>(dsm);  // [q]
  float* dts = seg + q;                         // [q]
  bf16* Cs = reinterpret_cast<bf16*>(dts + q);  // [64][ds + 8] the query tile's C rows
  bf16* Hs = Cs + kRows * CP;                   // [HD][ds + 8] the state entering the chunk
  float* CBs = dts + q;                         // [64][64 + 8] a key tile of C B^T (over Cs)
  bf16* Xs = reinterpret_cast<bf16*>(CBs + kRows * KP);  // [64][HD + 8] its x rows
  const long long c0 = static_cast<long long>(c) * q;
  const long long bhc = (static_cast<long long>(b) * a.H + h) * nc + c;
  const bf16* X = static_cast<const bf16*>(a.x) + b * a.x_sb + h * a.x_sh + c0 * a.x_ss;
  const bf16* Cp = static_cast<const bf16*>(a.Cm) + b * a.c_sb + g * a.c_sg + c0 * a.c_ss;
  const float* CB = cb + ((static_cast<long long>(b) * a.G + g) * nc + c) * q * q;
  const float* DT = a.dt + b * a.dt_sb + h * a.dt_sh + c0 * a.dt_ss;
  for (int i = tid; i < q; i += kMmaThreads) {
    seg[i] = segs[bhc * q + i];
    dts[i] = DT[i * a.dt_ss];
  }
  load_rows(Cs, Cp + i0 * a.c_ss, a.c_ss, kRows, ds, q - i0, tid);
  load_rows(Hs, hb + bhc * HD * ds, ds, HD, ds, HD, tid);
  wait_rows();

  const int r0 = 16 * w;
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  for (int kk = 0; kk < ds / 16; ++kk) {
    uint32_t af[4];
    sm90::ldmatrix_x4(af, Cs + (r0 + 8 * (mi % 2) + lane % 8) * CP + 16 * kk + 8 * (mi / 2));
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      uint32_t bfr[4];
      sm90::ldmatrix_x4(bfr, Hs + (16 * j + 8 * (mi / 2) + lane % 8) * CP + 16 * kk + 8 * (mi % 2));
      sm90::mma_bf16_16816(acc[2 * j], af, bfr[0], bfr[1]);
      sm90::mma_bf16_16816(acc[2 * j + 1], af, bfr[2], bfr[3]);
    }
  }
  const int ia = i0 + r0 + gq, ib = ia + 8;  // the chunk rows of this lane's sums
  const float sa = ia < q ? seg[ia] : 0.f, sb = ib < q ? seg[ib] : 0.f;
  const float ea = ia < q ? expf(sa) : 0.f, eb = ib < q ? expf(sb) : 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] *= ea;
    acc[nt][1] *= ea;
    acc[nt][2] *= eb;
    acc[nt][3] *= eb;
  }

  for (int j0 = 0; j0 <= i0; j0 += kRows) {
    __syncthreads();  // the previous tile (or the C tile and the state) is consumed
    for (int e = tid; e < kRows * (kRows / 4); e += kMmaThreads) {
      const int r = e / (kRows / 4), pc = e % (kRows / 4);
      const bool ok = i0 + r < q && j0 + 4 * pc < q;
      sm90::cp_async16(CBs + r * KP + 4 * pc, CB + (ok ? (i0 + r) * q + j0 + 4 * pc : 0),
                       ok ? 16 : 0);
    }
    load_rows(Xs, X + j0 * a.x_ss, a.x_ss, kRows, HD, q - j0, tid);
    wait_rows();
    const int nkg = j0 == i0 ? w + 1 : 4;  // 16-key groups this warp's rows see
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 u = *reinterpret_cast<const float2*>(CBs + (r0 + gq) * KP + 8 * nt + 2 * tq);
      const float2 v = *reinterpret_cast<const float2*>(CBs + (r0 + gq + 8) * KP + 8 * nt + 2 * tq);
      sc[nt][0] = u.x;
      sc[nt][1] = u.y;
      sc[nt][2] = v.x;
      sc[nt][3] = v.y;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + 8 * nt + 2 * tq + e % 2;
        const int i = e < 2 ? ia : ib;
        const int jc = j < q ? j : q - 1;
        sc[nt][e] = (j <= i && i < q)
                        ? sc[nt][e] * expf((e < 2 ? sa : sb) - seg[jc]) * dts[jc]
                        : 0.f;
      }
#pragma unroll
    for (int kg = 0; kg < 4; ++kg) {
      if (kg < nkg) {
        const uint32_t pa[4] = {sm90::pack_bf16(sc[2 * kg][0], sc[2 * kg][1]),
                                sm90::pack_bf16(sc[2 * kg][2], sc[2 * kg][3]),
                                sm90::pack_bf16(sc[2 * kg + 1][0], sc[2 * kg + 1][1]),
                                sm90::pack_bf16(sc[2 * kg + 1][2], sc[2 * kg + 1][3])};
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          uint32_t vb[4];
          sm90::ldmatrix_x4_trans(vb, Xs + (16 * kg + 8 * (mi % 2) + lane % 8) * XP + 16 * j + 8 * (mi / 2));
          sm90::mma_bf16_16816(acc[2 * j], pa, vb[0], vb[1]);
          sm90::mma_bf16_16816(acc[2 * j + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  bf16* Y = static_cast<bf16*>(a.y) + (static_cast<long long>(b) * a.S + c0) * a.H * HD + h * HD;
  const long long y_ss = static_cast<long long>(a.H) * HD;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = 8 * nt + 2 * tq;
    if (ia < q)
      *reinterpret_cast<uint32_t*>(Y + ia * y_ss + col) = sm90::pack_bf16(acc[nt][0], acc[nt][1]);
    if (ib < q)
      *reinterpret_cast<uint32_t*>(Y + ib * y_ss + col) = sm90::pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

template <int HD>
int launch_mma(const Args& a, int B, float* st, bf16* hb, float* segs, float* cb,
               cudaStream_t s) {
  const int nc = a.S / a.q, nqt = (a.q + kRows - 1) / kRows;
  const long long b1 = states_bytes(HD, a.ds, a.q), b2 = cb_bytes(a.ds),
                  b3 = outputs_bytes(HD, a.ds, a.q);
  if (b1 > kMaxSmem || b2 > kMaxSmem || b3 > kMaxSmem) return -3;
  cudaError_t err = cudaFuncSetAttribute(ssd_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(b1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(b2));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_outputs<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(b3));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_states<<<dim3(nc, a.H, B), kMmaThreads, b1, s>>>(a, st, segs);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_cb<<<dim3(nc * nqt, a.G, B), kMmaThreads, b2, s>>>(a, cb);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n = HD * a.ds;
  ssd_pass<<<dim3((n + 255) / 256, a.H, B), 256, 0, s>>>(st, hb, segs, nc, a.q, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_outputs<HD><<<dim3(nc * nqt, a.H, B), kMmaThreads, b3, s>>>(a, hb, segs, cb);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const Args& a, int B, float* st, bf16* hb, float* segs, float* cb,
                 cudaStream_t s) {
  if (a.ds % 16 != 0 || a.ds > 256 || a.q % 16 != 0) return -2;
  switch (a.hd) {
    case 16: return launch_mma<16>(a, B, st, hb, segs, cb, s);
    case 32: return launch_mma<32>(a, B, st, hb, segs, cb, s);
    case 64: return launch_mma<64>(a, B, st, hb, segs, cb, s);
    case 128: return launch_mma<128>(a, B, st, hb, segs, cb, s);
    default: return -2;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of the "mma" route's two tiled kernels,
// so that the host's route choice can be checked against them.
long long repro_ssd_states_bytes(int hd, int ds, int q) { return states_bytes(hd, ds, q); }
long long repro_ssd_cb_bytes(int ds) { return cb_bytes(ds); }
long long repro_ssd_outputs_bytes(int hd, int ds, int q) { return outputs_bytes(hd, ds, q); }

// Launches the scan on `stream` by `route` (0 = "fma", 1 = "mma"); returns
// cudaGetLastError() (0 = ok), -1 for an unsupported dtype, -2 for an
// unsupported head dimension or (mma) d_state or chunk, and -3 when the
// tiles do not fit a block's shared memory.  x [B, S, H, hd], dt [B, S, H]
// (fp32), B and C [B, S, G, ds] are device pointers addressed by the
// strides given (elements; the last dimension of x, B and C contiguous;
// for "mma" every stride and address 16-byte aligned), A [H] fp32
// contiguous, y [B, S, H, hd] contiguous.  dtype 0 = float32, 1 =
// bfloat16 (x, B, C and y; "mma" takes bfloat16 only).  H % G == 0; hd in
// {16, 32, 64, 128}; S % q == 0.  "mma" scratch (unused by "fma"): states
// [B, H, S / q, hd, ds] fp32, hstates the same in bf16, segs [B, H, S / q,
// q] fp32, cb [B, G, S / q, q, q] fp32.
int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg,
    int B, int S, int H, int hd, int G, int ds, int q, int dtype, int route,
    void* states, void* hstates, void* segs, void* cb, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
               Bm, Cm, y,
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
               b_sb, b_ss, b_sg, c_sb, c_ss, c_sg,
               S, H, G, hd, ds, q};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return -1;
    return dispatch_mma(a, B, static_cast<float*>(states), static_cast<bf16*>(hstates),
                        static_cast<float*>(segs), static_cast<float*>(cb), s);
  }
  if (route != 0) return -2;
  if (sizeof(float) * smem_floats(hd, ds, q) > 232448) return -3;
  if (dtype == 0) return dispatch<float>(a, B, hd, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, hd, s);
  return -1;
}

}  // extern "C"
