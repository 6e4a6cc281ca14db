// Sequential priority waterfill of NIC capacity, one warp per instance.
//
// Replaces the TPU kernel repro.kernels.waterfill.waterfill_fill (Pallas
// body `_kernel`, src/repro/kernels/waterfill.py), the rate pass of the
// fifo and mrtf policies in the batched event engine.  For each instance b
// the warp walks order[b, :]; each eligible flow i gets
// min(rem_in[dst[i]], rem_out[src[i]]) if that exceeds EPS, else 0, and the
// grant is subtracted from both NICs.  The arithmetic is compares and two
// subtractions per grant, with no multiply-add to contract, so the result
// equals the plain version and the Pallas kernel bit for bit.
//
// What bounds it on an H100: latency.  Within an instance each grant
// depends on the NIC remainders the previous grants left, so the
// dependent chain is EG steps long, while the bytes moved are few (three
// int32 and one bool row in, one float64 row out: ~9 us at B = 1024, EG =
// 1400).  The first kernel (one thread per instance) put two dependent
// device-memory loads on every step (order[k], then dst/src/elig of that
// flow) and filled 32 of the 132 SMs.  This one takes both off the chain:
//
//   * A warp per instance, kWarps of them a block (256 blocks at B = 1024,
//     all resident at once).
//   * The gather is done off the chain.  A step's flow and NICs do not
//     depend on earlier grants, only the remainders do.  So in tiles of
//     kTile steps the 32 lanes read the order row (coalesced), gather
//     dst, src and elig of each step's flow, drop the ineligible steps and
//     pack the rest, in priority order, as one int2 per step {flow, dst |
//     src << 16} in shared memory (a ballot and a prefix count keep the
//     order).
//   * The chain runs on chip, on one lane.  The NIC remainders live in
//     shared memory (fp64, M of each).  The packed ids are read ahead, and
//     the next step's two remainders are loaded before this step's stores
//     and corrected in registers when the next step shares this step's
//     ingress or egress NIC (a store-to-load forward).  So a step's
//     dependent chain is the fp64 compare, select and subtract and one
//     select alone (the tests against EPS read the remainders, not the
//     min); the shared-memory round trip runs beside it.  Holding one NIC
//     a lane and reading the remainders with __shfl_sync (M <= 32) was
//     measured with the chain probe below (its mode 2) against this form
//     (mode 0) and against the plain shared-memory read-min-write step
//     (mode 1); PERF.md gives the numbers and the reason this form was
//     kept.
//   * The grants go into a shared row of EG fp64 values, zeroed first and
//     written out coalesced once the instance is done; where that row
//     does not fit, they go straight to the zeroed output row.
//
// The host (kernels/waterfill.py, launch_plan) picks the warps a block and
// the grant row's place from the shared memory each needs.
//
// repro_waterfill_chain_probe times the chain alone: one warp running the
// step on ids already in shared memory, no gather, no output.  Its time
// for EG steps is the kernel's chain bound, measured on the card.
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (repro_torch/kernels/waterfill.py loads it with ctypes).

#include <cuda_runtime.h>

namespace {

constexpr double kEps = 1e-9;   // repro_torch.core.engine.EPS
constexpr int kWarps = 4;       // instances per block, at most
constexpr int kTile = 512;      // steps gathered per tile
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t warp_bytes(int EG, int M, bool row) {
  const size_t b = kTile * sizeof(int2) + 2 * sizeof(double) * static_cast<size_t>(M) +
                   (row ? sizeof(double) * static_cast<size_t>(EG) : 0);
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ int nic_in(int2 w) { return w.y & 0xffff; }
__device__ __forceinline__ int nic_out(int2 w) { return w.y >> 16; }

// One step on the remainders a (ingress) and c (egress): the candidate
// grant g = min(a, c), written as the reference writes it, and whether it
// is made.  min(a, c) > EPS holds exactly when both remainders exceed EPS,
// and a NaN remainder exceeds nothing, so both tests read a and c and run
// beside the min, not after it.
__device__ __forceinline__ double grant(double a, double c, bool& ok) {
  ok = (a > kEps) & (c > kEps);
  return a < c ? a : c;
}

// The chain over n packed steps, on one lane.  rin/rout: the instance's
// remainders in shared memory; grants: its output row (shared or device
// memory).  The next step's remainders are loaded before this step's
// stores and forwarded from this step when it shares a NIC, so no load
// waits on a store.
__device__ __forceinline__ void run_chain(const int2* __restrict__ words, int n,
                                          double* rin, double* rout, double* grants) {
  if (n <= 0) return;
  int2 w = words[0];
  int d = nic_in(w), s = nic_out(w), i = w.x;
  double a = rin[d], c = rout[s];
  int2 ahead = words[n > 1 ? 1 : 0];
  for (int k = 0; k < n; ++k) {
    const int2 w1 = ahead;
    ahead = words[k + 2 < n ? k + 2 : n - 1];
    const int d1 = nic_in(w1), s1 = nic_out(w1);
    const double la = rin[d1], lc = rout[s1];
    bool ok;
    const double g = grant(a, c, ok);
    const double an = a - g, cn = c - g;
    rin[d] = ok ? an : a;
    rout[s] = ok ? cn : c;
    if (ok) grants[i] = g;
    // the next remainders: one select after the subtraction on the chain
    const double ka = d1 == d ? a : la, kc = s1 == s ? c : lc;
    a = ok & (d1 == d) ? an : ka;
    c = ok & (s1 == s) ? cn : kc;
    d = d1;
    s = s1;
    i = w1.x;
  }
}

// Gathers the steps [t0, t0 + kTile) of one instance (pointers at its
// row): the eligible ones, in order, packed into words; returns how many.
__device__ __forceinline__ int gather_tile(const int* __restrict__ order,
                                           const int* __restrict__ src,
                                           const int* __restrict__ dst,
                                           const bool* __restrict__ elig, int t0, int EG,
                                           int2* words, int lane) {
  constexpr int R = kTile / 32;
  int ids[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int k = t0 + 32 * r + lane;
    ids[r] = k < EG ? order[k] : -1;
  }
  // loads clamped to a valid flow, not guarded, so that all issue at once
  int di[R], si[R];
  bool ei[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = ids[r] < 0 ? 0 : ids[r];
    ei[r] = elig[f];
    di[r] = dst[f];
    si[r] = src[f];
  }
  int n = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool e = ids[r] >= 0 && ei[r];
    const unsigned m = __ballot_sync(kFull, e);
    if (e) words[n + __popc(m & below)] = make_int2(ids[r], di[r] | (si[r] << 16));
    n += __popc(m);
  }
  return n;
}

template <bool kRow>
__global__ void waterfill_kernel(const int* __restrict__ order, const int* __restrict__ src,
                                 const int* __restrict__ dst, const bool* __restrict__ elig,
                                 const double* __restrict__ cap_in,
                                 const double* __restrict__ cap_out, double* __restrict__ out,
                                 int B, int EG, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;  // the whole warp
  unsigned char* base = smem + w * warp_bytes(EG, M, kRow);
  int2* words = reinterpret_cast<int2*>(base);
  double* rin = reinterpret_cast<double*>(base + kTile * sizeof(int2));
  double* rout = rin + M;
  const size_t row = static_cast<size_t>(b) * EG;
  double* out_row = out + row;
  double* grants = kRow ? rout + M : out_row;
  const size_t row_m = static_cast<size_t>(b) * M;
  for (int m = lane; m < M; m += 32) {
    rin[m] = cap_in[row_m + m];
    rout[m] = cap_out[row_m + m];
  }
  for (int k = lane; k < EG; k += 32) grants[k] = 0.0;
  __syncwarp();  // also orders the zeroing before lane 0's grants
  for (int t0 = 0; t0 < EG; t0 += kTile) {
    const int n = gather_tile(order + row, src + row, dst + row, elig + row, t0, EG, words, lane);
    __syncwarp();
    if (lane == 0) run_chain(words, n, rin, rout, grants);
    __syncwarp();  // the tile is consumed before the next gather
  }
  if (kRow)
    for (int k = lane; k < EG; k += 32) out_row[k] = grants[k];
}

// ------------------------------------------------------------ the probe
// One warp, `steps` packed steps over M NICs drawn by a hash (every step
// eligible), run `reps` times from fresh remainders.  MODE 0: the kernel's
// chain (run_chain); 1: the plain shared-memory step (load both
// remainders, grant, store, no forwarding); 2: one NIC a lane in
// registers, read with __shfl_sync (M <= 32), every lane running the
// chain.  out[0]: a checksum of the grants, out[1]: lane 0's clock cycles
// over all reps.
template <int MODE>
__global__ void chain_probe_kernel(int steps, int M, int reps, double* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* words = reinterpret_cast<int2*>(smem);
  double* rin = reinterpret_cast<double*>(smem + static_cast<size_t>(steps) * sizeof(int2));
  double* rout = rin + M;
  double* grants = rout + M;
  const int lane = threadIdx.x;
  for (int k = lane; k < steps; k += 32) {
    const unsigned h = (static_cast<unsigned>(k) + 1u) * 2654435761u;
    const int d = static_cast<int>((h >> 7) % static_cast<unsigned>(M));
    const int s = static_cast<int>((h >> 19) % static_cast<unsigned>(M));
    words[k] = make_int2(k, d | (s << 16));
    grants[k] = 0.0;
  }
  __syncwarp();
  long long cycles = 0;
  for (int rep = 0; rep < reps; ++rep) {
    double r_in = 0.0, r_out = 0.0;  // MODE 2: lane m's NICs
    for (int m = lane; m < M; m += 32) {
      rin[m] = 1.0 + 0.25 * m + rep;
      rout[m] = 2.0 + 0.5 * m;
    }
    if (lane < M) {
      r_in = 1.0 + 0.25 * lane + rep;
      r_out = 2.0 + 0.5 * lane;
    }
    __syncwarp();
    const long long t0 = clock64();
    if (MODE == 0) {
      if (lane == 0) run_chain(words, steps, rin, rout, grants);
    } else if (MODE == 1) {
      if (lane == 0)
        for (int k = 0; k < steps; ++k) {
          const int2 w = words[k];
          const int d = nic_in(w), s = nic_out(w);
          const double a = rin[d], c = rout[s];
          bool ok;
          const double g = grant(a, c, ok);
          if (ok) {
            rin[d] = a - g;
            rout[s] = c - g;
            grants[w.x] = g;
          }
        }
    } else {
      for (int k = 0; k < steps; ++k) {  // warp-uniform trip count
        const int2 w = words[k];
        const int d = nic_in(w), s = nic_out(w);
        const double a = __shfl_sync(kFull, r_in, d);
        const double c = __shfl_sync(kFull, r_out, s);
        bool ok;
        const double g = grant(a, c, ok);
        if (ok && lane == d) r_in = a - g;
        if (ok && lane == s) r_out = c - g;
        if (ok && lane == 0) grants[w.x] = g;
      }
    }
    __syncwarp();
    cycles += clock64() - t0;
  }
  if (lane == 0) {
    double sum = 0.0;
    for (int k = 0; k < steps; ++k) sum += grants[k];
    out[0] = sum;
    out[1] = static_cast<double>(cycles);
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" {

// The kernel's constants, so that the host's launch plan can be checked
// against them.
int repro_waterfill_tile() { return kTile; }
int repro_waterfill_max_warps() { return kWarps; }
long long repro_waterfill_warp_bytes(int EG, int M, int row) {
  return static_cast<long long>(warp_bytes(EG, M, row != 0));
}

// Launches the kernel on `stream`, `warps` instances a block (1 to
// kWarps), the grants in a shared row when `row` is non-zero; returns
// cudaGetLastError() (0 = ok), or -3 when the block's shared memory is
// more than a block may use.  All pointers are device pointers to
// C-contiguous arrays: order/src/dst [B, EG] int32, elig [B, EG] bool,
// caps [B, M] float64, out [B, EG] float64.  Machine ids must lie in [0,
// M) and order must hold a permutation of [0, EG); M < 32768.
int repro_waterfill_fill(const void* order, const void* src, const void* dst,
                         const void* elig, const void* cap_in, const void* cap_out, void* out,
                         int B, int EG, int M, int warps, int row, void* stream) {
  if (warps < 1 || warps > kWarps || M >= 32768) return -2;
  const size_t smem = warps * warp_bytes(EG, M, row != 0);
  if (smem > static_cast<size_t>(kMaxSmem)) return -3;
  const int blocks = (B + warps - 1) / warps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(order);
  const int* sr = static_cast<const int*>(src);
  const int* ds = static_cast<const int*>(dst);
  const bool* el = static_cast<const bool*>(elig);
  const double* ci = static_cast<const double*>(cap_in);
  const double* co = static_cast<const double*>(cap_out);
  double* r = static_cast<double*>(out);
  if (row) {
    const int err = set_smem(waterfill_kernel<true>, smem);
    if (err) return err;
    waterfill_kernel<true><<<blocks, 32 * warps, smem, s>>>(o, sr, ds, el, ci, co, r, B, EG, M);
  } else {
    const int err = set_smem(waterfill_kernel<false>, smem);
    if (err) return err;
    waterfill_kernel<false><<<blocks, 32 * warps, smem, s>>>(o, sr, ds, el, ci, co, r, B, EG, M);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches the chain probe (one warp) on `stream`: `steps` steps over M
// NICs, `reps` times, in the given mode (0, 1 or 2; 2 needs M <= 32).
// out: 2 float64 on the device.  Returns cudaGetLastError(), -2 for a bad
// mode or M, -3 when the steps do not fit shared memory.
int repro_waterfill_chain_probe(int steps, int M, int reps, int mode, void* out,
                                void* stream) {
  if (mode < 0 || mode > 2 || M < 1 || M >= 32768 || (mode == 2 && M > 32)) return -2;
  const size_t smem = static_cast<size_t>(steps) * (sizeof(int2) + sizeof(double)) +
                      2 * sizeof(double) * static_cast<size_t>(M);
  if (smem > static_cast<size_t>(kMaxSmem)) return -3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* o = static_cast<double*>(out);
  int err = 0;
  switch (mode) {
    case 0:
      err = set_smem(chain_probe_kernel<0>, smem);
      if (!err) chain_probe_kernel<0><<<1, 32, smem, s>>>(steps, M, reps, o);
      break;
    case 1:
      err = set_smem(chain_probe_kernel<1>, smem);
      if (!err) chain_probe_kernel<1><<<1, 32, smem, s>>>(steps, M, reps, o);
      break;
    default:
      err = set_smem(chain_probe_kernel<2>, smem);
      if (!err) chain_probe_kernel<2><<<1, 32, smem, s>>>(steps, M, reps, o);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
