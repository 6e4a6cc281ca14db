"""The Mamba2 SSD chunked scan: a CUDA kernel and its plain version.

``ssd_scan(x, dt, A, Bm, Cm, chunk=)`` is the port of the JAX package's
Pallas kernel ``repro.kernels.ssd_scan.ssd_scan`` and of its wrapper
``repro.kernels.ops.ssd_scan``: x [B, S, H, hd], dt [B, S, H] (after
softplus), A [H] (negative), B and C [B, S, ds] shared by every head, or
[B, S, G, ds] with head h reading group ``h // (H // G)`` -> y [B, S, H,
hd] in x's dtype.  In chunks of ``q = min(chunk, S)`` rows, with ``seg``
the chunk's cumulative sum of ``A dt`` and the fp32 state h [hd, ds]
starting at 0:

  y  = (tril(C B^T * exp(seg_i - seg_j)) * dt_j) x  +  exp(seg) * C h^T
  h' = exp(total) h  +  sum_j exp(total - seg_j) dt_j x_j^T B_j

which is the exact recurrence of the oracle ``repro.kernels.ref.ssd_ref``
(h_t = exp(A dt_t) h_{t-1} + dt_t x_t^T B_t, y_t = C_t . h_t) in the
order the TPU kernel sums it.

  * on CUDA tensors it launches ``csrc/ssd_scan.cu``, built with ``nvcc``
    for ``sm_90a`` into ``build/`` at first use and loaded with
    ``ctypes``; ``route(dtype, hd, ds, q, aligned)`` chooses its kernels
    on the host before the launch: ``"mma"`` (bf16 with hd in
    ``HEAD_DIMS``, d_state a multiple of 16 up to ``MAX_STATE``, the chunk
    a multiple of 16, 16-byte aligned rows, and tiles that fit a block:
    four kernels, the chunk states, C B^T once per group of heads, the
    pass over the chunks and the outputs, with the products on the tensor
    cores and scratch the wrapper allocates, ``scratch_sizes``) or
    ``"fma"`` (fp32, and every other shape: one block per batch row and
    head walking the chunks in order with the state in shared memory,
    fp32 FMA code).  x, dt, B and C are read through their strides, so
    views of the model's projections go in uncopied;
  * on CPU tensors it runs ``ssd_scan_plain``, the same chunked form
    written out in torch over all batch rows and heads at once.

There is no fallback between the two: a CUDA tensor launches the kernel
or raises.  Each call on a card adds one to ``ssd_scan.launches`` and to
its route's count in ``ssd_scan.launches_by_route`` (the mma route's
four kernels are one launch of the wrapper).

Gradients.  On CPU tensors autograd differentiates the plain version (the
training path's gradients, held to ``jax.grad`` of the reference's XLA
path).  On CUDA tensors, when any input requires a gradient (and grad
mode is on), the forward launch above runs inside a
``torch.autograd.Function`` that saves the inputs, and its backward
launches ``csrc/ssd_scan_bwd.cu`` (built beside the forward's library):
the chunk states recomputed in fp32, a pass over the chunks for the
states entering them and, in reverse, the state gradients leaving them,
then per chunk the gradients of x, dt, B and C (key tiles: dx, dB and
dt's direct terms; query tiles: dC and the rows' share of d(seg)), a pass
that turns d(seg) into d(A dt) by a reverse cumulative sum, and fixed-
order sums of dB and dC over a group's heads and of dA over the batch
and chunks.  ``backward_route`` chooses its kernels: ``"wgmma"`` (bf16
at hd 64, d_state 64 or 128 and chunks of 64-row tiles up to 256:
mamba2's and zamba2's shapes; C B^T once a (batch row, group, chunk),
dB and dC summed over a slice of a group's heads on chip, the products
on wgmma fed by TMA rings; ``backward_head_slice`` and
``backward_scratch_sizes`` are its host plan) or ``"fma"`` (fp32 FMA
code, per-head dB and dC through scratch: fp32, and every other shape
the forward takes).  No atomics: two runs give the same bits.
``ssd_scan_backward_plain`` is the same chunked backward written out in
torch.  Each backward adds one to ``ssd_scan.backward_launches`` and to
its route's count in ``ssd_scan.backward_launches_by_route``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import _build, _cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
BWD_SOURCE = SOURCE.with_name("ssd_scan_bwd.cu")
# dtype codes of the C interface (x and y; B and C)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 256  # d_state the kernel's shared memory takes
# the kernels of the C interface, by route code
ROUTES = {"fma": 0, "mma": 1}
# query rows of an outputs block of the mma route, key rows of its tiles
MMA_ROWS = 64
_MAX_SMEM_BYTES = 232_448  # a block's shared memory on Hopper
# the backward's kernels, by route code
BWD_ROUTES = {"fma": 0, "wgmma": 1}
BWD_FMA_ROWS = 32  # rows of the backward's FMA tiles
# the backward's wgmma route: 64-row tiles (a warpgroup's), hd 64 (a TMA
# box's 128-byte row), d_state 64 or 128 (one or two 64-column halves),
# chunks of up to 4 tiles (a TMA box of the chunk's rows)
BWD_WGMMA_ROWS = 64
BWD_WGMMA_STATES = (64, 128)
BWD_WGMMA_MAX_CHUNK = 256
BWD_WGMMA_STAGES = 3  # ring tiles in flight
SM_COUNT = 132  # an H100's SMs: a head slicing aims at ~4 blocks an SM

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None


def build() -> Tuple[Path, float, str]:
    """Compile the kernel if its library is missing; returns
    ``(library path, build seconds, compiler output)``."""
    return _build.build(SOURCE)[0]


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_ssd_scan.argtypes = [vp] * 6 + [ll] * 12 + [ci] * 9 + [vp] * 5
        lib.repro_ssd_scan.restype = ci
        for name in ("repro_ssd_states_bytes", "repro_ssd_outputs_bytes"):
            getattr(lib, name).argtypes = [ci] * 3
            getattr(lib, name).restype = ll
        lib.repro_ssd_cb_bytes.argtypes = [ci]
        lib.repro_ssd_cb_bytes.restype = ll
        got = (lib.repro_ssd_states_bytes(64, 128, 256), lib.repro_ssd_cb_bytes(128),
               lib.repro_ssd_outputs_bytes(64, 128, 256))
        if got != mma_smem_bytes(64, 128, 256):
            raise RuntimeError(f"ssd_scan.cu's shared memory {got} differs from the "
                               f"wrapper's {mma_smem_bytes(64, 128, 256)}")
        _LIB = lib
    return _LIB


def _backward_library() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = ctypes.CDLL(str(_build.build(BWD_SOURCE)[0][0]))
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_ssd_scan_bwd.argtypes = [vp] * 11 + [ll] * 12 + [ci] * 10 + [vp] * 11 + [vp]
        lib.repro_ssd_scan_bwd.restype = ci
        lib.repro_ssd_bwd_smem_bytes.argtypes = [ci] * 4
        lib.repro_ssd_bwd_smem_bytes.restype = ll
        for args in ((64, 128, 256, "wgmma"), (64, 64, 256, "wgmma"), (128, 256, 256, "fma")):
            got = lib.repro_ssd_bwd_smem_bytes(*args[:3], BWD_ROUTES[args[3]])
            if got != backward_smem_bytes(*args):
                raise RuntimeError(f"ssd_scan_bwd.cu's shared memory at {args} is {got}, the "
                                   f"wrapper's {backward_smem_bytes(*args)}")
        _BWD_LIB = lib
    return _BWD_LIB


def backward_smem_bytes(hd: int, ds: int, q: int, route: str) -> int:
    """The largest shared memory of the backward's kernels on a route
    (``route_smem_bytes`` of the source).  "fma": dt and seg of the
    chunk (fp32), then the tile kernels' fp32 tiles of ``BWD_FMA_ROWS``
    rows, their accumulators and fp64 sums of M's columns.  "wgmma": the key and query kernels' (``tile_smem``: 1024
    bytes to align the tiles, the block's own 64 rows of B or C and the
    other side's q / 64 tiles, bf16, ds * 128 bytes each, their C B^T
    tiles, fp32, 16 KB each, two head stages of an x or dy tile and a G_c
    or h_c tile, the ring of ``BWD_WGMMA_STAGES`` tiles, the head stages'
    seg and dt, eleven mbarriers), above the scan's (two stages of a
    chunk's x or dy rows, its B or C rows and its seg and dt, or a [64][ds
    + 8] fp32 state if larger, each stage 1024-aligned, the row weights,
    four fp64 sums) and the C B^T kernel's."""
    if route == "wgmma":
        nqt, tile = q // BWD_WGMMA_ROWS, ds * 128
        tiles = (1024 + tile * (1 + nqt) + nqt * 4 * BWD_WGMMA_ROWS ** 2 + 2 * (8192 + tile)
                 + BWD_WGMMA_STAGES * 8192 + 16 * q + (1 + 2 * 2 + 2 * BWD_WGMMA_STAGES) * 8)
        stage = -(-max(q * 128 + q * ds * 2 + 8 * q, 64 * (ds + 8) * 4) // 1024) * 1024
        scan = 1024 + 2 * stage + 4 * q + 4 * 8 + 4 * 8
        cb = 2 * 2 * MMA_ROWS * (ds + 8) + 4 * MMA_ROWS * (MMA_ROWS + 1)
        return max(tiles, scan, cb)
    r = BWD_FMA_ROWS
    return 8 * q + 4 * (3 * r * ds + 3 * r * hd + 4 * r * r + 2 * r) + 8 * r


def backward_head_slice(b: int, s: int, h: int, g: int, q: int) -> int:
    """Heads of a slice of the wgmma route's key and query kernels (a
    block sums dB or dC over its slice's heads; several slices' sums go
    through scratch and a small pass): as many slices as give the grid
    ~4 blocks an SM, but at least 8 heads a slice (so the slices' scratch
    is at most ~1/8 of per-head scratch), or the group's heads when it has
    fewer.  The kernels take it as an argument."""
    rep = h // g
    units = (q // BWD_WGMMA_ROWS) * (s // q) * g * b
    want = -(-4 * SM_COUNT // units)
    n = min(want, rep)
    return max(-(-rep // n), min(rep, 8))


def backward_scratch_sizes(b: int, s: int, h: int, g: int, hd: int, ds: int, q: int,
                           route: str) -> dict:
    """Elements of the backward's scratch on a route, by name (dtypes in
    brackets): the chunk states ``hst`` [b, h, S / q, hd, ds] (fp32),
    ``segs`` [b, h, S / q, q] (fp32), ``aux`` [b, h, S / q, q, 4] (fp64),
    ``dA_part`` [b, h, S / q] (fp64); on "fma" the state
    gradients ``gst`` (as ``hst``) and ``part``, the per-head dB and dC
    [2, b, S, h, ds] (fp32); on "wgmma" ``part``, the head slices' dB and
    dC [2, slices, b, S, G, ds] (fp32; none with one slice), and its own
    ``hb``, ``gb`` (the states and state gradients in bf16, TMA's
    operands), ``dts`` [b, h, S / q, q] (fp32: dt contiguous per chunk),
    ``cb`` [b, G, S / q, 2, q / 64, q / 64, 64 * 64] (fp32: C B^T once a
    (batch row, group, chunk), in both tile kernels' fragment orders) and
    ``gh`` [b, h, S / q] (fp64: sum(G_c * h_c), the scan's, for the
    finalize)."""
    nc = s // q
    states = b * h * nc * hd * ds
    sizes = dict(hst=states, gst=states, segs=b * h * nc * q, aux=b * h * nc * q * 4,
                 dA_part=b * h * nc, hb=0, gb=0, dts=0, cb=0, gh=0)
    if route != "wgmma":
        sizes["part"] = 2 * b * s * h * ds
        return sizes
    slices = -(-(h // g) // backward_head_slice(b, s, h, g, q))
    nqt = q // BWD_WGMMA_ROWS
    sizes.update(gst=0, part=2 * slices * b * s * g * ds if slices > 1 else 0, hb=states,
                 gb=states, dts=b * h * nc * q,
                 cb=b * g * nc * 2 * nqt * nqt * BWD_WGMMA_ROWS ** 2, gh=b * h * nc)
    return sizes


def backward_route(dtype: torch.dtype, hd: int, ds: int, q: int, aligned: bool = True) -> str:
    """The backward's kernels, from x's dtype, the head dim, the state
    size, the chunk and whether x, B, C and dy are 16-byte aligned:
    ``"wgmma"`` for bf16 at hd ``BWD_WGMMA_ROWS``, d_state in
    ``BWD_WGMMA_STATES`` and a chunk of 64-row tiles up to
    ``BWD_WGMMA_MAX_CHUNK``; else ``"fma"``."""
    if (dtype == torch.bfloat16 and aligned and hd == BWD_WGMMA_ROWS
            and ds in BWD_WGMMA_STATES and q % BWD_WGMMA_ROWS == 0
            and q <= BWD_WGMMA_MAX_CHUNK
            and backward_smem_bytes(hd, ds, q, "wgmma") <= _MAX_SMEM_BYTES):
        return "wgmma"
    return "fma"


def mma_smem_bytes(hd: int, ds: int, q: int) -> Tuple[int, int, int]:
    """Shared memory of the mma route's chunk-state, C B^T and output
    blocks (``states_bytes``, ``cb_bytes`` and ``outputs_bytes`` of the
    source): dt and seg (fp32), then bf16 tiles whose rows carry 8 values
    of padding; the outputs block's C tile and state give their room to
    the key loop's C B^T tile (fp32, rows of 64 + 8) and x tile."""
    r = MMA_ROWS
    states = 8 * q + 2 * q * (hd + 8) + 2 * q * (ds + 8)
    cb = 4 * r * (ds + 8)
    outputs = 8 * q + max(2 * (r + hd) * (ds + 8), 4 * r * (r + 8) + 2 * r * (hd + 8))
    return states, cb, outputs


def route(dtype: torch.dtype, hd: int, ds: int, q: int, aligned: bool = True) -> str:
    """The kernels a CUDA call launches, from x's dtype, the head dim, the
    state size, the chunk and whether x, B and C have 16-byte aligned
    addresses and strides: ``"mma"`` for bf16 when the tensor-core tiles
    take the shape, else ``"fma"``, which takes every shape the wrapper
    accepts (fp32 always: its checks leave no room for bf16 operands)."""
    if (dtype == torch.bfloat16 and aligned and hd in HEAD_DIMS and ds % 16 == 0
            and ds <= MAX_STATE and q % 16 == 0
            and max(mma_smem_bytes(hd, ds, q)) <= _MAX_SMEM_BYTES):
        return "mma"
    return "fma"


def scratch_sizes(b: int, s: int, h: int, g: int, hd: int, ds: int,
                  q: int) -> Tuple[int, int, int, int]:
    """Elements of the mma route's scratch: each chunk's own state
    contribution [b, h, S / q, hd, ds] in fp32, the state entering each
    chunk (the same shape) in bf16, each chunk's seg [b, h, S / q, q] in
    fp32, and each chunk's C B^T [b, G, S / q, q, q] in fp32 (once per
    group of heads)."""
    nc = s // q
    return b * h * nc * hd * ds, b * h * nc * hd * ds, b * h * nc * q, b * g * nc * q * q


def _aligned(*tensors: torch.Tensor) -> bool:
    """Addresses and outer strides (of dimensions larger than 1) that are
    multiples of 16 bytes: the mma route loads rows in 16-byte pieces."""
    for t in tensors:
        if t.data_ptr() % 16:
            return False
        if any(n > 1 and (st * t.element_size()) % 16
               for st, n in zip(t.stride()[:-1], t.shape[:-1])):
            return False
    return True


def _grouped(m: torch.Tensor) -> torch.Tensor:
    """B or C as [B, S, G, ds] (a [B, S, ds] tensor is one group)."""
    return m[:, :, None] if m.dim() == 3 else m


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length the scan uses, ``min(chunk, S)``; raises when S is
    not a multiple of it (both JAX versions assert this)."""
    q = min(chunk, s)
    if q < 1 or s % q != 0:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {q}")
    return q


def cost(x: torch.Tensor, Bm: torch.Tensor, q: int) -> Tuple[float, float]:
    """(flops, bytes) of one forward: per (batch row, group, chunk) the
    causal C B^T, per (batch row, head, chunk) the causal W x product, the
    carried state's C h and the state update, 2 flops a product; x and y
    moved once, dt, B and C read once."""
    b, s, h, hd = x.shape
    g, ds = _grouped(Bm).shape[2:]
    pairs = q * (q + 1) // 2
    flops = b * (s // q) * (g * 2 * pairs * ds + h * (2 * pairs * hd + 4 * q * hd * ds))
    return float(flops), x.element_size() * (2 * b * s * h * hd + 2 * b * s * g * ds) + 4 * (
        b * s * h + h)


def backward_cost(x: torch.Tensor, Bm: torch.Tensor, q: int) -> Tuple[float, float]:
    """(flops, bytes) of one backward: per (batch row, group, chunk) C B^T,
    per head the causal dy x^T, W^T dy, V^T C and V B products and five
    state products over the chunk's rows; x, dy, B, C and dt read and dx,
    dB, dC and ddt written once."""
    b, s, h, hd = x.shape
    g, ds = _grouped(Bm).shape[2:]
    pairs = q * (q + 1) // 2
    flops = b * (s // q) * (g * 2 * pairs * ds
                            + h * (2 * pairs * (2 * hd + 2 * ds) + 10 * q * hd * ds))
    return float(flops), x.element_size() * (3 * b * s * h * hd + 4 * b * s * g * ds) + 4 * (
        2 * b * s * h + 2 * h)


class _Counted:
    """A CPU call under an op counter (``_cost.CountedCall``)."""

    name = "ssd_scan"

    def __init__(self, q: int) -> None:
        self.q = q

    def cost(self, x, dt, A, Bm, Cm):
        return cost(x, Bm, self.q)

    def backward_cost(self, x, dt, A, Bm, Cm):
        return backward_cost(x, Bm, self.q)

    def run(self, *tensors):
        return (ssd_scan_plain(*tensors, chunk=self.q)[0],), ()

    def empty(self, x, *rest):
        return (torch.empty_like(x),), ()

    def grad(self, inputs, saved, grads):
        return ssd_scan_backward_plain(*inputs, grads[0], chunk=self.q)


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, *, chunk: int = 128, h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel, written out plainly, for tensors
    on any device; returns ``(y, h_final)``, the state [B, H, hd, ds] in
    fp32 after the last chunk.  ``h0`` is the state before the first
    chunk (zeros when None).  Sums are fp32, fp64 (and the state fp64)
    for fp64 inputs."""
    b, s, h, hd = x.shape
    Bg, Cg = _grouped(Bm), _grouped(Cm)
    rep = h // Bg.shape[2]
    ds = Bg.shape[-1]
    q = chunk_len(s, chunk)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    A = A.to(acc)
    dt = dt.to(acc)
    state = (torch.zeros(b, h, hd, ds, dtype=acc, device=x.device)
             if h0 is None else h0.to(acc))
    masked = ~torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, s, q):
        xc = x[:, c0:c0 + q].to(acc)  # [b, q, h, hd]
        dtc = dt[:, c0:c0 + q]  # [b, q, h]
        bc = Bg[:, c0:c0 + q].to(acc).repeat_interleave(rep, dim=2)  # [b, q, h, ds]
        cc = Cg[:, c0:c0 + q].to(acc).repeat_interleave(rep, dim=2)
        seg = torch.cumsum(A * dtc, dim=1)  # [b, q, h]
        total = seg[:, -1]  # [b, h]
        # intra-chunk: mask before the exp, as the reference does
        rel = seg[:, :, None, :] - seg[:, None, :, :]  # [b, qi, qj, h]
        decay = torch.exp(rel.masked_fill(masked[None, :, :, None], float("-inf")))
        cb = torch.einsum("binc,bjnc->bijn", cc, bc)
        w = cb * decay * dtc[:, None, :, :]
        y_intra = torch.einsum("bijn,bjnh->binh", w, xc)
        # inter-chunk: the carried state
        y_inter = torch.einsum("binc,bnhc->binh", cc, state) * torch.exp(seg)[..., None]
        carry = torch.exp(total[:, None, :] - seg) * dtc  # [b, q, h]
        state = torch.exp(total)[:, :, None, None] * state + torch.einsum(
            "bjnh,bjnc->bnhc", xc * carry[..., None], bc)
        ys.append((y_intra + y_inter).to(x.dtype))
    return torch.cat(ys, dim=1), state


def ssd_scan_backward_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, dy: torch.Tensor, *, chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``ssd_scan`` written out as the chunked backward the
    kernels compute (not as autograd), for tensors on any device: ``(dx,
    ddt, dA, dB, dC)`` in the inputs' dtypes and shapes, from the output
    gradient dy [B, S, H, hd].  Per (batch row, head), with h_c the fp32
    state entering chunk c, seg the chunk's cumulative sum of A dt and tot
    its last entry:

      g_c  = exp(tot_c) g_{c+1} + sum_i exp(seg_i) dy_i C_i^T  (g_nc = 0)
      dx_j = dt_j [sum_{i >= j} (C_i . B_j) exp(seg_i - seg_j) dy_i
                   + exp(tot - seg_j) g_{c+1} B_j]

    dB and dC by the same two parts (within the chunk, and the carried
    state), summed over a group's heads; dt's direct terms, then d(seg)
    carried to d(A dt) by a reverse cumulative sum within the chunk, ddt +=
    A d(A dt) and dA = sum dt d(A dt).  The mask is applied before the exp,
    as in the forward.  Sums are fp32, fp64 for fp64 inputs."""
    b, s, h, hd = x.shape
    Bg, Cg = _grouped(Bm), _grouped(Cm)
    G, ds = Bg.shape[2], Bg.shape[3]
    rep = h // G
    q = chunk_len(s, chunk)
    nc = s // q
    # sums in fp32, or in fp64 for fp64 inputs (a reference for the fp32
    # kernels: d(seg)'s reverse cumulative sums and dA cancel heavily)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc).reshape(b, nc, q, h, hd)
    dyf = dy.to(acc).reshape(b, nc, q, h, hd)
    Bh = Bg.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, q, h, ds)
    Ch = Cg.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, q, h, ds)
    dtc = dt.to(acc).reshape(b, nc, q, h)
    Af = A.to(acc)
    seg = torch.cumsum(Af * dtc, dim=2)  # [b, nc, q, h]
    tot = seg[:, :, -1]  # [b, nc, h]
    e_tail = torch.exp(tot[:, :, None] - seg)  # exp(tot - seg_j)
    e_seg = torch.exp(seg)
    # each chunk's own state contribution and its share of the state gradient
    s_c = torch.einsum("bcqhp,bcqhn->bchpn", xf * (e_tail * dtc)[..., None], Bh)
    u_c = torch.einsum("bcqhp,bcqhn->bchpn", dyf * e_seg[..., None], Ch)
    H = torch.zeros_like(s_c)  # the state entering chunk c
    Gl = torch.zeros_like(u_c)  # the gradient of the state leaving chunk c
    run = torch.zeros_like(s_c[:, 0])
    for c in range(nc):
        H[:, c] = run
        run = torch.exp(tot[:, c])[..., None, None] * run + s_c[:, c]
    run = torch.zeros_like(u_c[:, 0])
    for c in reversed(range(nc)):
        Gl[:, c] = run
        run = torch.exp(tot[:, c])[..., None, None] * run + u_c[:, c]
    # within the chunk: [b, nc, h, i, j], masked before the exp
    sp = seg.permute(0, 1, 3, 2)
    keep = torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    decay = torch.exp((sp[..., :, None] - sp[..., None, :]).masked_fill(~keep, float("-inf")))
    dtj = dtc.permute(0, 1, 3, 2)[..., None, :]
    CB = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)
    DX = torch.einsum("bcihp,bcjhp->bchij", dyf, xf)
    W = CB * decay * dtj
    V = DX * decay * dtj
    E = CB * decay * DX
    GB = torch.einsum("bchpn,bcjhn->bcjhp", Gl, Bh)
    dx = torch.einsum("bchij,bcihp->bcjhp", W, dyf) + (dtc * e_tail)[..., None] * GB
    dBh = (torch.einsum("bchij,bcihn->bcjhn", V, Ch)
           + (e_tail * dtc)[..., None] * torch.einsum("bchpn,bcjhp->bcjhn", Gl, xf))
    HY = torch.einsum("bchpn,bcihp->bcihn", H, dyf)  # h_c^T dy_i
    dCh = torch.einsum("bchij,bcjhn->bcihn", V, Bh) + e_seg[..., None] * HY
    e1 = E.sum(-2).permute(0, 1, 3, 2)  # [b, nc, j, h]
    e2 = e_tail * (xf * GB).sum(-1)
    rows = (E * dtj).sum(-1).permute(0, 1, 3, 2)  # [b, nc, i, h]
    n_inter = e_seg * (Ch * HY).sum(-1)  # dy_i . (h_c C_i), as C_i . (h_c^T dy_i)
    # d(seg), then d(A dt) by a reverse cumulative sum within the chunk
    dseg = rows + n_inter - dtc * (e1 + e2)
    dtot = torch.exp(tot) * (Gl * H).sum((-1, -2)) + (dtc * e2).sum(2)
    dseg[:, :, -1] += dtot
    da = torch.flip(torch.cumsum(torch.flip(dseg, [2]), 2), [2])
    ddt = (e1 + e2 + Af * da).reshape(b, s, h)
    dA = (dtc * da).sum((0, 1, 2))
    dB = dBh.reshape(b, s, G, rep, ds).sum(3).to(Bm.dtype).reshape(Bm.shape)
    dC = dCh.reshape(b, s, G, rep, ds).sum(3).to(Cm.dtype).reshape(Cm.shape)
    return (dx.reshape(b, s, h, hd).to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype), dB, dC)


def _check(x, dt, A, Bm, Cm) -> None:
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype} and {A.dtype}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"Bm {Bm.dtype} and Cm {Cm.dtype} must be x's {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, hd], got {tuple(x.shape)}")
    b, s, h, _ = x.shape
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} or A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    Bg, Cg = _grouped(Bm), _grouped(Cm)
    if Bg.dim() != 4 or Bg.shape != Cg.shape or tuple(Bg.shape[:2]) != (b, s):
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} must be "
                         f"[B, S, ds] or [B, S, G, ds] over x {tuple(x.shape)}")
    if Bg.shape[2] == 0 or h % Bg.shape[2] != 0:
        raise ValueError(f"{h} heads do not group over {Bg.shape[2]} B/C groups")


@_cost.reports("ssd_scan", lambda x, dt, A, Bm, Cm, q: cost(x, Bm, q))
def _launch(x, dt, A, Bm, Cm, q: int) -> torch.Tensor:
    b, s, h, hd = x.shape
    Bg, Cg = _grouped(Bm), _grouped(Cm)
    G, ds = Bg.shape[2], Bg.shape[3]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dimension {hd} not in the kernel's {HEAD_DIMS}")
    if ds > MAX_STATE:
        raise ValueError(f"d_state {ds} above the kernel's {MAX_STATE}")
    if max(x.stride(3), Bg.stride(3), Cg.stride(3)) != 1:
        raise ValueError("the last dimension of x, Bm and Cm must be contiguous")
    A = A.contiguous()
    y = torch.empty((b, s, h, hd), dtype=x.dtype, device=x.device)
    r = route(x.dtype, hd, ds, q, _aligned(x, Bg, Cg))
    n_st, n_h, n_seg, n_cb = (scratch_sizes(b, s, h, G, hd, ds, q) if r == "mma"
                              else (0, 0, 0, 0))
    states = torch.empty(n_st, dtype=torch.float32, device=x.device)
    hstates = torch.empty(n_h, dtype=torch.bfloat16, device=x.device)
    segs = torch.empty(n_seg, dtype=torch.float32, device=x.device)
    cb = torch.empty(n_cb, dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bg.data_ptr(),
            Cg.data_ptr(), y.data_ptr(),
            *x.stride()[:3], *dt.stride(), *Bg.stride()[:3], *Cg.stride()[:3],
            b, s, h, hd, G, ds, q, _DTYPES[x.dtype], ROUTES[r],
            states.data_ptr(), hstates.data_ptr(), segs.data_ptr(), cb.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed ({r} route): error {err}")
    ssd_scan.launches += 1
    ssd_scan.launches_by_route[r] += 1
    return y


def ssd_scan(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, *, chunk: int = 128,
) -> torch.Tensor:
    """The SSD scan y [B, S, H, hd] in x's dtype (see the module's note).

    x fp32 or bf16, B and C in x's dtype, dt and A fp32; any strides with
    the last dimension contiguous.  Raises when S is not a multiple of
    ``min(chunk, S)``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel (hd in ``HEAD_DIMS``, d_state up to ``MAX_STATE``).
    Under an op counter a CPU call is counted at ``cost`` and its backward
    at ``backward_cost`` (``_cost``)."""
    _check(x, dt, A, Bm, Cm)
    q = chunk_len(x.shape[1], chunk)
    if x.device.type == "cpu":
        if _cost.counting():
            return _cost.counted(_Counted(q), x, dt, A, Bm, Cm)
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=q)[0]
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, Bm, Cm)):
            _check_backward(x, Bm, q)
            return _Scan.apply(x, dt, A, Bm, Cm, q)
        return _launch(x, dt, A, Bm, Cm, q)
    raise ValueError(f"no ssd_scan kernel for device {x.device}")


def _check_backward(x: torch.Tensor, Bm: torch.Tensor, q: int) -> None:
    """Refuse, before the forward, a call whose gradient the backward
    kernels do not compute: the FMA route (which every shape may take)
    must fit a block's shared memory."""
    hd, ds = x.shape[3], _grouped(Bm).shape[3]
    if (hd not in HEAD_DIMS or ds > MAX_STATE
            or backward_smem_bytes(hd, ds, q, "fma") > _MAX_SMEM_BYTES):
        raise NotImplementedError(
            f"ssd_scan's backward kernels take hd in {HEAD_DIMS}, d_state up to "
            f"{MAX_STATE} and tiles within a block's shared memory; got hd {hd}, "
            f"d_state {ds}, chunk {q}")


@_cost.reports("ssd_scan backward", lambda x, dt, A, Bm, Cm, dy, q: backward_cost(x, Bm, q))
def _launch_backward(x, dt, A, Bm, Cm, dy, q: int):
    b, s, h, hd = x.shape
    Bg, Cg = _grouped(Bm), _grouped(Cm)
    G, ds = Bg.shape[2], Bg.shape[3]
    dy = dy.contiguous()
    A = A.contiguous()
    r = backward_route(x.dtype, hd, ds, q, _aligned(x, Bg, Cg, dy))
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, h, hd), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), **f32)
    dA = torch.empty((h,), **f32)
    dB = torch.empty((b, s, G, ds), dtype=Bm.dtype, device=dev)
    dC = torch.empty((b, s, G, ds), dtype=Cm.dtype, device=dev)
    # scratch (``backward_scratch_sizes``): fp64 for aux (d(seg)'s row and
    # column sums cancel) and dA's per-chunk parts, bf16 for the wgmma
    # route's copies of the states, fp32 otherwise
    hs = backward_head_slice(b, s, h, G, q) if r == "wgmma" else 0
    n = backward_scratch_sizes(b, s, h, G, hd, ds, q, r)
    dtypes = dict(aux=torch.float64, dA_part=torch.float64, gh=torch.float64,
                  hb=torch.bfloat16, gb=torch.bfloat16)
    scratch = {k: torch.empty(v, dtype=dtypes.get(k, torch.float32), device=dev)
               for k, v in n.items()}

    def ptr(name):
        return scratch[name].data_ptr() if n[name] else None

    lib = _backward_library()
    outs = (dy, dx, ddt, dA, dB, dC)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bg.data_ptr(), Cg.data_ptr(),
            *(t.data_ptr() for t in outs),
            *x.stride()[:3], *dt.stride(), *Bg.stride()[:3], *Cg.stride()[:3],
            b, s, h, hd, G, ds, q, _DTYPES[x.dtype], BWD_ROUTES[r], hs,
            *(ptr(k) for k in ("hst", "gst", "hb", "gb", "segs", "dts", "cb", "gh", "aux",
                               "part", "dA_part")),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed ({r} route): error {err}")
    ssd_scan.backward_launches += 1
    ssd_scan.backward_launches_by_route[r] += 1
    return dx, ddt, dA, dB.reshape(Bm.shape), dC.reshape(Cm.shape)


class _Scan(torch.autograd.Function):
    """The forward kernels, with the backward kernels as their gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, q):
        y = _launch(x, dt, A, Bm, Cm, q)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.q = q
        return y

    @staticmethod
    def backward(ctx, dy):
        grads = _launch_backward(*ctx.saved_tensors, dy, ctx.q)
        return (*grads, None)


ssd_scan.launches = 0  # type: ignore[attr-defined]
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)  # type: ignore[attr-defined]
ssd_scan.backward_launches = 0  # type: ignore[attr-defined]
ssd_scan.backward_launches_by_route = dict.fromkeys(BWD_ROUTES, 0)  # type: ignore[attr-defined]
