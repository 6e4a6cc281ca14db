"""The MoE grouped GEMM: a CUDA kernel and its plain version.

``moe_grouped_gemm(x, w, group_sizes)`` is the port of the JAX package's
Pallas kernel ``repro.kernels.moe_gemm.moe_gemm_padded`` behind its
wrapper ``repro.kernels.ops.moe_grouped_gemm``, which computes the oracle
``repro.kernels.ref.grouped_gemm_ref`` (``jax.lax.ragged_dot``): x [T, D]
with its rows sorted by expert, w [E, D, F], group_sizes [E] -> [T, F] in
x's dtype, where the ``group_sizes[e]`` rows of expert e's segment are
multiplied by ``w[e]`` with fp32 sums, and the rows past
``sum(group_sizes)`` are zero.

  * on CUDA tensors it launches ``csrc/moe_gemm.cu``, built with ``nvcc``
    for ``sm_90a`` into ``build/`` at first use and loaded with
    ``ctypes``.  The group sizes stay on the card: each block of the
    kernel finds its (expert, rows) from them itself, over a grid of
    ``ceil(T / R) + E`` row tiles of R rows (an upper bound on the tiles
    the segments need; R = 128 on the wgmma route, else 64), and tiles
    with no rows exit.  So a call never waits
    for the host, and no weight of an expert without rows is read.
    ``route(dtype, T, E)`` chooses the kernel on the host before the
    launch: ``"wgmma"`` (bf16 with T > 4 E, a prefill: 128-row tiles on
    the tensor cores, x and w loaded with TMA, which needs x's address
    and row stride 16-byte aligned), ``"stream"`` when T <= 4 E (a decode
    step: a persistent grid walks tiles of up to 4 rows x 256 columns x a
    slice of D, ``stream_split``, streaming the experts' weights; the
    slices' fp32 partial sums go to scratch and a second kernel adds them
    in slice order), or ``"fma"`` for fp32 above (64-row tiles through
    shared memory with fp32 FMAs);
  * on CPU tensors it runs ``moe_grouped_gemm_plain``: a loop over the
    experts of ``x[seg] @ w[e]`` in fp32, cast to x's dtype.

The TPU kernel needs the rows padded so that each 128-row block holds one
expert (``ops.padded_group_layout``); this kernel takes the segments as
they are, so the layout has no counterpart here.  There is no fallback
between the routes: a CUDA tensor launches the kernel of its route or
raises.  Each launch adds one to ``moe_grouped_gemm.launches`` and to
its route's count in ``moe_grouped_gemm.launches_by_route``.

Gradients.  On CPU tensors autograd differentiates the plain version (the
training path's gradients, held to ``jax.grad`` of the reference's XLA
path).  On CUDA tensors, when x or w requires a gradient (and grad mode
is on), the forward launch above runs inside a
``torch.autograd.Function`` that saves x, w and the group sizes, and its
backward launches ``csrc/moe_gemm_bwd.cu`` (built beside the forward's
library): dx = dy w[e]^T per segment, the forward's grouped GEMM with
each expert's weights read K-major, and dw[e] = x[seg]^T dy[seg], each
output tile walking the segment's rows in order; ``backward_route(dtype)``:
``"wgmma"`` for bf16 (dx on the forward's wgmma tiling, dw on a
persistent TMA + wgmma grid), ``"fma"`` for fp32, whatever route the
forward took.  No atomics: two runs give the same bits.
``moe_grouped_gemm_backward_plain`` is the same function written out
plainly.  The backward takes D a multiple of 8 (it stores dx and reads x
in 16-byte pieces); a call that needs a gradient on a card at another D
raises before the forward.  Each backward adds one to
``moe_grouped_gemm.backward_launches`` and to its route's count in
``moe_grouped_gemm.backward_launches_by_route``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from . import _build, _cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "moe_gemm.cu"
BWD_SOURCE = SOURCE.with_name("moe_gemm_bwd.cu")
# dtype codes of the C interface (x, w and the output)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC = 8  # F must be a multiple of this: w rows are read 16 bytes at a time
STREAM_ROWS = 4  # the most rows of a tile that streams its expert's weights
# the route names, and the kernel of the C interface each launches
ROUTES = ("wgmma", "fma", "stream")
_ROUTE_CODES = {"wgmma": 1, "fma": 0, "stream": 2}
BWD_ROUTES = ("wgmma", "fma")  # the backward's kernels: bf16, fp32
# the streaming route reads D in slices of at most STREAM_SLICE rows, each
# a multiple of STREAM_SLICE_STEP (a block step of its unrolled loads)
STREAM_SLICE = 512
STREAM_SLICE_STEP = 128

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
        lib.repro_moe_gemm.argtypes = [vp] * 4 + [ll] + [ci] * 8 + [vp, vp]
        lib.repro_moe_gemm.restype = ci
        _LIB = lib
    return _LIB


def _backward_library() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = ctypes.CDLL(str(_build.build(BWD_SOURCE)[0][0]))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.repro_moe_gemm_bwd.argtypes = [vp] * 6 + [ci] * 5 + [vp]
        lib.repro_moe_gemm_bwd.restype = ci
        _BWD_LIB = lib
    return _BWD_LIB


def route(dtype: torch.dtype, t: int, e: int) -> str:
    """The kernel a CUDA call launches, from x's dtype, T and E alone:
    ``"stream"`` when T <= 4 E (a decode step: most experts' tiles hold at
    most 4 rows), else ``"wgmma"`` for bf16 and ``"fma"`` for fp32."""
    if t <= STREAM_ROWS * e:
        return "stream"
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def backward_route(dtype: torch.dtype) -> str:
    """The backward's kernels for x's dtype: ``"wgmma"`` for bf16, ``"fma"``
    for fp32."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def stream_split(d: int) -> Tuple[int, int]:
    """The streaming route's split of D: ``(slice, n_slices)``, the fewest
    slices of at most ``STREAM_SLICE`` rows, of equal length rounded up to
    ``STREAM_SLICE_STEP`` (the last one shorter)."""
    n = max(1, -(-d // STREAM_SLICE))
    per = -(-d // n)
    sl = -(-per // STREAM_SLICE_STEP) * STREAM_SLICE_STEP
    return sl, -(-d // sl)


def stream_scratch_floats(t: int, f: int, n_slices: int) -> int:
    """fp32 values of the streaming route's scratch: each slice's partial
    sums of the [T, F] output."""
    return n_slices * t * f


def moe_grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                           group_sizes: torch.Tensor) -> torch.Tensor:
    """The same function as the kernel, written out plainly, for tensors
    on any device (it reads the group sizes on the host)."""
    t = x.shape[0]
    out = torch.zeros((t, w.shape[2]), dtype=x.dtype, device=x.device)
    start = 0
    for e, g in enumerate(group_sizes.tolist()):
        g = max(min(int(g), t - start), 0)
        if g:
            out[start:start + g] = (x[start:start + g].float() @ w[e].float()).to(x.dtype)
        start += g
    return out


def moe_grouped_gemm_backward_plain(
    x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``moe_grouped_gemm`` written out plainly, for
    tensors on any device (it reads the group sizes on the host): ``(dx,
    dw)``, a loop over the experts of dx[seg] = dy[seg] w[e]^T and dw[e] =
    x[seg]^T dy[seg], summed in fp32 and cast to x's and w's dtypes; rows
    past ``sum(group_sizes)`` get zero dx and an expert with no rows zero
    dw."""
    t = x.shape[0]
    dx = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.zeros(w.shape, dtype=w.dtype, device=w.device)
    start = 0
    for e, g in enumerate(group_sizes.tolist()):
        g = max(min(int(g), t - start), 0)
        if g:
            d = dy[start:start + g].float()
            dx[start:start + g] = (d @ w[e].float().T).to(x.dtype)
            dw[e] = (x[start:start + g].float().T @ d).to(w.dtype)
        start += g
    return dx, dw


def _routed(x: torch.Tensor, w: torch.Tensor,
            group_sizes: Optional[Sequence[int]]) -> Tuple[int, int]:
    """(rows routed, experts hit): every row of x and every expert without
    the group sizes (they are data; the model's rows are its routed rows),
    else as the sizes say."""
    if group_sizes is None:
        return x.shape[0], w.shape[0]
    return min(sum(group_sizes), x.shape[0]), sum(1 for g in group_sizes if g > 0)


def cost(x: torch.Tensor, w: torch.Tensor,
         group_sizes: Optional[Sequence[int]] = None) -> Tuple[float, float]:
    """(flops, bytes) of one forward (rows and experts as ``_routed``): 2
    flops per routed row and product; the routed rows of x, the hit
    experts' weights, the output and the group sizes moved once."""
    (T, D), (E, _, F) = x.shape, w.shape
    rows, hit = _routed(x, w, group_sizes)
    return 2.0 * rows * D * F, x.element_size() * (rows * D + hit * D * F + T * F) + 4 * E


def backward_cost(x: torch.Tensor, w: torch.Tensor,
                  group_sizes: Optional[Sequence[int]] = None) -> Tuple[float, float]:
    """(flops, bytes) of one backward (dx and dw, 2 flops per routed row
    and product each): x's routed rows, dy and the hit experts' weights
    read, dx and every expert's dw written once."""
    (T, D), (E, _, F) = x.shape, w.shape
    rows, hit = _routed(x, w, group_sizes)
    return 4.0 * rows * D * F, x.element_size() * (
        rows * D + T * F + hit * D * F + T * D + E * D * F) + 4 * E


class _Counted:
    """A CPU call under an op counter (``_cost.CountedCall``)."""

    name = "moe_grouped_gemm"

    def cost(self, x, w, gs):
        return cost(x, w)

    def backward_cost(self, x, w, gs):
        return backward_cost(x, w)

    def run(self, x, w, gs):
        return (moe_grouped_gemm_plain(x, w, gs),), ()

    def empty(self, x, w, gs):
        return (x.new_empty((x.shape[0], w.shape[2])),), ()

    def grad(self, inputs, saved, grads):
        return (*moe_grouped_gemm_backward_plain(*inputs, grads[0]), None)


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    for name, t in (("w", w), ("group_sizes", group_sizes)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x {x.dtype}")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"group_sizes must be int32 or int64, got {group_sizes.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         "[T, D] and [E, D, F]")
    if tuple(group_sizes.shape) != (w.shape[0],):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} does not match "
                         f"{w.shape[0]} experts")


@_cost.reports("moe_grouped_gemm", lambda x, w, *_, **__: cost(x, w))
def _launch(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    T, D = x.shape
    E, _, F = w.shape
    if F % VEC != 0:
        raise ValueError(f"F = {F} is not a multiple of {VEC}")
    if not w.is_contiguous() or w.data_ptr() % 16 != 0:
        raise ValueError("w must be contiguous and 16-byte aligned")
    if x.stride(1) != 1:
        raise ValueError("the last dimension of x must be contiguous")
    r = route(x.dtype, T, E)
    if r == "wgmma" and (x.data_ptr() % 16 or (x.stride(0) * x.element_size()) % 16):
        raise ValueError(f"x is not 16-byte aligned for the wgmma route (address "
                         f"{x.data_ptr()}, row stride {x.stride(0)})")
    gs = group_sizes.to(torch.int32).contiguous()
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    sl, n_sl = stream_split(D) if r == "stream" else (0, 0)
    scratch = (torch.empty(stream_scratch_floats(T, F, n_sl), dtype=torch.float32,
                           device=x.device) if r == "stream" else None)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_moe_gemm(
            x.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr(),
            x.stride(0), T, D, F, E, _DTYPES[x.dtype], _ROUTE_CODES[r], sl, n_sl,
            scratch.data_ptr() if scratch is not None else None, stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_gemm kernel launch failed ({r} route): error {err}")
    moe_grouped_gemm.launches += 1
    moe_grouped_gemm.launches_by_route[r] += 1
    return out


def moe_grouped_gemm(x: torch.Tensor, w: torch.Tensor,
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """``ragged_dot(x, w, group_sizes)``: x [T, D] sorted by expert, w [E,
    D, F], group_sizes [E] (int32 or int64, ``sum <= T``) -> [T, F] in
    x's dtype, rows past the sum zero.  x and w float32 or bfloat16.  CPU
    tensors take the plain version; CUDA tensors launch the kernel of
    ``route`` (F a multiple of 8, w contiguous), without reading the group
    sizes on the host.  Under an op counter a CPU call is counted at ``cost``
    and its backward at ``backward_cost`` (``_cost``)."""
    _check(x, w, group_sizes)
    if x.device.type == "cpu":
        if _cost.counting():
            return _cost.counted(_Counted(), x, w, group_sizes)
        return moe_grouped_gemm_plain(x, w, group_sizes)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            _check_backward(x)
            return _GroupedGemm.apply(x, w, group_sizes)
        return _launch(x, w, group_sizes)
    raise ValueError(f"no moe_grouped_gemm kernel for device {x.device}")


def _check_backward(x: torch.Tensor) -> None:
    """Refuse, before the forward, a call whose gradient the backward
    kernels do not compute."""
    if x.shape[1] % VEC != 0:
        raise NotImplementedError(
            f"moe_grouped_gemm's backward kernels take D a multiple of {VEC}; got "
            f"D = {x.shape[1]}")


@_cost.reports("moe_grouped_gemm backward", lambda x, w, *_, **__: backward_cost(x, w))
def _launch_backward(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                     dy: torch.Tensor, want_dx: bool,
                     want_dw: bool) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    T, D = x.shape
    E, _, F = w.shape
    # the kernels read x, dy and w in 16-byte pieces of dense rows
    x, dy = (t.contiguous() for t in (x, dy))
    x, dy = (t.clone() if t.data_ptr() % 16 else t for t in (x, dy))
    gs = group_sizes.to(torch.int32).contiguous()
    dx = torch.empty((T, D), dtype=x.dtype, device=x.device) if want_dx else None
    dw = torch.empty((E, D, F), dtype=w.dtype, device=w.device) if want_dw else None
    lib = _backward_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_moe_gemm_bwd(
            x.data_ptr(), w.data_ptr(), gs.data_ptr(), dy.data_ptr(),
            dx.data_ptr() if dx is not None else None,
            dw.data_ptr() if dw is not None else None,
            T, D, F, E, _DTYPES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_gemm backward launch failed "
                           f"({backward_route(x.dtype)} route): error {err}")
    moe_grouped_gemm.backward_launches += 1
    moe_grouped_gemm.backward_launches_by_route[backward_route(x.dtype)] += 1
    return dx, dw


class _GroupedGemm(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        out = _launch(x, w, group_sizes)
        ctx.save_for_backward(x, w, group_sizes)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, gs = ctx.saved_tensors
        dx, dw = _launch_backward(x, w, gs, dy, *ctx.needs_input_grad[:2])
        return dx, dw, None


moe_grouped_gemm.launches = 0  # type: ignore[attr-defined]
moe_grouped_gemm.launches_by_route = dict.fromkeys(ROUTES, 0)  # type: ignore[attr-defined]
moe_grouped_gemm.backward_launches = 0  # type: ignore[attr-defined]
moe_grouped_gemm.backward_launches_by_route = dict.fromkeys(BWD_ROUTES, 0)  # type: ignore[attr-defined]
