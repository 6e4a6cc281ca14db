"""GraphSAGE's masked neighbour mean: a CUDA kernel and its plain version.

For each output row m, the mean of ``x[idx[m, j]]`` over the j with
``idx[m, j] >= 0``, accumulated in fp32 and returned in ``x.dtype``; a row
whose ids are all padding (-1) gives 0.  ``sage_aggregate`` is the port
of the JAX package's Pallas kernel
``repro.kernels.sage_aggregate.sage_aggregate`` (with ``ops``' row padding,
which the CUDA kernel does not need):

  * on CUDA tensors it launches ``csrc/sage_aggregate.cu`` (one warp per
    output row, lanes striding over F), built with ``nvcc`` for ``sm_90a``
    into ``build/`` at first use and loaded with ``ctypes``;
  * on CPU tensors it runs ``sage_aggregate_plain``, which walks
    j = 0..K-1 in order, adding the row or nothing, and divides by
    ``max(count, 1)``: the kernel's order of operations, so in fp32 the
    two are equal bit for bit.

There is no fallback between the two: a CUDA tensor launches the kernel
or raises.  Each launch adds one to ``sage_aggregate.launches``.

It is differentiable in ``x``: the backward scatters ``grad_out / count``
into each valid id's row with ``index_add_`` in fp32 (the JAX package
trains through the reference gather, so it has no backward kernel).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sage_aggregate.cu"
# dtype codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bytes per wide (vector) access of the kernel
_WIDE_BYTES = 16

_LIB: Optional[ctypes.CDLL] = None


def build() -> Tuple[Path, float, str]:
    """Compile the kernel if its library is missing; returns
    ``(library path, build seconds, compiler output)``."""
    return _build.build(SOURCE)[0]


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.repro_sage_aggregate.argtypes = [vp] * 3 + [ci] * 5 + [vp]
        lib.repro_sage_aggregate.restype = ci
        _LIB = lib
    return _LIB


def sage_aggregate_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The same function as the kernel, written out plainly, for tensors
    on any device: x [N, F], idx [M, K] (-1 = padding) -> [M, F]."""
    M, K = idx.shape
    acc = torch.zeros((M, x.shape[1]), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((M, 1), dtype=torch.float32, device=x.device)
    for j in range(K):
        col = idx[:, j].long()
        valid = (col >= 0)[:, None]
        rows = x[col.clamp(min=0)].float()
        acc = torch.where(valid, acc + rows, acc)
        cnt = cnt + valid
    return (acc / cnt.clamp(min=1.0)).to(x.dtype)


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.device != idx.device:
        raise ValueError(f"idx is on {idx.device}, x on {x.device}")
    for name, t in (("x", x), ("idx", idx)):
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be torch.int32, got {idx.dtype}")
    if max(idx.shape[0], idx.shape[1], x.shape[1]) >= 2**31:
        raise ValueError("dimensions too large for the kernel's int32 sizes")


def _launch(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The kernel's forward on a CUDA tensor (no autograd)."""
    M, K = idx.shape
    F = x.shape[1]
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    per_access = _WIDE_BYTES // x.element_size()
    wide = (
        F % per_access == 0
        and x.data_ptr() % _WIDE_BYTES == 0
        and out.data_ptr() % _WIDE_BYTES == 0
    )
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_sage_aggregate(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), M, K, F,
            _DTYPES[x.dtype], int(wide), stream,
        )
    if err != 0:
        raise RuntimeError(f"sage_aggregate kernel launch failed: CUDA error {err}")
    sage_aggregate.launches += 1
    return out


class _SageAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            out = sage_aggregate_plain(x, idx)
        elif x.device.type == "cuda":
            out = _launch(x, idx)
        else:
            raise ValueError(f"no sage_aggregate kernel for device {x.device}")
        if ctx.needs_input_grad[0]:
            # the counts the backward divides by
            ctx.save_for_backward(idx, (idx >= 0).sum(1))
            ctx.n_rows = x.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        idx, cnt = ctx.saved_tensors
        K = idx.shape[1]
        g = grad_out.float() / cnt.clamp(min=1)[:, None].float()
        flat = idx.reshape(-1).long()
        pos = torch.nonzero(flat >= 0).squeeze(1)
        grad_x = torch.zeros(
            (ctx.n_rows, grad_out.shape[1]), dtype=torch.float32,
            device=grad_out.device,
        )
        grad_x.index_add_(0, flat[pos], g[pos // K])
        return grad_x.to(grad_out.dtype), None


def sage_aggregate(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Masked neighbour mean.

    x [N, F] float32 or bfloat16, idx [M, K] int32 with ids in [0, N) or
    -1 for padding -> [M, F] in x's dtype, fp32 accumulation; any M.
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Differentiable in x."""
    _check(x, idx)
    return _SageAggregate.apply(x, idx)


sage_aggregate.launches = 0  # type: ignore[attr-defined]
