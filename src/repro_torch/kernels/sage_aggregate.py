"""GraphSAGE's masked neighbour mean: CUDA kernels and their plain versions.

For each output row m, the mean of ``x[idx[m, j]]`` over the j with
``idx[m, j] >= 0``, accumulated in fp32 and returned in ``x.dtype``; a row
whose ids are all padding (-1) gives 0.  ``sage_aggregate`` is the port
of the JAX package's Pallas kernel
``repro.kernels.sage_aggregate.sage_aggregate`` (with ``ops``' row padding,
which the CUDA kernel does not need):

  * on CUDA tensors it launches ``csrc/sage_aggregate.cu``, built with
    ``nvcc`` for ``sm_90a`` into ``build/`` at first use and loaded with
    ``ctypes``: a persistent grid of blocks whose threads each gather one
    vector of one output row, with the widest access the row allows
    (``forward_plan`` picks it and the tile on the host);
  * on CPU tensors it runs ``sage_aggregate_plain``, which walks
    j = 0..K-1 in order, adding the row or nothing, and divides by
    ``max(count, 1)``: the kernel's order of operations, so in fp32 the
    two are equal bit for bit.

It is differentiable in ``x``.  The backward,
``grad_x[r] = sum of grad_out[m] / max(count_m, 1)`` over the flat
positions ``m * K + j`` with ``idx[m, j] == r`` in ascending order, runs
``sage_aggregate_backward_plain`` (``index_add_``) on CPU tensors and the
file's backward kernels on CUDA tensors: a transposed CSR of ``idx``
built on the card (counts, their scan, the positions grouped by row),
then each row's positions put in ascending order and summed in it, so the card's fp32 gradient equals the CPU's bit for bit,
with no host sync (the JAX package trains through the reference gather,
so it has no backward kernel).

There is no fallback: a CUDA tensor launches the kernels or raises.  Each
forward launch adds one to ``sage_aggregate.launches``; each backward on
the card (its four kernels) adds one to
``sage_aggregate.backward_launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sage_aggregate.cu"
# dtype codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256  # threads of a block (csrc: kThreads)
# bwd_long's shared memory: a two-stage ring of rows (at most 1024
# columns), and a bitmap of the flat positions when it fits
LONG_RING_BYTES = 96 * 1024
LONG_BITMAP_BYTES = 100 * 1024

_LIB: Optional[ctypes.CDLL] = None
_VP, _CI = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/sage_aggregate.cu: pointers (and the stream) as
# void*, sizes and flags as int, byte counts as long long
SIGNATURES = {
    "repro_sage_aggregate": [_VP] * 3 + [_CI] * 9 + [_VP],
    "repro_sage_bwd_prep": [_VP] * 4 + [_CI] * 4 + [_VP],
    "repro_sage_bwd_fill": [_VP] * 4 + [_CI, _VP],
    "repro_sage_bwd_long": [_VP] * 4 + [_CI] * 7 + [_VP],
    "repro_sage_bwd_sum": [_VP] * 4 + [_CI] * 4 + [_VP],
}


class Plan(NamedTuple):
    """The forward's launch: bytes an access, and a tile of R rows by W
    values (R * W / (values an access) <= THREADS threads)."""
    vec_bytes: int
    W: int
    R: int


def forward_plan(F: int, elt: int, x_ptr: int = 0, out_ptr: int = 0) -> Plan:
    """The access width and tile of a forward with rows of F values of
    ``elt`` bytes, x and out at the addresses given: the widest access
    (16, 8, 4 or 2 bytes) that the row and both pointers allow, a row (or
    a chunk of THREADS accesses) a thread per access, as many rows a tile
    as the block's threads hold."""
    row_bytes = F * elt
    vec = next(v for v in (16, 8, 4, 2)
               if v >= elt and row_bytes % v == 0 and x_ptr % v == 0 and out_ptr % v == 0)
    per = vec // elt
    W = min(F, THREADS * per)
    return Plan(vec, W, THREADS // (W // per))


def build() -> Tuple[Path, float, str]:
    """Compile the kernels if their library is missing; returns
    ``(library path, build seconds, compiler output)``."""
    return _build.build(SOURCE)[0]


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
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


def sage_aggregate_backward_plain(grad_out: torch.Tensor, idx: torch.Tensor,
                                  n_rows: int) -> torch.Tensor:
    """The gradient in x, written out plainly: grad_out [M, F], idx [M, K]
    -> fp32 [n_rows, F], each valid (m, j) adding grad_out[m] / max(count_m,
    1) to row idx[m, j] with ``index_add_`` in ascending flat position
    (the CPU's order; on a card its atomics add in any order)."""
    K = idx.shape[1]
    cnt = (idx >= 0).sum(1)
    g = grad_out.float() / cnt.clamp(min=1)[:, None].float()
    flat = idx.reshape(-1).long()
    pos = torch.nonzero(flat >= 0).squeeze(1)
    grad_x = torch.zeros((n_rows, grad_out.shape[1]), dtype=torch.float32,
                         device=grad_out.device)
    grad_x.index_add_(0, flat[pos], g[pos // K])
    return grad_x


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dim() != 2:
        raise ValueError(f"idx must be 2-D, got {tuple(idx.shape)}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be torch.int32, got {idx.dtype}")
    if idx.numel() >= 2**31:
        raise ValueError("idx too large for the kernels' int32 positions")


def _check(x: torch.Tensor, idx: torch.Tensor) -> None:
    if x.device != idx.device:
        raise ValueError(f"idx is on {idx.device}, x on {x.device}")
    _check_idx(idx)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if max(x.shape[0], x.shape[1]) >= 2**31:
        raise ValueError("dimensions too large for the kernel's int32 sizes")


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"sage_aggregate {what} launch failed: CUDA error {err}")


def _launch(x: torch.Tensor, idx: torch.Tensor, probe: bool = False) -> torch.Tensor:
    """The kernel's forward on a CUDA tensor (no autograd); ``probe``
    issues the loads alone and returns the unwritten output (the gather
    probe; its launch is not counted)."""
    M, K = idx.shape
    N, F = x.shape
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = forward_plan(F, x.element_size(), x.data_ptr(), out.data_ptr())
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_sage_aggregate(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), N, M, K, F, _DTYPES[x.dtype],
            plan.vec_bytes, plan.W, plan.R, int(probe), stream,
        )
    _raise(err, "forward")
    if not probe:
        sage_aggregate.launches += 1
    return out


def gather_probe(x: torch.Tensor, idx: torch.Tensor) -> None:
    """The forward's loads alone: every valid id's row gathered once, as
    the kernel gathers it, with no adds and no stores (CUDA tensors)."""
    _check(x, idx)
    _launch(x, idx, probe=True)


def _vec(F: int, *tensors: torch.Tensor) -> int:
    """fp32 values an access: 4 where F and every pointer allow 16 bytes."""
    return next(v for v in (4, 2, 1)
                if F % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors))


def long_plan(F: int, MK: int) -> Tuple[int, bool]:
    """bwd_long's ring depth D (rows a stage) and whether the flat
    positions' bitmap fits in its shared memory, for rows of F values and
    MK flat positions."""
    window = min(F, 1024)
    D = max(1, min(128, LONG_RING_BYTES // (2 * window * 4)))
    return D, -(-MK // 32) * 4 <= LONG_BITMAP_BYTES


def _backward_launch(grad_out: torch.Tensor, idx: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """The backward's kernels on a CUDA tensor: fp32 [n_rows, F]."""
    M, K = idx.shape
    F = grad_out.shape[1]
    dev = grad_out.device
    go = grad_out.float().contiguous()
    count = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    g = torch.empty((M, F), dtype=torch.float32, device=dev)
    grad_x = torch.empty((n_rows, F), dtype=torch.float32, device=dev)
    pos = torch.empty(M * K, dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise(lib.repro_sage_bwd_prep(go.data_ptr(), idx.data_ptr(), count.data_ptr(),
                                       g.data_ptr(), M, K, F, _vec(F, go, g), stream),
               "backward prep")
        # the CSR's row ends: an integer scan of the counts
        incl = torch.cumsum(count, 0, dtype=torch.int32)
        _raise(lib.repro_sage_bwd_fill(idx.data_ptr(), incl.data_ptr(), count.data_ptr(),
                                       pos.data_ptr(), M * K, stream), "backward fill")
        D, bitmap = long_plan(F, M * K)
        _raise(lib.repro_sage_bwd_long(g.data_ptr(), incl.data_ptr(), pos.data_ptr(),
                                       grad_x.data_ptr(), n_rows, F, K, M * K, D, int(bitmap),
                                       4 if _vec(F, g) == 4 else 1, stream),
               "backward long segments")
        _raise(lib.repro_sage_bwd_sum(g.data_ptr(), incl.data_ptr(), pos.data_ptr(),
                                      grad_x.data_ptr(), n_rows, F, K,
                                      _vec(F, g, grad_x), stream), "backward sum")
    sage_aggregate.backward_launches += 1
    return grad_x


def sage_aggregate_backward(grad_out: torch.Tensor, idx: torch.Tensor,
                            n_rows: int) -> torch.Tensor:
    """The gradient in x of ``sage_aggregate``: fp32 [n_rows, F] from
    grad_out [M, F] and idx [M, K] (int32, C-contiguous, ids in
    [0, n_rows) or -1).  CPU tensors take the plain version; CUDA tensors
    launch the kernels."""
    if grad_out.device != idx.device:
        raise ValueError(f"idx is on {idx.device}, grad_out on {grad_out.device}")
    _check_idx(idx)
    if grad_out.dim() != 2 or grad_out.shape[0] != idx.shape[0]:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} does not match idx "
                         f"{tuple(idx.shape)}")
    if max(n_rows, grad_out.shape[1]) >= 2**31:
        raise ValueError("dimensions too large for the kernels' int32 sizes")
    if grad_out.device.type == "cpu":
        return sage_aggregate_backward_plain(grad_out, idx, n_rows)
    if grad_out.device.type == "cuda":
        return _backward_launch(grad_out, idx, n_rows)
    raise ValueError(f"no sage_aggregate kernel for device {grad_out.device}")


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
            ctx.save_for_backward(idx)
            ctx.n_rows = x.shape[0]
        return out

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        idx, = ctx.saved_tensors
        grad_x = sage_aggregate_backward(grad_out, idx, ctx.n_rows)
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
sage_aggregate.backward_launches = 0  # type: ignore[attr-defined]
