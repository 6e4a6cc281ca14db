"""The sequential waterfill rate pass: a CUDA kernel and its plain version.

The fifo/mrtf rate rule visits flows in priority order and gives each the
min of its two NICs' remaining capacity — a sequential scan within an
instance, independent across the batch (instances never share NICs).
``waterfill_fill`` is the port of the JAX package's Pallas kernel
``repro.kernels.waterfill.waterfill_fill``:

  * on CUDA tensors it launches ``csrc/waterfill.cu`` (one thread per
    instance, fp64 remainders in shared memory), built with ``nvcc`` for
    ``sm_90a`` into ``build/`` at first use and loaded with ``ctypes``;
  * on CPU tensors it runs ``waterfill_fill_plain``, a plain loop over
    each instance's priority order, equal bit for bit to the JAX engine's
    ``fori_loop`` path.

There is no fallback between the two: a CUDA tensor launches the kernel
or raises.  Each launch adds one to ``waterfill_fill.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import _build

# grants at or below EPS are dropped; equal to repro_torch.core.engine.EPS
# (kept here so the kernels package imports nothing of core)
EPS = 1e-9

SOURCE = Path(__file__).resolve().parent / "csrc" / "waterfill.cu"
# a block may use up to 227 KB of shared memory on Hopper
_MAX_SMEM_BYTES = 232_448

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
        lib.repro_waterfill_fill.argtypes = [vp] * 7 + [ci, ci, ci, vp]
        lib.repro_waterfill_fill.restype = ci
        lib.repro_waterfill_threads.argtypes = []
        lib.repro_waterfill_threads.restype = ci
        _LIB = lib
    return _LIB


def waterfill_fill_plain(
    order: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    elig: torch.Tensor,
    cap_in: torch.Tensor,
    cap_out: torch.Tensor,
) -> torch.Tensor:
    """The same function as the kernel, written out plainly, for tensors
    on any device; the result lands on the inputs' device.

    Walks each instance's priority order in Python on the tensors' values,
    as the kernel's thread does and as the reference's numpy
    ``_WaterfillRate.rates`` does: a grant is ``min(rem_in[dst],
    rem_out[src])`` when it exceeds EPS, subtracted from both NICs.  (A
    batched loop of torch ops over the EG positions computes the same
    values, but pays a dozen op dispatches per position, which made the
    CPU engine's fifo and mrtf runs too slow to serve as references.)"""
    rows = zip(
        order.tolist(), src.tolist(), dst.tolist(), elig.tolist(),
        cap_in.to(torch.float64).tolist(), cap_out.to(torch.float64).tolist(),
    )
    out = []
    for o, s, d, e, rem_i, rem_o in rows:
        r = [0.0] * len(o)
        for i in o:
            if not e[i]:
                continue
            a, c = rem_i[d[i]], rem_o[s[i]]
            if a != a or c != c:  # NaN grants nothing, as in the reference
                continue
            give = a if a < c else c
            if give > EPS:
                r[i] = give
                rem_i[d[i]] = a - give
                rem_o[s[i]] = c - give
        out.append(r)
    return torch.tensor(out, dtype=torch.float64).reshape(order.shape).to(order.device)


def _check(
    order: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    elig: torch.Tensor,
    cap_in: torch.Tensor,
    cap_out: torch.Tensor,
) -> None:
    ts = dict(order=order, src=src, dst=dst, elig=elig, cap_in=cap_in,
              cap_out=cap_out)
    dev = order.device
    for name, t in ts.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, order on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
    want = dict(order=torch.int32, src=torch.int32, dst=torch.int32,
                elig=torch.bool, cap_in=torch.float64, cap_out=torch.float64)
    for name, dt in want.items():
        if ts[name].dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {ts[name].dtype}")
    B, EG = order.shape
    M = cap_in.shape[1]
    for name in ("src", "dst", "elig"):
        if tuple(ts[name].shape) != (B, EG):
            raise ValueError(f"{name} must be [{B}, {EG}]")
    for name in ("cap_in", "cap_out"):
        if tuple(ts[name].shape) != (B, M):
            raise ValueError(f"{name} must be [{B}, {M}]")
    if max(B * EG, B * M) >= 2**31:
        raise ValueError("arrays too large for the kernel's int32 offsets")


def waterfill_fill(
    order: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    elig: torch.Tensor,
    cap_in: torch.Tensor,
    cap_out: torch.Tensor,
) -> torch.Tensor:
    """Sequential waterfill rates.

    order/src/dst [B, EG] int32, elig [B, EG] bool, caps [B, M] float64
    -> rates [B, EG] float64.  ``order`` is each instance's priority
    permutation (a stable argsort of the policy's key); machine ids lie
    in [0, M).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _check(order, src, dst, elig, cap_in, cap_out)
    if order.device.type == "cpu":
        return waterfill_fill_plain(order, src, dst, elig, cap_in, cap_out)
    if order.device.type != "cuda":
        raise ValueError(f"no waterfill kernel for device {order.device}")
    B, EG = order.shape
    M = cap_in.shape[1]
    out = torch.empty((B, EG), dtype=torch.float64, device=order.device)
    if B == 0 or EG == 0:
        return out
    lib = _library()
    smem = 2 * M * lib.repro_waterfill_threads() * 8
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"M={M} machines need {smem} bytes of shared memory per block, "
            f"more than the {_MAX_SMEM_BYTES} a Hopper block can use"
        )
    with torch.cuda.device(order.device):
        stream = torch.cuda.current_stream(order.device).cuda_stream
        err = lib.repro_waterfill_fill(
            order.data_ptr(), src.data_ptr(), dst.data_ptr(), elig.data_ptr(),
            cap_in.data_ptr(), cap_out.data_ptr(), out.data_ptr(),
            B, EG, M, stream,
        )
    if err != 0:
        raise RuntimeError(f"waterfill kernel launch failed: CUDA error {err}")
    waterfill_fill.launches += 1
    return out


waterfill_fill.launches = 0  # type: ignore[attr-defined]
