"""The sequential waterfill rate pass: a CUDA kernel and its plain version.

The fifo/mrtf rate rule visits flows in priority order and gives each the
min of its two NICs' remaining capacity — a sequential scan within an
instance, independent across the batch (instances never share NICs).
``waterfill_fill`` is the port of the JAX package's Pallas kernel
``repro.kernels.waterfill.waterfill_fill``:

  * on CUDA tensors it launches ``csrc/waterfill.cu`` (one warp per
    instance: the lanes gather each tile of ``TILE`` steps' flow ids off
    the chain, one lane walks the chain with the fp64 remainders in
    shared memory; ``launch_plan`` picks the warps a block and where the
    grants go), built with ``nvcc`` for ``sm_90a`` into ``build/`` at
    first use and loaded with ``ctypes``;
  * on CPU tensors it runs ``waterfill_fill_plain``, a plain loop over
    each instance's priority order, equal bit for bit to the JAX engine's
    ``fori_loop`` path.

There is no fallback between the two: a CUDA tensor launches the kernel
or raises.  Each launch adds one to ``waterfill_fill.launches``.
``chain_probe`` times the kernel's dependent chain alone on a card (its
chain bound); it is not a launch of the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import _build, _cost

# grants at or below EPS are dropped; equal to repro_torch.core.engine.EPS
# (kept here so the kernels package imports nothing of core)
EPS = 1e-9

SOURCE = Path(__file__).resolve().parent / "csrc" / "waterfill.cu"
# a block may use up to 227 KB of shared memory on Hopper
_MAX_SMEM_BYTES = 232_448
# the kernel's constants (csrc/waterfill.cu; checked when it is loaded):
# steps gathered per tile, instances (warps) per block at most
TILE = 512
MAX_WARPS = 4
# machine ids are packed in 16 bits each
_MAX_M = 32_767
# the chain probe's modes: the kernel's chain, the plain shared-memory
# read-min-write step, one NIC a lane read with __shfl_sync (M <= 32)
PROBE_MODES = {"kernel": 0, "shared": 1, "shuffle": 2}

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
        lib.repro_waterfill_fill.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        lib.repro_waterfill_fill.restype = ci
        lib.repro_waterfill_chain_probe.argtypes = [ci] * 4 + [vp, vp]
        lib.repro_waterfill_chain_probe.restype = ci
        lib.repro_waterfill_warp_bytes.argtypes = [ci, ci, ci]
        lib.repro_waterfill_warp_bytes.restype = ctypes.c_longlong
        for name in ("repro_waterfill_tile", "repro_waterfill_max_warps"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ci
        consts = (lib.repro_waterfill_tile(), lib.repro_waterfill_max_warps(),
                  lib.repro_waterfill_warp_bytes(1400, 16, 1))
        if consts != (TILE, MAX_WARPS, warp_bytes(1400, 16, True)):
            raise RuntimeError(f"waterfill.cu's constants {consts} differ from the "
                               f"wrapper's {(TILE, MAX_WARPS, warp_bytes(1400, 16, True))}")
        _LIB = lib
    return _LIB


def tile_count(eg: int) -> int:
    """Tiles of ``TILE`` steps the kernel gathers for an instance of
    ``eg`` flows."""
    return -(-eg // TILE)


def warp_bytes(eg: int, m: int, row: bool) -> int:
    """Shared memory of one instance (warp): its tile of packed steps
    (8 bytes each), its 2 M fp64 remainders and, with ``row``, its EG fp64
    grants; rounded up to 16 bytes (``warp_bytes`` of the source)."""
    b = TILE * 8 + 16 * m + (8 * eg if row else 0)
    return -(-b // 16) * 16


def launch_plan(eg: int, m: int) -> Tuple[int, bool]:
    """``(warps a block, grants in a shared row)`` for EG flows over M
    machines: the most warps (up to ``MAX_WARPS``) whose shared memory
    fits a block with the grant row, else the most without it (the
    grants then go straight to device memory).  Raises when one warp's
    remainders and tile do not fit."""
    if m > _MAX_M:
        raise ValueError(f"M={m} machines: the kernel packs machine ids in 16 bits")
    for row in (True, False):
        for warps in range(MAX_WARPS, 0, -1):
            if warps * warp_bytes(eg, m, row) <= _MAX_SMEM_BYTES:
                return warps, row
    raise ValueError(
        f"M={m} machines need {warp_bytes(eg, m, False)} bytes of shared memory "
        f"per instance, more than the {_MAX_SMEM_BYTES} a Hopper block can use"
    )


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
        if _cost.counting():
            with _cost.kernel("waterfill_fill", *cost(order, src, dst, elig, cap_in, cap_out)):
                return waterfill_fill_plain(order, src, dst, elig, cap_in, cap_out)
        return waterfill_fill_plain(order, src, dst, elig, cap_in, cap_out)
    if order.device.type != "cuda":
        raise ValueError(f"no waterfill kernel for device {order.device}")
    return _launch(order, src, dst, elig, cap_in, cap_out)


def cost(*tensors: torch.Tensor) -> Tuple[float, float]:
    """(flops, bytes) of one call: a pass over the flows, the inputs read
    and the rates (float64) written once; no products."""
    return 0.0, float(sum(t.numel() * t.element_size() for t in tensors)
                      + 8 * tensors[0].numel())


@_cost.reports("waterfill_fill", cost)
def _launch(order: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, elig: torch.Tensor,
            cap_in: torch.Tensor, cap_out: torch.Tensor) -> torch.Tensor:
    B, EG = order.shape
    M = cap_in.shape[1]
    out = torch.empty((B, EG), dtype=torch.float64, device=order.device)
    if B == 0 or EG == 0:
        return out
    warps, row = launch_plan(EG, M)
    lib = _library()
    with torch.cuda.device(order.device):
        stream = torch.cuda.current_stream(order.device).cuda_stream
        err = lib.repro_waterfill_fill(
            order.data_ptr(), src.data_ptr(), dst.data_ptr(), elig.data_ptr(),
            cap_in.data_ptr(), cap_out.data_ptr(), out.data_ptr(),
            B, EG, M, warps, int(row), stream,
        )
    if err != 0:
        raise RuntimeError(f"waterfill kernel launch failed: CUDA error {err}")
    waterfill_fill.launches += 1
    return out


waterfill_fill.launches = 0  # type: ignore[attr-defined]


def chain_probe(steps: int, m: int, mode: str = "kernel", reps: int = 200,
                device: str = "cuda") -> Tuple[float, float]:
    """The dependent chain of ``steps`` waterfill steps over ``m`` NICs,
    timed alone on the card (one warp, ids already in shared memory, no
    gather, no output; ``PROBE_MODES`` names the forms): ``(ms for one
    chain of steps, clock cycles per step)``, from CUDA events around one
    launch that runs the chain ``reps`` times, and from the SM's clock.
    With mode ``"kernel"`` it is the kernel's chain bound."""
    if mode not in PROBE_MODES:
        raise ValueError(f"no probe mode {mode!r} (modes {sorted(PROBE_MODES)})")
    if torch.device(device).type != "cuda":
        raise ValueError("the chain probe runs on a CUDA card only")
    lib = _library()
    out = torch.zeros(2, dtype=torch.float64, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream

        def launch():
            err = lib.repro_waterfill_chain_probe(steps, m, reps, PROBE_MODES[mode],
                                                  out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"waterfill chain probe failed: CUDA error {err}")

        launch()  # warm-up
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        launch()
        t1.record()
        torch.cuda.synchronize(out.device)
    return t0.elapsed_time(t1) / reps, out[1].item() / (reps * steps)
