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
four kernels are one launch of the wrapper).  On CPU tensors
autograd differentiates the plain version (the training path's
gradients, held to ``jax.grad`` of the reference's XLA path).  There is
no backward kernel yet (ROADMAP Queue 2 item 9): a CUDA tensor that
requires a gradient is refused.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
# dtype codes of the C interface (x and y; B and C)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
MAX_STATE = 256  # d_state the kernel's shared memory takes
# the kernels of the C interface, by route code
ROUTES = {"fma": 0, "mma": 1}
# query rows of an outputs block of the mma route, key rows of its tiles
MMA_ROWS = 64
_MAX_SMEM_BYTES = 232_448  # a block's shared memory on Hopper

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


def ssd_scan_plain(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, *, chunk: int = 128, h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel, written out plainly, for tensors
    on any device; returns ``(y, h_final)``, the state [B, H, hd, ds] in
    fp32 after the last chunk.  ``h0`` is the state before the first
    chunk (zeros when None)."""
    b, s, h, hd = x.shape
    Bg, Cg = _grouped(Bm), _grouped(Cm)
    rep = h // Bg.shape[2]
    ds = Bg.shape[-1]
    q = chunk_len(s, chunk)
    A = A.float()
    dt = dt.float()
    state = (torch.zeros(b, h, hd, ds, dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    masked = ~torch.tril(torch.ones(q, q, dtype=torch.bool, device=x.device))
    ys = []
    for c0 in range(0, s, q):
        xc = x[:, c0:c0 + q].float()  # [b, q, h, hd]
        dtc = dt[:, c0:c0 + q]  # [b, q, h]
        bc = Bg[:, c0:c0 + q].float().repeat_interleave(rep, dim=2)  # [b, q, h, ds]
        cc = Cg[:, c0:c0 + q].float().repeat_interleave(rep, dim=2)
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


def _check(x, dt, A, Bm, Cm) -> None:
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if t.requires_grad and torch.is_grad_enabled() and t.device.type == "cuda":
            raise NotImplementedError(
                "ssd_scan has no backward kernel yet (ROADMAP Queue 2 item 9)")
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
    launch the kernel (hd in ``HEAD_DIMS``, d_state up to ``MAX_STATE``)."""
    _check(x, dt, A, Bm, Cm)
    q = chunk_len(x.shape[1], chunk)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, Bm, Cm, chunk=q)[0]
    if x.device.type == "cuda":
        return _launch(x, dt, A, Bm, Cm, q)
    raise ValueError(f"no ssd_scan kernel for device {x.device}")


ssd_scan.launches = 0  # type: ignore[attr-defined]
ssd_scan.launches_by_route = dict.fromkeys(ROUTES, 0)  # type: ignore[attr-defined]
