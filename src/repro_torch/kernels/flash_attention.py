"""Attention forward: a CUDA kernel and its plain version.

``flash_attention(q, k, v, causal=, window=, softcap=, scale=, q_offset=)``
is the port of the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention`` and of its wrapper
``repro.kernels.ops.flash_attention``: q [B, H, Sq, D], k and v [B, KV,
Sk, D] with ``H % KV == 0`` -> [B, H, Sq, D] in q's dtype, where query
head h reads KV head ``h // (H // KV)`` (the grouping of
``repro.models.layers._attend``).  The TPU kernel takes K and V already
repeated to H heads; this function of grouped heads equals it applied to
``k.repeat_interleave(H // KV, 1)``.

  * on CUDA tensors it launches one of the three kernels of
    ``csrc/flash_attention.cu``, built with ``nvcc`` for ``sm_90a`` into
    ``build/`` at first use and loaded with ``ctypes``; ``route(dtype, Sq,
    D)`` chooses it on the host before the launch: ``"wgmma"`` (bf16
    prefill, D 64 to 128, on the tensor cores), ``"decode"`` (Sq
    == 1: the keys split over blocks, ``decode_plan``) or ``"fma"`` (every
    other call: a tiled fp32 FMA kernel).  The tensors are read through
    their strides, so views of the model's [B, S, N, D] projections and
    of the [B, Smax, KV, D] cache are neither copied nor transposed (the
    wgmma kernel loads them with TMA and the decode kernel in 16-byte
    vectors, both of which need 16-byte aligned addresses and strides);
  * on CPU tensors it runs ``flash_attention_plain``, the oracle
    ``repro.kernels.ref.flash_attention_ref`` written out in torch: fp32
    scores, masked entries set to -1e30, a softmax, and weights rounded
    to v's dtype before the product with v.

There is no fallback between the routes: a CUDA tensor launches the
kernel of its route or raises.  Each launch adds one to
``flash_attention.launches`` and to its route's count in
``flash_attention.launches_by_route`` (a decode over several chunks is
one launch of the wrapper: the kernel and its merge).  Every route also
writes each row's logsumexp when asked (``return_lse``: the decode over
a cache whose positions are split over ranks merges the ranks' (o, lse)
pairs, ``models.layers.merge_attention_parts``).  Under an op
counter (``launch.op_cost``) a CPU call is counted at ``cost`` and its
backward at ``backward_cost``, the bounds ``chip_smoke.py`` times the
kernels against (``_cost``).

Gradients.  On CPU tensors autograd differentiates the plain version.
On CUDA tensors, when q, k or v requires a gradient (and grad mode is
on), the forward launch above runs inside a ``torch.autograd.Function``
that also has the forward kernel write each row's logsumexp (natural
domain, fp32, [B, H, S rounded up to 64]: ``lse_stride``) and saves q, k,
v, the output and it.  Its backward launches the kernels of
``csrc/flash_attention_bwd.cu`` (built beside the forward's library): one
forms delta = rowsum(dO * O), one accumulates dK and dV a key tile at a
time over the group's query heads, one accumulates dQ a query tile at a
time; ``backward_route(dtype)``: ``"wgmma"`` for bf16 (TMA rings and
wgmma, as the forward), ``"fma"`` for fp32; no atomics, so two runs give
the same bits.  ``flash_attention_backward_plain`` is the same function
written out plainly from (o, lse).  It takes self-attention over a whole
sequence (Sq == Sk > 1, ``q_offset`` 0) with any mask, softcap and
grouping, D in ``WGMMA_HEAD_DIMS``, fp32 or bf16; anything else that
needs a gradient on a card raises before the forward (there is no
fallback).  Each backward adds one to ``flash_attention.backward_launches``
and to its route's count in ``flash_attention.backward_launches_by_route``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, _cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
# dtype codes of the C interface
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 96, 112, 128)
# the kernels of the C interface, by route code
ROUTES = {"fma": 0, "decode": 1, "wgmma": 2}
BWD_ROUTES = ("wgmma", "fma")  # the backward's kernels: bf16, fp32
LSE_ROWS = 64  # the logsumexp's rows of a head are padded to a multiple of this
DECODE_HEAD_DIMS = (64, 80, 96, 112, 128)
WGMMA_HEAD_DIMS = (64, 80, 96, 112, 128)
NEG_INF = -1e30  # the masked score of the TPU kernel and of the oracle
# decode: a query over at most this many keys runs as one chunk (no merge
# pass; the serving ticks' positions), longer ones are cut into chunks of
# at least DECODE_MIN_CHUNK keys (a multiple of DECODE_CHUNK_STEP), as many
# as keep the blocks within DECODE_TARGET_BLOCKS: one wave of the bf16
# kernel on an H100 (2 blocks on each of its 132 SMs)
DECODE_ONE_CHUNK = 256
DECODE_MIN_CHUNK = 128
DECODE_CHUNK_STEP = 64
DECODE_TARGET_BLOCKS = 2 * 132

_LIB: Optional[ctypes.CDLL] = None
_BWD_LIB: Optional[ctypes.CDLL] = None


def build() -> Tuple[Path, float, str]:
    """Compile the kernel if its library is missing; returns
    ``(library path, build seconds, compiler output)``."""
    return _build.build(SOURCE)[0]


def load(path: Path) -> ctypes.CDLL:
    """A built library of the kernel with its C interface declared."""
    lib = ctypes.CDLL(str(path))
    vp, ci, ll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.repro_flash_attention.argtypes = (
        [vp] * 4 + [ll] * 12 + [ci] * 6 + [cf, cf] + [ci] * 9 + [vp, vp, ci, vp]
    )
    lib.repro_flash_attention.restype = ci
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = load(build()[0])
    return _LIB


def load_backward(path: Path) -> ctypes.CDLL:
    """A built library of the backward kernels with its C interface declared."""
    lib = ctypes.CDLL(str(path))
    vp, ci, ll, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.repro_flash_attention_bwd.argtypes = (
        [vp] * 10 + [ci] + [ll] * 24 + [ci] * 5 + [cf, cf] + [ci] * 3 + [vp]
    )
    lib.repro_flash_attention_bwd.restype = ci
    return lib


def _backward_library() -> ctypes.CDLL:
    global _BWD_LIB
    if _BWD_LIB is None:
        _BWD_LIB = load_backward(_build.build(BWD_SOURCE)[0][0])
    return _BWD_LIB


def route(dtype: torch.dtype, sq: int, d: int) -> str:
    """The kernel a CUDA call launches, from q's dtype, Sq and D alone:
    ``"wgmma"`` for bf16 with Sq > 1 and D in ``WGMMA_HEAD_DIMS``,
    ``"decode"`` for Sq == 1 and D in ``DECODE_HEAD_DIMS``, else
    ``"fma"``.  Every D of ``HEAD_DIMS`` that a route's kernel lacks goes to
    the FMA kernel, which takes them all."""
    if sq > 1 and dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return "wgmma"
    if sq == 1 and d in DECODE_HEAD_DIMS:
        return "decode"
    return "fma"


def backward_route(dtype: torch.dtype) -> str:
    """The backward's kernels for q's dtype: ``"wgmma"`` for bf16, ``"fma"``
    for fp32."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def lse_stride(s: int) -> int:
    """The row stride of a head's logsumexp (and delta): S rounded up to
    ``LSE_ROWS``, so that the backward copies a tile's 64 values as one
    aligned piece and never reads past the buffer."""
    return -(-s // LSE_ROWS) * LSE_ROWS


def _misaligned(t: torch.Tensor) -> bool:
    """Whether t's address or an outer stride (of a dimension larger than
    1) is not a multiple of 16 bytes."""
    return bool(t.data_ptr() % 16) or any(
        n > 1 and (st * t.element_size()) % 16
        for st, n in zip(t.stride()[:-1], t.shape[:-1]))


def _check_aligned(r: str, **tensors: torch.Tensor) -> None:
    """TMA (the wgmma routes, forward and backward) and 16-byte vector
    loads (the decode route) read a tensor whose address and outer
    strides are multiples of 16 bytes."""
    for name, t in tensors.items():
        if _misaligned(t):
            raise ValueError(f"{name} is not 16-byte aligned for the {r} route "
                             f"(address {t.data_ptr()}, strides {t.stride()})")


def key_range(sk: int, qa: int, qb: int, causal: bool, window: int) -> Tuple[int, int]:
    """The keys [lo, hi] that query positions [qa, qb] can see, as the
    kernels' ``key_range`` computes them (``window`` 0 = none): every key
    when some row of [qa, qb] sees none, whose output is then the mean of
    v over all keys."""
    lo, hi = 0, sk - 1
    if window > 0 and qb - window + 1 > sk - 1:
        return lo, hi
    if window > 0 and qa - window + 1 > 0:
        lo = qa - window + 1
    if causal and qb < hi:
        hi = qb
    return lo, hi


def decode_plan(b: int, h: int, kv: int, sk: int, pos: int, causal: bool,
                window: int) -> Tuple[int, int, int, int]:
    """The decode kernel's split of the keys of a query at position
    ``pos``: ``(lo, hi, chunk, n_chunks)``, from the shapes and the mask
    alone (no sync).  One chunk when the range holds at most
    ``DECODE_ONE_CHUNK`` keys; else at least 2 chunks, of at least
    ``DECODE_MIN_CHUNK`` keys, and as many as keep the ``b * kv`` (batch
    row, KV head) pairs' blocks within ``DECODE_TARGET_BLOCKS`` (``h`` is
    not read: a block serves all the query heads of its KV head)."""
    lo, hi = key_range(sk, pos, pos, causal, window)
    n_keys = hi - lo + 1
    if n_keys <= DECODE_ONE_CHUNK:
        return lo, hi, n_keys, 1
    n = min(DECODE_TARGET_BLOCKS // (b * kv), n_keys // DECODE_MIN_CHUNK)
    n = max(2, n)
    chunk = -(-n_keys // n)
    chunk = -(-chunk // DECODE_CHUNK_STEP) * DECODE_CHUNK_STEP
    return lo, hi, chunk, -(-n_keys // chunk)


def decode_scratch_floats(b: int, h: int, d: int, n_chunks: int) -> int:
    """fp32 values of the decode kernel's scratch: each (batch, head,
    chunk)'s acc [D], m and l; none for one chunk."""
    return 0 if n_chunks == 1 else b * h * n_chunks * (d + 2)


def causal_mask(sq: int, sk: int, window: Optional[int], offset: int = 0,
                causal: bool = True, device=None) -> torch.Tensor:
    """[Sq, Sk] boolean mask of the keys each query sees: ``offset`` is the
    absolute position of query 0 (for decode, the write position); with
    ``causal`` key j <= query i + offset, with ``window`` also
    j > i + offset - window."""
    iq = torch.arange(sq, device=device)[:, None] + offset
    jk = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m &= jk <= iq
    if window is not None:
        m &= jk > iq - window
    return m


def mask_counts(sq: int, sk: int, causal: bool, window: Optional[int],
                offset: int = 0) -> Tuple[int, int]:
    """(unmasked (query, key) pairs, keys some query sees) of
    ``causal_mask(sq, sk, window, offset, causal)``, counted without
    forming it."""
    i = np.arange(sq, dtype=np.int64) + offset
    hi = np.minimum(sk - 1, i) if causal else np.full(sq, sk - 1, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window is not None else np.zeros(sq, dtype=np.int64)
    n = np.clip(hi - lo + 1, 0, None)
    seen = n > 0
    keys = int(hi[seen].max() - lo[seen].min() + 1) if seen.any() else 0
    return int(n.sum()), keys


def cost(q: torch.Tensor, k: torch.Tensor, causal: bool, window: Optional[int],
         q_offset: int = 0) -> Tuple[float, float]:
    """(flops, bytes) of one forward: 4 D flops per unmasked pair; q and o
    moved once and the K and V positions the queries see read once."""
    B, H, Sq, D = q.shape
    pairs, keys = mask_counts(Sq, k.shape[2], causal, window, q_offset)
    return 4.0 * D * B * H * pairs, q.element_size() * (2 * B * H * Sq * D
                                                          + 2 * B * k.shape[1] * keys * D)


def backward_cost(q: torch.Tensor, k: torch.Tensor, causal: bool,
                  window: Optional[int]) -> Tuple[float, float]:
    """(flops, bytes) of one backward: five products per unmasked pair (10
    D flops); q, k, v, o and dO read and dq, dk, dv written once."""
    B, H, S, D = q.shape
    pairs, _ = mask_counts(S, k.shape[2], causal, window)
    return 10.0 * D * B * H * pairs, q.element_size() * (4 * B * H * S * D
                                                           + 4 * B * k.shape[1] * S * D)


class _Counted:
    """A CPU call under an op counter (``_cost.CountedCall``); with
    ``with_lse`` its outputs are (o, lse)."""

    name = "flash_attention"

    def __init__(self, causal, window, softcap, scale, q_offset, with_lse=False):
        self.mask = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        self.q_offset = q_offset
        self.with_lse = with_lse

    def cost(self, q, k, v):
        return cost(q, k, self.mask["causal"], self.mask["window"], self.q_offset)

    def backward_cost(self, q, k, v):
        return backward_cost(q, k, self.mask["causal"], self.mask["window"])

    def run(self, q, k, v):
        o, lse = flash_attention_plain(q, k, v, q_offset=self.q_offset, return_lse=True,
                                       **self.mask)
        return ((o, lse) if self.with_lse else (o,)), (o, lse)

    def empty(self, q, k, v):
        o = torch.empty_like(q)
        lse = q.new_empty((*q.shape[:2], lse_stride(q.shape[2])), dtype=torch.float32)
        return ((o, lse.narrow(2, 0, q.shape[2])) if self.with_lse else (o,)), (o, lse)

    def grad(self, inputs, saved, grads):
        return flash_attention_backward_plain(*inputs, *saved, grads[0], **self.mask)


def _scores(q, k, causal, window, softcap, scale, q_offset, want_dsdx=False):
    """fp32 scores [B, H, Sq, Sk] over grouped KV heads: scaled, capped,
    masked entries at ``NEG_INF``; the mask; with ``want_dsdx`` the cap's
    d s / d x (None without a softcap)."""
    kr = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    dsdx = None
    if softcap:
        s = torch.tanh(s / softcap)
        if want_dsdx:
            dsdx = 1 - s * s
        s = softcap * s
    mask = causal_mask(q.shape[2], k.shape[2], window, q_offset, causal,
                       device=q.device)
    return torch.where(mask, s, torch.full_like(s, NEG_INF)), mask, dsdx


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    q_offset: int = 0, return_lse: bool = False,
):
    """The same function as the kernel, written out plainly, for tensors
    on any device (the oracle's formula, with grouped KV heads).  With
    ``return_lse`` also each row's logsumexp of its scores (fp32 [B, H,
    Sq], natural domain, masked keys at -1e30): ``(out, lse)``, what the
    forward kernel writes for the backward."""
    scale = scale if scale is not None else q.shape[-1]**-0.5
    s, _, _ = _scores(q, k, causal, window, softcap, scale, q_offset)
    vr = v.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vr.float())
    if return_lse:
        return out.to(q.dtype), torch.logsumexp(s, dim=-1)
    return out.to(q.dtype)


def flash_attention_backward_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
    window: Optional[int] = None, softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function written out plainly, from the
    forward's output ``o`` and logsumexp ``lse`` ([B, H, S], natural
    domain): delta = rowsum(dO * O), P = exp(s - lse) (0 where masked),
    dV = P^T dO (P rounded to v's dtype, as the forward rounds it), dS = P
    (dO v^T - delta) times the softcap's 1 - tanh^2, dQ = scale dS K and
    dK = scale dS^T Q, K's and V's summed over each group of query heads;
    fp32 sums, cast to q's, k's and v's dtypes."""
    scale = scale if scale is not None else q.shape[-1]**-0.5
    b, h, sq, d = q.shape
    kv, g = k.shape[1], h // k.shape[1]
    s, mask, dsdx = _scores(q, k, causal, window, softcap, scale, 0, want_dsdx=True)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), torch.zeros_like(s))
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    vr = v.repeat_interleave(g, dim=1).float()
    ds = p * (dof @ vr.transpose(-1, -2) - delta)
    if dsdx is not None:
        ds = ds * dsdx
    dv = p.to(v.dtype).float().transpose(-1, -2) @ dof
    dk = ds.transpose(-1, -2) @ q.float() * scale
    dq = ds @ k.repeat_interleave(g, dim=1).float() * scale
    sk = k.shape[2]
    dk = dk.reshape(b, kv, g, sk, d).sum(2)
    dv = dv.reshape(b, kv, g, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], softcap: Optional[float], q_offset: int) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0 or H % k.shape[1] != 0:
        raise ValueError(f"{H} query heads do not group over {k.shape[1]} KV heads")
    if k.shape[2] == 0:
        raise ValueError("no keys")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and softcap < 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


@_cost.reports("flash_attention", lambda q, k, v, causal, window, softcap, scale, q_offset,
               *_, **__: cost(q, k, causal, window, q_offset))
def _launch(q, k, v, causal, window, softcap, scale, q_offset, want_lse=False):
    """The forward launch: o, or (o, lse) with ``want_lse`` (each row's
    logsumexp, which every route writes: [B, H, lse_stride(Sq)] of which
    the first Sq rows of a head are written).  On fake tensors (a dry run
    on card tensors) the outputs are empty tensors of these shapes and
    nothing is launched or counted."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dimension {D} not in the kernel's {HEAD_DIMS}")
    if max(q.stride(3), k.stride(3), v.stride(3)) != 1:
        raise ValueError("the head dimension of q, k and v must be contiguous")
    if max(Sq, Sk) + q_offset >= 2**31:
        raise ValueError("positions too large for the kernel's int32 indices")
    r = route(q.dtype, Sq, D)
    fake = _cost.is_fake(q)
    if r in ("wgmma", "decode") and not fake:
        _check_aligned(r, q=q, k=k, v=v)
    # the output in q's memory layout (a [B, S, H, D] view stays one)
    o = torch.empty_like(q)
    if o.stride(3) != 1:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # a window that reaches past key 0 from the last query masks nothing
    win = window if window is not None and window <= Sq + q_offset else 0
    lo, hi, chunk, n_chunks = (decode_plan(B, H, KV, Sk, q_offset, causal, win)
                               if r == "decode" else (0, 0, 0, 1))
    n_scratch = decode_scratch_floats(B, H, D, n_chunks)
    scratch = (torch.empty(n_scratch, dtype=torch.float32, device=q.device)
               if n_scratch else None)
    lse = (torch.empty((B, H, lse_stride(Sq)), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if fake:
        return (o, lse) if want_lse else o
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            B, H, KV, Sq, Sk, D, float(scale), float(softcap or 0.0),
            int(causal), int(win), int(q_offset), _DTYPES[q.dtype], ROUTES[r],
            lo, hi, chunk, n_chunks, scratch.data_ptr() if scratch is not None else None,
            lse.data_ptr() if lse is not None else None, lse_stride(Sq), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({r} route): error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[r] += 1
    return (o, lse) if want_lse else o


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
    softcap: Optional[float] = None, scale: Optional[float] = None,
    q_offset: int = 0, return_lse: bool = False,
):
    """softmax(mask(softcap(scale * q k^T))) v over grouped KV heads.

    q [B, H, Sq, D], k and v [B, KV, Sk, D], float32 or bfloat16, any
    strides with the last dimension contiguous; query position i is
    ``i + q_offset``, key position j is j.  ``scale`` defaults to
    D**-0.5.  CPU tensors take the plain version; CUDA tensors launch
    the kernel of ``route`` (D in ``HEAD_DIMS``).  With ``return_lse``
    (no gradient) also each row's logsumexp, fp32 [B, H, Sq] in the natural
    domain, -1e30 for a row that sees no key: ``(o, lse)``, which a caller
    that splits the keys (a decode over a cache sharded by positions)
    merges."""
    _check(q, k, v, window, softcap, q_offset)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if _cost.counting():
            return _cost.counted(_Counted(causal, window, softcap, scale, q_offset,
                                          with_lse=return_lse), q, k, v)
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset, return_lse=return_lse)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            if return_lse:
                raise NotImplementedError("flash_attention's return_lse takes no gradient")
            _check_backward(q, k, q_offset)
            return _Attention.apply(q, k, v, causal, window, softcap, scale)
        if return_lse:
            o, lse = _launch(q, k, v, causal, window, softcap, scale, q_offset, want_lse=True)
            return o, lse.narrow(2, 0, q.shape[2])
        return _launch(q, k, v, causal, window, softcap, scale, q_offset)
    raise ValueError(f"no flash_attention kernel for device {q.device}")


def _check_backward(q: torch.Tensor, k: torch.Tensor, q_offset: int) -> None:
    """Refuse, before the forward, a call whose gradient the backward
    kernels do not compute."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    if q_offset != 0 or sq != sk or sq < 2 or d not in WGMMA_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention's backward kernel takes self-attention over a whole "
            f"sequence (Sq == Sk > 1, q_offset 0) at D in {WGMMA_HEAD_DIMS}; got "
            f"Sq {sq}, Sk {sk}, q_offset {q_offset}, D {d}")


@_cost.reports("flash_attention backward", lambda q, k, v, o, lse, do, causal, window,
               *_, **__: backward_cost(q, k, causal, window))
def _launch_backward(q, k, v, o, lse, do, causal, window, softcap,
                     scale) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, H, S, D = q.shape
    KV = k.shape[1]
    if do.stride(3) != 1:
        do = do.contiguous()

    def like(t: torch.Tensor) -> torch.Tensor:  # t's layout where it is dense
        g = torch.empty_like(t)
        return g if g.stride(3) == 1 else torch.empty(t.shape, dtype=t.dtype,
                                                      device=t.device)

    r = backward_route(q.dtype)
    if r == "wgmma":  # TMA reads rows in place; delta reads 16-byte pieces of o and dO
        if _misaligned(do):
            do = do.contiguous()
        _check_aligned("backward", q=q, k=k, v=v, o=o, do=do)
    dq, dk, dv = like(q), like(k), like(v)
    if tuple(lse.shape) != (B, H, lse_stride(S)) or not lse.is_contiguous():
        raise ValueError(f"lse {tuple(lse.shape)} is not the forward's [B, H, lse_stride(S)]")
    delta = torch.empty_like(lse)
    win = window if window is not None and window <= S else 0
    lib = _backward_library()
    tensors = (q, k, v, o, do, dq, dk, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            *(t.data_ptr() for t in tensors), lse.data_ptr(), delta.data_ptr(), lse.shape[2],
            *(s for t in tensors for s in t.stride()[:3]),
            B, H, KV, S, D, float(scale), float(softcap or 0.0), int(causal),
            int(win), _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed ({r} route): error {err}")
    flash_attention.backward_launches += 1
    flash_attention.backward_launches_by_route[r] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The forward kernel (writing the logsumexp), with the backward
    kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        o, lse = _launch(q, k, v, causal, window, softcap, scale, 0, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, softcap, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _launch_backward(q, k, v, o, lse, do, *ctx.mask)
        return dq, dk, dv, None, None, None, None


flash_attention.launches = 0  # type: ignore[attr-defined]
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)  # type: ignore[attr-defined]
flash_attention.backward_launches = 0  # type: ignore[attr-defined]
flash_attention.backward_launches_by_route = dict.fromkeys(BWD_ROUTES, 0)  # type: ignore[attr-defined]
