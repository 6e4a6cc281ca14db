"""The port's SSD scan against the JAX package's, and its CUDA kernel.

  * ``ssd_scan_plain`` (the kernel's plain version, which the wrapper runs
    on CPU tensors) against the exact recurrence
    ``repro.kernels.ref.ssd_ref`` at the sweep shapes of
    ``tests/test_kernels.py`` (fp32 within 5e-4, bf16 within 5e-2, its
    tolerances), and against the Pallas kernel
    ``repro.kernels.ssd_scan.ssd_scan`` in interpret mode at one small
    shape (fp32 within 1e-5 of the output's largest magnitude: the outputs
    reach ~40, and torch and XLA sum the chunk's products in other
    orders);
  * ``ssd_scan_plain`` against the reference's ``models.ssm.ssd_chunked``
    (the port's counterpart of it), final state included, from a zero
    and from a given starting state (the same relative 1e-5);
  * B and C in groups: [B, S, G, ds] views read by head h as group
    h // (H / G) equal the same groups repeated over the heads;
  * the wrapper's checks (S a multiple of the chunk, dtypes, shapes) and
    no route for a tensor on neither the CPU nor a card;
  * the host's route choice (``"mma"``: bf16 on the tensor cores;
    ``"fma"``: fp32 and the shapes the tiles do not take), the tiled
    kernels' shared memory and the mma route's scratch sizes;
  * marked ``cuda``: the kernel against its plain version on a card, at
    the sweep shapes, the smoke config's chunk of 32, grouped strided
    views and mamba2-1.3b's chunk of 256; the mma route at every head dim
    and chunks of 32, 64 and 256, d_state 16 to 256, S of one chunk and
    grouped strided views, giving the same bits on two runs; fp32 on the
    FMA route.  They skip without a card; run them there with
    ``python -m pytest -m cuda tests/test_torch_ssd.py``.
  * gradients: CPU inputs that need a gradient take the plain version,
    which autograd differentiates, equal to ``jax.grad`` of
    ``ssd_chunked``; the plain backward ``ssd_scan_backward_plain``
    against autograd through the plain version (fp32 within 1e-5 of each
    gradient's largest magnitude) and against ``jax.grad`` of
    ``ssd_chunked`` (1e-4), for S of one chunk and of several, B and C
    shared by all heads and in groups (G < H); the backward's route
    choice, shared memory, head slices and scratch sizes; marked
    ``cuda``: the backward kernels against the plain backward (fp32
    within 1e-4, bf16 within 2e-2 of each gradient's largest magnitude;
    the same bits on two runs) on both routes, the wgmma route with up to
    112 heads to a group and a last head slice shorter than the others,
    mamba2's strong decay on both routes in bf16, and a call whose
    gradient the kernels do not compute refused before the forward's
    launch.

JAX is imported only by the tests that compare with it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan import (
    HEAD_DIMS, MAX_STATE, SM_COUNT, backward_head_slice, backward_route,
    backward_scratch_sizes, backward_smem_bytes, mma_smem_bytes, route, scratch_sizes,
    ssd_scan, ssd_scan_backward_plain, ssd_scan_plain)

TOL = {"float32": 5e-4, "bfloat16": 5e-2}
SWEEP = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64)]  # b, s, h, hd, ds, chunk


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref
    from repro.kernels import ssd_scan as pallas
    from repro.models import ssm

    return jax.numpy, ref.ssd_ref, pallas.ssd_scan, ssm.ssd_chunked


def _inputs(seed, b, s, h, hd, ds):
    """x, dt (after softplus), A < 0 (as the sweep draws them), and B, C
    [b, s, ds]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((b, s, ds)).astype(np.float32)
    Cm = rng.standard_normal((b, s, ds)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _torch(arrays, dtype, device="cpu"):
    x, dt, A, Bm, Cm = (torch.from_numpy(a).to(device) for a in arrays)
    dt_ = getattr(torch, dtype)
    return x.to(dt_), dt, A, Bm.to(dt_), Cm.to(dt_)


def _heads(m, h):
    """B or C [b, s, ds] repeated to [b, s, h, ds]."""
    return np.repeat(m[:, :, None, :], h, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_matches_reference(jx, shape, dtype):
    jnp, ref, _, _ = jx
    b, s, h, hd, ds, chunk = shape
    x, dt, A, Bm, Cm = _inputs(1, b, s, h, hd, ds)
    want = np.asarray(ref(jnp.asarray(x).astype(dtype), jnp.asarray(dt),
                          jnp.asarray(A), jnp.asarray(_heads(Bm, h)).astype(dtype),
                          jnp.asarray(_heads(Cm, h)).astype(dtype))
                      .astype(jnp.float32))
    before = ssd_scan.launches
    got = ssd_scan(*_torch((x, dt, A, Bm, Cm), dtype), chunk=chunk)
    assert ssd_scan.launches == before  # the CPU takes the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, hd)
    assert np.abs(got.float().numpy() - want).max() < TOL[dtype]


def test_plain_matches_pallas(jx):
    jnp, _, pallas, _ = jx
    b, s, h, hd, ds, chunk = 2, 64, 2, 16, 16, 16
    x, dt, A, Bm, Cm = _inputs(2, b, s, h, hd, ds)
    want = np.asarray(pallas(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)),
                             chunk=chunk, interpret=True))
    got = ssd_scan(*_torch((x, dt, A, Bm, Cm), "float32"), chunk=chunk)
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(jx, with_h0):
    jnp, _, _, ref_chunked = jx
    b, s, h, hd, ds, chunk = 2, 96, 3, 16, 8, 32
    x, dt, A, Bm, Cm = _inputs(3, b, s, h, hd, ds)
    Bh, Ch = _heads(Bm, h), _heads(Cm, h)
    h0 = (np.random.default_rng(4).standard_normal((b, h, hd, ds)).astype(np.float32)
          if with_h0 else None)
    y_r, hf_r = ref_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bh, Ch)), chunk,
                            None if h0 is None else jnp.asarray(h0))
    y, hf = ssd_scan_plain(*(torch.from_numpy(a) for a in (x, dt, A, Bh, Ch)),
                           chunk=chunk, h0=None if h0 is None else torch.from_numpy(h0))
    y_r, hf_r = np.asarray(y_r), np.asarray(hf_r)
    assert np.abs(y.numpy() - y_r).max() < 1e-5 * np.abs(y_r).max()
    assert hf.dtype == torch.float32 and hf.shape == (b, h, hd, ds)
    assert np.abs(hf.numpy() - hf_r).max() < 1e-5 * np.abs(hf_r).max()


def test_grouped_bc_equal_repeated_heads():
    """G = 2 groups over 4 heads, as strided views of one wider tensor:
    head h reads group h // 2."""
    b, s, h, hd, ds = 2, 64, 4, 16, 8
    x, dt, A, _, _ = _inputs(5, b, s, h, hd, ds)
    wide = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, s, 3 * 2 * ds)).astype(np.float32))
    Bg = wide[:, :, : 2 * ds].view(b, s, 2, ds)
    Cg = wide[:, :, 2 * ds: 4 * ds].view(b, s, 2, ds)
    xt, dtt, At = (torch.from_numpy(a) for a in (x, dt, A))
    got = ssd_scan(xt, dtt, At, Bg, Cg, chunk=16)
    want = ssd_scan(xt, dtt, At, Bg.repeat_interleave(2, 2), Cg.repeat_interleave(2, 2),
                    chunk=16)
    assert torch.equal(got, want)


def test_wrapper_validates_inputs():
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(7, 1, 48, 2, 16, 8))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(x, dt, A, Bm, Cm, chunk=32)  # 48 % 32 != 0
    assert ssd_scan(x, dt, A, Bm, Cm, chunk=64).shape == x.shape  # q = min(64, 48)
    with pytest.raises(TypeError, match="x must be"):
        ssd_scan(x.double(), dt, A, Bm.double(), Cm.double())
    with pytest.raises(TypeError, match="dt and A"):
        ssd_scan(x, dt.double(), A, Bm, Cm)
    with pytest.raises(TypeError, match="x's"):
        ssd_scan(x, dt, A, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="do not match"):
        ssd_scan(x, dt[:, :, :1], A, Bm, Cm)
    with pytest.raises(ValueError, match="group"):
        ssd_scan(x, dt, A, Bm[:, :, None].expand(1, 48, 3, 8), Cm[:, :, None].expand(1, 48, 3, 8))
    with pytest.raises(ValueError, match="no ssd_scan kernel"):
        ssd_scan(*(t.detach().to("meta") for t in (x, dt, A, Bm, Cm)))


@pytest.mark.parametrize("dtype,hd,ds,q,aligned,want", [
    ("bfloat16", 64, 128, 256, True, "mma"),  # mamba2-1.3b's prefill
    ("bfloat16", 16, 16, 32, True, "mma"),
    ("bfloat16", 128, 256, 256, True, "mma"),  # the largest tiles
    ("float32", 64, 128, 256, True, "fma"),  # fp32 keeps its 1e-4 checks
    ("bfloat16", 128, 24, 40, True, "fma"),  # d_state and chunk off the k16 steps
    ("bfloat16", 64, 128, 40, True, "fma"),
    ("bfloat16", 64, 24, 64, True, "fma"),
    ("bfloat16", 128, 256, 512, True, "fma"),  # chunk states past a block's memory
    ("bfloat16", 64, 128, 256, False, "fma"),  # rows not 16-byte aligned
])
def test_route_by_dtype_and_shape(dtype, hd, ds, q, aligned, want):
    assert route(getattr(torch, dtype), hd, ds, q, aligned) == want


def test_mma_smem_and_scratch_sizes():
    # every head dim and d_state up to MAX_STATE at chunk 256 fits a block
    for hd in HEAD_DIMS:
        assert max(mma_smem_bytes(hd, MAX_STATE, 256)) <= 232_448
    # mamba2-1.3b's prefill: the chunk states' x and B rows; the C and B
    # tiles of C B^T; the outputs' C tile and state (which the C B^T and x
    # tiles reuse)
    assert mma_smem_bytes(64, 128, 256) == (
        8 * 256 + 2 * 256 * 72 + 2 * 256 * 136, 4 * 64 * 136, 8 * 256 + 2 * 128 * 136)
    # [4, 64, 8, 64, 128] chunk states in fp32 (~67 MB) and in bf16,
    # [4, 64, 8, 256] segs and [4, 1, 8, 256, 256] C B^T in fp32
    states, hstates, segs, cb = scratch_sizes(4, 2048, 64, 1, 64, 128, 256)
    assert (states, hstates) == (4 * 64 * 8 * 64 * 128,) * 2
    assert (segs, cb) == (4 * 64 * 8 * 256, 4 * 8 * 256 * 256)
    assert 4 * states == 67_108_864
    # C B^T once per group, not per head
    assert scratch_sizes(2, 128, 6, 3, 32, 16, 64)[3] == 2 * 3 * 2 * 64 * 64


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP + [(2, 96, 4, 16, 16, 32), (1, 512, 2, 64, 128, 256),
                                           (1, 40, 2, 128, 24, 40)])
def test_kernel_matches_plain(cuda, shape, dtype):
    b, s, h, hd, ds, chunk = shape
    args = _torch(_inputs(8, b, s, h, hd, ds), dtype, cuda)
    before = ssd_scan.launches
    got = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want = ssd_scan_plain(*args, chunk=chunk)[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel_err(got, want) < (1e-4 if dtype == "float32" else 2e-2)


@pytest.mark.cuda
def test_kernel_reads_grouped_strided_views(cuda):
    """B and C as [B, S, G, ds] views of one wider projection, G = 2."""
    b, s, h, hd, ds = 2, 128, 4, 32, 16
    x, dt, A, _, _ = _torch(_inputs(9, b, s, h, hd, ds), "float32", cuda)
    wide = torch.randn(b, s, 5 * ds, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    Bg = wide[:, :, ds: 3 * ds].view(b, s, 2, ds)
    Cg = wide[:, :, 3 * ds: 5 * ds].view(b, s, 2, ds)
    got = ssd_scan(x, dt, A, Bg, Cg, chunk=32)
    want = ssd_scan_plain(x, dt, A, Bg, Cg, chunk=32)[0]
    assert _rel_err(got, want) < 1e-4


def _routed(args, chunk, want_route):
    """The wrapper's output, checked to launch once on ``want_route``."""
    before = dict(ssd_scan.launches_by_route)
    got = ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    moved = {r: ssd_scan.launches_by_route[r] - before[r] for r in before}
    assert moved == {r: int(r == want_route) for r in before}
    return got


# (b, s, h, hd, ds, chunk): every head dim at chunks of 32, 64 and 256
# (several chunks each), d_state 16 to 256, and S of one chunk
MMA_SHAPES = (
    [(2, 2 * q, 3, hd, 64, q) for hd in HEAD_DIMS for q in (32, 64, 256)]
    + [(1, 512, 2, 64, ds, 256) for ds in (16, 64, 128, 256)]
    + [(2, 256, 2, 128, 256, 256), (3, 64, 2, 32, 32, 64)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MMA_SHAPES)
def test_mma_route_matches_plain(cuda, shape):
    """The bf16 tensor-core route against the plain version, within 2e-2
    of the largest output, and the same bits on two runs."""
    b, s, h, hd, ds, chunk = shape
    args = _torch(_inputs(10, b, s, h, hd, ds), "bfloat16", cuda)
    got = _routed(args, chunk, "mma")
    want = ssd_scan_plain(*args, chunk=chunk)[0]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_err(got, want) < 2e-2
    assert torch.equal(got, ssd_scan(*args, chunk=chunk))


@pytest.mark.cuda
def test_mma_route_reads_grouped_strided_views(cuda):
    """B and C as [B, S, G, ds] views of one wider bf16 projection, G = 2
    over 4 heads, and x a view of it too."""
    b, s, h, hd, ds = 2, 256, 4, 32, 64
    _, dt, A, _, _ = _torch(_inputs(11, b, s, h, hd, ds), "bfloat16", cuda)
    wide = torch.randn(b, s, h * hd + 4 * ds, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(1)).bfloat16()
    x = wide[..., : h * hd].view(b, s, h, hd)
    Bg = wide[..., h * hd: h * hd + 2 * ds].view(b, s, 2, ds)
    Cg = wide[..., h * hd + 2 * ds:].view(b, s, 2, ds)
    got = _routed((x, dt, A, Bg, Cg), 64, "mma")
    want = ssd_scan_plain(x, dt, A, Bg, Cg, chunk=64)[0]
    assert _rel_err(got, want) < 2e-2
    assert torch.equal(got, ssd_scan(x, dt, A, Bg.repeat_interleave(2, 2),
                                     Cg.repeat_interleave(2, 2), chunk=64))


@pytest.mark.cuda
def test_fp32_stays_on_the_fma_route(cuda):
    b, s, h, hd, ds, chunk = 1, 512, 2, 64, 128, 256
    args = _torch(_inputs(12, b, s, h, hd, ds), "float32", cuda)
    got = _routed(args, chunk, "fma")
    assert _rel_err(got, ssd_scan_plain(*args, chunk=chunk)[0]) < 1e-4


@pytest.mark.parametrize("shape", SWEEP)
def test_cpu_gradients_match_jax_grad(jx, shape):
    """CPU inputs that need a gradient get autograd through the plain
    version, equal to ``jax.grad`` of the reference's ``ssd_chunked`` (the
    XLA path the reference trains through), B and C's gradients summed
    over the heads they are broadcast to."""
    import jax

    jnp, _, _, ref_chunked = jx
    b, s, h, hd, ds, chunk = shape
    arrays = _inputs(11, b, s, h, hd, ds)
    r = np.random.default_rng(12).standard_normal((b, s, h, hd)).astype(np.float32)

    def loss(x, dt, A, Bm, Cm):
        Bh, Ch = (jnp.broadcast_to(m[:, :, None], (b, s, h, ds)) for m in (Bm, Cm))
        return (ref_chunked(x, dt, A, Bh, Ch, chunk)[0] * r).sum()

    want = jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    before = ssd_scan.launches
    y = ssd_scan(ts[0], ts[1], ts[2], ts[3][:, :, None], ts[4][:, :, None], chunk=chunk)
    (y * torch.from_numpy(r)).sum().backward()
    assert ssd_scan.launches == before
    for name, t, w_ in zip(("x", "dt", "A", "B", "C"), ts, want):
        w_ = np.asarray(w_)
        assert np.abs(t.grad.numpy() - w_).max() <= 1e-4 * max(np.abs(w_).max(), 1.0), name


# (b, s, h, hd, ds, chunk, groups): the backward's cases; groups 0 passes
# B and C as [b, s, ds], shared by every head
BWD_CASES = [
    (2, 128, 4, 32, 16, 32, 0),  # several chunks, shared B and C
    (1, 64, 2, 16, 32, 64, 1),  # S of one chunk, one group
    (2, 96, 4, 16, 16, 32, 2),  # three chunks, two groups of two heads
    (1, 64, 6, 16, 16, 16, 3),  # four chunks of 16, three groups
]


def _bwd_inputs(seed, b, s, h, hd, ds, groups):
    """The scan's inputs with B and C [b, s, groups, ds] (or [b, s, ds]),
    and an output gradient."""
    x, dt, A, Bm, Cm = _inputs(seed, b, s, h, hd, ds)
    if groups:
        rng = np.random.default_rng(seed + 1)
        Bm = rng.standard_normal((b, s, groups, ds)).astype(np.float32)
        Cm = rng.standard_normal((b, s, groups, ds)).astype(np.float32)
    dy = np.random.default_rng(seed + 2).standard_normal((b, s, h, hd)).astype(np.float32)
    return (x, dt, A, Bm, Cm), dy


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_backward_matches_autograd_and_jax_grad(jx, case):
    """``ssd_scan_backward_plain`` against autograd through the plain
    forward (1e-5 of each gradient's largest magnitude) and against
    ``jax.grad`` of the reference's ``ssd_chunked`` (1e-4), B and C's
    gradients summed over the heads of their group."""
    import jax

    jnp, _, _, ref_chunked = jx
    b, s, h, hd, ds, chunk, groups = case
    arrays, dy = _bwd_inputs(13, b, s, h, hd, ds, groups)
    ts = [torch.from_numpy(a) for a in arrays]
    got = ssd_scan_backward_plain(*ts, torch.from_numpy(dy), chunk=chunk)
    for g, t in zip(got, ts):
        assert g.shape == t.shape and g.dtype == t.dtype
    leaves = [t.clone().requires_grad_(True) for t in ts]
    auto = torch.autograd.grad(ssd_scan_plain(*leaves, chunk=chunk)[0], leaves,
                               torch.from_numpy(dy))
    rep = h // max(groups, 1)

    def loss(x, dt, A, Bm, Cm):
        Bg, Cg = (m[:, :, None] if m.ndim == 3 else m for m in (Bm, Cm))
        Bh, Ch = (jnp.repeat(m, rep, axis=2) for m in (Bg, Cg))
        return (ref_chunked(x, dt, A, Bh, Ch, chunk)[0] * dy).sum()

    want = jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(a) for a in arrays))
    for name, g, a, j in zip(("x", "dt", "A", "B", "C"), got, auto, want):
        j = np.asarray(j)
        scale = max(np.abs(j).max(), 1.0)
        assert np.abs(g.numpy() - a.numpy()).max() <= 1e-5 * scale, name
        assert np.abs(g.numpy() - j).max() <= 1e-4 * scale, name


def test_plain_sums_in_fp64_for_fp64_inputs():
    """fp64 inputs take the plain forward in fp64 (the CPU reference of
    the card's fp32 training checks): y and the final state in fp64,
    equal to the fp32 sums within their rounding."""
    b, s, h, hd, ds, chunk, groups = BWD_CASES[2]
    arrays, _ = _bwd_inputs(15, b, s, h, hd, ds, groups)
    ts = [torch.from_numpy(a) for a in arrays]
    y64, h64 = ssd_scan_plain(*(t.double() for t in ts), chunk=chunk)
    y32, h32 = ssd_scan_plain(*ts, chunk=chunk)
    assert y64.dtype == h64.dtype == torch.float64
    assert _rel_err(y32, y64) < 1e-5 and _rel_err(h32, h64) < 1e-5


@pytest.mark.parametrize("dtype,hd,ds,q,aligned,want", [
    ("bfloat16", 64, 128, 256, True, "wgmma"),  # mamba2-1.3b
    ("bfloat16", 64, 64, 256, True, "wgmma"),  # zamba2
    ("bfloat16", 64, 128, 64, True, "wgmma"),  # one tile a chunk
    ("bfloat16", 64, 64, 128, True, "wgmma"),
    ("bfloat16", 16, 16, 32, True, "fma"),
    ("bfloat16", 32, 64, 64, True, "fma"),  # hd below a TMA box's 64 columns
    ("bfloat16", 64, 32, 256, True, "fma"),  # d_state not 64 or 128
    ("bfloat16", 64, 128, 48, True, "fma"),  # chunk not a multiple of 64
    ("bfloat16", 64, 128, 512, True, "fma"),  # chunk past the wgmma route's 256
    ("bfloat16", 128, 128, 256, True, "fma"),  # hd past a TMA box's 64 columns
    ("bfloat16", 64, 256, 256, True, "fma"),  # d_state past two 64-column halves
    ("bfloat16", 64, 24, 256, True, "fma"),  # d_state not a multiple of 16
    ("bfloat16", 64, 128, 40, True, "fma"),  # chunk not a multiple of 16
    ("bfloat16", 64, 128, 256, False, "fma"),  # unaligned rows
    ("float32", 64, 128, 256, True, "fma"),
])
def test_backward_route_by_dtype_and_shape(dtype, hd, ds, q, aligned, want):
    assert backward_route(getattr(torch, dtype), hd, ds, q, aligned) == want


def test_backward_smem_fits_every_forward_shape():
    """The FMA route's tiles fit a block at every head dim and d_state
    the forward takes (chunks up to 256), and the wgmma route's at every
    shape it takes, its key and query kernels being its largest
    (mamba2-1.3b's: 16 KB of B_j, 64 KB of C tiles, 64 KB of C B^T tiles,
    two 24 KB head stages, a 24 KB ring, seg and dt, mbarriers, 1 KB of
    alignment)."""
    for hd in HEAD_DIMS:
        for ds in (16, 64, 128, MAX_STATE):
            assert backward_smem_bytes(hd, ds, 256, "fma") <= 232_448
    assert backward_smem_bytes(64, 128, 256, "fma") == (
        8 * 256 + 4 * (3 * 32 * 128 + 3 * 32 * 64 + 4 * 32 * 32 + 2 * 32) + 8 * 32)
    for ds in (64, 128):
        for q in (64, 128, 192, 256):
            assert backward_smem_bytes(64, ds, q, "wgmma") <= 232_448
    assert backward_smem_bytes(64, 128, 256, "wgmma") == (
        1024 + 16384 + 4 * 16384 + 4 * 16384 + 2 * (8192 + 16384) + 3 * 8192 + 16 * 256 + 88)


@pytest.mark.parametrize("b,s,h,g,q,want", [
    (4, 2048, 64, 1, 256, 13),  # mamba2-1.3b: 5 slices, the last of 12 heads
    (4, 2048, 112, 1, 256, 23),  # zamba2: 5 slices, the last of 20 heads
    (1, 256, 64, 1, 256, 8),  # a small grid: at least 8 heads a slice
    (1, 256, 4, 1, 256, 4),  # fewer heads than 8: one slice
    (2, 512, 12, 3, 64, 4),  # groups of 4 heads
])
def test_backward_head_slice(b, s, h, g, q, want):
    """The wgmma route's head slices: ~4 blocks an SM (``SM_COUNT``) over
    (tile, slice, group, chunk, batch row), at least 8 heads a slice."""
    hs = backward_head_slice(b, s, h, g, q)
    assert hs == want
    rep, units = h // g, (q // 64) * (s // q) * g * b
    slices = -(-rep // hs)
    assert slices * hs >= rep and (slices - 1) * hs < rep
    if hs > min(rep, 8):
        assert units * (slices - 1) < 4 * SM_COUNT  # no more slices than the aim needs


def test_backward_scratch_sizes_drop_the_per_head_sums():
    """At mamba2-1.3b's training shape the wgmma route keeps no per-head
    [B, S, H, ds] fp32 dB and dC: its head slices' sums are 5/64 of them
    (5 slices of [B, S, G, ds], at most 1/8), and C B^T is once a (batch
    row, group, chunk), 8.4 MB in each of two fragment orders."""
    b, s, h, g, hd, ds, q = 4, 2048, 64, 1, 64, 128, 256
    old = backward_scratch_sizes(b, s, h, g, hd, ds, q, "fma")
    new = backward_scratch_sizes(b, s, h, g, hd, ds, q, "wgmma")
    per_head = 2 * b * s * h * ds
    assert old["part"] == per_head
    assert new["part"] == 2 * 5 * b * s * g * ds and 8 * new["part"] <= per_head
    assert new["cb"] == b * g * (s // q) * 2 * 16 * 64 * 64
    assert 4 * new["cb"] // 2 == 8_388_608  # bytes an order
    assert new["hb"] == new["gb"] == new["hst"] == b * h * (s // q) * hd * ds
    assert new["gst"] == 0 and new["gh"] == b * h * (s // q)  # G_c in bf16 alone
    assert new["dts"] == new["segs"]
    # one slice (4 heads): no slices' scratch at all
    assert backward_scratch_sizes(2, 512, 4, 1, 64, 128, 256, "wgmma")["part"] == 0

    def nbytes(n):
        size = dict(aux=8, dA_part=8, gh=8, hb=2, gb=2)
        return sum(size.get(k, 4) * v for k, v in n.items())

    # the whole scratch: ~0.5 GB less than the per-head route's
    assert nbytes(old) - nbytes(new) > 450e6


def test_backward_refusal_before_the_forward():
    """The check that runs before the forward on a card refuses a d_state
    past the kernels' and passes mamba2-1.3b's shape."""
    from repro_torch.kernels.ssd_scan import _check_backward

    with pytest.raises(NotImplementedError, match="d_state"):
        _check_backward(torch.zeros(1, 64, 2, 64), torch.zeros(1, 64, MAX_STATE + 16), 64)
    _check_backward(torch.zeros(1, 512, 2, 64), torch.zeros(1, 512, 1, 128), 256)


def _plain_backward(args, dy, chunk):
    """The plain backward on the same inputs; for fp32 inputs in fp64 (the
    exact gradient's stand-in: d(seg)'s reverse sums and dA cancel, so two
    fp32 orders of summing differ by ~1e-4 of dA's largest entry)."""
    if args[0].dtype == torch.float32:
        args, dy = [t.double() for t in args], dy.double()
    return ssd_scan_backward_plain(*args, dy, chunk=chunk)


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda):
    """On a card a call that needs a gradient runs the forward kernels
    inside the autograd Function and the backward kernels in its backward
    (one backward launch), equal to the plain backward; a d_state the
    backward does not take is refused before the forward launches."""
    x, dt, A, Bm, Cm = _torch(_inputs(3, 1, 64, 2, 64, 16), "float32", cuda)
    Bm, Cm = Bm[:, :, None], Cm[:, :, None]
    before = (ssd_scan.launches, ssd_scan.backward_launches)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    y = ssd_scan(*leaves, chunk=32)
    dy = torch.randn_like(y)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (ssd_scan.launches, ssd_scan.backward_launches) == (before[0] + 1, before[1] + 1)
    want = _plain_backward((x, dt, A, Bm, Cm), dy, 32)
    for leaf, w in zip(leaves, want):
        assert _rel_err(leaf.grad, w) < 1e-4
    wide = torch.zeros(1, 64, 1, MAX_STATE + 16, device=cuda)
    with pytest.raises(NotImplementedError, match="d_state"):
        ssd_scan(x.requires_grad_(True), dt, A, wide, wide, chunk=32)
    assert ssd_scan.launches == before[0] + 1


# the card's backward cases in both dtypes, then the largest tiles in
# bf16 alone (the forward's FMA route does not fit them in fp32)
BWD_CARD_CASES = [(c, dtype) for dtype in ("float32", "bfloat16") for c in BWD_CASES + [
    (2, 512, 4, 64, 128, 256, 1),  # mamba2-1.3b's head dim, d_state and chunk
    (1, 512, 4, 64, 64, 256, 1),  # zamba2's
    (2, 128, 4, 32, 64, 64, 2),  # grouped, several chunks
    (1, 96, 2, 64, 128, 48, 1),  # a chunk of three 16-row steps: partial 64-row tiles
]] + [((1, 256, 2, 128, 256, 256, 1), "bfloat16")] + [  # the backward's FMA route in bf16
    # the wgmma route with many heads to a group (slices of 8 heads)
    ((1, 256, 64, 64, 128, 256, 1), "bfloat16"),  # mamba2's hd, d_state, chunk: 64 heads
    ((1, 256, 112, 64, 64, 256, 1), "bfloat16"),  # zamba2's: 112 heads
    ((1, 256, 60, 64, 128, 256, 1), "bfloat16"),  # 60 heads: the last slice has 4
    ((2, 512, 40, 64, 64, 128, 2), "bfloat16"),  # two groups of 20 heads, chunks of 128
    ((1, 384, 12, 64, 128, 64, 3), "bfloat16"),  # three groups of 4, chunks of one tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", BWD_CARD_CASES)
def test_backward_kernel_matches_plain(cuda, case, dtype):
    """The backward kernels (through autograd) against the plain backward
    (fp32 against it in fp64, bf16 against it in fp32), fp32 within 1e-4
    and bf16 within 2e-2 of each gradient's largest magnitude, the same
    bits on two runs, on the route ``backward_route`` names."""
    b, s, h, hd, ds, chunk, groups = case
    arrays, dy = _bwd_inputs(14, b, s, h, hd, ds, groups)
    x, dt, A, Bm, Cm = _torch(arrays, dtype, cuda)
    dyt = torch.from_numpy(dy).to(cuda, x.dtype)
    want_route = backward_route(x.dtype, hd, ds, min(chunk, s))

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
        torch.autograd.backward(ssd_scan(*leaves, chunk=chunk), dyt)
        return [t.grad for t in leaves]

    before = dict(ssd_scan.backward_launches_by_route)
    got, again = run(), run()
    torch.cuda.synchronize()
    moved = {r: ssd_scan.backward_launches_by_route[r] - before[r] for r in before}
    assert moved == {r: 2 * int(r == want_route) for r in before}
    want = _plain_backward((x, dt, A, Bm, Cm), dyt, chunk)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for name, a, a2, w, t in zip(("x", "dt", "A", "B", "C"), got, again, want,
                                 (x, dt, A, Bm, Cm)):
        assert a.dtype == t.dtype and a.shape == w.shape, name
        assert torch.equal(a, a2), name
        assert _rel_err(a, w) < tol, (name, _rel_err(a, w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    (1, 1024, 16, 64, 128, 256, 1),  # the wgmma route
    (2, 256, 4, 32, 64, 64, 2),  # the fma route
])
def test_backward_kernel_strong_decay(cuda, case):
    """mamba2's decay, A = -linspace(1, 16, H) (seg falls to ~-3000 over a
    chunk of 256): the bf16 backward against the plain backward within
    2e-2 of each gradient's largest magnitude, dA among them (its sum of
    d(A dt) cancels heavily, so an imprecise exp(seg_i - seg_j) shows
    there first)."""
    b, s, h, hd, ds, chunk, groups = case
    arrays, dy = _bwd_inputs(16, b, s, h, hd, ds, groups)
    arrays = (arrays[0], arrays[1], -np.linspace(1.0, 16.0, h).astype(np.float32), *arrays[3:])
    x, dt, A, Bm, Cm = _torch(arrays, "bfloat16", cuda)
    dyt = torch.from_numpy(dy).to(cuda, x.dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, Cm)]
    torch.autograd.backward(ssd_scan(*leaves, chunk=chunk), dyt)
    want = _plain_backward((x, dt, A, Bm, Cm), dyt, chunk)
    for name, leaf, w in zip(("x", "dt", "A", "B", "C"), leaves, want):
        assert _rel_err(leaf.grad, w) < 2e-2, (name, _rel_err(leaf.grad, w))
