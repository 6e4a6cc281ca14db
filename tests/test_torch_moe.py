"""The port's MoE FFN and grouped GEMM against the JAX package's, and the
grouped GEMM's CUDA kernel.

  * ``moe_grouped_gemm_plain`` (the kernel's plain version, which the
    wrapper runs on CPU tensors) against the oracle
    ``repro.kernels.ref.grouped_gemm_ref`` (``jax.lax.ragged_dot``) at the
    sweep shapes of ``tests/test_kernels.py``, and against the Pallas
    kernel behind ``repro.kernels.ops.moe_grouped_gemm`` in interpret mode
    at one small shape: fp32 within 1e-5, bf16 within 1e-1 (the sweep's
    bf16 tolerance), rows past the sum of the group sizes zero; experts
    with no rows;
  * the router (``_route``) and ``apply_moe`` against the reference's
    ``_route`` and ``apply_moe`` on one device, for top-1 (llama4-smoke)
    and top-2 (kimi-smoke), fp32 within 1e-5 (ids and weights equal);
  * the wrapper's checks and no route for a tensor on neither the CPU nor
    a card; the route a CUDA call takes, by dtype, T and E; the streaming
    route's split of D into slices and its scratch;
  * marked ``cuda``: the kernel against its plain version on a card (fp32
    within 1e-4 of the output's largest magnitude, bf16 within 2e-2) at
    the sweep shapes, a decode-like tile of one row per expert, empty
    experts and rows past the sum; the bf16 wgmma route at ragged shapes
    (segments not aligned to its 128-row tiles, a one-row and an empty
    expert, rows past the sum, D = 72 and F = 136, and a routed T = 8192
    over 16 experts), rows past the sum exactly 0; the streaming (decode)
    route at llama4-scout's and kimi-k2's decode shapes and at ragged
    ones (an empty expert, rows past the sum, an expert of more than 4
    rows, D not a multiple of its slices, F not of its 128 columns), rows
    past the sum exactly 0 and the same bits on two runs; and
    ``apply_moe`` through the kernel against the plain path.  They skip without a card; run them there
    with ``python -m pytest -m cuda tests/test_torch_moe.py``.

  * gradients: CPU inputs that need a gradient take the plain version,
    which autograd differentiates, equal to ``jax.grad`` of the oracle;
    the plain backward ``moe_grouped_gemm_backward_plain`` against
    autograd through the plain version and against ``jax.grad`` of
    ``ragged_dot`` (fp32 within 1e-5 of the largest gradient) with empty
    experts, rows past the sum, T not a multiple of any tile, and D and F
    not multiples of the card's tiles; the backward's route by dtype;
    marked ``cuda``: the backward kernels against the plain backward (fp32
    within 1e-4, bf16 within 2e-2 of the largest gradient; the same bits
    on two runs; bf16 on the "wgmma" route) at the sweep shapes, skewed
    routings, decode-sized T (the forward on its streaming route), ragged
    D and F, an expert of one row starting one row past a box edge and
    40 experts, and a call
    whose gradient the kernels do not compute (D not a multiple of 8)
    refused before the forward's launch.

JAX is imported only by the tests that compare with it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.moe_gemm import (
    STREAM_SLICE,
    moe_grouped_gemm,
    moe_grouped_gemm_backward_plain,
    moe_grouped_gemm_plain,
    route,
    stream_scratch_floats,
    stream_split,
)

TOL = {"float32": 1e-5, "bfloat16": 1e-1}
SWEEP = [(256, 128, 128, 4), (512, 256, 256, 8)]  # t, d, f, e


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.kernels import ops, ref

    return jax, ops.moe_grouped_gemm, ref.grouped_gemm_ref


def _inputs(seed, t, d, f, e, empty=()):
    """x [t, d], w [e, d, f] (scaled 0.1, as the sweep) and group sizes
    summing to ~0.9 t (experts in ``empty`` get none)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * 0.1).astype(np.float32)
    share = rng.dirichlet(np.ones(e))
    share[list(empty)] = 0.0
    gs = np.floor(share / share.sum() * t * 0.9).astype(np.int32)
    return x, w, gs


def _torch(x, w, gs, dtype, device="cpu"):
    dt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(device, dt), torch.from_numpy(w).to(device, dt),
            torch.from_numpy(gs).to(device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_matches_reference(jx, shape, dtype):
    jax, _, ref = jx
    x, w, gs = _inputs(1, *shape, empty=(1,))
    jnp = jax.numpy
    want = np.asarray(ref(jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
                          jnp.asarray(gs)).astype(jnp.float32))
    before = moe_grouped_gemm.launches
    got = moe_grouped_gemm(*_torch(x, w, gs, dtype))
    assert moe_grouped_gemm.launches == before  # the CPU takes the plain version
    assert got.dtype == getattr(torch, dtype) and got.shape == (shape[0], shape[2])
    tot = int(gs.sum())
    assert gs[1] == 0 and tot < shape[0]
    assert np.abs(got[:tot].float().numpy() - want[:tot]).max() < TOL[dtype]
    assert not got[tot:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(jx, dtype):
    jax, ops_gemm, _ = jx
    jnp = jax.numpy
    x, w, gs = _inputs(2, 128, 64, 64, 4, empty=(2,))
    want = np.asarray(ops_gemm(jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype),
                               jnp.asarray(gs), bt=32, bf=64, bk=64)
                      .astype(jnp.float32))
    got = moe_grouped_gemm(*_torch(x, w, gs, dtype)).float().numpy()
    assert np.abs(got - want).max() < TOL[dtype]
    assert not got[int(gs.sum()):].any() and not want[int(gs.sum()):].any()


def _moe_cfgs(arch):
    from repro import configs as ref_configs
    from repro_torch.convert import lm_config_from_reference

    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype="float32")
    return cfg, lm_config_from_reference(cfg)


def _moe_params(jax, cfg, seed):
    from repro.models import moe as ref_moe

    p = ref_moe.init_moe(jax.random.key(seed), cfg, 1, jax.numpy.float32)
    return ({k: v[0] for k, v in p.items()},
            {k: torch.from_numpy(np.array(v[0])) for k, v in p.items()})


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_route_matches_reference(jx, arch):
    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    jax = jx[0]
    cfg, port_cfg = _moe_cfgs(arch)
    p_ref, p = _moe_params(jax, cfg, 3)
    xt = np.random.default_rng(4).standard_normal((40, cfg.d_model)).astype(np.float32)
    ids_r, w_r, probs_r = ref_moe._route(jax.numpy.asarray(xt), p_ref["router"], cfg)
    ids, w, probs = moe._route(torch.from_numpy(xt), p["router"], port_cfg)
    assert ids.shape == (40, cfg.moe.top_k)
    assert np.array_equal(ids.numpy(), np.asarray(ids_r))
    assert np.abs(w.numpy() - np.asarray(w_r)).max() < 1e-6
    assert np.abs(probs.numpy() - np.asarray(probs_r)).max() < 1e-6


def test_route_breaks_ties_to_the_lower_expert():
    """Equal probabilities pick the lower ids first, as lax.top_k does."""
    from repro_torch.models import moe

    _, port_cfg = _moe_cfgs("kimi-k2-1t-a32b")
    router = torch.zeros(port_cfg.d_model, port_cfg.moe.n_experts)
    ids, w, _ = moe._route(torch.ones(3, port_cfg.d_model), router, port_cfg)
    assert ids.tolist() == [[0, 1]] * 3 and torch.allclose(w, torch.full((3, 2), 0.5))


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_apply_moe_matches_reference(jx, arch):
    from repro.models import moe as ref_moe
    from repro.sharding import single_device_ctx
    from repro_torch.models import moe

    jax = jx[0]
    cfg, port_cfg = _moe_cfgs(arch)
    p_ref, p = _moe_params(jax, cfg, 5)
    x = np.random.default_rng(6).standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe.apply_moe(p_ref, jax.numpy.asarray(x), cfg, single_device_ctx())
    before = moe_grouped_gemm.launches
    got, aux = moe.apply_moe(p, torch.from_numpy(x), port_cfg)
    assert moe_grouped_gemm.launches == before
    assert got.shape == x.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    # the load-balance loss, and none when the caller asks for none
    assert abs(aux.item() - float(want_aux)) < 1e-5
    y, none = moe.apply_moe(p, torch.from_numpy(x), port_cfg, aux=False)
    assert none is None and torch.equal(y, got)


def test_empty_experts_and_zero_rows():
    """Experts with no rows are skipped and rows past the sum are zero;
    all rows in one expert, and no rows at all."""
    x, w, _ = _inputs(7, 50, 16, 24, 5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for gs in ([0, 0, 50, 0, 0], [0, 0, 0, 0, 0], [3, 0, 0, 7, 0]):
        g = torch.tensor(gs, dtype=torch.int32)
        got = moe_grouped_gemm(xt, wt, g)
        start = 0
        for e, n in enumerate(gs):
            assert torch.allclose(got[start:start + n], xt[start:start + n] @ wt[e])
            start += n
        assert not got[start:].any()


def test_wrapper_validates_inputs():
    x, w, gs = _torch(*_inputs(8, 32, 16, 24, 3), "float32")
    with pytest.raises(TypeError, match="x must be"):
        moe_grouped_gemm(x.double(), w.double(), gs)
    with pytest.raises(TypeError, match="w is"):
        moe_grouped_gemm(x, w.bfloat16(), gs)
    with pytest.raises(TypeError, match="group_sizes"):
        moe_grouped_gemm(x, w, gs.float())
    with pytest.raises(ValueError, match="experts"):
        moe_grouped_gemm(x, w, gs[:2])
    with pytest.raises(ValueError, match=r"\[T, D\]"):
        moe_grouped_gemm(x[:, :8], w, gs)
    with pytest.raises(ValueError, match="no moe_grouped_gemm kernel"):
        moe_grouped_gemm(*(t.detach().to("meta") for t in (x, w, gs)))


@pytest.mark.parametrize("dtype,t,e,want", [
    ("bfloat16", 8192, 16, "wgmma"), ("bfloat16", 65, 16, "wgmma"),
    ("bfloat16", 64, 16, "stream"), ("bfloat16", 8, 16, "stream"),
    ("float32", 8192, 16, "fma"), ("float32", 8, 16, "stream"),
    ("bfloat16", 64, 384, "stream"), ("bfloat16", 1536, 384, "stream"),
    ("bfloat16", 65536, 384, "wgmma"),
])
def test_route_by_dtype_and_rows(dtype, t, e, want):
    """T <= 4 E (a decode step) streams the weights; above, bf16 takes the
    tensor cores and fp32 the FMA tiles; nothing but the three arguments
    is read."""
    assert route(getattr(torch, dtype), t, e) == want


@pytest.mark.parametrize("d", [72, 128, 256, 1024, 1025, 1100, 2048, 5120, 7168, 8192])
def test_stream_split_covers_d(d):
    """The streaming route's slices of D: the fewest of at most
    STREAM_SLICE rows, each a multiple of 128 rows but the last, covering D
    exactly; the scratch holds every slice's [T, F] partial sums."""
    sl, n = stream_split(d)
    assert sl % 128 == 0 and sl <= max(STREAM_SLICE, 128)
    assert (n - 1) * sl < d <= n * sl
    assert n == -(-d // STREAM_SLICE)
    assert stream_scratch_floats(8, 8192, n) == n * 8 * 8192


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,gs", [
    (SWEEP[0], None), (SWEEP[1], None),
    ((8, 256, 512, 16), [1, 0, 1, 1, 0, 2, 0, 0, 1, 0, 0, 0, 1, 0, 1, 0]),  # decode
    ((300, 72, 136, 6), [0, 130, 0, 0, 101, 0]),  # ragged D and F tiles, zero rows
])
def test_kernel_matches_plain(cuda, shape, gs, dtype):
    x, w, g = _inputs(9, *shape, empty=(0,))
    if gs is not None:
        g = np.array(gs, np.int32)
    args = _torch(x, w, g, dtype, cuda)
    before = moe_grouped_gemm.launches
    got = moe_grouped_gemm(*args)
    torch.cuda.synchronize()
    assert moe_grouped_gemm.launches == before + 1
    want = moe_grouped_gemm_plain(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _rel_err(got, want) < (1e-4 if dtype == "float32" else 2e-2)
    assert not got[int(g.sum()):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_apply_moe_kernel_matches_plain(cuda, arch, monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator(cuda).manual_seed(0)
    shapes, shapes32 = moe.moe_shapes(cfg)
    p = {n: torch.randn(s, device=cuda, generator=gen) * moe.moe_scales(cfg)[n]
         for n, s in {**shapes, **shapes32}.items()}
    x = torch.randn(3, 7, cfg.d_model, device=cuda, generator=gen)
    got, _ = moe.apply_moe(p, x, cfg)
    monkeypatch.setattr(moe, "moe_grouped_gemm", moe_grouped_gemm_plain)
    want, _ = moe.apply_moe(p, x, cfg)
    # top-2 adds a token's two rows with atomics in either order
    assert _rel_err(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape,gs", [
    ((300, 72, 136, 6), [0, 130, 0, 0, 101, 0]),  # D and F not multiples of 64
    ((1000, 200, 264, 5), [129, 0, 1, 383, 250]),  # unaligned segments, rows past the sum
    ((8192, 128, 256, 16), "routed"),  # top-1 routing of 8192 tokens, sum = T
])
def test_wgmma_route_matches_plain(cuda, shape, gs):
    """The bf16 grouped GEMM on the tensor cores against the plain version
    within 2e-2 of the largest output; rows past the sum exactly 0."""
    t, _, _, e = shape
    x, w, g = _inputs(12, *shape)
    if gs == "routed":
        g = np.bincount(np.random.default_rng(13).integers(0, e, t), minlength=e)
    g = np.asarray(g, np.int32)
    args = _torch(x, w, g, "bfloat16", cuda)
    assert route(torch.bfloat16, t, e) == "wgmma"
    before = moe_grouped_gemm.launches_by_route["wgmma"]
    got = moe_grouped_gemm(*args)
    torch.cuda.synchronize()
    assert moe_grouped_gemm.launches_by_route["wgmma"] == before + 1
    want = moe_grouped_gemm_plain(*args)
    assert _rel_err(got, want) < 2e-2
    assert torch.equal(got[int(g.sum()):], torch.zeros_like(got[int(g.sum()):]))


def _card_inputs(cuda, seed, t, d, f, e, dtype):
    """x [t, d] and w [e, d, f] (scaled 1/sqrt(d)) drawn on the card."""
    gen = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(t, d, device=cuda, generator=gen).to(dtype)
    w = torch.randn(e, d, f, device=cuda, generator=gen).mul_(d ** -0.5).to(dtype)
    return x, w


def _topk_sizes(seed, tokens, k, e, empty=()):
    """Group sizes of top-k routing of ``tokens`` tokens over e experts,
    none to the experts in ``empty``."""
    rng = np.random.default_rng(seed)
    pool = np.setdiff1d(np.arange(e), empty)
    hits = np.concatenate([rng.choice(pool, k, replace=False) for _ in range(tokens)])
    return np.bincount(hits, minlength=e).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    "llama4_gate_up", "llama4_down", "kimi_gate_up", "kimi_down",
    "rows_past_sum", "expert_of_6_rows", "ragged_slices_and_columns",
])
def test_stream_route_matches_plain(cuda, case, dtype):
    """The streaming (decode) route against the plain version: fp32 within
    1e-4 and bf16 within 2e-2 of the largest output, rows past the sum
    exactly 0, the same bits on a second run.  llama4-scout's decode: 8
    rows top-1 over 16 experts (expert 0 empty), D 5120 / F 8192 and back;
    kimi-k2's: 8 tokens x top-8 over 384 experts, D 7168 / F 2048 and back."""
    shapes = {  # (t, d, f, e, group sizes)
        "llama4_gate_up": (8, 5120, 8192, 16, _topk_sizes(1, 8, 1, 16, empty=(0,))),
        "llama4_down": (8, 8192, 5120, 16, _topk_sizes(1, 8, 1, 16, empty=(0,))),
        "kimi_gate_up": (64, 7168, 2048, 384, _topk_sizes(2, 8, 8, 384, empty=(0,))),
        "kimi_down": (64, 2048, 7168, 384, _topk_sizes(2, 8, 8, 384, empty=(0,))),
        "rows_past_sum": (16, 1024, 256, 8, np.array([0, 2, 0, 3, 1, 0, 0, 4], np.int32)),
        "expert_of_6_rows": (12, 512, 384, 4, np.array([1, 6, 0, 3], np.int32)),
        "ragged_slices_and_columns": (9, 1100, 136, 5, np.array([2, 0, 1, 4, 1], np.int32)),
    }
    t, d, f, e, gs = shapes[case]
    dt = getattr(torch, dtype)
    x, w = _card_inputs(cuda, 3, t, d, f, e, dt)
    g = torch.from_numpy(gs).to(cuda)
    assert route(dt, t, e) == "stream"
    before = moe_grouped_gemm.launches_by_route["stream"]
    got = moe_grouped_gemm(x, w, g)
    again = moe_grouped_gemm(x, w, g)
    torch.cuda.synchronize()
    assert moe_grouped_gemm.launches_by_route["stream"] == before + 2
    want = moe_grouped_gemm_plain(x, w, g)
    assert got.dtype == dt and got.shape == (t, f)
    assert _rel_err(got, want) < (1e-4 if dtype == "float32" else 2e-2)
    rows = int(gs.sum())
    assert torch.equal(got[rows:], torch.zeros_like(got[rows:]))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", SWEEP)
def test_cpu_gradients_match_jax_grad(jx, shape):
    """CPU inputs that need a gradient get autograd through the plain
    version, equal to ``jax.grad`` of the oracle (``ragged_dot``)."""
    jax, _, ref = jx
    jnp = jax.numpy
    x, w, gs = _inputs(9, *shape, empty=(1,))
    r = np.random.default_rng(10).standard_normal((x.shape[0], w.shape[2])).astype(np.float32)
    want = jax.grad(lambda a, b: (ref(a, b, jnp.asarray(gs)) * r).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt, g = _torch(x, w, gs, "float32")
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    before = moe_grouped_gemm.launches
    (moe_grouped_gemm(xt, wt, g) * torch.from_numpy(r)).sum().backward()
    assert moe_grouped_gemm.launches == before
    for got, w_ in zip((xt.grad, wt.grad), want):
        w_ = np.asarray(w_)
        assert np.abs(got.numpy() - w_).max() <= 1e-5 * max(np.abs(w_).max(), 1.0)


# (t, d, f, e, group sizes): the backward's cases on the CPU; None draws
# the sweep's sizes (~0.9 t, expert 1 empty)
BWD_CASES = [
    (256, 128, 128, 4, None),
    (512, 256, 256, 8, None),
    (77, 24, 40, 5, [30, 0, 0, 41, 2]),  # T a multiple of no tile, two empty experts
    (50, 16, 24, 3, [0, 0, 0]),  # no rows at all: dx and dw zero
    (40, 16, 8, 3, [25, 30, 10]),  # group sizes past T: the segments clamp
    (300, 72, 136, 6, [0, 130, 0, 0, 101, 0]),  # D and F not multiples of the tiles
    (1000, 200, 264, 5, [900, 0, 1, 2, 0]),  # one expert holds most rows, rows past the sum
]


def _bwd_inputs(seed, t, d, f, e, gs):
    x, w, g = _inputs(seed, t, d, f, e, empty=(1,))
    if gs is not None:
        g = np.array(gs, np.int32)
    dy = np.random.default_rng(seed + 1).standard_normal((t, f)).astype(np.float32)
    return x, w, g, dy


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_backward_matches_autograd_and_jax_grad(jx, case):
    """The plain backward against autograd through the plain forward and
    against ``jax.grad`` of ``ragged_dot``, fp32 within 1e-5 of the
    largest gradient; rows past the sum get zero dx, experts with no rows
    zero dw."""
    jax, _, ref = jx
    jnp = jax.numpy
    x, w, gs, dy = _bwd_inputs(11, *case)
    xt, wt, g = _torch(x, w, gs, "float32")
    dyt = torch.from_numpy(dy)
    dx, dw = moe_grouped_gemm_backward_plain(xt, wt, g, dyt)
    assert dx.shape == xt.shape and dw.shape == wt.shape
    xa, wa = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
    out = moe_grouped_gemm_plain(xa, wa, g)
    # with no rows the plain output is a constant: its gradients are zero
    auto = (torch.autograd.grad(out, (xa, wa), dyt) if out.requires_grad
            else (torch.zeros_like(xt), torch.zeros_like(wt)))
    rows = min(int(np.maximum(gs, 0).sum()), x.shape[0])
    want = jax.grad(lambda a, b: (ref(a, b, jnp.asarray(gs)) * dy).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    for got, a, j in zip((dx, dw), auto, want):
        j = np.asarray(j)
        scale = max(np.abs(j).max(), 1.0)
        assert np.abs(got.numpy() - a.numpy()).max() <= 1e-5 * scale
        assert np.abs(got.numpy() - j).max() <= 1e-5 * scale
    assert not dx[rows:].any()
    for e, n in enumerate(gs):
        if n <= 0:
            assert not dw[e].any()


def test_backward_route_by_dtype():
    """bf16 takes the wgmma backward (dx and dw), fp32 the FMA one."""
    from repro_torch.kernels.moe_gemm import BWD_ROUTES, backward_route

    assert backward_route(torch.bfloat16) == "wgmma"
    assert backward_route(torch.float32) == "fma"
    assert set(moe_grouped_gemm.backward_launches_by_route) == set(BWD_ROUTES)


def test_backward_refusal_before_the_forward():
    """A call whose gradient the backward kernels do not compute (D not a
    multiple of 8) is refused by the check that runs before the forward
    on a card; D = 16 passes it."""
    from repro_torch.kernels.moe_gemm import _check_backward

    with pytest.raises(NotImplementedError, match="multiple of 8"):
        _check_backward(torch.zeros(4, 12))
    _check_backward(torch.zeros(4, 16))


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda):
    """On a card a call that needs a gradient runs the forward kernel
    inside the autograd Function and the backward kernels in its
    backward (one backward launch), equal to the plain backward; a call
    at a D the backward does not take is refused before the forward
    launches."""
    x, w, gs = _torch(*_inputs(8, 32, 16, 24, 3), "float32", cuda)
    before = (moe_grouped_gemm.launches, moe_grouped_gemm.backward_launches)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = moe_grouped_gemm(xa, wa, gs)
    dy = torch.randn_like(out)
    out.backward(dy)
    torch.cuda.synchronize()
    assert (moe_grouped_gemm.launches, moe_grouped_gemm.backward_launches) == (
        before[0] + 1, before[1] + 1)
    want = moe_grouped_gemm_backward_plain(x, w, gs, dy)
    assert _rel_err(xa.grad, want[0]) < 1e-4 and _rel_err(wa.grad, want[1]) < 1e-4
    x12 = torch.randn(32, 12, device=cuda, requires_grad=True)
    w12 = torch.randn(3, 12, 24, device=cuda)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        moe_grouped_gemm(x12, w12, gs)
    assert moe_grouped_gemm.launches == before[0] + 1
    with torch.no_grad():
        moe_grouped_gemm(x12, w12, gs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES[:3] + [
    (8, 256, 512, 16, [1, 0, 1, 1, 0, 2, 0, 0, 1, 0, 0, 0, 1, 0, 1, 0]),  # the streaming forward
    (300, 72, 136, 6, [0, 130, 0, 0, 101, 0]),  # D and F not multiples of the tiles
    (1000, 200, 264, 5, [900, 0, 1, 2, 0]),  # one expert holds most rows, rows past the sum
    (4096, 512, 384, 16, "routed"),  # top-1 routing, sum = T
    # an expert of one row, starting one row past a 64-row box edge
    (600, 128, 256, 4, [65, 1, 300, 100]),
    (512, 64, 128, 40, "routed"),  # more experts than a warp scans at once
])
def test_backward_kernel_matches_plain(cuda, case, dtype):
    """The backward kernels (through autograd) against the plain backward:
    fp32 within 1e-4, bf16 within 2e-2 of each gradient's largest
    magnitude, the same bits on two runs, rows past the sum zero dx."""
    t, d, f, e, gs = case
    if gs == "routed":
        gs = np.bincount(np.random.default_rng(5).integers(0, e, t), minlength=e).tolist()
    x, w, g, dy = _bwd_inputs(12, t, d, f, e, gs)
    xt, wt, gt = _torch(x, w, g, dtype, cuda)
    dyt = torch.from_numpy(dy).to(cuda, xt.dtype)

    def run():
        xa, wa = xt.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        torch.autograd.backward(moe_grouped_gemm(xa, wa, gt), dyt)
        return xa.grad, wa.grad

    before = moe_grouped_gemm.backward_launches
    by_route = dict(moe_grouped_gemm.backward_launches_by_route)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert moe_grouped_gemm.backward_launches == before + 2
    r = "wgmma" if dtype == "bfloat16" else "fma"
    assert moe_grouped_gemm.backward_launches_by_route[r] == by_route[r] + 2
    want = moe_grouped_gemm_backward_plain(xt, wt, gt, dyt)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b, c in zip(got, again, want):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, b)
        assert _rel_err(a, c) < tol
    rows = min(int(np.maximum(g, 0).sum()), t)
    assert not got[0][rows:].any()
