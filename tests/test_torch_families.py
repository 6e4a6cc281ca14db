"""The port's last four model families against the JAX package's.

gemma2 (local/global windows alternating by layer, both softcaps,
sandwich norms, GeGLU, tied embeddings), the zamba2 hybrid (one shared
attention + MLP block after every ``hybrid_every`` mamba2 blocks, its KV
cache indexed by application), the hubert encoder (frame embeddings in,
bidirectional attention without rope, per-frame logits, no decode) and
llava (a patch prefix before the tokens, mistral's sliding window):

  * the port's configs equal the reference's field by field, smoke and
    full, with the same head dim, query scale and parameter count, and
    the full counts fall in the reference's own ranges
    (``tests/test_models.py``);
  * ``forward``, ``prefill`` and 24 ``decode_step``s at smax 32 against
    the JAX model's on the same weights (carried across with
    ``convert.lm_from_reference``) in fp32: within 1e-4 and the same
    argmax; the smoke windows of 16 bite in the forward and in the
    decode; the decode caches (zamba2's nested one too) equal JAX's;
  * gemma2's alternation acts: the same weights with every layer global
    give another forward;
  * hubert's hidden states and per-frame logits equal JAX's, and it has
    no decode cache and no decode step;
  * the bf16 forward within 2e-2 of JAX's, relative to the output's
    largest magnitude, and as close to the exact forward as JAX's is.

Inputs are drawn with numpy from a seed.  On the CPU the attention and
the SSD scan run through the kernels' plain versions.  The reference's
forward sends these layers through ``_attend_chunked``, which needs a
length that is a multiple of min(512, length): 32 here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs
from repro.models import build_model as ref_build
from repro.sharding import single_device_ctx
from repro_torch import configs
from repro_torch.convert import lm_config_from_reference, lm_from_reference

CTX = single_device_ctx()
FAMILIES = ["gemma2-27b", "zamba2-7b", "hubert-xlarge", "llava-next-mistral-7b"]
DECODERS = ["gemma2-27b", "zamba2-7b", "llava-next-mistral-7b"]
ATOL = 1e-4  # fp32: XLA and torch sum the same products in other orders
BF16_RTOL = 2e-2  # of the output's largest magnitude (test_torch_lm.py says why)
SEQ = 32  # positions of the forward (a llava prefix included)
SMAX, DECODE_STEPS = 32, 24  # past the smoke windows of 16
# the reference's ranges of the full configs' parameter counts
# (tests/test_models.py::test_param_counts_match_reference_scale)
COUNT_RANGES = {
    "gemma2-27b": (26e9, 29e9),
    "zamba2-7b": (6.5e9, 8.2e9),
    "hubert-xlarge": (0.9e9, 1.1e9),
    "llava-next-mistral-7b": (6.8e9, 7.6e9),
}


def _models(arch, dtype="float32", seed=0):
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    model = ref_build(cfg, CTX)
    params = model.init(jax.random.key(seed))
    return cfg, model, params, lm_from_reference(params, cfg, device="cpu")


def _inputs(cfg, b=2, seq=SEQ, seed=1):
    """(the reference's batch, the port's arguments): seq positions of
    frames, or of a patch prefix and tokens, or of tokens."""
    rng = np.random.default_rng(seed)

    def emb(n):
        return rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)

    if cfg.frontend == "frames":
        frames = emb(seq)
        return {"frames": jnp.asarray(frames)}, ((), {"frames": torch.from_numpy(frames)})
    n_patch = cfg.n_patches if cfg.frontend == "patches" else 0
    toks = rng.integers(0, cfg.vocab, (b, seq - n_patch)).astype(np.int32)
    batch, kw = {"tokens": jnp.asarray(toks)}, {}
    if n_patch:
        patches = emb(n_patch)
        batch["patches"], kw["patches"] = jnp.asarray(patches), torch.from_numpy(patches)
    return batch, ((torch.from_numpy(toks),), kw)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_configs_equal_reference(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    ref, port = getattr(ref_configs, get)(arch), getattr(configs, get)(arch)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):  # the ssm spec
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), (f.name, g.name)
        else:
            assert got == want, f.name
    assert port.hd == ref.hd and port.q_scaling() == ref.q_scaling()
    assert port.is_encoder == ref.is_encoder
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert lm_config_from_reference(ref) == port


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_param_counts_in_reference_ranges(arch):
    lo, hi = COUNT_RANGES[arch]
    assert lo <= configs.get_config(arch).param_count() <= hi


def test_every_reference_arch_resolves():
    """All ten of the reference's archs resolve in the port, smoke and
    full, and the port builds each smoke config (all six block patterns,
    both frontends)."""
    from repro_torch.models import TransformerLM

    assert sorted(configs.ARCH_IDS) == sorted(ref_configs.ARCH_IDS)
    assert configs.UNPORTED == {}
    patterns, frontends = set(), set()
    for arch in ref_configs.ARCH_IDS:
        cfg = configs.get_smoke_config(arch)
        assert configs.get_config(arch).block_pattern == cfg.block_pattern
        TransformerLM(cfg, device="cpu")
        patterns.add(cfg.block_pattern)
        frontends.add(cfg.frontend)
    assert patterns == {"dense", "gemma2", "moe", "mamba2", "zamba2", "encoder"}
    assert frontends == {None, "frames", "patches"}


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_prefill_decode_match_reference(arch):
    cfg, model, params, port = _models(arch)
    batch, (args, kw) = _inputs(cfg)
    x, _ = model.forward(params, batch)
    full = np.asarray(model._logits(params, x))
    hidden = port.forward(*args, **kw)
    assert hidden.shape == (2, SEQ, cfg.d_model)
    assert np.abs(hidden.numpy() - np.asarray(x)).max() < ATOL
    logits = port._logits(hidden).numpy()
    assert logits.shape == full.shape
    assert np.abs(logits - full).max() < ATOL
    assert np.array_equal(logits.argmax(-1), full.argmax(-1))
    pre = port.prefill(*args, **kw).numpy()
    want = np.asarray(model.prefill(params, batch))
    assert np.abs(pre - want).max() < ATOL
    assert np.array_equal(pre.argmax(-1), want.argmax(-1))

    # 24 decode steps at smax 32, token by token (llava decodes text
    # without its patch prefix, as the reference's decode_step does)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, DECODE_STEPS)).astype(np.int32)
    struct, _ = model.cache_struct(2, SMAX)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), struct)
    pcache = port.cache_struct(2, SMAX)
    want_leaves = jax.tree_util.tree_leaves_with_path(struct)
    got_leaves = jax.tree_util.tree_leaves_with_path(pcache)
    assert [jax.tree_util.keystr(k) for k, _ in got_leaves] == \
        [jax.tree_util.keystr(k) for k, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
    no_prefix = {"patches": torch.zeros(2, 0, cfg.d_model)} if cfg.frontend else {}
    own = port._logits(port.forward(torch.from_numpy(toks), **no_prefix)).numpy()
    step = jax.jit(model.decode_step)
    for t in range(DECODE_STEPS):
        cache, want_t = step(params, cache, jnp.asarray(toks[:, t]), jnp.int32(t))
        pcache, got_t = port.decode_step(pcache, torch.from_numpy(toks[:, t]), t)
        got_t, want_t = got_t.numpy(), np.asarray(want_t)
        assert np.abs(got_t - want_t).max() < ATOL, t
        assert np.array_equal(got_t.argmax(-1), want_t.argmax(-1)), t
        assert np.abs(got_t - own[:, t]).max() < ATOL, t
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(pcache),
                                 jax.tree_util.tree_leaves_with_path(cache)):
        assert np.abs(g.numpy() - np.asarray(w)).max() < ATOL, jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ["gemma2-27b", "llava-next-mistral-7b"])
def test_window_bites(arch):
    """The smoke windows (16) act within the tests' 32 positions: without
    them (every layer global) the forward moves, past position 16 only."""
    cfg, _, _, port = _models(arch)
    _, (args, kw) = _inputs(cfg)
    windowed = port.forward(*args, **kw)
    assert [port._window_for(i) for i in range(4)] == (
        [16, None, 16, None] if cfg.block_pattern == "gemma2" else [16] * 4)
    port._window_for = lambda idx: None
    every_global = port.forward(*args, **kw)
    assert np.abs((windowed - every_global).numpy()).max() > 1e-3
    # positions below the window see the same keys either way
    assert np.abs((windowed - every_global)[:, :16].numpy()).max() < ATOL


def test_zamba2_shared_block_applications():
    """zamba2-smoke's 7 layers in groups of 3: the shared block runs after
    layers 2 and 5 (two applications, one trailing layer), each with its
    own KV entry; both entries are written by a decode step."""
    cfg, _, _, port = _models("zamba2-7b")
    assert (cfg.n_layers, cfg.hybrid_every) == (7, 3)
    cache = port.cache_struct(2, 8)
    assert cache["attn"]["k"].shape[0] == 2
    assert cache["mamba"]["h"].shape[0] == 7
    port.decode_step(cache, torch.tensor([3, 4]), 0)
    for name in ("k", "v"):
        for app in range(2):
            assert cache["attn"][name][app, :, 0].abs().max() > 0, (name, app)
            assert cache["attn"][name][app, :, 1:].abs().max() == 0, (name, app)


def test_hubert_matches_reference_and_has_no_decode():
    cfg, model, params, port = _models("hubert-xlarge")
    assert port.embed is None and port.head is not None
    batch, (args, kw) = _inputs(cfg, seq=64)
    x, _ = model.forward(params, batch)
    hidden = port.forward(*args, **kw)
    assert np.abs(hidden.numpy() - np.asarray(x)).max() < ATOL
    # per-frame logits over the padded vocabulary, the padded entries -1e30
    want = np.asarray(model._logits(params, x))
    got = port._logits(hidden).numpy()
    assert got.shape == (2, 64, 2048) == want.shape
    assert np.abs(got[..., : cfg.vocab] - want[..., : cfg.vocab]).max() < ATOL
    assert np.all(got[..., cfg.vocab:] == -1e30)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(port.prefill(*args, **kw).numpy() - got[:, -1]).max() < ATOL
    # bidirectional: the first frame's state depends on the last frame
    frames = kw["frames"].clone()  # (layernorm would erase a constant shift)
    frames[:, -1] += torch.from_numpy(
        np.random.default_rng(3).standard_normal(cfg.d_model).astype(np.float32))
    assert np.abs((port.forward(frames=frames) - hidden)[:, 0].numpy()).max() > 1e-4
    with pytest.raises(ValueError, match="encoder"):
        model.cache_struct(2, 8)
    with pytest.raises(ValueError, match="encoder"):
        port.cache_struct(2, 8)
    with pytest.raises(ValueError, match="encoder"):
        port.decode_step({}, torch.zeros(2, dtype=torch.int32), 0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_frontend_inputs_are_checked(arch):
    """Each model takes the inputs of its frontend and refuses others."""
    cfg, _, _, port = _models(arch)
    x = torch.zeros(1, 4, cfg.d_model)
    tok = torch.zeros(1, 4, dtype=torch.int32)
    if cfg.frontend == "frames":
        bad = [dict(tokens=tok), dict(tokens=tok, frames=x), dict(frames=x, patches=x)]
    elif cfg.frontend == "patches":
        bad = [dict(tokens=tok), dict(tokens=tok, frames=x)]
    else:
        bad = [dict(tokens=tok, patches=x), dict(tokens=tok, frames=x)]
    for kw in bad:
        with pytest.raises(ValueError):
            port.forward(**kw)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_forward_matches_reference(arch):
    """bf16 weights: the port's forward within 2e-2 of JAX's, relative to
    the output's largest magnitude, and no farther from the exact (fp32)
    forward of the same weight values than JAX's own bf16 forward is (with
    a margin of 1.5x), as ``test_torch_lm.py`` holds the other families.

    zamba2-smoke is held to the second bound only: its 7 mamba2 layers
    and 2 shared-block applications round in bf16 far enough that JAX's
    own bf16 forward is 0.117 from the exact one (3.0% of the largest
    output, 0.056 at mamba2-smoke's 3 layers), so no forward that rounds
    elsewhere can be within 2e-2 of JAX's; the port's is 0.069 from the
    exact forward, and 0.122 from JAX's."""
    cfg, model, params, port = _models(arch, dtype="bfloat16")
    batch, (args, kw) = _inputs(cfg)
    x = np.asarray(model.forward(params, batch)[0].astype(jnp.float32))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    exact = np.asarray(ref_build(cfg32, CTX).forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), params), batch)[0])
    got = port.forward(*args, **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if cfg.block_pattern != "zamba2":
        assert np.abs(got - x).max() < BF16_RTOL * np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1.5 * np.abs(x - exact).max()
