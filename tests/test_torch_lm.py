"""The port's TransformerLM (dense, moe and mamba2) against the JAX package's.

  * the port's configs (``repro_torch.configs``) equal the reference's
    dataclasses field by field (the MoE and SSM specs too), with the same
    parameter counts, total and active; the archs the port does not run
    raise ``NotImplementedError``;
  * norms, RoPE and the three MLP variants against ``repro.models.layers``;
  * ``forward``, ``prefill`` and 12 ``decode_step``s against the JAX
    model's on the same weights (carried across with
    ``convert.lm_from_reference``) in fp32: logits within 1e-4 and the
    same argmax, for internlm2-smoke, phi3-smoke, starcoder2-smoke, an
    internlm2-smoke with every dense knob set (sliding window, both
    softcaps, q scale, embedding scale, tied embeddings), mamba2-smoke,
    llama4-smoke (top-1 MoE), kimi-smoke (top-2 MoE), a kimi-shaped
    config with kimi-k2's head_dim of 112 and an internlm2-shaped one with
    hubert-xlarge's head_dim of 80; the decode tracks
    the port's own forward as ``tests/test_models.py`` checks it, and the
    decode cache (KV, or the convolution windows and SSM state) equals
    JAX's;
  * the bf16 forward within 2e-2 of JAX's, relative to the output's
    largest magnitude, and as close to the exact forward as JAX's is.

On the CPU the attention, the SSD scan and the grouped GEMM run through
the kernels' plain versions; the kernels themselves are held against them
on the card (``test_torch_flash.py``, ``test_torch_ssd.py``,
``test_torch_moe.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs
from repro.models import build_model as ref_build
from repro.models import layers as ref_ly
from repro.sharding import single_device_ctx
from repro_torch import configs
from repro_torch.convert import lm_config_from_reference, lm_from_reference
from repro_torch.models import layers as ly

CTX = single_device_ctx()
SMOKE = ["internlm2-1.8b", "phi3-mini-3.8b", "starcoder2-3b"]
PATTERNS = ["mamba2-1.3b", "llama4-scout-17b-a16e", "kimi-k2-1t-a32b"]  # mamba2, moe
ATOL = 1e-4  # fp32 logits: XLA and torch sum the same products in other orders
BF16_RTOL = 2e-2  # of the output's largest magnitude; see the bf16 test


def _knobs(cfg):
    """internlm2-smoke with every dense knob the port reads set."""
    return dataclasses.replace(
        cfg, name="internlm2-knobs", sliding_window=5, attn_softcap=20.0,
        logit_softcap=15.0, q_scale=0.3, embed_scale=True, tie_embeddings=True,
        rope_theta=500.0,
    )


def _ref_cfg(arch, dtype="float32"):
    if arch == "knobs":
        return dataclasses.replace(_knobs(ref_configs.get_smoke_config("internlm2-1.8b")),
                                   dtype=dtype)
    if arch == "kimi-hd112":  # kimi-k2's head_dim (7168 / 64) at a small width
        ref = ref_configs.get_smoke_config("kimi-k2-1t-a32b")
        return dataclasses.replace(ref, name="kimi-hd112", d_model=224, n_heads=2,
                                   n_kv_heads=1, moe=dataclasses.replace(
                                       ref.moe, n_experts=2, top_k=2), dtype=dtype)
    if arch == "hd80":  # hubert-xlarge's head_dim (1280 / 16) in the dense pattern
        return dataclasses.replace(ref_configs.get_smoke_config("internlm2-1.8b"),
                                   name="internlm2-hd80", d_model=160, n_heads=2,
                                   n_kv_heads=1, dtype=dtype)
    return dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)


def _models(arch, dtype="float32", seed=0):
    cfg = _ref_cfg(arch, dtype)
    model = ref_build(cfg, CTX)
    params = model.init(jax.random.key(seed))
    return cfg, model, params, lm_from_reference(params, cfg, device="cpu")


def _tokens(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", SMOKE + PATTERNS)
def test_configs_equal_reference(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    ref, port = getattr(ref_configs, get)(arch), getattr(configs, get)(arch)
    for f in dataclasses.fields(port):
        got, want = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(got):  # the moe and ssm specs
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), (f.name, g.name)
        else:
            assert got == want, f.name
    assert port.hd == ref.hd and port.q_scaling() == ref.q_scaling()
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    if port.ssm is not None:
        assert port.ssm.d_inner(port.d_model) == ref.ssm.d_inner(ref.d_model)
        assert port.ssm.n_heads(port.d_model) == ref.ssm.n_heads(ref.d_model)
    assert lm_config_from_reference(ref) == port


def test_full_param_counts():
    """The counts of the new patterns' full configs, as the reference
    gives them (mamba2-1.3b, llama4-scout total and active)."""
    assert configs.get_config("mamba2-1.3b").param_count() == 1_446_402_048
    scout = configs.get_config("llama4-scout-17b-a16e")
    assert scout.param_count() == 101_729_566_720
    assert scout.active_param_count() == 11_132_600_320


def test_unported_archs_raise():
    assert sorted(configs.ARCH_IDS + list(configs.UNPORTED)) == sorted(ref_configs.ARCH_IDS)
    for arch in configs.UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            configs.get_config(arch)
        with pytest.raises(NotImplementedError):
            lm_config_from_reference(ref_configs.get_smoke_config(arch))
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(norm):
    cfg = dataclasses.replace(ref_configs.get_smoke_config("internlm2-1.8b"), norm=norm)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
         "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    want = np.asarray(ref_ly.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(x), cfg))
    got = ly.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), lm_config_from_reference(cfg))
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.arange(3, 10)
    cos_r, sin_r = ref_ly.rope_cos_sin(jnp.asarray(pos), 16, 10_000.0)
    cos, sin = ly.rope_cos_sin(torch.from_numpy(pos), 16, 10_000.0)
    assert np.abs(cos.numpy() - np.asarray(cos_r)).max() < 1e-6
    assert np.abs(sin.numpy() - np.asarray(sin_r)).max() < 1e-6
    want = np.asarray(ref_ly.apply_rope(jnp.asarray(x).astype(dtype), cos_r, sin_r)
                      .astype(jnp.float32))
    got = ly.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), cos, sin)
    assert got.dtype == getattr(torch, dtype)
    assert np.abs(got.float().numpy() - want).max() < (1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(mlp):
    cfg = dataclasses.replace(ref_configs.get_smoke_config("internlm2-1.8b"),
                              mlp=mlp, dtype="float32")
    p = jax.tree.map(lambda a: a[0], ref_ly.init_mlp(jax.random.key(4), cfg, 1, jnp.float32))
    x = np.random.default_rng(5).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_ly.apply_mlp(p, jnp.asarray(x), cfg, CTX))
    got = ly.apply_mlp({k: torch.from_numpy(np.array(v)) for k, v in p.items()},
                       torch.from_numpy(x), lm_config_from_reference(cfg))
    assert np.abs(got.numpy() - want).max() < 1e-5


@pytest.mark.parametrize("arch", SMOKE + ["knobs"] + PATTERNS + ["kimi-hd112", "hd80"])
def test_forward_prefill_decode_match_reference(arch):
    cfg, model, params, port = _models(arch)
    if arch in ("kimi-hd112", "hd80"):
        assert port.cfg.hd == {"kimi-hd112": 112, "hd80": 80}[arch]
    toks = _tokens(cfg)
    # forward: final-normed hidden states and all-position logits
    x, _ = model.forward(params, {"tokens": jnp.asarray(toks)})
    full = np.asarray(model._logits(params, x))
    hidden = port.forward(torch.from_numpy(toks))
    assert np.abs(hidden.numpy() - np.asarray(x)).max() < ATOL
    logits = port._logits(hidden).numpy()
    assert logits.shape == full.shape and logits.shape[-1] % 2048 == 0
    assert np.abs(logits - full).max() < ATOL
    assert np.array_equal(logits.argmax(-1), full.argmax(-1))
    # prefill: the last position's logits
    pre = port.prefill(torch.from_numpy(toks)).numpy()
    want = np.asarray(model.prefill(params, {"tokens": jnp.asarray(toks)}))
    assert np.abs(pre - want).max() < ATOL
    assert np.array_equal(pre.argmax(-1), want.argmax(-1))
    # 12 decode steps, token by token, against JAX's and against the forward
    struct, _ = model.cache_struct(2, 16)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), struct)
    pcache = port.cache_struct(2, 16)
    assert sorted(pcache) == sorted(struct)
    for name, c in pcache.items():
        assert tuple(c.shape) == struct[name].shape, name
        assert str(c.dtype).split(".")[-1] == str(struct[name].dtype), name
    step = jax.jit(model.decode_step)
    for t in range(toks.shape[1]):
        cache, want_t = step(params, cache, jnp.asarray(toks[:, t]), jnp.int32(t))
        pcache, got_t = port.decode_step(pcache, torch.from_numpy(toks[:, t]), t)
        got_t, want_t = got_t.numpy(), np.asarray(want_t)
        assert np.abs(got_t - want_t).max() < ATOL, t
        assert np.array_equal(got_t.argmax(-1), want_t.argmax(-1)), t
        assert np.abs(got_t - logits[:, t]).max() < ATOL, t
    for name, c in pcache.items():
        assert np.abs(c.numpy() - np.asarray(cache[name])).max() < ATOL, name


# kimi-smoke is left out: with top-2 routing over 8 experts, one of its 32
# positions has two router probabilities so close that bf16 rounding in
# either framework picks another expert there (0.47 apart, the rest
# within 0.06); its fp32 forward matches JAX's within 1e-4 above
@pytest.mark.parametrize("arch", SMOKE + PATTERNS[:2])
def test_bf16_forward_matches_reference(arch):
    """bf16 weights: the port's forward within 2e-2 of JAX's, relative to
    the output's largest magnitude, and no farther from the exact (fp32)
    forward of the same weight values than JAX's own bf16 forward is (with
    a margin of 1.5x).  An absolute 2e-2 cannot hold: bf16 keeps 8 bits,
    so one rounding of an output near 3.5 moves it by up to 0.016, and the
    two frameworks round in other places (JAX's chunked attention already
    differs from its ``_attend`` by one ulp a layer); JAX's bf16 forward is
    itself 0.03-0.05 from the fp32 one on these configs."""
    cfg, model, params, port = _models(arch, dtype="bfloat16")
    assert port.embed.dtype == torch.bfloat16
    toks = _tokens(cfg, s=16)
    batch = {"tokens": jnp.asarray(toks)}
    x = np.asarray(model.forward(params, batch)[0].astype(jnp.float32))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    exact = np.asarray(ref_build(cfg32, CTX).forward(
        jax.tree.map(lambda a: a.astype(jnp.float32), params), batch)[0])
    got = port.forward(torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - x).max() < BF16_RTOL * np.abs(exact).max()
    assert np.abs(got - exact).max() <= 1.5 * np.abs(x - exact).max()
