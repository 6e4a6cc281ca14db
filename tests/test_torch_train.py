"""The port's LM training against the JAX package's, on the CPU.

  * ``TransformerLM.loss_fn``: the loss, the aux loss and every gradient
    leaf against ``jax.grad`` of the reference's ``loss_fn`` on the same
    weights (carried across with ``convert.lm_from_reference``, gradients
    carried back with ``convert.lm_to_reference``) in fp32, for the smoke
    configs of all ten archs (hubert's frames, llava's patch prefix,
    labels < 0 ignored): within 1e-4 of each leaf's largest gradient;
  * AdamW: three updates (two unclipped, one clipped) from the same
    weights and gradients equal the reference's ``adamw_update`` within
    1e-6 (new weights, masters and moments; a bf16 leaf within one ulp of
    that, the second moments within 1e-5) in the plain, ``m_dtype="bfloat16"`` and ``factored_v``
    variants, on a mamba2 tree (stacked norm, ``A_log`` and ``D`` leaves:
    weight decay and factoring on them) and a dense one; ``schedule``
    equals the reference's at every step of a 60-step run;
  * three ``TrainStepBuilder.train_step``s from carried-across weights
    equal the reference's losses and weights within 1e-4, with
    ``accum_steps`` 1 and 2, and for a MoE arch;
  * compression: the top-k mask exactly, int8 given JAX's noise within one
    quantum, and the reference's error-feedback checks (telescoping,
    bounded residual);
  * ``TokenPipeline.batch_at`` bit for bit against the reference's;
    ``train_shapes`` against the reference's;
  * resume: train 4 == train 2, save, restore, train 2, bit for bit; a
    checkpoint of another shape raises; the reference restores a port
    checkpoint's weights;
  * ``python -m repro_torch.launch.train --smoke --device cpu`` end to end
    (also on llama4-scout, mamba2 and zamba2), and its refusal of the
    frontend archs.

The card's training paths are ``chip_smoke.py``'s ``lm_train`` (the
attention's backward kernel, internlm2 at full width), ``moe_train``
(llama4-scout) and ``mamba_train`` (mamba2-1.3b) phases.
"""
import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as ref_configs
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.launch import inputs as ref_inputs
from repro.models import build_model as ref_build
from repro.sharding import single_device_ctx
from repro.train import compression as ref_comp
from repro.train import optimizer as ref_opt
from repro.train.train_loop import TrainState as RefState
from repro.train.train_loop import TrainStepBuilder as RefBuilder
from repro_torch import configs
from repro_torch.convert import lm_from_reference, lm_to_reference
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import inputs
from repro_torch.train import compression, optimizer
from repro_torch.train.checkpoint import latest_checkpoint
from repro_torch.train.optimizer import tree_build, tree_items
from repro_torch.train.train_loop import (
    TrainStepBuilder,
    restore_state,
    save_state,
    stacked_weights,
)

CTX = single_device_ctx()
SEQ = 32  # positions a row (a llava prefix included)
GRAD_RTOL = 1e-4  # of a leaf's largest gradient: XLA and torch sum in other orders


def _models(arch, dtype="float32", seed=0):
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=dtype)
    model = ref_build(cfg, CTX)
    params = model.init(jax.random.key(seed))
    return cfg, model, params, lm_from_reference(params, cfg, device="cpu")


def _batch(cfg, b=2, seq=SEQ, seed=1):
    """(the reference's batch, the port's): seeded embeddings or ids and
    labels with some positions at -1 (ignored)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, _) in ref_inputs.train_shapes(cfg, b, seq).items():
        if name in ("tokens", "labels"):
            out[name] = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        else:
            out[name] = rng.standard_normal(shape).astype(np.float32)
    out["labels"][:, ::5] = -1
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(leaf, dtype=np.float32)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _to_torch(tree):
    """A reference tree of arrays as the port's tree of tensors (dtypes
    kept: bf16 values are exact in fp32)."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t
    return jax.tree.map(leaf, tree)


# ------------------------------------------------------------------ loss_fn
@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_IDS))
def test_loss_and_gradients_match_jax(arch):
    cfg, model, params, port = _models(arch)
    jb, tb = _batch(cfg)
    (want_total, want_m), want_g = jax.value_and_grad(model.loss_fn, has_aux=True)(params, jb)
    total, metrics = port.loss_fn(tb)
    total.backward()
    assert abs(total.item() - float(want_total)) < 1e-4
    assert abs(metrics["loss"].item() - float(want_m["loss"])) < 1e-4
    assert abs(metrics["aux_loss"].item() - float(want_m["aux_loss"])) < 1e-5
    assert metrics["tokens"].item() == int(want_m["tokens"])
    if cfg.moe is not None:
        assert metrics["aux_loss"].item() > 0  # the MoE layers' loss is in the total
    got, want = _flat(lm_to_reference(port, grads=True)), _flat(want_g)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(got[name] - w).max() <= GRAD_RTOL * scale, name


def test_weights_round_trip_through_convert():
    cfg, _, params, port = _models("zamba2-7b")
    got, want = _flat(lm_to_reference(port)), _flat(params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------------ AdamW
VARIANTS = {
    "plain": {},
    "bf16_m": dict(m_dtype="bfloat16"),
    "factored_v": dict(factored_v=True),
}


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "internlm2-1.8b"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_adamw_update_matches_reference(arch, variant):
    cfg = ref_configs.get_smoke_config(arch)  # bf16 weights, fp32 norms
    params = ref_build(cfg, CTX).init(jax.random.key(2))
    kw = dict(warmup_steps=1, total_steps=10, lr=1e-2, **VARIANTS[variant])
    ref_cfg, cfg_t = ref_opt.AdamWConfig(**kw), optimizer.AdamWSettings(**kw)
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.3,
                                                 dtype=p.dtype), params) for _ in range(3)]
    state = ref_opt.adamw_init(params, ref_cfg)
    p_t = _to_torch(params)
    state_t = optimizer.adamw_init(p_t, cfg_t)
    is_f = lambda x: isinstance(x, dict) and set(x) == {"r", "c"}
    n_factored = sum(is_f(v) for v in jax.tree.leaves(state["v"], is_leaf=is_f))
    assert n_factored == sum(isinstance(v, dict) for _, v in tree_items(state_t["v"]))
    assert (n_factored > 0) == (variant == "factored_v")
    for step, g in enumerate(grads):
        # two steps unclipped (both scale by exactly 1), then one clipped
        clip = dict(clip_norm=1e9 if step < 2 else 1.0)
        params, state, met = ref_opt.adamw_update(
            dataclasses.replace(ref_cfg, **clip), params, state, g, jnp.int32(step))
        p_t, state_t, met_t = optimizer.adamw_update(
            dataclasses.replace(cfg_t, **clip), p_t, state_t, _to_torch(g), step)
        # the norm sums many squares, which XLA and torch add in other orders
        assert abs(met_t["grad_norm"].item() - float(met["grad_norm"])) <= 1e-5 * float(
            met["grad_norm"])
        assert abs(met_t["lr"] - float(met["lr"])) <= 1e-9
    for mine, ref in ((p_t, params), (state_t["master"], state["master"]),
                      (state_t["m"], state["m"])):
        got = {"/".join(p): t for p, t in tree_items(mine)}
        for name, w in _flat(ref).items():
            t = got[name]
            assert t.shape == w.shape, name
            err = np.abs(t.float().numpy() - w)
            if t.dtype == torch.bfloat16:
                # the fp32 values agree within 1e-6 (the masters, and m
                # before its cast): a bf16 leaf may round them one ulp apart
                assert (err <= np.maximum(1e-6, np.abs(w) * 2.0**-7)).all(), name
            else:
                assert err.max() <= 1e-6, name
    v_ref = {"/".join(str(k.key) for k in path): leaf for path, leaf in
             jax.tree_util.tree_leaves_with_path(state["v"], is_leaf=is_f)}
    for path, v in tree_items(state_t["v"]):
        w = v_ref["/".join(path)]
        pairs = [(v[k], w[k]) for k in ("r", "c")] if isinstance(v, dict) else [(v, w)]
        # squares of gradients clipped by norms ~1e-6 apart (see above)
        for a, b in pairs:
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5 * np.abs(
                np.asarray(b)).max(), path


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=6, total_steps=60, min_lr_frac=0.1)
    for step in range(61):
        want = float(ref_opt.schedule(ref_opt.AdamWConfig(**cfg), jnp.int32(step)))
        assert abs(optimizer.schedule(optimizer.AdamWSettings(**cfg), step) - want) <= 1e-6 * want


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("arch,accum", [("internlm2-1.8b", 1), ("internlm2-1.8b", 2),
                                        ("llama4-scout-17b-a16e", 1)])
def test_train_steps_match_reference(arch, accum):
    cfg, model, params, port = _models(arch)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=20)
    ref_b = RefBuilder(model, ref_opt.AdamWConfig(**kw), accum_steps=accum)
    state = RefState(params=params, opt=ref_opt.adamw_init(params, ref_b.opt_cfg),
                     step=jnp.zeros((), jnp.int32))
    step_fn = jax.jit(ref_b.train_step)
    builder = TrainStepBuilder(port, optimizer.AdamWSettings(**kw), accum_steps=accum)
    st = builder.init_state()
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=SEQ, global_batch=4, seed=1)
    for i in range(3):
        b = pipe.batch_at(i)
        state, met = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        st, met_t = builder.train_step(st, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(met_t["loss"].item() - float(met["loss"])) < 1e-4, i
        assert abs(met_t["grad_norm"].item() - float(met["grad_norm"])) < 1e-4 * float(
            met["grad_norm"]), i
    assert st.step == 3
    got, want = _flat(lm_to_reference(port)), _flat(state.params)
    for name, w in want.items():
        assert np.abs(got[name] - w).max() <= 1e-4, name


def test_eval_step_matches_loss():
    cfg, model, params, port = _models("phi3-mini-3.8b")
    jb, tb = _batch(cfg)
    builder = TrainStepBuilder(port)
    met = builder.eval_step(builder.init_state(), tb)
    want = model.loss_fn(params, jb)[1]
    assert abs(met["loss"].item() - float(want["loss"])) < 1e-4
    assert not met["loss"].requires_grad


# ------------------------------------------------------------- compression
def test_topk_mask_equals_reference():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((40, 30)).astype(np.float32)
    g[3, :5] = g[0, 0]  # ties at some magnitudes
    g[7, 2] = -g[0, 0]
    for frac in (0.01, 0.05, 0.25, 0.5):
        want = np.asarray(ref_comp._topk_mask(jnp.asarray(g), frac))
        got = compression._topk_mask(torch.from_numpy(g), frac).numpy()
        assert np.array_equal(got, want), frac


def test_int8_given_jax_noise_within_one_quantum():
    rng = np.random.default_rng(5)
    g = (rng.standard_normal((64, 33)) * 0.7).astype(np.float32)
    key = jax.random.key(9)
    noise = np.asarray(jax.random.uniform(key, g.shape, minval=-0.5, maxval=0.5))
    q_ref, s_ref = ref_comp._int8_compress(jnp.asarray(g), key)
    q, s = compression._int8_compress(torch.from_numpy(g), torch.from_numpy(noise))
    assert abs(s.item() - float(s_ref)) <= 1e-7 * float(s_ref)
    assert q.dtype == torch.int8
    assert np.abs(q.numpy().astype(np.int32) - np.asarray(q_ref).astype(np.int32)).max() <= 1
    d = compression._int8_decompress(q, s).numpy()
    assert np.abs(d - np.asarray(ref_comp._int8_decompress(q_ref, s_ref))).max() <= float(s_ref)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_error_feedback_unbiased(kind):
    """The reference's checks (tests/test_train_infra.py): the residuals
    telescope, sum(decompressed) = n g - e_final, and stay bounded."""
    cfg = compression.CompressionSettings(kind=kind, topk_frac=0.25)
    g_true = {"w": torch.linspace(-1, 1, 256).reshape(16, 16)}
    err = compression.init_error_state(g_true)
    acc = torch.zeros(16, 16)
    gen = torch.Generator().manual_seed(0)
    n = 30
    for _ in range(n):
        dec, err, metrics = compression.compress_grads(cfg, g_true, err, gen)
        acc = acc + dec["w"]
    assert (acc - (n * g_true["w"] - err["w"])).abs().max() < 1e-3
    assert err["w"].abs().max() < 5.0
    assert (acc / n - g_true["w"]).abs().max() < 5.0 / n + 0.02
    assert metrics["compressed_bytes"] < metrics["raw_bytes"]


def test_compression_none_passes_through():
    g = {"a": {"b": torch.ones(3, 2)}}
    out, err, met = compression.compress_grads(
        compression.CompressionSettings(kind="none"), g, compression.init_error_state(g),
        torch.Generator())
    assert out is g and met["compressed_bytes"] == met["raw_bytes"] == 24.0


# ------------------------------------------------------- pipeline, shapes
@pytest.mark.parametrize("seed,step,shards,shard", [(0, 0, 1, 0), (3, 5, 2, 1),
                                                    (7, 123, 4, 2), (1, 9, 2, 0)])
def test_pipeline_equals_reference(seed, step, shards, shard):
    kw = dict(vocab=1000, seq_len=48, global_batch=8, n_shards=shards, shard_id=shard,
              seed=seed)
    got, want = TokenPipeline(**kw).batch_at(step), RefPipeline(**kw).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", sorted(ref_configs.ARCH_IDS))
def test_train_shapes_equal_reference(arch):
    for smoke in (True, False):
        get = "get_smoke_config" if smoke else "get_config"
        ref_cfg, cfg = getattr(ref_configs, get)(arch), getattr(configs, get)(arch)
        seq = cfg.n_patches + 64
        want = ref_inputs.train_shapes(ref_cfg, 4, seq)
        got = inputs.train_shapes(cfg, 4, seq)
        assert list(got) == list(want)
        for k, (shape, dt) in want.items():
            assert got[k][0] == shape and str(got[k][1]).split(".")[-1] == jnp.dtype(dt).name
    batch = inputs.train_batch(cfg, 2, seq, torch.Generator().manual_seed(0), device="cpu")
    for k, (shape, dt) in inputs.train_shapes(cfg, 2, seq).items():
        assert batch[k].shape == shape and batch[k].dtype == dt
    assert int(batch["labels"].min()) >= 0 and int(batch["labels"].max()) < cfg.vocab


# ------------------------------------------------------------------ resume
def _trainer(arch="internlm2-1.8b"):
    cfg = configs.get_smoke_config(arch)
    from repro_torch.models.model import TransformerLM

    model = TransformerLM(cfg, device="cpu")
    builder = TrainStepBuilder(model, optimizer.AdamWSettings(warmup_steps=2, total_steps=50))
    return cfg, builder


def test_resume_is_bitwise():
    cfg, builder = _trainer()
    batches = [inputs.train_batch(cfg, 2, SEQ, torch.Generator().manual_seed(i), device="cpu")
               for i in range(4)]
    s = builder.init_state(torch.Generator().manual_seed(0))
    for b in batches:
        s, _ = builder.train_step(s, b)
    direct = {"/".join(p): t.clone() for p, t in tree_items(stacked_weights(s.params))}
    s = builder.init_state(torch.Generator().manual_seed(0))
    for b in batches[:2]:
        s, _ = builder.train_step(s, b)
    with tempfile.TemporaryDirectory() as d:
        save_state(d, s)
        s = builder.init_state(torch.Generator().manual_seed(5))  # other weights
        restore_state(latest_checkpoint(d), s)
    assert s.step == 2
    for b in batches[2:]:
        s, _ = builder.train_step(s, b)
    for p, t in tree_items(stacked_weights(s.params)):
        assert torch.equal(t, direct["/".join(p)]), p


def test_checkpoint_detects_shape_mismatch():
    cfg, builder = _trainer()
    s = builder.init_state(torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as d:
        save_state(d, s)
        other = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
        from repro_torch.models.model import TransformerLM

        bad = TrainStepBuilder(TransformerLM(other, device="cpu")).init_state(
            torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="shape"):
            restore_state(latest_checkpoint(d), bad)


def test_reference_restores_port_checkpoint():
    """A port checkpoint of a train state restores into the reference's
    ``TrainState`` (the same leaves and names)."""
    from repro.train.checkpoint import restore_checkpoint as ref_restore

    cfg, builder = _trainer()
    s = builder.init_state(torch.Generator().manual_seed(0))
    s, _ = builder.train_step(s, inputs.train_batch(cfg, 2, SEQ, torch.Generator().manual_seed(1),
                                                    device="cpu"))
    ref_b = RefBuilder(ref_build(ref_configs.get_smoke_config("internlm2-1.8b"), CTX),
                       ref_opt.AdamWConfig(warmup_steps=2, total_steps=50))
    like = ref_b.init_state(jax.random.key(0))
    with tempfile.TemporaryDirectory() as d:
        save_state(d, s)
        got, at = ref_restore(latest_checkpoint(d), like)
    assert at == 1 and int(got.step) == 1
    want = {"/".join(p): t.float().numpy() for p, t in tree_items(stacked_weights(s.params))}
    for name, arr in _flat(got.params).items():
        assert np.array_equal(arr, want[name]), name


# ------------------------------------------------------------------ driver
def test_launch_train_smoke_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    out = train.main(["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
                      "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert len(out["losses"]) == 6 and all(np.isfinite(out["losses"]))
    assert latest_checkpoint(tmp_path).name == "step_00000006"
    # a second run resumes from the final checkpoint: no step left
    again = train.main(["--smoke", "--device", "cpu", "--steps", "6", "--batch", "2",
                        "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert again["start"] == 6 and again["losses"] == []
    assert "resumed from step 6" in capsys.readouterr().out


def test_launch_train_refusals():
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="frontend"):
        train.main(["--smoke", "--device", "cpu", "--arch", "hubert-xlarge"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--smoke"])


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "mamba2-1.3b", "zamba2-7b"])
def test_launch_train_smoke_moe_and_ssm_on_cpu(arch):
    """``launch.train`` trains the moe, mamba2 and zamba2 patterns (the ones the
    grouped-GEMM and SSD backwards serve): finite losses over 4 steps of
    the smoke configs."""
    from repro_torch.launch import train

    out = train.main(["--smoke", "--device", "cpu", "--arch", arch, "--steps", "4",
                      "--batch", "2", "--seq", "32"])
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
