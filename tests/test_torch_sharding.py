"""The port's sharding layout against the JAX reference's, on mesh shapes
alone (no ranks): ``repro_torch.sharding.MeshShape`` beside
``jax.sharding.AbstractMesh``, which needs no devices.

  * ``MeshContext`` (``ShardCtx``): tp_size, dp_size, batch_spec and
    seq_shard_ok on 16 x 16, 2 x 16 x 16 and 2 x 4;
  * every parameter leaf's spec, through ``TransformerLM.leaf_groups`` on a
    meta build, equals the reference's ``param_specs()`` for the ten
    archs on both production meshes in "head_dim" and "pad" mode, and
    ``opt_state_specs`` (a factored second moment too) and the decode
    cache's specs equal the reference's;
  * ``attn_shard_mode``, ``padded_head_layout`` and ``kv_eff_heads`` at tp
    1, 2, 4, 8 and 16;
  * the expert shard's body equals the reference's ``_moe_local`` called
    with the same e0 and capacity, with tokens dropped and without;
  * the meta builds' leaf shapes, ``param_count``, ``active_param_count``,
    ``SHAPES`` and ``cell_status`` equal the reference's.
A spec entry is compared as its tuple of mesh axes (the reference's
``PartitionSpec`` writes a one-axis tuple as the axis name).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro import sharding as ref_sharding
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch import sharding as sh
from repro_torch.models import TransformerLM
from repro_torch.models import layers, moe
from repro_torch.train import optimizer
from repro_torch.train.train_loop import TrainStepBuilder

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model")),
          "small": ((2, 4), ("data", "model"))}
ARCHS = configs.ARCH_IDS


def _ctxs(mesh):
    sizes, names = MESHES[mesh]
    return (ref_sharding.ctx_for_mesh(AbstractMesh(sizes, names)),
            sh.ctx_for_mesh(sh.MeshShape(names, sizes)))


def _norm(spec):
    entries = [sh.axis_names(e) for e in tuple(spec)]
    while entries and not entries[-1]:
        entries.pop()
    return tuple(entries)


def _flat(tree, prefix=()):
    if isinstance(tree, dict) and set(tree) != {"r", "c"}:
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    elif isinstance(tree, dict):
        yield prefix, {k: _norm(v) for k, v in tree.items()}
    else:
        yield prefix, _norm(tree)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_shard_ctx_matches_reference(mesh):
    ref, port = _ctxs(mesh)
    assert port.tp_size == ref.tp_size and port.dp_size == ref.dp_size
    assert port.dp == tuple(ref.dp) and port.tp == ref.tp
    for batch in (1, 2, 3, 8, 32, 128, 256, 512):
        for extra in (0, 1, 2):
            assert _norm(port.batch_spec(batch, extra)) == _norm(ref.batch_spec(batch, extra))
        assert port.seq_shard_ok(batch) == ref.seq_shard_ok(batch)
    assert sh.single_device_ctx().tp_size == 1 and sh.single_device_ctx().mesh is None
    x = torch.arange(6.0)
    assert sh.single_device_ctx().shard(x, ("data",)) is x


def _cfgs(arch, mode):
    return (dataclasses.replace(ref_configs.get_config(arch), attn_mode=mode),
            dataclasses.replace(configs.get_config(arch), attn_mode=mode))


@pytest.mark.parametrize("mode", ["head_dim", "pad"])
@pytest.mark.parametrize("mesh", ["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_specs_match_reference(arch, mesh, mode):
    ref_ctx, ctx = _ctxs(mesh)
    ref_cfg, cfg = _cfgs(arch, mode)
    ref_model = ref_build(ref_cfg, ref_ctx)
    want = dict(_flat(ref_model.param_specs()))
    model = TransformerLM(cfg, device="meta")
    got = dict(_flat(model.param_specs(ctx)))
    assert set(got) == set(want)
    assert [p for p, _, _ in model.leaf_groups()] == sorted(want)
    for path in want:
        assert got[path] == want[path], (path, got[path], want[path])
    # each parameter's own spec drops the stacked layer axis
    for name, param, spec in model.parameter_specs(ctx):
        assert len(spec) <= param.dim() and all(e is None or isinstance(e, (str, tuple))
                                                for e in spec), name
    # the optimizer state's specs, a factored second moment's too
    shapes = jax.eval_shape(lambda: ref_model.init(jax.random.key(0)))
    for factored in (False, True):
        ocfg = ref_opt.AdamWConfig(factored_v=factored)
        want_o = dict(_flat(ref_opt.opt_state_specs(ocfg, shapes, ref_model.param_specs())))
        model_o = TrainStepBuilder(model, optimizer.AdamWSettings(factored_v=factored))
        model_o.ctx = ctx
        got_o = dict(_flat(model_o.state_specs()["opt"]))
        assert got_o == want_o
    # the same specs as DTensor placements, the batch's over dp
    names = MESHES[mesh][1]
    placed = model_o.state_shardings()
    assert placed["step"] == sh.placements((), names)
    for path, spec in _flat(model.param_specs(ctx)):
        node = placed["params"]
        for k in path:
            node = node[k]
        assert node == sh.placements(spec, names), path
    batch = model_o.batch_shardings(256)
    assert all(p == sh.placements((ctx.dp, None), names) for p in batch.values())
    # the decode cache's specs
    if not cfg.is_encoder:
        for batch in (1, 128):
            _, want_c = ref_model.cache_struct(batch, 64)
            model.ctx = ctx
            assert dict(_flat(model.cache_specs(batch))) == dict(_flat(want_c))


@pytest.mark.parametrize("arch", ARCHS)
def test_head_layout_matches_reference(arch):
    for mode in ("head_dim", "pad"):
        ref_cfg, cfg = _cfgs(arch, mode)
        for tp in (1, 2, 4, 8, 16):
            ref_ctx = ref_sharding.ctx_for_mesh(AbstractMesh((1, tp), ("data", "model")))
            ctx = sh.ctx_for_mesh(sh.MeshShape(("data", "model"), (1, tp)))
            try:
                want = ref_layers.attn_shard_mode(ref_cfg, ref_ctx)
            except AssertionError:
                with pytest.raises(ValueError):
                    layers.attn_shard_mode(cfg, ctx)
                continue
            assert layers.attn_shard_mode(cfg, ctx) == want
            assert layers.kv_eff_heads(cfg, ctx) == ref_layers.kv_eff_heads(ref_cfg, ref_ctx)
            assert cfg.kv_repeat_for(tp) == ref_cfg.kv_repeat_for(tp)
            try:
                want_pad = ref_layers.padded_head_layout(ref_cfg, tp)
            except AssertionError:
                with pytest.raises(ValueError):
                    layers.padded_head_layout(cfg, tp)
                continue
            assert layers.padded_head_layout(cfg, tp) == want_pad


@pytest.mark.parametrize("e0,e_local,capacity", [(0, 2, 128), (2, 2, 128), (6, 2, 64),
                                                 (4, 4, 32)])
def test_expert_shard_matches_reference_moe_local(e0, e_local, capacity):
    """kimi-smoke's routing (8 experts, top 2) over 96 tokens: the local
    experts' rows, capped at ``capacity`` of the 192 pairs (the small
    capacities drop pairs)."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("kimi-k2-1t-a32b"),
                                  dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke_config("kimi-k2-1t-a32b"), dtype="float32")
    rng = np.random.default_rng(11)
    t, d, f, e = 96, cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    xt = rng.standard_normal((t, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    w = [(rng.standard_normal((e_local, a, b)) / np.sqrt(a)).astype(np.float32)
         for a, b in ((d, f), (d, f), (f, d))]
    y_ref, aux_ref = ref_moe._moe_local(xt, router, *w, ref_cfg, e0, capacity)
    y, aux = moe.expert_shard(torch.from_numpy(xt), torch.from_numpy(router),
                              *(torch.from_numpy(a) for a in w), cfg, e0, capacity)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    assert abs(float(aux) - float(aux_ref)) <= 1e-6
    topi = torch.from_numpy(np.array(jax.lax.top_k(jax.nn.softmax(xt @ router), 2)[1]))
    local = int(((topi >= e0) & (topi < e0 + e_local)).sum())
    if capacity < local:  # pairs were dropped: the rows differ from all of them
        full, _ = moe.expert_shard(torch.from_numpy(xt), torch.from_numpy(router),
                                   *(torch.from_numpy(a) for a in w), cfg, e0, 2 * t)
        assert not torch.allclose(full, y)
    assert moe.capacity_for(4096 * 16, cfg, 16) == int(
        ref_moe.CAPACITY_FACTOR * 4096 * 16 * 2 / 16 + 127) // 128 * 128


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_build_counts_and_shapes_match_reference(arch):
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    model = TransformerLM(cfg, device="meta")
    tree = jax.eval_shape(lambda: ref_build(ref_cfg, ref_sharding.single_device_ctx()).init(
        jax.random.key(0)))
    want = {tuple(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    for path, ps, stacked in model.leaf_groups():
        shape = (len(ps),) + tuple(ps[0].shape) if stacked else tuple(ps[0].shape)
        assert shape == tuple(want[path]), path
    assert {p for p, _, _ in model.leaf_groups()} == set(want)
    for shape in configs.SHAPES:
        assert configs.cell_status(cfg, shape) == ref_configs.cell_status(ref_cfg, shape)


def test_shapes_match_reference():
    assert configs.SHAPES == ref_configs.SHAPES
    statuses = [configs.cell_status(configs.get_config(a), s) for a in ARCHS
                for s in configs.SHAPES]
    assert len(statuses) == 40 and statuses.count("run") == 31


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert sh.placements((None, ("pod", "data"), "model"), names) == [Shard(1), Shard(1),
                                                                      Shard(2)]
    assert sh.placements((None, None), names) == [Replicate()] * 3
    sizes = dict(zip(names, (2, 16, 16)))
    assert sh.local_shape((4, 2048, 16, 128), (None, ("pod", "data"), "model"), sizes) == (
        4, 64, 1, 128)
