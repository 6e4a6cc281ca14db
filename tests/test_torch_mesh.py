"""The port's mesh against the JAX reference: gloo ranks on the CPU.

``tests/torch_mesh_worker.py`` runs each case on spawned gloo ranks (a
``DeviceMesh`` over (data, model), the model placed by its specs with
``TransformerLM.shard_parameters``, each rank on its dp shard of the
batch) from the reference's weights and batch; here the loss and the
gradients, gathered whole, are held against ``jax.grad`` of the
reference's single-device ``loss_fn`` in fp32: the loss within
``LOSS_RTOL``, each gradient leaf within ``GRAD_RTOL`` of its largest.
The reference is the mean of its loss over the batch's two halves: that
is the reference mesh's loss at dp 2, which takes the MoE load-balance
loss per dp shard (``pmean``), and for the other archs the whole batch's
loss; kimi-k2 at dp 1 is held against the whole batch's.  The reference's
``attn_mode`` changes nothing without a mesh.  Cases: internlm2 (dense, heads mode), kimi-k2 (expert
parallel, top-2) and mamba2 (the head-sharded scan) at tp 4 and at dp 2
x tp 2; mamba2 with 2 B/C groups at tp 2 and tp 4 and with 4 at tp 2
(each rank scanning its heads over the groups they use); starcoder2 at
tp 8 in "head_dim" and "pad" mode (its 4 query
heads over 2 KV heads divide neither); one mesh AdamW step (plain and
with a factored second moment; two steps, as the schedule's first lr is
0) against the same steps without a mesh; internlm2's decode at batch 1 on
dp 2 x tp 2 (the cache's positions sharded over dp, merged over the
ranks) against the decode without a mesh, its attention counted at the
flash kernel's formula; zamba2's decode at batch 1 on dp 4 and on dp 2 x
tp 2 against JAX's decode without a mesh, over steps where some ranks see
no key; checkpoints on dp 2 x tp 2 (plain and factored AdamW): a resume
equal bit for bit to the steps without it, a mesh checkpoint restored
without a mesh and back with the same files, and the reference's
``restore_checkpoint`` reading it; and, on fake card tensors, a rank's
part of the sequence-sharded decode reaching the flash decode route with
its logsumexp.  The one-rank mesh on a card is a ``cuda`` test in
``test_torch_cuda.py``, which imports no JAX.
"""
import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as ref_configs
from repro.models import build_model as ref_build
from repro.sharding import single_device_ctx

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
BATCH, SEQ = 4, 64

LOSS_CASES = [(arch, model) for model in (4, 2)
              for arch in ("internlm2-1.8b", "kimi-k2-1t-a32b", "mamba2-1.3b")]
PAD_CASES = [("starcoder2-3b", 8, mode) for mode in ("head_dim", "pad")]
STEP_CASES = [False, True]  # factored second moment
STEP_LR = 1e-2  # tests/torch_mesh_worker.py's
DECODE_STEPS = 12  # a cache of 12 positions, 6 a dp rank: the steps cross ranks
ZAMBA_DECODE = [1, 2]  # model axes: dp 4 (3 positions a rank) and dp 2 x tp 2
# mamba2-smoke's 8 SSM heads: (groups, model axis) pairs where tp divides
# the groups (2 at tp 2, 4 at tp 2) and where the groups divide tp (2 at 4)
GROUP_CASES = [(2, 2), (2, 4), (4, 2)]


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


_CACHE = {}


def _ref_cfg(arch, mode="head_dim", groups=None):
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype="float32",
                              attn_mode=mode)
    if groups:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=groups))
    return cfg


def _reference(arch, mode, whole=False, groups=None):
    """The reference's weights, batch, and loss and gradients: the mean of
    its jitted ``loss_fn`` over the batch's two halves (dp 2), or with
    ``whole`` over the whole batch (only the MoE load-balance loss tells
    them apart); ``groups`` sets mamba2's B/C groups."""
    key = (arch, mode, whole, groups)
    if key in _CACHE:
        return _CACHE[key]
    cfg = _ref_cfg(arch, mode, groups)
    model = ref_build(cfg, single_device_ctx())
    params = model.init(jax.random.key(0))
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    fn = jax.jit(jax.value_and_grad(model.loss_fn, has_aux=True))
    parts = [batch] if whole else [{k: v[i * BATCH // 2:(i + 1) * BATCH // 2]
                                    for k, v in batch.items()} for i in range(2)]
    losses, grads = [], None
    for part in parts:
        (_, met), g = fn(params, part)
        losses.append(float(met["loss"]))
        grads = g if grads is None else jax.tree.map(lambda a, b: a + b, grads, g)
    grads = jax.tree.map(lambda a: a / len(parts), grads)
    _CACHE[key] = params, batch, float(np.mean(losses)), dict(_flat(grads))
    return _CACHE[key]


def _spawn(tmp, world, cases):
    spec = tmp / "cases.json"
    spec.write_text(json.dumps({"world": world, "port": _port(), "cases": cases}))
    out = subprocess.run([sys.executable, str(WORKER), str(spec)], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]


def _inputs(tmp, name, params, batch):
    path = tmp / f"{name}.npz"
    leaves = {"leaf/" + "/".join(p): a for p, a in _flat(params)}
    np.savez(path, **leaves, **batch)
    return str(path)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh4")
    cases, refs = [], {}
    for arch, model in LOSS_CASES:
        # dp 1 sees the whole batch's load-balance loss, dp 2 each half's
        params, batch, loss, grads = _reference(arch, "head_dim",
                                                whole=model == 4 and arch.startswith("kimi"))
        name = f"{arch}_{model}"
        cases.append({"arch": arch, "model": model, "mode": "head_dim",
                      "inputs": _inputs(tmp, name, params, batch),
                      "output": str(tmp / f"{name}_out.npz")})
        refs[(arch, model)] = (loss, grads, cases[-1]["output"])
    params, batch, _, _ = _reference("internlm2-1.8b", "head_dim")
    for factored in STEP_CASES:
        name = f"step_{factored}"
        cases.append({"arch": "internlm2-1.8b", "model": 2, "mode": "head_dim", "step": True,
                      "factored": factored, "inputs": _inputs(tmp, name, params, batch),
                      "output": str(tmp / f"{name}_out.npz")})
        refs[("step", factored)] = cases[-1]["output"]
    cases.append({"arch": "internlm2-1.8b", "model": 2, "mode": "head_dim",
                  "decode": DECODE_STEPS, "inputs": _inputs(tmp, "decode", params, batch),
                  "output": str(tmp / "decode_out.npz")})
    refs["decode"] = cases[-1]["output"]
    for factored in STEP_CASES:
        name = f"ckpt_{factored}"
        cases.append({"arch": "internlm2-1.8b", "model": 2, "mode": "head_dim",
                      "ckpt": str(tmp / name), "factored": factored,
                      "inputs": _inputs(tmp, name, params, batch),
                      "output": str(tmp / f"{name}_out.npz")})
        refs[("ckpt", factored)] = (Path(cases[-1]["ckpt"]), cases[-1]["output"])
    zparams, zbatch, _, _ = _reference("zamba2-7b", "head_dim")
    zinputs = _inputs(tmp, "zamba2_decode", zparams, zbatch)
    for model in ZAMBA_DECODE:
        cases.append({"arch": "zamba2-7b", "model": model, "mode": "head_dim",
                      "decode": DECODE_STEPS, "inputs": zinputs,
                      "output": str(tmp / f"zamba2_decode_{model}_out.npz")})
        refs[("zamba2 decode", model)] = cases[-1]["output"]
    for groups, model in GROUP_CASES:
        params, batch, loss, grads = _reference("mamba2-1.3b", "head_dim", groups=groups)
        name = f"mamba2_g{groups}_{model}"
        cases.append({"arch": "mamba2-1.3b", "model": model, "mode": "head_dim",
                      "groups": groups, "inputs": _inputs(tmp, name, params, batch),
                      "output": str(tmp / f"{name}_out.npz")})
        refs[("groups", groups, model)] = (loss, grads, cases[-1]["output"])
    _spawn(tmp, 4, cases)
    return refs


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh8")
    cases, refs = [], {}
    for arch, model, mode in PAD_CASES:
        params, batch, loss, grads = _reference(arch, "head_dim")
        name = f"{arch}_{mode}"
        cases.append({"arch": arch, "model": model, "mode": mode,
                      "inputs": _inputs(tmp, name, params, batch),
                      "output": str(tmp / f"{name}_out.npz")})
        refs[mode] = (loss, grads, cases[-1]["output"])
    _spawn(tmp, 8, cases)
    return refs


def _check(loss, grads, output):
    got = np.load(output)
    assert abs(float(got["loss"]) - loss) <= LOSS_RTOL * abs(loss), (float(got["loss"]), loss)
    assert {k[5:] for k in got.files if k.startswith("grad/")} == {"/".join(p) for p in grads}
    for path, want in grads.items():
        g = got["grad/" + "/".join(path)]
        assert g.shape == want.shape, path
        err = np.abs(g - want).max() / max(np.abs(want).max(), 1e-12)
        assert err <= GRAD_RTOL, (path, err)
    return got


@pytest.mark.parametrize("arch,model", LOSS_CASES)
def test_mesh_loss_and_grads_match_jax(world4, arch, model):
    _check(*world4[(arch, model)])


@pytest.mark.parametrize("mode", ["head_dim", "pad"])
def test_starcoder2_tp8_modes_match_jax(world8, mode):
    got = _check(*world8[mode])
    other = np.load(world8["pad" if mode == "head_dim" else "head_dim"][2])
    assert abs(float(got["loss"]) - float(other["loss"])) <= LOSS_RTOL * abs(float(got["loss"]))


@pytest.mark.parametrize("factored", STEP_CASES)
def test_mesh_adamw_step_equals_no_mesh_step(world4, factored):
    got = np.load(world4[("step", factored)])
    got_init = {"/".join(p): a for p, a in _flat(_reference("internlm2-1.8b", "head_dim")[0])}
    assert abs(float(got["mesh_loss"]) - float(got["none_loss"])) <= 1e-6 * abs(
        float(got["none_loss"]))
    assert abs(float(got["mesh_gnorm"]) - float(got["none_gnorm"])) <= 1e-5 * float(
        got["none_gnorm"])
    names = [k[5:] for k in got.files if k.startswith("mesh/")]
    assert names and sorted(names) == sorted(k[5:] for k in got.files if k.startswith("none/"))
    moved = 0
    for n in names:
        a, b = got["mesh/" + n], got["none/" + n]
        # Adam moves a weight by ~lr whatever its gradient's size, so a
        # gradient of ~1e-9 whose sign fp32 sums in another order flip
        # moves it by up to 2 lr a step: a few such weights a leaf, and the
        # rest within 1e-3 lr
        off = np.abs(a - b) > 1e-3 * STEP_LR
        assert off.sum() <= max(4, 1e-3 * a.size), (n, int(off.sum()))
        assert np.abs(a - b).max() <= 4 * STEP_LR, n
        moved += n in got_init and not np.array_equal(b, got_init[n])
    assert moved == len(names)  # the steps moved every leaf


def test_seq_sharded_decode_equals_no_mesh_decode(world4):
    got = np.load(world4["decode"])
    a, b = got["mesh_logits"], got["none_logits"]
    assert a.shape == b.shape == (DECODE_STEPS, 1, a.shape[-1])
    real = np.abs(b) < 1e29  # the padded vocabulary's entries are -1e30
    assert np.array_equal(real, np.abs(a) < 1e29)
    assert np.abs(a - b)[real].max() <= 1e-5 * np.abs(b[real]).max()
    # rank 0 holds positions 0-5: the last step's query sees all 6 of them,
    # 4 hd flops a pair over its 2 of tp 2's query heads in every layer
    cfg = ref_configs.get_smoke_config("internlm2-1.8b")
    want = cfg.n_layers * 4.0 * cfg.hd * (cfg.n_heads // 2) * (DECODE_STEPS // 2)
    assert float(got["flash_flops"]) == want


@pytest.mark.parametrize("groups,model", GROUP_CASES)
def test_mamba2_groups_over_tp_match_jax(world4, groups, model):
    """mamba2-smoke with more than one B/C group on tp 2 and tp 4: the
    loss and every gradient leaf (wB and wC's summed over tp) against
    ``jax.grad`` without a mesh."""
    _check(*world4[("groups", groups, model)])


def _jax_decode(arch, params, tokens, n):
    """The reference's logits of n decode steps of ``tokens`` [1, n]
    without a mesh: [n, 1, vocab_padded]."""
    import jax.numpy as jnp

    model = ref_build(_ref_cfg(arch), single_device_ctx())
    struct, _ = model.cache_struct(1, n)
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), struct)
    step, out = jax.jit(model.decode_step), []
    for pos in range(n):
        cache, lg = step(params, cache, jnp.asarray(tokens[:, pos]), jnp.int32(pos))
        out.append(np.asarray(lg))
    return np.stack(out)


@pytest.mark.parametrize("model", ZAMBA_DECODE)
def test_zamba2_seq_sharded_decode_matches_jax(world4, model):
    """zamba2-smoke's decode at batch 1 with the shared block's cache
    positions sharded over dp 4 (3 a rank) or dp 2 x tp 2 (6 a rank),
    every rank merging its (o, lse) over dp, against JAX's decode without
    a mesh on the same weights: every real logit within 1e-5 of the
    largest, over 12 steps, in the first of which ranks see no key.  Rank
    0's attention in the last step is counted at the flash kernel's
    formula at its local position: 4 hd flops a pair over its keys and
    heads."""
    params, batch, _, _ = _reference("zamba2-7b", "head_dim")
    got = np.load(world4[("zamba2 decode", model)])
    want = _jax_decode("zamba2-7b", params, batch["tokens"][:1], DECODE_STEPS)
    a = got["mesh_logits"]
    assert a.shape == want.shape == (DECODE_STEPS, 1, a.shape[-1])
    real = np.abs(want) < 1e29  # the padded vocabulary's entries are -1e30
    assert np.array_equal(real, np.abs(a) < 1e29)
    assert np.abs(a - want)[real].max() <= 1e-5 * np.abs(want[real]).max()
    cfg = ref_configs.get_smoke_config("zamba2-7b")
    keys = DECODE_STEPS // (4 // model)  # rank 0 holds positions 0..keys-1
    apps = cfg.n_layers // cfg.hybrid_every
    # its 4 heads over 4 KV heads shard over tp ("heads" mode): n_heads / tp a rank
    assert float(got["flash_flops"]) == apps * 4.0 * cfg.hd * (cfg.n_heads // model) * keys


def _files(directory):
    from repro_torch.train import latest_checkpoint

    path = latest_checkpoint(directory)
    return path, {f.name: np.load(f) for f in path.glob("*.npy")}


@pytest.mark.parametrize("factored", STEP_CASES)
def test_mesh_checkpoint_round_trip(world4, factored):
    """internlm2-smoke on dp 2 x tp 2: a mesh checkpoint (each leaf
    gathered whole, rank 0 writing) resumed into a fresh mesh state gives
    the second step's state bit for bit; restored without a mesh and saved
    again, and restored from that onto the mesh, it keeps its files bit for
    bit; the reference's ``restore_checkpoint`` reads it into its
    ``TrainState``."""
    from repro.train import optimizer as ref_opt
    from repro.train.checkpoint import restore_checkpoint as ref_restore
    from repro.train.train_loop import TrainStepBuilder as RefBuilder

    root, output = world4[("ckpt", factored)]
    got = np.load(output)
    assert float(got["resumed_loss"]) == float(got["direct_loss"])
    a_path, a = _files(root / "a")
    d_path, direct = _files(root / "direct")
    assert a_path.name == "step_00000001" and d_path.name == "step_00000002"
    assert any(n.startswith("opt__v__") and n.endswith(("__r.npy", "__c.npy"))
               for n in a) == factored
    for other in ("resumed",):
        _, files = _files(root / other)
        assert sorted(files) == sorted(direct)
        assert all(np.array_equal(files[n], direct[n]) for n in direct), other
    for other in ("plain", "back"):
        path, files = _files(root / other)
        assert path.name == a_path.name and sorted(files) == sorted(a)
        assert all(np.array_equal(files[n], a[n]) for n in a), other
    assert not all(np.array_equal(a[n], direct[n]) for n in a)  # the step moved the state
    ref = ref_build(_ref_cfg("internlm2-1.8b"), single_device_ctx())
    like = RefBuilder(ref, ref_opt.AdamWConfig(lr=1e-2, warmup_steps=1, factored_v=factored)
                      ).init_state(jax.random.key(0))
    restored, at = ref_restore(a_path, like)
    assert at == 1 and int(restored.step) == 1
    for path, arr in _flat(restored.params):
        assert np.array_equal(arr, a["params__" + "__".join(path) + ".npy"]), path


def test_seq_sharded_decode_reaches_the_decode_route(monkeypatch):
    """On fake card tensors (nothing launched) rank (data 1, model 0) of
    a 2 x 2 mesh takes its part of the sequence-sharded decode on the
    flash kernel's decode route with the logsumexp, [B, H, lse_stride(1)],
    counted at flash's formula at its local position (pos - 6), and merges
    it by one max and two sum reductions over dp; at a position before its
    shard it launches nothing and still takes part in the reductions."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch import sharding as sh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.models import layers

    class Mesh:  # the rank's coordinates and group names; nothing runs
        mesh_dim_names, shape = ("data", "model"), (2, 2)

        def get_local_rank(self, axis):
            return {"data": 1, "model": 0}[axis]

        def get_group(self, axis):
            return axis

    cfg = dataclasses.replace(configs.get_smoke_config("zamba2-7b"), head_dim=64)
    ctx = sh.MeshContext(mesh=Mesh(), dp=("data",), tp="model")
    reduced, launched = [], []
    monkeypatch.setattr(sh, "all_reduce", lambda x, grp, op="sum": reduced.append((grp, op)) or x)
    real = fa._launch

    def spy(q, k, v, *args, **kw):
        out = real(q, k, v, *args, **kw)
        launched.append((fa.route(q.dtype, q.shape[2], q.shape[3]), args[4],
                         tuple(out[1].shape)))
        return out

    monkeypatch.setattr(fa, "_launch", spy)
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    with FakeTensorMode():
        q = torch.empty(1, 1, h, d, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(1, 6, kv, d, device="cuda", dtype=torch.bfloat16)
        with OpCounter() as counter:
            o = layers._seq_sharded_decode(q, k, k, 9, cfg, None, ctx)
        assert launched == [("decode", 3, (1, h, fa.lse_stride(1)))]
        assert o.shape == (1, h, 1, d) and o.dtype == torch.bfloat16 and o.device.type == "cuda"
        assert counter.kernels["flash_attention"]["flops"] == 4.0 * d * h * 4
        assert reduced == [("data", "max"), ("data", "sum"), ("data", "sum")]
        o = layers._seq_sharded_decode(q, k, k, 3, cfg, None, ctx)
        assert len(launched) == 1 and len(reduced) == 6 and o.shape == (1, h, 1, d)
