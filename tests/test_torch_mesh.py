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
x tp 2; starcoder2 at tp 8 in "head_dim" and "pad" mode (its 4 query
heads over 2 KV heads divide neither); one mesh AdamW step (plain and
with a factored second moment; two steps, as the schedule's first lr is
0) against the same steps without a mesh; internlm2's decode at batch 1 on
dp 2 x tp 2 (the cache's positions sharded over dp, merged over the
ranks) against the decode without a mesh, its attention counted at the
flash kernel's formula, and the same decode refused on CUDA tensors.
The one-rank mesh on a card is a ``cuda`` test in ``test_torch_cuda.py``,
which imports no JAX.
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


def _reference(arch, mode, whole=False):
    """The reference's weights, batch, and loss and gradients: the mean of
    its jitted ``loss_fn`` over the batch's two halves (dp 2), or with
    ``whole`` over the whole batch (only the MoE load-balance loss tells
    them apart)."""
    key = (arch, mode, whole)
    if key in _CACHE:
        return _CACHE[key]
    cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype="float32",
                              attn_mode=mode)
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


def test_seq_sharded_decode_refuses_cuda_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import configs
    from repro_torch import sharding as sh
    from repro_torch.models import layers

    cfg = configs.get_smoke_config("internlm2-1.8b")
    ctx = sh.ctx_for_mesh(sh.MeshShape(("data", "model"), (2, 2)))
    with FakeTensorMode():
        q = torch.empty(1, 1, cfg.n_heads // 2, cfg.hd, device="cuda")
        k = torch.empty(1, 6, cfg.n_kv_heads // 2, cfg.hd, device="cuda")
        with pytest.raises(NotImplementedError, match="logsumexp"):
            layers._seq_sharded_decode(q, k, k, 3, cfg, None, ctx)
