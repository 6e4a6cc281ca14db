"""The port's checkpoints and fault tolerance against the reference's, on
the CPU.

  * ``save_checkpoint`` / ``restore_checkpoint`` round-trip a nested
    mapping of tensors (a GraphSAGE ``state_dict`` beside optimizer-like
    leaves) exactly, in fp32 and bf16, onto ``like``'s dtypes;
  * the on-disk layout is the reference's: a checkpoint the reference
    writes from a nested dict of arrays is restored by the port to the
    same values, and the reverse; shapes are validated;
  * ``latest_checkpoint`` ignores a directory without a manifest;
  * ``FailureController.on_failure`` (and ``on_join``) give the
    reference's re-plan on ``tests/test_dynamics.py``'s failure case,
    ``restore`` gives the latest checkpoint back, ``rescale_plan`` the
    reference's search, and ``StragglerPolicy`` flags what the
    reference's flags.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

from repro.core import heterogeneous_cluster, ifs_placement
from repro.core.cluster import Machine as RefMachine
from repro.core.cluster import ClusterSpec as RefCluster
from repro.train import checkpoint as ref_ckpt
from repro.train import fault_tolerance as ref_ft
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL
from repro_torch.models.gnn import GraphSAGE, GraphSAGEConfig
from repro_torch.train import (
    FailureController,
    StragglerPolicy,
    latest_checkpoint,
    rescale_plan,
    restore_checkpoint,
    save_checkpoint,
)

from test_dynamics import replan_job


def _close(a, b):
    return bool(np.isclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL))


def _state(dtype, seed=0):
    """A small GraphSAGE's state beside optimizer-like leaves."""
    model = GraphSAGE(GraphSAGEConfig(in_dim=12, hidden=16, n_classes=5, n_layers=2),
                      device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    params = {k: v.to(dtype) for k, v in model.state_dict().items()}
    return {
        "model": params,
        "opt": {"step": torch.tensor(7, dtype=torch.int64),
                "mu": [torch.randn(3, 4, generator=gen).to(dtype),
                       torch.randn(5, generator=gen).to(dtype)]},
        "rng": torch.arange(6, dtype=torch.int32).reshape(2, 3),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else
            [torch.zeros_like(x) for x in v] if isinstance(v, list) else
            torch.zeros_like(v) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_checkpoint_round_trips_exactly(tmp_path, dtype):
    state = _state(dtype)
    path = save_checkpoint(tmp_path, state, step=3)
    assert path.name == "step_00000003" and latest_checkpoint(tmp_path) == path
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["step"] == 3
    want_dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert manifest["entries"]["opt__mu__0"] == {"shape": [3, 4], "dtype": want_dtype}
    assert manifest["entries"]["opt__step"] == {"shape": [], "dtype": "int64"}
    if dtype == torch.bfloat16:
        assert np.load(path / "opt__mu__1.npy").dtype == np.uint16
    got, step = restore_checkpoint(path, _zeros_like(state))
    assert step == 3
    want, have = _flat(state), _flat(got)
    assert want.keys() == have.keys()
    for k, v in want.items():
        assert have[k].dtype == v.dtype and have[k].device == v.device, k
        assert torch.equal(have[k], v), k
    # the model takes its state back
    model = GraphSAGE(GraphSAGEConfig(in_dim=12, hidden=16, n_classes=5, n_layers=2),
                      device="cpu", seed=5)
    model.load_state_dict({k: v.float() for k, v in got["model"].items()})
    for k, v in model.state_dict().items():
        assert torch.equal(v, state["model"][k].float()), k


def _ref_tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                   "b": rng.standard_normal(3).astype(ml_dtypes.bfloat16)},
        "layers": [{"k": rng.standard_normal((2, 2)).astype(np.float32)},
                   {"k": rng.standard_normal((2, 2)).astype(np.float32)}],
        "step": np.array(11, dtype=np.int64),
    }


def _torch_like(tree):
    if isinstance(tree, dict):
        return {k: _torch_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_like(v) for v in tree]
    dt = torch.bfloat16 if tree.dtype == ml_dtypes.bfloat16 else torch.from_numpy(
        np.zeros(0, tree.dtype)).dtype
    return torch.zeros(tree.shape, dtype=dt)


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _ref_tree()
    path = ref_ckpt.save_checkpoint(tmp_path, tree, step=5)
    got, step = restore_checkpoint(path, _torch_like(tree))
    assert step == 5
    want, have = _flat(tree), _flat(got)
    assert want.keys() == have.keys()
    for k, v in want.items():
        h = _as_numpy(have[k])
        assert h.dtype == v.dtype and h.tobytes() == v.tobytes(), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _ref_tree()
    path = save_checkpoint(tmp_path, _torch_from_numpy(tree), step=9)
    got, step = ref_ckpt.restore_checkpoint(path, tree)
    assert step == 9
    want, have = _flat(tree), _flat(got)
    for k, v in want.items():
        h = np.asarray(have[k])
        if v.dtype.kind == "i":  # the reference's JAX arrays run without x64
            assert np.array_equal(h, v), k
        else:
            assert h.dtype == v.dtype and h.tobytes() == v.tobytes(), k
    # numpy leaves are saved as the reference saves them, file for file
    np_path = save_checkpoint(tmp_path / "np", tree, step=9)
    ref_path = ref_ckpt.save_checkpoint(tmp_path / "ref", tree, step=9)
    for q in (path, np_path):
        assert json.loads((q / "manifest.json").read_text()) == json.loads(
            (ref_path / "manifest.json").read_text())
        for name in want:
            f = name.rstrip("/").replace("/", "__") + ".npy"
            assert (q / f).read_bytes() == (ref_path / f).read_bytes(), (q, f)


def _torch_from_numpy(tree):
    if isinstance(tree, dict):
        return {k: _torch_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_from_numpy(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def test_latest_checkpoint_skips_partial_writes_and_shapes_are_checked(tmp_path):
    assert latest_checkpoint(tmp_path / "missing") is None
    state = {"a": torch.ones(2, 3)}
    save_checkpoint(tmp_path, state, step=1)
    p2 = save_checkpoint(tmp_path, {"a": 2 * torch.ones(2, 3)}, step=2)
    (tmp_path / "step_00000009").mkdir()  # no manifest: a partial write
    (tmp_path / "step_00000009" / "a.npy").write_bytes(b"")
    assert latest_checkpoint(tmp_path) == p2
    assert latest_checkpoint(tmp_path) == ref_ckpt.latest_checkpoint(tmp_path)
    got, step = restore_checkpoint(latest_checkpoint(tmp_path), {"a": torch.zeros(2, 3)})
    assert step == 2 and torch.equal(got["a"], 2 * torch.ones(2, 3))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(p2, {"a": torch.zeros(3, 2)})
    # the same step again replaces the checkpoint
    save_checkpoint(tmp_path, {"a": 5 * torch.ones(2, 3)}, step=2)
    got, _ = restore_checkpoint(p2, {"a": torch.zeros(2, 3)})
    assert torch.equal(got["a"], 5 * torch.ones(2, 3))


def _same_etp(want, got):
    assert np.array_equal(want.placement.y, got.placement.y)
    assert _close(want.best_makespan, got.best_makespan)
    assert (want.evaluations, want.accepted, want.proposals) == (
        got.evaluations, got.accepted, got.proposals)


def test_failure_controller_matches_reference(tmp_path):
    """``tests/test_dynamics.py``'s case (its budget 50 cut to 16 for the
    CPU's time): machine 2 of 5 fails, then a machine joins, through the
    controller's one re-planner."""
    wl = replan_job()
    cluster = heterogeneous_cluster(5, seed=7)
    p0 = ifs_placement(wl, cluster, seed=0)
    want = ref_ft.FailureController(wl, cluster, p0.copy(), ckpt_dir=str(tmp_path / "r"),
                                    replan_budget=16)
    got = FailureController(from_reference(wl), from_reference(cluster),
                            from_reference(p0), ckpt_dir=str(tmp_path / "p"),
                            replan_budget=16, device="cpu")
    wc, wp, wres = want.on_failure(machine=2, seed=0)
    gc, gp, gres = got.on_failure(machine=2, seed=0)
    assert gc.M == wc.M == cluster.M - 1
    assert np.array_equal(gc.bw_in, wc.bw_in) and np.array_equal(gc.bw_out, wc.bw_out)
    assert [m.name for m in gc.machines] == [m.name for m in wc.machines]
    assert np.array_equal(gp.y, wp.y)
    _same_etp(wres, gres)
    assert got.failures == [2] and got.replanner(0).config.device == "cpu"
    assert [r.trigger for r in got.replanner(0).records] == ["leave"]
    a, b = want.last_record, got.last_record
    assert (a.moved_tasks, len(a.flows)) == (b.moved_tasks, len(b.flows))
    for k in ("forced_gb", "migration_gb", "makespan", "overlap_s", "objective"):
        assert _close(getattr(a, k), getattr(b, k)), k
    joiner = RefMachine("m-join", {"mem": 48.0, "cpu": 16.0, "gpu": 2.0}, 6.25, 6.25)
    wc, wp, wres = want.on_join(joiner, seed=1)
    gc, gp, gres = got.on_join(
        from_reference(RefCluster(machines=[joiner])).machines[0], seed=1)
    assert gc.M == wc.M == cluster.M and np.array_equal(gp.y, wp.y)
    _same_etp(wres, gres)
    assert [r.trigger for r in got.replanner(1).records] == ["leave", "join"]


def test_failure_controller_restores_the_latest_checkpoint(tmp_path):
    wl = replan_job(n_iters=4)
    cluster = heterogeneous_cluster(4, seed=7)
    p0 = ifs_placement(wl, cluster, seed=0)
    fc = FailureController(from_reference(wl), from_reference(cluster),
                           from_reference(p0), ckpt_dir=str(tmp_path), device="cpu")
    like = {"w": torch.zeros(3, 2)}
    assert fc.restore(like) == (like, 0)
    save_checkpoint(tmp_path, {"w": torch.ones(3, 2)}, step=4)
    save_checkpoint(tmp_path, {"w": 2 * torch.ones(3, 2)}, step=12)
    state, step = fc.restore(like)
    assert step == 12 and torch.equal(state["w"], 2 * torch.ones(3, 2))


def test_rescale_plan_matches_reference():
    wl = replan_job(n_iters=6)
    cluster = heterogeneous_cluster(4, seed=3)
    want = ref_ft.rescale_plan(wl, cluster, budget=6, seed=1)
    got = rescale_plan(from_reference(wl), from_reference(cluster), budget=6, seed=1,
                       device="cpu")
    _same_etp(want, got)
    with pytest.raises(RuntimeError, match="cuda"):
        rescale_plan(from_reference(wl), from_reference(cluster), budget=2)


def test_straggler_policy_matches_reference():
    """``tests/test_train_infra.py``'s check, and the same flags as the
    reference's policy over a noisy stream with outliers."""
    pol = StragglerPolicy(window=20, k_mad=4.0)
    flagged = [pol.observe(1.0 + 0.01 * (i % 3)) for i in range(15)]
    assert not any(flagged)
    assert pol.observe(3.0)
    rng = np.random.default_rng(0)
    times = 1.0 + 0.05 * rng.standard_normal(200)
    times[[30, 77, 78, 150]] = (4.0, 2.5, 2.6, 9.0)
    want, got = ref_ft.StragglerPolicy(window=30), StragglerPolicy(window=30)
    flags = [got.observe(float(t)) for t in times]
    assert flags == [want.observe(float(t)) for t in times]
    assert sum(flags) >= 3 and len(got.history) == 30
