"""Torch engine regimes on the CPU: traces, migration flows, class shaping,
utilization aggregates and the flow log, against the numpy and JAX engines.

The contract is the JAX engine's: makespans and task-start matrices equal
the numpy engine's at ``PARITY_RTOL`` / ``PARITY_ATOL``.  Covered:

  * the ``dynamic``, ``migration`` and ``priority`` golden cells of
    ``tests/golden/golden_schedules.json`` for all five policies, against
    the pinned JSON and numpy ``simulate_batch``;
  * a width-4 batch with different migration flows per instance (one
    ``None``) and finite deadlines, in strict and deadline mode, against
    numpy and ``simulate_batch_jax`` (also with the Pallas waterfill in
    interpret mode);
  * ``utilization=True`` aggregates against the JAX engine's and against
    the numpy schedule trace's, as ``tests/test_obs.py`` holds the JAX
    engine;
  * ``flow_log`` against numpy's, as a map (edge, iter) -> (start, end);
  * a trace over the wrong machine count raises; the static program is
    the same, bit for bit, whatever inert regime arguments it is given.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import MigrationFlow as RefFlow
from repro.core import ifs_placement, simulate_batch
from repro.core.engine_jax import simulate_batch_jax
from repro.dynamics import constant_trace
from repro.obs.trace import ScheduleTrace
from repro_torch.convert import from_reference
from repro_torch.core import PARITY_ATOL, PARITY_RTOL, simulate_batch_torch
from repro_torch.core import engine_torch

from test_golden_schedules import GOLDEN_PATH, JOBS, POLICIES, _cases

REGIMES = ("dynamic", "migration", "priority")
# (shaping, policy) -> the instances of ``hetero_case`` where
# simulate_batch_jax differs from numpy beyond PARITY_RTOL (ROADMAP Queue 3)
JAX_OFF_NUMPY = {("deadline", "omcoflow"): [3]}
CASES = {(n, r): rest for n, r, *rest in _cases()}


def _close(a, b):
    return np.isclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL)


def _same_schedule(wl, n_iters, ref, got):
    return bool(_close(ref.makespan, got.makespan)) and np.allclose(
        ref.task_start_matrix(wl.J, n_iters), got.task_start_matrix(wl.J, n_iters),
        rtol=PARITY_RTOL, atol=PARITY_ATOL, equal_nan=True,
    )


def _flows(migs):
    return None if migs is None else [from_reference(f) for f in migs]


def _torch(wl, cluster, placements, reals, policy, *, trace=None, migrations=None,
           **kw):
    return simulate_batch_torch(
        from_reference(wl), from_reference(cluster),
        [from_reference(p) for p in placements],
        [from_reference(r) for r in reals], policy=policy,
        trace=None if trace is None else from_reference(trace),
        migrations=None if migrations is None else [_flows(m) for m in migrations],
        device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN_PATH.read_text())


@pytest.mark.parametrize("name,regime", [(n, r) for n in JOBS for r in REGIMES])
def test_golden_regime_torch(golden, name, regime):
    """The cell under its trace, flows and shaping, all five policies:
    the torch engine against the pinned schedule and numpy's batch engine."""
    wl, cluster, placement, realization, trace, flows, shaping = CASES[(name, regime)]
    N = realization.n_iters
    for policy in POLICIES:
        kw = dict(record=True, trace=trace, shaping=shaping,
                  migrations=None if flows is None else [flows])
        got = _torch(wl, cluster, [placement], [realization], policy, **kw)[0]
        ref = simulate_batch(wl, cluster, [placement], [realization],
                             policy=policy, backend="numpy", **kw)[0]
        pinned = golden[name][regime][policy]
        assert _close(got.makespan, pinned["makespan"]), (policy, got.makespan)
        assert np.allclose(got.task_start_matrix(wl.J, N),
                           np.array(pinned["task_start"]),
                           rtol=PARITY_RTOL, atol=PARITY_ATOL), policy
        assert _same_schedule(wl, N, ref, got), policy
        shaped = policy if shaping is None else f"{policy}+{shaping}"
        assert got.policy == ref.policy == shaped


@pytest.fixture(scope="module")
def hetero_case():
    """Width 4 on the fanin job under its trace: the golden flows, no
    flows, one flow, and three other flows with finite deadlines."""
    wl, cluster, placement, _, trace, _, _ = CASES[("fanin", "priority")]
    flows = CASES[("fanin", "priority")][5]
    placements = [placement, ifs_placement(wl, cluster, seed=1), placement,
                  ifs_placement(wl, cluster, seed=2)]
    reals = [wl.realize(seed=s) for s in range(4)]
    migs = [
        flows,
        None,
        flows[:1],
        [dataclasses.replace(flows[1], deadline=1.0), flows[2],
         RefFlow(src=2, dst=0, gb=0.7, task=3, deadline=2.0)],
    ]
    return wl, cluster, placements, reals, trace, migs


@pytest.mark.parametrize("shaping", ("strict", "deadline"))
@pytest.mark.parametrize("policy", POLICIES)
def test_heterogeneous_flows_match_numpy_and_jax(hetero_case, shaping, policy):
    wl, cluster, placements, reals, trace, migs = hetero_case
    kw = dict(record=True, trace=trace, migrations=migs, shaping=shaping)
    ref = simulate_batch(wl, cluster, placements, reals, policy=policy,
                         backend="numpy", **kw)
    ref_jax = simulate_batch_jax(wl, cluster, placements, reals, policy=policy, **kw)
    got = _torch(wl, cluster, placements, reals, policy, **kw)
    jax_off = []
    for b in range(4):
        assert _same_schedule(wl, 4, ref[b], got[b]), b
        if _same_schedule(wl, 4, ref[b], ref_jax[b]):
            assert _same_schedule(wl, 4, ref_jax[b], got[b]), b
        else:
            jax_off.append(b)
    # the one instance where the JAX engine itself leaves numpy's schedule
    # (a migration flow lands exactly at its deadline, t = 1.0, and JAX's
    # run escalates differently); the port follows numpy there
    assert jax_off == JAX_OFF_NUMPY.get((shaping, policy), [])


def test_pallas_waterfill_reference(hetero_case, monkeypatch):
    """fifo under deadline shaping against the JAX engine running the
    Pallas waterfill kernel in interpret mode."""
    monkeypatch.setenv("REPRO_WATERFILL_PALLAS", "1")
    wl, cluster, placements, reals, trace, migs = hetero_case
    kw = dict(record=True, trace=trace, migrations=migs, shaping="deadline")
    ref_jax = simulate_batch_jax(wl, cluster, placements, reals, policy="fifo", **kw)
    got = _torch(wl, cluster, placements, reals, "fifo", **kw)
    for b in range(4):
        assert _same_schedule(wl, 4, ref_jax[b], got[b]), b


@pytest.mark.parametrize("regime", ("migration", "priority"))
@pytest.mark.parametrize("policy", POLICIES)
def test_utilization_aggregates(regime, policy):
    """The in-program integrals against the JAX engine's at PARITY_RTOL
    and against the numpy schedule trace's post-hoc aggregates."""
    wl, cluster, placement, r, trace, flows, shaping = CASES[("fanin", regime)]
    kw = dict(trace=trace, migrations=[flows], shaping=shaping, utilization=True)
    got = _torch(wl, cluster, [placement], [r], policy, **kw)[0].aggregates
    want_jax = simulate_batch_jax(wl, cluster, [placement], [r], policy=policy,
                                  **kw)[0].aggregates
    res = simulate_batch(wl, cluster, [placement], [r], policy=policy, record=True,
                         trace=trace, migrations=[flows], shaping=shaping,
                         backend="numpy")[0]
    want = ScheduleTrace.from_result(
        res, wl, cluster, placement, r, trace=trace, migrations=flows,
        shaping=shaping,
    ).aggregates()
    for key in ("nic_in_gb", "nic_out_gb", "busy_s"):
        np.testing.assert_allclose(got[key], want_jax[key], rtol=PARITY_RTOL,
                                   atol=PARITY_ATOL)
    np.testing.assert_allclose(got["nic_in_gb"], want["nic_in_gb"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["nic_out_gb"], want["nic_out_gb"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got["busy_s"], want["busy_s"], rtol=1e-6, atol=1e-6)
    assert set(got["class_gb"]) == set(want_jax["class_gb"]) == {0, 1}
    for cls, gb in want["class_gb"].items():
        assert got["class_gb"][cls] == pytest.approx(gb, rel=1e-6)
        assert got["class_gb"][cls] == pytest.approx(want_jax["class_gb"][cls],
                                                     rel=PARITY_RTOL)
    plain = _torch(wl, cluster, [placement], [r], policy, trace=trace)[0]
    assert plain.aggregates is None


@pytest.mark.parametrize("regime", ("static",) + REGIMES)
def test_flow_log_matches_numpy(regime):
    """Every delivered flow instance, (edge, iter) -> (arm time, delivery
    time), as numpy records them; migration columns with iter 1, start 0."""
    for name in JOBS:
        wl, cluster, placement, r, trace, flows, shaping = CASES[(name, regime)]
        for policy in POLICIES:
            kw = dict(record=True, trace=trace, shaping=shaping,
                      migrations=None if flows is None else [flows])
            ref = simulate_batch(wl, cluster, [placement], [r], policy=policy,
                                 backend="numpy", **kw)[0]
            got = _torch(wl, cluster, [placement], [r], policy, **kw)[0]
            want = {(e, n): (s, t) for e, n, s, t in ref.flow_log}
            have = {(e, n): (s, t) for e, n, s, t in got.flow_log}
            assert len(have) == len(got.flow_log)
            assert set(have) == set(want), (name, policy)
            for k, v in want.items():
                assert np.allclose(have[k], v, rtol=PARITY_RTOL, atol=PARITY_ATOL), k
            assert [f[3] for f in got.flow_log] == sorted(f[3] for f in got.flow_log)
            for e, n, s, _ in got.flow_log:
                if e >= wl.E:
                    assert (n, s) == (1, 0.0)
    unrecorded = _torch(wl, cluster, [placement], [r], "oes", trace=trace)[0]
    assert unrecorded.flow_log is None


def test_trace_with_wrong_machine_count_raises():
    wl, cluster, placement, r, _, _, _ = CASES[("fanin", "static")]
    from repro.core import heterogeneous_cluster

    other = constant_trace(heterogeneous_cluster(4, seed=0))
    with pytest.raises(ValueError, match="trace covers 4 machines"):
        _torch(wl, cluster, [placement], [r], "oes", trace=other)


def test_bad_regime_arguments_raise():
    wl, cluster, placement, r, _, flows, _ = CASES[("fanin", "migration")]
    with pytest.raises(ValueError, match="unknown shaping mode"):
        _torch(wl, cluster, [placement], [r], "oes", shaping="fair")
    with pytest.raises(ValueError, match="one \\(possibly None\\) entry per instance"):
        _torch(wl, cluster, [placement], [r], "oes", migrations=[flows, None])
    with pytest.raises(ValueError, match="outside the 3-machine cluster"):
        _torch(wl, cluster, [placement], [r], "oes",
               migrations=[[RefFlow(src=0, dst=5, gb=1.0)]])
    with pytest.raises(ValueError, match="one class id per logical edge"):
        _torch(wl, cluster, [placement], [r], "oes", edge_classes=[0, 1])


@pytest.mark.parametrize("policy", POLICIES)
def test_static_program_unchanged_by_inert_regimes(policy):
    """``shaping=None`` with no trace and no flows builds the static
    program: no segment rows, no flow columns, no class levels.  Inert
    regime arguments (a one-segment trace, no flows in any instance,
    strict shaping over a single class, zero edge classes, the
    utilization integrals) give the same schedules bit for bit."""
    wl, cluster, placement, _, _, _, _ = CASES[("ring", "static")]
    placements = [placement, ifs_placement(wl, cluster, seed=3)]
    reals = [wl.realize(seed=s) for s in (0, 1)]
    twl, tcl = from_reference(wl), from_reference(cluster)
    ys = np.stack([p.y for p in placements])
    prog = engine_torch._build_program(
        twl, tcl, ys, [from_reference(r) for r in reals], policy, True,
        torch.device("cpu"),
    )
    assert (prog.S, prog.G, prog.mode, prog.tr_slow, prog.utilization) == (
        1, 0, None, None, False)
    plain = _torch(wl, cluster, placements, reals, policy, record=True)
    inert = _torch(wl, cluster, placements, reals, policy, record=True,
                   trace=constant_trace(cluster), migrations=[None, []],
                   shaping="strict", edge_classes=np.zeros(wl.E, dtype=np.int64),
                   utilization=True)
    for a, b in zip(plain, inert):
        assert a.makespan == b.makespan
        assert a.task_events == b.task_events
        assert a.flow_log == b.flow_log


@pytest.mark.parametrize("shaping", ("strict", "deadline"))
@pytest.mark.parametrize("policy", POLICIES)
def test_shaping_ends_when_the_flows_land(hetero_case, shaping, policy):
    """Once no migration flow is active, the program drops the shaping
    passes (one class is left); the schedule, the flow log and the
    aggregates are the same, bit for bit, as with the passes kept."""
    wl, cluster, placements, reals, trace, migs = hetero_case
    args = (from_reference(wl), from_reference(cluster),
            np.stack([p.y for p in placements]),
            [from_reference(r) for r in reals], policy, True, torch.device("cpu"))
    kw = dict(trace=from_reference(trace), migrations=[_flows(m) for m in migs],
              shaping=shaping, utilization=True)
    runs = []
    for ends in (True, False):
        prog = engine_torch._build_program(*args, **kw)
        assert prog.shaping_ends
        prog.shaping_ends = ends
        prog.run(50_000_000)
        assert (prog.mode is None) == ends
        runs.append(prog)
    a, b = runs
    for name in ("t", "start_rec", "end_rec", "arm_rec", "fin_rec", "util", "busy",
                 "clsgb"):
        assert torch.equal(getattr(a, name).nan_to_num(-1.0),
                           getattr(b, name).nan_to_num(-1.0)), name


def test_flow_log_is_built_at_first_read():
    """A recorded run hands back each instance's flow log unbuilt: its
    length is known at once, its tuples appear at the first read."""
    wl, cluster, placement, r, trace, flows, shaping = CASES[("chain", "migration")]
    got = _torch(wl, cluster, [placement], [r], "fifo", record=True, trace=trace,
                 migrations=[flows])[0].flow_log
    assert got._rows is None and len(got) > 0
    rows = list(got)
    assert got._rows is not None and len(rows) == len(got)
    assert got == rows and got[0] == rows[0] and got[-1] == rows[-1]
    assert repr(got) == repr(rows)
