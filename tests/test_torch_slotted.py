"""The port's slotted OES oracle (Alg. 1) against the reference's, and the
torch engine against it, on the CPU.

  * ``simulate_slotted`` equals the reference's slot for slot (the
    makespan in slots and every ``(task, iter)`` start slot) on
    ``tests/test_oes.py``'s tiny job, and on the reference tests' jobs
    with a bandwidth trace, migration flows, and strict and deadline
    shaping;
  * the torch engine's ``oes_strict`` makespan agrees with the port's
    oracle within the reference tests' discretisation bounds (0.35 at
    slot 0.25, 0.1 at slot 0.05), tightening as the slot shrinks;
  * the oracle refuses what the reference's refuses.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import heterogeneous_cluster, ifs_placement
from repro.core import simulate_slotted as ref_slotted
from repro.dynamics import DynamicsEvent, trace_from_events
from repro_torch.convert import from_reference
from repro_torch.core import MigrationFlow, simulate_slotted, simulate_torch

from test_dynamics import _mig_flows, small_job
from test_oes import tiny_job
from test_traffic_classes import _gated_flows

SLOTS = ((0.25, 0.35), (0.05, 0.1))


def _tiny():
    wl = tiny_job(n_iters=4)
    cluster = heterogeneous_cluster(3, seed=4)
    return wl, cluster, ifs_placement(wl, cluster, seed=0), wl.realize(seed=2)


def _small(seed=4, r_seed=2):
    wl = small_job(seed=seed)
    cluster = heterogeneous_cluster(3, seed=seed)
    return wl, cluster, ifs_placement(wl, cluster, seed=0), wl.realize(seed=r_seed)


def _dip(cluster):
    return trace_from_events(cluster, [DynamicsEvent(t0=2.0, t1=6.0, machine=0,
                                                     bw_scale=0.5)])


def _case(name):
    """(workload, cluster, placement, realization, regime kwargs) of the
    reference tests' slot->0 checks."""
    if name == "tiny":
        return (*_tiny(), {})
    if name == "trace":
        wl, cluster, p, r = _small()
        tr = trace_from_events(cluster, [
            DynamicsEvent(t0=2.0, t1=6.0, machine=0, bw_scale=0.4, slowdown=1.5),
            DynamicsEvent(t0=4.0, machine=None, bw_scale=0.7),
        ])
        return wl, cluster, p, r, {"trace": tr}
    if name in ("migrations", "migrations_trace"):
        wl, cluster, p, r = _small()
        kw = {"migrations": _mig_flows(wl, p, cluster.M)}
        if name == "migrations_trace":
            kw["trace"] = _dip(cluster)
        return wl, cluster, p, r, kw
    mode, _, traced = name.partition("_")
    wl, cluster, p, r = _small(seed=0, r_seed=2)
    kw = {"migrations": _gated_flows(wl, p, cluster.M, deadline=1.0), "shaping": mode}
    if traced:
        kw["trace"] = _dip(cluster)
    return wl, cluster, p, r, kw


CASES = ("tiny", "trace", "migrations", "migrations_trace", "strict", "strict_trace",
         "deadline", "deadline_trace")


def _port_kw(kw):
    out = dict(kw)
    if "trace" in kw:
        out["trace"] = from_reference(kw["trace"])
    if "migrations" in kw:
        out["migrations"] = [from_reference(f) for f in kw["migrations"]]
    return out


def _port(wl, cluster, p, r):
    return tuple(from_reference(x) for x in (wl, cluster, p, r))


@pytest.mark.parametrize("case", CASES)
def test_slotted_matches_reference_slot_for_slot(case):
    wl, cluster, p, r, kw = _case(case)
    args = _port(wl, cluster, p, r)
    for slot, _ in SLOTS:
        want = ref_slotted(wl, cluster, p, r, slot=slot, **kw)
        got = simulate_slotted(*args, slot=slot, **_port_kw(kw))
        assert got.makespan == want.makespan, (slot, got.makespan, want.makespan)
        assert got.task_start == want.task_start, slot
        assert len(got.task_start) == wl.J * r.n_iters


@pytest.mark.parametrize("case", CASES)
def test_torch_engine_agrees_with_slotted(case):
    """Paper Alg. 1 (slotted) == the torch engine's strict rule in the
    slot->0 limit, as tests/test_oes.py holds the numpy engine."""
    wl, cluster, p, r, kw = _case(case)
    args = _port(wl, cluster, p, r)
    pkw = _port_kw(kw)
    ev = simulate_torch(*args, policy="oes_strict", device="cpu", **pkw).makespan
    last_rel = np.inf
    for slot, tol in SLOTS:
        sl = simulate_slotted(*args, slot=slot, **pkw).makespan * slot
        assert sl == pytest.approx(ev, rel=tol), (slot, sl, ev)
        rel = abs(sl - ev) / ev
        assert rel <= last_rel + 1e-9  # converging
        last_rel = rel


def test_slotted_refuses_what_the_reference_refuses():
    wl, cluster, p, r = _port(*_tiny())
    with pytest.raises(ValueError, match="unknown shaping mode"):
        simulate_slotted(wl, cluster, p, r, shaping="aggressive")
    stale = from_reference(trace_from_events(heterogeneous_cluster(4, seed=0), []))
    with pytest.raises(ValueError, match="rebuild the trace"):
        simulate_slotted(wl, cluster, p, r, trace=stale)
    with pytest.raises(ValueError, match="outside"):
        simulate_slotted(wl, cluster, p, r, migrations=[MigrationFlow(src=0, dst=7, gb=1.0)])
    with pytest.raises(ValueError, match="edge_classes"):
        simulate_slotted(wl, cluster, p, r, edge_classes=np.zeros(wl.E + 1))
    with pytest.raises(RuntimeError, match="converge"):
        simulate_slotted(wl, cluster, p, r, slot=0.25, max_slots=3)
