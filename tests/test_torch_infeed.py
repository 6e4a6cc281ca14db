"""The port's infeed planner against the reference's, on the CPU.

  * the port's ``active_param_count()`` equals the reference's
    ``ModelConfig.active_param_count()`` for every config both packages
    run, which the sync volumes rest on;
  * ``build_infeed_cluster`` / ``build_infeed_workload`` equal the
    reference's (machines, edges, traffic arrays);
  * ``plan_infeed`` gives the reference's ``InfeedPlan`` (placement,
    shard map, summary) on ``tests/test_system.py``'s two specs (``ps``
    and ``allreduce``), at budgets cut from 150 and 100 for the CPU's
    time;
  * gradient compression shrinks the planned sync flows as
    ``tests/test_system.py`` holds it.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as ref_config
from repro.core import infeed_planner as ref
from repro_torch.configs import get_config
from repro_torch.core import PARITY_ATOL, PARITY_RTOL
from repro_torch.core import infeed_planner as port

ARCH = "internlm2-1.8b"


def _close(a, b):
    return bool(np.isclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL))


def _specs(**kw):
    return (ref.LMJobSpec(cfg=ref_config(ARCH), **kw),
            port.LMJobSpec(cfg=get_config(ARCH), **kw))


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "phi3-mini-3.8b", "starcoder2-3b",
                                  "mamba2-1.3b", "llama4-scout-17b-a16e",
                                  "kimi-k2-1t-a32b"))
def test_active_param_count_matches_reference(arch):
    assert get_config(arch).active_param_count() == ref_config(arch).active_param_count()
    assert get_config(arch).param_count() == ref_config(arch).param_count()


@pytest.mark.parametrize("sync", ("ps", "allreduce"))
def test_infeed_cluster_and_workload_match_reference(sync):
    a, b = _specs(global_batch=256, seq_len=4096, n_pods=2, sync=sync)
    ca, cb = ref.build_infeed_cluster(a), port.build_infeed_cluster(b)
    assert [dataclasses.astuple(m) for m in ca.machines] == [
        dataclasses.astuple(m) for m in cb.machines]
    wa, wb = ref.build_infeed_workload(a), port.build_infeed_workload(b)
    assert [dataclasses.astuple(e) for e in wa.edges] == [
        dataclasses.astuple(e) for e in wb.edges]
    assert [(t.name, t.kind, t.demand) for t in wa.tasks] == [
        (t.name, t.kind, t.demand) for t in wb.tasks]
    for k in ("mean_volume", "mean_exec"):
        assert np.array_equal(getattr(wa.traffic, k), getattr(wb.traffic, k)), k
    assert wa.sampler_of_worker == wb.sampler_of_worker


@pytest.mark.parametrize("sync,budget", (("ps", 12), ("allreduce", 8)))
def test_plan_infeed_matches_reference(sync, budget):
    a, b = _specs(global_batch=256, seq_len=4096, n_pods=2, sync=sync)
    want = ref.plan_infeed(a, budget=budget, seed=0)
    got = port.plan_infeed(b, budget=budget, seed=0, device="cpu")
    assert np.array_equal(got.plan.placement.y, want.plan.placement.y)
    assert got.shard_of_loader == want.shard_of_loader
    assert set(got.shard_of_loader) == set(sum(got.workload.sampler_of_worker.values(), []))
    sw, sg = want.summary(), got.summary()
    assert sw.keys() == sg.keys() and sw["delta"] == sg["delta"]
    for k in ("makespan_s", "inter_host_gb", "locality"):
        assert _close(sw[k], sg[k]), k
    assert np.isfinite(got.makespan) and got.makespan > 0
    with pytest.raises(RuntimeError, match="cuda"):
        port.plan_infeed(b, budget=2, seed=0)  # no card here, and no fallback


def test_compression_shrinks_planned_sync_flows():
    kw = dict(global_batch=64, seq_len=1024, n_pods=2)
    _, base = _specs(**kw)
    _, comp = _specs(compression_ratio=0.25, **kw)
    wb, wc = port.build_infeed_workload(base), port.build_infeed_workload(comp)
    gb = sum(v for e, v in zip(wb.edges, wb.traffic.mean_volume) if e.kind == "w2p")
    gc = sum(v for e, v in zip(wc.edges, wc.traffic.mean_volume) if e.kind == "w2p")
    assert gc < gb * 0.3
    ref_comp = ref.build_infeed_workload(_specs(compression_ratio=0.25, **kw)[0])
    assert np.array_equal(ref_comp.traffic.mean_volume, wc.traffic.mean_volume)
