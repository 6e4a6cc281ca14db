"""The port stands alone: no JAX, nothing of ``repro``, CUDA by default.

  * an AST scan of every module under ``src/repro_torch/`` and of the
    scripts ``chip_smoke.py``, ``engine_probe.py``, ``flash_ablate.py``,
    ``sage_ablate.py``, ``ssd_ablate.py``, ``profiler_probe.py``,
    ``examples/train_graphsage_torch.py``,
    ``examples/dynamic_replan_torch.py``, ``examples/arrivals_torch.py``
    and ``examples/cache_sweep_torch.py`` finds no import of ``jax`` or of
    ``repro``;
  * importing the port in a fresh interpreter leaves both out of
    ``sys.modules``;
  * an entry point called without ``device`` runs on CUDA, so with no
    card present it raises instead of falling back to the CPU (the
    planner, the engine's regimes and the re-planner with its scenario
    and example, multi-job search, the arrival service and the
    cache-aware search with their examples, GraphSAGE and its example, the LM and
    ``repro_torch.launch.serve`` on every pattern, the SSD scan and the
    grouped GEMM).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_source():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "engine_probe.py",
        ROOT / "flash_ablate.py", ROOT / "sage_ablate.py", ROOT / "ssd_ablate.py",
        ROOT / "profiler_probe.py", ROOT / "decode_bits.py",
        ROOT / "examples" / "train_graphsage_torch.py",
        ROOT / "examples" / "dynamic_replan_torch.py",
        ROOT / "examples" / "arrivals_torch.py",
        ROOT / "examples" / "cache_sweep_torch.py",
    ]
    assert len(files) > 10
    bad = [
        (str(f.relative_to(ROOT)), name)
        for f in files
        for name in _imports(f)
        if _forbidden(name)
    ]
    assert bad == []


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core\n"
        "import repro_torch.kernels.waterfill, repro_torch.kernels.sage_aggregate\n"
        "import repro_torch.data, repro_torch.models\n"
        "import repro_torch.kernels.flash_attention, repro_torch.configs\n"
        "import repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.kernels.moe_gemm\n"
        "import repro_torch.models.ssm, repro_torch.models.moe\n"
        "import repro_torch.dynamics, repro_torch.obs, repro_torch.cache\n"
        "import repro_torch.core.multijob, repro_torch.dynamics.arrivals\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_cuda(monkeypatch):
    from repro_torch.core import (
        build_gnn_workload,
        heterogeneous_cluster,
        ifs_placement,
        plan,
        resolve_device,
        simulate_torch,
    )

    wl = build_gnn_workload(
        n_stores=2, n_workers=1, samplers_per_worker=1, n_ps=1, n_iters=2,
        store_to_sampler_gb=0.5, sampler_to_worker_gb=0.3, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    p = ifs_placement(wl, cluster, seed=0)
    r = wl.realize(seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_torch(wl, cluster, p, r)
    with pytest.raises(RuntimeError, match="cuda"):
        plan(wl, cluster, realization=r, budget=2, sim_iters=2)
    # explicitly asking for the CPU works
    assert simulate_torch(wl, cluster, p, r, device="cpu").makespan > 0


def test_regimes_and_replanning_default_to_cuda(monkeypatch):
    """The engine under a trace, flows and shaping, the re-planner, the
    scenario driver and ``examples/dynamic_replan_torch.py`` run on CUDA
    unless asked for the CPU, and raise with no card."""
    import importlib.util

    from repro_torch.core import (
        MigrationFlow,
        build_gnn_workload,
        heterogeneous_cluster,
        ifs_placement,
        simulate_torch,
    )
    from repro_torch.dynamics import (
        ReplanConfig,
        Replanner,
        constant_trace,
        run_scenario,
    )

    spec = importlib.util.spec_from_file_location(
        "dynamic_replan_torch", ROOT / "examples" / "dynamic_replan_torch.py"
    )
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    wl = build_gnn_workload(
        n_stores=2, n_workers=1, samplers_per_worker=1, n_ps=1, n_iters=2,
        store_to_sampler_gb=0.5, sampler_to_worker_gb=0.3, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    p = ifs_placement(wl, cluster, seed=0)
    r = wl.realize(seed=0)
    regimes = dict(trace=constant_trace(cluster), shaping="deadline",
                   migrations=[MigrationFlow(src=0, dst=1, gb=0.5, task=0,
                                             deadline=0.1)],
                   utilization=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_torch(wl, cluster, p, r, **regimes)
    with pytest.raises(RuntimeError, match="cuda"):
        Replanner(wl, cluster, p, config=ReplanConfig(budget=2, sim_iters=2)).replan()
    with pytest.raises(RuntimeError, match="cuda"):
        run_scenario(wl, cluster, constant_trace(cluster), strategy="static",
                     n_intervals=1, iters_per_interval=2)
    with pytest.raises(RuntimeError, match="cuda"):
        example.main([])
    # explicitly asking for the CPU works
    assert simulate_torch(wl, cluster, p, r, device="cpu", **regimes).makespan > 0


def test_tenants_and_cache_default_to_cuda(monkeypatch):
    """``joint_search``, ``run_service``, the ordering baselines,
    ``cache_aware_etp`` and the two walkthroughs
    (``examples/arrivals_torch.py``, ``examples/cache_sweep_torch.py``)
    run on CUDA unless asked for the CPU, and raise with no card."""
    import importlib.util

    from repro_torch.cache import (
        CacheConfig,
        build_hit_model,
        cache_aware_etp,
        collect_trace,
    )
    from repro_torch.core import build_gnn_workload, heterogeneous_cluster
    from repro_torch.core.multijob import joint_search
    from repro_torch.data import synthetic_graph
    from repro_torch.dynamics import (
        JobArrival,
        ServiceConfig,
        run_ordering_baseline,
        run_service,
    )

    examples = []
    for name in ("arrivals_torch", "cache_sweep_torch"):
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        examples.append(mod)
    wl = build_gnn_workload(
        n_stores=2, n_workers=1, samplers_per_worker=2, n_ps=1, n_iters=2,
        store_to_sampler_gb=0.5, sampler_to_worker_gb=0.3, grad_gb=0.2,
        store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
        ps_exec_s=0.2,
    )
    cluster = heterogeneous_cluster(3, seed=0)
    trace = collect_trace(synthetic_graph(n_nodes=200, avg_degree=4, n_feats=4,
                                          n_parts=2, seed=0),
                          n_samplers=2, seeds_per_iter=4, fanouts=(2,), n_iters=2)
    model = build_hit_model(trace, capacity_nodes=20)
    stream = [JobArrival("a", 0.0, wl, deadline_s=1e9)]
    kw = dict(n_chains=1, budget=1, sim_iters=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        joint_search([wl, wl], cluster, **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        run_service(stream, cluster, ServiceConfig(replan=False))
    with pytest.raises(RuntimeError, match="cuda"):
        run_ordering_baseline(stream, cluster, "edf")
    with pytest.raises(RuntimeError, match="cuda"):
        cache_aware_etp(wl, cluster, model, CacheConfig(), **kw)
    for mod in examples:
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])
    # explicitly asking for the CPU works
    out = run_service(stream, cluster, ServiceConfig(replan=False, device="cpu"))
    assert out.report.deadlines_met == 1
    assert cache_aware_etp(wl, cluster, model, CacheConfig(), device="cpu",
                           **kw).best_makespan > 0


def test_graphsage_defaults_to_cuda(monkeypatch):
    """The model, the batch loader and the example run on CUDA unless asked
    for the CPU; without a card they raise.  The aggregation follows its
    tensors: a CUDA tensor launches the kernel (a card is needed even to
    make one), a tensor on another device raises, and only a CPU tensor
    takes the plain version."""
    import importlib.util

    import numpy as np

    from repro_torch.kernels.sage_aggregate import sage_aggregate
    from repro_torch.models import GraphSAGE, SageConfig, batch_to

    spec = importlib.util.spec_from_file_location(
        "train_graphsage_torch", ROOT / "examples" / "train_graphsage_torch.py"
    )
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    cfg = SageConfig(in_dim=4, hidden=8, n_classes=3, n_layers=1)
    feats = np.zeros((3, 4), np.float32)
    blocks = [np.array([[1, 2], [-1, -1]], np.int32)]
    labels = np.zeros(2, np.int64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        GraphSAGE(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        batch_to(feats, blocks, labels)
    with pytest.raises(RuntimeError, match="cuda"):
        example.main(["--steps", "1"])
    x = torch.zeros(3, 4)
    idx = torch.tensor(blocks[0])
    with pytest.raises(ValueError, match="no sage_aggregate kernel"):
        sage_aggregate(x.to("meta"), idx.to("meta"))
    # explicitly asking for the CPU works, and launches no kernel
    before = sage_aggregate.launches
    model = GraphSAGE(cfg, device="cpu")
    batch = batch_to(feats, blocks, labels, device="cpu")
    assert model(batch["feats"], batch["blocks"]).shape == (2, 3)
    assert sage_aggregate.launches == before


def test_lm_serving_defaults_to_cuda(monkeypatch):
    """The LM, its serving driver and the attention follow the same rule:
    without ``device`` they run on CUDA and raise with no card; a tensor
    on neither the CPU nor a card raises; only the CPU takes the plain
    version, and launches nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import TransformerLM

    cfg = get_smoke_config("internlm2-1.8b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerLM(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke", "--requests", "1"])
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    before = flash_attention.launches
    stats = serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                        "--max-tokens", "2"])
    assert stats["tokens"] == 2 * 3
    assert flash_attention.launches == before


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "llama4-scout-17b-a16e", "gemma2-27b",
                                  "zamba2-7b", "llava-next-mistral-7b"])
def test_new_patterns_default_to_cuda(monkeypatch, arch):
    """``launch.serve --arch mamba2-1.3b``, ``--arch
    llama4-scout-17b-a16e`` and the gemma2, zamba2 and llava archs run on
    CUDA unless asked for the CPU, and
    raise with no card (before allocating the full-width weights); their
    kernels' wrappers route a tensor on neither the CPU nor a card to no
    kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.moe_gemm import moe_grouped_gemm
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch import serve
    from repro_torch.models import TransformerLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", arch, "--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        TransformerLM(get_smoke_config(arch))
    m = torch.zeros(1, 4, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no ssd_scan kernel"):
        ssd_scan(m, m[..., 0], m[0, 0, :, 0], m[:, :, 0], m[:, :, 0])
    with pytest.raises(ValueError, match="no moe_grouped_gemm kernel"):
        moe_grouped_gemm(torch.zeros(4, 16, device="meta"),
                         torch.zeros(2, 16, 8, device="meta"),
                         torch.zeros(2, dtype=torch.int32, device="meta"))


def test_mesh_and_tooling_stand_alone():
    """The mesh and the analysis tooling (``sharding``, ``launch.mesh``,
    ``launch.op_cost``, ``launch.dryrun``, ``launch.perf``, ``roofline``)
    import neither JAX nor ``repro``, and importing them starts no process
    group."""
    code = (
        "import sys\n"
        "import repro_torch.sharding, repro_torch.launch.mesh, repro_torch.launch.op_cost\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.perf, repro_torch.roofline\n"
        "import repro_torch.launch.train, repro_torch.kernels._cost\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_mesh_train_step_defaults_to_cuda(monkeypatch):
    """``launch.train --mesh host`` runs on CUDA unless asked for the CPU,
    and raises with no card before it starts a process group; a mesh needs
    one."""
    import torch.distributed as dist

    from repro_torch.launch import mesh, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("host", "pod"):
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--smoke", "--mesh", kind, "--steps", "1"])
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_host_mesh()
