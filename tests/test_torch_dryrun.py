"""The port's analysis tooling: the op counter, the dry run and the
roofline (``repro_torch.launch.op_cost``, ``launch.dryrun``,
``roofline``), against the reference's formulas.

  * the counter counts L x 2 m n k for L chained matmuls (the reference's
    ``test_scan_aware_counter_on_known_program``), and a kernel call on
    CPU tensors (the attention, the grouped GEMM, the SSD scan, each
    forward and backward) at the kernel's own formula, not at the plain
    version's operations; fake tensors count the same;
  * a smoke cell of the dry run on a small fake mesh (2 x 4), in a
    subprocess of its own (the fake process group is global state), gives
    a record with the reference's keys, whose argument bytes are the
    local shards implied by the reference's specs: the weights, the fp32
    master and moments, and the batch;
  * ``cell_roofline`` and ``model_flops_for`` on a hand-made record.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro import sharding as ref_sharding
from repro.launch import dryrun as ref_dryrun
from repro.models import build_model as ref_build
from repro_torch import roofline
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.op_cost import OpCounter, count

ROOT = Path(__file__).resolve().parents[1]


def test_counter_on_known_program():
    L, m, k, n = 7, 64, 32, 32
    w = torch.ones(L, k, n)

    def f(x):
        for l in range(L):
            x = x @ w[l]
        return x

    res = count(f, torch.ones(m, k))
    assert res["dot_flops"] == L * 2 * m * k * n
    assert res["hbm_bytes"] > 0 and res["collective_total_bytes"] == 0


@pytest.mark.parametrize("fake", [False, True])
def test_kernels_counted_at_their_formula(fake):
    from torch._subclasses.fake_tensor import FakeTensorMode

    def run():
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 96, 64, generator=g).requires_grad_(True)
        k = torch.randn(2, 2, 96, 64, generator=g).requires_grad_(True)
        x = torch.randn(40, 16, generator=g).requires_grad_(True)
        w = torch.randn(3, 16, 24, generator=g).requires_grad_(True)
        gs = torch.tensor([10, 0, 30])
        xs = torch.randn(1, 64, 2, 16, generator=g).requires_grad_(True)
        dt = torch.rand(1, 64, 2, generator=g)
        A = -torch.rand(2, generator=g)
        bc = torch.randn(1, 64, 1, 8, generator=g)
        with OpCounter() as c:
            o = fa.flash_attention(q, k, k, causal=True, window=40)
            y = mg.moe_grouped_gemm(x, w, gs)
            z = ss.ssd_scan(xs, dt, A, bc, bc, chunk=32)
            (o.sum() + y.sum() + z.sum()).backward()
        return c.result(), (q, k, x, w, xs, bc)

    if fake:
        with FakeTensorMode():
            res, (q, k, x, w, xs, bc) = run()
    else:
        res, (q, k, x, w, xs, bc) = run()
    want = {
        "flash_attention": fa.cost(q, k, True, 40),
        "flash_attention backward": fa.backward_cost(q, k, True, 40),
        "moe_grouped_gemm": mg.cost(x, w),
        "moe_grouped_gemm backward": mg.backward_cost(x, w),
        "ssd_scan": ss.cost(xs, bc, 32),
        "ssd_scan backward": ss.backward_cost(xs, bc, 32),
    }
    for name, (flops, n_bytes) in want.items():
        assert res["kernels"][name] == {"calls": 1, "flops": flops, "bytes": n_bytes}, name
    # the plain attention forms the whole [96, 96] score square per head;
    # the kernel's window of 40 keys is counted instead
    pairs, _ = fa.mask_counts(96, 96, True, 40)
    assert pairs < 96 * 96 and fa.cost(q, k, True, 40)[0] == 4 * 64 * 2 * 4 * pairs
    kernel_flops = sum(f for f, _ in want.values())
    assert res["dot_flops"] >= kernel_flops
    assert res["ragged_dot_flops"] == want["moe_grouped_gemm"][0] + want[
        "moe_grouped_gemm backward"][0]


def _local_bytes(spec, shape, dtype_bytes, sizes):
    from repro_torch.sharding import local_shape

    entries = tuple(tuple(spec)) + (None,) * (len(shape) - len(tuple(spec)))
    return math.prod(local_shape(shape, entries, sizes)) * dtype_bytes


def test_dry_run_smoke_cell_record(tmp_path):
    arch, batch, seq = "internlm2-1.8b", 4, 64
    out = tmp_path / "cell.json"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--smoke",
         "--shape", "train_4k", "--mesh", "2x4", "--batch", str(batch), "--seq", str(seq),
         "--out", str(out)],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(out.read_text())
    assert rec["status"] == "run" and rec["n_devices"] == 8
    ref_keys = {"arch", "shape", "mesh", "status", "kind", "seq_len", "global_batch", "params",
                "active_params", "lower_s", "compile_s", "n_devices", "memory", "cost",
                "collectives", "scan_aware"}
    assert set(rec) == ref_keys
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "code_bytes"}
    assert set(rec["cost"]) == {"flops", "transcendentals", "bytes_accessed"}
    assert set(rec["collectives"]) == {"total_bytes", "bytes_by_kind", "count_by_kind"}
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert rec["collectives"]["bytes_by_kind"][kind] > 0
    assert set(rec["scan_aware"]) >= {"dot_flops", "hbm_bytes", "collective_bytes",
                                      "collective_total_bytes"}
    # the arguments: the local shards the reference's specs imply
    cfg = ref_configs.get_smoke_config(arch)
    mesh = AbstractMesh((2, 4), ("data", "model"))
    model = ref_build(cfg, ref_sharding.ctx_for_mesh(mesh))
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    specs = model.param_specs()
    sizes = {"data": 2, "model": 4}
    want = 0
    for (path, leaf), spec in zip(jax.tree_util.tree_leaves_with_path(shapes),
                                  jax.tree_util.tree_leaves(
                                      specs, is_leaf=lambda s: isinstance(s, tuple))):
        n = _local_bytes(spec, leaf.shape, 1, sizes)
        want += n * (np.dtype(leaf.dtype).itemsize + 4 + 4 + 4)  # weight, master, m, v
    want += 2 * (batch // 2) * seq * 4  # tokens and labels, int32, over dp
    assert rec["memory"]["argument_bytes"] == want
    assert rec["params"] == cfg.param_count()
    assert rec["cost"]["flops"] == rec["scan_aware"]["dot_flops"] > 0


def test_dry_run_skips_as_the_reference():
    from repro_torch.launch.dryrun import run_cell

    rec = run_cell("hubert-xlarge", "decode_32k", "pod", verbose=False)
    assert rec["status"] == ref_configs.cell_status(ref_configs.get_config("hubert-xlarge"),
                                                    "decode_32k") != "run"
    assert set(rec) == {"arch", "shape", "mesh", "status", "kind", "seq_len",
                        "global_batch", "params", "active_params"}
    assert ref_dryrun.cell_path("a", "b", "c").name == "a__b__c.json"


def test_roofline_on_a_hand_made_record():
    rec = {"arch": "internlm2-1.8b", "shape": "train_4k", "status": "run", "kind": "train",
           "seq_len": 4096, "global_batch": 256, "params": 1_000, "active_params": 800,
           "n_devices": 256,
           "memory": {"argument_bytes": 10 * 2**30, "temp_bytes": 20 * 2**30,
                      "output_bytes": 0},
           "scan_aware": {"dot_flops": 4e15, "hbm_bytes": 2e12,
                          "collective_total_bytes": 9e11}}
    assert roofline.model_flops_for(rec) == 6.0 * 800 * 256 * 4096
    assert roofline.model_flops_for({**rec, "kind": "prefill"}) == 2.0 * 800 * 256 * 4096
    assert roofline.model_flops_for({**rec, "kind": "decode"}) == 2.0 * 800 * 256
    cell = roofline.cell_roofline(rec, memory_bytes=80 * 10**9)
    assert cell.compute_s == 4e15 / mesh_mod.PEAK_FLOPS_BF16
    assert cell.memory_s == 2e12 / mesh_mod.HBM_BW
    assert cell.collective_s == 9e11 / mesh_mod.NVLINK_BW
    assert cell.dominant == max(("compute", cell.compute_s), ("memory", cell.memory_s),
                                ("collective", cell.collective_s), key=lambda t: t[1])[0]
    assert cell.useful_ratio == roofline.model_flops_for(rec) / (4e15 * 256)
    assert cell.roofline_fraction == cell.compute_s / max(cell.compute_s, cell.memory_s,
                                                          cell.collective_s)
    assert cell.fits and not roofline.cell_roofline(rec, memory_bytes=2**30).fits
    assert cell.temp_gib == 20.0
    skipped = roofline.cell_roofline({**rec, "status": "skip: x"})
    assert skipped.note == "skip: x" and skipped.compute_s == 0.0
    table = roofline.markdown_table([cell, skipped])
    assert table.count("\n") == 3 and "**" in table
