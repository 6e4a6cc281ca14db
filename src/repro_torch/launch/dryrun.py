"""Multi-pod dry run of the port: every (arch x shape x mesh) cell on fake
tensors over a fake process group.

The port's counterpart of the JAX package's ``repro.launch.dryrun``
(which lowers and compiles each cell with XLA on 512 host devices).  For
every cell, in one process: a fake process group of 256 ranks (16 x 16,
"data" x "model") or 512 (2 x 16 x 16 with "pod") from
``torch.testing._internal.distributed.fake_pg.FakeStore`` (this process
is rank 0; collectives return at once), and ``FakeTensorMode``, under
which the full-size model is built and placed by its specs, and the
cell's step runs once: a train step (loss, backward, AdamW), the
prefill, or one decode step against a cache of ``seq_len`` positions.
Nothing is allocated, and the kernels report their formulas
(``kernels._cost``).  The record has the reference's keys:

  * ``memory``: ``argument_bytes`` the local shards of the state (weights,
    optimizer state) or the cache, and the batch; ``temp_bytes`` the peak
    of what the call allocates (gradients, activations, temporaries), from
    ``torch.distributed._tools.mem_tracker.MemTracker``; ``alias_bytes``
    the state the step updates in place; ``output_bytes`` what the call
    returns; ``code_bytes`` 0;
  * ``cost`` and ``scan_aware``: ``launch.op_cost`` over the call
    (``flops`` = its ``dot_flops``, ``bytes_accessed`` = its ``hbm_bytes``;
    no transcendentals are counted: -1);
  * ``collectives``: the counter's collective bytes by kind.

Records are cached as JSON under ``results/dryrun_torch/`` (listed in
``.gitignore``); ``roofline`` and ``launch.perf`` read them.  A fake group
is global state: run one cell per process (``--all`` runs each in a
subprocess of its own).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b \\
      --shape train_4k --mesh pod            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-1.3b --smoke \\
      --shape train_4k --mesh 2x4 --batch 4 --seq 64 --out /tmp/cell.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _mesh_shape(mesh_kind: str):
    from ..launch.mesh import production_shape
    from ..sharding import MeshShape

    if mesh_kind in ("pod", "multipod"):
        return production_shape(multi_pod=mesh_kind == "multipod")
    data, model = (int(n) for n in mesh_kind.split("x"))
    return MeshShape(("data", "model"), (data, model))


def _tensors(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif hasattr(tree, "shape"):
        yield tree


def _nbytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, smoke: bool = False,
             batch: Optional[int] = None, seq: Optional[int] = None,
             overrides: Optional[Dict[str, Any]] = None, opt: Any = None,
             accum: int = 1, verbose: bool = True) -> Dict[str, Any]:
    """The record of one cell (see the module's note); ``smoke``,
    ``batch``, ``seq`` and ``overrides`` (config fields) cut it for tests,
    ``opt`` (``AdamWSettings``) and ``accum`` are ``launch.perf``'s knobs.
    Starts the fake process group: once per process."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .. import configs as cfgs
    from ..models.model import TransformerLM
    from ..sharding import ctx_for_mesh
    from ..train.train_loop import TrainStepBuilder
    from .op_cost import OpCounter

    cfg = cfgs.get_smoke_config(arch) if smoke else cfgs.get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    sh = dict(cfgs.SHAPES[shape_name])
    sh.update({k: v for k, v in (("global_batch", batch), ("seq_len", seq)) if v})
    status = cfgs.cell_status(cfg, shape_name)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": status,
        "kind": sh["kind"], "seq_len": sh["seq_len"], "global_batch": sh["global_batch"],
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if status != "run":
        return rec
    shape = _mesh_shape(mesh_kind)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=shape.size)
    mesh = init_device_mesh("cpu", shape.sizes, mesh_dim_names=shape.axis_names)
    ctx = ctx_for_mesh(mesh)
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True):
        model = TransformerLM(cfg, device="cpu").shard_parameters(ctx)
        builder = TrainStepBuilder(model, opt, accum_steps=accum)
        b, s = sh["global_batch"], sh["seq_len"]
        lower = {"train": builder.lower_train, "prefill": builder.lower_prefill,
                 "decode": builder.lower_decode}[sh["kind"]]
        call = lower(b, s)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        arg_bytes = _nbytes(call.inputs)
        tracker = MemTracker()
        tracker.track_external(model)
        with tracker, OpCounter() as counter:
            out = call()
        peak = tracker.get_tracker_snapshot("peak")
        t_run = time.perf_counter() - t0
    # what the call allocated at its peak (the weights were there before)
    temp = max((sum(v for k, v in d.items() if not str(k).endswith(("PARAM", "BUFFER", "Total")))
                for d in peak.values()), default=0)
    sa = counter.result()
    rec.update({
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_run, 2),
        "n_devices": shape.size,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _nbytes(out),
            "temp_bytes": temp,
            "alias_bytes": _nbytes(call.updated),
            "code_bytes": 0,
        },
        "cost": {"flops": sa["dot_flops"], "transcendentals": -1.0,
                 "bytes_accessed": sa["hbm_bytes"]},
        "collectives": {
            "total_bytes": int(sa["collective_total_bytes"]),
            "bytes_by_kind": {k: int(v) for k, v in sa["collective_bytes"].items()},
            "count_by_kind": dict(sa["collective_count"]),
        },
        "scan_aware": sa,
    })
    if verbose:
        print(f"[{arch} / {shape_name} / {mesh_kind}] memory: {rec['memory']}")
        print(f"[{arch} / {shape_name} / {mesh_kind}] flops {sa['dot_flops']:.4g}, bytes "
              f"{sa['hbm_bytes']:.4g}, collectives {rec['collectives']['bytes_by_kind']}")
    return rec


def cell_path(arch: str, shape: str, mesh: str) -> Path:
    return RESULTS / f"{arch}__{shape}__{mesh}.json"


def _run_one(args: argparse.Namespace) -> int:
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, smoke=args.smoke, batch=args.batch,
                       seq=args.seq)
    except Exception as e:  # noqa: BLE001 - report and record the failure
        traceback.print_exc()
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": f"FAILED: {type(e).__name__}: {e}"}
    out = Path(args.out) if args.out else cell_path(args.arch, args.shape, args.mesh)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    return 1 if rec["status"].startswith("FAILED") else 0


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None,
                    help="pod, multipod, or DATAxMODEL (a small fake mesh)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="the arch's smoke config")
    ap.add_argument("--batch", type=int, default=None, help="cut the global batch")
    ap.add_argument("--seq", type=int, default=None, help="cut the sequence length")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)

    from .. import configs as cfgs

    if args.arch and args.shape and args.mesh and not args.all:
        sys.exit(_run_one(args))
    archs = [args.arch] if args.arch else cfgs.ARCH_IDS
    shapes = [args.shape] if args.shape else list(cfgs.SHAPES)
    meshes = [args.mesh] if args.mesh else ["pod", "multipod"]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                out = cell_path(arch, shape, mesh)
                if out.exists() and not args.force:
                    print(f"cached  {arch:24s} {shape:12s} {mesh:9s} "
                          f"{json.loads(out.read_text())['status']}")
                    continue
                # one process a cell: the fake process group is global state
                rc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                                     "--arch", arch, "--shape", shape, "--mesh", mesh]).returncode
                rec = json.loads(out.read_text()) if out.exists() else {"status": "FAILED"}
                if rc:
                    failures.append((arch, shape, mesh))
                print(f"done    {arch:24s} {shape:12s} {mesh:9s} {rec['status']}")
    if failures:
        print(f"\n{len(failures)} FAILED cells: {failures}")
        sys.exit(1)
    print("\nall requested dry-run cells OK")


if __name__ == "__main__":
    main()
