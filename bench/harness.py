"""One run of one benchmark cell: set-up, the measured window, the traced
steps, the comparison with the plain reference, the result line.

A run (``run``):

1. Set-up.  The nvcc libraries of the configuration's kernels are built,
   or found in the checkout's ``build/``.  The weights are drawn from the
   seed on the device (``weights.draw``) and copied into the port's
   ``TransformerLM``; ``TrainStepBuilder`` is built with the traffic's
   AdamW settings; a ring of ``ring`` batches is drawn on the host from the
   frozen ``pipeline.TokenPipeline``.  The first ``check_steps`` steps run
   through the window's own call (``Program.step``) on the ring's first
   batches, whose rows all differ; the program's readings are taken from
   its state (the first gradient from the first moment after step 1, the
   change from the fp32 masters after the last).  They are the warm-up:
   every shape of the window has run.  The peak memory is reset.
2. The window: steps for ``seconds``, each as ``launch/train.py`` makes
   one: the batch copied to the device, ``builder.train_step(state,
   batch)``, then ``float(metrics["loss"])``, which waits for the step.
   With ``trace`` the steps after the window's middle are profiled
   (``trace.traced``).
3. After the window: the peak memory read, the program freed, then the plain
   reference (``reference.common.train``) follows the same steps from the
   same weights and batches in fp32, and ``compare`` holds the program's
   readings against it under the cell's limits.

Everything a cell names is found by name: ``BENCHMARK.json`` gives the
cell's configuration and traffic, ``configs/``, ``traffic/`` and
``limits/`` hold them, ``metrics/<name>.py`` reads each metric from a
``Run``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch.profiler import record_function

from . import trace as trace_mod
from . import weights
from .pipeline import TokenPipeline
from .reference import common
from .reference.common import Precision, Readings

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = float(1 << 30)


def load_json(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _for(cell: str, metrics: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    man = load_json(root / "BENCHMARK.json")
    work = [w for w in man["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in man['workloads']]}")
    w = work[0]
    conf = [c for c in man["configs"] if c["name"] == w["config"]][0]
    return Cell(name, w["chips"], load_json(root / conf["file"]),
                load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                load_json(HERE / "limits" / f"{name}.json"),
                _for(name, man["end_to_end"]), _for(name, man["per_layer"]))


def reader(name: str):
    """The reader module of metric ``name``: ``metrics/<name>.py``, whose
    ``read(run)`` returns the metric or None where it finds nothing."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_config(config: Mapping[str, Any]):
    """The port's ``LMConfig`` of a configuration file: its keys that name
    the config's fields (``ssm`` as an ``SSMSpec``)."""
    from repro_torch.models.config import LMConfig, SSMSpec

    fields = {f.name for f in dataclasses.fields(LMConfig)}
    kw = {k: v for k, v in config.items() if k in fields and k != "ssm"}
    if "ssm" in config:
        kw["ssm"] = SSMSpec(**config["ssm"])
    return LMConfig(**kw)


def build_kernels(config: Mapping[str, Any], device: torch.device) -> None:
    """Build (or find built) the forward and backward libraries of the
    configuration's kernels, all at once."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build

    sources = []
    for name in config["kernels"]:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        sources += [mod.SOURCE, mod.BWD_SOURCE]
    _build.build(*sources)


def ring(config: Mapping[str, Any], traffic: Mapping[str, Any], seed: int
         ) -> List[Dict[str, torch.Tensor]]:
    """The traffic's ring of batches on the host, drawn from the seed."""
    pipe = TokenPipeline(vocab=config["vocab"], seq_len=traffic["seq"],
                         global_batch=traffic["batch"], seed=seed % (1 << 63),
                         markov_k=traffic["markov_k"])
    return [{k: torch.from_numpy(v).contiguous() for k, v in pipe.batch_at(i).items()}
            for i in range(traffic["ring"])]


def half_batch(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The fault "half of the batch left out, the mean taken over the
    rest": the first half of the rows, or of a single row's labels."""
    n = batch["tokens"].shape[0]
    if n >= 2:
        return {k: v[:n // 2] for k, v in batch.items()}
    labels = batch["labels"].clone()
    labels[:, labels.shape[1] // 2:] = -1
    return {"tokens": batch["tokens"], "labels": labels}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: the port's ``TransformerLM`` holding the
    benchmark's weights, its ``TrainStepBuilder`` and ``TrainState``, and
    the ring of batches it is fed."""

    def __init__(self, cell: Cell, seed: int, device: torch.device) -> None:
        from repro_torch.models.model import TransformerLM
        from repro_torch.train.optimizer import AdamWSettings
        from repro_torch.train.train_loop import TrainStepBuilder

        self.device = device
        self.init: Optional[Dict[str, torch.Tensor]] = weights.draw(cell.config, seed, device)
        model = TransformerLM(lm_config(cell.config), device=device)
        params = dict(model.named_parameters())
        if set(params) != set(self.init):
            raise ValueError(f"the port's parameters {sorted(set(params) ^ set(self.init))} "
                             f"differ from the reference's")
        with torch.no_grad():
            for name, p in params.items():
                w = self.init[name]
                if p.shape != w.shape or p.dtype != w.dtype:
                    raise ValueError(f"{name}: the port's {tuple(p.shape)} {p.dtype} against "
                                     f"the reference's {tuple(w.shape)} {w.dtype}")
                p.copy_(w)
        self.names = {id(p): n for n, p in params.items()}
        self.opt = AdamWSettings(**cell.traffic["optimizer"])
        self.builder = TrainStepBuilder(model, self.opt)
        self.state = self.builder.init_state()
        self.ring = ring(cell.config, cell.traffic, seed)
        self.steps = 0

    def step(self) -> Tuple[float, float, float]:
        """One step, the window's call and feed: (loss, seconds until
        ``train_step`` returned, seconds until the loss was read)."""
        t0 = time.perf_counter()
        with record_function("bench.batch_to_device"):
            batch = {k: v.to(self.device) for k, v in
                     self.ring[self.steps % len(self.ring)].items()}
        with record_function("bench.train_step"):
            self.state, met = self.builder.train_step(self.state, batch)
        t1 = time.perf_counter()
        with record_function("bench.read_loss"):
            loss = float(met["loss"])
        self.steps += 1
        return loss, t1 - t0, time.perf_counter() - t0

    def _norms(self, which: str, scale: float = 1.0, minus_init: bool = False
               ) -> Dict[str, float]:
        """Each parameter's norm of its slice of the optimizer state's tree
        ``which`` (less the initial weight with ``minus_init``)."""
        out = {}
        with torch.no_grad():
            for path, ps, stacked in self.builder.model.leaf_groups():
                tree = self.state.opt[which]
                for k in path:
                    tree = tree[k]
                for l, p in enumerate(ps):
                    name = self.names[id(p)]
                    x = (tree[l] if stacked else tree).float()
                    if minus_init:
                        x = x - self.init[name].float()
                    out[name] = x.norm().item() * scale
        return out

    def first_steps(self, n: int) -> Readings:
        """The first ``n`` steps and the program's readings: each step's
        loss, the first gradient as the optimizer got it (its first moment
        after step 1 over 1 - beta1) and the change of the fp32 masters
        over the ``n`` steps."""
        losses, grads = [], {}
        for k in range(n):
            losses.append(self.step()[0])
            if k == 0:
                grads = self._norms("m", 1.0 / (1.0 - self.opt.beta1))
        change = self._norms("master", minus_init=True)
        self.init = None
        return Readings(losses, grads, change)


def reference(cell: Cell, seed: int, device: torch.device, precision: str = "float32",
              fault: Optional[str] = None) -> Readings:
    """The plain reference's readings over the cell's first steps, from the
    same weights and batches as the program's (drawn again from the
    seed); ``fault="half_batch"`` plants that fault in it."""
    opt = cell.traffic["optimizer"]
    if opt.get("m_dtype", "float32") != "float32" or opt.get("factored_v", False):
        raise ValueError("the reference's AdamW keeps fp32 moments, unfactored")
    n = cell.traffic["check_steps"]
    init = weights.draw(cell.config, seed, device)
    batches = [{k: v.to(device) for k, v in b.items()}
               for b in ring(cell.config, cell.traffic, seed)[:n]]
    if fault == "half_batch":
        batches = [half_batch(b) for b in batches]
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return common.train(init, batches, cell.config, opt, Precision(precision))


NUMBERS = ("loss_gap", "grad_gap", "change_gap")


def gap_details(got: Readings, want: Readings) -> Dict[str, Tuple[float, str]]:
    """The numbers compared, of ``got`` against the reference's ``want``,
    each with where it was read (the step or the leaf): the largest
    relative gap of a step's loss; of a leaf's first-gradient norm and of a
    leaf's change norm, the gap between the two norms over the reference's
    norm of that leaf or of the median leaf, whichever is larger, worst
    leaf.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change."""
    if set(got.grad_norms) != set(want.grad_norms) or len(got.losses) != len(want.losses):
        raise ValueError("the readings cover different leaves or steps")
    loss = max((abs(a - b) / abs(b), f"step {i + 1}")
               for i, (a, b) in enumerate(zip(got.losses, want.losses)))
    med_g = statistics.median(want.grad_norms.values())
    grad = max((abs(got.grad_norms[n] - g) / max(g, med_g), n)
               for n, g in want.grad_norms.items())
    moved = [n for n, g in want.grad_norms.items() if g >= 1e-3 * med_g]
    med_c = statistics.median(want.change_norms[n] for n in moved)
    change = max((abs(got.change_norms[n] - want.change_norms[n])
                  / max(want.change_norms[n], med_c), n) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def readings_gaps(got: Readings, want: Readings) -> Dict[str, float]:
    """``gap_details``' numbers alone."""
    return {k: v for k, (v, _) in gap_details(got, want).items()}


@dataclass
class Run:
    """What the metric readers read."""

    config: Dict[str, Any]
    traffic: Dict[str, Any]
    setup_s: float
    window_s: float
    tokens: int
    walls: List[float]  # each unprofiled window step, start to loss read
    enqueues: List[float]  # each unprofiled window step, start to train_step's return
    peak_bytes: int
    trace: Optional[trace_mod.Trace]


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: Optional[float] = None) -> Tuple[Dict[str, Any], List[str]]:
    """One run of ``cell``: (the result line's object, the lines that give
    each number compared beside its limit)."""
    t_start = time.perf_counter() if t_start is None else t_start
    traffic = cell.traffic
    marks = [("imports", time.perf_counter())]
    build_kernels(cell.config, device)
    marks.append(("kernels built or found", time.perf_counter()))
    program = Program(cell, seed, device)
    marks.append(("weights, model, optimizer state, ring", time.perf_counter()))
    mine = program.first_steps(traffic["check_steps"])
    _sync(device)
    marks.append((f"{traffic['check_steps']} first steps and readings", time.perf_counter()))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    at, spans = t_start, []
    for what, t in marks:
        spans.append(f"{what} {t - at:.2f} s")
        at = t

    walls, enqueues, losses, traced = [], [], [], None

    def traced_steps(k: int) -> None:
        for _ in range(k):
            losses.append(program.step()[0])

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace and traced is None and time.perf_counter() - t0 >= seconds / 2:
            traced = trace_mod.traced(traced_steps, traffic["trace_steps"])
            continue
        loss, enq, wall = program.step()
        losses.append(loss)
        walls.append(wall)
        enqueues.append(enq)
    if trace and traced is None:
        traced = trace_mod.traced(traced_steps, traffic["trace_steps"])
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    want = reference(cell, seed, device)
    gaps = gap_details(mine, want)
    t_ref = time.perf_counter() - t_ref
    failed = sum(1 for x in losses if not math.isfinite(x))
    # a number without a limit has no upper reading and is not compared
    checks = {n: {"value": gaps[n][0], "limit": cell.limits[n]} for n in NUMBERS
              if cell.limits[n] is not None}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())

    data = Run(cell.config, traffic, setup_s, window_s,
               len(losses) * traffic["batch"] * traffic["seq"], walls, enqueues, peak, traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"]).read(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result: Dict[str, Any] = {"correct": correct, "attempted": len(losses), "failed": failed,
                              "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = traced.breakdown()
    result["checks"] = {**checks, "failed_steps": {"value": failed, "limit": 0}}
    lines = [f"[setup] {setup_s:.2f} s: " + ", ".join(spans),
             f"[window] {len(losses)} steps in {window_s:.2f} s; the reference's "
             f"{traffic['check_steps']} steps {t_ref:.2f} s; worst: "
             + ", ".join(f"{n} at {gaps[n][1]}" for n in NUMBERS)]
    lines += [f"reading {n} {gaps[n][0]!r} (not compared)" for n in NUMBERS
              if cell.limits[n] is None]
    lines += [f"check {n} {c['value']!r} limit {c['limit']!r}"
              for n, c in result["checks"].items()]
    return result, lines
