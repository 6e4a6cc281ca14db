#!/usr/bin/env python3
"""Measures the torch engine's host-synchronisation choices on the card.

    python3 engine_probe.py [--device cuda] [--width 1024] [--steps 300]
                            [--out chiprun_out/engine_probe.json]

The eager engine tests three loop conditions on the host, each a
device-to-host copy.  This script times each choice against its
alternatives on the jobs and candidates of ``chip_smoke.py`` (papers100M:
J=117, E=1400, M=16; products: J=23, E=72, M=4; ``--width`` candidates
each, one iteration of papers and ten of products):

  1. ``rounds``: oes filling rounds per ``advance`` over a whole run, each
     round counted while the engine tests for an empty flow set after it;
  2. ``oes_check``: that test every 1 or 4 rounds, or never (a fixed 4*M
     rounds), over the first ``--steps`` lock-step iterations of oes;
  3. ``settle``: the settle fixpoint with and without the one-round
     shortcut for workloads that cannot cascade (oes_strict, ``--steps``
     iterations);
  4. ``check_every``: the outer loop's termination test every 1, 8, 32
     or 128 iterations (oes_strict, whole products run);
  5. ``flow_log``: a whole recorded fifo run (``record=True``) with the
     flow log, and with its two scatters and its extraction patched out
     (task events only, as ``record`` was before the engine kept a flow
     log).

Each comparison runs its variants in the order a, b, c, c, b, a and
reports both times of each; every variant must reach the same clocks as
the first.  Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from chip_smoke import _candidates, _jobs  # also puts src/ on sys.path


@contextlib.contextmanager
def _patched(module: object, **values: int) -> Iterator[None]:
    old = {k: getattr(module, k) for k in values}
    for k, v in values.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reals(reals, n_iters):
    from repro_torch.core import Realization

    return [
        Realization(r.volumes[:, :n_iters], r.exec_times[:, :n_iters])
        for r in reals
    ]


def _program(wl, cluster, placements, reals, policy, dev):
    from repro_torch.core import engine_torch as et

    ys = np.stack([p.y for p in placements]).astype(np.int64)
    return et._build_program(wl, cluster, ys, reals, policy, False, dev)


def _steps(prog, steps: int, dev) -> Tuple[float, np.ndarray]:
    """Seconds for the first settle and ``steps`` advance+settle steps."""
    _sync(dev)
    t0 = time.perf_counter()
    prog.settle()
    for _ in range(steps):
        prog.advance()
        prog.settle()
    _sync(dev)
    return time.perf_counter() - t0, prog.t.cpu().numpy()


def _compare(
    name: str, variants: Dict[str, Callable[[], Tuple[float, np.ndarray]]]
) -> Dict[str, List[float]]:
    """Runs the variants a, b, ..., ..., b, a; checks equal clocks."""
    keys = list(variants)
    times: Dict[str, List[float]] = {k: [] for k in keys}
    first = None
    for k in keys + keys[::-1]:
        secs, t = variants[k]()
        if first is None:
            first = t
        elif not np.array_equal(t, first):
            raise AssertionError(f"{name}: variant {k} reached other clocks")
        times[k].append(secs)
    for k in keys:
        print(f"[{name}] {k:>12s}: {times[k][0]:.4f} s, {times[k][1]:.4f} s",
              flush=True)
    return times


def main() -> int:
    import torch

    from repro_torch.core import engine_torch as et
    from repro_torch.core import resolve_device, simulate_batch_torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", choices=("flow_log",), default=None,
                    help="run this comparison alone")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    out: Dict[str, object] = {"device": str(dev), "width": args.width,
                              "steps": args.steps}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    n_iters = {"papers": 1, "products": 10}
    with torch.inference_mode():
        for job, wl, cluster in _jobs():
            placements, reals = _candidates(wl, cluster, args.width, seed=0)
            reals = _reals(reals, n_iters[job])
            M = cluster.M
            res: Dict[str, object] = {}
            out[job] = res

            # 5. a whole recorded run with and without the flow log
            def recorded_run(flow_log: bool):
                def run():
                    no_log = dict(
                        record_flows=lambda self, *a: None,
                        flow_logs=lambda self: [[] for _ in range(self.B)],
                    )
                    _sync(dev)
                    t0 = time.perf_counter()
                    with _patched(et._Program, **({} if flow_log else no_log)):
                        rs = simulate_batch_torch(
                            wl, cluster, placements, reals, policy="fifo",
                            record=True, device=dev,
                        )
                    _sync(dev)
                    return (time.perf_counter() - t0,
                            np.array([r.makespan for r in rs]))
                return run

            res["flow_log"] = _compare(f"flow_log {job}", {
                "with": recorded_run(True), "without": recorded_run(False),
            })
            if args.only == "flow_log":
                continue

            # 1. oes filling rounds per advance, over a whole run
            prog = _program(wl, cluster, placements, reals, "oes", dev)
            rates, round_fn = prog.rates, prog.oes_round
            per_adv: List[int] = []
            calls = [0]

            def counted_round(*state, _f=round_fn):
                calls[0] += 1
                return _f(*state)

            def counted_rates(mask, caps, _f=rates):
                calls[0] = 0
                r = _f(mask, caps)
                per_adv.append(calls[0])
                return r

            prog.oes_round, prog.rates = counted_round, counted_rates
            with _patched(et, _OES_CHECK_EVERY=1):
                prog.run(50_000_000)
            a = np.array(per_adv)
            res["rounds"] = dict(
                advances=int(a.size), mean=float(a.mean()),
                p50=float(np.percentile(a, 50)), p99=float(np.percentile(a, 99)),
                max=int(a.max()), cap=4 * M, at_cap=int((a == 4 * M).sum()),
            )
            print(f"[rounds] {job} oes: {a.size} advances, rounds per advance "
                  f"mean {a.mean():.2f}, p50 {np.percentile(a, 50):.0f}, "
                  f"p99 {np.percentile(a, 99):.0f}, max {a.max()} "
                  f"(cap {4 * M}, reached {(a == 4 * M).sum()} times)",
                  flush=True)

            # 2. the empty-flow test every k oes rounds
            def oes_run(k: int):
                def run():
                    prog = _program(wl, cluster, placements, reals, "oes", dev)
                    with _patched(et, _OES_CHECK_EVERY=k):
                        return _steps(prog, args.steps, dev)
                return run

            res["oes_check"] = _compare(f"oes_check {job}", {
                "every 1": oes_run(1), "every 4": oes_run(4),
                f"never ({4 * M})": oes_run(4 * M),
            })

            # 3. settle with and without the no-cascade shortcut
            def settle_run(shortcut: bool):
                def run():
                    prog = _program(
                        wl, cluster, placements, reals, "oes_strict", dev
                    )
                    assert prog.no_cascade
                    prog.no_cascade = shortcut
                    return _steps(prog, args.steps, dev)
                return run

            res["settle"] = _compare(f"settle {job}", {
                "shortcut": settle_run(True), "fixpoint": settle_run(False),
            })

            # 4. the outer loop's termination test every k iterations
            if job == "products":
                def whole_run(k: int):
                    def run():
                        _sync(dev)
                        t0 = time.perf_counter()
                        with _patched(et, _CHECK_EVERY=k):
                            rs = simulate_batch_torch(
                                wl, cluster, placements, reals,
                                policy="oes_strict", device=dev,
                            )
                        _sync(dev)
                        return (time.perf_counter() - t0,
                                np.array([r.makespan for r in rs]))
                    return run

                res["check_every"] = _compare(f"check_every {job}", {
                    f"{k}": whole_run(k) for k in (1, 8, 32, 128)
                })
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({"ok": True, "device": out["device"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
