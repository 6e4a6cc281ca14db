"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload internlm2_train_4x2048 --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout, on a machine with an NVIDIA card.  The port
(``src/repro_torch``) runs on the card; the last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which are also the last lines of
standard error).  Without a card, or with fewer cards than the cell asks
for, it prints no result and exits with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the caches any library of the run keeps, at fixed paths in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "bench_cache" / "torch_ext"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import harness

    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
        return 2
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                                torch.device("cuda", 0), t_start=T_START)
    found = harness.loaded_forbidden()
    if found:
        print(f"no result: modules loaded that the benchmark may not load: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
