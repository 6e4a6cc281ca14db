"""The readings that the cells' correctness limits are set from.

    python3 bench/calibrate.py --workload internlm2_train_4x2048 \
        --seeds 1,2,3,4,5,6,7,8,9,10,11,12 --control 3 --out calib.json

On the card, in one process, at the cell's own sizes: for each seed the
program's first steps (``harness.Program.first_steps``) against the
reference (the lower readings); for the first ``--control`` seeds the
control, the reference computed in fp8 e4m3 in the program's place, and
the fault "half of the batch left out", planted in the reference put in
the program's place (the upper readings).  A state left unchanged reads 1
on ``change_gap`` by its definition and needs no run.  Writes one JSON
object with every reading and the seconds each side took.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the upper readings")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, ROOT)
    harness.build_kernels(cell.config, dev)
    out = {"cell": cell.name, "card": torch.cuda.get_device_name(dev), "seeds": []}
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog = harness.Program(cell, seed, dev)
        mine = prog.first_steps(cell.traffic["check_steps"])
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = harness.reference(cell, seed, dev)
        t2 = time.perf_counter()
        row = {"seed": seed, "program": harness.gap_details(mine, ref),
               "program_s": t1 - t0, "reference_s": t2 - t1, "losses": ref.losses,
               "program_losses": mine.losses}
        if k < args.control:
            row["control"] = harness.gap_details(
                harness.reference(cell, seed, dev, precision="fp8"), ref)
            row["half_batch"] = harness.gap_details(
                harness.reference(cell, seed, dev, fault="half_batch"), ref)
        out["seeds"].append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
