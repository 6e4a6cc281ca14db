"""Perf variants of three dry-run cells, through the port's dry run and
roofline.

The port's counterpart of the JAX package's ``repro.launch.perf``: a
chosen (arch x shape) cell runs again with named variants, and the three
roofline terms and the live memory are printed against the cell's
baseline record (``results/dryrun_torch``).  The variants:

  attn_mode=pad  the padded-heads tensor-parallel layout (``layers``)
  accum=K        gradient accumulation over K microbatches
  opt8           bf16 first moments and a factored second moment
  chunk=N        the SSD chunk

Records land in ``results/perf_torch/<arch>__<shape>__<variant>.json``;
each variant runs in a process of its own (the dry run's fake group is
global state).

  PYTHONPATH=src python -m repro_torch.launch.perf --cell llama4 --variant pad
  PYTHONPATH=src python -m repro_torch.launch.perf --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict

PERF_DIR = Path(__file__).resolve().parents[3] / "results" / "perf_torch"

# the reference's three cells: the most collective-bound (llama4's prefill,
# heads that do not divide tp), the MoE flagship that does not fit (kimi
# train_4k), the dense training flagship (gemma2 train_4k)
CELLS = {
    "llama4": ("llama4-scout-17b-a16e", "prefill_32k"),
    "kimi": ("kimi-k2-1t-a32b", "train_4k"),
    "gemma2": ("gemma2-27b", "train_4k"),
}

VARIANTS = {
    "llama4": {"pad": dict(attn_mode="pad")},
    "kimi": {
        "accum4": dict(accum=4),
        "accum4_opt8": dict(accum=4, opt8=True),
        "accum8_opt8": dict(accum=8, opt8=True),
        "pad_opt8_accum4": dict(accum=4, opt8=True, attn_mode="pad"),
    },
    "gemma2": {"accum4": dict(accum=4), "accum8": dict(accum=8)},
}


def run_variant(arch: str, shape: str, variant: str, knobs: Dict[str, Any],
                mesh_kind: str = "pod") -> Dict[str, Any]:
    """The dry run of the cell with ``knobs``; written to ``PERF_DIR``."""
    from .. import configs as cfgs
    from ..train.optimizer import AdamWSettings
    from .dryrun import run_cell

    overrides: Dict[str, Any] = {}
    if "attn_mode" in knobs:
        overrides["attn_mode"] = knobs["attn_mode"]
    if "chunk" in knobs:
        ssm = cfgs.get_config(arch).ssm
        if ssm is not None:
            overrides["ssm"] = dataclasses.replace(ssm, chunk=knobs["chunk"])
    opt = AdamWSettings()
    if knobs.get("opt8"):
        opt = dataclasses.replace(opt, m_dtype="bfloat16", factored_v=True)
    rec = run_cell(arch, shape, mesh_kind, overrides=overrides, opt=opt,
                   accum=knobs.get("accum", 1))
    rec.update(variant=variant, knobs=dict(knobs))
    PERF_DIR.mkdir(parents=True, exist_ok=True)
    (PERF_DIR / f"{arch}__{shape}__{variant}.json").write_text(json.dumps(rec, indent=1))
    return rec


def compare(arch: str, shape: str, rec: Dict[str, Any]) -> Dict[str, Any]:
    """The roofline terms and live GiB of the baseline and the variant."""
    from ..roofline import GIB, cell_roofline, load_cell

    base = load_cell(arch, shape, "pod")
    if base is None:
        raise FileNotFoundError(f"no baseline record: run launch.dryrun --arch {arch} "
                                f"--shape {shape} --mesh pod")

    def terms(r):
        c = cell_roofline(r)
        live = (r["memory"]["temp_bytes"] + r["memory"]["argument_bytes"]) / GIB
        return c.compute_s, c.memory_s, c.collective_s, live

    names = ("compute_s", "memory_s", "collective_s", "live_GiB")
    b, v = terms(base), terms(rec)
    print(f"\n== {arch} / {shape} / {rec['variant']} ==")
    for n, bb, vv in zip(names, b, v):
        delta = (vv / bb - 1) * 100 if bb > 0 else float("inf")
        print(f"  {n:13s} {bb:10.3f} -> {vv:10.3f}  ({delta:+.1f}%)")
    return dict(zip(names, zip(b, v)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS), default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    cells = [args.cell] if args.cell else list(CELLS)
    for c in cells:
        arch, shape = CELLS[c]
        variants = VARIANTS[c]
        if args.variant:
            variants = {args.variant: variants[args.variant]}
        for vname, knobs in variants.items():
            out = PERF_DIR / f"{arch}__{shape}__{vname}.json"
            if args.one:
                run_variant(arch, shape, vname, knobs)
                return
            if args.force or not out.exists():
                print(f"running {arch}/{shape}/{vname} ...", flush=True)
                subprocess.run([sys.executable, "-m", "repro_torch.launch.perf", "--cell", c,
                                "--variant", vname, "--one"], check=True)
            compare(arch, shape, json.loads(out.read_text()))


if __name__ == "__main__":
    main()
