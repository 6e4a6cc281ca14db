"""Roofline of the dry run's cells on the card's constants.

The port's counterpart of the JAX package's ``repro.roofline``, over the
records of ``launch.dryrun`` (``results/dryrun_torch/``).  Per (arch x
shape) cell on the single-pod mesh, per device:

  compute term    = dot_flops / PEAK_FLOPS_BF16
  memory term     = hbm_bytes / HBM_BW
  collective term = collective_bytes / NVLINK_BW

(``launch.mesh``: one H100 SXM5's data-sheet rates; the collective term
is a lower bound, see there).  MODEL_FLOPS is 6 N D for training (N the
active parameters of a MoE), 2 N tokens for a prefill and 2 N per
sequence for a decode step; its share of the counted FLOPs flags
rematerialisation and other work past the model's.  A cell fits when its
arguments, temporaries and outputs fit a card's memory
(``card_memory_bytes``: the card's own where there is one).
``python -m repro_torch.roofline`` prints the markdown table.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from .launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, card_memory_bytes

RESULTS = Path(__file__).resolve().parents[2] / "results" / "dryrun_torch"
GIB = float(2**30)


@dataclass
class CellRoofline:
    arch: str
    shape: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops: float = 0.0
    hlo_flops_global: float = 0.0
    useful_ratio: float = 0.0
    roofline_fraction: float = 0.0
    temp_gib: float = 0.0
    fits: bool = True
    note: str = ""


def model_flops_for(rec: Dict) -> float:
    """The model's FLOPs of the cell, over all devices."""
    n_active = rec["active_params"]
    tokens = rec["global_batch"] * rec["seq_len"]
    if rec["kind"] == "train":
        return 6.0 * n_active * tokens
    if rec["kind"] == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * rec["global_batch"]  # decode: one token a sequence


def _note_for(dom: str, cell: CellRoofline) -> str:
    if not cell.fits:
        return ("does not fit a card: shrink the live set first (microbatches, a "
                "smaller MoE capacity, an 8-bit optimizer or more ranks)")
    if dom == "collective":
        return ("cut the tensor-parallel collectives: pad heads to a tp-divisible count, "
                "reduce-scatter in place of all-reduce, a larger per-device batch")
    if dom == "memory":
        return ("raise arithmetic intensity: fuse elementwise passes, larger blocks, "
                "do not re-stream the KV cache or expert weights")
    return ("compute-bound: cut work past the model's (rematerialisation) and overlap "
            "the remaining collectives")


def load_cell(arch: str, shape: str, mesh: str = "pod") -> Optional[Dict]:
    p = RESULTS / f"{arch}__{shape}__{mesh}.json"
    return json.loads(p.read_text()) if p.exists() else None


def cell_roofline(rec: Dict, memory_bytes: Optional[int] = None) -> CellRoofline:
    """The roofline of a dry-run record; ``memory_bytes`` is a card's
    memory (default ``card_memory_bytes()``)."""
    cell = CellRoofline(arch=rec["arch"], shape=rec["shape"], status=rec["status"])
    if rec["status"] != "run":
        cell.note = rec["status"]
        return cell
    sa = rec.get("scan_aware") or {}
    if "dot_flops" not in sa:
        cell.note = "op counts missing"
        return cell
    cell.compute_s = sa["dot_flops"] / PEAK_FLOPS_BF16
    cell.memory_s = sa["hbm_bytes"] / HBM_BW
    cell.collective_s = sa["collective_total_bytes"] / NVLINK_BW
    terms = {"compute": cell.compute_s, "memory": cell.memory_s,
             "collective": cell.collective_s}
    cell.dominant = max(terms, key=terms.get)
    cell.model_flops = model_flops_for(rec)
    cell.hlo_flops_global = sa["dot_flops"] * rec.get("n_devices", 256)
    cell.useful_ratio = cell.model_flops / max(cell.hlo_flops_global, 1e-9)
    cell.roofline_fraction = cell.compute_s / max(max(terms.values()), 1e-12)
    mem = rec["memory"]
    live = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
    cell.temp_gib = mem["temp_bytes"] / GIB
    cell.fits = live <= (card_memory_bytes() if memory_bytes is None else memory_bytes)
    cell.note = _note_for(cell.dominant, cell)
    return cell


def full_table(mesh: str = "pod") -> List[CellRoofline]:
    from .configs import ARCH_IDS, SHAPES

    recs = (load_cell(arch, shape, mesh) for arch in ARCH_IDS for shape in SHAPES)
    return [cell_roofline(rec) for rec in recs if rec is not None]


def markdown_table(cells: List[CellRoofline]) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful % | roofline frac | temp GiB/dev | fits | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.status != "run":
            lines.append(f"| {c.arch} | {c.shape} |" + " — |" * 9 + f" {c.status} |")
            continue
        lines.append(
            f"| {c.arch} | {c.shape} | {c.compute_s:.3g} | {c.memory_s:.3g} | "
            f"{c.collective_s:.3g} | **{c.dominant}** | {c.model_flops:.3g} | "
            f"{100 * c.useful_ratio:.0f}% | {c.roofline_fraction:.2f} | "
            f"{c.temp_gib:.1f} | {'yes' if c.fits else 'NO'} | {c.note} |")
    return "\n".join(lines)


def main() -> None:
    print(markdown_table(full_table("pod")))


if __name__ == "__main__":
    main()
