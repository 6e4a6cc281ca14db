"""The whole step's share of the chip's bf16 peak, in %: the model FLOPs
of the window's unprofiled steps (``flops/model.py``: 6 x the parameters
in matrix products x tokens, plus the mixer's forward and backward; the
rematerialised forward not counted) over 989 TFLOP/s times their wall."""
from bench.flops.model import step_flops
from bench.flops.peaks import BF16_FLOPS


def read(run):
    if not run.walls:
        return None
    flops = step_flops(run.config, run.traffic["batch"], run.traffic["seq"])
    return 100.0 * flops * len(run.walls) / (BF16_FLOPS * sum(run.walls))
