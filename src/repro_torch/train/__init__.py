"""Training infrastructure of the port: checkpoints and fault tolerance.

``checkpoint`` saves and restores nested mappings of tensors (a model's
``state_dict``, optimizer state) in the JAX package's on-disk layout, so
either package restores what the other wrote; ``fault_tolerance`` drives
restore -> re-plan -> resume on a machine failure through the port's
``Replanner``.
"""
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .fault_tolerance import FailureController, StragglerPolicy, rescale_plan

__all__ = [
    "FailureController",
    "StragglerPolicy",
    "latest_checkpoint",
    "rescale_plan",
    "restore_checkpoint",
    "save_checkpoint",
]
