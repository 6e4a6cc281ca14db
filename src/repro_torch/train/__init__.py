"""Training infrastructure of the port.

``checkpoint`` saves and restores nested mappings of tensors in the JAX
package's on-disk layout, so either package restores what the other
wrote; ``fault_tolerance`` drives restore -> re-plan -> resume on a
machine failure through the port's ``Replanner``; ``optimizer`` is AdamW
over the reference's stacked leaves; ``compression`` compresses
gradients with error feedback; ``train_loop`` builds the LM train step.
"""
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .compression import CompressionConfig, CompressionSettings, compress_grads
from .fault_tolerance import FailureController, StragglerPolicy, rescale_plan
from .optimizer import (
    AdamWConfig,
    AdamWSettings,
    adamw_init,
    adamw_update,
    global_norm,
    schedule,
)
from .train_loop import TrainState, TrainStepBuilder, restore_state, save_state

__all__ = [
    "AdamWConfig",
    "AdamWSettings",
    "CompressionConfig",
    "CompressionSettings",
    "FailureController",
    "StragglerPolicy",
    "TrainState",
    "TrainStepBuilder",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "compress_grads",
    "latest_checkpoint",
    "rescale_plan",
    "restore_checkpoint",
    "restore_state",
    "save_checkpoint",
    "save_state",
    "schedule",
]
