"""The LM train step on PyTorch: loss, gradients, accumulation and AdamW.

The port of the JAX package's ``repro.train.train_loop`` on one device.
``TrainState`` is (params, opt, step) as in the reference, with
``params`` the ``TransformerLM`` itself: a step updates its parameters in
place, and ``opt`` holds the AdamW state over the reference's stacked
leaves (``TransformerLM.leaf_groups``).  A step:

  1. the model's ``loss_fn`` and its backward (each layer rematerialised:
     on the card the attention's forward kernel runs twice a layer and
     its backward kernel once);
  2. the gradients stacked into the reference's leaves, in the weights'
     dtype; with ``accum_steps`` k > 1 the batch is cut into k
     microbatches along axis 0 and the leaves summed in fp32 as
     g_i / k, the metrics averaged the same way (the reference's scan);
  3. ``adamw_update`` on the stacked leaves, and the new weights written
     back into the model's parameters.

A state saves and restores through ``train.checkpoint`` as the tree
``{"opt", "params", "step"}``, the reference's ``TrainState`` leaves and
names (``save_state``, ``restore_state``).  The reference's jit, lower
and sharding helpers serve its dry-run and mesh (ROADMAP Queue 1 item
14).
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..models.model import TransformerLM
from .checkpoint import PathLike, restore_checkpoint, save_checkpoint
from .optimizer import AdamWSettings, Tree, adamw_init, adamw_update, tree_build, tree_items

Batch = Mapping[str, torch.Tensor]


@dataclass
class TrainState:
    params: TransformerLM
    opt: Dict[str, Tree]
    step: int


def stacked_weights(model: TransformerLM) -> Tree:
    """The model's weights as the reference's tree (stacked copies; the
    unstacked leaves are the parameters themselves, detached)."""
    return tree_build([(path, torch.stack([p.detach() for p in ps]) if st else ps[0].detach())
                       for path, ps, st in model.leaf_groups()])


def _stacked_grads(model: TransformerLM) -> Tree:
    """The gradients as the reference's tree, in the weights' dtypes (zeros
    where a parameter got none); each parameter's ``.grad`` is released."""
    items = []
    for path, ps, st in model.leaf_groups():
        gs = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
        items.append((path, torch.stack(gs) if st else gs[0]))
        for p in ps:
            p.grad = None
    return tree_build(items)


@torch.no_grad()
def _write_weights(model: TransformerLM, new: Tree) -> None:
    leaves = dict(tree_items(new))
    for path, ps, st in model.leaf_groups():
        for l, p in enumerate(ps):
            p.copy_(leaves[path][l] if st else leaves[path])


def _micro(batch: Batch, k: int, i: int) -> Dict[str, torch.Tensor]:
    return {n: t.reshape(k, t.shape[0] // k, *t.shape[1:])[i] for n, t in batch.items()}


class TrainStepBuilder:
    def __init__(self, model: TransformerLM, opt_cfg: Optional[AdamWSettings] = None,
                 accum_steps: int = 1) -> None:
        self.model = model
        self.cfg = model.cfg
        self.opt_cfg = opt_cfg or AdamWSettings()
        self.accum_steps = accum_steps

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """The model's weights drawn from ``generator`` (on the model's
        device; None keeps the weights it holds, such as ones carried
        across from the reference), fresh AdamW state, step 0."""
        if generator is not None:
            self.model.init(generator)
        return TrainState(params=self.model,
                          opt=adamw_init(stacked_weights(self.model), self.opt_cfg),
                          step=0)

    def _grads(self, batch: Batch) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        model, k = self.model, self.accum_steps
        for _, ps, _ in model.leaf_groups():
            for p in ps:
                p.grad = None
        if k <= 1:
            total, metrics = model.loss_fn(batch)
            total.backward()
            return _stacked_grads(model), {n: m.detach() for n, m in metrics.items()}
        n = next(iter(batch.values())).shape[0]
        if n % k:
            raise ValueError(f"batch {n} does not split into {k} microbatches")
        grads: Optional[Dict[Tuple[str, ...], torch.Tensor]] = None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(k):
            total, metrics = model.loss_fn(_micro(batch, k, i))
            total.backward()
            gi = dict(tree_items(_stacked_grads(model)))
            if grads is None:
                grads = {p: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                         for p, g in gi.items()}
            for p, g in gi.items():
                grads[p] = grads[p] + g.float() / k
            for name, m in metrics.items():
                sums[name] = sums.get(name, 0.0) + m.detach().float() / k
        return tree_build(list(grads.items())), sums

    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, Dict[str, Any]]:
        """One optimizer step on ``batch`` (the model's ``loss_fn`` inputs,
        on its device); returns the state (its model updated in place, step
        + 1) and the metrics (``loss``, ``aux_loss``, ``tokens``,
        ``grad_norm`` as tensors, ``lr`` as a float)."""
        if state.params is not self.model:
            raise ValueError("the state holds another model than the builder's")
        grads, metrics = self._grads(batch)
        dtypes = tree_build([(path, ps[0]) for path, ps, _ in self.model.leaf_groups()])
        new, opt, opt_metrics = adamw_update(self.opt_cfg, dtypes, state.opt, grads, state.step)
        del grads
        _write_weights(self.model, new)
        state.opt, state.step = opt, state.step + 1
        return state, {**metrics, **opt_metrics}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        """The metrics of ``loss_fn`` on ``batch``, without gradients."""
        return state.params.loss_fn(batch)[1]


def state_tree(state: TrainState) -> Tree:
    """The state as the reference's ``TrainState`` tree: ``params`` stacked
    as the reference's, ``opt``, and ``step`` an int32 scalar."""
    return {"params": stacked_weights(state.params), "opt": state.opt,
            "step": torch.tensor(state.step, dtype=torch.int32)}


def save_state(directory: PathLike, state: TrainState) -> Path:
    """Checkpoint the state at its step (``train.checkpoint`` layout)."""
    return save_checkpoint(directory, state_tree(state), state.step)


def restore_state(path: PathLike, state: TrainState) -> TrainState:
    """Restore a ``save_state`` checkpoint into ``state`` (shapes checked;
    a mismatch raises ``ValueError``): the model's weights, the optimizer
    state and the step, bit for bit."""
    tree, _ = restore_checkpoint(path, state_tree(state))
    _write_weights(state.params, tree["params"])
    state.opt = tree["opt"]
    state.step = int(tree["step"])
    return state
