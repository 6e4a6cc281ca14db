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
names (``save_state``, ``restore_state``).

On a mesh (a model placed with ``TransformerLM.shard_parameters``) the
same step runs SPMD on every rank: the batch, which every rank holds
whole, cut to the rank's dp shard (``batch_shardings``); the loss and its
backward over the rank's shards (FSDP over dp, tensor parallelism over
tp: ``models.model``); the gradients' shards stacked into the reference's
leaves; the global norm summed over the mesh (a leaf replicated over an
axis counted once); AdamW on each rank's shard of the state
(``state_specs``: the parameters' specs, a factored moment's means summed
over the axes of the reduced dimension).  ``lower_train``,
``lower_prefill`` and ``lower_decode`` build the step, the prefill and
one decode step on inputs of the cell's shapes, made in the current
tensor mode (fake tensors in the dry run), and return it to be called.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import math

import torch

from .. import sharding as sh
from ..launch import inputs as inputs_mod
from ..models.model import TransformerLM
from .checkpoint import PathLike, restore_checkpoint, save_checkpoint
from .optimizer import (AdamWSettings, Tree, adamw_init, adamw_update,
                        opt_state_specs, tree_build, tree_items)

Batch = Mapping[str, torch.Tensor]


@dataclass
class TrainState:
    params: TransformerLM
    opt: Dict[str, Tree]
    step: int


def _shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (which shares its storage); t otherwise."""
    return t.to_local() if hasattr(t, "to_local") else t


def stacked_weights(model: TransformerLM) -> Tree:
    """The model's weights as the reference's tree (stacked copies; the
    unstacked leaves are the parameters themselves, detached); on a mesh
    this rank's shards."""
    return tree_build([(path, torch.stack([_shard(p.detach()) for p in ps]) if st
                        else _shard(ps[0].detach()))
                       for path, ps, st in model.leaf_groups()])


def _stacked_grads(model: TransformerLM) -> Tree:
    """The gradients as the reference's tree, in the weights' dtypes (zeros
    where a parameter got none; on a mesh this rank's shards); each
    parameter's ``.grad`` is released."""
    items = []
    for path, ps, st in model.leaf_groups():
        gs = [_shard(p.grad) if p.grad is not None else torch.zeros_like(_shard(p.detach()))
              for p in ps]
        items.append((path, torch.stack(gs) if st else gs[0]))
        for p in ps:
            p.grad = None
    return tree_build(items)


@torch.no_grad()
def _write_weights(model: TransformerLM, new: Tree) -> None:
    leaves = dict(tree_items(new))
    for path, ps, st in model.leaf_groups():
        for l, p in enumerate(ps):
            _shard(p).copy_(leaves[path][l] if st else leaves[path])


def _micro(batch: Batch, k: int, i: int) -> Dict[str, torch.Tensor]:
    return {n: t.reshape(k, t.shape[0] // k, *t.shape[1:])[i] for n, t in batch.items()}


def _stacked_specs(model: TransformerLM) -> Dict[Tuple[str, ...], Tuple[Any, ...]]:
    return dict(tree_items(model.param_specs()))


def _mesh_norm(ctx: sh.MeshContext, specs: Mapping[Tuple[str, ...], Any],
               grads: Tree) -> torch.Tensor:
    """The global norm of this rank's gradient shards summed over the mesh,
    each leaf's squares divided by the ranks that hold a copy of its
    shard."""
    sizes = sh.mesh_shape(ctx.mesh)
    total = None
    for path, g in tree_items(grads):
        axes = {a for e in specs[path] for a in sh.axis_names(e)}
        copies = math.prod(n for a, n in sizes.items() if a not in axes)
        sq = g.float().pow(2).sum() / copies
        total = sq if total is None else total + sq
    return torch.sqrt(sh.all_reduce(total, torch.distributed.group.WORLD))


def _mesh_mean(ctx: sh.MeshContext, spec: Tuple[Any, ...],
               ndim: int) -> Callable[..., torch.Tensor]:
    """The factored mean of a leaf of ``ndim`` dimensions and spec ``spec``
    on a mesh: its shard's sum over ``dim`` summed over the axes of the
    leaf's dimension ``leaf_dim``."""
    sizes = sh.mesh_shape(ctx.mesh)
    spec = tuple(spec) + (None,) * (ndim - len(spec))

    def mean(x, dim, leaf_dim, keepdim=False):
        axes = sh.axis_names(spec[leaf_dim])
        out = x.sum(dim, keepdim=keepdim)
        for a in axes:
            out = sh.all_reduce(out, ctx.group(a))
        return out / (x.shape[dim] * math.prod(sizes[a] for a in axes))

    return mean


class TrainStepBuilder:
    def __init__(self, model: TransformerLM, opt_cfg: Optional[AdamWSettings] = None,
                 accum_steps: int = 1) -> None:
        self.model = model
        self.cfg = model.cfg
        self.ctx = model.ctx
        self.opt_cfg = opt_cfg or AdamWSettings()
        self.accum_steps = accum_steps

    # ---------------------------------------------------------------- specs
    def state_specs(self) -> Dict[str, Any]:
        """The reference's ``state_specs``: ``params`` the model's
        ``param_specs``, ``opt`` ``opt_state_specs`` over the stacked
        leaves' shapes, ``step`` replicated."""
        ps = self.model.param_specs(self.ctx)
        shapes = tree_build(list(self._whole_leaves().items()))
        return {"params": ps, "opt": opt_state_specs(self.opt_cfg, shapes, ps), "step": ()}

    def state_shardings(self) -> Optional[Dict[str, Any]]:
        """``state_specs`` as DTensor placements over the model's mesh
        (None without one)."""
        if self.ctx.mesh is None:
            return None
        names = tuple(sh.mesh_shape(self.ctx.mesh))

        def place(spec: Any) -> Any:
            if isinstance(spec, dict):
                return {k: place(v) for k, v in spec.items()}
            return sh.placements(spec, names)

        return place(self.state_specs())

    def batch_shardings(self, batch: int) -> Optional[Dict[str, Any]]:
        """The batch's specs (``inputs.batch_specs``) as placements (None
        without a mesh)."""
        if self.ctx.mesh is None:
            return None
        names = tuple(sh.mesh_shape(self.ctx.mesh))
        return {k: sh.placements(s, names)
                for k, s in inputs_mod.batch_specs(self.cfg, self.ctx, batch).items()}

    def init_state(self, generator: Optional[torch.Generator] = None) -> TrainState:
        """The model's weights drawn from ``generator`` (on the model's
        device; None keeps the weights it holds, such as ones carried
        across from the reference), fresh AdamW state, step 0."""
        if generator is not None:
            self.model.init(generator)
        return TrainState(params=self.model,
                          opt=adamw_init(stacked_weights(self.model), self.opt_cfg,
                                         self._whole_leaves() if self.ctx.has_ranks else None),
                          step=0)

    def _whole_leaves(self) -> Dict[Tuple[str, ...], torch.Tensor]:
        """Meta tensors of the whole stacked leaves' shapes."""
        return {path: torch.empty((len(ps),) + tuple(ps[0].shape) if st
                                  else tuple(ps[0].shape), device="meta")
                for path, ps, st in self.model.leaf_groups()}

    def _local_batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """This rank's dp shard of a batch every rank holds whole."""
        n = next(iter(batch.values())).shape[0]
        specs = inputs_mod.batch_specs(self.cfg, self.ctx, n)
        return {k: self.ctx.shard(t, specs[k]) for k, t in batch.items()}

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
        hooks = {}
        if self.ctx.has_ranks:
            batch = self._local_batch(batch)
            ctx, specs = self.ctx, _stacked_specs(self.model)
            hooks = {"norm": lambda g: _mesh_norm(ctx, specs, g),
                     "mean_of": lambda path, g: _mesh_mean(ctx, specs[path], g.dim())}
        grads, metrics = self._grads(batch)
        dtypes = tree_build([(path, ps[0]) for path, ps, _ in self.model.leaf_groups()])
        new, _, opt_metrics = adamw_update(self.opt_cfg, dtypes, state.opt, grads, state.step,
                                           **hooks)
        del grads
        _write_weights(self.model, new)
        state.step += 1
        return state, {**metrics, **opt_metrics}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        """The metrics of ``loss_fn`` on ``batch``, without gradients."""
        if self.ctx.has_ranks:
            batch = self._local_batch(batch)
        return state.params.loss_fn(batch)[1]

    # ------------------------------------------------------------- dry run
    def _weights(self) -> Dict[str, torch.Tensor]:
        return {n: _shard(p.detach()) for n, p in self.model.named_parameters()}

    def lower_train(self, batch: int, seq: int) -> "Lowered":
        """One train step of a fresh state on a batch of the cell's
        shapes (``inputs.train_structs``)."""
        state = self.init_state()
        structs = inputs_mod.train_structs(self.cfg, batch, seq, device=self.model.device)
        local = self._local_batch(structs) if self.ctx.has_ranks else structs
        return Lowered(lambda: self.train_step(state, structs)[1],
                       {"weights": self._weights(), "opt": state.opt, "batch": local},
                       {"weights": self._weights(), "opt": state.opt})

    def lower_prefill(self, batch: int, seq: int) -> "Lowered":
        """The prefill (last-position logits) of a batch of the cell's
        shapes, each rank on its dp shard."""
        structs = inputs_mod.train_structs(self.cfg, batch, seq, device=self.model.device)
        structs.pop("labels")
        local = self._local_batch(structs) if self.ctx.has_ranks else structs
        model = self.model
        return Lowered(lambda: model.prefill(local.get("tokens"), frames=local.get("frames"),
                                             patches=local.get("patches")),
                       {"weights": self._weights(), "batch": local}, {})

    def lower_decode(self, batch: int, smax: int) -> "Lowered":
        """One decode step against a cache of ``smax`` positions, at the
        last of them (each rank on its shard of the cache and the batch)."""
        model = self.model
        cache = model.cache_struct(batch, smax)
        token = inputs_mod.decode_inputs_structs(batch, device=model.device)["token"]
        token = self.ctx.shard(token, self.ctx.batch_spec(batch, 0))
        return Lowered(lambda: model.decode_step(cache, token, smax - 1)[1],
                       {"weights": self._weights(), "cache": cache, "token": token},
                       {"cache": cache})


@dataclass
class Lowered:
    """A step built on inputs of a cell's shapes, run by calling it:
    ``inputs`` the tensors it reads (this rank's shards), ``updated`` those
    of them it writes in place."""

    call: Callable[[], Any]
    inputs: Dict[str, Any]
    updated: Dict[str, Any]

    def __call__(self) -> Any:
        return self.call()


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
