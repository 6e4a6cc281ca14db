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

While a profiler records, the step and each of its parts open a span
(``obs.spans``: ``train.step``, ``train.forward``, ``train.backward``,
``train.stack_grads``, ``train.adamw``, ``train.write_weights``; the
model opens ``model.embed``, ``model.block`` and ``model.head_loss``).

A state saves and restores through ``train.checkpoint`` as the tree
``{"opt", "params", "step"}``, the reference's ``TrainState`` leaves and
names (``save_state``, ``restore_state``); on a mesh each leaf is saved
whole, gathered from the ranks' shards, and restored into each rank's
shard, so the files are the same with or without a mesh.

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

import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import math

import torch

from .. import sharding as sh
from ..launch import inputs as inputs_mod
from ..models.model import TransformerLM
from ..obs.spans import span
from .checkpoint import PathLike, leaf_paths, restore_checkpoint, save_checkpoint
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


def _whole_leaves(model: TransformerLM) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Meta tensors of the whole stacked leaves' shapes and dtypes."""
    return {path: torch.empty((len(ps),) + tuple(ps[0].shape) if st else tuple(ps[0].shape),
                              dtype=ps[0].dtype, device="meta")
            for path, ps, st in model.leaf_groups()}


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
        return _whole_leaves(self.model)

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
            with span("train.forward"):
                total, metrics = model.loss_fn(batch)
            with span("train.backward"):
                total.backward()
            with span("train.stack_grads"):
                return _stacked_grads(model), {n: m.detach() for n, m in metrics.items()}
        n = next(iter(batch.values())).shape[0]
        if n % k:
            raise ValueError(f"batch {n} does not split into {k} microbatches")
        grads: Optional[Dict[Tuple[str, ...], torch.Tensor]] = None
        sums: Dict[str, torch.Tensor] = {}
        for i in range(k):
            with span("train.forward"):
                total, metrics = model.loss_fn(_micro(batch, k, i))
            with span("train.backward"):
                total.backward()
            with span("train.stack_grads"):
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
        with span("train.step"):
            hooks = {}
            if self.ctx.has_ranks:
                batch = self._local_batch(batch)
                ctx, specs = self.ctx, _stacked_specs(self.model)
                hooks = {"norm": lambda g: _mesh_norm(ctx, specs, g),
                         "mean_of": lambda path, g: _mesh_mean(ctx, specs[path], g.dim())}
            grads, metrics = self._grads(batch)
            dtypes = tree_build([(path, ps[0]) for path, ps, _ in self.model.leaf_groups()])
            with span("train.adamw"):
                new, _, opt_metrics = adamw_update(self.opt_cfg, dtypes, state.opt, grads,
                                                   state.step, **hooks)
            del grads
            with span("train.write_weights"):
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


def _names(tree: Any, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """A tree of specs or shapes (tuples are leaves) by checkpoint leaf
    name: a mapping's keys, sorted, joined with ``__``."""
    if isinstance(tree, Mapping):
        return {n: v for k in sorted(tree) for n, v in _names(tree[k], prefix + (k,)).items()}
    return {"__".join(prefix): tree}


def _mesh_layout(state: TrainState) -> Tuple[Dict[str, Tuple[int, ...]], Dict[str, Any]]:
    """On a mesh, each leaf of ``state_tree(state)`` by checkpoint name:
    (its whole shape, its spec).  The parameters' specs are
    ``param_specs``; the optimizer's ``opt_state_specs`` with a factored
    second moment where the state has one, decided, as ``adamw_init(...,
    whole=)`` decided it, from the whole leaf's shape."""
    model = state.params
    leaves = _whole_leaves(model)
    factored = any(isinstance(v, Mapping) for _, v in tree_items(state.opt["v"]))
    cfg = AdamWSettings(factored_v=factored)
    params, specs = tree_build(list(leaves.items())), model.param_specs()
    whole = {"params": params, "opt": adamw_init(params, cfg),  # meta: shapes only
             "step": torch.empty((), device="meta")}
    shapes = {n: tuple(t.shape) for n, t in leaf_paths(whole)}
    return shapes, _names({"params": specs, "opt": opt_state_specs(cfg, params, specs),
                           "step": ()})


# the most bytes of a leaf that a mesh gathers at once to save it
_GATHER_BYTES = 1 << 30


def _gathered(ctx: sh.MeshContext, t: torch.Tensor, spec: Tuple[Any, ...],
              shape: Tuple[int, ...], keep: bool) -> Optional[torch.Tensor]:
    """The whole leaf of ``shape`` whose shard under ``spec`` this rank
    holds as ``t``, on the host where ``keep`` (else None).  It is
    gathered over the ranks in slices of the first dimension that the spec
    does not shard, of at most ``_GATHER_BYTES`` each (one index where that
    is more), each slice moved to the host before the next is gathered: a
    card holds its shards and one slice whole, never the whole leaf."""
    if not any(sh.axis_names(e) for e in spec):
        return t.cpu() if keep else None
    from torch.distributed.tensor import DTensor

    place = sh.placements(spec, tuple(sh.mesh_shape(ctx.mesh)))
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    free = [d for d in range(len(shape)) if not sh.axis_names(spec[d]) and shape[d] > 1]
    dim = free[0] if free else 0
    per = shape[dim] if not free else max(
        1, _GATHER_BYTES * shape[dim] // (math.prod(shape) * t.element_size()))
    out = torch.empty(shape, dtype=t.dtype) if keep else None
    for at in range(0, shape[dim], per):
        n = min(per, shape[dim] - at)
        part = t.narrow(dim, at, n).contiguous() if free else t
        size = torch.Size(shape[:dim] + (n,) + shape[dim + 1:])
        whole = DTensor.from_local(part, ctx.mesh, place, shape=size,
                                   stride=torch.empty(size, device="meta").stride()).full_tensor()
        if keep:
            out.narrow(dim, at, n).copy_(whole)
        del whole
    return out


def save_state(directory: PathLike, state: TrainState) -> Path:
    """Checkpoint the state at its step (``train.checkpoint`` layout).  On
    a mesh every rank calls it: each leaf is gathered whole, one at a time
    (``_gathered``), rank 0 writes it while the other ranks take part in
    the same gathers in the same order, and every rank waits at a barrier
    until rank 0 has published the manifest."""
    ctx = state.params.ctx
    if not ctx.has_ranks:
        return save_checkpoint(directory, state_tree(state), state.step)
    import torch.distributed as dist

    shapes, specs = _mesh_layout(state)
    writer = dist.get_rank() == 0
    tree = {n: functools.partial(_gathered, ctx, t, specs[n], shapes[n], writer)
            for n, t in leaf_paths(state_tree(state))}
    if writer:
        path = save_checkpoint(directory, tree, state.step)
    else:
        for _, gather in leaf_paths(tree):
            gather()
        path = Path(directory) / f"step_{state.step:08d}"
    dist.barrier()
    return path


def restore_state(path: PathLike, state: TrainState) -> TrainState:
    """Restore a ``save_state`` checkpoint, written with or without a
    mesh, into ``state`` (shapes checked; a mismatch raises
    ``ValueError``): the model's weights, the optimizer state and the step,
    bit for bit.  On a mesh each rank reads the whole leaves and keeps its
    shard of each by its spec."""
    ctx, place = state.params.ctx, None
    if ctx.has_ranks:
        shapes, specs = _mesh_layout(state)

        def place(name: str, t: torch.Tensor) -> torch.Tensor:
            if tuple(t.shape) != shapes[name]:
                raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != the whole "
                                 f"leaf's {shapes[name]}")
            return ctx.shard(t, specs[name])

    tree, _ = restore_checkpoint(path, state_tree(state), place)
    _write_weights(state.params, tree["params"])
    state.opt = tree["opt"]
    state.step = int(tree["step"])
    return state
