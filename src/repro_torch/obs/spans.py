"""Spans inside the LM train step, on a ``torch.profiler`` trace.

``span(name)`` is a context manager.  With no profiler recording
(``torch.autograd._profiler_enabled()`` false) it is one shared no-op
context: no allocation, no dispatcher call, no string formatted, as the
metrics registry's off state.  While a profiler records it is
``torch.profiler.record_function(name)``: the span lies on the
profiler's host timeline, on the clock of the device rows it launches,
and stays in the profiler's memory until the trace ends.  There is no
other switch.

The spans, each a fixed name (the parent in brackets):

  train.step           ``TrainStepBuilder.train_step``
  train.forward        the model's ``loss_fn``, once a micro-batch [train.step]
  train.backward       its backward, once a micro-batch [train.step]
  train.stack_grads    the gradients stacked into the reference's leaves,
                       and summed in fp32 over micro-batches [train.step]
  train.adamw          ``adamw_update`` [train.step]
  train.write_weights  the new weights written into the parameters [train.step]
  model.embed          the first block's input [train.forward]
  model.block          one layer, or one application of zamba2's shared
                       block, inside the function the rematerialisation
                       runs again in the backward: a step opens it twice a
                       layer [train.forward; the recompute's train.backward]
  model.head_loss      the head's fp32 logits and the cross entropy [train.forward]

A backward operation runs under no span of the model: a profile reader
puts it down to the span of the forward operation that made its autograd
node (the node's forward thread and sequence number).
"""
from __future__ import annotations

import contextlib
from typing import ContextManager

import torch

_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """``record_function(name)`` while a profiler records; else the
    shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
