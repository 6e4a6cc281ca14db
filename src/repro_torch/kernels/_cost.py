"""What a kernel call costs, reported to an active op counter.

``repro_torch.launch.op_cost.OpCounter`` counts the operations a torch
program dispatches; the kernels are loaded through ``ctypes`` and never
dispatch, and on CPU or fake tensors their plain versions run instead,
whose step-by-step operations are not the kernel's work (the plain
attention forms the whole score square).  So while a counter is active
(``counting()``) each kernel call runs inside ``kernel(name, flops,
bytes)``, which reports the kernel's own formula (the operations and
bytes ``chip_smoke.py`` bounds it by) and hides the operations inside
from the counter: a launch on a card through ``reports``, a call on CPU
tensors through ``CountedCall`` (forward and backward).  On fake tensors
(``torch._subclasses.FakeTensorMode``: the dry run) nothing is computed:
the outputs are empty tensors of the kernel's shapes, and the saved
tensors are those the kernel saves.
"""
from __future__ import annotations

import functools
from contextlib import contextmanager
from typing import Any, Callable, Iterator, List

import torch

_COUNTERS: List[Any] = []


def counting() -> bool:
    return bool(_COUNTERS)


def push(counter: Any) -> None:
    _COUNTERS.append(counter)


def pop(counter: Any) -> None:
    _COUNTERS.remove(counter)


@contextmanager
def kernel(name: str, flops: float, n_bytes: float) -> Iterator[None]:
    """Report one call of kernel ``name`` to the active counter and hide
    the operations run inside from it."""
    counter = _COUNTERS[-1]
    counter.kernel_enter(name, float(flops), float(n_bytes))
    try:
        yield
    finally:
        counter.kernel_exit()


def reports(name: str, cost_of: Callable[..., Any]) -> Callable[[Callable], Callable]:
    """Decorate a kernel's launch: under a counter the launch is reported
    at ``cost_of(*its arguments)`` -> (flops, bytes)."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def launch(*args: Any, **kwargs: Any) -> Any:
            if not _COUNTERS:
                return fn(*args, **kwargs)
            with kernel(name, *cost_of(*args, **kwargs)):
                return fn(*args, **kwargs)
        return launch
    return wrap


def is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


class CountedCall(torch.autograd.Function):
    """A kernel call under a counter.  ``call`` holds the kernel's
    ``name``, ``cost(*tensors)`` and ``backward_cost(*tensors)`` -> (flops,
    bytes), ``run(*tensors)`` -> (outputs, saved) computing the plain
    version (``saved``: what the backward needs besides the inputs), and
    ``grad(inputs, saved, grads)`` -> the inputs' gradients;
    ``empty(*tensors)`` -> (outputs, saved) of the kernel's shapes for
    fake tensors."""

    @staticmethod
    def forward(ctx, call, *tensors):
        fake = any(is_fake(t) for t in tensors if isinstance(t, torch.Tensor))
        with kernel(call.name, *call.cost(*tensors)):
            outs, saved = (call.empty if fake else call.run)(*tensors)
        ctx.call, ctx.n_in, ctx.fake = call, len(tensors), fake
        ctx.save_for_backward(*tensors, *saved)
        return outs[0] if len(outs) == 1 else tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        saved = ctx.saved_tensors
        inputs, extra = saved[:ctx.n_in], saved[ctx.n_in:]
        with kernel(call.name + " backward", *call.backward_cost(*inputs)):
            if ctx.fake:
                out = tuple(torch.empty_like(t) if t.is_floating_point() else None
                            for t in inputs)
            else:
                out = call.grad(inputs, extra, grads)
        return (None, *out)


def counted(call: Any, *tensors: torch.Tensor):
    return CountedCall.apply(call, *tensors)
