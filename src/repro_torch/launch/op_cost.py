"""Per-device cost of a torch program: matmul FLOPs, HBM bytes, collectives.

The port's counterpart of the JAX package's ``repro.launch.hlo_cost``,
which parses XLA's optimized HLO.  A torch program has no HLO; its
operations are counted as they are dispatched, over one call, by
``OpCounter`` (a ``TorchDispatchMode``, on real or fake tensors):

  * ``dot_flops``  2 m n k per matrix product (PyTorch's
                   ``torch.utils.flop_counter`` formulas, as
                   ``FlopCounterMode``), plus each hand-written kernel's
                   own count (the MFU convention: products only);
  * ``hbm_bytes``  result plus operand bytes of every operation that
                   materialises a tensor (views, metadata and allocations
                   move nothing), plus each kernel's own bytes;
  * collective bytes by kind: the operand bytes of the functional
                   collectives (``_c10d_functional``) that the mesh's
                   tensor-parallel regions, DTensor's FSDP gathers and
                   reduce-scatters, and the loss's sums issue (all-gather
                   counts its smaller input, reduce-scatter its larger
                   one, as the reference).

A kernel is counted by its own formula, whatever implements it: the CUDA
kernels are loaded through ``ctypes`` and never dispatch, and on CPU or
fake tensors their plain versions run instead, whose steps are not the
kernel's work.  So while a counter is active each wrapper reports its
call's FLOPs and bytes (``kernels._cost``) and the operations of the plain
version inside it are left out.  Each rank's program is its own, so the
numbers are per device.

    with OpCounter() as c:
        step()
    c.result()   # {"dot_flops", "hbm_bytes", "collective_bytes", ...}
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import _cost

# the functional collectives' names -> the reference's kinds
_KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
          "all_reduce": "all-reduce", "all_to_all": "all-to-all"}
# operations that move no data
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
             "detach", "lift_fresh", "lift_fresh_copy", "wait_tensor", "_local_scalar_dense",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
             "set_", "resize_", "record_stream"}


def _bytes(x: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


class OpCounter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_bytes: Dict[str, float] = defaultdict(float)
        self.coll_count: Dict[str, int] = defaultdict(int)
        self.kernels: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0})
        self.n_ops = 0
        self._hidden = 0  # inside a kernel: its plain version's operations

    # ---- kernels (kernels._cost) ---------------------------------------
    def kernel_enter(self, name: str, flops: float, n_bytes: float) -> None:
        if not self._hidden:
            k = self.kernels[name]
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += n_bytes
            self.dot_flops += flops
            self.hbm_bytes += n_bytes
        self._hidden += 1

    def kernel_exit(self) -> None:
        self._hidden -= 1

    def __enter__(self):
        _cost.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cost.pop(self)
        return super().__exit__(*exc)

    # ---- operations ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._hidden:
            return out
        self.n_ops += 1
        packet = func.overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name != "wait_tensor":
            kind = next((k for n, k in _KINDS.items() if n in name), None)
            if kind is not None:
                self.coll_bytes[kind] += _bytes(args[0])
                self.coll_count[kind] += 1
        if packet in flop_registry:
            self.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_BYTES:
            self.hbm_bytes += _bytes(out) + _bytes((args, kwargs))
        return out

    def result(self) -> Dict[str, Any]:
        """The reference's ``analyze`` keys (``ragged_dot_flops`` the
        grouped GEMM's; ``n_ops`` in place of ``n_computations``), and the
        kernels' calls, FLOPs and bytes."""
        coll = {k: v for k, v in self.coll_bytes.items() if v}
        return {
            "dot_flops": self.dot_flops,
            "ragged_dot_flops": sum(v["flops"] for k, v in self.kernels.items()
                                    if k.startswith("moe_grouped_gemm")),
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": coll,
            "collective_count": {k: v for k, v in self.coll_count.items() if v},
            "collective_total_bytes": sum(coll.values()),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "n_ops": self.n_ops,
        }


def count(fn, *args: Any, **kwargs: Any) -> Dict[str, Any]:
    """``OpCounter().result()`` over one call of ``fn``."""
    with OpCounter() as c:
        fn(*args, **kwargs)
    return c.result()
