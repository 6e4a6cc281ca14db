"""Meshes over ranks, and the card's constants for the roofline.

The port of the JAX package's ``repro.launch.mesh``:

  single pod  16 x 16 = 256 ranks, axes ("data", "model");
  multi-pod   2 x 16 x 16 = 512 ranks, axes ("pod", "data", "model").

A mesh is a ``DeviceMesh`` over the process group in place: a fake one of
256 or 512 ranks in the dry run (``launch.dryrun``), or ``torchrun``'s in
a launch.  ``production_shape`` is the same mesh without ranks (a
``sharding.MeshShape``), which the spec builders take.  These are
functions: importing this module starts no process group.

The roofline's constants are one NVIDIA H100 80GB HBM3 (SXM5) card's,
from NVIDIA's H100 data sheet; the card the port's numbers come from
reports ``NVIDIA H100 80GB HBM3, 700.00 W`` (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``).  The collective
term is one rate for every collective, a card's NVLink bandwidth in one
direction; a 16-wide model axis spans two 8-card NVLink domains, whose
link between them is slower, so the term is a lower bound.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from ..sharding import MeshContext, MeshShape, ctx_for_mesh

# H100 SXM5 data sheet: dense bf16 tensor-core peak, HBM3 bandwidth,
# NVLink 4 bandwidth in one direction (900 GB/s both ways), HBM capacity
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s, one direction
HBM_PER_CARD = 80e9  # bytes (the data sheet's 80 GB)


def card_memory_bytes() -> int:
    """A card's memory: ``torch.cuda.get_device_properties`` on the card,
    the data sheet's ``HBM_PER_CARD`` without one."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return int(HBM_PER_CARD)


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_type() -> str:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (torchrun, init_ranks, or the "
                           "dry run's fake group) before building a mesh")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the process group in place, which must
    have 256 ranks (512 with ``multi_pod``)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = production_shape(multi_pod=multi_pod)
    return init_device_mesh(_device_type(), shape.sizes, mesh_dim_names=shape.axis_names)


def make_host_mesh(model: int = 1):
    """A (data, model) mesh over the running ranks: gloo ranks on the CPU,
    NCCL ranks on cards (``torchrun``, or one rank from ``init_ranks``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device = _device_type()
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model axes of {model}")
    return init_device_mesh(device, (n // model, model), mesh_dim_names=("data", "model"))


def production_ctx(*, multi_pod: bool = False) -> MeshContext:
    return ctx_for_mesh(make_production_mesh(multi_pod=multi_pod))


def init_ranks(device: str) -> Tuple[int, int]:
    """Start the process group of a launch on ``device`` ("cpu": gloo,
    "cuda": NCCL, each rank on card ``LOCAL_RANK``): ``torchrun``'s ranks
    from its environment, else one rank on a local ``HashStore`` (no
    network).  Returns (rank, world size)."""
    import torch.distributed as dist

    backend = "nccl" if device == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        if device == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size()
