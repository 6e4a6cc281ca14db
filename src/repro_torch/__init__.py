"""DGTP on PyTorch and CUDA: the port of the ``repro`` package.

DGTP planning (``core``) with its regimes, re-planning and the
arrival-driven multi-tenant service (``dynamics``), multi-job planning
(``core.multijob``) and the feature-cache tier (``cache``); GraphSAGE
training (``data``, ``models.gnn``); LM serving for the dense, mamba2 and
MoE block patterns (``configs``, ``models``, ``serve``,
``launch.serve``); each TPU kernel rewritten by hand in CUDA
(``kernels``).

``repro_torch`` imports torch and numpy and nothing of ``repro`` or JAX.
Its entry points take ``device=``; with none they run on the CUDA card
and raise when there is none.  ``repro_torch.convert.from_reference``
carries the JAX package's workloads, clusters, placements and
realizations across.
"""
