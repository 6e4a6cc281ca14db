"""DGTP on PyTorch and CUDA: the port of the ``repro`` package.

``repro_torch`` imports torch and numpy and nothing of ``repro`` or JAX.
Its entry points take ``device=``; with none they run on the CUDA card
and raise when there is none.  ``repro_torch.convert.from_reference``
carries the JAX package's workloads, clusters, placements and
realizations across.
"""
