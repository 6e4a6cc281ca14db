"""DGTP on PyTorch and CUDA: the port of the ``repro`` package.

Three slices so far: DGTP planning (``core``), GraphSAGE training
(``data``, ``models.gnn``) and LM serving for the dense block pattern
(``configs``, ``models``, ``serve``, ``launch.serve``), each with its TPU
kernel rewritten by hand in CUDA (``kernels``).

``repro_torch`` imports torch and numpy and nothing of ``repro`` or JAX.
Its entry points take ``device=``; with none they run on the CUDA card
and raise when there is none.  ``repro_torch.convert.from_reference``
carries the JAX package's workloads, clusters, placements and
realizations across.
"""
