"""The benchmark of the PyTorch and CUDA port: LM training on one H100.

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``, its
correctness limits in ``limits/<cell>.json``, each per-layer metric's
reader in ``metrics/<metric>.py``, the count formulas in ``flops/``, and
the plain fp32 reference of each block pattern in
``reference/<pattern>.py``.
"""
