"""Device milliseconds a traced step in the library's matrix products
(cuBLAS's gemm, nvjet, gemv and cutlass kernels): the blocks' projections
and the head's fp32 products."""


def read(run):
    t = run.trace
    return 1e3 * t.gemm_seconds() / t.steps if t is not None and t.rows else None
