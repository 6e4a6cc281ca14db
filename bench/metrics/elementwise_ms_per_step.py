"""Device milliseconds a traced step in every operation that is neither a
library matrix product nor one of the port's own kernels: the blocks'
elementwise passes and reductions, the loss, the optimizer's passes, the
gradients' stacking, the weights' write-back, copies and memsets."""


def read(run):
    t = run.trace
    return 1e3 * t.other_seconds() / t.steps if t is not None and t.rows else None
