"""Device operations (kernels, copies, memsets) a traced step."""


def read(run):
    t = run.trace
    return t.operations() / t.steps if t is not None and t.rows else None
