"""Seconds from the process's start to the window's first step: imports,
the kernels' build (the first run in a checkout) or load, the weights,
the model, the optimizer state, the ring of batches and the first steps,
which run every shape the window runs."""


def read(run):
    return run.setup_s
