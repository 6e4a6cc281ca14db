"""Milliseconds a step from its start (the batch's copy) to
``train_step``'s return, before the loss is read, averaged over the
window's unprofiled steps: the host's cost of issuing a step.  Near the
step's wall the step is bound by the host."""


def read(run):
    return 1e3 * sum(run.enqueues) / len(run.enqueues) if run.enqueues else None
