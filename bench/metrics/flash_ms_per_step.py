"""Device milliseconds a traced step in the attention's kernels (forward, rematerialised forward and backward)."""


def read(run):
    t = run.trace
    if t is None or not (t.launches.get("flash_forward") or t.launches.get("flash_backward")):
        return None
    return 1e3 * (t.seconds("flash_forward") + t.seconds("flash_backward")) / t.steps
