"""Device milliseconds a traced step in the SSD scan's kernels (forward, rematerialised forward and backward)."""


def read(run):
    t = run.trace
    if t is None or not (t.launches.get("ssd_forward") or t.launches.get("ssd_backward")):
        return None
    return 1e3 * (t.seconds("ssd_forward") + t.seconds("ssd_backward")) / t.steps
