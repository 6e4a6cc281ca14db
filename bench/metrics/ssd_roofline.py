"""The SSD scan kernels' share of their roofline, in %: the least time
their launches in the traced steps need (per call the larger of its FLOPs
over the bf16 peak and its bytes over the HBM rate, ``flops/``; a
rematerialised forward counts as the call it is) over their device time."""
from bench.flops import ssd_scan
from bench.flops.peaks import bound_s


def read(run):
    t, c, tr = run.trace, run.config, run.traffic
    if t is None or c["block_pattern"] != "mamba2":
        return None
    n_fwd, n_bwd = t.launches.get("ssd_forward", 0), t.launches.get("ssd_backward", 0)
    secs = t.seconds("ssd_forward") + t.seconds("ssd_backward")
    if not (n_fwd or n_bwd) or secs <= 0:
        return None
    s = c["ssm"]
    nh = s["expand"] * c["d_model"] // s["head_dim"]
    shape = (tr["batch"], tr["seq"], nh, s["head_dim"], s["n_groups"], s["d_state"], s["chunk"])
    least = (n_fwd * bound_s(*ssd_scan.forward(*shape))
             + n_bwd * bound_s(*ssd_scan.backward(*shape)))
    return 100.0 * least / secs
