"""The attention kernels' share of their roofline, in %: the least time
their launches in the traced steps need (per call the larger of its FLOPs
over the bf16 peak and its bytes over the HBM rate, ``flops/``; a
rematerialised forward counts as the call it is) over their device time."""
from bench.flops import flash_attention as fa
from bench.flops.peaks import bound_s


def read(run):
    t, c, tr = run.trace, run.config, run.traffic
    if t is None or c["block_pattern"] != "dense":
        return None
    n_fwd, n_bwd = t.launches.get("flash_forward", 0), t.launches.get("flash_backward", 0)
    secs = t.seconds("flash_forward") + t.seconds("flash_backward")
    if not (n_fwd or n_bwd) or secs <= 0:
        return None
    b, s = tr["batch"], tr["seq"]
    h, kv = c["n_heads"], c["n_kv_heads"]
    d = c.get("head_dim") or c["d_model"] // h
    least = (n_fwd * bound_s(*fa.forward(b, h, kv, s, s, d))
             + n_bwd * bound_s(*fa.backward(b, h, kv, s, d)))
    return 100.0 * least / secs
