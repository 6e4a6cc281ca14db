"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its
700 W power limit: the yardstick of every roofline share and of MFU."""
BF16_FLOPS = 989e12  # FLOP/s on the tensor cores, bf16 and fp16
FP32_FLOPS = 67e12  # FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12  # bytes/s


def bound_s(flops: float, n_bytes: float, elt: int = 2) -> float:
    """The least time a call of ``flops`` operations moving ``n_bytes``
    needs: the larger of the two times, at the bf16 tensor-core peak (the
    fp32 peak for 4-byte elements) and the HBM rate."""
    peak = BF16_FLOPS if elt == 2 else FP32_FLOPS
    return max(flops / peak, n_bytes / HBM_BYTES)
