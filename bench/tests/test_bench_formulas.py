"""The frozen count formulas reproduce the bounds PERF.md recorded from the
port's own formulas: flash backward 0.173794 ms at q [4, 16, 2048, 128]
over 8 KV heads, causal; ssd_scan forward 0.041943 ms and backward
0.096016 ms at x [4, 2048, 64, 64], d_state 128, chunk 256."""
import pytest

from bench.flops import flash_attention, model, ssd_scan
from bench.flops.peaks import bound_s


def test_flash_backward_bound():
    assert bound_s(*flash_attention.backward(4, 16, 8, 2048, 128)) * 1e3 == pytest.approx(
        0.173794, abs=5e-7)


def test_flash_forward_bound():
    assert bound_s(*flash_attention.forward(4, 16, 8, 2048, 2048, 128)) * 1e3 == pytest.approx(
        0.069518, abs=5e-7)


@pytest.mark.parametrize("fn,ms", [(ssd_scan.forward, 0.041943), (ssd_scan.backward, 0.096016)])
def test_ssd_bounds(fn, ms):
    assert bound_s(*fn(4, 2048, 64, 64, 1, 128, 256)) * 1e3 == pytest.approx(ms, abs=5e-7)


def test_model_flops_match_the_param_counts():
    """The parameters in matrix products are the port's ``param_count``
    (1889009664 for internlm2-1.8b, 1446402048 for mamba2-1.3b untied at
    vocab 50280) less one vocab x d table."""
    dense = dict(block_pattern="dense", n_layers=24, d_model=2048, n_heads=16,
                 n_kv_heads=8, d_ff=8192, vocab=92544)
    assert model.matmul_params(dense) == 1889009664 - 92544 * 2048
    ssm = dict(block_pattern="mamba2", n_layers=48, d_model=2048, vocab=50280,
               ssm=dict(d_state=128, head_dim=64, expand=2, d_conv=4, n_groups=1, chunk=256))
    assert model.matmul_params(ssm) == 1446402048 - 50280 * 2048


def test_the_port_formulas_agree_today():
    """While the port's own formulas are unchanged, the frozen copies give
    the same counts (a change to the port's is no change to these)."""
    torch = pytest.importorskip("torch")
    from repro_torch.kernels import flash_attention as fa, ssd_scan as ss

    q = torch.empty(4, 16, 2048, 128, dtype=torch.bfloat16, device="meta")
    k = torch.empty(4, 8, 2048, 128, dtype=torch.bfloat16, device="meta")
    assert fa.backward_cost(q, k, True, None) == flash_attention.backward(4, 16, 8, 2048, 128)
    assert fa.cost(q, k, True, None) == flash_attention.forward(4, 16, 8, 2048, 2048, 128)
    x = torch.empty(4, 2048, 64, 64, dtype=torch.bfloat16, device="meta")
    b = torch.empty(4, 2048, 1, 128, dtype=torch.bfloat16, device="meta")
    assert ss.cost(x, b, 256) == ssd_scan.forward(4, 2048, 64, 64, 1, 128, 256)
    assert ss.backward_cost(x, b, 256) == ssd_scan.backward(4, 2048, 64, 64, 1, 128, 256)
