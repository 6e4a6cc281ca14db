"""The port's ServeEngine against the JAX package's, and its driver.

On the same fp32 weights (carried across with ``convert.lm_from_reference``)
the two engines, fed the same requests, emit the same tokens: identical
``out`` lists for every request and identical tick and token counts.
Both make the reference's choices (admission order, token-by-token prompt
feed, greedy argmax, one lock-step ``pos``, caches not reset on admit),
so a request admitted into a used slot reads what its predecessor left
(the KV entries, or mamba2's convolution windows and SSM state); 6
requests over 4 slots exercise that, on the dense, mamba2 and moe
patterns, and on gemma2 (whose smoke window of 16 the lock-step
position passes), zamba2 (its nested cache) and llava (text only, as in
the reference).  Both engines and both drivers refuse the hubert
encoder, which has no decode step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_smoke_config
from repro.models import build_model
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro.sharding import single_device_ctx
from repro_torch.convert import lm_from_reference
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve as port_serve
from repro_torch.serve import Request, ServeEngine


def _requests(cls, n, max_tokens):
    return [cls(rid=i, prompt=[1 + i % 13, 2, 3], max_tokens=max_tokens)
            for i in range(n)]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "starcoder2-3b", "mamba2-1.3b",
                                  "llama4-scout-17b-a16e", "gemma2-27b", "zamba2-7b",
                                  "llava-next-mistral-7b"])
def test_engine_emits_reference_tokens(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = build_model(cfg, single_device_ctx())
    params = model.init(jax.random.key(0))
    ref = RefEngine(model, params, n_slots=4, smax=32)
    port = ServeEngine(lm_from_reference(params, cfg, device="cpu"),
                       n_slots=4, smax=32)
    ref_reqs, port_reqs = _requests(RefRequest, 6, 5), _requests(Request, 6, 5)
    for r, p in zip(ref_reqs, port_reqs):
        ref.submit(r)
        port.submit(p)
    want, got = ref.run(), port.run()
    assert [p.out for p in port_reqs] == [r.out for r in ref_reqs]
    assert all(p.done for p in port_reqs)
    assert (got["ticks"], got["tokens"]) == (want["ticks"], want["tokens"])
    # the reference counts the fed-back prompt tokens toward max_tokens,
    # so a 3-token prompt ends after max_tokens + 1 generated tokens
    assert port.pos == ref.pos and got["tokens"] == 6 * (5 + 1)


def test_engine_stops_at_smax():
    """A cache that fills stops the engine, as in the reference."""
    cfg = dataclasses.replace(get_smoke_config("phi3-mini-3.8b"), dtype="float32")
    model = build_model(cfg, single_device_ctx())
    params = model.init(jax.random.key(1))
    ref = RefEngine(model, params, n_slots=2, smax=8)
    port = ServeEngine(lm_from_reference(params, cfg, device="cpu"), n_slots=2, smax=8)
    ref_reqs, port_reqs = _requests(RefRequest, 3, 20), _requests(Request, 3, 20)
    for r, p in zip(ref_reqs, port_reqs):
        ref.submit(r)
        port.submit(p)
    want, got = ref.run(), port.run()
    assert got["ticks"] == want["ticks"] == 8
    assert [p.out for p in port_reqs] == [r.out for r in ref_reqs]
    assert len(port.queue) == 1 and not port_reqs[0].done


def test_serve_driver_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --smoke --device cpu``: the
    reference's defaults (16 requests, 8 slots, smax 128, 16 new tokens
    each) on the CPU, through the attention's plain version."""
    before = flash_attention.launches
    stats = port_serve.main(["--smoke", "--device", "cpu", "--seed", "3"])
    assert flash_attention.launches == before
    assert stats["tokens"] == 16 * (16 + 1) and stats["ticks"] > 0
    assert "internlm2-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("arch,name", [("mamba2-1.3b", "mamba2-smoke"),
                                       ("llama4-scout-17b-a16e", "llama4-smoke")])
def test_serve_driver_new_patterns_on_cpu(capsys, arch, name):
    """``--arch mamba2-1.3b`` and ``--arch llama4-scout-17b-a16e`` with
    ``--smoke --device cpu`` and the depth cut to 2 layers: every request
    finishes, and no kernel launches (the CPU takes the plain versions)."""
    from repro_torch.kernels.moe_gemm import moe_grouped_gemm
    from repro_torch.kernels.ssd_scan import ssd_scan

    before = (ssd_scan.launches, moe_grouped_gemm.launches, flash_attention.launches)
    stats = port_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                             "--requests", "5", "--slots", "3", "--max-tokens", "4",
                             "--layers", "2"])
    assert (ssd_scan.launches, moe_grouped_gemm.launches,
            flash_attention.launches) == before
    assert stats["tokens"] == 5 * (4 + 1)
    assert f"{name} (2 layers)" in capsys.readouterr().out


@pytest.mark.parametrize("arch,name,layers", [
    ("gemma2-27b", "gemma2-smoke", 2), ("zamba2-7b", "zamba2-smoke", 4),
    ("llava-next-mistral-7b", "llava-smoke", 2)])
def test_serve_driver_families_on_cpu(capsys, arch, name, layers):
    """``--arch`` gemma2, zamba2 (4 layers: one application of its shared
    block) and llava with ``--smoke --device cpu``: every request
    finishes, and no kernel launches."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    before = (ssd_scan.launches, flash_attention.launches)
    stats = port_serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                             "--requests", "5", "--slots", "3", "--max-tokens", "4",
                             "--layers", str(layers)])
    assert (ssd_scan.launches, flash_attention.launches) == before
    assert stats["tokens"] == 5 * (4 + 1)
    assert f"{name} ({layers} layers)" in capsys.readouterr().out


def test_encoder_is_not_served(monkeypatch):
    """hubert has no decode step: the reference's engine asserts and its
    driver exits; the port's engine raises and its driver exits with the
    reference's message."""
    from repro.launch import serve as ref_serve

    cfg = dataclasses.replace(get_smoke_config("hubert-xlarge"), dtype="float32")
    model = build_model(cfg, single_device_ctx())
    params = model.init(jax.random.key(0))
    with pytest.raises(AssertionError, match="encoder"):
        RefEngine(model, params, n_slots=2, smax=8)
    with pytest.raises(ValueError, match="encoder"):
        ServeEngine(lm_from_reference(params, cfg, device="cpu"), n_slots=2, smax=8)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "hubert-xlarge", "--smoke"])
    with pytest.raises(SystemExit) as ref_exit:
        ref_serve.main()
    with pytest.raises(SystemExit) as port_exit:
        port_serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    assert str(port_exit.value) == str(ref_exit.value) == "encoder-only archs have no decode path"
