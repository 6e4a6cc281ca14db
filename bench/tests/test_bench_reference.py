"""The plain reference against the port's CPU path: internlm2-smoke and
mamba2-smoke in fp32, two AdamW steps (the schedule's first step moves
nothing), every loss, every leaf's first-gradient norm and every leaf's
value after the steps.  The reference imports nothing of the port; the
test holds one against the other."""

import pytest
import torch

from bench import harness, weights
from bench.reference import common

SMOKE = {
    "internlm2-smoke": dict(block_pattern="dense", n_layers=3, d_model=64, n_heads=4,
                            n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                            rope_theta=1e6, tie_embeddings=False),
    "mamba2-smoke": dict(block_pattern="mamba2", n_layers=3, d_model=64, n_heads=1,
                         n_kv_heads=1, head_dim=16, d_ff=0, vocab=512, tie_embeddings=True,
                         ssm=dict(d_state=16, head_dim=16, expand=2, d_conv=4, n_groups=1,
                                  chunk=32)),
}
OPT = dict(lr=1e-3, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0,
           warmup_steps=2, total_steps=1000, min_lr_frac=0.1)


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_equals_the_port_in_fp32(name):
    from repro_torch.models.model import TransformerLM
    from repro_torch.train.optimizer import AdamWSettings
    from repro_torch.train.train_loop import TrainStepBuilder

    cfg = dict(SMOKE[name], name=name, dtype="float32", rms_norm_eps=1e-6)
    dev = torch.device("cpu")
    init = weights.draw(cfg, 2**31 + 5, dev)
    traffic = dict(batch=2, seq=64, markov_k=64, ring=2)
    batches = harness.ring(cfg, traffic, 2**31 + 5)

    model = TransformerLM(harness.lm_config(cfg), device=dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    builder = TrainStepBuilder(model, AdamWSettings(**OPT))
    state = builder.init_state()
    losses, norms = [], None
    for i, b in enumerate(batches):
        state, met = builder.train_step(state, b)
        losses.append(float(met["loss"]))
        if i == 0:
            norms = float(met["grad_norm"])
    ref = common.train(init, batches, cfg, OPT, keep=True)
    assert losses == pytest.approx(ref.losses, rel=1e-5)
    # the first step's global norm, before clipping: the clipped leaf norms
    # scaled back where the reference clipped
    total = sum(v * v for v in ref.grad_norms.values()) ** 0.5
    assert min(norms, OPT["clip_norm"]) == pytest.approx(total, rel=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), ref.params[n], rtol=1e-5, atol=1e-6, msg=n)
        assert not torch.equal(ref.params[n], init[n].float()), f"{n} did not move"


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_ssd_and_attention_blocks_match_at_several_chunks(name):
    """The reference's loss does not depend on its own block sizes (the
    attention's query blocks, the loss's row blocks, the SSD's chunk)."""
    cfg = dict(SMOKE[name], name=name, dtype="float32", rms_norm_eps=1e-6)
    dev = torch.device("cpu")
    init = {n: t.float() for n, t in weights.draw(cfg, 3, dev).items()}
    b = harness.ring(cfg, dict(batch=2, seq=64, markov_k=64, ring=1), 3)[0]
    base = common.loss(init, b["tokens"], b["labels"], cfg, common.Precision()).item()
    old = (common.QUERY_BLOCK, common.LOSS_ROWS)
    try:
        common.QUERY_BLOCK, common.LOSS_ROWS = 16, 24
        cfg2 = dict(cfg, ssm=dict(cfg["ssm"], chunk=16)) if "ssm" in cfg else cfg
        other = common.loss(init, b["tokens"], b["labels"], cfg2, common.Precision()).item()
    finally:
        common.QUERY_BLOCK, common.LOSS_ROWS = old
    assert other == pytest.approx(base, rel=1e-6)
