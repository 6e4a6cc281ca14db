"""End-to-end driver on PyTorch: train a ~100M-parameter LM.

    python examples/train_lm_100m_torch.py [--steps 60] [--d-model 640] [--device cpu]

The twin of examples/train_lm_100m.py on the port (``repro_torch``):
config -> TransformerLM (each layer rematerialised in the backward) ->
AdamW (fp32 masters over the stacked leaves) -> the deterministic
sharded token pipeline -> a checkpoint at mid-run and a restore from it
(a simulated preemption) -> the run resumes exactly.  The DGTP infeed
planner runs first, as it would on a multi-pod job.  On the card the
attention runs the flash kernels forward and backward; ``--device cpu``
runs their plain versions (slow at the default sizes: cut --steps,
--batch or --seq).
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.core import resolve_device
from repro_torch.core.infeed_planner import LMJobSpec, plan_infeed
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import TransformerLM
from repro_torch.models.config import LMConfig
from repro_torch.train import (
    AdamWSettings,
    TrainStepBuilder,
    latest_checkpoint,
    restore_state,
    save_state,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--layers", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = LMConfig(
        name="lm-100m", block_pattern="dense",
        n_layers=args.layers, d_model=args.d_model,
        n_heads=args.d_model // 64, n_kv_heads=args.d_model // 128,
        d_ff=4 * args.d_model, vocab=32_000,
    )
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    # plan host-level infeed for the production job shape first
    spec = LMJobSpec(cfg=cfg, global_batch=256, seq_len=4096, n_pods=2)
    ip = plan_infeed(spec, budget=150, device=device)
    print("infeed plan:", ip.summary())

    model = TransformerLM(cfg, device=device)
    builder = TrainStepBuilder(
        model, AdamWSettings(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    )
    state = builder.init_state(torch.Generator(device=device).manual_seed(0))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0)

    ckpt_dir = Path(tempfile.mkdtemp(prefix="lm100m_ckpt_"))
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        state, metrics = builder.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(
                f"step {step:4d} loss {losses[-1]:.3f} "
                f"gnorm {float(metrics['grad_norm']):.2f} "
                f"lr {metrics['lr']:.2e}"
            )
        if step == args.steps // 2:
            save_state(ckpt_dir, state)
            print(f"checkpointed at step {state.step}; simulating preemption+restore")
            state = restore_state(latest_checkpoint(ckpt_dir), state)
            assert state.step == step + 1
    dt = time.time() - t0
    toks = args.steps * args.batch * args.seq
    print(
        f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps "
        f"({toks/dt:.0f} tok/s on {device})"
    )
    assert losses[-1] < losses[0], "loss must decrease"


if __name__ == "__main__":
    main()
