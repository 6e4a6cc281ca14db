"""Training driver: the LM on TokenPipeline batches, with checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 20 --batch 4 --seq 2048 --ckpt-dir /tmp/run1   # on the card

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke --device cpu \
        --mesh host --tp 2                                      # 2 x 2 gloo ranks

The port of ``repro.launch.train`` with the same flags and defaults, plus
``--device`` (default: the CUDA card; it raises when there is none) and
``--tp`` (the host mesh's model axis).  ``--mesh host`` runs on the ranks
``torchrun`` started (gloo on the CPU, which needs ``--device cpu``; NCCL
on cards), or on one rank without ``torchrun``; ``pod`` and ``multipod``
on 256 or 512 of them: every rank draws the same weights, keeps its
shards (``TransformerLM.shard_parameters``) and steps on its dp shard of
each batch; rank 0 prints.  With ``--ckpt-dir`` on a mesh every leaf
is gathered whole to rank 0's host, slice by slice, and rank 0 writes it
(the same files as without a mesh, ``train_loop.save_state``); each rank
restores its shards from the latest checkpoint, whether a mesh wrote it
or not.
Features: DGTP infeed planning (``--plan-infeed``, the port's
``plan_infeed``), the deterministic sharded data pipeline, AdamW with
optional gradient accumulation and bf16 first moments with a factored
second moment (``--opt8``), periodic checkpoints with exact resume from
the latest, straggler tracking.  Frontend archs (hubert's frames,
llava's patches) are refused, as the reference refuses them; every other
arch trains on the card as on the CPU (the attention, grouped-GEMM and
SSD kernels each have a backward).  A configuration that does not fit
the card fails with PyTorch's out-of-memory error.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from .. import configs as cfgs
from ..core.engine import resolve_device
from ..core.infeed_planner import LMJobSpec, plan_infeed
from ..data.pipeline import TokenPipeline
from ..models.model import TransformerLM
from ..train.checkpoint import latest_checkpoint
from ..train.fault_tolerance import StragglerPolicy
from ..train.optimizer import AdamWSettings
from ..sharding import ctx_for_mesh
from ..train.train_loop import TrainStepBuilder, restore_state, save_state
from .mesh import init_ranks, make_host_mesh, make_production_mesh


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=cfgs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--opt8", action="store_true", help="bf16 m + factored v")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--plan-infeed", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "host", "pod", "multipod"])
    ap.add_argument("--tp", type=int, default=1, help="the host mesh's model axis")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda; raises without a card)")
    args = ap.parse_args(argv)

    cfg = cfgs.get_smoke_config(args.arch) if args.smoke else cfgs.get_config(args.arch)
    if cfg.frontend is not None:
        raise SystemExit("frontend-stub archs train via inputs.train_batch; "
                         "use the dry-run for their full shapes")
    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.mesh != "none":
        rank, _ = init_ranks(device.type)
        mesh = (make_host_mesh(model=args.tp) if args.mesh == "host"
                else make_production_mesh(multi_pod=args.mesh == "multipod"))
    say = print if rank == 0 else (lambda *a, **k: None)

    if args.plan_infeed:
        spec = LMJobSpec(cfg=cfg, global_batch=256, seq_len=4096, n_pods=2)
        say("infeed plan:", plan_infeed(spec, budget=150, device=device).summary())

    opt = AdamWSettings(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                        total_steps=args.steps)
    if args.opt8:
        opt = dataclasses.replace(opt, m_dtype="bfloat16", factored_v=True)
    model = TransformerLM(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    if mesh is not None:
        model.shard_parameters(ctx_for_mesh(mesh))
    builder = TrainStepBuilder(model, opt, accum_steps=args.accum)
    say(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params, {device}, mesh={args.mesh}"
        + (f" {dict(zip(mesh.mesh_dim_names, mesh.shape))}" if mesh is not None else ""))

    state = builder.init_state()
    start = 0
    if args.ckpt_dir:
        latest = latest_checkpoint(args.ckpt_dir)
        if latest is not None:
            state = restore_state(latest, state)
            start = state.step
            say(f"resumed from step {start}")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0)
    straggler = StragglerPolicy()
    losses = []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
        state, metrics = builder.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        dt = time.perf_counter() - t0
        slow = straggler.observe(dt)
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"{dt*1e3:.0f}ms{'  STRAGGLER' if slow else ''}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_state(args.ckpt_dir, state)
    if args.ckpt_dir:
        save_state(args.ckpt_dir, state)
        say(f"final checkpoint at {args.ckpt_dir}")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return {"losses": losses, "start": start, "step": state.step}


if __name__ == "__main__":
    main()
