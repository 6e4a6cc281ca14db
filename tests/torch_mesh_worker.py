"""Worker of ``tests/test_torch_mesh.py``: gloo ranks on the CPU running the
port's mesh cases (no JAX here).

    python tests/torch_mesh_worker.py CASES.json

CASES.json holds ``{"world": N, "port": P, "cases": [...]}``; each case
names an arch, its mesh (data, model), attention mode, the weights and
batch (an ``.npz`` of the reference's leaves, ``leaf/...``, and
``tokens``, ``labels``) and an output ``.npz``.  Rank 0 writes the
case's loss, aux loss and gradients gathered whole (``grad/<leaf>``), and
for ``"step": true`` cases each leaf after two mesh AdamW steps and
after the same steps without a mesh (``mesh/<leaf>``, ``none/<leaf>``),
and the second step's loss and grad norm; for ``"decode": n`` cases the
logits of n decode steps of the batch's first row (batch 1: the cache's
positions sharded over dp) on the mesh and without it (``mesh_logits``,
``none_logits``), and the flash FLOPs that ``OpCounter`` counts on rank
0 in the mesh's last step (``flash_flops``); a case's ``"groups"`` sets
the mamba2 B/C groups; for ``"ckpt": DIR`` cases the checkpoints of
``_ckpt_case`` under DIR (the test compares their files).
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _params(npz):
    from repro_torch.train.optimizer import tree_build

    return tree_build([(tuple(k.split("/")[1:]), npz[k]) for k in npz.files
                       if k.startswith("leaf/")])


def _ckpt_case(case, cfg, params, batch, mesh):
    """Checkpoints on a mesh (AdamW, plain or with a factored second
    moment), each written by ``save_state`` under ``case["ckpt"]``:
    ``a`` after one mesh step; ``direct`` after a second step; ``resumed``
    after ``a`` restored into a fresh mesh state and the same second step;
    ``plain`` after ``a`` restored without a mesh and saved by rank 0;
    ``back`` after ``plain`` restored into a fresh mesh state.  The
    leaves are gathered in slices of at most 1 KiB, so that a sharded
    leaf takes several gathers, as a large one does at the default size.
    Returns the two second steps' losses."""
    import torch.distributed as dist

    from repro_torch.convert import lm_from_reference
    from repro_torch.sharding import ctx_for_mesh
    from repro_torch.train import latest_checkpoint, restore_state, save_state
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import AdamWSettings
    from repro_torch.train.train_loop import TrainStepBuilder

    train_loop._GATHER_BYTES = 1024
    root = Path(case["ckpt"])
    opt = AdamWSettings(lr=1e-2, warmup_steps=1, factored_v=case["factored"])

    def fresh(on_mesh):
        m = lm_from_reference(params, cfg, device="cpu")
        if on_mesh:
            m.shard_parameters(ctx_for_mesh(mesh))
        b = TrainStepBuilder(m, opt)
        return b, b.init_state()

    out = {}
    b, state = fresh(True)
    state, _ = b.train_step(state, batch)
    save_state(root / "a", state)
    state, met = b.train_step(state, batch)
    out["direct_loss"] = float(met["loss"])
    save_state(root / "direct", state)
    b, state = fresh(True)
    state = restore_state(latest_checkpoint(root / "a"), state)
    state, met = b.train_step(state, batch)
    out["resumed_loss"] = float(met["loss"])
    save_state(root / "resumed", state)
    _, state = fresh(False)
    state = restore_state(latest_checkpoint(root / "a"), state)
    if dist.get_rank() == 0:
        save_state(root / "plain", state)
    dist.barrier()
    _, state = fresh(True)
    state = restore_state(latest_checkpoint(root / "plain"), state)
    save_state(root / "back", state)
    return out


def _case(case):
    from repro_torch import configs
    from repro_torch.convert import lm_from_reference
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import ctx_for_mesh
    from repro_torch.train.optimizer import AdamWSettings
    from repro_torch.train.train_loop import TrainStepBuilder, stacked_weights
    from repro_torch.train.optimizer import tree_items

    cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]), dtype="float32",
                              attn_mode=case["mode"])
    if case.get("groups"):
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                               n_groups=case["groups"]))
    npz = np.load(case["inputs"])
    params = _params(npz)
    batch = {k: torch.from_numpy(npz[k]) for k in ("tokens", "labels")}
    mesh = make_host_mesh(model=case["model"])
    if case.get("ckpt"):
        return _ckpt_case(case, cfg, params, batch, mesh)
    model = lm_from_reference(params, cfg, device="cpu").shard_parameters(ctx_for_mesh(mesh))
    out = {}
    if case.get("decode"):
        from repro_torch.launch.op_cost import OpCounter

        n = case["decode"]
        plain = lm_from_reference(params, cfg, device="cpu")
        for tag, m in (("mesh", model), ("none", plain)):
            cache, logits = m.cache_struct(1, n), []
            for pos in range(n):
                counter = OpCounter() if tag == "mesh" and pos == n - 1 else None
                if counter is not None:
                    with counter:
                        cache, lg = m.decode_step(cache, batch["tokens"][:1, pos], pos)
                    out["flash_flops"] = counter.kernels["flash_attention"]["flops"]
                else:
                    cache, lg = m.decode_step(cache, batch["tokens"][:1, pos], pos)
                logits.append(lg)
            out[f"{tag}_logits"] = torch.stack(logits).numpy()
        return out
    if case.get("step"):
        # two steps: the schedule's first lr is 0
        opt = AdamWSettings(lr=1e-2, warmup_steps=1, factored_v=case.get("factored", False))
        plain = lm_from_reference(params, cfg, device="cpu")
        for tag, m in (("mesh", model), ("none", plain)):
            b = TrainStepBuilder(m, opt)
            state = b.init_state()
            for _ in range(2):
                state, met = b.train_step(state, batch)
            out[f"{tag}_loss"] = float(met["loss"])
            out[f"{tag}_gnorm"] = float(met["grad_norm"])
            if tag == "mesh":
                leaves = [(path, torch.stack([p.detach().full_tensor() for p in ps]) if st
                           else ps[0].detach().full_tensor())
                          for path, ps, st in m.leaf_groups()]
            else:
                leaves = list(tree_items(stacked_weights(m)))
            for path, w in leaves:
                out[f"{tag}/" + "/".join(path)] = w.numpy()
        return out
    local = TrainStepBuilder(model)._local_batch(batch)
    total, met = model.loss_fn(local)
    total.backward()
    out["loss"], out["aux_loss"] = float(met["loss"]), float(met["aux_loss"])
    for path, ps, st in model.leaf_groups():
        g = [p.grad.full_tensor() for p in ps]
        out["grad/" + "/".join(path)] = (torch.stack(g) if st else g[0]).numpy()
    return out


def _run(rank, spec):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{spec['port']}",
                            rank=rank, world_size=spec["world"])
    for case in spec["cases"]:
        out = _case(case)
        if rank == 0:
            np.savez(case["output"], **{k: np.asarray(v) for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    spec = json.loads(Path(sys.argv[1]).read_text())
    mp.spawn(_run, args=(spec,), nprocs=spec["world"])
