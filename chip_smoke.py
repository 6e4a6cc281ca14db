#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # on a machine with one CUDA card

Drives the port's paths on the card, DGTP planning, GraphSAGE training,
LM serving (dense, mamba2, MoE, gemma2, the zamba2 hybrid, the llava
patch prefix), encoding (hubert) and LM training (internlm2, llama4-scout,
mamba2-1.3b), and holds them against the port's own CPU path and against
the plain version of every kernel.
Phases, in order; any failure ends the run with a non-zero exit:

  1. build the five kernels (waterfill, sage_aggregate, and
     flash_attention, ssd_scan and moe_gemm each with its backward in a
     source of its own) from ``src/repro_torch/kernels/csrc`` with nvcc
     for sm_90a, one nvcc per source (eight), all started together; TF32
     off for fp32 products and convolutions;
  2. the waterfill kernel against its plain version on the card, at
     every shape the main path gives it (B=1024 with EG=1400, M=16 and
     with EG=72, M=4; B=1 with EG=72, M=4), on inputs with tied priority
     keys: exact equality, and device times; the chain probe at each
     shape (the kernel's dependent chain alone: its chain bound) and, at
     the papers shape, the plain shared-memory step and the
     one-NIC-a-lane shuffle form beside it;
  3. ``simulate_batch_torch`` at width 1024 on the papers100M job (J=117,
     E=1400, M=16, its first 2 of 10 iterations; the regimes phase runs
     4) and the products job (J=23, E=72, M=4, N=40), all five
     policies, on the card; the first 8 instances are held against the
     same 8 on the CPU (run in worker processes meanwhile, compared once
     phase 4 is done) at the engine's parity tolerance;
  4. ``plan()`` on the quickstart job and cluster (budget 120, 15
     simulated iterations, seed 0) and ``plan_baseline("distdgl")``, each
     committed schedule held against the CPU engine, and each Theorem-1
     certificate against the one built from the CPU engine's recorded
     schedule (and it holds);
  5. a profiled short run per job (the device's busy share, the kernel
     launches per iteration, the top device rows);
  5a. regimes: the 12 golden cells (static, dynamic, migration and
     priority on three jobs), built with the port's own builders, for all
     five policies on the card against ``tests/golden/golden_schedules.json``;
     then the papers job at full width (J=117, E=1400, M=16) and its
     first 4 of 10 iterations under a 6-segment drift trace with
     stragglers, each instance with its own migration flows (a store's
     restore and the moves from its base placement; none for the three
     bases), deadline shaping with deadlines from ``annotate_deadlines`` on
     a clean recorded run, and ``utilization=True``: fifo and oes at width
     1024, oes_strict, mrtf and omcoflow at 16; per policy evals/s,
     lock-step iterations, host syncs and waterfill launches (per
     iteration), ``class_gb`` summing to the delivered GB; the first 8
     instances against the CPU engine, and against the CPU engine under
     strict shaping (fifo, oes: some makespan must differ);
  5b. replan: ``run_scenario(strategy="replan", collect_traces=True)`` on
     the products job and drift trace of ``examples/dynamic_replan_torch.py``
     (budget 8), and ``Replanner.on_leave(3)`` under deadline shaping, on
     the card; each committed interval, its trace's blame (chain and
     components) and ``ScenarioOutcome.blame()`` against the CPU engine's
     recorded runs, and the leave record against the CPU engine;
  5c. tenants: ``joint_search`` on ``tests/test_multijob.py``'s pair
     (ogbn-products 4/3x2/1 for 12 iterations, reddit 4/2x2/1 for 8) on a
     4-machine cluster, ``merged_batch_cost`` of the winner and of each
     chain's start under oes and fifo, ``per_job_makespans`` of the
     winner; ``run_service`` with warm re-planning and traces on
     ``examples/arrivals.py``'s four tenants (``tenant_blame()`` conserves
     the epochs' makespans), and without on the tests'
     three-tenant mixed stream, with the EDF, SJF and RR orderings of it
     under oes and fifo (deadlines met printed for each);
  5d. cache: ``examples/cache_sweep.py``'s sections 2-4 (the replay
     sweep, the cache-adjusted makespans, cache-aware against
     cache-oblivious ETP), then the ogbn-products profile's hit model
     (its proxy trace) on the replan phase's products job:
     ``cache_aware_etp``, the winner judged by ``cache_cost_fns`` under
     oes and fifo, and a cache-aware ``Replanner`` through
     ``on_leave(3)`` (its per-machine budgets shrink);
  5e. obs: the products testbed job (its first 20 of 40 iterations)
     recorded under oes and fifo with
     ``utilization=True`` (``ScheduleTrace``, ``blame``, ``write_trace``
     and the file validated as read back; blame conserves the makespan,
     NIC integrals equal delivered GB and the engine's aggregates; both
     blame tables printed); ``examples/replan_failure.py``'s job through
     ``FailureController`` (a GraphSAGE state checkpointed from the card
     and restored bit for bit, then ``on_failure(2)`` at budget 2 and 4
     simulated iterations); ``plan_infeed`` on internlm2-1.8b (budget 4,
     8 chains); the slotted Alg. 1 oracle against the engine's
     ``oes_strict`` on ``tests/test_oes.py``'s tiny job.  Each unit of
     5c, 5d and 5e runs on the card and, meanwhile, on the CPU in a
     worker process: decisions, placements and critical-path chains equal
     exactly, times at the engine's parity tolerance;
  6. GraphSAGE at the ogbn-products widths (in 100, hidden 256, 47
     classes, 3 layers, fan-outs 5/10/15, 2000 seeds per batch) on a
     240,000-node synthetic graph: the aggregation kernel against its
     plain version at the three shapes one batch gives it (exact in
     fp32, 3e-2 in bf16, plus all-padding rows and an odd M), and its
     backward kernels against the plain backward on the CPU (exact in
     fp32), both giving the same bits on two runs; the forward's times
     beside its bound, the gather probe (its loads alone) and
     ``F.embedding_bag``, the backward's beside its bound and
     ``index_add_``, also on ids with three hubs named thousands of
     times; one forward and backward on the card against the same on
     the CPU; then five SGD steps, the measured-traffic calibration and
     ``plan_baseline("distdgl")`` (its fifo commit launches waterfill);
     then one profiled step, checked to hold every aggregation launch
     (the device's busy share; no ``index_add_`` left);
  7. LM serving (internlm2-1.8b, bf16, random weights from a seeded
     generator on the card): the attention kernel against its plain
     version at the five sweep shapes of ``tests/test_kernels.py``, at
     head dims 80 and 112 on every route (prefill, decode over several
     chunks, a window, a softcap, a row with no valid key), the prefill
     shape q [4, 16, 2048, 128] over 8 KV heads and the decode shape q
     [8, 16, 1, 128] against a [8, 2048, 8, 128] cache at three positions
     (fp32 within 2e-5, bf16 within 2e-2), with times beside its bound and
     ``F.scaled_dot_product_attention``, also at kimi-k2's decode shape q
     [8, 64, 1, 112], each timed decode giving the same bits on two runs;
     ``prefill`` of
     4 x 2048 tokens through the kernel (its 24 launches all on the wgmma
     route; the wall of a first and of a second, warm call) against the
     same with the plain attention; 2 layers at full width in fp32 on the
     card against the CPU, and decode against forward; decode against
     forward at full depth in bf16; then ``ServeEngine`` (16 requests, 8
     slots, smax 2048, 128 new tokens each) and one profiled tick;
  8. mamba_serve (mamba2-1.3b, bf16, full width and depth, random
     weights): the SSD scan kernel against its plain version at the
     sweep shapes of ``tests/test_kernels.py``, the smoke config's chunk
     of 32 and the prefill shape x [4, 2048, 64, 64] with d_state 128 and
     chunk 256, also as views of one projection (fp32 within 1e-4, bf16
     within 2e-2 of the output's largest magnitude; bf16 on the mma
     route, fp32 on the FMA route), times at the prefill shape on both
     routes and the mma route's share of its bound, the mma route giving
     the same bits on two runs; 2 layers at full width in fp32 on the
     card against the CPU, and decode against forward; then the prefill
     of 4 x 2048 tokens (its 48 launches all on the mma route) and
     ``ServeEngine`` at phase 7's traffic, the prefill against the plain
     scan and timed again warm, and one profiled tick;
  9. moe_serve (llama4-scout-17b-a16e, bf16, full width, 8 of its 48
     layers): the grouped GEMM kernel against its plain version at the
     sweep shapes (an empty expert, rows past the sum) and the decode
     (T = 8) and prefill (T = 8192) shapes, and kimi-k2's decode (T = 64
     over 384 experts), times beside the bound and ``torch._grouped_mm``,
     each timed decode giving the same bits on two runs; 2 layers in fp32,
     kernels against plain versions on the card, and decode against
     forward; then the prefill (its 24 moe_gemm and 8 flash launches all
     on the wgmma routes) and ``ServeEngine`` as in phase 8, and one
     profiled tick;
 10. kimi_serve (kimi-k2-1t-a32b, bf16, full width: d_model 7168, 64
     heads of 112 over 8 KV heads, 384 experts top-8; 1 of its 61 layers,
     as one layer's experts are 33.8 GB): the attention kernel at its
     prefill and decode shapes; the prefill (on the wgmma routes) and
     ``ServeEngine`` as in phase 8, the ticks on flash's decode and
     moe_gemm's streaming routes; the prefill against the plain path;
     decode against forward beside the same through the plain versions;
     one profiled tick;
 11. gemma2_serve (gemma2-27b, bf16, full width: d_model 4608, 32 heads
     of 128 over 16 KV heads, d_ff 36864, vocab 256000; 8 of its 46
     layers): the attention kernel at its prefill shape q [1, 32, 8192,
     128] (softcap 50, scale 144^-0.5) with window 4096 and without, and
     its decode shape q [8, 32, 1, 128] at position 6143 of a [8, 8192,
     16, 128] cache, windowed and global, against the plain version and
     timed; 2 layers in fp32 on the card against the CPU; decode against
     forward over 64 positions in bf16; the prefill of one 8192-token
     sequence (its 8 launches on the wgmma route, the even layers
     windowed) against the plain attention, then ``ServeEngine`` (8
     requests, 8 slots, smax 2048, 64 new tokens each: one wave) and one
     profiled tick;
 12. zamba2_serve (zamba2-7b, bf16, full width: d_model 3584, mamba2
     d_inner 7168 in 112 SSM heads of 64, d_state 64, chunk 256; its
     shared block 32 heads of 112 over 32 KV heads, d_ff 14336; 13 of 81
     layers: two groups of 6, each followed by the shared block, and 1
     trailing layer): ssd_scan at x [4, 2048, 112, 64] and the attention
     kernel at q [4, 32, 2048, 112] against their plain versions and
     timed; 7 layers in fp32 on the card against the CPU; decode against
     forward in bf16 (both shared-block applications' KV entries
     written); the 4 x 2048 prefill (ssd_scan on the mma route, flash
     on wgmma) against the plain path, ``ServeEngine`` as in phase 11
     and one profiled tick;
 13. llava_serve (llava-next-mistral-7b, bf16, full width and depth):
     the attention kernel at q [2, 32, 4928, 128] over 8 KV heads with
     window 4096; 2 layers in fp32 with a patch prefix on the card
     against the CPU; decode against forward on tokens; the prefill of 2
     x (2880 patch embeddings + 2048 tokens) (its 32 launches on wgmma,
     the window cutting) against the plain attention, ``ServeEngine`` as
     in phase 11 and one profiled tick;
 14. hubert_encode (hubert-xlarge, bf16, full width and depth: 48 layers,
     16 heads of 80, layernorm, GELU, bidirectional): the attention
     kernel at q [4, 16, 1500, 80], non-causal, against its plain
     version and timed beside ``F.scaled_dot_product_attention``; 2
     layers in fp32 on the card against the CPU; the forward over 4 x
     1500 frames to per-frame logits [4, 1500, 2048] (the padded entries
     -1e30; its 48 launches on wgmma) against the plain attention, its
     wall first and warm; ``decode_step``, ``cache_struct`` and
     ``ServeEngine`` refuse the encoder;
 15. lm_train (internlm2-1.8b, bf16, full width and depth, random
     weights): the attention's backward kernels against autograd through
     the plain version at internlm2's training shape q [4, 16, 2048, 128]
     over 8 KV heads, a small fp32 case, gemma2's window and softcap,
     hubert's non-causal D 80 and zamba2's D 112 (fp32 within 1e-4, bf16
     within 2e-2 of the largest gradient; two runs give the same bits;
     bf16 on the "wgmma" route, fp32 on "fma"), bf16 times beside the
     bound, the plain backward and SDPA's, and at the training shape one
     call's device time by kernel (delta, dK/dV, dQ) under the profiler;
     8 AdamW
     steps of ``TrainStepBuilder`` on the ``TokenPipeline`` stream's
     first 2 batches of 4 x 2048 tokens in turn (finite losses and grad
     norms, the loss falling, 48 forward and 24
     backward attention launches a step, every backward on the "wgmma"
     route), step wall, tokens/s and peak
     memory; two fp32 steps of a narrow config on
     the card against the CPU, a resumed run (train 2, save, restore,
     train 2) equal to 4 direct steps bit for bit under
     ``torch.use_deterministic_algorithms(True)``, and one step's bf16
     gradients at 2 full-width layers against the plain attention's;
 16. moe_train (llama4-scout-17b-a16e, bf16, full width, 1 of its 48
     layers): the grouped GEMM's backward kernels against the plain
     backward at its training shapes (gate/up x [4096, 5120], w [16, 5120,
     8192]; down x [4096, 8192], w [16, 8192, 5120]; a skewed routing with
     one expert holding most rows, two empty and rows past the sum) and a
     small fp32 case (fp32 within 1e-4, bf16 within 2e-2 of the largest
     gradient; two runs give the same bits; bf16 on the "wgmma" route,
     fp32 on "fma"), the gate/up backward timed beside its bound, the
     plain backward and ``torch._grouped_mm``'s backward, and its device
     time by kernel, dx and dw (under the profiler with ``--only``, else
     each kernel alone with events); 4 AdamW steps (bf16 first moments, a factored second
     moment) of ``TrainStepBuilder`` on the stream's first 2 batches of 2
     x 2048 tokens in turn (the loss falling; 6 grouped-GEMM and 2
     attention forward launches, 3 and 1 backward launches, a layer and
     step, the backwards on "wgmma"), step wall, tokens/s and peak memory; two
     fp32 steps of a narrow llama4 on the card against the CPU;
 17. mamba_train (mamba2-1.3b, bf16, full width and depth): the SSD scan's
     backward kernels against the plain backward at mamba2-1.3b's training
     shape (x [4, 2048, 64, 64], d_state 128, chunk 256) and zamba2's (x
     [4, 2048, 112, 64], d_state 64) on the wgmma route and a small fp32
     case with two groups on the FMA route (against the plain backward in
     fp64), the mamba2 backward timed beside its bound and the plain
     backward, and its device time by kernel; 4 AdamW steps on the
     stream's first 2 batches of 4 x 2048 tokens in turn (2 forward and 1
     backward scan launches a layer and step, the backwards on "wgmma"),
     step wall, tokens/s and peak memory; two
     fp32 steps of a narrow mamba2 and of a narrow zamba2 on the card
     against the CPU;
 17a. long_decode (zamba2-7b's long_500k cell: a decode at batch 1 over
     524288 positions, whose cache a mesh with dp > 1 shards by
     positions): the decode kernels' logsumexp (``return_lse``) against
     the plain version, bf16 ``flash_decode_mma`` with one chunk and many
     and fp32 ``flash_decode``, with a window, a softcap, a row with no
     key (exactly -1e30) and q_offset >= Sk, two runs and the serving
     call (no logsumexp) giving the same bits; the shared block's
     attention at full width (32 heads over 32 KV heads of 112, bf16)
     over a 524288-position cache drawn from a seed, at positions 1000,
     262143 and 524287: the whole-cache decode kernel against the plain
     version and against the dp ranks' parts (``layers.seq_shard_part``)
     merged in one process (``layers.merge_attention_parts``) at dp 2 and
     dp 16 (the pod's data axis: 32768 positions a rank), within 2e-2, and
     the whole-cache decode and one dp-16 rank's part timed beside their
     bounds; zamba2-7b at full width and 12 of its 81 layers (two
     shared-block applications, 15 GB of cache) at batch 1 with caches of
     524288 positions and mamba states drawn from a seed, 4 decode ticks
     at the last positions (2 flash launches a tick, on the decode route)
     against the same ticks through the plain attention, ms a tick and
     the peak memory; and ``_seq_sharded_decode`` on two gloo ranks
     sharing the card (a 65536-position cache), where gloo takes CUDA
     tensors, against the whole-cache decode (else the phase says so);
 18. mesh: a one-rank NCCL process group (a local ``HashStore``) and
     ``make_host_mesh()`` (data 1 x model 1); internlm2-1.8b at full width
     and depth in bf16 (seeded random weights) takes 2 AdamW steps of the
     mesh train step (``TransformerLM.shard_parameters``) on the stream's
     first batch of 4 x 2048, and the same 2 steps without the mesh: losses
     and grad norms equal within MESH_RTOL (1e-6 relative), and each
     parameter's sum after the steps within MESH_RTOL of its magnitude's
     sum (the first step's lr is 0), also for the narrow config in fp32; 48 forward and 24 backward flash launches a
     step, all on wgmma; step walls and peak memory; one more step under
     ``launch.op_cost.OpCounter``: its matmul FLOPs against 6 N tokens (in
     [1, 3]), HBM bytes, the roofline's three terms on the H100 constants
     (``launch.mesh``), the measured step and the step's MFU beside the
     card's name and power limit; a checkpoint round trip on the mesh
     (the narrow config in fp32 under deterministic algorithms: two steps,
     ``save_state`` gathering each leaf whole, a restore into a fresh mesh
     model, one more step equal bit for bit to the step without the round
     trip); then ``launch.dryrun`` of internlm2-1.8b
     train_4k on the pod mesh (a fake group of 256 ranks, in a subprocess
     without the card, started after every timed phase so that it shares
     the host's CPU with none of them): its memory, FLOPs and collective
     bytes by kind;
 19. the kernel table's JSON line (the flash and moe_gemm records also
     carry their prefill shape's times, ``prefill_ms``,
     ``prefill_bound_ms``, ``prefill_library_ms``, and kimi-k2's decode
     shape's, ``kimi_decode_ms``, ``kimi_decode_plain_ms``,
     ``kimi_decode_bound_ms``, ``kimi_decode_library_ms``, and the last
     four families' shapes', ``gemma2_*``, ``zamba2_*``, ``llava_*`` and
     ``hubert_*`` (``_ms``, ``_plain_ms``, ``_bound_ms``,
     ``_library_ms``, None where no PyTorch call computes a softcap), and
     phase 17a's ``long_decode_ms``, ``long_decode_plain_ms``,
     ``long_decode_bound_ms``, ``long_decode_library_ms`` (the
     whole-cache decode at position 524287), ``long_decode_shard_ms`` and
     ``long_decode_shard_bound_ms`` (one dp-16 rank's part),
     ``long_decode_lse_err`` and ``long_decode_gloo_cuda``;
     waterfill's its measured ``chain_bound_ms`` beside the bytes bound;
     ssd_scan's its paths' ``launches_by_route``, the FMA route's
     ``fma_ms`` and zamba2's prefill shape's ``zamba2_prefill_*``;
     sage_aggregate's the gather probe's ``probe_ms`` and its backward's
     ``bwd_ms``,
     ``bwd_bound_ms`` and ``bwd_library_ms``; flash's its backward's,
     ``bwd_ms``, ``bwd_plain_ms``, ``bwd_bound_ms``, ``bwd_library_ms``,
     ``bwd_source``, ``bwd_split_ms`` (device ms a call by kernel: the
     profiler's for flash and ssd_scan, moe_gemm's dx and dw each launched
     alone) and ``bwd_launches``, as are the moe_gemm and ssd_scan
     records' from phases 16 and 17), the card's name and power limit,
     and the closing status line.

Nineteen main paths, each with the kernel launch counts set to 0 just
before it and read just after: phases 3-4 (planning), phases 5a-5b (the
engine's regimes and re-planning), phase 5c (multi-job planning and the
arrival service), phase 5d (the feature-cache tier), phase 5e (traces
and blame, failure handling, the infeed planner), the training
steps, calibration and baseline plan of phase 6 (GraphSAGE), the
``ServeEngine`` run of phase 7 (LM serving), and the prefill followed by
the ``ServeEngine`` run of phases 8 (mamba2), 9 (MoE), 10 (kimi-k2), 11
(gemma2), 12 (zamba2) and 13 (llava), the forward to per-frame
logits of phase 14 (hubert), the training steps of phases 15, 16
and 17 (forward and backward counts), the long-context decode ticks of
phase 17a, and the mesh train steps of phase 18.
Each phase's seconds are printed on a ``[time]`` line.  ``--only
regimes`` (phases 5a-5b), ``tenants`` (5c), ``cache`` (5d), ``obs`` (5e), ``sage``,
``lm_serve``, ``mamba_serve``, ``moe_serve``, ``kimi_serve``,
``gemma2_serve``, ``zamba2_serve``, ``llava_serve``, ``hubert_encode``,
``lm_train``, ``moe_train``, ``mamba_train``, ``long_decode`` or ``mesh`` builds the
kernels and runs
that phase alone (for work on that path; it prints no
closing status line).
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

POLICIES = ("oes", "oes_strict", "fifo", "mrtf", "omcoflow")
WIDTH = 1024
N_CHECK = 8  # instances held against the CPU engine
# worker processes for the CPU references; they run while the card works,
# at a lower priority than the process that drives it
CPU_WORKERS = 6
# The smoke's depth cuts (the whole smoke took 1000.1 s of its 1200 in
# one run and past 1200 in another; with the engine and plan() cut as
# below, 1016.4 s on a host ~1.3-1.8x slower, the regimes phase 592.5 s
# of it; NVIDIA H100 80GB HBM3, 700 W; the engine is bound by the host,
# so batch width buys no time back): the engine phase simulates the
# papers job's first 2 of its 10 iterations, the regimes phase its first
# 5, and plan() searches with a budget of 160 evaluations (600, then 240
# before; cut to 160 to pay for the lm_train phase: the whole smoke took
# 760.8 s with 240 on a host ~1.2x slower than the one of 595.1 s).
ENGINE_PAPERS_ITERS = 2
REGIME_PAPERS_ITERS = 4
PLAN_BUDGET = 120
# H100 SXM data sheet: the fp64 and fp32 (non-tensor) peaks (the HBM rate and
# the bf16 tensor-core peak are repro_torch.launch.mesh's HBM_BW and
# PEAK_FLOPS_BF16, which the roofline uses too)
FP64_FLOP_PER_S = 34e12
FP32_FLOP_PER_S = 67e12
# GraphSAGE phase: the ogbn-products widths (core/profiles.py, and the
# reference's SageConfig defaults) and the paper's per-worker mini-batch;
# the graph is cut from ogbn-products' 2.4M nodes to 240k (a batch's
# support barely grows past this size, and building it costs host time)
SAGE_NODES = 240_000
SAGE_BATCH = 2000
SAGE_FANOUTS = (5, 10, 15)
SAGE_STEPS = 5
SAGE_ATOL = 1e-4  # card against CPU: logits, loss and gradients
BF16_ATOL = 3e-2  # the JAX package's kernel sweep tolerance for bf16
# LM serving phase: the default arch of launch/serve.py at full width
LM_ARCH = "internlm2-1.8b"
LM_PREFILL = (4, 2048)  # sequences, tokens
LM_REQUESTS, LM_SLOTS, LM_SMAX, LM_MAX_TOKENS = 16, 8, 2048, 128
# the attention sweep of tests/test_kernels.py and its tolerances
FLASH_SWEEP = [  # (b, h, sq, sk, d, causal, window, softcap)
    (1, 2, 256, 256, 64, True, None, None),
    (2, 1, 128, 256, 128, True, 64, None),
    (1, 2, 256, 256, 64, True, None, 30.0),
    (1, 1, 128, 128, 64, False, None, None),
    (2, 2, 384, 384, 32, True, 128, 50.0),
]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_POSITIONS = (0, 1023, 2047)
# mamba_serve: mamba2-1.3b at full width and depth, at phase 7's traffic;
# the scan's sweep shapes of tests/test_kernels.py (b, s, h, hd, ds, chunk)
MAMBA_ARCH = "mamba2-1.3b"
SSD_SWEEP = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 64, 64)]
# moe_serve: llama4-scout at full width and 8 of its 48 layers (its 16
# experts are 4.03 GB a layer in bf16: 48 layers do not fit one card);
# the grouped GEMM's sweep shapes of tests/test_kernels.py (t, d, f, e)
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 8
MOE_SWEEP = [(256, 128, 128, 4), (512, 256, 256, 8)]
# kimi_serve: kimi-k2-1t-a32b at full width and 1 of its 61 layers (its
# 384 experts are 33.8 GB a layer in bf16: two layers do not fit one card)
KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_LAYERS = 1
# decode logits against the forward's at the same positions, in bf16: at
# each position within 1e-2, or within 1.5x the same comparison through
# the plain versions there, whichever is larger.  bf16 products of other
# shapes (the forward's 128 rows against a decode step's 8) round
# differently, and at 7168 wide that alone moves a logit by 1-3e-2 (the
# plain path: 0.013-0.026, and 0.76-0.84 where a top-8 near-tie routes a
# token to another expert; the kernels: 0.014-0.030; NVIDIA H100 80GB HBM3
# at 700 W): the kernels must add no more than the plain path's rounding
KIMI_DECODE_ATOL = 1e-2
KIMI_DECODE_NOISE = 1.5
# the attention checks at head dims 80 and 112 on every route: (label, (B,
# H, KV, Sq, Sk, D), kwargs); prefill (fma in fp32, wgmma in bf16) and
# decode, a window, a softcap, an offset, rows with no valid key, chunks
FLASH_HEAD_DIM_CHECKS = [
    ("hd80 prefill", (2, 4, 2, 300, 300, 80), dict(causal=True, softcap=30.0)),
    ("hd112 prefill", (1, 8, 1, 333, 400, 112), dict(causal=True, window=100, q_offset=67)),
    ("hd80 decode", (3, 10, 2, 1, 900, 80), dict(causal=True, q_offset=850)),
    ("hd112 decode", (2, 16, 2, 1, 1500, 112), dict(causal=True, window=700, q_offset=1400)),
    ("hd112 decode, no valid key", (1, 8, 1, 1, 600, 112), dict(causal=True, window=4,
                                                               q_offset=700)),
]
# the new kernels against their plain versions, relative to the output's
# largest magnitude: fp32 differs only in the order of sums; bf16 rounds
# the output once (the plain versions round the same fp32 sums)
KERNEL_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a bf16 prefill through the kernels against the same prefill through the
# plain versions, relative to the largest plain logit: only the rounding
# differs, and it compounds over the layers (2.3% at internlm2-1.8b's 24
# layers, 5.1% at mamba2-1.3b's 48, 5.8% at llama4-scout's 8, on an NVIDIA
# H100 80GB HBM3 at 700 W); a wrong kernel moves logits by their own size
PREFILL_RTOL = 0.1
# 2 layers at full width in fp32, card against CPU: only the order of the
# sums differs (cuBLAS and the kernel against the CPU's BLAS and the plain
# version), ~1e-6 relative in fp32; 1e-3 on values of order 1-10 leaves
# room for the 2048- and 8192-long dot products over 2 layers
LM_FP32_ATOL = 1e-3


def _jobs():
    """(name, workload, cluster): the paper's simulation-study job and its
    testbed job (benchmarks/bench_algorithms.py, examples/quickstart.py)."""
    from repro_torch.core import (
        OGBN_PAPERS100M,
        OGBN_PRODUCTS,
        build_workload_from_profile,
        heterogeneous_cluster,
        testbed_cluster,
    )

    papers = build_workload_from_profile(
        OGBN_PAPERS100M, n_stores=16, n_workers=20, samplers_per_worker=4,
        n_ps=1, n_iters=10,
    )
    products = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2,
        n_ps=1, n_iters=40,
    )
    return [
        ("papers", papers, heterogeneous_cluster(16, seed=1)),
        ("products", products, testbed_cluster()),
    ]


def _candidates(wl, cluster, width, seed):
    """ETP-style candidate placements: the DistDGL placement and two IFS
    starts, each with 1-4 random non-store tasks moved to random machines
    (seeded), paired with the seeded draws realize(seed=b)."""
    from repro_torch.core import Placement, distdgl_placement, ifs_placement

    rng = np.random.default_rng(seed)
    bases = [distdgl_placement(wl, cluster)] + [
        ifs_placement(wl, cluster, seed=s) for s in (0, 1)
    ]
    movable = np.array(
        [j for j, t in enumerate(wl.tasks) if t.kind != "store"]
    )
    ys = []
    for b in range(width):
        y = bases[b % len(bases)].y.copy()
        if b >= len(bases):
            moved = rng.choice(movable, size=int(rng.integers(1, 5)), replace=False)
            y[moved] = rng.integers(0, cluster.M, size=len(moved))
        ys.append(y)
    placements = [Placement(y) for y in ys]
    reals = [wl.realize(seed=b) for b in range(width)]
    return placements, reals


def _first_iters(reals, n):
    """The realizations cut to their first ``n`` iterations."""
    from repro_torch.core import Realization

    return [Realization(r.volumes[:, :n], r.exec_times[:, :n]) for r in reals]


def _low_priority():
    """Worker initializer: the CPU references yield the host's cores to
    the process that drives the card."""
    import os

    os.nice(10)


def _cpu_reference(job, policy, ys, vols, exs):
    """Worker process: the first instances on the CPU engine."""
    import torch

    from repro_torch.core import Placement, Realization, simulate_batch_torch

    torch.set_num_threads(1)
    wl, cluster = {n: (w, c) for n, w, c in _jobs()}[job]
    res = simulate_batch_torch(
        wl, cluster, [Placement(y) for y in ys],
        [Realization(v, e) for v, e in zip(vols, exs)],
        policy=policy, record=True, device="cpu",
    )
    N = vols[0].shape[1]
    return (
        [r.makespan for r in res],
        np.stack([r.task_start_matrix(wl.J, N) for r in res]),
    )


def _assert_parity(name, ms_gpu, st_gpu, ms_cpu, st_cpu):
    from repro_torch.core import PARITY_ATOL, PARITY_RTOL

    ok_ms = np.allclose(ms_gpu, ms_cpu, rtol=PARITY_RTOL, atol=PARITY_ATOL)
    ok_st = np.allclose(st_gpu, st_cpu, rtol=PARITY_RTOL, atol=PARITY_ATOL,
                        equal_nan=True)
    if not (ok_ms and ok_st):
        raise AssertionError(
            f"{name}: cuda and cpu engines disagree "
            f"(makespans {ms_gpu} vs {ms_cpu})"
        )
    return float(np.max(np.abs(np.asarray(ms_gpu) - np.asarray(ms_cpu))))


def _waterfill_inputs(seed, B, EG, M):
    """Seeded kernel inputs with many tied priority keys (integer keys in
    [0, 4), stably sorted), random eligibility and some exhausted NICs."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 4, size=(B, EG)).astype(np.float64)
    order = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    src = rng.integers(0, M, size=(B, EG)).astype(np.int32)
    dst = rng.integers(0, M, size=(B, EG)).astype(np.int32)
    elig = rng.random((B, EG)) < 0.7
    cap_in = rng.uniform(0.0, 3.0, size=(B, M))
    cap_out = rng.uniform(0.0, 3.0, size=(B, M))
    cap_in[rng.random((B, M)) < 0.2] = 0.0
    return order, src, dst, elig, cap_in, cap_out


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _kernel_shapes():
    """(label, B, EG, M) of every waterfill launch on the main path: the
    engine at width 1024 on each job, and the width-1 DistDGL commit
    (fifo) on the products job."""
    shapes = [(job, WIDTH, wl.E, cl.M) for job, wl, cl in _jobs()]
    _, wl, cl = _jobs()[1]
    return shapes + [("products commit", 1, wl.E, cl.M)]


def phase_kernel(wf):
    """The kernel against its plain version at each main-path shape, on
    seeded inputs with tied keys.  Returns the numbers of the first (the
    papers job's) shape and the largest difference over all of them."""
    import torch

    from repro_torch.launch.mesh import HBM_BW

    rows = []
    for seed, (label, B, EG, M) in enumerate(_kernel_shapes()):
        args = [torch.from_numpy(a).cuda()
                for a in _waterfill_inputs(seed, B, EG, M)]
        got = wf.waterfill_fill(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wf.waterfill_fill_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(
                f"waterfill kernel != plain version at {label} (max {err})"
            )
        # device time (the host's issue time left out: at the products
        # shape it is longer than the kernel's), L2 not flushed: in the
        # engine the inputs come straight from the argsort and the masks
        ms = _device_ms(lambda: wf.waterfill_fill(*args), 50)
        # least time for the same work: each input read once, the output
        # written once; operations counted on this data (two compares per
        # eligible flow, two subtractions per grant) at the fp64 peak
        n_bytes = B * EG * (3 * 4 + 1 + 8) + 2 * B * M * 8
        n_elig = int(args[3].sum().item())
        n_grant = int((want > 0).sum().item())
        bytes_ms = n_bytes / HBM_BW * 1e3
        ops_ms = (2 * n_elig + 2 * n_grant) / FP64_FLOP_PER_S * 1e3
        print(
            f"[kernel] waterfill {label} B={B} EG={EG} M={M}: exact match; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
            f"{max(bytes_ms, ops_ms):.6f} ms ({n_bytes} bytes; dependent "
            f"chain {EG} steps per instance)",
            flush=True,
        )
        # the chain bound: the longest chain of these inputs (an
        # instance's eligible flows, the steps the kernel walks) alone, on
        # chip
        n_chain = int(args[3].sum(1).max().item())
        chain_ms, cycles = wf.chain_probe(n_chain, M)
        print(
            f"[kernel] waterfill chain probe EG={EG} M={M}: chain bound "
            f"{chain_ms:.6f} ms for the longest chain ({n_chain} eligible "
            f"steps; {cycles:.1f} cycles a step), {100 * chain_ms / ms:.1f}% "
            f"of the kernel's time",
            flush=True,
        )
        if not 0 < chain_ms < ms:
            raise AssertionError(f"waterfill at {label}: chain bound {chain_ms} ms "
                                 f"not in (0, kernel's {ms} ms)")
        if not rows:  # the papers shape: the other forms of the step
            for mode in ("kernel", "shared", "shuffle"):
                m_ms, m_cycles = wf.chain_probe(EG, M, mode=mode)
                print(f"[kernel] waterfill chain probe, {EG} steps, M={M}, {mode} "
                      f"form: {m_ms:.6f} ms ({m_cycles:.1f} cycles a step)", flush=True)
        rows.append(dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            max_abs_err=float((got - want).abs().max().item()),
            chain_bound_ms=chain_ms,
        ))
    out = dict(rows[0])
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return out


def phase_engine(wf, pool):
    """The engine at width 1024 on the card.  The CPU references of the
    first instances are submitted to ``pool`` first, so that they run
    while the card works; returns the candidates and the pending
    comparisons for ``check_engine``."""
    import torch

    from repro_torch.core import simulate_batch_torch

    cands = {}
    for job, wl, cluster in _jobs():
        placements, reals = _candidates(wl, cluster, WIDTH, seed=0)
        if job == "papers":
            reals = _first_iters(reals, ENGINE_PAPERS_ITERS)
        cands[job] = (wl, cluster, placements, reals)
    pending = []
    for job, (wl, cluster, placements, reals) in cands.items():
        ys = [p.y for p in placements[:N_CHECK]]
        vols = [r.volumes for r in reals[:N_CHECK]]
        exs = [r.exec_times for r in reals[:N_CHECK]]
        for policy in POLICIES:
            fut = pool.submit(_cpu_reference, job, policy, ys, vols, exs)
            pending.append((job, policy, fut))
    gpu = {}
    for job, (wl, cluster, placements, reals) in cands.items():
        print(f"[engine] {job}: J={wl.J} E={wl.E} M={cluster.M} "
              f"N={reals[0].n_iters} width={WIDTH}", flush=True)
        for policy in POLICIES:
            before = wf.waterfill_fill.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _sync_count() as syncs:
                res = simulate_batch_torch(
                    wl, cluster, placements, reals, policy=policy, record=True,
                    device="cuda",
                )
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = wf.waterfill_fill.launches - before
            iters = max(r.n_events for r in res)
            ms = np.array([r.makespan for r in res])
            if not (np.isfinite(ms).all() and (ms > 0).all()):
                raise AssertionError(f"{job}/{policy}: bad makespans")
            if policy in ("fifo", "mrtf") and launches == 0:
                raise AssertionError(f"{job}/{policy}: waterfill never launched")
            N = reals[0].n_iters
            gpu[(job, policy)] = (
                [r.makespan for r in res[:N_CHECK]],
                np.stack([r.task_start_matrix(wl.J, N) for r in res[:N_CHECK]]),
            )
            print(
                f"[engine] {job} {policy:10s} {WIDTH / wall:10.1f} evals/s "
                f"wall {wall:.2f} s, {iters} lock-step iterations "
                f"({iters / wall:.0f} it/s), mean makespan {ms.mean():.3f} s, "
                f"waterfill launches {launches} ({launches / iters:.2f} an "
                f"iteration), host syncs {syncs[0]} ({syncs[0] / iters:.2f} an "
                f"iteration)",
                flush=True,
            )
    return cands, pending, gpu


def check_engine(pending, gpu):
    """The card's first instances against the CPU engine's."""
    for job, policy, fut in pending:
        ms_cpu, st_cpu = fut.result()
        ms_gpu, st_gpu = gpu[(job, policy)]
        err = _assert_parity(f"{job}/{policy}", ms_gpu, st_gpu, ms_cpu, st_cpu)
        print(f"[engine] {job} {policy:10s} first {N_CHECK} instances match "
              f"the cpu engine (max makespan diff {err:.3g} s)", flush=True)


def phase_plan(wf):
    import torch

    from repro_torch.core import (
        OGBN_PRODUCTS,
        PARITY_ATOL,
        PARITY_RTOL,
        build_workload_from_profile,
        chain_lower_bound,
        plan,
        plan_baseline,
        simulate_torch,
        testbed_cluster,
    )

    wl = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=6, samplers_per_worker=2,
        n_ps=1, n_iters=40,
    )
    cluster = testbed_cluster()
    r = wl.realize(seed=0)
    before = wf.waterfill_fill.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = plan(wl, cluster, realization=r, budget=PLAN_BUDGET, sim_iters=15, seed=0,
             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dd = plan_baseline(wl, cluster, baseline="distdgl", realization=r,
                       device="cuda")
    torch.cuda.synchronize()
    launches = wf.waterfill_fill.launches - before
    for name, pl, policy in (("dgtp", p, "oes"), ("distdgl", dd, "fifo")):
        ref = simulate_torch(wl, cluster, pl.placement, r, policy=policy,
                             record=True, device="cpu")
        _assert_parity(
            f"plan/{name}", [pl.schedule.makespan],
            pl.schedule.task_start_matrix(wl.J, r.n_iters)[None],
            [ref.makespan], ref.task_start_matrix(wl.J, r.n_iters)[None],
        )
        # the Theorem-1 certificate from the card's recorded schedule, and
        # from the cpu engine's recorded schedule of the same placement
        cert = pl.certificate
        want = chain_lower_bound(wl, cluster, pl.placement, r, ref)
        if not (cert.holds and (cert.delta, cert.chain_len) == (want.delta, want.chain_len)
                and np.isclose(cert.lower_bound, want.lower_bound,
                               rtol=PARITY_RTOL, atol=PARITY_ATOL)):
            raise AssertionError(f"plan/{name}: certificate {cert} != {want} or "
                                 "does not hold")
        print(f"[plan] {name} certificate: lower bound {cert.lower_bound:.4f} s, "
              f"Delta {cert.delta}, chain of {cert.chain_len}, ratio "
              f"{cert.ratio:.3f}, holds; equal to the cpu engine's "
              f"({len(pl.schedule.flow_log)} flow-log entries)", flush=True)
    sp = 100 * (1 - p.schedule.makespan / dd.schedule.makespan)
    print(
        f"[plan] quickstart job: DGTP makespan {p.schedule.makespan:.3f} s, "
        f"DistDGL {dd.schedule.makespan:.3f} s, speedup {sp:.1f}%; planning "
        f"wall {wall:.1f} s ({p.etp.evaluations} evaluations, "
        f"{len(p.etp.chain_stats)} chains); waterfill launches {launches}; "
        f"both committed schedules match the cpu engine",
        flush=True,
    )


def _device_us(avg):
    return getattr(avg, "self_device_time_total", None) or getattr(
        avg, "self_cuda_time_total", 0.0
    )


# spin kernels that open every trace: the profiler drops a trace's first
# device rows, more of them the longer the process has run (one process
# kept 10, 7, 4, 2, 0 of a short trace's 10 rows over two minutes:
# ``profiler_probe.py``; after the whole smoke's earlier phases, a trace
# of one short call kept none), so a trace counts only once a row of its
# spin kernels survives, the work's rows after them then whole
TRACE_SPINS = 256


def _traced(fn, device_only=False):
    """Runs ``fn`` under ``torch.profiler`` (the device's activity alone
    with ``device_only``, else the host's too), after TRACE_SPINS spin
    kernels (``torch.cuda._sleep``) and the card synchronized; again, with
    four times the spins, up to three times while the trace keeps no spin
    kernel's row.  Returns ``fn``'s result and the trace's device rows
    (``key_averages``, largest first), the spin kernels' left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] if device_only else [ProfilerActivity.CPU,
                                                         ProfilerActivity.CUDA]
    spins = TRACE_SPINS
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            for _ in range(spins):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            out = fn()
            torch.cuda.synchronize()
        rows = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
        kept = sum(a.count for a in rows if "spin_kernel" in a.key)
        if kept:
            break
        print(f"[trace] attempt {attempt + 1}: none of {spins} spin kernels' rows kept",
              flush=True)
        spins *= 4
    rows = sorted((a for a in rows if "spin_kernel" not in a.key), key=_device_us,
                  reverse=True)
    return out, rows


def phase_profile(cands):
    """Where the engine's time goes: one short run per cell unprofiled,
    then the same run under torch.profiler, tracing the device only (the
    host's operator events are not read: with them the phase took 116.6
    s for ~8 s of runs; NVIDIA H100 80GB HBM3, 700 W).  Device time is
    summed over the profiler's device rows (kernels and copies), and set
    against both runs' wall times.  Not part of the main path (its
    launches are not counted)."""
    import torch

    from repro_torch.core import simulate_batch_torch

    for job, policy, n_iters in (("papers", "fifo", 1), ("products", "oes", 2)):
        wl, cluster, placements, reals = cands[job]
        short = _first_iters(reals, n_iters)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate_batch_torch(wl, cluster, placements, short,
                                       policy=policy, device="cuda")
            torch.cuda.synchronize()
            return time.perf_counter() - t0, max(r.n_events for r in res)

        wall, iters = run()
        (wall_p, _), rows = _traced(run, device_only=True)
        if not rows:
            raise AssertionError(f"profile {job}: the profiler traced no device time")
        kernels = [a for a in rows if not a.key.startswith(("Memcpy", "Memset"))]
        dev_ms = sum(_device_us(a) for a in rows) / 1e3
        kern_ms = sum(_device_us(a) for a in kernels) / 1e3
        n_kernels = sum(a.count for a in kernels)
        print(
            f"[profile] {job} {policy} width {WIDTH}, {n_iters} iteration(s): "
            f"{iters} lock-step iterations, wall {wall:.3f} s unprofiled, "
            f"{wall_p:.3f} s profiled; device busy {dev_ms:.1f} ms "
            f"({kern_ms:.1f} ms in kernels), {100 * dev_ms / 1e3 / wall_p:.1f}% "
            f"of the profiled wall, {100 * dev_ms / 1e3 / wall:.1f}% of the "
            f"unprofiled; {n_kernels} kernel launches "
            f"({n_kernels / iters:.0f} per iteration)",
            flush=True,
        )
        for a in rows[:6]:
            print(f"[profile]   {_device_us(a) / 1e3:9.1f} ms {a.count:7d}x "
                  f"{a.key[:70]}", flush=True)


GOLDEN = ROOT / "tests" / "golden" / "golden_schedules.json"
# the regimes phase: the papers job under a drift trace, migration flows
# and deadline shaping, at these widths (the three slower policies cut to
# 16; the engine is bound by the host's launches per lock-step iteration,
# so a narrower batch saves little: 47-68 s at 64 against fifo's 62 at
# 1024, NVIDIA H100 80GB HBM3, 700 W)
REGIME_WIDTH = {"fifo": WIDTH, "oes": WIDTH, "oes_strict": 16, "mrtf": 16,
                "omcoflow": 16}
# the trace's horizon: ~1.2x the first candidate's static makespan over
# REGIME_PAPERS_ITERS iterations (oes: 12.27 s over 5, 24.2 s over 10; so
# ~9.8 s over 4)
REGIME_HORIZON_S = 11.76
# policies whose first instances also run under strict shaping, on the CPU
STRICT_POLICIES = ("fifo", "oes")
# the replan phase: the example's job and trace (examples/dynamic_replan_torch.py)
# at a fifteenth of its search budget (120): an evaluation is ~1-2.6 s of
# host launches on the card (budget 120: 301 s for the scenario, 218 s for
# the leave; NVIDIA H100 80GB HBM3, 700 W)
REPLAN_INTERVALS, REPLAN_ITERS, REPLAN_BUDGET = 4, 8, 8


def _golden_cells():
    """The 12 cells of the golden suite (tests/test_golden_schedules.py),
    built with the port's own builders: (job, regime, workload, cluster,
    placement, realization, trace, flows, shaping)."""
    from repro_torch.core import (
        MigrationFlow,
        build_gnn_workload,
        heterogeneous_cluster,
        ifs_placement,
    )
    from repro_torch.dynamics import DynamicsEvent, trace_from_events

    common = dict(n_iters=4)
    jobs = [
        ("fanin", 0, build_gnn_workload(
            n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1, **common,
            store_to_sampler_gb=1.0, sampler_to_worker_gb=0.5, grad_gb=0.2,
            store_exec_s=0.3, sampler_exec_s=0.4, worker_exec_s=0.8,
            ps_exec_s=0.2, pmr=1.3)),
        ("chain", 1, build_gnn_workload(
            n_stores=3, n_workers=1, samplers_per_worker=1, n_ps=2, n_iters=5,
            store_to_sampler_gb=2.0, sampler_to_worker_gb=1.0, grad_gb=0.1,
            store_exec_s=0.2, sampler_exec_s=0.3, worker_exec_s=1.0,
            ps_exec_s=0.15, pmr=1.0)),
        ("ring", 2, build_gnn_workload(
            n_stores=2, n_workers=3, samplers_per_worker=1, n_ps=1, **common,
            store_to_sampler_gb=0.8, sampler_to_worker_gb=0.6, grad_gb=0.3,
            store_exec_s=0.25, sampler_exec_s=0.35, worker_exec_s=0.7,
            ps_exec_s=0.2, pmr=1.16, sync="allreduce")),
    ]
    for name, seed, wl in jobs:
        cluster = heterogeneous_cluster(3, seed=seed)
        placement = ifs_placement(wl, cluster, seed=0)
        realization = wl.realize(seed=seed)
        dyn = trace_from_events(cluster, [
            DynamicsEvent(t0=1.5, t1=6.0, machine=0, bw_scale=0.4),
            DynamicsEvent(t0=3.0, machine=None, bw_scale=0.75, slowdown=1.2),
        ])
        y, M, J = placement.y, cluster.M, wl.J
        src0, src1 = int((y[0] + 1) % M), int((y[J - 1] + 2) % M)
        migs = [
            MigrationFlow(src=src0, dst=int(y[0]), gb=1.2, task=0),
            MigrationFlow(src=src1, dst=int(y[J - 1]), gb=0.8, task=J - 1),
            MigrationFlow(src=0, dst=1, gb=0.5),
        ]
        migs_pri = [
            MigrationFlow(src=src0, dst=int(y[0]), gb=1.2, task=0, deadline=0.5),
            MigrationFlow(src=src1, dst=int(y[J - 1]), gb=0.8, task=J - 1,
                          deadline=3.0),
            MigrationFlow(src=0, dst=1, gb=0.5),
        ]
        for regime, trace, flows, shaping in (
            ("static", None, None, None),
            ("dynamic", dyn, None, None),
            ("migration", dyn, migs, None),
            ("priority", dyn, migs_pri, "deadline"),
        ):
            yield name, regime, wl, cluster, placement, realization, trace, flows, shaping


def _regime_inputs():
    """The papers job's 1024 candidates (as in phase 3, over its first
    ``REGIME_PAPERS_ITERS`` iterations) and each instance's migration
    flows: the state moves from its base placement to it
    (``build_migration_flows``), and the restore of one store's partition
    from its ring successor, as after that machine left (none for the
    three bases themselves)."""
    from repro_torch.core import MigrationFlow, distdgl_placement, ifs_placement
    from repro_torch.dynamics import build_migration_flows, default_task_state_gb

    _, wl, cluster = _jobs()[0]
    placements, reals = _candidates(wl, cluster, WIDTH, seed=0)
    reals = _first_iters(reals, REGIME_PAPERS_ITERS)
    bases = [distdgl_placement(wl, cluster)] + [
        ifs_placement(wl, cluster, seed=s) for s in (0, 1)
    ]
    state = default_task_state_gb(wl, cluster)
    migs = [None] * 3
    for b, p in enumerate(placements[3:], start=3):
        g = wl.store_tasks[b % len(wl.store_tasks)]
        restore = MigrationFlow(src=int((p.y[g] + 1) % cluster.M), dst=int(p.y[g]),
                                gb=float(state[g]), task=int(g))
        migs.append([restore] + build_migration_flows(bases[b % 3].y, p.y, state))
    return wl, cluster, placements, reals, migs


def _cpu_regime(policy, ys, vols, exs, migs, trace, shaping="deadline"):
    """Worker process: the first regime instances on the CPU engine."""
    import torch

    from repro_torch.core import Placement, Realization, simulate_batch_torch

    torch.set_num_threads(1)
    _, wl, cluster = _jobs()[0]
    res = simulate_batch_torch(
        wl, cluster, [Placement(y) for y in ys],
        [Realization(v, e) for v, e in zip(vols, exs)], policy=policy,
        record=True, trace=trace, migrations=migs, shaping=shaping,
        device="cpu",
    )
    N = vols[0].shape[1]
    return (
        [r.makespan for r in res],
        np.stack([r.task_start_matrix(wl.J, N) for r in res]),
    )


@contextlib.contextmanager
def _sync_count():
    """Counts the host syncs of the block (torch's sync debug mode warns
    once per synchronizing call; the warnings are recorded, not shown)."""
    import warnings

    import torch

    got = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield got
        finally:
            torch.cuda.set_sync_debug_mode("default")
    got.append(sum("synchroniz" in str(w.message) for w in caught))


def phase_regimes(wf, pool):
    """The engine's regimes on the card: the 12 golden cells from the
    port's own builders against the pinned JSON, then the papers job under
    a drift trace, per-instance migration flows, deadline shaping and
    utilization; the first instances against the CPU engine (submitted to
    ``pool`` first).  Returns the pending comparisons."""
    import torch

    from repro_torch.core import (
        PARITY_ATOL,
        PARITY_RTOL,
        simulate_batch_torch,
        simulate_torch,
    )
    from repro_torch.dynamics import annotate_deadlines, drift_trace

    golden = json.loads(GOLDEN.read_text())
    t0 = time.perf_counter()
    n = 0
    for name, regime, wl, cl, p, r, trace, flows, shaping in _golden_cells():
        for policy in POLICIES:
            res = simulate_torch(wl, cl, p, r, policy=policy, record=True,
                                 trace=trace, migrations=flows, shaping=shaping,
                                 device="cuda")
            pin = golden[name][regime][policy]
            _assert_parity(f"golden {name}/{regime}/{policy}", [res.makespan],
                           res.task_start_matrix(wl.J, r.n_iters)[None],
                           [pin["makespan"]], np.array(pin["task_start"])[None])
            n += 1
    print(f"[regimes] {n} golden cells (12 job/regime cells x 5 policies, built "
          f"with the port's builders) match tests/golden/golden_schedules.json "
          f"on the card ({time.perf_counter() - t0:.1f} s)", flush=True)

    wl, cluster, placements, reals, migs = _regime_inputs()
    trace = drift_trace(cluster, horizon_s=REGIME_HORIZON_S, n_segments=6, seed=0)
    if not (trace.slow > 1.0).any():
        raise AssertionError("the drift trace carries no slowdown")
    # deadlines: each gated task's first start in a clean recorded run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean = simulate_batch_torch(wl, cluster, placements, reals, policy="fifo",
                                 record=True, trace=trace, device="cuda")
    clean_wall = time.perf_counter() - t0
    migs = [None if m is None else annotate_deadlines(m, [c])
            for m, c in zip(migs, clean)]
    n_flows = [0 if m is None else len(m) for m in migs]
    print(f"[regimes] papers: J={wl.J} E={wl.E} M={cluster.M} N={reals[0].n_iters}; "
          f"trace of {trace.S} segments over {REGIME_HORIZON_S} s "
          f"({int((trace.slow > 1).sum())} straggler entries); migration flows per "
          f"instance {min(n_flows)}-{max(n_flows)} ({sum(n_flows)} in all, "
          f"{sum(m is None for m in migs)} instances without); the clean recorded "
          f"fifo run for the deadlines took {clean_wall:.2f} s at width {WIDTH} "
          f"({sum(len(c.flow_log) for c in clean)} flow-log entries)", flush=True)
    first = ([p.y for p in placements[:N_CHECK]], [r.volumes for r in reals[:N_CHECK]],
             [r.exec_times for r in reals[:N_CHECK]], migs[:N_CHECK], trace)
    pending = [("regimes papers", policy, pool.submit(_cpu_regime, policy, *first))
               for policy in POLICIES]
    strict = {policy: pool.submit(_cpu_regime, policy, *first, shaping="strict")
              for policy in STRICT_POLICIES}
    gpu = {}
    for policy in POLICIES:
        W = REGIME_WIDTH[policy]
        before = wf.waterfill_fill.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _sync_count() as syncs:
            res = simulate_batch_torch(
                wl, cluster, placements[:W], reals[:W], policy=policy,
                record=True, trace=trace, migrations=migs[:W],
                shaping="deadline", utilization=True, device="cuda",
            )
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = wf.waterfill_fill.launches - before
        iters = max(r.n_events for r in res)
        if policy in ("fifo", "mrtf") and launches == 0:
            raise AssertionError(f"regimes {policy}: waterfill never launched")
        # every delivered GB lands in one class: the remote training
        # instances (edge e sends iterations 1..N - lag[e]) plus the
        # migration flows that ship anything
        N = reals[0].n_iters
        sent = np.arange(N)[None, :] < (N - wl.edge_lag)[:, None]
        worst = 0.0
        for b, rb in enumerate(res):
            y = placements[b].y
            remote = (y[wl.edge_src] != y[wl.edge_dst])[:, None] & sent
            want = float(reals[b].volumes[remote].sum()) + sum(
                f.gb for f in (migs[b] or []) if f.src != f.dst and f.gb > 1e-9
            )
            agg = rb.aggregates
            for got in (sum(agg["class_gb"].values()), agg["nic_in_gb"].sum(),
                        agg["nic_out_gb"].sum()):
                worst = max(worst, abs(got - want) / want)
        if worst > PARITY_RTOL:
            raise AssertionError(f"regimes {policy}: class_gb off the delivered "
                                 f"volume by {worst:.3g} (relative)")
        gpu[("regimes papers", policy)] = (
            [r.makespan for r in res[:N_CHECK]],
            np.stack([r.task_start_matrix(wl.J, N) for r in res[:N_CHECK]]),
        )
        cls = {k: round(v, 3) for k, v in res[3].aggregates["class_gb"].items()}
        print(
            f"[regimes] papers {policy:10s} width {W}: {W / wall:9.1f} evals/s, "
            f"wall {wall:.2f} s, {iters} lock-step iterations, host syncs "
            f"{syncs[0]} ({syncs[0] / iters:.2f} an iteration), waterfill "
            f"launches {launches} ({launches / iters:.2f} an iteration); class_gb "
            f"sums to the delivered GB within {worst:.2g} (instance 3: {cls})",
            flush=True,
        )
    return pending, gpu, strict


def check_escalation(strict, gpu):
    """Deadline shaping against strict on the first instances: at least
    one makespan differs, so that a flow really escalated."""
    from repro_torch.core import PARITY_ATOL, PARITY_RTOL

    escalated = 0
    for policy, fut in strict.items():
        ms_strict, _ = fut.result()
        ms_deadline = gpu[("regimes papers", policy)][0]
        diff = int((~np.isclose(ms_deadline, ms_strict, rtol=PARITY_RTOL,
                                atol=PARITY_ATOL)).sum())
        escalated += diff
        print(f"[regimes] papers {policy:10s} deadline != strict on {diff} of the "
              f"first {N_CHECK} (strict on the cpu engine)", flush=True)
    if escalated == 0:
        raise AssertionError("regimes: no instance escalated (deadline == strict)")


def _check_blames(tag, gpu, cpu):
    """Blame reports of the card's runs against the CPU's: the same
    critical-path chains, the numbers at the engine's parity tolerance."""
    from repro_torch.core import PARITY_ATOL, PARITY_RTOL

    if len(gpu) != len(cpu):
        raise AssertionError(f"{tag}: {len(gpu)} blame reports on the card, {len(cpu)} cpu")
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        (ea, na), (eb, nb) = _blame_numbers(a), _blame_numbers(b)
        if ea != eb:
            raise AssertionError(f"{tag} [{i}]: the card's critical path differs from the "
                                 f"cpu's: {ea} vs {eb}")
        if not np.allclose(na, nb, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            raise AssertionError(f"{tag} [{i}]: blame {na} (cuda) vs {nb} (cpu)")


def phase_replan():
    """``run_scenario(strategy="replan")`` on the example's job and trace,
    and ``Replanner.on_leave(3)`` under deadline shaping, on the card;
    each committed interval and the leave record against the CPU engine."""
    from repro_torch.core import (
        OGBN_PRODUCTS,
        build_workload_from_profile,
        ifs_placement,
        monte_carlo_draws,
        simulate_batch_torch,
        simulate_torch,
        testbed_cluster,
    )
    from repro_torch.dynamics import ReplanConfig, Replanner, drift_trace, run_scenario
    from repro_torch.obs.blame import blame, combine
    from repro_torch.obs.trace import ScheduleTrace

    wl = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=4, samplers_per_worker=2, n_ps=1,
        n_iters=REPLAN_INTERVALS * REPLAN_ITERS,
    )
    cluster = testbed_cluster()
    p0 = ifs_placement(wl, cluster, seed=0)
    full = wl.realize(seed=0, n_iters=REPLAN_INTERVALS * REPLAN_ITERS)
    undisturbed = simulate_torch(wl, cluster, p0, full, device="cuda").makespan
    trace = drift_trace(cluster, horizon_s=undisturbed * 1.2,
                        n_segments=3 * REPLAN_INTERVALS, seed=0,
                        bw_scale_range=(0.25, 1.0))
    cfg = ReplanConfig(budget=REPLAN_BUDGET, sim_iters=REPLAN_ITERS,
                       drift_threshold=0.2, device="cuda")
    t0 = time.perf_counter()
    out = run_scenario(wl, cluster, trace, strategy="replan",
                       n_intervals=REPLAN_INTERVALS, iters_per_interval=REPLAN_ITERS,
                       seed=0, replan_config=cfg, collect_traces=True)
    wall = time.perf_counter() - t0
    cpu_blames = []
    for i, iv in enumerate(out.intervals):
        r_iv = full.window(i * REPLAN_ITERS, (i + 1) * REPLAN_ITERS)
        tw = trace.window(iv.start_s)
        ref = simulate_torch(wl, cluster, out.placements[i], r_iv, trace=tw,
                             migrations=iv.flows or None, record=True, device="cpu")
        _assert_parity(f"replan interval {i}", [iv.makespan_s], np.zeros((1, 1)),
                       [ref.makespan], np.zeros((1, 1)))
        cpu_blames.append(blame(ScheduleTrace.from_result(
            ref, wl, cluster, out.placements[i], r_iv, trace=tw,
            migrations=iv.flows or None)))
    _check_blames("replan run_scenario", [blame(tr) for tr in out.traces], cpu_blames)
    rep = out.blame()
    _check_blames("replan run_scenario, combined", [rep], [combine(cpu_blames)])
    if abs(rep.makespan - out.total_s) > 1e-9 * max(1.0, out.total_s):
        raise AssertionError(f"scenario blame {rep.makespan} != total {out.total_s}")
    print(f"[replan] run_scenario(replan), products job, {REPLAN_INTERVALS} x "
          f"{REPLAN_ITERS} iterations, budget {REPLAN_BUDGET}, traces recorded: total "
          f"{out.total_s:.3f} s (compute {out.compute_s:.3f} + overlap "
          f"{out.overlap_total_s:.3f}), {out.n_replans} re-plans, "
          f"{sum(len(iv.flows) for iv in out.intervals)} committed flows; wall "
          f"{wall:.1f} s; each interval and its blame match the cpu engine", flush=True)
    print("[replan] " + rep.table("run_scenario(replan) blame, combined over the "
                                  "intervals").replace("\n", "\n[replan] "), flush=True)
    t0 = time.perf_counter()
    rp = Replanner(wl, cluster, p0.copy(), config=ReplanConfig(
        budget=REPLAN_BUDGET, sim_iters=REPLAN_ITERS, shaping="deadline",
        device="cuda"))
    rec = rp.on_leave(3)
    wall_leave = time.perf_counter() - t0
    reals = monte_carlo_draws(wl, seed=0, n_iters=REPLAN_ITERS, n_draws=1)
    clean = simulate_batch_torch(wl, rp.cluster, [rp.placement], reals,
                                 device="cpu")[0].makespan
    loaded = simulate_batch_torch(wl, rp.cluster, [rp.placement], reals,
                                  shaping="deadline", migrations=[rec.flows],
                                  device="cpu")[0].makespan
    _assert_parity("replan on_leave(3)", [rec.makespan, rec.makespan + rec.overlap_s],
                   np.zeros((1, 1)), [clean, loaded], np.zeros((1, 1)))
    print(f"[replan] on_leave(3), shaping=deadline: {rp.cluster.M} machines, "
          f"{len(rec.flows)} flows ({rec.forced_gb:.2f} GB forced, "
          f"{rec.moved_tasks} moved), makespan {rec.makespan:.3f} s, overlap "
          f"{rec.overlap_s:.3f} s, {rec.etp.evaluations} evaluations; wall "
          f"{wall_leave:.1f} s; matches the cpu engine", flush=True)


def _sage_x(batch_feats, blocks, hidden, seed):
    """(label, x, idx) of the three aggregations of one forward: layer 0
    gathers the batch's features, layers 1 and 2 the hidden rows (seeded
    ReLU'd normals of the shape the forward gives them)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    x = batch_feats
    L = len(blocks)
    for l in range(L):
        idx = blocks[L - 1 - l]
        out.append((f"layer {l}", x, idx))
        x = torch.relu(torch.randn(idx.shape[0], hidden, device="cuda",
                                   generator=gen))
    return out


def _device_ms(fn, reps, flush=False):
    """Device time per call, without the host's time to issue it: a spin
    kernel holds the card while the host enqueues every call between two
    events, so the calls then run back to back and the events time the
    device alone.  The spin must outlast the enqueueing (checked).  When
    it does not, the spin is lengthened and the calls halved: the card's
    launch queue holds a limited number of entries, and the host blocks
    once it is full (the plain version launches ~110 kernels a call).
    ``flush`` writes 128 MB before each call, outside its events, which
    evicts the 50 MB L2."""
    import torch

    buf = torch.empty(2**25, dtype=torch.float32, device="cuda") if flush else None
    fn()
    torch.cuda.synchronize()
    cycles = 10**7
    for _ in range(6):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(cycles)
        spun = torch.cuda.Event()
        spun.record()
        for t0, t1 in pairs:
            if flush:
                buf.fill_(1.0)
            t0.record()
            fn()
            t1.record()
        host_ahead = not spun.query()
        torch.cuda.synchronize()
        if host_ahead:
            return sum(t0.elapsed_time(t1) for t0, t1 in pairs) / reps
        cycles *= 4
        reps = max(1, reps // 2)
    raise AssertionError("the host could not enqueue the calls ahead of the card")


SAGE_HUBS = 3  # ids each named by a third of layer 1's output rows


def _sage_hubs(sa, batch, hidden, gen):
    """The backward on layer 1's ids with the first id of every row
    replaced by one of SAGE_HUBS hubs (each named ~2239 times, as a
    power-law graph's hubs are): exact against the plain backward on the
    CPU, timed beside ``index_add_`` with the L2 flushed."""
    import torch

    _, x, idx = _sage_x(batch["feats"], batch["blocks"], hidden, 0)[1]
    N, Fdim = x.shape
    M, K = idx.shape
    idx = idx.clone()
    idx[:, 0] = torch.arange(M, device="cuda", dtype=torch.int32) % SAGE_HUBS
    go = torch.randn(M, Fdim, device="cuda", generator=gen)
    backward = lambda: sa.sage_aggregate_backward(go, idx, N)
    if not torch.equal(backward().cpu(),
                       sa.sage_aggregate_backward_plain(go.cpu(), idx.cpu(), N)):
        raise AssertionError("sage backward != plain on the cpu with hubs")
    flat = idx.reshape(-1).long()
    pos = torch.nonzero(flat >= 0).squeeze(1)
    cnt = (idx >= 0).sum(1).clamp(min=1)[:, None].float()
    add_ids, add_rows = flat[pos], (go / cnt)[pos // K]
    add_buf = torch.zeros(N, Fdim, device="cuda")
    ms = _device_ms(backward, 20, flush=True)
    lib_ms = _device_ms(lambda: add_buf.index_add_(0, add_ids, add_rows), 20, flush=True)
    longest = int((idx == 0).sum().item())
    print(f"[sage backward] layer 1 with {SAGE_HUBS} hubs (the longest segment "
          f"{longest} positions): exact match with the plain backward on the cpu; "
          f"device time per call, L2 flushed: kernels {ms:.4f} ms, index_add_ "
          f"{lib_ms:.4f} ms", flush=True)
    return {"bwd_hub_ms": ms, "bwd_hub_library_ms": lib_ms}


def phase_sage_kernel(sa, batch, hidden):
    """The aggregation kernels against their plain versions at the three
    shapes one batch gives them: the forward exact in fp32 and within
    BF16_ATOL in bf16, the backward exact in fp32
    against the plain backward on the CPU, each giving the same bits on
    two runs; all-padding rows and an M that is not a multiple of 128;
    the forward's times beside its bound, the gather probe (its loads
    alone) and ``F.embedding_bag``; the backward's beside its bound and
    ``index_add_``, at each shape and on layer 1's ids with three hubs
    named thousands of times.  Returns the JSON numbers: the forward's summed over
    the three shapes (one forward's aggregations), the backward's over
    layers 1 and 2 (one backward's: layer 0's input needs no gradient)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.launch.mesh import HBM_BW

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, x, idx in _sage_x(batch["feats"], batch["blocks"], hidden, 0):
        N, Fdim = x.shape
        M, K = idx.shape
        got = sa.sage_aggregate(x, idx)
        want = sa.sage_aggregate_plain(x, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"sage kernel != plain at {label} (max {err})")
        _bit_stable(f"sage forward {label}", lambda: sa.sage_aggregate(x, idx))
        xb = x.to(torch.bfloat16)
        err_bf16 = (sa.sage_aggregate(xb, idx).float()
                    - sa.sage_aggregate_plain(xb, idx).float()).abs().max().item()
        if not err_bf16 <= BF16_ATOL:
            raise AssertionError(f"sage kernel bf16 at {label}: max err {err_bf16}")
        bf16_vec = sa.forward_plan(Fdim, 2, xb.data_ptr()).vec_bytes
        # the backward: kernels against the plain backward on the CPU
        go = torch.randn(M, Fdim, device="cuda", generator=gen)
        backward = lambda: sa.sage_aggregate_backward(go, idx, N)
        g_got = backward()
        g_want = sa.sage_aggregate_backward_plain(go.cpu(), idx.cpu(), N)
        if not torch.equal(g_got.cpu(), g_want):
            err = (g_got.cpu() - g_want).abs().max().item()
            raise AssertionError(f"sage backward != plain on the cpu at {label} (max {err})")
        _bit_stable(f"sage backward {label}", backward)
        # the yardsticks: one PyTorch call with the same semantics each
        bag_idx = torch.where(idx < 0, N, idx).long()
        bag_x = torch.cat([x, x.new_zeros(1, Fdim)])
        lib = lambda: F.embedding_bag(bag_idx, bag_x, mode="mean", padding_idx=N)
        err_lib = (lib() - want).abs().max().item()
        flat = idx.reshape(-1).long()
        pos = torch.nonzero(flat >= 0).squeeze(1)
        cnt = (idx >= 0).sum(1).clamp(min=1)[:, None].float()
        add_ids, add_rows = flat[pos], (go / cnt)[pos // K]
        add_buf = torch.zeros(N, Fdim, device="cuda")
        bwd_lib = lambda: add_buf.index_add_(0, add_ids, add_rows)
        kernel = lambda: sa.sage_aggregate(x, idx)
        plain = lambda: sa.sage_aggregate_plain(x, idx)
        # device time per call with the 50 MB L2 flushed before each call
        # (x is 7-37 MB, so back-to-back calls find it in L2 and beat the
        # memory bound); the hot kernel time is printed beside it
        ms = _device_ms(kernel, 20, flush=True)
        hot_ms = _device_ms(kernel, 50)
        probe_ms = _device_ms(lambda: sa.gather_probe(x, idx), 20, flush=True)
        probe_hot_ms = _device_ms(lambda: sa.gather_probe(x, idx), 50)
        plain_ms = _device_ms(plain, 4, flush=True)
        library_ms = _device_ms(lib, 20, flush=True)
        bwd_ms = _device_ms(backward, 20, flush=True)
        bwd_library_ms = _device_ms(bwd_lib, 20, flush=True)
        call_ms = _cuda_ms(kernel, 50)
        lib_call_ms = _cuda_ms(lib, 50)
        # least time: idx read once, each distinct row of x that a valid
        # id names read once, the output written once; one add per
        # gathered value and one divide per output value at the fp32 peak
        valid = idx[idx >= 0]
        n_valid = valid.numel()
        n_rows = int(torch.unique(valid).numel())
        n_bytes = M * K * 4 + n_rows * Fdim * 4 + M * Fdim * 4
        bytes_ms = n_bytes / HBM_BW * 1e3
        ops_ms = (n_valid * Fdim + M * Fdim) / FP32_FLOP_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        # the backward's: grad_out, idx, the CSR (N row ends, a position per
        # valid id) and grad_x once each; a divide per grad_out value and
        # an add per gathered value
        bwd_bytes = M * Fdim * 4 + M * K * 4 + (N + n_valid) * 4 + N * Fdim * 4
        bwd_bound = max(bwd_bytes / HBM_BW,
                        (M * Fdim + n_valid * Fdim) / FP32_FLOP_PER_S) * 1e3
        print(
            f"[sage kernel] {label}: x {tuple(x.shape)} fp32, idx {tuple(idx.shape)} "
            f"({n_valid} valid ids, {n_rows} distinct rows): exact match, bf16 max err "
            f"{err_bf16:.3g} ({bf16_vec}-byte accesses); device time per call, "
            f"L2 flushed: kernel {ms:.4f} ms (hot {hot_ms:.4f} ms), gather probe "
            f"{probe_ms:.4f} ms (hot {probe_hot_ms:.4f} ms), plain {plain_ms:.4f} ms, embedding_bag "
            f"{library_ms:.4f} ms (max diff {err_lib:.3g}); bound {bound:.6f} ms "
            f"({n_bytes} bytes, {100 * bound / ms:.1f}% of the kernel's time); "
            f"back-to-back calls, host included: kernel {call_ms:.4f} ms, "
            f"embedding_bag {lib_call_ms:.4f} ms",
            flush=True,
        )
        print(
            f"[sage backward] {label}: grad_out {tuple(go.shape)} fp32 -> grad_x "
            f"{tuple(g_got.shape)}: exact match with the plain backward on the cpu; "
            f"device time per call, L2 flushed: kernels {bwd_ms:.4f} ms, index_add_ "
            f"{bwd_library_ms:.4f} ms; bound {bwd_bound:.6f} ms ({bwd_bytes} bytes, "
            f"{100 * bwd_bound / bwd_ms:.1f}% of the kernels' time)",
            flush=True,
        )
        rows.append(dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         probe_ms=probe_ms,
                         bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound,
                         bwd_library_ms=bwd_library_ms,
                         max_abs_err=(got - want).abs().max().item()))
    # all-padding rows and an M that is not a multiple of 128
    x, idx = batch["feats"], batch["blocks"][-1][:1037].clone()
    idx[:64] = -1
    got = sa.sage_aggregate(x, idx)
    if not (torch.equal(got, sa.sage_aggregate_plain(x, idx))
            and (got[:64] == 0).all()):
        raise AssertionError("sage kernel: all-padding rows or odd M differ")
    print("[sage kernel] M=1037 with 64 all-padding rows: exact match, "
          "padding rows 0", flush=True)
    out = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bytes_ms", "ops_ms",
                                                  "probe_ms")}
    out.update({k: sum(r[k] for r in rows[1:])
                for k in ("bwd_ms", "bwd_bound_ms", "bwd_library_ms")})
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["ops_ms"] else "operations"
    out.update(_sage_hubs(sa, batch, hidden, gen))
    print(f"[sage kernel] one forward (three calls), L2 flushed: kernel {out['ms']:.4f} "
          f"ms against a bound of {out['bound_ms']:.6f} ms and a gather probe of "
          f"{out['probe_ms']:.4f} ms (embedding_bag {out['library_ms']:.4f} ms); one "
          f"backward (layers 1 and 2): kernels {out['bwd_ms']:.4f} ms against a bound of "
          f"{out['bwd_bound_ms']:.6f} ms, index_add_ {out['bwd_library_ms']:.4f} ms",
          flush=True)
    return out


def phase_sage(sa, wf):
    """GraphSAGE on the card: the kernel checks, card-vs-CPU parity, then
    the main path (training steps, calibration, DistDGL baseline plan)
    with the launch counts set to 0 just before and read just after, then
    one profiled step.  Returns the kernel numbers and the path's
    launches per kernel."""
    import torch

    from repro_torch.core import plan_baseline, testbed_cluster
    from repro_torch.core.units import BYTES_PER_GB, BYTES_PER_MIB
    from repro_torch.core.workload import build_gnn_workload
    from repro_torch.data.graph import sample_blocks, synthetic_graph
    from repro_torch.models import GraphSAGE, SageConfig, batch_to, sage_loss, sgd_step

    # full fp32 products on both sides of the card-vs-CPU comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = SageConfig(in_dim=100, hidden=256, n_classes=47, n_layers=3)
    t0 = time.perf_counter()
    g = synthetic_graph(n_nodes=SAGE_NODES, n_feats=cfg.in_dim,
                        n_classes=cfg.n_classes, n_parts=4, seed=0)
    print(f"[sage] graph: {g.n_nodes} nodes, {len(g.indices)} edges, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)

    def sample():
        seeds = rng.choice(g.train_nodes, SAGE_BATCH, replace=False)
        return sample_blocks(g, seeds, SAGE_FANOUTS, rng)

    feats, blocks, labels, _ = sample()
    print(f"[sage] batch: feats {feats.shape}, blocks "
          f"{[b.shape for b in blocks]}", flush=True)
    batch = batch_to(feats, blocks, labels, device="cuda")
    with torch.no_grad():
        kern = phase_sage_kernel(sa, batch, cfg.hidden)

    # one forward and backward on the card against the same on the CPU
    model = GraphSAGE(cfg, device="cuda", seed=0)
    ref = GraphSAGE(cfg, device="cpu", seed=0)
    cpu_batch = batch_to(feats, blocks, labels, device="cpu")
    with torch.no_grad():
        d_logits = (model(batch["feats"], batch["blocks"]).cpu()
                    - ref(cpu_batch["feats"], cpu_batch["blocks"])).abs().max().item()
    loss_g, _ = sage_loss(model, batch)
    loss_g.backward()
    loss_c, _ = sage_loss(ref, cpu_batch)
    loss_c.backward()
    d_loss = abs(loss_g.item() - loss_c.item())
    d_grad = max((pg.grad.cpu() - pc.grad).abs().max().item()
                 for pg, pc in zip(model.parameters(), ref.parameters()))
    print(f"[sage] card vs cpu, batch 1: logits max diff {d_logits:.3g}, loss "
          f"{loss_g.item():.6f} vs {loss_c.item():.6f} (diff {d_loss:.3g}), "
          f"gradients max diff {d_grad:.3g} (atol {SAGE_ATOL})", flush=True)
    if not max(d_logits, d_loss, d_grad) <= SAGE_ATOL:
        raise AssertionError("GraphSAGE on the card disagrees with the CPU")
    model.zero_grad(set_to_none=True)

    # the main path: SGD steps, calibration, the DistDGL baseline plan
    sa.sage_aggregate.launches = 0
    sa.sage_aggregate.backward_launches = 0
    wf.waterfill_fill.launches = 0
    losses, store_bytes, split = [], [], []
    for _ in range(SAGE_STEPS):
        t0 = time.perf_counter()
        feats, blocks, labels, per_store = sample()
        t1 = time.perf_counter()
        batch = batch_to(feats, blocks, labels, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss, m = sage_loss(model, batch)
        loss.backward()
        sgd_step(model, lr=0.1)
        losses.append(loss.item())  # a sync
        t3 = time.perf_counter()
        store_bytes.append(sum(per_store.values()))
        split.append((t1 - t0, t2 - t1, t3 - t2))
    vol_gb = float(np.mean(store_bytes)) / BYTES_PER_GB
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    wl = build_gnn_workload(
        n_stores=4, n_workers=6, samplers_per_worker=2, n_ps=1, n_iters=40,
        store_to_sampler_gb=vol_gb, sampler_to_worker_gb=vol_gb,
        grad_gb=param_bytes / BYTES_PER_GB,
        store_exec_s=0.04, sampler_exec_s=0.08, worker_exec_s=0.15,
        ps_exec_s=0.015, pmr=float(np.max(store_bytes) / np.mean(store_bytes)),
    )
    dd = plan_baseline(wl, testbed_cluster(), baseline="distdgl",
                       realization=wl.realize(seed=0), device="cuda")
    torch.cuda.synchronize()
    launches = {"sage_aggregate": sa.sage_aggregate.launches,
                "sage_aggregate_backward": sa.sage_aggregate.backward_launches,
                "waterfill_fill": wf.waterfill_fill.launches}
    print(f"[sage] losses over {SAGE_STEPS} SGD steps: "
          f"{' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"GraphSAGE training did not learn: {losses}")
    sp = np.array(split)
    print(f"[sage] step split (mean of {SAGE_STEPS}): sampling on the host "
          f"{sp[:, 0].mean():.4f} s, H2D copy {sp[:, 1].mean():.4f} s, forward "
          f"+ backward + SGD {sp[:, 2].mean():.4f} s; per step "
          f"{' / '.join(f'{a:.3f}+{b:.4f}+{c:.4f}' for a, b, c in sp)}",
          flush=True)
    print(f"[sage] calibrated: {vol_gb * BYTES_PER_GB / BYTES_PER_MIB:.1f} MiB per "
          f"batch, PMR {np.max(store_bytes) / np.mean(store_bytes):.3f}; DistDGL "
          f"baseline makespan {dd.schedule.makespan:.3f} s; launches on the path: "
          f"{launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the GraphSAGE path never launched {name}")

    # one profiled step: the device's busy share of a whole step
    def step():
        t0 = time.perf_counter()
        feats, blocks, labels, _ = sample()
        loss, _ = sage_loss(model, batch_to(feats, blocks, labels, device="cuda"))
        loss.backward()
        sgd_step(model, lr=0.1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the traced step must hold every launch of the aggregation and the
    # batch's copies to the card
    expect = {"sage_fwd": 3, "sage_bwd_prep": 2, "sage_bwd_fill": 2, "sage_bwd_long": 2,
              "sage_bwd_sum": 2}
    wall, rows = _traced(step)
    seen = {k: sum(a.count for a in rows if re.search(rf"::{k}[<(]", a.key))
            for k in expect}
    copies = sum(a.count for a in rows if a.key.startswith("Memcpy HtoD"))
    if seen != expect or copies == 0:
        raise AssertionError(f"the profiled GraphSAGE step lost device events: aggregation "
                             f"launches {seen} of {expect}, {copies} host-to-device copies")
    dev_ms = sum(_device_us(a) for a in rows) / 1e3
    kernel_ms = sum(_device_us(a) for a in rows if not a.key.startswith("Memcpy")) / 1e3
    print(f"[sage profile] one step: wall {wall:.3f} s profiled, device busy "
          f"{dev_ms:.3f} ms ({100 * dev_ms / 1e3 / wall:.2f}% of the wall), of which "
          f"kernels (no host-to-device copies) {kernel_ms:.3f} ms; every aggregation "
          f"launch traced {seen}, {copies} host-to-device copies", flush=True)
    for a in rows[:8]:
        print(f"[sage profile]   {_device_us(a) / 1e3:9.3f} ms {a.count:5d}x "
              f"{a.key[:70]}", flush=True)
    ours = [a for a in rows if "sage_" in a.key]
    print(f"[sage profile] the aggregation's kernels: "
          f"{sum(_device_us(a) for a in ours) / 1e3:.3f} ms ("
          + ", ".join(f"{re.search(r'sage_\w+(<[^>]*>)?', a.key).group(0)} "
                      f"{_device_us(a) / 1e3:.3f} ms {a.count}x" for a in ours) + ")",
          flush=True)
    scatter = [a.key for a in rows if "indexFunc" in a.key]
    if scatter:
        raise AssertionError(f"the GraphSAGE step still runs index_add_: {scatter}")
    return kern, launches


@contextlib.contextmanager
def _plain(*names):
    """The model's calls of the named kernels ("flash", "ssd", "moe")
    through their plain versions, on the card (a check only: the port
    always calls the kernels)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import layers as ly
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod

    sites = {
        "flash": (ly, "flash_attention", fa.flash_attention_plain),
        "ssd": (ssm_mod, "ssd_scan",
                lambda *a, chunk: ss.ssd_scan_plain(*a, chunk=chunk)[0]),
        "moe": (moe_mod, "moe_grouped_gemm", mg.moe_grouped_gemm_plain),
    }
    saved = [(sites[n][0], sites[n][1], getattr(sites[n][0], sites[n][1])) for n in names]
    try:
        for n in names:
            mod, attr, plain = sites[n]
            setattr(mod, attr, plain)
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _flash_qkv(seed, B, H, KV, Sq, Sk, D, dtype):
    """Seeded q [B, H, Sq, D] and k, v [B, KV, Sk, D] on the card, as views
    of [B, S, N, D] tensors (the layout the model hands the kernel)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(S, N):
        return torch.randn(B, S, N, D, generator=gen, device="cuda").to(dtype).transpose(1, 2)

    return draw(Sq, H), draw(Sk, KV), draw(Sk, KV)


def _bound(flops, n_bytes, elt):
    """Least time on the card of a kernel that does ``flops`` operations and
    moves ``n_bytes`` (its wrapper's ``cost`` or ``backward_cost``, which the
    op counter counts too): the larger of the two times, at the bf16
    tensor-core peak (fp32 peak for fp32 data, ``elt`` 4) and the HBM rate.
    Returns (ms, "operations" or "bytes")."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

    ops_ms = flops / (PEAK_FLOPS_BF16 if elt == 2 else FP32_FLOP_PER_S) * 1e3
    bytes_ms = n_bytes / HBM_BW * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _flash_checks(fa, checks, tag):
    """Each (label, (B, H, KV, Sq, Sk, D), kwargs) of ``checks`` through
    the attention kernel against its plain version, fp32 and bf16, within
    FLASH_TOL.  Returns the largest fp32 error."""
    import torch

    worst = 0.0
    for seed, (label, shape, kw) in enumerate(checks):
        errs = {}
        for dtype in ("float32", "bfloat16"):
            q, k, v = _flash_qkv(seed, *shape, getattr(torch, dtype))
            got = fa.flash_attention(q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not err <= FLASH_TOL[dtype]:
                raise AssertionError(f"flash kernel != plain at {label} {dtype}: "
                                     f"max err {err} (tol {FLASH_TOL[dtype]})")
            errs[dtype] = err
            worst = max(worst, err) if dtype == "float32" else worst
            del q, k, v, got, want
        print(f"[{tag}] {label}: q {shape[:2] + shape[3:4] + shape[5:]} "
              f"over {shape[2]} KV heads x {shape[4]} keys, {kw}: max err fp32 "
              f"{errs['float32']:.3g}, bf16 {errs['bfloat16']:.3g}", flush=True)
    return worst


def _path_flash_checks(H, KV, D):
    """The serving paths' attention shapes for H query heads over KV heads
    of D: the prefill of LM_PREFILL and the decode of LM_SLOTS sequences
    over an LM_SMAX cache at DECODE_POSITIONS."""
    B, S = LM_PREFILL
    checks = [("prefill", (B, H, KV, S, S, D), dict(causal=True))]
    for pos in DECODE_POSITIONS:
        checks.append((f"decode pos {pos}", (LM_SLOTS, H, KV, 1, LM_SMAX, D),
                       dict(causal=True, q_offset=pos)))
    return checks


def phase_flash_kernel(fa):
    """The attention kernel against its plain version at the sweep, prefill
    and decode shapes (fp32 and bf16), and its times at the prefill and
    decode shapes in bf16.  Returns the JSON numbers: the decode at the
    full cache (position 2047), the serving path's launch."""
    checks = []
    for i, (b, h, sq, sk, d, causal, window, softcap) in enumerate(FLASH_SWEEP):
        checks.append((f"sweep {i}", (b, h, h, sq, sk, d), dict(
            causal=causal, window=window, softcap=softcap)))
    worst = _flash_checks(fa, checks + FLASH_HEAD_DIM_CHECKS + _path_flash_checks(16, 8, 128),
                          "flash kernel")

    # times in bf16 (the model's dtype), L2 flushed before each call: the
    # internlm2 prefill and decode, and kimi-k2's decode (64 heads over 8
    # KV heads of 112)
    B, S = LM_PREFILL
    timed = [("prefill", (B, 16, 8, S, S, 128), dict(causal=True))]
    timed += [(f"decode pos {pos}", (LM_SLOTS, 16, 8, 1, LM_SMAX, 128),
               dict(causal=True, q_offset=pos)) for pos in DECODE_POSITIONS]
    timed += [(f"kimi decode pos {pos}", (LM_SLOTS, 64, 8, 1, LM_SMAX, 112),
               dict(causal=True, q_offset=pos)) for pos in DECODE_POSITIONS]
    rows = {label: _flash_time(fa, "flash kernel", label, shape, kw)
            for label, shape, kw in timed}
    out = dict(rows[f"decode pos {DECODE_POSITIONS[-1]}"])
    out["max_abs_err"] = worst
    out.update(_prefill_nums(rows["prefill"]))
    out.update(_shape_nums("kimi_decode", rows[f"kimi decode pos {DECODE_POSITIONS[-1]}"]))
    return out


def _sdpa(q, k, v, kw):
    """``F.scaled_dot_product_attention`` computing the attention of ``kw``
    on q, k and v, the yardstick (the port never calls it), or None where
    it computes another function (a tanh softcap).  A causal prefill from
    position 0 takes ``is_causal``; a causal decode without a window reads
    keys 0..pos; any other mask is passed as a boolean ``attn_mask``."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    if kw.get("softcap"):
        return None
    sq, sk = q.shape[2], k.shape[2]
    causal, window, off = kw.get("causal", True), kw.get("window"), kw.get("q_offset", 0)
    extra = dict(scale=kw["scale"]) if kw.get("scale") is not None else {}
    if window is None and causal and sq == 1:  # the one query row sees keys 0..pos
        kk, vv = k[:, :, : off + 1], v[:, :, : off + 1]
        return lambda: F.scaled_dot_product_attention(q, kk, vv, enable_gqa=True, **extra)
    if window is None and (not causal or (off == 0 and sq == sk)):
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      enable_gqa=True, **extra)
    mask = fa.causal_mask(sq, sk, window, off, causal, device=q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True, **extra)


def _flash_time(fa, tag, label, shape, kw):
    """One bf16 attention shape (B, H, KV, Sq, Sk, D) with ``kw``, L2
    flushed before each call: the kernel (two runs giving the same bits),
    its plain version and ``_sdpa``'s call timed, beside the bound.
    Returns the row (``library_ms`` None where no PyTorch call computes
    the function)."""
    import torch

    b, h, kv, sq, sk, d = shape
    q, k, v = _flash_qkv(7, b, h, kv, sq, sk, d, torch.bfloat16)
    kernel = lambda: fa.flash_attention(q, k, v, **kw)
    _bit_stable(f"flash {label}", kernel)
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
    lib = _sdpa(q, k, v, kw)
    reps = 10 if sq > 1 else 50
    ms = _device_ms(kernel, reps, flush=True)
    plain_ms = _device_ms(plain, 2 if sq > 1 else 10, flush=True)
    if lib is None:
        library_ms, lib_note = None, "no PyTorch call computes a tanh softcap"
    else:
        err_lib = (lib().float() - plain().float()).abs().max().item()
        library_ms = _device_ms(lib, reps, flush=True)
        lib_note = (f"scaled_dot_product_attention {library_ms:.4f} ms (max diff to "
                    f"plain {err_lib:.3g})")
    flops, n_bytes = fa.cost(q, k, kw.get("causal", True), kw.get("window"),
                             kw.get("q_offset", 0))
    bound, by = _bound(flops, n_bytes, 2)
    print(
        f"[{tag}] {label} bf16: device time per call, L2 flushed: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, {lib_note}; bound "
        f"{bound:.6f} ms by {by} ({flops} flops, {n_bytes} bytes; "
        f"{100 * bound / ms:.1f}% of the kernel's time)", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by=by)


def _bit_stable(tag, fn):
    """Fail unless two calls of ``fn`` give the same bits (the kernels sum
    in a fixed order: no atomics)."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{tag}: two runs differ (max "
                             f"{(a.float() - b.float()).abs().max().item()})")
    print(f"[bits] {tag}: two runs give the same bits", flush=True)


def phase_lm(fa):
    """internlm2-1.8b on the card: prefill through the kernel against the
    plain attention, fp32 card against CPU at 2 layers, decode against
    forward, then the main path (ServeEngine, counts set to 0 just before
    and read just after) and one profiled tick.  Returns the path's
    flash launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to {model.vp}; "
          f"{n_params} parameters in {cfg.dtype} (param_count {cfg.param_count()}), "
          f"initialised on the card in {time.perf_counter() - t0:.1f} s", flush=True)

    # prefill of 4 x 2048 tokens: the kernel against the plain attention
    B, S = LM_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    before = fa.flash_attention.launches
    routes = _routes(fa.flash_attention)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = fa.flash_attention.launches - before
    _check_wgmma("lm prefill", routes, _routes(fa.flash_attention), [cfg.n_layers])
    warm = _warm_prefill(model, toks)
    with _plain("flash"):
        want = model.prefill(toks)
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("prefill logits not finite or of the wrong shape")
    if n_launch != cfg.n_layers:
        raise AssertionError(f"prefill launched the kernel {n_launch} times")
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[lm] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {n_launch} kernel launches, all on the "
          f"wgmma route; against the plain attention: max abs "
          f"logit diff {d_pre:.4g} (logits in [{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} of "
          f"{B}", flush=True)
    _gate_prefill("lm", d_pre, want[:, : cfg.vocab])

    # 2 layers at full width in fp32: the card's kernel path against the
    # CPU's plain path, and decode against forward on the card
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_m = TransformerLM(cfg2, device="cpu").init(torch.Generator().manual_seed(2))
    card_m = TransformerLM(cfg2, device="cuda")
    card_m.load_state_dict(cpu_m.state_dict())
    toks2 = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator().manual_seed(3))
    h_card = card_m.forward(toks2.cuda()).cpu()
    h_cpu = cpu_m.forward(toks2)
    l_card, l_cpu = card_m.prefill(toks2.cuda()).cpu(), cpu_m.prefill(toks2)
    d_h = (h_card - h_cpu).abs().max().item()
    d_l = (l_card - l_cpu)[:, : cfg.vocab].abs().max().item()
    print(f"[lm] 2 layers, full width, fp32, 2 x 256 tokens: card (kernel) vs "
          f"cpu (plain): hidden max diff {d_h:.3g}, last logits max diff "
          f"{d_l:.3g} (atol {LM_FP32_ATOL})", flush=True)
    if not max(d_h, d_l) <= LM_FP32_ATOL:
        raise AssertionError("the card's fp32 LM disagrees with the CPU's")
    del cpu_m

    errs, agree = _decode_vs_forward(card_m, 16, 2)
    print(f"[lm] decode vs forward, 2 layers fp32 on the card, 16 positions: "
          f"max err per position {' '.join(f'{e:.2g}' for e in errs)}; argmax "
          f"agrees at {agree} of 16", flush=True)
    if not (errs[0] < 1e-3 and max(errs) < 1e-2 and agree == 16):
        raise AssertionError("fp32 decode disagrees with the forward")
    del card_m
    errs, agree = _decode_vs_forward(model, 16, LM_SLOTS)
    print(f"[lm] decode vs forward, {cfg.n_layers} layers bf16, {LM_SLOTS} "
          f"sequences, 16 positions: max err per position "
          f"{' '.join(f'{e:.2g}' for e in errs)}; argmax agrees on all "
          f"sequences at {agree} of 16 positions", flush=True)
    if not all(np.isfinite(errs)):
        raise AssertionError("bf16 decode or forward not finite")

    # the main path: ServeEngine at launch/serve.py's defaults, smax 2048
    # and 128 new tokens each
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    stats = engine.run()
    launches = fa.flash_attention.launches
    ms_tick = _serve_checks("lm serve", model, stats, reqs,
                            {"flash": (launches, cfg.n_layers)})
    _teacher_forced("lm serve", model, reqs)
    _profile_tick("lm profile", model, ms_tick,
                  {"flash_attention": ("flash_decode", "flash_tiled", "flash_wgmma")})
    return launches


def _warm_prefill(model, toks):
    """Seconds of a second, warm call of ``model.prefill``."""
    return _warm(lambda: model.prefill(toks))


def _routes(*counted):
    """The launches per route of each kernel wrapper in ``counted``."""
    return [dict(c.launches_by_route) for c in counted]


def _check_wgmma(tag, before, after, want):
    """Fail unless every launch between the two ``_routes`` readings went
    through the wgmma route: ``want`` launches per wrapper."""
    for b, a, n in zip(before, after, want):
        moved = {r: a[r] - b[r] for r in a}
        if moved["wgmma"] != n or sum(moved.values()) != n:
            raise AssertionError(f"{tag}: the bf16 prefill's launches by route were "
                                 f"{moved}, expected {n} on the wgmma route")


def _gate_prefill(tag, d_pre, want, what="prefill"):
    """Fail unless the kernel path's logits (a prefill's, or ``what``'s)
    are within PREFILL_RTOL of the largest plain logit (``want``, the
    vocab's columns)."""
    lim = PREFILL_RTOL * want.abs().max().item()
    print(f"[{tag}] {what} against the plain path: max abs logit diff "
          f"{d_pre:.4g}, limit {lim:.4g} ({PREFILL_RTOL} of the largest plain "
          f"logit)", flush=True)
    if not d_pre <= lim:
        raise AssertionError(f"{tag}: bf16 {what} through the kernels disagrees "
                             f"with the plain path ({d_pre} > {lim})")


def _decode_run(m, n_pos, batch):
    """Logits of ``n_pos`` decode steps against the forward's at the same
    positions (seeded tokens): the max error per position, the number of
    positions where the argmax agrees on every sequence, the largest
    forward logit's magnitude, and the decode's cache."""
    import torch

    vocab = m.cfg.vocab
    tk = torch.randint(0, vocab, (batch, n_pos),
                       generator=torch.Generator().manual_seed(4)).cuda()
    full = m._logits(_text_forward(m, tk))[..., :vocab]
    cache = m.cache_struct(batch, n_pos)
    errs, agree = [], 0
    for t in range(n_pos):
        cache, lg = m.decode_step(cache, tk[:, t], t)
        lg = lg[:, :vocab]
        errs.append((lg - full[:, t]).abs().max().item())
        agree += int((lg.argmax(-1) == full[:, t].argmax(-1)).all().item())
    return errs, agree, full.abs().max().item(), cache


def _decode_vs_forward(m, n_pos, batch):
    """``_decode_run``'s errors per position and argmax agreements."""
    return _decode_run(m, n_pos, batch)[:2]


def _text_forward(model, toks):
    """``model.forward`` of token ids alone (a patches model with an empty
    patch prefix: its decode reads tokens only)."""
    import torch

    if model.cfg.frontend != "patches":
        return model.forward(toks)
    empty = torch.zeros(toks.shape[0], 0, model.cfg.d_model, device=toks.device)
    return model.forward(toks, patches=empty)


def _requests(n, max_tokens):
    from repro_torch.serve import Request

    return [Request(rid=i, prompt=[1 + i % 13, 2, 3], max_tokens=max_tokens)
            for i in range(n)]


def _engine(model, n_requests=LM_REQUESTS, max_tokens=LM_MAX_TOKENS):
    """A ServeEngine at launch/serve.py's defaults (16 requests of
    ``[1 + i % 13, 2, 3]``, 8 slots) with smax LM_SMAX and LM_MAX_TOKENS
    new tokens each (or ``n_requests`` of ``max_tokens``), the requests
    submitted."""
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, n_slots=LM_SLOTS, smax=LM_SMAX)
    reqs = _requests(n_requests, max_tokens)
    for r in reqs:
        engine.submit(r)
    return engine, reqs


def _serve_checks(tag, model, stats, reqs, launches):
    """Prints the engine run's numbers and checks it: every request done
    with its tokens in the vocabulary, and each kernel of ``launches``
    (name -> (count, per tick)) launched its count per tick.  Returns the
    mean ms per tick."""
    vocab = model.cfg.vocab
    n_req, max_tokens = len(reqs), reqs[0].max_tokens
    ms_tick = 1e3 * stats["wall_s"] / stats["ticks"]
    counts = ", ".join(f"{k} launches {n} ({n / stats['ticks']:.1f} per tick)"
                       for k, (n, _) in launches.items())
    print(f"[{tag}] {n_req} requests, {LM_SLOTS} slots, smax {LM_SMAX}, "
          f"{max_tokens} new tokens each: {stats['tokens']} tokens over "
          f"{stats['ticks']} ticks in {stats['wall_s']:.3f} s: "
          f"{stats['tok_per_s']:.1f} tokens/s, {ms_tick:.3f} ms per tick; "
          f"{counts}", flush=True)
    for name, (n, per_tick) in launches.items():
        if n != per_tick * stats["ticks"]:
            raise AssertionError(f"{tag}: {name} launched {n} times, expected "
                                 f"{per_tick} per tick")
    if not all(r.done for r in reqs) or stats["tokens"] != n_req * (max_tokens + 1):
        raise AssertionError(f"{tag}: the engine did not finish every request")
    if not all(0 <= t < vocab for r in reqs for t in r.out):
        raise AssertionError(f"{tag}: the engine emitted a token outside the vocabulary")
    return ms_tick


def _teacher_forced(tag, model, reqs):
    """The first wave (admitted at position 0, on a clean cache) against a
    teacher-forced forward of the same sequences."""
    import torch

    vocab = model.cfg.vocab
    first = reqs[:LM_SLOTS]
    seqs = torch.tensor([r.prompt[:1] + r.out for r in first], device="cuda")
    with torch.no_grad():
        pred = model._logits(_text_forward(model, seqs[:, :-1]))[..., :vocab].argmax(-1)
    gen_from = len(first[0].prompt) - 1  # positions whose next token was generated
    tf_agree = (pred[:, gen_from:] == seqs[:, gen_from + 1:]).float().mean().item()
    print(f"[{tag}] first wave's {seqs.shape[1] - 1 - gen_from} generated "
          f"tokens per request against a teacher-forced {model.cfg.dtype} forward: "
          f"{100 * tf_agree:.1f}% agree", flush=True)


def _profile_tick(tag, model, ms_tick, kernels):
    """One profiled tick (8 busy slots, past the prompt feed): the
    device's busy share and operation count, and the tick's device time
    split into the kernels named in ``kernels`` (name -> key substrings),
    the matrix products (cuBLAS) and the rest (copies, casts, norms, ...)."""
    import torch

    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model, n_slots=LM_SLOTS, smax=LM_SMAX)
    for r in _requests(LM_SLOTS, 16):
        engine.submit(r)
    for _ in range(4):
        engine.tick()
    def tick():
        t0 = time.perf_counter()
        engine.tick()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, rows = _traced(tick)
    dev_ms = sum(_device_us(a) for a in rows) / 1e3
    n_kernels = sum(a.count for a in rows)
    print(f"[{tag}] one tick at position {engine.pos - 1}: wall {1e3 * wall:.3f} "
          f"ms profiled, device busy {dev_ms:.3f} ms ({100 * dev_ms / 1e3 / wall:.1f}% "
          f"of the profiled wall, {100 * dev_ms / ms_tick:.1f}% of the engine run's "
          f"mean tick), {n_kernels} device operations", flush=True)
    split = {name: 0.0 for name in kernels}
    split.update(matmul=0.0, other=0.0)
    for a in rows:
        key = a.key.lower()
        part = next((name for name, subs in kernels.items()
                     if any(sub in key for sub in subs)), None)
        if part is None:
            part = ("matmul" if any(w in key for w in ("gemm", "nvjet", "gemv"))
                    else "other")
        split[part] += _device_us(a) / 1e3
    print(f"[{tag}] device time split: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items()), flush=True)
    for a in rows[:10]:
        print(f"[{tag}]   {_device_us(a) / 1e3:9.3f} ms {a.count:5d}x "
              f"{a.key[:70]}", flush=True)


# ----------------------------------------------------------- mamba2, MoE
def _free():
    """Returns the memory of the models freed so far to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _rel_err(got, want):
    """Largest difference relative to the largest magnitude of ``want``."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _ssd_inputs(seed, b, s, h, hd, ds, dtype, wide=False):
    """Seeded scan inputs on the card: x, dt = softplus(normal), mamba2's
    A = -linspace(1, 16, h), B and C.  With ``wide``, x, B and C are
    views of one [b, s, h hd + 2 ds] projection (strided rows)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if wide:
        proj = draw(b, s, h * hd + 2 * ds).to(dtype)
        x = proj[..., : h * hd].view(b, s, h, hd)
        Bm = proj[..., h * hd: h * hd + ds].view(b, s, 1, ds)
        Cm = proj[..., h * hd + ds:].view(b, s, 1, ds)
    else:
        x, Bm, Cm = draw(b, s, h, hd).to(dtype), draw(b, s, ds).to(dtype), draw(b, s, ds).to(dtype)
    dt = F.softplus(draw(b, s, h))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x, dt, A, Bm, Cm


def _ssd_checks(ss, tag, checks):
    """Each (label, (b, s, h, hd, ds, chunk), wide) of ``checks`` through
    the SSD kernel against its plain version, fp32 on the FMA route and
    bf16 on the mma route, within KERNEL_RTOL of the largest output.
    Returns the largest fp32 error."""
    import torch

    worst = 0.0
    for seed, (label, (b, s, h, hd, ds, q), wide) in enumerate(checks):
        errs = {}
        for dtype in ("float32", "bfloat16"):
            args = _ssd_inputs(seed, b, s, h, hd, ds, getattr(torch, dtype), wide)
            before = _routes(ss.ssd_scan)
            got = ss.ssd_scan(*args, chunk=q)
            _check_route(f"ssd {label} {dtype}", before, _routes(ss.ssd_scan),
                         ["mma" if dtype == "bfloat16" else "fma"])
            want = ss.ssd_scan_plain(*args, chunk=q)[0]
            torch.cuda.synchronize()
            errs[dtype] = _rel_err(got, want)
            if not errs[dtype] <= KERNEL_RTOL[dtype]:
                raise AssertionError(f"ssd kernel != plain at {label} {dtype}: "
                                     f"relative err {errs[dtype]} (tol {KERNEL_RTOL[dtype]})")
            if dtype == "float32":
                worst = max(worst, (got - want).abs().max().item())
            del args, got, want
        print(f"[{tag}] {label}: x [{b}, {s}, {h}, {hd}], d_state {ds}, chunk "
              f"{q}: max err relative to the largest output, fp32 (fma route) "
              f"{errs['float32']:.3g}, bf16 (mma route) {errs['bfloat16']:.3g}", flush=True)
    return worst


def _ssd_time(ss, tag, full):
    """The mma route at ``full`` (b, s, h, hd, ds, chunk) in bf16, L2
    flushed before each call: the same bits on two runs, the kernel's and
    the plain version's times beside the bound.  Returns the row."""
    import torch

    args = _ssd_inputs(99, *full[:5], torch.bfloat16)
    kernel = lambda: ss.ssd_scan(*args, chunk=full[5])
    plain = lambda: ss.ssd_scan_plain(*args, chunk=full[5])
    _bit_stable(f"ssd_scan mma route, {tag} bf16", kernel)
    ms = _device_ms(kernel, 10, flush=True)
    plain_ms = _device_ms(plain, 2, flush=True)
    flops, n_bytes = ss.cost(args[0], args[3], ss.chunk_len(full[1], full[5]))
    bound, by = _bound(flops, n_bytes, 2)
    print(f"[{tag}] x {list(full[:4])}, d_state {full[4]}, chunk {full[5]}, bf16: "
          f"device time per call, L2 flushed: kernel (mma route) {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no library call computes it; bound {bound:.6f} ms by "
          f"{by} ({flops} flops, {n_bytes} bytes): the mma route at "
          f"{100 * bound / ms:.1f}% of its bound", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound, bound_by=by)


def phase_ssd_kernel(ss):
    """The SSD kernel against its plain version at the sweep shapes of
    ``tests/test_kernels.py``, the smoke config's chunk of 32, and
    mamba2-1.3b's prefill shape (plain and as views of one projection),
    bf16 on the mma route and fp32 on the FMA route; at the prefill shape
    in bf16, the same bits on two runs and its times (the FMA route's in
    fp32 beside them).  Returns the JSON numbers (the prefill shape: the
    path's launches)."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(MAMBA_ARCH)
    B, S = LM_PREFILL
    full = (B, S, cfg.ssm.n_heads(cfg.d_model), cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.chunk)
    checks = [(f"sweep {i}", shape, False) for i, shape in enumerate(SSD_SWEEP)]
    checks += [("smoke chunk 32", (2, 96, 4, 16, 16, 32), False),
               ("prefill", full, False),
               ("prefill, x, B and C views of one projection", full, True)]
    worst = _ssd_checks(ss, "ssd kernel", checks)
    row = _ssd_time(ss, "ssd kernel", full)
    # the FMA route's time at the same shape (fp32), in the same run
    args32 = _ssd_inputs(99, *full[:5], torch.float32)
    fma_ms = _device_ms(lambda: ss.ssd_scan(*args32, chunk=full[5]), 3, flush=True)
    del args32
    print(f"[ssd kernel] prefill fp32 on the FMA route: {fma_ms:.4f} ms", flush=True)
    return dict(row, max_abs_err=worst, fma_ms=fma_ms)


def phase_mamba(ss, fa, mg):
    """mamba2-1.3b on the card: fp32 card (kernel) against CPU (plain) at 2
    layers and decode against forward; then the main path, the prefill
    of 4 x 2048 tokens and the ServeEngine run, with the launch counts set
    to 0 just before and read just after; the prefill against the plain
    scan; one profiled tick.  Returns the path's ssd_scan launches, in
    all and by route."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MAMBA_ARCH)
    # 2 layers at full width in fp32: the card's kernel path against the
    # CPU's plain path, and decode against forward on the card
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    cpu_m = TransformerLM(cfg2, device="cpu").init(torch.Generator().manual_seed(2))
    card_m = TransformerLM(cfg2, device="cuda")
    card_m.load_state_dict(cpu_m.state_dict())
    toks2 = torch.randint(0, cfg.vocab, (2, 512), generator=torch.Generator().manual_seed(3))
    h_card = card_m.forward(toks2.cuda())
    h_cpu = cpu_m.forward(toks2)
    l_card, l_cpu = card_m._logits(h_card[:, -1]).cpu(), cpu_m._logits(h_cpu[:, -1])
    d_h = (h_card.cpu() - h_cpu).abs().max().item()
    d_l = (l_card - l_cpu)[:, : cfg.vocab].abs().max().item()
    print(f"[mamba] 2 layers, full width, fp32, 2 x 512 tokens ("
          f"{512 // cfg.ssm.chunk} chunks of {cfg.ssm.chunk}): card (kernel) vs "
          f"cpu (plain): hidden max diff "
          f"{d_h:.3g}, last logits max diff {d_l:.3g} (atol {LM_FP32_ATOL})", flush=True)
    if not max(d_h, d_l) <= LM_FP32_ATOL:
        raise AssertionError("the card's fp32 mamba2 disagrees with the CPU's")
    del cpu_m, h_card
    errs, agree = _decode_vs_forward(card_m, 16, 2)
    print(f"[mamba] decode vs forward, 2 layers fp32 on the card, 16 positions: "
          f"max err per position {' '.join(f'{e:.2g}' for e in errs)}; argmax "
          f"agrees at {agree} of 16", flush=True)
    if not (errs[0] < 1e-3 and max(errs) < 1e-2 and agree == 16):
        raise AssertionError("fp32 mamba2 decode disagrees with the forward")
    del card_m
    _free()

    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    s = cfg.ssm
    print(f"[mamba] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_inner {s.d_inner(cfg.d_model)}, {s.n_heads(cfg.d_model)} SSM heads "
          f"of {s.head_dim}, d_state {s.d_state}, chunk {s.chunk}, vocab "
          f"{cfg.vocab} padded to {model.vp}; "
          f"{sum(p.numel() for p in model.parameters())} parameters in "
          f"{cfg.dtype} (param_count {cfg.param_count()}), initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: the prefill, then the ServeEngine run
    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    for counted in (ss.ssd_scan, fa.flash_attention, mg.moe_grouped_gemm):
        counted.launches = 0
    routes0 = _routes(ss.ssd_scan)
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_pre = ss.ssd_scan.launches
    _check_route("mamba2 prefill", routes0, _routes(ss.ssd_scan), ["mma"])
    stats = engine.run()
    launches = ss.ssd_scan.launches
    by_route = {r: n - routes0[0][r] for r, n in ss.ssd_scan.launches_by_route.items()}
    others = fa.flash_attention.launches + mg.moe_grouped_gemm.launches
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("mamba2 prefill logits not finite or of the wrong shape")
    if n_pre != cfg.n_layers or others:
        raise AssertionError(f"mamba2 prefill launched ssd_scan {n_pre} times "
                             f"and the other kernels {others} times")
    warm = _warm_prefill(model, toks)
    with _plain("ssd"):
        want = model.prefill(toks)
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[mamba] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {n_pre} ssd_scan launches, all on the "
          f"mma route; against the "
          f"plain scan: max abs logit diff {d_pre:.4g} (logits in "
          f"[{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} "
          f"of {B}", flush=True)
    _gate_prefill("mamba", d_pre, want[:, : cfg.vocab])
    h = engine.cache["h"]
    print(f"[mamba serve] recurrent state {list(h.shape)} fp32, "
          f"{h.numel() * h.element_size()} bytes", flush=True)
    ms_tick = _serve_checks("mamba serve", model, stats, reqs,
                            {"ssd_scan": (launches - n_pre, 0)})
    _teacher_forced("mamba serve", model, reqs)
    _profile_tick("mamba profile", model, ms_tick, {"ssd_scan": ("ssd_scan",)})
    print(f"[mamba] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    return launches, by_route


def _moe_inputs(seed, t, d, f, e, dtype, gs):
    """Seeded x [t, d] and w [e, d, f] (scaled 1/sqrt(d), as the model's)
    on the card, and the group sizes as a device int32 tensor."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
    w = torch.randn(e, d, f, generator=gen, device="cuda").mul_(d ** -0.5).to(dtype)
    return x, w, torch.tensor(gs, dtype=torch.int32, device="cuda")


def _routed(seed, t, e, empty=()):
    """Group sizes: top-1 routing of t tokens to e experts (uniform), or,
    with ``empty``, a Dirichlet share of 0.9 t with those experts empty
    (the sweep of tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    if not empty:
        return np.bincount(rng.integers(0, e, t), minlength=e).tolist()
    share = rng.dirichlet(np.ones(e))
    share[list(empty)] = 0.0
    return np.floor(share / share.sum() * t * 0.9).astype(int).tolist()


def _routed_topk(seed, tokens, k, e):
    """Group sizes: top-k routing of ``tokens`` tokens, each to k distinct
    experts of e (uniform): tokens * k rows."""
    rng = np.random.default_rng(seed)
    hits = np.concatenate([rng.choice(e, k, replace=False) for _ in range(tokens)])
    return np.bincount(hits, minlength=e).tolist()


def _event_ms(fn, reps):
    """Device time per call from events around each call, L2 flushed
    before it, for a function that waits on the host inside (the plain
    grouped GEMM reads the group sizes): its host time is included."""
    import torch

    buf = torch.empty(2**25, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        buf.fill_(1.0)
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def _grouped_mm(x, w, gs, want):
    """``torch._grouped_mm`` on the same inputs, the yardstick (the port
    never calls it): a callable and a note, or None and the reason."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    rows = int(gs.sum().item())
    reason = ""
    for label, wl in (("w as stored", w),
                      ("w column-major", w.transpose(1, 2).contiguous().transpose(1, 2))):
        fn = lambda wl=wl: torch._grouped_mm(x, wl, offs=offs)
        try:
            out = fn()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, ValueError) as err:
            reason = f"torch._grouped_mm refused ({label}): {str(err).splitlines()[0]}"
            continue
        return fn, f"{label}, max diff to plain {_rel_err(out[:rows], want[:rows]):.3g} relative"
    return None, reason


def phase_moe_kernel(mg):
    """The grouped-GEMM kernel against its plain version at the sweep
    shapes of ``tests/test_kernels.py`` (an empty expert, rows past the
    sum) and llama4-scout's decode (T = 8, gate/up and down) and prefill
    (T = 8192, gate/up and down) shapes, fp32 and bf16; times at those four
    shapes in bf16
    beside the bound and ``torch._grouped_mm``.  Returns the JSON numbers
    (the decode gate/up shape: the serving path's launches)."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    D, Fe, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    kimi = get_config(KIMI_ARCH)
    KD, KF, KE, KK = kimi.d_model, kimi.moe.d_ff_expert, kimi.moe.n_experts, kimi.moe.top_k
    B, S = LM_PREFILL
    big = [("decode gate/up", (LM_SLOTS, D, Fe, E), _routed(1, LM_SLOTS, E)),
           ("decode down", (LM_SLOTS, Fe, D, E), _routed(1, LM_SLOTS, E)),
           ("prefill gate/up", (B * S, D, Fe, E), _routed(2, B * S, E)),
           ("prefill down", (B * S, Fe, D, E), _routed(2, B * S, E)),
           ("kimi decode gate/up", (LM_SLOTS * KK, KD, KF, KE),
            _routed_topk(3, LM_SLOTS, KK, KE)),
           ("kimi decode down", (LM_SLOTS * KK, KF, KD, KE),
            _routed_topk(3, LM_SLOTS, KK, KE))]
    checks = [(f"sweep {i}", shape, _routed(10 + i, shape[0], shape[3], empty=(1,)))
              for i, shape in enumerate(MOE_SWEEP)] + big
    worst = 0.0
    for seed, (label, (t, d, f, e), gs) in enumerate(checks):
        errs = {}
        for dtype in ("float32", "bfloat16"):
            x, w, g = _moe_inputs(seed, t, d, f, e, getattr(torch, dtype), gs)
            got = mg.moe_grouped_gemm(x, w, g)
            want = mg.moe_grouped_gemm_plain(x, w, g)
            torch.cuda.synchronize()
            errs[dtype] = _rel_err(got, want)
            if not (errs[dtype] <= KERNEL_RTOL[dtype] and not got[sum(gs):].any()):
                raise AssertionError(f"moe kernel != plain at {label} {dtype}: "
                                     f"relative err {errs[dtype]} (tol {KERNEL_RTOL[dtype]})")
            if dtype == "float32":
                worst = max(worst, (got - want).abs().max().item())
            del x, w, g, got, want
        print(f"[moe kernel] {label}: x [{t}, {d}], w [{e}, {d}, {f}], {sum(gs)} rows "
              f"over {sum(1 for v in gs if v)} experts: max err relative to the "
              f"largest output, fp32 {errs['float32']:.3g}, bf16 {errs['bfloat16']:.3g}",
              flush=True)
    _free()
    rows = {}
    for label, (t, d, f, e), gs in big:
        x, w, g = _moe_inputs(7, t, d, f, e, torch.bfloat16, gs)
        want = mg.moe_grouped_gemm_plain(x, w, g)
        kernel = lambda: mg.moe_grouped_gemm(x, w, g)
        decode = mg.route(x.dtype, t, e) == "stream"
        if decode:
            _bit_stable(f"moe {label}", kernel)
        ms = _device_ms(kernel, 20 if decode else 5, flush=True)
        plain_ms = _event_ms(lambda: mg.moe_grouped_gemm_plain(x, w, g), 5)
        lib, note = _grouped_mm(x, w, g, want)
        library_ms = _device_ms(lib, 20 if decode else 5, flush=True) if lib else None
        flops, n_bytes = mg.cost(x, w, gs)
        bound, by = _bound(flops, n_bytes, 2)
        lib_txt = f"{library_ms:.4f} ms ({note})" if lib else f"none ({note})"
        print(f"[moe kernel] {label} bf16 ({sum(1 for v in gs if v)} experts hit): "
              f"device time per call, L2 flushed: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (host included: it reads the group sizes), "
              f"torch._grouped_mm {lib_txt}; bound {bound:.6f} ms by {by} "
              f"({flops} flops, {n_bytes} bytes; {100 * bound / ms:.1f}% of the "
              f"kernel's time)", flush=True)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound, bound_by=by)
        del x, w, g, want, lib
        _free()
    out = dict(rows["decode gate/up"])
    out["max_abs_err"] = worst
    out.update(_prefill_nums(rows["prefill gate/up"]))
    out.update(_shape_nums("kimi_decode", rows["kimi decode gate/up"]))
    return out


def phase_moe(mg, fa):
    """llama4-scout at full width and MOE_LAYERS of its 48 layers on the
    card: at 2 layers in fp32 the kernel path against the plain path and
    decode against forward; then the main path, the prefill of 4 x 2048
    tokens and the ServeEngine run, with the launch counts set to 0 just
    before and read just after; the prefill against the plain path; one
    profiled tick.  Returns the path's launches per kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    # 2 layers at full width in fp32 (16 GB of experts): the kernels
    # against their plain versions on the card (the CPU is too slow for
    # them; the CPU tests hold the plain path to JAX), and decode against
    # forward
    m2 = TransformerLM(dataclasses.replace(cfg, n_layers=2, dtype="float32"),
                       device="cuda").init(torch.Generator(device="cuda").manual_seed(2))
    toks2 = torch.randint(0, cfg.vocab, (2, 256),
                          generator=torch.Generator().manual_seed(3)).cuda()
    h_k = m2.forward(toks2)
    with _plain("flash", "moe"):
        h_p = m2.forward(toks2)
    d_h = (h_k - h_p).abs().max().item()
    d_l = (m2._logits(h_k[:, -1]) - m2._logits(h_p[:, -1]))[:, : cfg.vocab].abs().max().item()
    print(f"[moe] 2 layers, full width, fp32, 2 x 256 tokens: kernels vs plain "
          f"on the card: hidden max diff {d_h:.3g}, last logits max diff {d_l:.3g} "
          f"(atol {LM_FP32_ATOL})", flush=True)
    if not max(d_h, d_l) <= LM_FP32_ATOL:
        raise AssertionError("llama4 fp32: the kernels disagree with the plain path")
    del h_k, h_p
    errs, agree = _decode_vs_forward(m2, 16, 2)
    print(f"[moe] decode vs forward, 2 layers fp32 on the card, 16 positions: "
          f"max err per position {' '.join(f'{e:.2g}' for e in errs)}; argmax "
          f"agrees at {agree} of 16", flush=True)
    if not (errs[0] < 1e-3 and max(errs) < 1e-2 and agree == 16):
        raise AssertionError("fp32 llama4 decode disagrees with the forward")
    del m2
    _free()

    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    e = cfg.moe
    print(f"[moe] {cfg.name} at {cfg.n_layers} of 48 layers: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, "
          f"{e.n_experts} experts of d_ff {e.d_ff_expert}, top-{e.top_k}, vocab "
          f"{cfg.vocab} padded to {model.vp}; "
          f"{sum(p.numel() for p in model.parameters())} parameters in "
          f"{cfg.dtype} (param_count {cfg.param_count()}), initialised on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: the prefill, then the ServeEngine run
    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    mg.moe_grouped_gemm.launches = 0
    routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre = (mg.moe_grouped_gemm.launches, fa.flash_attention.launches)
    pre_routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    stats = engine.run()
    launches = {"moe_gemm": mg.moe_grouped_gemm.launches,
                "flash_attention": fa.flash_attention.launches}
    _check_wgmma("moe prefill", routes, pre_routes, [3 * cfg.n_layers, cfg.n_layers])
    warm = _warm_prefill(model, toks)
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("llama4 prefill logits not finite or of the wrong shape")
    if pre != (3 * cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"llama4 prefill launched (moe_gemm, flash) {pre} times")
    with _plain("flash", "moe"):
        want = model.prefill(toks)
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[moe] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {pre[0]} moe_gemm and {pre[1]} flash "
          f"launches, all on the wgmma routes; against the plain "
          f"path: max abs logit diff {d_pre:.4g} (logits in "
          f"[{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} "
          f"of {B}", flush=True)
    _gate_prefill("moe", d_pre, want[:, : cfg.vocab])
    ms_tick = _serve_checks("moe serve", model, stats, reqs, {
        "moe_gemm": (launches["moe_gemm"] - pre[0], 3 * cfg.n_layers),
        "flash_attention": (launches["flash_attention"] - pre[1], cfg.n_layers)})
    _teacher_forced("moe serve", model, reqs)
    _profile_tick("moe profile", model, ms_tick,
                  {"moe_gemm": ("moe_gemm", "moe_wgmma", "moe_stream"),
                   "flash_attention": ("flash_decode", "flash_tiled", "flash_wgmma")})
    print(f"[moe] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    return launches


def _check_route(tag, before, after, want):
    """Fail unless the launches between the two ``_routes`` readings all
    went through the route named in ``want`` for each wrapper, and some
    did."""
    for b, a, r in zip(before, after, want):
        moved = {k: a[k] - b[k] for k in a}
        if moved[r] == 0 or sum(moved.values()) != moved[r]:
            raise AssertionError(f"{tag}: launches by route were {moved}, expected "
                                 f"all on the {r} route")


def phase_kimi(mg, fa):
    """kimi-k2-1t-a32b at full width and KIMI_LAYERS of its 61 layers on the
    card, bf16: the main path (the prefill of 4 x 2048 tokens, on the
    wgmma routes, then the ServeEngine run, whose ticks go through flash's
    decode route at head_dim 112 and moe_gemm's streaming route), with the
    launch counts set to 0 just before and read just after; the prefill
    against the plain path; decode against forward; one profiled tick.
    Returns the path's launches per kernel."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(KIMI_ARCH), n_layers=KIMI_LAYERS)
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    e = cfg.moe
    print(f"[kimi] {cfg.name} at {cfg.n_layers} of 61 layers (the cut: one "
          f"layer's {e.n_experts} experts are "
          f"{3 * e.n_experts * cfg.d_model * e.d_ff_expert * 2} bytes in bf16, so "
          f"two layers do not fit the card): d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} KV heads, head_dim {cfg.hd}, {e.n_experts} "
          f"experts of d_ff {e.d_ff_expert}, top-{e.top_k}, vocab {cfg.vocab} padded "
          f"to {model.vp}; {sum(p.numel() for p in model.parameters())} parameters "
          f"in {cfg.dtype} (param_count {cfg.param_count()}), initialised on the card "
          f"in {time.perf_counter() - t0:.1f} s; peak so far "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)

    # the main path: the prefill, then the ServeEngine run
    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    mg.moe_grouped_gemm.launches = 0
    routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    t0 = time.perf_counter()
    got = model.prefill(toks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre = (mg.moe_grouped_gemm.launches, fa.flash_attention.launches)
    pre_routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    stats = engine.run()
    launches = {"moe_gemm": mg.moe_grouped_gemm.launches,
                "flash_attention": fa.flash_attention.launches}
    tick_routes = _routes(mg.moe_grouped_gemm, fa.flash_attention)
    _check_wgmma("kimi prefill", routes, pre_routes, [3 * cfg.n_layers, cfg.n_layers])
    _check_route("kimi ticks", pre_routes, tick_routes, ["stream", "decode"])
    print(f"[kimi] launches by route: prefill moe_gemm "
          f"{ {k: pre_routes[0][k] - routes[0][k] for k in routes[0]} }, flash "
          f"{ {k: pre_routes[1][k] - routes[1][k] for k in routes[1]} }; ticks "
          f"moe_gemm { {k: tick_routes[0][k] - pre_routes[0][k] for k in routes[0]} }, "
          f"flash { {k: tick_routes[1][k] - pre_routes[1][k] for k in routes[1]} }",
          flush=True)
    warm = _warm_prefill(model, toks)
    if not (torch.isfinite(got[:, : cfg.vocab]).all() and got.shape == (B, model.vp)):
        raise AssertionError("kimi prefill logits not finite or of the wrong shape")
    if pre != (3 * cfg.n_layers, cfg.n_layers):
        raise AssertionError(f"kimi prefill launched (moe_gemm, flash) {pre} times")
    with _plain("flash", "moe"):
        want = model.prefill(toks)
    d_pre = (got - want)[:, : cfg.vocab].abs().max().item()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum().item())
    print(f"[kimi] prefill {B} x {S} tokens, bf16: {wall:.3f} s (first call), "
          f"{warm:.3f} s (second call), {pre[0]} moe_gemm and {pre[1]} flash "
          f"launches, all on the wgmma routes; against the plain path: max abs "
          f"logit diff {d_pre:.4g} (logits in [{got[:, :cfg.vocab].min().item():.3f}, "
          f"{got[:, :cfg.vocab].max().item():.3f}]), argmax agrees on {agree} "
          f"of {B}", flush=True)
    _gate_prefill("kimi", d_pre, want[:, : cfg.vocab])
    del got, want
    ms_tick = _serve_checks("kimi serve", model, stats, reqs, {
        "moe_gemm": (launches["moe_gemm"] - pre[0], 3 * cfg.n_layers),
        "flash_attention": (launches["flash_attention"] - pre[1], cfg.n_layers)})
    _teacher_forced("kimi serve", model, reqs)
    errs, agree = _decode_vs_forward(model, 16, LM_SLOTS)
    with _plain("flash", "moe"):
        errs_p, agree_p = _decode_vs_forward(model, 16, LM_SLOTS)
    tols = [max(KIMI_DECODE_ATOL, KIMI_DECODE_NOISE * e) for e in errs_p]
    print(f"[kimi] decode vs forward, {cfg.n_layers} layer bf16, {LM_SLOTS} "
          f"sequences, 16 positions: max err per position "
          f"{' '.join(f'{e:.2g}' for e in errs)}; argmax agrees on all sequences "
          f"at {agree} of 16 positions; the same through the plain versions: "
          f"{' '.join(f'{e:.2g}' for e in errs_p)}, argmax at {agree_p} of 16 "
          f"(tol per position: {KIMI_DECODE_ATOL}, or {KIMI_DECODE_NOISE}x the plain "
          f"path's error there)", flush=True)
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError("kimi decode disagrees with the forward")
    _profile_tick("kimi profile", model, ms_tick,
                  {"moe_gemm": ("moe_gemm", "moe_wgmma", "moe_stream"),
                   "flash_attention": ("flash_decode", "flash_tiled", "flash_wgmma")})
    print(f"[kimi] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    return launches


def phase_kimi_serve(mg, fa, t):
    """kimi_serve: the attention kernel at kimi-k2's shapes (64 query heads
    over 8 KV heads of 112), then the model.  Returns the path's launches
    and the largest fp32 attention error."""
    from repro_torch.configs import get_config

    cfg = get_config(KIMI_ARCH)
    flash_err = _flash_checks(fa, _path_flash_checks(cfg.n_heads, cfg.n_kv_heads, cfg.hd),
                              "kimi flash kernel")
    t = _phase_done(f"flash_attention checks at {KIMI_ARCH}'s shapes", t)
    launches = phase_kimi(mg, fa)
    t = _phase_done(f"kimi serving (kimi-k2 at {KIMI_LAYERS} layer: prefill, "
                    "ServeEngine, decode, profile)", t)
    return launches, flash_err, t


# ------------------------------------------------- the last four families
# gemma2-27b, zamba2-7b, llava-next-mistral-7b and hubert-xlarge at full
# width.  Each ServeEngine run is one wave: FAMILY_REQUESTS requests of
# launch/serve.py's prompts over LM_SLOTS slots, smax LM_SMAX, with
# FAMILY_MAX_TOKENS new tokens each.
FAMILY_REQUESTS, FAMILY_MAX_TOKENS = 8, 64
FLASH_KEYS = ("flash_decode", "flash_tiled", "flash_wgmma")
# gemma2: 8 of its 46 layers, four local/global pairs (~11.5 GB of the
# ~54 GB; cut for time, and for room for the plain path's 8192^2 fp32
# scores in the prefill check); the prefill of one sequence at its
# context of 8192, past its 4096 window; the kernel's decode shape at a
# position the window cuts; decode against forward over 64 positions
GEMMA_ARCH, GEMMA_LAYERS, GEMMA_PREFILL = "gemma2-27b", 8, (1, 8192)
GEMMA_DECODE_POS, GEMMA_DECODE_STEPS = 6143, 64
# zamba2: 13 of its 81 layers, two groups of 6 each followed by the shared
# block, then 1 trailing layer (~2.9 GB of ~13.5 GB; cut for time); the
# fp32 check runs one group, the shared block and the trailing layer
ZAMBA_ARCH, ZAMBA_LAYERS, ZAMBA_FP32_LAYERS = "zamba2-7b", 13, 7
# llava: full depth; the prefill of 2 x (2880 patch embeddings + 2048
# tokens), 4928 positions, past mistral's 4096 window
LLAVA_ARCH, LLAVA_PREFILL = "llava-next-mistral-7b", (2, 2048)
# hubert: full depth; 4 clips of 30 s at its conv frontend's 50 Hz
HUBERT_ARCH, HUBERT_FRAMES = "hubert-xlarge", (4, 1500)
FAMILY_DECODE_STEPS = 16  # zamba2's and llava's decode against forward


def _lm_kernels(fa, ss, mg):
    """The LM's kernel wrappers by name."""
    return {"flash_attention": fa.flash_attention, "ssd_scan": ss.ssd_scan,
            "moe_gemm": mg.moe_grouped_gemm}


def _family_model(tag, cfg, depth):
    """``cfg``'s bf16 model on the card, weights from a seeded generator."""
    import torch

    from repro_torch.models import TransformerLM

    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} ({cfg.block_pattern}, {depth}): d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab} padded to {model.vp}; "
          f"{sum(p.numel() for p in model.parameters())} parameters in {cfg.dtype} "
          f"(param_count {cfg.param_count()}), initialised on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model


def _fp32_card_vs_cpu(tag, cfg, n_layers, toks, kw):
    """``n_layers`` of ``cfg`` at full width in fp32: the card's kernel path
    against the CPU's plain path on the same weights (drawn on the card,
    copied to the CPU) and inputs (CPU tensors: ``toks`` or None, and the
    frontend's ``kw``): hidden states and last-position logits within
    LM_FP32_ATOL."""
    import torch

    from repro_torch.models import TransformerLM

    cfg2 = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    card_m = TransformerLM(cfg2, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(2))
    cpu_m = TransformerLM(cfg2, device="cpu")
    cpu_m.load_state_dict(card_m.state_dict())
    h_card = card_m.forward(None if toks is None else toks.cuda(),
                            **{k: v.cuda() for k, v in kw.items()})
    l_card = card_m._logits(h_card[:, -1]).cpu()
    h_card = h_card.cpu()
    del card_m
    _free()
    h_cpu = cpu_m.forward(toks, **kw)
    l_cpu = cpu_m._logits(h_cpu[:, -1])
    d_h = (h_card - h_cpu).abs().max().item()
    d_l = (l_card - l_cpu)[:, : cfg.vocab].abs().max().item()
    shape = "x".join(str(n) for n in h_cpu.shape[:2])
    print(f"[{tag}] {n_layers} layers, full width, fp32, {shape} positions: card "
          f"(kernels) vs cpu (plain): hidden max diff {d_h:.3g}, last logits max "
          f"diff {d_l:.3g} (atol {LM_FP32_ATOL})", flush=True)
    if not max(d_h, d_l) <= LM_FP32_ATOL:
        raise AssertionError(f"{tag}: the card's fp32 model disagrees with the CPU's")


def _decode_gate(tag, model, n_pos):
    """bf16 decode against forward over the first ``n_pos`` positions of
    LM_SLOTS seeded sequences: every logit within PREFILL_RTOL of the
    largest forward logit (the two round differently; a wrong kernel or
    cache entry moves logits by their own size).  Returns the decode's
    cache."""
    errs, agree, scale, cache = _decode_run(model, n_pos, LM_SLOTS)
    lim = PREFILL_RTOL * scale
    print(f"[{tag}] decode vs forward, {model.cfg.n_layers} layers bf16, {LM_SLOTS} "
          f"sequences, {n_pos} positions: max err per position "
          f"{' '.join(f'{e:.2g}' for e in errs)}; argmax agrees on all sequences at "
          f"{agree} of {n_pos} positions; limit {lim:.4g} ({PREFILL_RTOL} of the "
          f"largest forward logit)", flush=True)
    if not (all(np.isfinite(errs)) and max(errs) <= lim):
        raise AssertionError(f"{tag}: bf16 decode disagrees with the forward")
    return cache


def _main_path(counted, call, engine=None):
    """A family's main path: every wrapper of ``counted`` (name ->
    wrapper) at 0 launches, ``call()`` (the prefill, or the encoder's
    forward) timed, then ``engine.run()`` when given, the counts read
    after.  Returns the call's output, its wall, its launches by route
    per wrapper, the engine's stats and the path's launches and launches
    by route per wrapper."""
    import torch

    torch.cuda.synchronize()
    for w in counted.values():
        w.launches = 0
    start = {n: dict(w.launches_by_route) for n, w in counted.items()}

    def moved():
        return {n: {r: c - start[n][r] for r, c in w.launches_by_route.items()}
                for n, w in counted.items()}

    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre = moved()
    stats = engine.run() if engine is not None else None
    launches = {n: w.launches for n, w in counted.items()}
    return out, wall, pre, stats, launches, moved()


def _expect_routes(tag, moved, want):
    """Fail unless the launches by route of ``moved`` are exactly ``want``
    (name -> {route: count}; every other route and wrapper at 0)."""
    for name, by_route in moved.items():
        exp = {r: want.get(name, {}).get(r, 0) for r in by_route}
        if by_route != exp:
            raise AssertionError(f"{tag}: {name} launches by route were {by_route}, "
                                 f"expected {exp}")
    print(f"[{tag}] launches by route: " + "; ".join(
        f"{n} {r}" for n, r in moved.items() if any(r.values())), flush=True)


def _warm(call):
    """Seconds of a second, warm ``call()`` (the allocator's blocks and the
    kernels' first-launch costs already in place)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _against_plain(tag, label, cfg, got, call, names, wall, what="prefill"):
    """The main path's ``got`` (logits, the vocabulary's columns first)
    against ``call()`` through the plain versions of ``names``, within
    PREFILL_RTOL of the largest plain logit; prints the first and warm
    walls."""
    import torch

    warm = _warm(call)
    with _plain(*names):
        want = call()
    if not (torch.isfinite(got[..., : cfg.vocab]).all() and got.shape == want.shape):
        raise AssertionError(f"{tag}: logits not finite or of the wrong shape")
    d = (got - want)[..., : cfg.vocab].abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"[{tag}] {label}, bf16: {wall:.3f} s (first call), {warm:.3f} s "
          f"(second call); against the plain path: max abs logit diff {d:.4g} "
          f"(logits in [{got[..., :cfg.vocab].min().item():.3f}, "
          f"{got[..., :cfg.vocab].max().item():.3f}]), argmax agrees at "
          f"{100 * agree:.1f}% of the rows", flush=True)
    _gate_prefill(tag, d, want[..., : cfg.vocab], what)


def _serve_family(tag, model, stats, reqs, launches, pre, per_tick, kernels):
    """The family's engine run checked (``per_tick``: name -> launches a
    tick; the other wrappers none), its first wave against a
    teacher-forced forward, one profiled tick, the peak memory."""
    import torch

    ms_tick = _serve_checks(tag + " serve", model, stats, reqs, {
        n: (launches[n] - sum(pre[n].values()), per_tick.get(n, 0)) for n in launches})
    _teacher_forced(tag + " serve", model, reqs)
    _profile_tick(tag + " profile", model, ms_tick, kernels)
    print(f"[{tag}] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)


def phase_gemma(fa, ss, mg):
    """gemma2-27b at full width and GEMMA_LAYERS of its 46 layers on the
    card: 2 layers in fp32 against the CPU; bf16 decode against forward;
    the main path (the prefill of one 8192-token sequence, its 8 flash
    launches on the wgmma route with the window on the even layers, then
    the ServeEngine run); the prefill against the plain attention; one
    profiled tick (the tied head's fp32 copy among the copies).  Returns
    the path's launches and launches by route."""
    import torch

    from repro_torch.configs import get_config

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(GEMMA_ARCH), n_layers=GEMMA_LAYERS)
    toks2 = torch.randint(0, cfg.vocab, (2, 128), generator=torch.Generator().manual_seed(3))
    _fp32_card_vs_cpu("gemma2", cfg, 2, toks2, {})
    model = _family_model("gemma2", cfg, f"{cfg.n_layers} of 46 layers")
    windows = [model._window_for(i) for i in range(cfg.n_layers)]
    print(f"[gemma2] windows by layer: {windows}; attention softcap "
          f"{cfg.attn_softcap}, logit softcap {cfg.logit_softcap}, query scale "
          f"{cfg.q_scaling():.6f}", flush=True)
    _decode_gate("gemma2", model, GEMMA_DECODE_STEPS)

    B, S = GEMMA_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model, FAMILY_REQUESTS, FAMILY_MAX_TOKENS)
    call = lambda: model.prefill(toks)
    got, wall, pre, stats, launches, path = _main_path(_lm_kernels(fa, ss, mg), call, engine)
    _expect_routes("gemma2 prefill", pre, {"flash_attention": {"wgmma": cfg.n_layers}})
    _against_plain("gemma2", f"prefill {B} x {S} tokens", cfg, got, call, ("flash",), wall)
    del got
    _serve_family("gemma2", model, stats, reqs, launches, pre,
                  {"flash_attention": cfg.n_layers},
                  {"flash_attention": FLASH_KEYS, "copies and casts": ("copy",)})
    return launches, path


def phase_zamba(fa, ss, mg):
    """zamba2-7b at full width and ZAMBA_LAYERS of its 81 layers on the
    card: ZAMBA_FP32_LAYERS in fp32 against the CPU; bf16 decode against
    forward, with both shared-block applications' KV entries written; the
    main path (the prefill of 4 x 2048 tokens, its ssd_scan launches on
    the mma route and its flash launches on wgmma, then the ServeEngine
    run); the prefill against the plain path; one profiled tick.  Returns
    the path's launches and launches by route."""
    import torch

    from repro_torch.configs import get_config

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(ZAMBA_ARCH), n_layers=ZAMBA_LAYERS)
    n_apps = cfg.n_layers // cfg.hybrid_every
    toks2 = torch.randint(0, cfg.vocab, (1, 512), generator=torch.Generator().manual_seed(3))
    _fp32_card_vs_cpu("zamba2", cfg, ZAMBA_FP32_LAYERS, toks2, {})
    s = cfg.ssm
    model = _family_model("zamba2", cfg, f"{cfg.n_layers} of 81 layers: the shared "
                          f"block after layers {cfg.hybrid_every - 1} and "
                          f"{2 * cfg.hybrid_every - 1}; mamba2 d_inner "
                          f"{s.d_inner(cfg.d_model)}, {s.n_heads(cfg.d_model)} SSM "
                          f"heads of {s.head_dim}, d_state {s.d_state}, chunk {s.chunk}")
    cache = _decode_gate("zamba2", model, FAMILY_DECODE_STEPS)
    kv = cache["attn"]["k"]
    norms = [kv[a].float().norm().item() for a in range(kv.shape[0])]
    print(f"[zamba2] decode cache: mamba {sorted(cache['mamba'])} over "
          f"{cache['mamba']['h'].shape[0]} layers; shared-block KV {list(kv.shape)}, "
          f"one entry per application, norms {norms}", flush=True)
    if kv.shape[0] != n_apps or not all(np.isfinite(norms)) or min(norms) == 0:
        raise AssertionError("zamba2: a shared-block application's KV entry was not written")
    del cache, kv

    B, S = LM_PREFILL
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    engine, reqs = _engine(model, FAMILY_REQUESTS, FAMILY_MAX_TOKENS)
    call = lambda: model.prefill(toks)
    got, wall, pre, stats, launches, path = _main_path(_lm_kernels(fa, ss, mg), call, engine)
    _expect_routes("zamba2 prefill", pre, {"ssd_scan": {"mma": cfg.n_layers},
                                           "flash_attention": {"wgmma": n_apps}})
    _against_plain("zamba2", f"prefill {B} x {S} tokens", cfg, got, call,
                   ("flash", "ssd"), wall)
    del got
    _serve_family("zamba2", model, stats, reqs, launches, pre,
                  {"flash_attention": n_apps},
                  {"flash_attention": FLASH_KEYS, "ssd_scan": ("ssd_scan",)})
    return launches, path


def _patches(b, n, d, gen, device):
    """Seeded precomputed patch embeddings [b, n, d] at the embedding
    table's scale (standard normals over sqrt(d))."""
    import torch

    return torch.randn(b, n, d, generator=gen, device=device) / math.sqrt(d)


def phase_llava(fa, ss, mg):
    """llava-next-mistral-7b at full width and depth on the card: 2 layers
    in fp32 with a patch prefix against the CPU; bf16 decode against
    forward (tokens only, as the engine serves it); the main path (the
    prefill of 2 x (2880 patches + 2048 tokens), its 32 flash launches on
    the wgmma route with mistral's window cutting, then the ServeEngine
    run); the prefill against the plain attention; one profiled tick.
    Returns the path's launches and launches by route."""
    import torch

    from repro_torch.configs import get_config

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(LLAVA_ARCH)
    gen = torch.Generator().manual_seed(3)
    toks2 = torch.randint(0, cfg.vocab, (2, 192), generator=gen)
    _fp32_card_vs_cpu("llava", cfg, 2, toks2,
                      {"patches": _patches(2, 64, cfg.d_model, gen, "cpu")})
    model = _family_model("llava", cfg, f"full depth, {cfg.n_layers} layers, window "
                          f"{cfg.sliding_window}, {cfg.n_patches} patches")
    _decode_gate("llava", model, FAMILY_DECODE_STEPS)

    B, S = LLAVA_PREFILL
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), device="cuda", generator=gen)
    patches = _patches(B, cfg.n_patches, cfg.d_model, gen, "cuda").to(torch.bfloat16)
    engine, reqs = _engine(model, FAMILY_REQUESTS, FAMILY_MAX_TOKENS)
    call = lambda: model.prefill(toks, patches=patches)
    got, wall, pre, stats, launches, path = _main_path(_lm_kernels(fa, ss, mg), call, engine)
    _expect_routes("llava prefill", pre, {"flash_attention": {"wgmma": cfg.n_layers}})
    _against_plain("llava", f"prefill {B} x ({cfg.n_patches} patches + {S} tokens) = "
                   f"{B} x {cfg.n_patches + S} positions", cfg, got, call, ("flash",), wall)
    del got, patches
    _serve_family("llava", model, stats, reqs, launches, pre,
                  {"flash_attention": cfg.n_layers}, {"flash_attention": FLASH_KEYS})
    return launches, path


def phase_hubert(fa, ss, mg):
    """hubert-xlarge at full width and depth on the card: 2 layers in fp32
    against the CPU; the main path (the forward over 4 x 1500 frames to
    per-frame logits, its 48 flash launches on the wgmma route,
    bidirectional); the logits against the plain attention's; the
    encoder refused by ``decode_step``, ``cache_struct`` and the engine.
    Returns the path's launches and launches by route."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.serve import ServeEngine

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(HUBERT_ARCH)
    gen = torch.Generator().manual_seed(3)
    _fp32_card_vs_cpu("hubert", cfg, 2, None,
                      {"frames": torch.randn(2, 300, cfg.d_model, generator=gen)})
    model = _family_model("hubert", cfg, f"full depth, {cfg.n_layers} layers, "
                          f"{cfg.norm}, {cfg.mlp}, bidirectional, no rope")

    B, T = HUBERT_FRAMES
    frames = torch.randn(B, T, cfg.d_model, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
    frames = frames.to(torch.bfloat16)
    call = lambda: model._logits(model.forward(frames=frames))
    got, wall, pre, _, launches, path = _main_path(_lm_kernels(fa, ss, mg), call)
    _expect_routes("hubert forward", pre, {"flash_attention": {"wgmma": cfg.n_layers}})
    if got.shape != (B, T, model.vp) or not (got[..., cfg.vocab:] == -1e30).all():
        raise AssertionError(f"hubert: per-frame logits {list(got.shape)}, or a padded "
                             "entry not at -1e30")
    print(f"[hubert] per-frame logits {list(got.shape)} fp32, the {model.vp - cfg.vocab} "
          f"padded entries at -1e30", flush=True)
    _against_plain("hubert", f"forward {B} x {T} frames", cfg, got, call, ("flash",), wall)
    refused = []
    for name, fn in (("decode_step", lambda: model.decode_step(
                         {}, torch.zeros(B, dtype=torch.int32, device="cuda"), 0)),
                     ("cache_struct", lambda: model.cache_struct(B, 8)),
                     ("ServeEngine", lambda: ServeEngine(model, n_slots=B, smax=8))):
        try:
            fn()
        except ValueError as err:
            refused.append(f"{name} ({err})")
            continue
        raise AssertionError(f"hubert: {name} accepted the encoder")
    print(f"[hubert] refused: {'; '.join(refused)}", flush=True)
    print(f"[hubert] peak device memory {torch.cuda.max_memory_allocated()} bytes",
          flush=True)
    return launches, path


def _timed_flash(fa, tag, prefix, checks):
    """``checks`` (label, shape, kwargs) against the plain version in fp32
    and bf16, then each timed in bf16: (the largest fp32 error, the
    record's ``<prefix>_<label>_*`` numbers)."""
    err = _flash_checks(fa, checks, tag)
    nums = {}
    for label, shape, kw in checks:
        row = _flash_time(fa, tag, label, shape, kw)
        nums.update(_shape_nums(f"{prefix}_{label.replace(' ', '_')}", row))
    return err, nums


def phase_gemma_serve(fa, ss, mg, t):
    """gemma2_serve: the attention kernel at gemma2-27b's prefill shape
    (window and global, softcap 50, scale 144^-0.5) and decode shape
    (position GEMMA_DECODE_POS of an 8192 cache, window and global), then
    the model."""
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA_ARCH)
    B, S = GEMMA_PREFILL
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sc = dict(causal=True, softcap=cfg.attn_softcap, scale=cfg.q_scaling())
    win = dict(sc, window=cfg.sliding_window)
    dec = dict(q_offset=GEMMA_DECODE_POS)
    err, nums = _timed_flash(fa, "gemma2 flash kernel", "gemma2", [
        ("prefill", (B, h, kv, S, S, d), win),
        ("prefill global", (B, h, kv, S, S, d), sc),
        ("decode", (LM_SLOTS, h, kv, 1, S, d), dict(win, **dec)),
        ("decode global", (LM_SLOTS, h, kv, 1, S, d), dict(sc, **dec)),
    ])
    t = _phase_done(f"flash_attention checks and times at {GEMMA_ARCH}'s shapes", t)
    launches, path = phase_gemma(fa, ss, mg)
    t = _phase_done(f"gemma2 serving (gemma2-27b at {GEMMA_LAYERS} layers: parity, "
                    "decode, prefill, ServeEngine, profile)", t)
    return dict(flash_err=err, flash_nums=nums, launches=launches, by_route=path), t


def phase_zamba_serve(fa, ss, mg, t):
    """zamba2_serve: the SSD kernel at zamba2-7b's prefill shape (112 heads
    of 64, d_state 64, chunk 256) and the attention kernel at its shared
    block's (32 query heads over 32 KV heads of 112), then the model."""
    from repro_torch.configs import get_config

    cfg = get_config(ZAMBA_ARCH)
    B, S = LM_PREFILL
    s = cfg.ssm
    full = (B, S, s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.chunk)
    ssd_err = _ssd_checks(ss, "zamba2 ssd kernel", [("prefill", full, False)])
    ssd_nums = _shape_nums("zamba2_prefill", _ssd_time(ss, "zamba2 ssd kernel", full))
    flash_err, flash_nums = _timed_flash(fa, "zamba2 flash kernel", "zamba2", [
        ("prefill", (B, cfg.n_heads, cfg.n_kv_heads, S, S, cfg.hd), dict(causal=True))])
    t = _phase_done(f"ssd_scan and flash_attention checks and times at {ZAMBA_ARCH}'s "
                    "shapes", t)
    launches, path = phase_zamba(fa, ss, mg)
    t = _phase_done(f"zamba2 serving (zamba2-7b at {ZAMBA_LAYERS} layers: parity, "
                    "decode, prefill, ServeEngine, profile)", t)
    return dict(flash_err=flash_err, flash_nums=flash_nums, ssd_err=ssd_err,
                ssd_nums=ssd_nums, launches=launches, by_route=path), t


def phase_llava_serve(fa, ss, mg, t):
    """llava_serve: the attention kernel at llava's prefill shape (4928
    positions, 32 query heads over 8 KV heads, window 4096), then the
    model."""
    from repro_torch.configs import get_config

    cfg = get_config(LLAVA_ARCH)
    B, S = LLAVA_PREFILL
    n = cfg.n_patches + S
    err, nums = _timed_flash(fa, "llava flash kernel", "llava", [
        ("prefill", (B, cfg.n_heads, cfg.n_kv_heads, n, n, cfg.hd),
         dict(causal=True, window=cfg.sliding_window))])
    t = _phase_done(f"flash_attention checks and times at {LLAVA_ARCH}'s shapes", t)
    launches, path = phase_llava(fa, ss, mg)
    t = _phase_done("llava serving (llava-next-mistral-7b at full depth: parity, "
                    "decode, prefill with patches, ServeEngine, profile)", t)
    return dict(flash_err=err, flash_nums=nums, launches=launches, by_route=path), t


def phase_hubert_encode(fa, ss, mg, t):
    """hubert_encode: the attention kernel at hubert's shape (1500 frames,
    16 heads of 80, non-causal), then the model."""
    from repro_torch.configs import get_config

    cfg = get_config(HUBERT_ARCH)
    B, T = HUBERT_FRAMES
    err, nums = _timed_flash(fa, "hubert flash kernel", "hubert", [
        ("encode", (B, cfg.n_heads, cfg.n_kv_heads, T, T, cfg.hd), dict(causal=False))])
    t = _phase_done(f"flash_attention checks and times at {HUBERT_ARCH}'s shapes", t)
    launches, path = phase_hubert(fa, ss, mg)
    t = _phase_done("hubert encoding (hubert-xlarge at full depth: parity, forward, "
                    "per-frame logits, refusals)", t)
    return dict(flash_err=err, flash_nums=nums, launches=launches, by_route=path), t


FAMILY_PHASES = {"gemma2_serve": phase_gemma_serve, "zamba2_serve": phase_zamba_serve,
                 "llava_serve": phase_llava_serve, "hubert_encode": phase_hubert_encode}


def phase_families(fa, ss, mg, t, names=tuple(FAMILY_PHASES)):
    """The named family phases in order: their results by name."""
    out = {}
    for name in names:
        out[name], t = FAMILY_PHASES[name](fa, ss, mg, t)
    return out, t


def _add_families(flash, ssd_entry, families):
    """The family paths' numbers and launches merged into the flash
    numbers and the ssd_scan record; returns the paths' flash launches."""
    flash_launches = 0
    for fam in families.values():
        flash["max_abs_err"] = max(flash["max_abs_err"], fam["flash_err"])
        flash.update(fam["flash_nums"])
        flash_launches += fam["launches"]["flash_attention"]
        if "ssd_nums" in fam:
            ssd_entry.update(fam["ssd_nums"])
            ssd_entry["max_abs_err"] = max(ssd_entry["max_abs_err"], fam["ssd_err"])
        ssd_entry["launches"] += fam["launches"]["ssd_scan"]
        for r, n in fam["by_route"]["ssd_scan"].items():
            ssd_entry["launches_by_route"][r] += n
    return flash_launches


def _prefill_nums(row):
    """A timed prefill row as the record's prefill_* numbers."""
    return {"prefill_ms": row["ms"], "prefill_bound_ms": row["bound_ms"],
            "prefill_library_ms": row["library_ms"]}


def _shape_nums(prefix, row):
    """A timed row at a second shape as the record's <prefix>_* numbers."""
    return {f"{prefix}_{k}": row[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")}


def _entry(name, stem, replaces, nums, launches, by_route=None):
    """One kernel's record of the JSON line (source csrc/<stem>.cu); the
    flash and moe_gemm records also carry their prefill row's times,
    waterfill's its chain bound, ssd_scan's its FMA route's time and its
    launches by route, sage_aggregate's its gather probe's time and its
    backward's times (``bwd_ms``, ``bwd_bound_ms``, ``bwd_library_ms``)."""
    return {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{stem}.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": nums["max_abs_err"],
        "ms": nums["ms"],
        "plain_ms": nums["plain_ms"],
        "bound_ms": nums["bound_ms"],
        "bound_by": nums["bound_by"],
        "library_ms": nums.get("library_ms"),
        **{k: v for k, v in nums.items()
           if k.startswith(("prefill_", "kimi_", "chain_", "fma_", "bwd_", "probe_",
                            "gemma2_", "zamba2_", "llava_", "hubert_", "long_decode_"))},
        **({"launches_by_route": by_route} if by_route is not None else {}),
    }


def phase_mamba_serve(ss, fa, mg, t):
    ssd = phase_ssd_kernel(ss)
    t = _phase_done("ssd_scan kernel checks and times", t)
    launches, by_route = phase_mamba(ss, fa, mg)
    t = _phase_done("mamba2 serving (mamba2-1.3b: parity, decode, prefill, "
                    "ServeEngine, profile)", t)
    return _entry("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:83", ssd,
                  launches, by_route), t


def phase_moe_serve(mg, fa, t):
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    # llama4-scout's attention: 40 query heads over 8 KV heads, so decode
    # runs the 4-head grouping with a partial second group (5 = 4 + 1)
    flash_err = _flash_checks(fa, _path_flash_checks(cfg.n_heads, cfg.n_kv_heads, cfg.hd),
                              "moe flash kernel")
    t = _phase_done(f"flash_attention checks at {MOE_ARCH}'s shapes", t)
    moe = phase_moe_kernel(mg)
    t = _phase_done("moe_gemm kernel checks and times", t)
    launches = phase_moe(mg, fa)
    t = _phase_done(f"MoE serving (llama4-scout at {MOE_LAYERS} layers: parity, "
                    "decode, prefill, ServeEngine, profile)", t)
    entry = _entry("moe_gemm", "moe_gemm", "src/repro/kernels/moe_gemm.py:69", moe,
                   launches["moe_gemm"])
    return entry, launches["flash_attention"], flash_err, t


def phase_regimes_all(wf, t):
    """The regimes and re-planning path: counts set to 0 here, read after
    the replan phase; the CPU references run in worker processes
    meanwhile."""
    wf.waterfill_fill.launches = 0
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=get_context("spawn"),
                             initializer=_low_priority) as pool:
        pending, gpu, strict = phase_regimes(wf, pool)
        t = _phase_done("regimes (golden cells, papers under drift, migrations, "
                        "deadline shaping, utilization)", t)
        phase_replan()
        launches = wf.waterfill_fill.launches
        t = _phase_done("replan (run_scenario, on_leave under deadline shaping)", t)
        check_engine(pending, gpu)
        check_escalation(strict, gpu)
        t = _phase_done("waiting for the regimes' CPU references", t)
    if launches == 0:
        raise AssertionError("the regimes path never launched the waterfill kernel")
    return launches, t


# the tenants and cache phases (multi-job planning, the arrival service,
# the feature-cache tier): every simulation of a unit runs on the card in
# this process and on the CPU in a worker process meanwhile, and the two
# are compared once both are done.  Their depth: the search budgets and
# chain counts below; the jobs keep their widths and iterations.
TENANT_CHAINS, TENANT_BUDGET = 2, 4  # joint_search over the two-job pair
SERVICE_REPLAN_BUDGET, SERVICE_REPLAN_ITERS = 4, 2  # the service's warm re-plans
CACHE_CHAINS, CACHE_BUDGET, CACHE_SIM_ITERS = 8, 16, 8  # cache_sweep's section 4
PRODUCTS_CACHE_CHAINS, PRODUCTS_CACHE_BUDGET = 4, 8  # the products job's search
PRODUCTS_CACHE_ITERS, PRODUCTS_LEAVE_BUDGET = 4, 4
PRODUCTS_CACHE_GB = 0.25  # each sampler-hosting machine's cache, GB (~27% of the graph)


def _two_jobs():
    """``tests/test_multijob.py::two_jobs()``'s pair at the profiles' full
    widths, and its 4-machine cluster."""
    from repro_torch.core import (
        OGBN_PRODUCTS,
        REDDIT,
        build_workload_from_profile,
        heterogeneous_cluster,
    )

    j1 = build_workload_from_profile(OGBN_PRODUCTS, n_stores=4, n_workers=3,
                                     samplers_per_worker=2, n_ps=1, n_iters=12)
    j2 = build_workload_from_profile(REDDIT, n_stores=4, n_workers=2,
                                     samplers_per_worker=2, n_ps=1, n_iters=8)
    return [j1, j2], heterogeneous_cluster(4, seed=3, gpu_range=(2, 4))


def _unit_joint(device):
    """``joint_search`` on the pair; ``merged_batch_cost`` of the winner and
    of each chain's IFS start under oes and fifo (DistDGL's scheduler:
    waterfill's rates); ``per_job_makespans`` and
    ``per_job_iteration_ends`` of the winner's recorded merged run."""
    from repro_torch.core import ifs_placement, simulate_torch
    from repro_torch.core.multijob import (
        SEED_NS_CHAIN,
        derive_seed,
        joint_search,
        merged_batch_cost,
        per_job_iteration_ends,
        per_job_makespans,
        realize_merged,
    )

    jobs, cluster = _two_jobs()
    mj, res = joint_search(jobs, cluster, n_chains=TENANT_CHAINS, budget=TENANT_BUDGET,
                           seed=0, device=device)
    ps = [res.placement] + [
        ifs_placement(mj.workload, cluster, seed=derive_seed(0, SEED_NS_CHAIN, c))
        for c in range(TENANT_CHAINS)
    ]
    oes = merged_batch_cost(mj, None, cluster, seed=0, device=device)(ps)
    fifo = merged_batch_cost(mj, None, cluster, seed=0, policy="fifo", device=device)(ps)
    run = simulate_torch(mj.workload, cluster, res.placement, realize_merged(mj, seed=0),
                         record=True, device=device)
    spans = per_job_makespans(mj, run)
    ends = per_job_iteration_ends(mj, run)
    return {
        "exact": {"winner": res.placement.y.tolist(), "evaluations": res.evaluations,
                  "iterations": [len(e) for e in ends]},
        "close": {"best": [res.best_makespan],
                  "chain_best": [s["best_makespan"] for s in res.chain_stats],
                  "oes": oes, "fifo": fifo, "spans": spans,
                  "ends": np.concatenate(ends).tolist()},
        "line": (f"joint_search (ogbn-products 4/3x2/1 x 12 + reddit 4/2x2/1 x 8, "
                 f"J={mj.workload.J}, E={mj.workload.E}; {TENANT_CHAINS} chains, budget "
                 f"{TENANT_BUDGET}): best {res.best_makespan:.4f} s over "
                 f"{res.evaluations} evaluations; merged_batch_cost of the winner "
                 f"and {TENANT_CHAINS} chain starts oes {[round(x, 4) for x in oes]}, "
                 f"fifo {[round(x, 4) for x in fifo]}; per-job makespans "
                 f"{[round(x, 4) for x in spans]}"),
    }


def _arrival_jobs():
    """``examples/arrivals.py``'s two job shapes."""
    from repro_torch.core import build_gnn_workload

    def net_job():
        return build_gnn_workload(
            n_stores=2, n_workers=2, samplers_per_worker=2, n_ps=1, n_iters=4,
            store_to_sampler_gb=2.0, sampler_to_worker_gb=1.0, grad_gb=0.5,
            store_exec_s=0.2, sampler_exec_s=0.3, worker_exec_s=0.6,
            ps_exec_s=0.2, pmr=1.3,
        )

    def compute_job():
        return build_gnn_workload(
            n_stores=2, n_workers=1, samplers_per_worker=1, n_ps=1, n_iters=4,
            store_to_sampler_gb=0.2, sampler_to_worker_gb=0.1, grad_gb=0.05,
            store_exec_s=0.1, sampler_exec_s=0.2, worker_exec_s=2.0,
            ps_exec_s=0.1, pmr=1.2,
        )

    return net_job, compute_job


def _service_outcome(out):
    """An outcome's decisions (compared exactly) and times (at the
    engine's parity tolerance)."""
    rep = out.report
    done = [t for t in rep.tenants if t.admitted]
    return {
        "exact": {
            "events": [(e.kind, e.job, re.sub(r"-?\d+(\.\d+)?", "#", e.detail))
                       for e in out.events],
            "epochs": [(e.reason, e.jobs, sorted(e.served.items()), e.replanned)
                       for e in out.epochs],
            "tenants": [(t.name, t.admitted, t.n_defers, t.met) for t in rep.tenants],
        },
        "close": {
            "event_t": [e.t for e in out.events],
            "epoch_t": [x for e in out.epochs for x in (e.start_s, e.end_s, e.migration_gb)],
            "complete": [t.t_complete for t in done],
            "solo": [t.solo_makespan_s for t in rep.tenants],
        },
    }


def _unit_service_example(device):
    """``run_service`` with warm re-planning on ``examples/arrivals.py``'s
    four tenants (deadlines from solo runs on the CPU, so that the card
    and the CPU serve the same stream)."""
    from repro_torch.core import heterogeneous_cluster
    from repro_torch.dynamics import (
        JobArrival,
        ReplanConfig,
        ServiceConfig,
        run_service,
        solo_makespan,
    )

    net_job, compute_job = _arrival_jobs()
    cluster = heterogeneous_cluster(4, seed=3, gpu_range=(2, 4))
    hopeless = compute_job()
    solo = solo_makespan(hopeless, cluster, seed=0, index=3, device="cpu")
    stream = [
        JobArrival("fg", 0.0, net_job(), deadline_s=1e9, qos=0),
        JobArrival("bg", 0.5, net_job(), deadline_s=42.7, qos=1),
        JobArrival("doomed", 2.0, hopeless, deadline_s=2.0 + 0.5 * solo, qos=0),
        JobArrival("ride", 4.0, compute_job(), deadline_s=1e9, qos=1),
    ]
    rc = ReplanConfig(budget=SERVICE_REPLAN_BUDGET, sim_iters=SERVICE_REPLAN_ITERS,
                      shaping="strict", seed=0, device=device)
    out = run_service(stream, cluster, ServiceConfig(replan=True, replan_config=rc,
                                                     device=device), collect_traces=True)
    got = _service_outcome(out)
    shares = out.tenant_blame()
    total = sum(tr.makespan for tr, _, _ in out.traces)
    if len(out.traces) != len(out.epochs) or abs(sum(shares.values()) - total) > 1e-9 * total:
        raise AssertionError(f"tenant blame {shares} does not conserve the epochs' {total} s")
    got["exact"]["blame_tenants"] = sorted(shares)
    got["exact"]["trace_spans"] = [(len(tr.tasks), len(tr.flows)) for tr, _, _ in out.traces]
    got["close"]["tenant_blame"] = [shares[k] for k in sorted(shares)]
    rep = out.report
    got["line"] = (f"run_service, examples/arrivals.py's stream, replan=True (budget "
                   f"{SERVICE_REPLAN_BUDGET}, {SERVICE_REPLAN_ITERS} simulated "
                   f"iterations): {len(out.events)} events "
                   f"{[(e.kind, e.job) for e in out.events]}, {len(out.epochs)} epochs "
                   f"({sum(e.replanned for e in out.epochs)} re-planned), deadlines met "
                   f"{rep.deadlines_met}/{rep.n_jobs}, {rep.n_admitted} admitted, "
                   f"fairness {rep.fairness:.3f}; tenant blame over {len(out.traces)} "
                   f"traced epochs {({k: round(v, 3) for k, v in sorted(shares.items())})}")
    return got


def _unit_service_mixed(device):
    """``run_service`` on the tests' three-tenant mixed stream, and the
    EDF, SJF and RR exclusive orderings of it under oes and fifo."""
    from repro_torch.core import heterogeneous_cluster
    from repro_torch.dynamics import (
        ORDERINGS,
        JobArrival,
        ServiceConfig,
        run_ordering_baseline,
        run_service,
        solo_makespan,
    )

    _, compute_job = _arrival_jobs()
    cluster = heterogeneous_cluster(4, seed=3, gpu_range=(2, 4))
    stream = []
    for i, (t0, qos) in enumerate([(0.0, 0), (0.5, 1), (1.0, 1)]):
        job = compute_job()
        solo = solo_makespan(job, cluster, seed=0, index=i, device="cpu")
        stream.append(JobArrival(f"t{i}", t0, job, deadline_s=t0 + 1.6 * solo, qos=qos))
    out = run_service(stream, cluster, ServiceConfig(replan=False, device=device))
    got = _service_outcome(out)
    met = {"service": out.report.deadlines_met}
    for policy in ("oes", "fifo"):
        for order in ORDERINGS:
            rep = run_ordering_baseline(stream, cluster, order, policy=policy, device=device)
            met[f"{order}/{policy}"] = rep.deadlines_met
            got["close"][f"{order}/{policy}"] = [t.t_complete for t in rep.tenants]
    got["exact"]["met"] = sorted(met.items())
    got["line"] = (f"the mixed stream (three tenants): deadlines met of 3, service "
                   f"{met['service']}, " + ", ".join(
                       f"{k} {v}" for k, v in met.items() if k != "service"))
    return got


def _cache_sweep_inputs():
    from repro_torch.cache import collect_trace
    from repro_torch.core import build_gnn_workload, testbed_cluster
    from repro_torch.data.graph import synthetic_graph

    g = synthetic_graph(n_nodes=2000, avg_degree=12, n_feats=16, n_parts=4, seed=0)
    trace = collect_trace(g, n_samplers=8, seeds_per_iter=16, fanouts=(4, 4),
                          n_iters=12, seed=0)
    wl = build_gnn_workload(
        n_stores=4, n_workers=4, samplers_per_worker=2, n_ps=1, n_iters=10,
        store_to_sampler_gb=0.8, sampler_to_worker_gb=0.05, grad_gb=0.01,
        store_exec_s=0.02, sampler_exec_s=0.04, worker_exec_s=0.06, ps_exec_s=0.01,
        store_skew=[0.1, 0.1, 0.7, 0.1],
    )
    return trace, wl, testbed_cluster()


def _unit_cache_sweep(device):
    """``examples/cache_sweep.py``'s sections 2-4: the replay sweep, the
    cache-adjusted makespans, and cache-aware against cache-oblivious
    ETP judged under cache-adjusted traffic."""
    from repro_torch.cache import (
        CacheConfig,
        build_hit_model,
        cache_adjusted_realization,
        cache_aware_etp,
        cache_cost_fns,
        replay,
        samplers_per_machine,
        static_hit_rate_estimate,
    )
    from repro_torch.core import etp_multichain, ifs_placement, simulate_torch

    trace, wl, cluster = _cache_sweep_inputs()
    sweep = [[float(replay(trace, pol, cap, k=2).mean())
              for pol in ("static", "lru", "prefetch")] for cap in (100, 300, 600, 1200)]
    est = static_hit_rate_estimate(trace, 600)
    p0 = ifs_placement(wl, cluster, seed=0)
    r = wl.realize(seed=0)
    mks = [simulate_torch(wl, cluster, p0, r, device=device).makespan]
    for cap in (150, 600):
        adj = cache_adjusted_realization(
            wl, cluster, p0, r, build_hit_model(trace, policy="lru", capacity_nodes=cap))
        mks.append(simulate_torch(wl, cluster, p0, adj, device=device).makespan)
    model = build_hit_model(trace, policy="prefetch", capacity_nodes=150)
    cfg = CacheConfig(policy="prefetch", cache_gb=1.0)
    kw = dict(n_chains=CACHE_CHAINS, budget=CACHE_BUDGET, sim_iters=CACHE_SIM_ITERS,
              seed=0, device=device)
    oblivious = etp_multichain(wl, cluster, **kw)
    aware = cache_aware_etp(wl, cluster, model, cfg, sim_draws=1, **kw)
    _, judge, _ = cache_cost_fns(wl, cluster, model, sim_iters=CACHE_SIM_ITERS,
                                 sim_draws=3, seed=123, device=device)
    judged = judge([oblivious.placement, aware.placement])
    spm = [samplers_per_machine(wl, cluster, p).tolist()
           for p in (oblivious.placement, aware.placement)]
    return {
        "exact": {"sweep": sweep, "estimate": est, "oblivious": oblivious.placement.y.tolist(),
                  "aware": aware.placement.y.tolist()},
        "close": {"makespans": mks, "judged": judged,
                  "best": [oblivious.best_makespan, aware.best_makespan]},
        "line": (f"cache_sweep: mean hit rate (2 samplers a cache; static, lru, "
                 f"prefetch) at 100/300/600/1200 nodes "
                 f"{[[round(x, 3) for x in row] for row in sweep]}; makespan uncached "
                 f"{mks[0]:.3f} s, lru 150 nodes {mks[1]:.3f} s, lru 600 {mks[2]:.3f} s; "
                 f"ETP ({CACHE_CHAINS} chains, budget {CACHE_BUDGET}, {CACHE_SIM_ITERS} "
                 f"iterations) judged under cache-adjusted traffic: oblivious "
                 f"{judged[0]:.3f} s (samplers/machine {spm[0]}), aware {judged[1]:.3f} s "
                 f"({spm[1]})"),
    }


def _unit_cache_products(device):
    """The feature-cache tier on the ogbn-products testbed job of the
    replan phase (4 stores, 4 workers x 2 samplers, 1 PS): the profile's
    hit model from its proxy trace, ``cache_aware_etp``, the winner
    judged by ``cache_cost_fns`` under oes and fifo, and a cache-aware
    ``Replanner`` through ``on_leave(3)`` (its per-machine budgets
    shrink with the cluster)."""
    from repro_torch.cache import (
        CacheConfig,
        cache_aware_etp,
        cache_cost_fns,
        hit_model_for_profile,
        samplers_per_machine,
    )
    from repro_torch.core import (
        OGBN_PRODUCTS,
        build_workload_from_profile,
        ifs_placement,
        testbed_cluster,
    )
    from repro_torch.dynamics import ReplanConfig, Replanner

    wl = build_workload_from_profile(
        OGBN_PRODUCTS, n_stores=4, n_workers=4, samplers_per_worker=2, n_ps=1,
        n_iters=REPLAN_INTERVALS * REPLAN_ITERS,
    )
    cluster = testbed_cluster()
    model = hit_model_for_profile(OGBN_PRODUCTS, cache_gb=PRODUCTS_CACHE_GB,
                                  policy="lru", n_samplers=8)
    cfg = CacheConfig(policy="lru", cache_gb=[PRODUCTS_CACHE_GB] * cluster.M)
    aware = cache_aware_etp(wl, cluster, model, cfg, n_chains=PRODUCTS_CACHE_CHAINS,
                            budget=PRODUCTS_CACHE_BUDGET, sim_iters=PRODUCTS_CACHE_ITERS,
                            seed=0, device=device)
    p0 = ifs_placement(wl, cluster, seed=0)
    judged = {}
    for policy in ("oes", "fifo"):
        _, judge, _ = cache_cost_fns(wl, cluster, model, sim_iters=PRODUCTS_CACHE_ITERS,
                                     seed=123, policy=policy, device=device)
        judged[policy] = judge([p0, aware.placement])
    rp = Replanner(wl, cluster, aware.placement.copy(), config=ReplanConfig(
        budget=PRODUCTS_LEAVE_BUDGET, sim_iters=PRODUCTS_CACHE_ITERS,
        shaping="deadline", device=device), hit_model=model, cache_config=cfg)
    rec = rp.on_leave(3)
    budgets = np.asarray(rp.cache_config.cache_gb).tolist()
    if len(budgets) != cluster.M - 1:
        raise AssertionError(f"cache budgets did not shrink with the cluster: {budgets}")
    return {
        "exact": {"capacity": model.capacity_nodes, "aware": aware.placement.y.tolist(),
                  "leave_y": rp.placement.y.tolist(), "budgets": budgets,
                  "moved": rec.moved_tasks,
                  "flows": [(f.src, f.dst, f.task, f.cls) for f in rec.flows]},
        "close": {"best": [aware.best_makespan], "oes": judged["oes"],
                  "fifo": judged["fifo"],
                  "leave": [rec.makespan, rec.overlap_s, rec.objective, rec.forced_gb]},
        "line": (f"ogbn-products testbed job (J={wl.J}, E={wl.E}), {PRODUCTS_CACHE_GB} GB "
                 f"lru caches ({model.capacity_nodes} proxy nodes of "
                 f"{model.trace.n_nodes}): cache_aware_etp ({PRODUCTS_CACHE_CHAINS} "
                 f"chains, budget {PRODUCTS_CACHE_BUDGET}, {PRODUCTS_CACHE_ITERS} "
                 f"iterations) best {aware.best_makespan:.4f} s, samplers/machine "
                 f"{samplers_per_machine(wl, cluster, aware.placement).tolist()}; judged "
                 f"(IFS, aware) oes {[round(x, 4) for x in judged['oes']]}, fifo "
                 f"{[round(x, 4) for x in judged['fifo']]}; on_leave(3) under deadline "
                 f"shaping (budget {PRODUCTS_LEAVE_BUDGET}): makespan {rec.makespan:.4f} s, "
                 f"overlap {rec.overlap_s:.4f} s, {len(rec.flows)} flows, cache budgets "
                 f"{budgets} GB"),
    }


# the obs phase (schedule traces and blame, failure handling with a
# checkpoint, the infeed planner, the slotted oracle): each unit runs on
# the card and on the CPU in a worker process meanwhile, as the tenants
# phase does.  Its depth: the search budgets and simulated iterations
# below, cut from the reference's defaults (the failure re-plan's 300
# and 12, the infeed plan's 150) to keep the phase within its seconds.
FAILURE_BUDGET, FAILURE_SIM_ITERS = 2, 4
INFEED_BUDGET, INFEED_CHAINS = 4, 8
TRACE_ITERS = 20  # the products job's first 20 of its 40 iterations, traced
SLOTTED_SLOTS = ((0.25, 0.35), (0.05, 0.1))  # (slot, tests/test_oes.py's bound)


def _blame_numbers(rep):
    """A blame report's chain (compared exactly) and numbers (at the
    engine's parity tolerance)."""
    from repro_torch.obs.trace import TaskSpan

    chain = [("task", s.task, s.iter) if isinstance(s, TaskSpan) else
             ("flow", s.edge, s.iter) for s in rep.path]
    machines = sorted(rep.per_machine_contention)
    return ({"chain": chain, "machines": machines},
            [rep.makespan, *rep.components.values(),
             *(rep.per_machine_contention[m] for m in machines)])


def _unit_trace_products(device):
    """The products testbed job (IFS placement and realization, seed 0;
    its first ``TRACE_ITERS`` iterations) recorded under oes (DGTP's policy) and fifo (DistDGL's: waterfill's
    rates), ``utilization=True`` in the same run: ``ScheduleTrace``,
    ``blame`` and ``write_trace`` of each, the file validated as read
    back; blame conserves the makespan, each NIC's utilization integral
    equals its delivered GB, and the trace's per-NIC integrals equal the
    engine's own aggregates of the run."""
    import tempfile

    from repro_torch.core import ifs_placement, simulate_torch
    from repro_torch.obs.blame import blame
    from repro_torch.obs.perfetto import validate_trace_events, write_trace
    from repro_torch.obs.trace import ScheduleTrace

    _, wl, cluster = _jobs()[1]
    p = ifs_placement(wl, cluster, seed=0)
    r = wl.realize(seed=0).window(0, TRACE_ITERS)
    exact, close, lines = {}, {}, []
    for policy in ("oes", "fifo"):
        res = simulate_torch(wl, cluster, p, r, policy=policy, record=True,
                             utilization=True, device=device)
        tr = ScheduleTrace.from_result(res, wl, cluster, p, r)
        rep = blame(tr)
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "trace.json"
            write_trace(tr, path)
            counts = validate_trace_events(json.loads(path.read_text()))
        if abs(rep.residual) >= 1e-6 * max(1.0, tr.makespan):
            raise AssertionError(f"{policy}: blame residual {rep.residual}")
        agg, mine = res.aggregates, tr.aggregates()
        for m in range(tr.M):
            for direction in ("in", "out"):
                got = tr.utilization_integral(m, direction)
                want = tr.delivered_gb(m, direction)
                if not np.isclose(got, want, rtol=1e-9, atol=1e-9):
                    raise AssertionError(f"{policy} machine {m} {direction}: "
                                         f"integral {got} != delivered {want}")
        for k in ("nic_in_gb", "nic_out_gb"):
            if not np.allclose(agg[k], mine[k], rtol=1e-9, atol=1e-9):
                raise AssertionError(f"{policy} {k}: engine {agg[k]} != trace {mine[k]}")
        ex, nums = _blame_numbers(rep)
        exact[policy] = {**ex, "counts": counts, "spans": (len(tr.tasks), len(tr.flows))}
        close[policy] = nums + agg["nic_in_gb"].tolist() + agg["nic_out_gb"].tolist()
        lines.append(rep.table(f"{policy} ({'DGTP' if policy == 'oes' else 'DistDGL'}"
                               f"'s policy), {len(tr.tasks)} task and {len(tr.flows)} "
                               f"flow spans, {len(rep.path)} on the critical path"))
    return {
        "exact": exact, "close": close,
        "line": (f"traces of the products testbed job (J={wl.J}, E={wl.E}, its first "
                 f"{r.n_iters} of {wl.n_iters} iterations, IFS placement): blame conserves each makespan, NIC integrals equal "
                 f"delivered GB and the engine's utilization aggregates, trace.json "
                 f"validated\n" + "\n".join(lines)),
    }


def _unit_failure(device):
    """``examples/replan_failure.py``'s job (6 machines) through
    ``FailureController``: a small GraphSAGE's state checkpointed from
    ``device`` and restored onto it bit for bit, then machine 2 fails and
    ``on_failure`` re-plans on the survivors."""
    import tempfile

    import torch

    from repro_torch.core import (
        OGBN_PRODUCTS,
        build_workload_from_profile,
        heterogeneous_cluster,
        ifs_placement,
    )
    from repro_torch.models.gnn import GraphSAGE, GraphSAGEConfig
    from repro_torch.train import FailureController, save_checkpoint

    wl = build_workload_from_profile(OGBN_PRODUCTS, n_stores=4, n_workers=6,
                                     samplers_per_worker=2, n_ps=1, n_iters=30)
    cluster = heterogeneous_cluster(6, seed=7)
    placement = ifs_placement(wl, cluster, seed=0)
    model = GraphSAGE(GraphSAGEConfig(in_dim=100, hidden=256, n_classes=47, n_layers=3),
                      device=device, seed=0)
    state = {"model": model.state_dict(),
             "bf16": {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()},
             "step": torch.tensor(17, device=device)}
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, state, step=17)
        fc = FailureController(wl, cluster, placement, ckpt_dir=d,
                               replan_budget=FAILURE_BUDGET, device=device)
        like = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                    if isinstance(v, dict) else torch.zeros_like(v))
                for k, v in state.items()}
        back, step = fc.restore(like)
    for k, v in state.items():
        for n, t in (v.items() if isinstance(v, dict) else [("", v)]):
            b = back[k][n] if n else back[k]
            if step != 17 or b.device != t.device or b.dtype != t.dtype or not torch.equal(b, t):
                raise AssertionError(f"checkpoint leaf {k}/{n} did not come back bit for bit")
    rp = fc.replanner(0)
    rp.config = dataclasses.replace(rp.config, sim_iters=FAILURE_SIM_ITERS)
    new_cluster, new_p, res = fc.on_failure(machine=2, seed=0)
    rec = fc.last_record
    n_leaves = sum(len(v) if isinstance(v, dict) else 1 for v in state.values())
    return {
        "exact": {"cluster": [(m.name, m.bw_in, m.bw_out) for m in new_cluster.machines],
                  "placement": new_p.y.tolist(), "evaluations": res.evaluations,
                  "moved": rec.moved_tasks,
                  "flows": [(f.src, f.dst, f.task, f.cls) for f in rec.flows]},
        "close": {"mk": [res.best_makespan, rec.makespan, rec.objective, rec.overlap_s,
                         rec.forced_gb]},
        "line": (f"checkpoint of a GraphSAGE state (ogbn-products widths, {n_leaves} "
                 f"leaves, fp32 and bf16) restored bit for bit; machine 2 of 6 failed -> "
                 f"re-planned on {new_cluster.M} machines (budget {FAILURE_BUDGET}, "
                 f"{FAILURE_SIM_ITERS} simulated iterations): {res.evaluations} "
                 f"evaluations, makespan {rec.makespan:.4f} s, {len(rec.flows)} restore "
                 f"flows ({rec.forced_gb:.2f} GB forced, {rec.moved_tasks} moved), "
                 f"overlap {rec.overlap_s:.4f} s"),
    }


def _unit_infeed(device):
    """``plan_infeed`` on ``tests/test_system.py``'s spec (internlm2-1.8b,
    global batch 256, sequence 4096, 2 pods, parameter-server sync)."""
    from repro_torch.configs import get_config
    from repro_torch.core.infeed_planner import LMJobSpec, plan_infeed

    spec = LMJobSpec(cfg=get_config(LM_ARCH), global_batch=256, seq_len=4096, n_pods=2,
                     sync="ps")
    ip = plan_infeed(spec, budget=INFEED_BUDGET, seed=0, n_chains=INFEED_CHAINS,
                     device=device)
    s = ip.summary()
    return {
        "exact": {"placement": ip.plan.placement.y.tolist(),
                  "shards": sorted(ip.shard_of_loader.items()), "delta": s["delta"]},
        "close": {"summary": [s["makespan_s"], s["inter_host_gb"], s["locality"]]},
        "line": (f"plan_infeed ({LM_ARCH}, {spec.cfg.active_param_count()} active "
                 f"parameters, batch 256 x 4096, 2 pods, ps; {INFEED_CHAINS} chains, "
                 f"budget {INFEED_BUDGET}): makespan {s['makespan_s']:.4f} s over "
                 f"{spec.steps_per_plan} steps, inter-host {s['inter_host_gb']:.2f} GB, "
                 f"loader shards {ip.shard_of_loader}"),
    }


def _unit_slotted(device):
    """``tests/test_oes.py``'s tiny job: the engine's ``oes_strict``
    makespan against the slotted Alg. 1 oracle (on the host) at two slot
    widths, within that test's bounds."""
    from repro_torch.core import (
        build_gnn_workload,
        heterogeneous_cluster,
        ifs_placement,
        simulate_slotted,
        simulate_torch,
    )

    wl = build_gnn_workload(
        n_stores=2, n_workers=2, samplers_per_worker=1, n_ps=1, n_iters=4,
        store_to_sampler_gb=1.0, sampler_to_worker_gb=1.0, grad_gb=0.1,
        store_exec_s=0.5, sampler_exec_s=0.5, worker_exec_s=1.0, ps_exec_s=0.25,
        pmr=1.0,
    )
    cluster = heterogeneous_cluster(3, seed=4)
    p = ifs_placement(wl, cluster, seed=0)
    r = wl.realize(seed=2)
    ev = simulate_torch(wl, cluster, p, r, policy="oes_strict", device=device).makespan
    slotted = []
    for slot, tol in SLOTTED_SLOTS:
        sl = simulate_slotted(wl, cluster, p, r, slot=slot)
        if abs(sl.makespan * slot - ev) > tol * ev:
            raise AssertionError(f"slot {slot}: slotted {sl.makespan * slot} vs engine "
                                 f"{ev}, past {tol}")
        slotted.append((sl.makespan, sorted(sl.task_start.items())))
    return {
        "exact": {"slotted": slotted}, "close": {"engine": [ev]},
        "line": (f"oes_strict on tests/test_oes.py's tiny job: engine {ev:.4f} s, slotted "
                 + ", ".join(f"{m * s:.4f} s at slot {s}"
                             for (m, _), (s, _) in zip(slotted, SLOTTED_SLOTS))),
    }


OBS_UNITS = {"trace_products": _unit_trace_products, "failure": _unit_failure,
             "infeed": _unit_infeed, "slotted": _unit_slotted}


TENANT_UNITS = {"joint": _unit_joint, "service_example": _unit_service_example,
                "service_mixed": _unit_service_mixed}
CACHE_UNITS = {"cache_sweep": _unit_cache_sweep, "cache_products": _unit_cache_products}


def _cpu_unit(name):
    """Worker process: one unit on the CPU."""
    import torch

    torch.set_num_threads(1)
    return {**TENANT_UNITS, **CACHE_UNITS, **OBS_UNITS}[name]("cpu")


def _check_unit(name, gpu, cpu):
    """Decisions and placements exactly, times at the engine's parity
    tolerance."""
    from repro_torch.core import PARITY_ATOL, PARITY_RTOL

    if gpu["exact"] != cpu["exact"]:
        diff = [k for k in gpu["exact"] if gpu["exact"][k] != cpu["exact"].get(k)]
        raise AssertionError(f"{name}: the card and the CPU decide differently: {diff}")
    worst = 0.0
    for k, v in gpu["close"].items():
        a, b = np.asarray(v, dtype=np.float64), np.asarray(cpu["close"][k], dtype=np.float64)
        if a.shape != b.shape or not np.allclose(a, b, rtol=PARITY_RTOL, atol=PARITY_ATOL):
            raise AssertionError(f"{name}: {k} differs: {v} (cuda) vs {cpu['close'][k]} (cpu)")
        fin = np.isfinite(a)
        if fin.any():
            worst = max(worst, float(np.max(np.abs(a[fin] - b[fin]))))
    return worst


def phase_tenants_cache(wf, t, units, tag):
    """One path: the given units on the card (waterfill's count set to 0
    just before, read just after), their CPU runs in worker processes
    meanwhile, then the comparison."""
    with ProcessPoolExecutor(min(len(units), CPU_WORKERS), mp_context=get_context("spawn"),
                             initializer=_low_priority) as pool:
        pending = {name: pool.submit(_cpu_unit, name) for name in units}
        wf.waterfill_fill.launches = 0
        gpu = {}
        for name, fn in units.items():
            t0 = time.perf_counter()
            gpu[name] = fn("cuda")
            line = gpu[name]["line"].replace("\n", f"\n[{tag}] ")
            print(f"[{tag}] {line}\n[{tag}] {name}: wall {time.perf_counter() - t0:.1f} s",
                  flush=True)
        launches = wf.waterfill_fill.launches
        t = _phase_done(f"{tag} on the card ({', '.join(units)})", t)
        for name in units:
            err = _check_unit(name, gpu[name], pending[name].result())
            print(f"[{tag}] {name}: the card equals the CPU (decisions and placements "
                  f"exactly; largest time gap {err:.3g} s)", flush=True)
        t = _phase_done(f"waiting for the {tag} phase's CPU runs", t)
    if launches == 0:
        raise AssertionError(f"the {tag} path never launched the waterfill kernel")
    print(f"[{tag}] waterfill launches on the {tag} path: {launches}", flush=True)
    return launches, t


# ------------------------------------------------------------ LM training
# lm_train: internlm2-1.8b at full width (bf16, all 24 layers), batch 4 x
# 2048 tokens, the first LM_TRAIN_STEPS AdamW steps of a run of
# LM_TRAIN_TOTAL (so the cosine decay has not begun), over the
# TokenPipeline stream's first LM_TRAIN_CYCLE batches in turn: on fresh
# batches the loss moves less than its noise in so few steps (the
# stream's successors are uniform over the vocabulary), on revisited ones
# it falls as the model learns them
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_TOTAL = 4, 2048, 8, 1000
LM_TRAIN_CYCLE = 2
LM_TRAIN_LAYERS = None  # all 24
LM_TRAIN_LR, LM_TRAIN_WARMUP = 1e-3, 2
# the backward kernels' checks: (label, (B, H, KV, S, D), kwargs, dtype);
# the first is the training path's shape, timed with the others in bf16
BWD_CHECKS = [
    ("internlm2", (4, 16, 8, 2048, 128), dict(causal=True), "bfloat16"),
    ("small fp32", (2, 4, 2, 256, 64), dict(causal=True), "float32"),
    ("gemma2 window + softcap", (1, 32, 16, 2048, 128),
     dict(causal=True, window=1024, softcap=50.0, scale=144 ** -0.5), "bfloat16"),
    ("hubert non-causal", (4, 16, 16, 1500, 80), dict(causal=False), "bfloat16"),
    ("zamba2 hd112", (2, 32, 32, 2048, 112), dict(causal=True), "bfloat16"),
]
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of the largest gradient
# the narrow config of the card-vs-CPU and resume checks: internlm2's
# pattern at head dim 64 (the backward kernel's least), 2 layers
LM_TRAIN_NARROW = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                       vocab=1000)
LM_TRAIN_FP32_ATOL = 1e-4
# the fp32 check's learning rate: Adam moves a weight by up to ~lr whatever
# its gradient's size, so a gradient of ~1e-9 whose sign the card's sums
# and the CPU's give differently moves it by up to 2 lr
LM_TRAIN_FP32_LR = 3e-5
LM_TRAIN_BF16_RTOL = 2e-2  # kernel vs plain attention: gradients, of the largest


def _bwd_qkv(seed, B, H, KV, S, D, dtype):
    """q, k, v (needing gradients) as views of [B, S, N, D] tensors, and an
    output gradient, on the card."""
    import torch

    q, k, v = _flash_qkv(seed, B, H, KV, S, S, D, dtype)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(B, H, S, D, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _sdpa_backward(q, k, v, do, kw):
    """A call computing the backward of ``F.scaled_dot_product_attention``
    (GQA) at the same function, its forward run once beforehand, or None
    where it computes another function (a tanh softcap)."""
    import torch

    ins = tuple(t.detach().requires_grad_(True) for t in (q, k, v))
    sd = _sdpa(*ins, kw)
    if sd is None:
        return None
    out = sd()
    return lambda: torch.autograd.grad(out, ins, do, retain_graph=True)


def _bwd_route_moved(tag, wrapper, before, route, n):
    """Fail unless ``wrapper``'s backward launches by route moved from
    ``before`` by exactly ``n`` on ``route`` (and nowhere else)."""
    moved = {r: c - before[r] for r, c in wrapper.backward_launches_by_route.items()}
    _expect_routes(tag, {"backward": moved}, {"backward": {route: n}})


def phase_flash_backward(fa):
    """The backward kernels against autograd through the plain version at
    BWD_CHECKS (each giving the same bits on two runs, bf16 on the wgmma
    route and fp32 on the FMA one), and their times in bf16 (L2 flushed)
    beside the bound, the plain backward's and SDPA's; at the training
    shape also one call's device time by kernel (delta, dK/dV, dQ:
    ``_kernel_split``, since one C call launches all three).  Returns the
    training shape's numbers as the flash record's bwd_*."""
    import torch

    worst, out = 0.0, {}
    for seed, (label, (B, H, KV, S, D), kw, dtype) in enumerate(BWD_CHECKS):
        q, k, v, do = _bwd_qkv(seed, B, H, KV, S, D, getattr(torch, dtype))
        ins = (q, k, v)
        before = fa.flash_attention.backward_launches
        by_route = dict(fa.flash_attention.backward_launches_by_route)
        kernel = lambda: torch.autograd.grad(o_k, ins, do, retain_graph=True)
        o_k = fa.flash_attention(q, k, v, **kw)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if fa.flash_attention.backward_launches != before + 2:
            raise AssertionError(f"flash backward at {label}: the kernel did not launch")
        _bwd_route_moved(f"flash backward {label}", fa.flash_attention, by_route,
                         fa.backward_route(q.dtype), 2)
        o_p = fa.flash_attention_plain(q, k, v, **kw)
        plain = lambda: torch.autograd.grad(o_p, ins, do, retain_graph=True)
        want = plain()
        errs = []
        for name, g, g2, w in zip("qkv", got, again, want):
            if not torch.equal(g, g2):
                raise AssertionError(f"flash backward at {label}: two runs differ in d{name}")
            rel = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
            if not rel <= BWD_TOL[dtype]:
                raise AssertionError(f"flash backward != plain autograd at {label} {dtype}: "
                                     f"d{name} off by {rel:.3g} of its largest (tol "
                                     f"{BWD_TOL[dtype]})")
            errs.append(rel)
            if dtype == "float32":
                worst = max(worst, (g - w).abs().max().item())
        del got, again, want
        line = (f"[flash backward] {label}: q {(B, H, S, D)} over {KV} KV heads, {kw}, "
                f"{dtype}: dq, dk, dv off by {errs[0]:.3g}, {errs[1]:.3g}, {errs[2]:.3g} of "
                f"their largest; two runs give the same bits")
        if dtype != "bfloat16":
            print(line, flush=True)
            continue
        ms = _device_ms(kernel, 3, flush=True)
        parts = _kernel_split(f"flash backward {label}", kernel) if not out else None
        plain_ms = _device_ms(plain, 1, flush=True)
        lib = _sdpa_backward(q, k, v, do, kw)
        lib_ms = _device_ms(lib, 3, flush=True) if lib is not None else None
        del o_k, o_p
        bound, by = _bound(*fa.backward_cost(q, k, kw.get("causal", True), kw.get("window")),
                           2)
        print(f"{line}; device time per backward, L2 flushed: kernels {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA's backward "
              f"{'none (no PyTorch call computes a tanh softcap)' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"; bound {bound:.6f} ms by {by} ({100 * bound / ms:.1f}% of the kernels' "
              f"time)", flush=True)
        if not out:
            out = {"bwd_ms": ms, "bwd_plain_ms": plain_ms, "bwd_bound_ms": bound,
                   "bwd_bound_by": by, "bwd_library_ms": lib_ms,
                   "bwd_source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "bwd_split_ms": parts}
        del q, k, v, do
        _free()
    out["bwd_max_abs_err"] = worst
    return out


def _narrow_cfg(dtype):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_ARCH), name="internlm2-narrow", dtype=dtype,
                               **LM_TRAIN_NARROW)


def _builder(cfg, device, seed=2, lr=LM_TRAIN_LR):
    import torch

    from repro_torch.models import TransformerLM
    from repro_torch.train import AdamWSettings, TrainStepBuilder

    model = TransformerLM(cfg, device=device)
    b = TrainStepBuilder(model, AdamWSettings(lr=lr, warmup_steps=1,
                                              total_steps=LM_TRAIN_STEPS))
    return b, b.init_state(torch.Generator(device=device).manual_seed(seed))


def _pipe_batch(pipe, step, device):
    import torch

    return {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}


def _train_card_vs_cpu(cfg=None, tag="lm train", seq=256, scan64=False):
    """Two fp32 train steps of a narrow config (internlm2's by default) on
    the card (the kernels) against the same on the CPU (the plain
    versions; the schedule's first step has lr 0), over batches of 2 x
    ``seq`` tokens: the first step's gradients within LM_TRAIN_FP32_ATOL
    of each leaf's largest, losses, grad norms and the updated weights
    within LM_TRAIN_FP32_ATOL.  With ``scan64`` (the SSM configs) the CPU
    reference runs its scan in fp64 (``_cpu_scan_fp64``)."""
    from repro_torch.convert import lm_to_reference
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.optimizer import tree_items
    from repro_torch.train.train_loop import stacked_weights

    cfg = cfg if cfg is not None else _narrow_cfg("float32")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=2, seed=3)
    b_gpu, s_gpu = _builder(cfg, "cuda", lr=LM_TRAIN_FP32_LR)
    b_cpu, _ = _builder(cfg, "cpu", lr=LM_TRAIN_FP32_LR)
    b_cpu.model.load_state_dict(b_gpu.model.state_dict())
    s_cpu = b_cpu.init_state()
    reference = _cpu_scan_fp64 if scan64 else contextlib.nullcontext

    def grads(b, dev):
        b.model.zero_grad(set_to_none=True)
        b.model.loss_fn(_pipe_batch(pipe, 0, dev))[0].backward()
        return dict(tree_items(lm_to_reference(b.model, grads=True)))

    def rel(a, w):
        return float(np.abs(a - w).max()) / max(float(np.abs(w).max()), 1e-30)

    with reference():
        g_cpu = grads(b_cpu, "cpu")
    worst_rel = max(rel(g, g_cpu[path]) for path, g in grads(b_gpu, "cuda").items())
    worst = 0.0
    with reference():
        for i in range(2):
            s_gpu, m_gpu = b_gpu.train_step(s_gpu, _pipe_batch(pipe, i, "cuda"))
            s_cpu, m_cpu = b_cpu.train_step(s_cpu, _pipe_batch(pipe, i, "cpu"))
            worst = max([worst] + [abs(m_gpu[n].item() - m_cpu[n].item())
                                   for n in ("loss", "grad_norm")])
    want = dict(tree_items(stacked_weights(s_cpu.params)))
    for path, t in tree_items(stacked_weights(s_gpu.params)):
        worst = max(worst, (t.cpu() - want[path]).abs().max().item())
    print(f"[{tag}] fp32 narrow {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), "
          f"2 x {seq} tokens, card (kernels) vs cpu (plain"
          f"{', its scan in fp64' if scan64 else ''}): gradients within "
          f"{worst_rel:.3g} of each leaf's largest; two steps at lr {LM_TRAIN_FP32_LR}: "
          f"losses, grad norms and weights within {worst:.3g} (tol {LM_TRAIN_FP32_ATOL})",
          flush=True)
    if not max(worst, worst_rel) <= LM_TRAIN_FP32_ATOL:
        raise AssertionError(f"{tag}: the card's fp32 steps disagree with the CPU's")
    del b_gpu, s_gpu, b_cpu, s_cpu
    _free()


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` for the block's
    duration.  cuBLAS is deterministic on one stream; torch asks for
    ``CUBLAS_WORKSPACE_CONFIG`` before it allows its products in
    deterministic mode."""
    import torch

    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved


def _train_resume_bitwise():
    """With ``torch.use_deterministic_algorithms(True)``, the narrow config
    in bf16: train 2, save, restore into other weights, train 2 equals a
    direct 4-step run bit for bit."""
    import tempfile

    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import latest_checkpoint, restore_state, save_state
    from repro_torch.train.optimizer import tree_items
    from repro_torch.train.train_loop import stacked_weights

    cfg = _narrow_cfg("bfloat16")
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=256, global_batch=2, seed=4)
    with _deterministic():
        b, s = _builder(cfg, "cuda")
        for i in range(4):
            s, _ = b.train_step(s, _pipe_batch(pipe, i, "cuda"))
        direct = {p: t.clone() for p, t in tree_items(stacked_weights(s.params))}
        b, s = _builder(cfg, "cuda")
        for i in range(2):
            s, _ = b.train_step(s, _pipe_batch(pipe, i, "cuda"))
        with tempfile.TemporaryDirectory() as d:
            save_state(d, s)
            b, s = _builder(cfg, "cuda", seed=9)
            s = restore_state(latest_checkpoint(d), s)
        for i in range(2, 4):
            s, _ = b.train_step(s, _pipe_batch(pipe, i, "cuda"))
        torch.cuda.synchronize()
    diff = [p for p, t in tree_items(stacked_weights(s.params)) if not torch.equal(t, direct[p])]
    if diff:
        raise AssertionError(f"lm train: the resumed run differs from the direct one at {diff}")
    print("[lm train] deterministic algorithms on, narrow config in bf16: train 2, save, "
          "restore, train 2 equals 4 direct steps bit for bit", flush=True)


def _train_grads_vs_plain(fa):
    """One step's bf16 gradients of internlm2 at full width and 2 layers
    through the flash kernels against the same with the plain attention:
    every leaf within LM_TRAIN_BF16_RTOL of its largest gradient."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_to_reference
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import TransformerLM

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2)
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(5))
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, global_batch=2, seed=5)
    batch = _pipe_batch(pipe, 0, "cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        model.loss_fn(batch)[0].backward()
        return lm_to_reference(model, grads=True)

    before = fa.flash_attention.backward_launches
    got = grads()
    if fa.flash_attention.backward_launches != before + cfg.n_layers:
        raise AssertionError("lm train: the kernel path did not run the backward kernel")
    with _plain("flash"):
        want = grads()
    worst = 0.0

    def walk(a, b, path=()):
        nonlocal worst
        if isinstance(b, dict):
            for key in b:
                walk(a[key], b[key], path + (key,))
            return
        scale = max(float(np.abs(b).max()), 1e-30)
        rel = float(np.abs(a - b).max()) / scale
        worst = max(worst, rel)
        if not rel <= LM_TRAIN_BF16_RTOL:
            raise AssertionError(f"lm train: gradient {'/'.join(path)} through the kernels "
                                 f"off the plain attention's by {rel:.3g} of its largest")

    walk(got, want)
    print(f"[lm train] one bf16 step at full width, 2 layers: every gradient leaf through "
          f"the flash kernels within {worst:.3g} of its largest of the plain attention's "
          f"(tol {LM_TRAIN_BF16_RTOL})", flush=True)
    model.zero_grad(set_to_none=True)
    del model
    _free()


def phase_lm_train(fa):
    """LM training on the card: the backward kernels' checks and times;
    then the main path, internlm2-1.8b at full width training on
    TokenPipeline batches through TrainStepBuilder (the counts set to 0
    just before the steps and read just after: the forward twice a layer
    and the backward once a layer each step); then the parity checks (fp32 card vs CPU, bitwise resume, bf16 gradients
    against the plain attention's).  Returns the flash record's bwd_*
    numbers and the path's forward launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import TransformerLM
    from repro_torch.train import AdamWSettings, TrainStepBuilder

    t = time.perf_counter()
    nums = phase_flash_backward(fa)
    t = _phase_done("flash backward checks and times", t)

    cfg = get_config(LM_ARCH)
    if LM_TRAIN_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=LM_TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    builder = TrainStepBuilder(model, AdamWSettings(lr=LM_TRAIN_LR,
                                                    warmup_steps=LM_TRAIN_WARMUP,
                                                    total_steps=LM_TRAIN_TOTAL))
    state = builder.init_state()
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ,
                         global_batch=LM_TRAIN_BATCH, seed=0)
    batches = [_pipe_batch(pipe, i, "cuda") for i in range(LM_TRAIN_CYCLE)]
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    fa.flash_attention.launches = 0
    fa.flash_attention.backward_launches = 0
    fa.flash_attention.backward_launches_by_route = dict.fromkeys(fa.BWD_ROUTES, 0)
    losses, norms, walls = [], [], []
    for i in range(LM_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, met = builder.train_step(state, batches[i % LM_TRAIN_CYCLE])
        losses.append(met["loss"].item())  # waits for the step
        norms.append(met["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention.backward_launches
    if not (fwd == 2 * cfg.n_layers * LM_TRAIN_STEPS and bwd == cfg.n_layers * LM_TRAIN_STEPS):
        raise AssertionError(f"lm train: flash launched {fwd} forwards and {bwd} backwards "
                             f"over {LM_TRAIN_STEPS} steps of {cfg.n_layers} layers")
    _expect_routes("lm train backward",
                   {"flash_attention": dict(fa.flash_attention.backward_launches_by_route)},
                   {"flash_attention": {fa.backward_route(torch.bfloat16): bwd}})
    if not all(math.isfinite(x) for x in losses + norms) or not losses[-1] < losses[0]:
        raise AssertionError(f"lm train: losses {losses}, grad norms {norms}")
    step_ms = 1e3 * float(np.median(walls[1:]))
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"[lm train] {cfg.name} ({cfg.n_layers} layers, full width, bf16), batch "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, the stream's first {LM_TRAIN_CYCLE} batches "
          f"in turn: losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
          + ", ".join(f"{x:.3f}" for x in norms) + f"; step walls "
          + ", ".join(f"{1e3 * w:.1f}" for w in walls) + f" ms (median after the first "
          f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s); flash launches a "
          f"step: {fwd // LM_TRAIN_STEPS} forward ({cfg.n_layers} and {cfg.n_layers} "
          f"rematerialised), {bwd // LM_TRAIN_STEPS} backward; peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    del builder, state, model, batches
    _free()
    t = _phase_done("lm train (internlm2-1.8b at full width: steps)", t)
    _train_card_vs_cpu()
    _train_resume_bitwise()
    _train_grads_vs_plain(fa)
    _phase_done("lm train parity (fp32 card vs cpu, bitwise resume, bf16 kernel vs "
                "plain gradients)", t)
    nums["bwd_launches"] = bwd
    return nums, fwd


# moe_train and mamba_train: the grouped GEMM's and the SSD scan's backward
# kernels, then llama4-scout and mamba2-1.3b training at full width.
# llama4-scout at 1 of its 48 layers: one layer's 16 experts (2.01 B
# parameters) and its untied 202048-row embedding and head (2.07 B) are
# ~4.15 B parameters, ~42 GB with bf16 first moments and a factored second
# moment (the reference's --opt8); 8 layers would be ~300 GB of weights
# and optimizer state.  Its batch is cut from 4 to 2 sequences for the
# fp32 logits over 202048 columns.  mamba2-1.3b at all 48 layers.  Each
# phase takes TRAIN_STEPS steps over the TokenPipeline stream's first
# LM_TRAIN_CYCLE batches in turn, as lm_train does.
MOE_TRAIN_LAYERS = 1
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 2048
MAMBA_TRAIN_LAYERS = None  # all 48
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ = 4, 2048
TRAIN_STEPS = 4
# the narrow configs of the fp32 card-vs-CPU checks: full patterns at head
# dim 64 (the attention backward's least), 2 layers (zamba2: 7, one shared
# block application and a trailing layer), mamba2 and zamba2 over 2 chunks
MOE_TRAIN_NARROW = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                        vocab=1000)
MAMBA_TRAIN_NARROW = dict(n_layers=2, d_model=256, vocab=1000)
ZAMBA_TRAIN_NARROW = dict(n_layers=7, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
                          vocab=1000)


def _grouped_mm_backward(x, w, gs, dy):
    """The backward of ``torch._grouped_mm`` on the same inputs (autograd
    through one call), the yardstick (the port never calls it): a
    callable and a note, or None and the reason."""
    import torch

    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    reason = ""
    for label, wl in (("w as stored", w),
                      ("w column-major", w.transpose(1, 2).contiguous().transpose(1, 2))):
        xa, wa = x.detach().requires_grad_(True), wl.detach().requires_grad_(True)
        try:
            out = torch._grouped_mm(xa, wa, offs=offs)
            fn = lambda out=out, xa=xa, wa=wa: torch.autograd.grad(out, (xa, wa), dy,
                                                                  retain_graph=True)
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, TypeError, ValueError, NotImplementedError) as err:
            reason = f"torch._grouped_mm's backward refused ({label}): {str(err).splitlines()[0]}"
            continue
        return fn, label
    return None, reason


# calls of a backward traced together for its split by kernel
SPLIT_CALLS = 32


def _kernel_split(tag, fn):
    """``fn``'s device time per call by kernel (L2 warm): after a warm-up
    call, SPLIT_CALLS calls in one trace (``_traced``), each kernel's
    device time over its launches divided by SPLIT_CALLS; printed,
    largest first.  Returns ``{name: ms}``."""
    fn()
    _, rows = _traced(lambda: [fn() for _ in range(SPLIT_CALLS)])
    split = {re.sub(r"\(anonymous namespace\)::", "", a.key).split("(")[0][:48]:
             _device_us(a) / SPLIT_CALLS / 1e3 for a in rows}
    split = dict(sorted(split.items(), key=lambda kv: kv[1], reverse=True))
    print(f"[{tag}] one call's device time by kernel (profiler, L2 warm): "
          + (", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
             or "no device rows"),
          flush=True)
    return split


def phase_moe_backward(mg):
    """The grouped GEMM's backward kernels (through autograd) against the
    plain backward at llama4-scout's training shapes (gate/up and down at
    T = MOE_TRAIN_BATCH x MOE_TRAIN_SEQ routed rows, uniform and skewed
    routing: one expert holding most rows, two empty, rows past the sum)
    in bf16 and a small fp32 case: each gradient within BWD_TOL of its
    largest, the same bits on two runs, bf16 on the wgmma route and fp32
    on the FMA one; the gate/up backward timed beside its bound, the plain
    backward and ``torch._grouped_mm``'s backward, and dx and dw each
    launched alone, timed as the backward is.  Returns the moe_gemm
    record's bwd_* numbers."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    D, Fe, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    T = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ * cfg.moe.top_k
    routed = _routed(20, T, E)
    skewed = [T - 196 - 13 * 40, 0, 0] + [40] * 13  # 196 rows past the sum
    checks = [("gate/up", (T, D, Fe, E), routed, "bfloat16"),
              ("down", (T, Fe, D, E), routed, "bfloat16"),
              ("gate/up skewed", (T, D, Fe, E), skewed, "bfloat16"),
              ("small fp32", (300, 72, 136, 6), [0, 130, 0, 0, 101, 0], "float32")]
    worst, out = 0.0, {}
    for seed, (label, (t, d, f, e), gs, dtype) in enumerate(checks):
        x, w, g = _moe_inputs(30 + seed, t, d, f, e, getattr(torch, dtype), gs)
        gen = torch.Generator(device="cuda").manual_seed(40 + seed)
        dy = torch.randn(t, f, generator=gen, device="cuda").to(x.dtype)
        xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        o = mg.moe_grouped_gemm(xa, wa, g)
        kernel = lambda: torch.autograd.grad(o, (xa, wa), dy, retain_graph=True)
        before = mg.moe_grouped_gemm.backward_launches
        by_route = dict(mg.moe_grouped_gemm.backward_launches_by_route)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        if mg.moe_grouped_gemm.backward_launches != before + 2:
            raise AssertionError(f"moe backward at {label}: the kernels did not launch")
        _bwd_route_moved(f"moe backward {label}", mg.moe_grouped_gemm, by_route,
                         mg.backward_route(x.dtype), 2)
        plain = lambda: mg.moe_grouped_gemm_backward_plain(x, w, g, dy)
        want = plain()
        errs = []
        for name, a, b, c in zip(("dx", "dw"), got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"moe backward at {label}: two runs differ in {name}")
            rel = _rel_err(a, c)
            if not rel <= BWD_TOL[dtype]:
                raise AssertionError(f"moe backward != plain at {label} {dtype}: {name} off "
                                     f"by {rel:.3g} of its largest (tol {BWD_TOL[dtype]})")
            errs.append(rel)
            if dtype == "float32":
                worst = max(worst, (a - c).abs().max().item())
        rows = min(sum(gs), t)
        if got[0][rows:].any():
            raise AssertionError(f"moe backward at {label}: dx past the routed rows not zero")
        line = (f"[moe backward] {label}: x [{t}, {d}], w [{e}, {d}, {f}], {rows} rows over "
                f"{sum(1 for v in gs if v)} experts, {dtype}: dx, dw off by {errs[0]:.3g}, "
                f"{errs[1]:.3g} of their largest; two runs give the same bits")
        del got, again, want
        if label != "gate/up":
            print(line, flush=True)
            del x, w, g, dy, xa, wa, o
            _free()
            continue
        ms = _device_ms(kernel, 3, flush=True)
        parts = {part: _device_ms(lambda want=want: mg._launch_backward(x, w, g, dy, *want),
                                  3, flush=True)
                 for part, want in (("dx", (True, False)), ("dw", (False, True)))}
        print("[moe backward] each kernel alone, device time per call, L2 flushed: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()), flush=True)
        plain_ms = _event_ms(plain, 2)
        lib, note = _grouped_mm_backward(x, w, g, dy)
        lib_ms = _device_ms(lib, 3, flush=True) if lib is not None else None
        flops, n_bytes = mg.backward_cost(x, w, gs)
        bound, by = _bound(flops, n_bytes, 2)
        print(f"{line}; device time per backward (dx and dw), L2 flushed: kernels "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (host included: it reads the group "
              f"sizes), torch._grouped_mm's backward "
              f"{f'{lib_ms:.4f} ms ({note})' if lib_ms is not None else f'none ({note})'}; "
              f"bound {bound:.6f} ms by {by} ({flops} flops, {n_bytes} bytes; "
              f"{100 * bound / ms:.1f}% of the kernels' time)", flush=True)
        out = {"bwd_ms": ms, "bwd_plain_ms": plain_ms, "bwd_bound_ms": bound,
               "bwd_bound_by": by, "bwd_library_ms": lib_ms,
               "bwd_source": "src/repro_torch/kernels/csrc/moe_gemm_bwd.cu",
               "bwd_split_ms": parts}
        del x, w, g, dy, xa, wa, o, lib
        _free()
    out["bwd_max_abs_err"] = worst
    return out


def _ssd_bwd_inputs(seed, b, s, h, hd, ds, g, dtype):
    """Seeded scan inputs on the card (x, dt = softplus(normal), mamba2's A
    = -linspace(1, 16, h), B and C [b, s, g, ds]) needing gradients, and
    an output gradient."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    leaves = [draw(b, s, h, hd).to(dtype), F.softplus(draw(b, s, h)),
              -torch.linspace(1.0, 16.0, h, device="cuda"), draw(b, s, g, ds).to(dtype),
              draw(b, s, g, ds).to(dtype)]
    return [t.requires_grad_(True) for t in leaves], draw(b, s, h, hd).to(dtype)


def phase_ssd_backward(ss):
    """The SSD scan's backward kernels (through autograd) against the plain
    backward at mamba2-1.3b's training shape (x [4, 2048, 64, 64], d_state
    128, chunk 256) and zamba2's (x [4, 2048, 112, 64], d_state 64) in bf16
    on the wgmma route, and a small fp32 case with two groups on the FMA
    route (against the plain backward in fp64): each gradient within
    BWD_TOL of its largest, the same bits on two runs; mamba2's backward
    timed beside its bound and the plain backward, and its device time by
    kernel (``_kernel_split``).  Returns the ssd_scan record's bwd_*
    numbers."""
    import torch

    from repro_torch.configs import get_config

    checks = []
    for label, arch in (("mamba2-1.3b", MAMBA_ARCH), ("zamba2", "zamba2-7b")):
        c = get_config(arch)
        sp = c.ssm
        checks.append((label, (4, 2048, sp.n_heads(c.d_model), sp.head_dim, sp.d_state,
                               sp.chunk, sp.n_groups), "bfloat16", "wgmma"))
    checks.append(("small fp32", (2, 512, 4, 64, 128, 256, 2), "float32", "fma"))
    worst, out = 0.0, {}
    for seed, (label, (b, s, h, hd, ds, q, g), dtype, want_route) in enumerate(checks):
        leaves, dy = _ssd_bwd_inputs(50 + seed, b, s, h, hd, ds, g, getattr(torch, dtype))
        if ss.backward_route(leaves[0].dtype, hd, ds, q) != want_route:
            raise AssertionError(f"ssd backward at {label}: route "
                                 f"{ss.backward_route(leaves[0].dtype, hd, ds, q)}, want "
                                 f"{want_route}")
        y = ss.ssd_scan(*leaves, chunk=q)
        kernel = lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)
        before = dict(ss.ssd_scan.backward_launches_by_route)
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        moved = {r: n - before[r] for r, n in ss.ssd_scan.backward_launches_by_route.items()}
        if moved != {r: 2 * int(r == want_route) for r in moved}:
            raise AssertionError(f"ssd backward at {label}: launches by route {moved}, "
                                 f"want 2 on {want_route}")
        args = [t.detach() for t in leaves]
        ref = [t.double() for t in args] if dtype == "float32" else args
        plain = lambda: ss.ssd_scan_backward_plain(*ref, dy.double() if dtype == "float32"
                                                   else dy, chunk=q)
        want = plain()
        errs = []
        for name, a, a2, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, again, want):
            if not torch.equal(a, a2):
                raise AssertionError(f"ssd backward at {label}: two runs differ in {name}")
            rel = _rel_err(a, w)
            if not rel <= BWD_TOL[dtype]:
                raise AssertionError(f"ssd backward != plain at {label} {dtype}: {name} off "
                                     f"by {rel:.3g} of its largest (tol {BWD_TOL[dtype]})")
            errs.append(rel)
            if dtype == "float32":
                worst = max(worst, (a.double() - w).abs().max().item())
        line = (f"[ssd backward] {label}: x [{b}, {s}, {h}, {hd}], d_state {ds}, {g} "
                f"group(s), chunk {q}, {dtype}, {want_route} route: dx, ddt, dA, dB, dC off "
                f"by " + ", ".join(f"{e:.3g}" for e in errs) + " of their largest; two "
                "runs give the same bits")
        del got, again, want
        if seed != 0:
            print(line, flush=True)
            del leaves, dy, y, args, ref
            _free()
            continue
        ms = _device_ms(kernel, 3, flush=True)
        parts = _kernel_split("ssd backward", kernel)
        plain_ms = _device_ms(plain, 1, flush=True)
        flops, n_bytes = ss.backward_cost(leaves[0], leaves[3], q)
        bound, by = _bound(flops, n_bytes, 2)
        print(f"{line}; device time per backward, L2 flushed: kernels {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, no library call computes it; bound {bound:.6f} ms by "
              f"{by} ({flops} flops, {n_bytes} bytes; {100 * bound / ms:.1f}% of the "
              f"kernels' time)", flush=True)
        out = {"bwd_ms": ms, "bwd_plain_ms": plain_ms, "bwd_bound_ms": bound,
               "bwd_bound_by": by, "bwd_library_ms": None,
               "bwd_source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
               "bwd_split_ms": parts}
        del leaves, dy, y, args, ref
        _free()
    out["bwd_max_abs_err"] = worst
    return out


def _train_path(tag, cfg, opt, batch, seq, counted):
    """The training main path of a phase: ``cfg`` at full width on the
    card, ``TRAIN_STEPS`` AdamW steps of ``TrainStepBuilder`` over the
    stream's first LM_TRAIN_CYCLE batches of ``batch`` x ``seq`` tokens in
    turn, with every kernel's forward and backward counts set to 0 just
    before the steps and read just after (``counted``: ``{name: (wrapper,
    route)}``, every backward launch on ``route``, the route the
    wrapper's module gives the path's shapes); finite losses and grad
    norms, the loss falling.  Returns the counts ``{name: (forward,
    backward)}``."""
    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import TransformerLM
    from repro_torch.train import TrainStepBuilder

    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TransformerLM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    builder = TrainStepBuilder(model, opt)
    state = builder.init_state()
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0)
    batches = [_pipe_batch(pipe, i, "cuda") for i in range(LM_TRAIN_CYCLE)]
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {n_params} parameters in {cfg.dtype}, optimizer m {opt.m_dtype}, "
          f"factored v {opt.factored_v}; built on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for fn, _ in counted.values():
        fn.launches = 0
        fn.backward_launches = 0
        fn.backward_launches_by_route = dict.fromkeys(fn.backward_launches_by_route, 0)
    losses, norms, walls = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, met = builder.train_step(state, batches[i % LM_TRAIN_CYCLE])
        losses.append(met["loss"].item())  # waits for the step
        norms.append(met["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
    counts = {n: (fn.launches, fn.backward_launches) for n, (fn, _) in counted.items()}
    _expect_routes(f"{tag} backward",
                   {n: dict(fn.backward_launches_by_route) for n, (fn, _) in counted.items()},
                   {n: {route: fn.backward_launches} for n, (fn, route) in counted.items()})
    if not all(math.isfinite(x) for x in losses + norms) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses}, grad norms {norms}")
    step_ms = 1e3 * float(np.median(walls[1:]))
    tokens = batch * seq
    print(f"[{tag}] {cfg.name} ({cfg.n_layers} layers, full width, bf16), batch {batch} x "
          f"{seq}, the stream's first {LM_TRAIN_CYCLE} batches in turn: losses "
          + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
          + ", ".join(f"{x:.3f}" for x in norms) + "; step walls "
          + ", ".join(f"{1e3 * w:.1f}" for w in walls) + f" ms (median after the first "
          f"{step_ms:.1f} ms, {tokens / step_ms * 1e3:.0f} tokens/s); launches over the "
          f"{TRAIN_STEPS} steps (forward, backward): {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
    del builder, state, model, batches
    _free()
    return counts


def phase_moe_train(mg, fa):
    """MoE training on the card: the grouped GEMM's backward checks and
    times; then the main path, llama4-scout at full width and
    MOE_TRAIN_LAYERS layer(s) (bf16, AdamW with bf16 first moments and a
    factored second moment), every grouped GEMM and attention call
    launching its forward kernel (twice a layer and step: rematerialised)
    and its backward kernels (once); then the fp32 card-vs-CPU check on a
    narrow llama4.  Returns the moe_gemm record's bwd_* numbers and the
    path's counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train import AdamWSettings

    t = time.perf_counter()
    nums = phase_moe_backward(mg)
    t = _phase_done("moe_gemm backward checks and times", t)
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    opt = AdamWSettings(lr=LM_TRAIN_LR, warmup_steps=LM_TRAIN_WARMUP,
                        total_steps=LM_TRAIN_TOTAL, m_dtype="bfloat16", factored_v=True)
    bf16 = torch.bfloat16
    counts = _train_path("moe train", cfg, opt, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                         {"moe_gemm": (mg.moe_grouped_gemm, mg.backward_route(bf16)),
                          "flash_attention": (fa.flash_attention, fa.backward_route(bf16))})
    L, n = cfg.n_layers, TRAIN_STEPS
    if counts != {"moe_gemm": (6 * L * n, 3 * L * n), "flash_attention": (2 * L * n, L * n)}:
        raise AssertionError(f"moe train: launches {counts} over {n} steps of {L} layers")
    t = _phase_done(f"moe train ({MOE_ARCH} at {L} layer(s), full width: steps)", t)
    base = get_config(MOE_ARCH)
    narrow = dataclasses.replace(base, name="llama4-narrow", dtype="float32",
                                 moe=dataclasses.replace(base.moe, d_ff_expert=512),
                                 **MOE_TRAIN_NARROW)
    _train_card_vs_cpu(narrow, "moe train")
    _phase_done("moe train parity (fp32 narrow llama4, card vs cpu)", t)
    return nums, counts


@contextlib.contextmanager
def _cpu_scan_fp64():
    """The model's scan on CPU tensors through the plain version in fp64:
    the CPU reference of the SSM configs' fp32 checks.  For the context's
    duration it replaces the module attribute
    ``repro_torch.models.ssm.ssd_scan``; only CPU tensors take the
    replacement, calls on the card still launch the kernel, and the port
    itself has no such switch.  Their A_log gradients sum d(seg)'s reverse
    cumulative sums, which cancel: the CPU's fp32 autograd is 1.2e-4 to
    2.9e-4 of A_log's largest gradient off the same with the scan in fp64
    (narrow mamba2), the kernels on an H100 (which sum that part in fp64)
    2.2e-5."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm as ssm_mod

    kernel = ssm_mod.ssd_scan

    def scan(x, dt, A, Bm, Cm, *, chunk):
        if x.device.type != "cpu":
            return kernel(x, dt, A, Bm, Cm, chunk=chunk)
        return ss.ssd_scan_plain(*(t.double() for t in (x, dt, A, Bm, Cm)),
                                 chunk=chunk)[0].to(x.dtype)

    ssm_mod.ssd_scan = scan
    try:
        yield
    finally:
        ssm_mod.ssd_scan = kernel


def phase_mamba_train(ss, fa):
    """Mamba2 training on the card: the SSD scan's backward checks and
    times; then the main path, mamba2-1.3b at full width and depth (bf16,
    AdamW), every scan call launching its forward kernels (twice a layer
    and step: rematerialised) and its backward kernels (once); then the
    fp32 card-vs-CPU checks on a narrow mamba2 and a narrow zamba2 (the
    CPU's scan in fp64: ``_train_card_vs_cpu``'s ``scan64``).  Returns the ssd_scan record's bwd_* numbers and the path's counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.train import AdamWSettings

    t = time.perf_counter()
    nums = phase_ssd_backward(ss)
    t = _phase_done("ssd_scan backward checks and times", t)
    cfg = get_config(MAMBA_ARCH)
    if MAMBA_TRAIN_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=MAMBA_TRAIN_LAYERS)
    opt = AdamWSettings(lr=LM_TRAIN_LR, warmup_steps=LM_TRAIN_WARMUP,
                        total_steps=LM_TRAIN_TOTAL)
    sp, bf16 = cfg.ssm, torch.bfloat16
    ssd_route = ss.backward_route(bf16, sp.head_dim, sp.d_state, sp.chunk)
    if ssd_route != "wgmma":
        raise AssertionError(f"mamba train: the scan's backward route is {ssd_route}, want wgmma")
    counts = _train_path("mamba train", cfg, opt, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ,
                         {"ssd_scan": (ss.ssd_scan, ssd_route),
                          "flash_attention": (fa.flash_attention, fa.backward_route(bf16))})
    L, n = cfg.n_layers, TRAIN_STEPS
    if counts != {"ssd_scan": (2 * L * n, L * n), "flash_attention": (0, 0)}:
        raise AssertionError(f"mamba train: launches {counts} over {n} steps of {L} layers")
    t = _phase_done(f"mamba train ({MAMBA_ARCH} at {L} layers, full width: steps)", t)
    for label, arch, narrow in (("mamba2", MAMBA_ARCH, MAMBA_TRAIN_NARROW),
                                ("zamba2", "zamba2-7b", ZAMBA_TRAIN_NARROW)):
        cfg_n = dataclasses.replace(get_config(arch), name=f"{label}-narrow", dtype="float32",
                                    **narrow)
        _train_card_vs_cpu(cfg_n, "mamba train", seq=512, scan64=True)
    _phase_done("mamba train parity (fp32 narrow mamba2 and zamba2, card vs cpu)", t)
    return nums, counts


# long_decode: zamba2-7b's long_500k cell (configs.SHAPES: a decode at batch
# 1 over 524288 positions).  On any mesh with dp > 1 the batch does not
# divide dp, so each rank keeps 524288 / dp of the cache's positions and the
# ranks' (o, lse) parts are merged (models.layers._seq_sharded_decode); the
# 13 shared-block applications of zamba2-7b hold 97.7 GB of such cache, more
# than one card.  On the one card: the decode kernels' logsumexp against the
# plain version; the shared block's attention over the whole cache against
# the dp ranks' parts and their merge run in one process over its shards
# (LONG_DP); the model at full width and LONG_LAYERS layers (two shared-block
# applications, 15 GB of cache) decoding LONG_TICKS ticks with no mesh; and
# _seq_sharded_decode itself on two gloo ranks on the card (NCCL takes one
# rank a card), where gloo takes CUDA tensors.
LONG_ARCH, LONG_SMAX = "zamba2-7b", 524288
LONG_DP = (2, 16)  # dp 16: the pod mesh's data axis, 32768 positions a rank
# query positions: in the first dp-16 shard, mid-cache, the last
LONG_POSITIONS = (1000, 262143, LONG_SMAX - 1)
LONG_LAYERS, LONG_TICKS = 12, 4
LONG_GLOO_SMAX = 65536  # the two gloo ranks' cache (32768 positions each)
LONG_GLOO_POSITIONS = (100, 32767, 40000, 65535)  # rank 1 sees no key at the first two
LONG_GLOO_TIMEOUT = 300
# the long caches' keys are drawn at LONG_K_STD standard deviations, their
# values standard normal: a query's scores then have that deviation, a few
# hundred keys across the cache carry its output (|o| of order 0.1-1, where
# keys drawn at 1 give sqrt(e / N), 1e-2 at 524288 positions), and the
# shards' logsumexps differ by units, so that the merge's weights matter
LONG_K_STD = 4.0
# the decode outputs held to one another within LONG_RTOL of the plain
# output's largest |o|: in bf16 two to four steps of the largest element, in
# fp32 sums in another order.  A decode that returns zeros, one that drops
# the last of its chunks, and a merge that drops its heaviest shard lie
# further, which the phase checks (``_long_gate``)
LONG_RTOL = {"float32": 2 ** -16, "bfloat16": 2 ** -6}
# the decode kernels' logsumexp against the plain version's, of the largest
# |lse| (a row that sees no key: exactly -1e30); fp32 sums in another order,
# bf16 also in the log2 domain with ex2.approx (relative error ~2^-22)
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
# (label, (B, H, KV, 1, Sk, D), kwargs): one chunk (at most 256 keys) and
# several, a window, a softcap, a row with no key, q_offset >= Sk (a rank
# whose shard lies before the query)
LSE_CHECKS = [
    ("one chunk", (2, 16, 2, 1, 1024, 128), dict(q_offset=200)),
    ("chunks", (2, 16, 2, 1, 4096, 128), dict(q_offset=3000)),
    ("window over chunks", (1, 32, 32, 1, 8192, 112), dict(q_offset=7000, window=2000)),
    ("softcap", (2, 8, 1, 1, 2048, 80), dict(q_offset=1500, softcap=30.0)),
    ("no key", (1, 8, 2, 1, 600, 128), dict(q_offset=700, window=4)),
    ("past the keys, one chunk", (1, 32, 32, 1, 200, 112), dict(q_offset=5000)),
    ("past the keys, chunks", (1, 32, 32, 1, 32768, 112), dict(q_offset=40000)),
]


def _lse_checks(fa):
    """Each LSE_CHECKS shape in fp32 (``flash_decode``) and bf16
    (``flash_decode_mma``) on the decode route with its logsumexp, against
    the plain version on the card: the output within LONG_RTOL of the
    plain output's largest |o|, each row's
    logsumexp within LSE_TOL of the largest |lse| and -1e30 exactly where
    the row sees no key; two runs give the same bits, and the output the
    same bits as the serving call's (no logsumexp).  Returns (the largest
    output error, the largest logsumexp error)."""
    import torch

    worst_o = worst = 0.0
    for seed, (label, shape, kw) in enumerate(LSE_CHECKS):
        b, h, kv, _, sk, d = shape
        chunks = fa.decode_plan(b, h, kv, sk, kw["q_offset"], True, kw.get("window") or 0)[3]
        errs = {}
        for dtype in ("float32", "bfloat16"):
            q, k, v = _flash_qkv(seed, *shape, getattr(torch, dtype))
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            o2, lse2 = fa.flash_attention(q, k, v, return_lse=True, **kw)
            served = fa.flash_attention(q, k, v, **kw)
            want_o, want = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(o, served)):
                raise AssertionError(f"long decode: {label} {dtype}: two runs, or the runs "
                                     "with and without the logsumexp, differ")
            none = want <= -1e29
            if not (torch.equal(lse[none], want[none]) and (want[none] == -1e30).all()):
                raise AssertionError(f"long decode: {label} {dtype}: a row that sees no key "
                                     "has a logsumexp other than -1e30")
            seen = ~none
            err = ((lse - want)[seen].abs().max().item()
                   / max(want[seen].abs().max().item(), 1.0)) if seen.any() else 0.0
            err_o = (o.float() - want_o.float()).abs().max().item()
            lim = LONG_RTOL[dtype] * want_o.float().abs().max().item()
            if not (err <= LSE_TOL[dtype] and err_o <= lim):
                raise AssertionError(f"long decode: {label} {dtype}: logsumexp err {err} (tol "
                                     f"{LSE_TOL[dtype]}), output err {err_o} (limit {lim})")
            errs[dtype] = (err_o, lim, err, int(none.sum()))
            worst, worst_o = max(worst, err), max(worst_o, err_o)
            del q, k, v, o, o2, lse, lse2, served, want_o, want
        print(f"[long decode] lse {label}: q [{b}, {h}, 1, {d}] over {kv} KV heads x {sk} "
              f"keys, {kw}, {chunks} chunk(s): " + "; ".join(
                  f"{dt} output err {e[0]:.3g} (limit {e[1]:.3g}), lse err {e[2]:.3g} of the "
                  f"largest |lse|, {e[3]} rows with no key at -1e30" for dt, e in errs.items())
              + "; two runs and the serving call (no lse) give the same bits", flush=True)
    return worst_o, worst


def _merge_over(parts):
    """``layers.merge_attention_parts`` over a list of shards' (o, lse) in
    one process: the parts stacked on a leading dimension, reduced over
    it."""
    import torch

    from repro_torch.models import layers

    o, lse = (torch.stack(t) for t in zip(*parts))
    return layers.merge_attention_parts(
        o, lse, lambda x, op: x.amax(0) if op == "max" else x.sum(0))


def _long_gate(tag, want, diffs, controls, rel):
    """Hold ``diffs`` (name -> max abs difference) within ``rel`` of
    ``want``'s largest |o|, and each of ``controls`` (name -> the max abs
    difference of an output known to be wrong) beyond it; prints both
    beside the limit."""
    lim = rel * want.float().abs().max().item()
    print(f"[long decode] {tag}: max abs diff " + ", ".join(
        f"{n} {e:.3g}" for n, e in diffs.items()) + f"; limit {lim:.3g} ({rel:.3g} of the "
          f"plain output's largest |o|); wrong outputs lie at " + ", ".join(
        f"{n} {e:.3g}" for n, e in controls.items()), flush=True)
    if not max(diffs.values()) <= lim:
        raise AssertionError(f"long decode: {tag} disagrees: {diffs}, limit {lim}")
    if not min(controls.values()) > lim:
        raise AssertionError(f"long decode: {tag}: the gate does not see a wrong output: "
                             f"{controls}, limit {lim}")


def _long_attention(fa, cfg):
    """The shared block's attention of ``cfg`` at full width over a
    LONG_SMAX-position bf16 cache drawn from a seed (keys at LONG_K_STD),
    batch 1, at LONG_POSITIONS: the whole-cache decode kernel, the plain
    version, and for each dp of LONG_DP the ranks' parts
    (``layers.seq_shard_part``) merged in one process, held to each other
    by ``_long_gate`` against zeros, the plain decode without the kernel's
    last chunk of keys, and each merge without its heaviest shard; then the
    whole-cache decode and one dp-16 rank's part timed at the last
    position.  Returns (the largest difference, the record's numbers)."""
    import torch

    from repro_torch.models import layers

    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(1, 1, h, d, generator=gen, device="cuda").to(torch.bfloat16)
    ck, cv = (torch.empty(1, LONG_SMAX, kv, d, dtype=torch.bfloat16, device="cuda")
              .normal_(std=std, generator=gen) for std in (LONG_K_STD, 1.0))
    kw = dict(causal=True, softcap=cfg.attn_softcap, scale=cfg.q_scaling())
    qt, kt, vt = q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)
    worst = 0.0
    for pos in LONG_POSITIONS:
        whole = fa.flash_attention(qt, kt, vt, q_offset=pos, **kw)
        plain = fa.flash_attention_plain(qt, kt, vt, q_offset=pos, **kw)
        chunk = fa.decode_plan(1, h, kv, LONG_SMAX, pos, True, 0)[2]
        short = fa.flash_attention_plain(qt, kt, vt, q_offset=pos - chunk, **kw)
        diffs = {"whole vs plain": (whole.float() - plain.float()).abs().max().item()}
        controls = {"zeros": plain.float().abs().max().item(),
                    f"the plain decode without the last chunk's {chunk} keys":
                        (short.float() - plain.float()).abs().max().item()}
        for dp in LONG_DP:
            sl = LONG_SMAX // dp
            parts = [layers.seq_shard_part(q, ck[:, i * sl:(i + 1) * sl],
                                           cv[:, i * sl:(i + 1) * sl], pos - i * sl, cfg, None)
                     for i in range(dp)]
            merged = _merge_over(parts).to(q.dtype)
            heavy = max(range(dp), key=lambda i: parts[i][1].max().item())
            dropped = _merge_over(parts[:heavy] + parts[heavy + 1:]).to(q.dtype)
            diffs[f"dp {dp} vs whole"] = (merged.float() - whole.float()).abs().max().item()
            diffs[f"dp {dp} vs plain"] = (merged.float() - plain.float()).abs().max().item()
            controls[f"dp {dp} without shard {heavy}"] = (
                dropped.float() - plain.float()).abs().max().item()
            del parts
        torch.cuda.synchronize()
        _long_gate(f"{cfg.name} shared attention, q [1, {h}, 1, {d}] over {kv} KV heads x "
                   f"{LONG_SMAX} positions (bf16), query at {pos}", plain, diffs, controls,
                   LONG_RTOL["bfloat16"])
        worst = max([worst] + list(diffs.values()))
        del whole, plain, short, merged, dropped
    pos, sl = LONG_SMAX - 1, LONG_SMAX // LONG_DP[-1]
    kwp = dict(kw, q_offset=pos)
    ms = _device_ms(lambda: fa.flash_attention(qt, kt, vt, **kwp), 20, flush=True)
    plain_ms = _device_ms(lambda: fa.flash_attention_plain(qt, kt, vt, **kwp), 2, flush=True)
    lib = _sdpa(qt, kt, vt, kwp)
    library_ms = _device_ms(lib, 20, flush=True) if lib is not None else None
    bound, by = _bound(*fa.cost(qt, kt, True, None, pos), 2)
    ks, vs = ck[:, -sl:], cv[:, -sl:]
    shard_ms = _device_ms(lambda: layers.seq_shard_part(q, ks, vs, sl - 1, cfg, None), 50,
                          flush=True)
    shard_bound, _ = _bound(*fa.cost(qt, ks.transpose(1, 2), True, None, sl - 1), 2)
    print(f"[long decode] bf16 device time per call at position {pos}, L2 flushed: "
          f"whole-cache decode {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms} ms; bound {bound:.6f} ms by {by}, "
          f"{100 * bound / ms:.1f}% of the kernel's time); one dp-{LONG_DP[-1]} rank's part "
          f"({sl} positions, with its logsumexp) {shard_ms:.4f} ms (bound {shard_bound:.6f} "
          f"ms, {100 * shard_bound / shard_ms:.1f}%) ({_card()})", flush=True)
    del ck, cv, kt, vt, ks, vs
    _free()
    return worst, {"long_decode_ms": ms, "long_decode_plain_ms": plain_ms,
                   "long_decode_bound_ms": bound, "long_decode_library_ms": library_ms,
                   "long_decode_shard_ms": shard_ms, "long_decode_shard_bound_ms": shard_bound}


def _long_model(fa, ss, mg):
    """zamba2-7b at full width and LONG_LAYERS layers, batch 1, no mesh:
    caches of LONG_SMAX positions (keys at LONG_K_STD) and mamba states
    drawn from a seed, then the main path: LONG_TICKS decode ticks at the
    cache's last positions (counts set to 0 just before, read just after; 2
    flash launches a tick, on the decode route), against the same ticks
    through the plain attention (``_against_plain``; the mamba states
    restored before each run); the same ticks with the caches' values
    zeroed must fall outside that gate (it sees the attention); ms per tick
    and the peak memory.  Returns the path's launches."""
    import torch

    from repro_torch.configs import get_config

    _free()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(LONG_ARCH), n_layers=LONG_LAYERS)
    n_apps = cfg.n_layers // cfg.hybrid_every
    model = _family_model("long decode", cfg, f"{cfg.n_layers} of 81 layers, {n_apps} "
                          f"shared-block applications")
    cache = model.cache_struct(1, LONG_SMAX)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, t in sorted(cache["attn"].items()):
        t.normal_(std=LONG_K_STD if name == "k" else 1.0, generator=gen)
    for name, t in cache["mamba"].items():
        t.normal_(generator=gen).mul_(0.1 if name == "h" else 1.0)
    kv_bytes = sum(t.numel() * t.element_size() for t in cache["attn"].values())
    snap = {n: t.clone() for n, t in cache["mamba"].items()}
    toks = torch.randint(0, cfg.vocab, (LONG_TICKS,), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(13))
    first = LONG_SMAX - LONG_TICKS

    def ticks():
        for n, t in cache["mamba"].items():
            t.copy_(snap[n])
        return torch.stack([model.decode_step(cache, toks[i:i + 1], first + i)[1]
                            for i in range(LONG_TICKS)])

    got, wall, pre, _, launches, _ = _main_path(_lm_kernels(fa, ss, mg), ticks)
    _expect_routes("long decode", pre, {"flash_attention": {"decode": n_apps * LONG_TICKS}})
    ms_tick = 1e3 * _warm(ticks) / LONG_TICKS
    _against_plain("long decode", f"{LONG_TICKS} decode ticks at positions {first}-"
                   f"{LONG_SMAX - 1}", cfg, got, ticks, ("flash",), wall, "decode ticks")
    cache["attn"]["v"].zero_()
    off = (ticks() - got)[..., : cfg.vocab].abs().max().item()
    lim = PREFILL_RTOL * got[..., : cfg.vocab].abs().max().item()
    print(f"[long decode] the same ticks with the caches' values zeroed (but the ticks' "
          f"own): max abs logit diff {off:.4g} from the kernel path's, beyond the gate's "
          f"limit {lim:.4g}", flush=True)
    if not off > lim:
        raise AssertionError("long decode: the logits gate does not see the attention "
                             f"({off} <= {lim})")
    print(f"[long decode] {cfg.name} at {cfg.n_layers} layers, batch 1, caches of "
          f"{LONG_SMAX} positions ({kv_bytes} bytes of shared-block KV): {ms_tick:.2f} ms a "
          f"decode tick (warm); flash launches {launches['flash_attention']}; peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes ({_card()})", flush=True)
    del got, cache, snap, model
    _free()
    return launches


class _OneAxisMesh:
    """The dp axis of two gloo ranks, enough for ``MeshContext`` and
    ``_seq_sharded_decode``: the rank's coordinate and the world group."""

    mesh_dim_names, shape = ("data",), (2,)

    def __init__(self, rank):
        self.rank = rank

    def get_local_rank(self, axis):
        return self.rank

    def get_group(self, axis):
        import torch.distributed as dist

        return dist.group.WORLD


def _gloo_rank(rank, port, out):
    """One of two gloo ranks on the card: an all-reduce of a CUDA tensor
    first (does gloo take them?), then ``_seq_sharded_decode`` over this
    rank's half of a LONG_GLOO_SMAX-position cache at LONG_GLOO_POSITIONS;
    rank 0 holds the merged outputs against the whole-cache decode kernel
    and writes the record to ``out``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch import sharding as sh
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        try:
            probe = sh.all_reduce(torch.full((4,), rank + 1.0, device="cuda"),
                                  dist.group.WORLD)
            ok = probe.device.type == "cuda" and probe.tolist() == [3.0] * 4
            note = f"all_reduce gave {probe.tolist()} on {probe.device}"
        except RuntimeError as e:
            ok, note = False, f"{type(e).__name__}: {e}"
        if not ok:
            if rank == 0:
                Path(out).write_text(json.dumps({"gloo_cuda": False, "note": note[:2000]}))
            return
        cfg = get_config(LONG_ARCH)
        h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        gen = torch.Generator(device="cuda").manual_seed(14)
        q = torch.randn(1, 1, h, d, generator=gen, device="cuda").to(torch.bfloat16)
        ck, cv = (torch.empty(1, LONG_GLOO_SMAX, kv, d, dtype=torch.bfloat16, device="cuda")
                  .normal_(std=std, generator=gen) for std in (LONG_K_STD, 1.0))
        sl = LONG_GLOO_SMAX // 2
        ctx = sh.MeshContext(mesh=_OneAxisMesh(rank), dp=("data",), tp=None)
        fa.flash_attention.launches = 0
        outs = [layers._seq_sharded_decode(q, ck[:, rank * sl:(rank + 1) * sl],
                                           cv[:, rank * sl:(rank + 1) * sl], pos, cfg, None, ctx)
                for pos in LONG_GLOO_POSITIONS]
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        dist.barrier()
        if rank == 0:
            errs, lims = [], []
            for pos, o in zip(LONG_GLOO_POSITIONS, outs):
                whole = fa.flash_attention(
                    q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2), causal=True,
                    scale=cfg.q_scaling(), softcap=cfg.attn_softcap, q_offset=pos)
                errs.append((o.float() - whole.float()).abs().max().item())
                lims.append(LONG_RTOL["bfloat16"] * whole.float().abs().max().item())
            Path(out).write_text(json.dumps({"gloo_cuda": True, "note": note, "errs": errs,
                                             "limits": lims, "launches": launches}))
    finally:
        dist.destroy_process_group()


def _gloo_decode():
    """``_gloo_rank`` on two processes sharing the card; returns its record
    (whether gloo takes CUDA tensors, the probe's note, and where it does
    the merged decode's differences from the whole-cache decode).  A rank
    that fails or hangs fails the phase."""
    import socket

    out = ROOT / "build" / "long_decode_gloo.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp = get_context("spawn")
    procs = [mp.Process(target=_gloo_rank, args=(r, port, str(out))) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + LONG_GLOO_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.perf_counter()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0] or not out.exists():
        raise AssertionError(f"long decode: the gloo ranks exited with {codes}")
    rec = json.loads(out.read_text())
    if not rec["gloo_cuda"]:
        print(f"[long decode] gloo does not take CUDA tensors for all_reduce here "
              f"({rec['note']}): the merge over ranks is verified by the CPU gloo tests "
              f"only", flush=True)
        return rec
    print(f"[long decode] two gloo ranks on the card ({rec['note']}): _seq_sharded_decode "
          f"over {LONG_GLOO_SMAX} positions, {LONG_GLOO_SMAX // 2} a rank, at positions "
          f"{LONG_GLOO_POSITIONS}: max abs diff from the whole-cache decode "
          f"{rec['errs']} (limits {rec['limits']}, {LONG_RTOL['bfloat16']} of the whole-cache "
          f"decode's largest |o|); rank 0's flash launches {rec['launches']}", flush=True)
    # rank 0 launches at every position (its local position is never < 0)
    if not (all(e <= lim for e, lim in zip(rec["errs"], rec["limits"]))
            and rec["launches"] == len(LONG_GLOO_POSITIONS)):
        raise AssertionError(f"long decode: the gloo ranks' decode disagrees: {rec}")
    return rec


def phase_long_decode(fa, ss, mg, t):
    """long_decode (see the note above LONG_ARCH).  Returns the flash
    record's numbers (``long_decode_*``, the checks' largest errors) and
    the main path's flash launches."""
    from repro_torch.configs import get_config

    err_o, err_lse = _lse_checks(fa)
    t = _phase_done("long decode: the decode kernels' logsumexp against the plain version", t)
    err_att, nums = _long_attention(fa, get_config(LONG_ARCH))
    t = _phase_done(f"long decode: {LONG_ARCH}'s shared attention over {LONG_SMAX} positions, "
                    f"whole and split over dp {LONG_DP}", t)
    launches = _long_model(fa, ss, mg)
    t = _phase_done(f"long decode: {LONG_ARCH} at {LONG_LAYERS} layers, {LONG_TICKS} ticks "
                    f"over {LONG_SMAX} positions (main path)", t)
    gloo = _gloo_decode()
    t = _phase_done("long decode: two gloo ranks on the card", t)
    nums.update(max_abs_err=max(err_o, err_att), long_decode_lse_err=err_lse,
                long_decode_gloo_cuda=gloo["gloo_cuda"])
    return nums, launches["flash_attention"], t


# mesh: the mesh train step on one NCCL rank (make_host_mesh: data 1 x model
# 1; NCCL takes one rank a card), internlm2-1.8b at full width and depth in
# bf16, against the step without a mesh; the op counter and the roofline on
# the card's constants over one such step; one dry-run cell on the pod mesh
# (a fake group of 256 ranks, in a subprocess without the card).  On one
# rank the mesh step runs the same operations in the same order as the
# step without one (its collectives are copies), so the losses and grad
# norms must agree to MESH_RTOL, in bf16 at full width and in fp32 on the
# narrow config.
MESH_STEPS = 2
MESH_RTOL = 1e-6
MESH_DRYRUN = ("internlm2-1.8b", "train_4k", "pod")
MESH_DRYRUN_TIMEOUT = 400


def _mesh_steps(cfg, ctx, batch, fa, lr=LM_TRAIN_LR):
    """MESH_STEPS AdamW steps of ``cfg`` (weights from seed 0) on ``batch``
    each step, on ``ctx``'s mesh when it is given: (losses, grad norms,
    step walls, the builder and state, the flash counts over the steps)."""
    import torch

    from repro_torch.models import TransformerLM
    from repro_torch.train import AdamWSettings, TrainStepBuilder

    model = TransformerLM(cfg, device="cuda").init(torch.Generator(device="cuda").manual_seed(0))
    if ctx is not None:
        model.shard_parameters(ctx)
    builder = TrainStepBuilder(model, AdamWSettings(lr=lr, warmup_steps=LM_TRAIN_WARMUP,
                                                    total_steps=LM_TRAIN_TOTAL))
    state = builder.init_state()
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    fa.flash_attention.backward_launches = 0
    fa.flash_attention.launches_by_route = dict.fromkeys(fa.ROUTES, 0)
    fa.flash_attention.backward_launches_by_route = dict.fromkeys(fa.BWD_ROUTES, 0)
    losses, norms, walls = [], [], []
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        state, met = builder.train_step(state, batch)
        losses.append(met["loss"].item())  # waits for the step
        norms.append(met["grad_norm"].item())
        walls.append(time.perf_counter() - t0)
    counts = (fa.flash_attention.launches, fa.flash_attention.backward_launches,
              dict(fa.flash_attention.launches_by_route),
              dict(fa.flash_attention.backward_launches_by_route))
    # the weights after the steps (the first step's lr is 0, the second's
    # not): each parameter's sum and sum of magnitudes
    sums = []
    for p in model.parameters():
        w = (p.detach().to_local() if hasattr(p, "to_local") else p.detach()).double()
        sums.append((w.sum().item(), w.abs().sum().item()))
    return losses, norms, walls, builder, state, counts, sums


def _mesh_agree(tag, plain, mesh):
    for name, a, b in (("loss", plain[0], mesh[0]), ("grad norm", plain[1], mesh[1])):
        if not all(math.isfinite(x) and abs(x - y) <= MESH_RTOL * abs(x) for x, y in zip(a, b)):
            raise AssertionError(f"{tag}: the mesh step's {name}es {b} != the step's {a} "
                                 f"(rtol {MESH_RTOL})")
    off = [i for i, ((s, m), (s2, _)) in enumerate(zip(plain[-1], mesh[-1]))
           if not abs(s - s2) <= MESH_RTOL * m]
    if len(plain[-1]) != len(mesh[-1]) or off:
        raise AssertionError(f"{tag}: the weights after the steps differ on and off the mesh "
                             f"(parameters {off[:8]}; rtol {MESH_RTOL} of their magnitude)")
    print(f"[mesh] {tag}: losses {mesh[0]} and grad norms {mesh[1]} on the mesh, {plain[0]} "
          f"and {plain[1]} without; largest relative difference "
          f"{max(abs(x - y) / abs(x) for x, y in zip(plain[0] + plain[1], mesh[0] + mesh[1])):.3g}"
          f" (rtol {MESH_RTOL}); the {len(mesh[-1])} parameters' sums after the steps agree",
          flush=True)


def _start_dryrun():
    """The dry run of MESH_DRYRUN's cell, started in a process of its own
    without the card: (the process, its record's path)."""
    arch, shape, mesh_kind = MESH_DRYRUN
    out = ROOT / "build" / "dryrun" / f"{arch}__{shape}__{mesh_kind}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape, "--mesh", mesh_kind, "--out", str(out)],
                            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())  # a failed run stops it
    return proc, out


def _mesh_ckpt_round_trip(ctx):
    """The narrow config in fp32 on the mesh, under deterministic
    algorithms: two steps, ``save_state`` (each leaf gathered whole), the
    state restored into a fresh mesh model drawn from another seed, then
    one more step from each: the two states after it equal bit for bit."""
    import tempfile

    import torch

    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import TransformerLM
    from repro_torch.train import (AdamWSettings, TrainStepBuilder, latest_checkpoint,
                                   restore_state, save_state)
    from repro_torch.train.checkpoint import leaf_paths
    from repro_torch.train.train_loop import state_tree

    cfg = _narrow_cfg("float32")
    batch = _pipe_batch(TokenPipeline(vocab=cfg.vocab, seq_len=256, global_batch=2, seed=5),
                        0, "cuda")

    def fresh(seed):
        model = TransformerLM(cfg, device="cuda").init(
            torch.Generator(device="cuda").manual_seed(seed)).shard_parameters(ctx)
        b = TrainStepBuilder(model, AdamWSettings(lr=LM_TRAIN_FP32_LR, warmup_steps=1,
                                                  total_steps=LM_TRAIN_STEPS))
        return b, b.init_state()

    with _deterministic():
        b, s = fresh(2)
        for _ in range(2):
            s, _ = b.train_step(s, batch)
        with tempfile.TemporaryDirectory() as d:
            path = save_state(d, s)
            n_files = len(list(path.glob("*.npy")))
            b2, s2 = fresh(9)
            s2 = restore_state(latest_checkpoint(d), s2)
        s, m = b.train_step(s, batch)
        s2, m2 = b2.train_step(s2, batch)
        torch.cuda.synchronize()
    want = dict(leaf_paths(state_tree(s)))
    diff = [n for n, t in leaf_paths(state_tree(s2)) if not torch.equal(t, want[n])]
    if diff or m["loss"].item() != m2["loss"].item():
        raise AssertionError(f"mesh: the step after the checkpoint round trip differs at "
                             f"{diff[:8]} (losses {m['loss'].item()}, {m2['loss'].item()})")
    print(f"[mesh] checkpoint round trip on the mesh, narrow fp32 config: save at step 2 "
          f"({n_files} leaves, each whole), restore into a fresh mesh model, one more step: "
          f"the {len(want)} state leaves and the loss ({m['loss'].item()}) equal the step "
          f"without the round trip bit for bit", flush=True)


def phase_mesh(fa, card):
    """The mesh phase (see the note above MESH_STEPS): the timed steps
    first, then the dry-run cell, which runs alone on the host.  Returns
    the mesh path's flash launches (forward, backward)."""
    import torch
    import torch.distributed as dist

    from repro_torch import roofline
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.sharding import ctx_for_mesh

    t = time.perf_counter()
    mesh_mod.init_ranks("cuda")
    ctx = ctx_for_mesh(mesh_mod.make_host_mesh())
    print(f"[mesh] one NCCL rank, mesh {dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.shape))}, "
          f"dp {ctx.dp}, tp {ctx.tp}", flush=True)
    cfg = get_config(LM_ARCH)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH,
                         seed=0)
    batch = _pipe_batch(pipe, 0, "cuda")
    _free()
    plain = _mesh_steps(cfg, None, batch, fa)
    plain = plain[:3] + plain[-1:]
    _free()
    torch.cuda.reset_peak_memory_stats()
    mesh = _mesh_steps(cfg, ctx, batch, fa)
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd, by_route, bwd_by_route = mesh[5]
    n = MESH_STEPS
    if (fwd, bwd) != (2 * cfg.n_layers * n, cfg.n_layers * n) or by_route["wgmma"] != fwd \
            or bwd_by_route["wgmma"] != bwd:
        raise AssertionError(f"mesh: flash launched {fwd} forwards ({by_route}) and {bwd} "
                             f"backwards ({bwd_by_route}) over {n} steps of {cfg.n_layers} "
                             f"layers, want all on wgmma")
    _mesh_agree(f"{cfg.name} bf16 full width", plain, mesh)
    step_s = mesh[2][-1]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"[mesh] {cfg.name} ({cfg.n_layers} layers, bf16), batch {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ}: mesh step walls " + ", ".join(f"{1e3 * w:.1f}" for w in mesh[2])
          + " ms, without the mesh " + ", ".join(f"{1e3 * w:.1f}" for w in plain[2])
          + f" ms; flash launches a step: {fwd // n} forward, {bwd // n} backward, all on "
          f"wgmma; peak device memory {peak} bytes ({card})", flush=True)
    builder, state = mesh[3], mesh[4]
    del mesh
    # the count: one more step under the op counter
    with OpCounter() as counter:
        builder.train_step(state, batch)
    torch.cuda.synchronize()
    res = counter.result()
    model_flops = 6.0 * cfg.param_count() * tokens
    compute_s = res["dot_flops"] / mesh_mod.PEAK_FLOPS_BF16
    memory_s = res["hbm_bytes"] / mesh_mod.HBM_BW
    coll_s = res["collective_total_bytes"] / mesh_mod.NVLINK_BW
    ratio = res["dot_flops"] / model_flops
    if not 1.0 <= ratio <= 3.0:
        raise AssertionError(f"mesh: counted {res['dot_flops']:.4g} flops, {ratio:.3f} x 6 N "
                             f"tokens (want 1 to 3)")
    print(f"[mesh] op count of one step: {res['dot_flops']:.6g} matmul flops "
          f"({ratio:.4f} x 6 N tokens = {model_flops:.6g}, N {cfg.param_count()}), "
          f"{res['hbm_bytes']:.6g} HBM bytes, collectives {res['collective_bytes']} "
          f"({res['collective_total_bytes']:.6g} bytes), kernels "
          + ", ".join(f"{k} {v['calls']} calls {v['flops']:.4g} flops" for k, v in
                      res["kernels"].items()) + f"; roofline terms on the H100 constants "
          f"(bf16 {mesh_mod.PEAK_FLOPS_BF16:.4g} FLOP/s, HBM {mesh_mod.HBM_BW:.4g} B/s, "
          f"NVLink {mesh_mod.NVLINK_BW:.4g} B/s): compute {1e3 * compute_s:.3f} ms, memory "
          f"{1e3 * memory_s:.3f} ms, collective {1e3 * coll_s:.3f} ms; measured step "
          f"{1e3 * step_s:.1f} ms; MFU {model_flops / step_s / mesh_mod.PEAK_FLOPS_BF16:.4f}; "
          f"card memory {mesh_mod.card_memory_bytes()} bytes ({card})", flush=True)
    del builder, state
    _free()
    narrow = dataclasses.replace(cfg, name="internlm2-narrow", dtype="float32",
                                 **LM_TRAIN_NARROW)
    batch = _pipe_batch(TokenPipeline(vocab=narrow.vocab, seq_len=256, global_batch=2, seed=0),
                        0, "cuda")
    plain = _mesh_steps(narrow, None, batch, fa, lr=LM_TRAIN_FP32_LR)
    mesh = _mesh_steps(narrow, ctx, batch, fa, lr=LM_TRAIN_FP32_LR)
    plain, mesh = plain[:3] + plain[-1:], mesh[:3] + mesh[-1:]
    _mesh_agree("narrow fp32", plain, mesh)
    del plain, mesh
    _free()
    _mesh_ckpt_round_trip(ctx)
    _free()
    dist.destroy_process_group()
    t = _phase_done("mesh train step (one NCCL rank) and its op count", t)
    # the dry-run cell, on the CPU in its own process, after the timed steps
    arch, shape, mesh_kind = MESH_DRYRUN
    proc, out = _start_dryrun()
    try:
        _, err = proc.communicate(timeout=MESH_DRYRUN_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rec = json.loads(out.read_text()) if out.exists() else {"status": "no record"}
    if proc.returncode != 0 or rec["status"] != "run":
        raise AssertionError(f"dry run of {MESH_DRYRUN}: rc {proc.returncode}, status "
                             f"{rec['status']}: {err[-2000:]}")
    cell = roofline.cell_roofline(rec, memory_bytes=mesh_mod.card_memory_bytes())
    print(f"[mesh] dry run {arch} {shape} on the {mesh_kind} mesh ({rec['n_devices']} fake "
          f"ranks, built in {rec['lower_s']} s, run in {rec['compile_s']} s): memory per "
          f"device {rec['memory']}; {rec['cost']['flops']:.6g} matmul flops and "
          f"{rec['cost']['bytes_accessed']:.6g} HBM bytes per device; collective bytes by "
          f"kind {rec['collectives']['bytes_by_kind']}; roofline compute {cell.compute_s:.4g} s"
          f", memory {cell.memory_s:.4g} s, collective {cell.collective_s:.4g} s "
          f"({cell.dominant}), MODEL_FLOPS / counted {cell.useful_ratio:.3f}, fits "
          f"{cell.fits}", flush=True)
    _phase_done("dry run of one cell on the pod mesh (CPU, fake group)", t)
    return fwd, bwd


def _phase_done(name, t0):
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return time.perf_counter()


def phase_lm_serve(fa, t):
    """Phase 7: the attention kernel's checks and times, then the LM."""
    flash = phase_flash_kernel(fa)
    t = _phase_done("flash_attention kernel checks and times", t)
    launches = phase_lm(fa)
    t = _phase_done("LM serving (internlm2-1.8b: prefill, parity, decode, "
                    "ServeEngine, profile)", t)
    return flash, launches, t


def phase_sage_all(sa, wf, t):
    """Phase 6: the aggregation kernels' checks and times, then GraphSAGE."""
    sage, launches = phase_sage(sa, wf)
    t = _phase_done("GraphSAGE (graph, kernel checks, parity, training, "
                    "calibration, profile)", t)
    return sage, launches, t


def _sage_entry(sage, launches):
    return _entry("sage_aggregate", "sage_aggregate", "src/repro/kernels/sage_aggregate.py:83",
                  sage, launches["sage_aggregate"])


def _flash_entry(flash, launches):
    return _entry("flash_attention", "flash_attention",
                  "src/repro/kernels/flash_attention.py:102", flash, launches)


def _card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return smi.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("regimes", "tenants", "cache", "obs", "sage",
                                       "lm_serve", "mamba_serve", "moe_serve",
                                       "kimi_serve", *FAMILY_PHASES, "lm_train",
                                       "moe_train", "mamba_train", "long_decode", "mesh"),
                    default=None, help="build the kernels and run this phase alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import sage_aggregate as sa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import waterfill as wf

    t_start = t = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    sources = (wf.SOURCE, sa.SOURCE, fa.SOURCE, fa.BWD_SOURCE, ss.SOURCE, ss.BWD_SOURCE,
               mg.SOURCE, mg.BWD_SOURCE)
    for src, (_, secs, log) in zip(sources, _build.build(*sources)):
        print(f"[build] {src.name} built in {secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {line.strip()}", flush=True)
    t = _phase_done(f"build ({len(sources)} sources, in parallel)", t)
    # full fp32 products and convolutions wherever the card is held to a
    # plain or CPU result (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn."
          f"allow_tf32 = {torch.backends.cudnn.allow_tf32}", flush=True)
    if args.only is not None:
        if args.only in ("regimes", "tenants", "cache", "obs"):
            if args.only == "regimes":
                launches, t = phase_regimes_all(wf, t)
            else:
                units = {"tenants": TENANT_UNITS, "cache": CACHE_UNITS,
                         "obs": OBS_UNITS}[args.only]
                launches, t = phase_tenants_cache(wf, t, units, args.only)
            print(json.dumps({"waterfill_launches": launches}))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        if args.only == "sage":
            sage, sage_launches, t = phase_sage_all(sa, wf, t)
            entries = [_sage_entry(sage, sage_launches)]
        elif args.only == "lm_serve":
            flash, flash_launches, t = phase_lm_serve(fa, t)
            entries = [_flash_entry(flash, flash_launches)]
        elif args.only == "mamba_serve":
            entry, t = phase_mamba_serve(ss, fa, mg, t)
            entries = [entry]
        elif args.only == "kimi_serve":
            launches, _, t = phase_kimi_serve(mg, fa, t)
            print(json.dumps({"kimi_launches": launches}))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        elif args.only == "lm_train":
            nums, fwd = phase_lm_train(fa)
            print(json.dumps({"flash_attention": {**nums, "train_forward_launches": fwd}}))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        elif args.only in ("moe_train", "mamba_train"):
            if args.only == "moe_train":
                nums, counts = phase_moe_train(mg, fa)
            else:
                nums, counts = phase_mamba_train(ss, fa)
            print(json.dumps({"backward": nums, "train_launches": counts}))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        elif args.only == "long_decode":
            nums, launches, t = phase_long_decode(fa, ss, mg, t)
            print(json.dumps({"flash_attention": nums, "long_decode_launches": launches}))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        elif args.only == "mesh":
            fwd, bwd = phase_mesh(fa, _card())
            print(json.dumps({"mesh_flash_launches": [fwd, bwd]}))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        elif args.only in FAMILY_PHASES:
            fams, t = phase_families(fa, ss, mg, t, (args.only,))
            print(json.dumps(fams[args.only]))
            print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
            return 0
        else:
            entry, _, _, t = phase_moe_serve(mg, fa, t)
            entries = [entry]
        print(json.dumps({"kernels": entries}))
        print(f"[done] {time.perf_counter() - t_start:.1f} s ({args.only} only)")
        return 0

    kern = phase_kernel(wf)
    t = _phase_done("waterfill kernel checks", t)

    # the planning path: counts set to 0 here, read after the plan phase
    wf.waterfill_fill.launches = 0
    sa.sage_aggregate.launches = 0
    with ProcessPoolExecutor(CPU_WORKERS, mp_context=get_context("spawn"),
                             initializer=_low_priority) as pool:
        cands, pending, gpu = phase_engine(wf, pool)
        t = _phase_done("engine at width 1024", t)
        phase_plan(wf)
        launches = wf.waterfill_fill.launches
        t = _phase_done("plan() and the DistDGL baseline", t)
        check_engine(pending, gpu)
        t = _phase_done("waiting for the CPU references", t)
    if launches == 0:
        raise AssertionError("the main path never launched the waterfill kernel")
    phase_profile(cands)
    t = _phase_done("engine profile", t)
    regime_launches, t = phase_regimes_all(wf, t)
    tenant_launches, t = phase_tenants_cache(wf, t, TENANT_UNITS, "tenants")
    cache_launches, t = phase_tenants_cache(wf, t, CACHE_UNITS, "cache")
    obs_launches, t = phase_tenants_cache(wf, t, OBS_UNITS, "obs")

    sage, sage_launches, t = phase_sage_all(sa, wf, t)

    flash, flash_launches, t = phase_lm_serve(fa, t)
    ssd_entry, t = phase_mamba_serve(ss, fa, mg, t)
    moe_entry, moe_flash_launches, moe_flash_err, t = phase_moe_serve(mg, fa, t)
    kimi_launches, kimi_flash_err, t = phase_kimi_serve(mg, fa, t)
    flash["max_abs_err"] = max(flash["max_abs_err"], moe_flash_err, kimi_flash_err)
    moe_entry["launches"] += kimi_launches["moe_gemm"]
    mamba_ssd_launches = ssd_entry["launches"]
    families, t = phase_families(fa, ss, mg, t)
    family_flash_launches = _add_families(flash, ssd_entry, families)
    train_nums, train_flash_launches = phase_lm_train(fa)
    flash.update(train_nums)
    flash["max_abs_err"] = max(flash["max_abs_err"], train_nums["bwd_max_abs_err"])
    moe_bwd, moe_counts = phase_moe_train(mg, fa)
    ssd_bwd, ssd_counts = phase_mamba_train(ss, fa)
    long_nums, long_launches, t = phase_long_decode(fa, ss, mg, time.perf_counter())
    flash["max_abs_err"] = max(flash["max_abs_err"], long_nums.pop("max_abs_err"))
    flash.update(long_nums)
    mesh_fwd, mesh_bwd = phase_mesh(fa, _card())
    t = time.perf_counter()
    moe_serve_launches = moe_entry["launches"]
    moe_entry["launches"] += moe_counts["moe_gemm"][0]
    moe_entry.update({k: v for k, v in moe_bwd.items() if k != "bwd_max_abs_err"})
    moe_entry["bwd_launches"] = moe_counts["moe_gemm"][1]
    moe_entry["max_abs_err"] = max(moe_entry["max_abs_err"], moe_bwd["bwd_max_abs_err"])
    ssd_entry["launches"] += ssd_counts["ssd_scan"][0]
    ssd_entry.update({k: v for k, v in ssd_bwd.items() if k != "bwd_max_abs_err"})
    ssd_entry["bwd_launches"] = ssd_counts["ssd_scan"][1]
    ssd_entry["max_abs_err"] = max(ssd_entry["max_abs_err"], ssd_bwd["bwd_max_abs_err"])
    train_flash_launches += moe_counts["flash_attention"][0] + mesh_fwd
    flash["bwd_launches"] += moe_counts["flash_attention"][1] + mesh_bwd

    line = {
        "kernels": [
            _entry("waterfill_fill", "waterfill", "src/repro/kernels/waterfill.py:64",
                   kern, launches + regime_launches + tenant_launches + cache_launches
                   + obs_launches + sage_launches["waterfill_fill"]),
            _sage_entry(sage, sage_launches),
            _flash_entry(flash, flash_launches + moe_flash_launches
                         + kimi_launches["flash_attention"] + family_flash_launches
                         + long_launches + train_flash_launches),
            ssd_entry,
            moe_entry,
        ]
    }
    print(f"[launches] planning path: waterfill_fill {launches}; regimes and "
          f"re-planning path: waterfill_fill {regime_launches}; tenants path: "
          f"waterfill_fill {tenant_launches}; cache path: waterfill_fill "
          f"{cache_launches}; obs path: waterfill_fill {obs_launches}; GraphSAGE "
          f"path: {sage_launches}; LM serving path: flash_attention "
          f"{flash_launches}; mamba2 path: ssd_scan {mamba_ssd_launches}; "
          f"MoE path: moe_gemm {moe_serve_launches - kimi_launches['moe_gemm']}, "
          f"flash_attention {moe_flash_launches}; kimi path: {kimi_launches}; "
          + "; ".join(f"{name} path: {fam['launches']}" for name, fam in families.items())
          + f"; LM training paths: flash_attention {train_flash_launches} forward, "
          f"{flash['bwd_launches']} backward (internlm2 and llama4-scout); MoE training "
          f"path: moe_gemm {moe_counts['moe_gemm'][0]} forward, {moe_counts['moe_gemm'][1]} "
          f"backward; mamba2 training path: ssd_scan {ssd_counts['ssd_scan'][0]} forward, "
          f"{ssd_counts['ssd_scan'][1]} backward; long decode path: flash_attention "
          f"{long_launches}; mesh training path: flash_attention "
          f"{mesh_fwd} forward, {mesh_bwd} backward", flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line))
    print(_card())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
