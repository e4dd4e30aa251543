#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one Hopper GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an sm_90 card.  Phases:

1. device: the card's name and power limit; TF32 off for fp32 products
   and convolutions;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc``; print
   each kernel's registers, spills and static shared memory (``-Xptxas
   -v``, read by ``repro_torch.analysis.kernels.ptxas_usage``);
3. kernels vs plain: every kernel against its plain PyTorch version on the
   card, fp32 and bf16, at the slices' shapes and at edge shapes — RMSNorm
   at widths 64-8192 (the training rows of zamba2-2.7b and falcon-mamba-7b,
   a 4-row decode case at each width, an odd width and an unaligned view;
   every warps-per-row plan must be reached), prefill attention at head
   dims 16-128 (80: zamba2-2.7b's, causal, GQA G=1 and G=4) and with V
   narrower than Q/K (MLA's 192 / 128 and 16 / 8, fp32 and bf16, causal
   and not), the Mamba-1
   scan (ragged and unaligned L and C, L = 1, N = 4..128, large dt*A,
   every lanes-per-channel plan, bit for bit across two launches) and the
   Mamba-2 SSD (ragged L, G in {1, 2, 4}, N in {8, 16, 64}, large dt*A, a
   128-chunk chain, 512 (b, h) pairs of 2 chunks, bf16 x/B/C with fp32
   dt), the
   tensor-core SSD also against its rounding-faithful plain version and
   bit for bit across two launches;
   paged decode against dense decode on the same rows (bit for bit); the
   bf16 tensor-core prefill at every head dim and block shape (causal,
   cross, q_offset of either sign, window, softcap, ragged lengths); the
   split decode at 16 slots over 4096-row caches (lengths 0, 1, on a
   split boundary, past the capacity), paged equal to dense bit for bit
   there too; the tensor-core instructions (HMMA) in the prefill and SSD
   kernels' SASS; and the gradient of each autograd-wrapped op (kernel forward,
   recompute backward) against autograd through its plain version, prefill
   also at the instances phase 4i trains (MLA's 192 / 128; non-causal
   self-attention, fp32 and bf16; non-causal cross-attention, 64 over 1600
   rows, GQA; a bf16 query over fp32 K/V, each gradient in its input's
   dtype); what
   SSM serving launches: the scan with its final state and the SSD with
   its initial and final states (both routes) at prefill lengths 1, 17,
   63, 64, 65 and 200 and the fixed batch (4, 64), y bit for bit equal to
   the launch without the state, SSD prefills of other lengths queued
   between decode launches, and decode / paged decode at head dim 80,
   G = 1 and at llama4-maverick's head dim 128, G = 5 (paged equal to
   dense bit for bit); a vlm / audio decode step's cross-attention (one
   query row over 1600 patch rows at head dim 128, G = 4, and over 1500
   encoder rows at head dim 64, G = 1, non-causal, fp32 and bf16, every
   block shape) and mixed operands through ``ops`` (a bf16 query over fp32
   K/V, fp32 rows with a bf16 weight and the reverse) against the plain
   versions;
4. serving slice: llama3.2-1b at full width and depth (bf16, seeded random
   weights) through the fixed-batch serve path and through the continuous
   batcher (dense, paged, paged with chunked prefill), with every launch
   counter set to 0 before and read after; prefill and decode logits
   against a plain-version run with the same weights;
4b. training slice: falcon-mamba-7b (8 of 64 layers) and zamba2-2.7b (12
   of 54) at full width, bf16 compute with fp32 AdamW master weights,
   batch 2 x 1024 tokens, 4 steps each through
   ``repro_torch.launch.train``, the counters read after every step (each
   step must launch the scan resp. the SSD, attention and RMSNorm
   kernels); one step with the kernels against the same step under
   ``dispatch.use_mode("ref")`` (2 layers resp. 1 super-block);
4c. the sim-to-real loop: ``make_sim2real_pair`` over llama3.2-1b at full
   width on the card (a 17-request Poisson trace), two interventions on
   the default configuration (the same schedule both times), then, on a
   fresh pair, ``transfer_tune("cameo", ...)`` with the simulator as
   source and trace replays through the batcher as target, traced, with
   the counters set to 0 before and read after; the default's replays,
   the tuning run and the winner's deployment must resolve RMSNorm and
   attention to ``cuda`` only and launch RMSNorm, prefill and decode; one
   line per target measurement, read off the trace (replayed p99 beside
   the simulator's prediction, the round's tuner and replay time); the GP
   surrogate timed on the CPU and the card in turns (3 x 31) against the
   nine-tenths rule; the serve CLI's ``--workload ... --tune-serving 4
   --sim2real-eval`` as a subprocess;
4d. kernel-launch tuning: for three full-width cells (serve llama3.2-1b
   4 x 96; train falcon-mamba-7b and zamba2-2.7b 2 x 1024)
   ``tune_kernel_launch(..., target_backend="wallclock")`` — the analytic
   launch geometry as source, CUDA-event timings of the kernels as target
   — counted and traced; every kernel output at the default and at every
   measured configuration against its plain version on the backend's own
   inputs; the default and the tuned config remeasured in turns beside
   the source's prediction; how many points of each family's launch
   space give distinct launches (shapes only); the tuned configs deployed
   (two train steps of each depth-cut model against ``phase_train``'s
   first two, the tuned values seen by every resolution) and the serve
   CLI's ``--full-config --tune-launch 4 --measure-backend wallclock`` as
   a subprocess; every resolution of the phase ``cuda``;
4e. SSM serving: falcon-mamba-7b (64 layers) and zamba2-2.7b (54) at
   full width and depth, seeded bf16 weights, through the fixed batch and
   the continuous batcher (dense, paged, paged with chunked prefill),
   counted (every resolution ``cuda``, the scan resp. the SSD, prefill,
   decode and paged decode launched, the same tokens in every geometry);
   the fixed batch's logits against a plain-version run; one request's
   prefill time by prompt length, the decode step's launches and a
   profiled decode step; the serve CLI with ``--full-config`` for each;
4f. the compiled decode step (``jitted_steps``' decode captured in a CUDA
   graph; every phase from 4 on serves through it): for llama3.2-1b,
   falcon-mamba-7b and zamba2-2.7b at full width and depth (the models of
   phases 4 and 4e) the fixed batch through the eager and the captured
   step in turns — the same tokens and logits bit for bit, host p50 /
   p99, tok/s, device busy, idle share and kernels a step under the
   profiler, the capture's time and pool — each port kernel's profiled
   calls a replayed step against the launches its capture recorded, the
   launch counters after 10 replays against 10 eager steps', and the
   dense, paged and chunked batchers with the eager step against phases
   4 / 4e's (tokens, order, counters and every step's logits bit for
   bit); a 4-slot graph
   replayed after a 32-slot eager decode grew the split decode's scratch;
   phase 4c's measured replays capture nothing (the captures fall in the
   deployments' warm-ups);
4g. the MoE family and the carried dense configs: deepseek-v3-671b (MLA,
   sigmoid top-8 of 256 experts, shared expert; 2 of 61 layers, no MTP
   head), llama4-maverick-400b-a17b (one super-block, a dense and a
   top-1-of-128 MoE layer, of 24), h2o-danube-1.8b at full size,
   nemotron-4-15b and command-r-35b (8 layers each), every one at its
   published widths with seeded bf16 weights: the fixed batch (counted:
   every resolution ``cuda``, the kernels and the prefill instance of
   each path launched — MLA's 192 / 128), the dense batcher (llama4
   also paged, with the dense batcher's tokens and completion order, and
   chunked), the teacher-forced eager kernel run equal to the served
   logits and held against the plain run (for MoE the expert choices
   compared first: under 1% flipped, every flip in a row that agreed so
   far a near tie of the plain run's router logits, the logits of each
   row held up to its first differing route), danube's 4608-token prompt
   through its 4096-row ring cache (the windowed d 80 prefill), phase 4f's
   compiled decode for each (captured equal to eager bit for bit, host
   p50 / p99, device busy, idle share, kernels a step), each step's
   weight-read floor, peak memory, and the serve CLI at both MoE smoke
   configs;
4h. the vlm and audio families at published widths and full depth:
   llama-3.2-vision-11b (40 layers, a gated cross-attention layer every
   fifth, its gates opened to seeded values) and whisper-large-v3 (32
   encoder and 32 decoder layers), seeded bf16 weights, one after the
   other, the fixed batch with its ``vision_embeds`` (4, 1600, 4096) /
   ``frames`` (4, 1500, 1280) in bf16: counted (RMSNorm, prefill, decode
   and the non-causal prefill instance launched), the teacher-forced
   eager kernel run equal to the served logits and held against the
   plain run; the serve CLI's fp32 inputs (prefill and 4 decode steps,
   kernel against plain, and the captured step timed); phase 4f's
   compiled decode for each, the cross-attention (the prefill kernel at
   one query row) launched inside the graph; each step's weight-read
   floor; the serve CLI with whisper-large-v3 at its full config;
4i. training every family: whisper-large-v3 (32 + 32 layers, 2 x 448
   tokens, fp32 ``frames`` as ``make_data`` gives them),
   llama-3.2-vision-11b (one super-block, 5 of 40 layers, gates opened,
   2 x 1024 with fp32 ``vision_embeds``), deepseek-v3-671b (1 of 61 layers
   and the MTP head, 12 of 256 routed experts, 1 x 1024) and
   llama4-maverick-400b-a17b (one super-block, 4 of 128 experts, 1 x
   1024) at published widths, bf16 compute with fp32 AdamW masters, 3
   steps each through ``repro_torch.launch.train``, counted step by step
   (every resolution ``cuda``, RMSNorm and prefill launched with exactly
   the expected prefill instances, their recompute backwards run; loss,
   ``moe_aux`` and ``mtp_loss`` finite; step p50, tokens/s, peak memory);
   one step with the kernels against the plain step (whisper at 2 + 2
   layers, the others at their training depth; for MoE the expert choices
   first); the fault-tolerant driver on the card (whisper at 4 + 4
   layers, 8 steps, a checkpoint every 3, faults before steps 5 and 8,
   against two unbroken runs: the restored checkpoint bit for bit, peak
   memory across the restarts, the final parameters; a save and a
   restore timed); the train CLI run twice on one ``--ckpt-dir``
   (deepseek-v3-671b and whisper-large-v3 smoke configs), the second run
   resuming;
4j. fleet replay and the data-parallel train path: ``make_sim2real_pair(
   ..., fleet=True, num_devices=8)`` over llama3.2-1b at full width and
   phase 4c's trace, for 2 replicas under each routing policy and 4
   replicas, dense and paged: the router's plan against
   ``FleetSimulator`` built apart, each replica's replay on the shared
   deployment against a plain replay of its sub-trace on a fresh batcher
   (schedule fields and tokens bit for bit), the pooled counters against
   the replicas' reports and against ``intervene`` (exactly, but the
   wall-clock ones; ``slo_violation_rate`` against the share of the
   measured replay's own latencies above the SLO), every resolution
   ``cuda``, no graph captured inside a measured replay; then
   ``transfer_tune("cameo", ...)`` over the fleet knobs (the fleet
   replays' launches counted each just around its ``fleet_replay``, and
   CAMEO's apart); the train loop under an NCCL process group of one rank
   against the plain loop (bit for bit, counted), the train CLI
   (llama3.2-1b, full config, 3 steps of 2 x 512) under
   ``torch.distributed.run`` (its logged loss and gradient norm the plain
   loop's, its step time), and its checkpoint restored through
   ``remesh_state`` on the one-device mesh: the NCCL loop's state bit for
   bit, and its next step gives the unbroken run's loss;
4m. the sharded train and serve steps (``phase_sharded``, run after 4j): four
   thread-ranks of the ``threaded`` process group of
   ``torch.testing._internal.distributed.multi_threaded_pg`` on the one
   card, a (2, 2) ``("data", "model")`` mesh ((1, 4) at tp=4);
   llama3.2-1b at full width and depth, fp32, tp=2 and fsdp=2, with and
   without sequence parallelism (``sp``), 3 steps of 4 x 512 against the
   one-process loop run first (losses within 1e-5 relative, every
   parameter within 1e-5 + 1e-5|p|); falcon-mamba-7b (8 layers) and
   zamba2-2.7b (12 layers) at tp=2, deepseek-v3-671b (1 layer + MTP, 12
   experts, Adafactor) at tp=2 and fsdp=2 with its experts on the model
   axis (with and without ``sp``) and on the data axis,
   llama-3.2-vision-11b (one super-block, 5 of 40 layers, Adafactor) at
   tp=2 with and without ``sp``, whisper-large-v3 (4 + 4 layers) at
   tp=4 with and without ``sp`` (equal losses bit for bit: ``sp`` cuts
   no audio activation), on the train CLI's fp32 stub inputs, 2 steps
   in the model dtype against the one-process loop (phase 4i's
   ``STEP_TOL`` and 1e-4 relative on every rank's losses and grad
   norms); in every run each rank's step-1
   gradient of every leaf the model axis leaves whole (norms, ``w_dkv``,
   the router, Mamba-2's ``w_B`` / ``w_C`` / ``A_log`` ...) against its
   block of one process's (1e-5 in fp32, 5e-2 in bf16, relative in
   norm; in bf16 the vlm gate's against 5e-2 of the root of the sum of
   its products' squares, ``gate_hold``), each rank's step-1 collective
   bytes by kind equal the dry run's trace of rank 0, every
   resolution is ``cuda`` and the kernels launch at the ranks' local
   shapes (prefill at 16 / 4 heads for llama3.2-1b, the vision cross
   attention at 16 / 4 heads over 1600 patch rows, whisper's encoder at
   5 / 5 heads, non-causal, over 1500 frames), RMSNorm at the stream's
   rows (``B S / 2`` under ``sp``); then the prefill and decode steps
   with ``mesh=`` (``SHARDED_SERVE``): llama3.2-1b full, fp32, tp=2 +
   fsdp=2 with and without ``sp`` (4 x 512, 4 decode steps),
   zamba2-2.7b 6 layers, bf16, tp=2 (4 x 512, 8), deepseek-v3-671b one
   MoE layer of 12 experts, fp32, tp=2 + fsdp=2 (4 x 256, 8), each rank
   teacher-forced with one process's greedy tokens: logits against one
   process's (fp32 within 1e-5 + 1e-5 x the row's largest |logit|,
   tokens equal; bf16 by phase 4f's rule, under 2% of the tokens flipped,
   each at a near tie), the bytes of the prefill and of every decode
   step equal to the dry run's trace of rank 0's prefill and decode,
   every resolution ``cuda``, the kernels at the local shapes (decode at
   16 / 4 heads for llama3.2-1b, the SSD at 40 of zamba2's 80 heads);
4k. the dry run against the card: ``repro_torch.launch.dryrun``'s
   ``dryrun_cell`` on three llama3.2-1b cells under the plan the port
   executes (``tp=1,fsdp=1`` on a data-only mesh: ``decode_32k`` and
   ``prefill_32k`` at ``16x1``, ``train_4k`` at ``128x1``), then one data
   rank's real step on the card from seeded weights (8 slots over a
   32768-row cache, 2 x 32768, 2 x 4096): the dry run's kernel scopes by
   family equal the step's launches and its ``<name>_bwd`` scopes the
   recompute backwards, its argument bytes equal the real arguments'
   exactly; its peak beside ``max_memory_allocated``, the step's device
   time (CUDA events) against the roofline bound at the H100's constants,
   the dry run's seconds, the eager decode step's host p50 with the
   scopes against a bare call in turns and one scope call's host ns
   against the direct call, and one ``CompiledPerfEnv``
   intervention timed (run before phase 4, on the emptied card);
4l. the static analysis against the card (``phase_analysis``, run right
   after 4k): the analysis's sm_90 limits (opt-in shared bytes a block,
   registers an SM, threads a block) against
   ``torch.cuda.get_device_properties`` where this torch exposes them;
   ``python -m repro_torch.analysis --gate --ptxas <build>/ptxas.log
   src/repro_torch`` as a subprocess, exit 0; every config of every
   family's launch domain (87 in all), in fp32 and bf16, at the shape of
   the registry's set with the most shared bytes, launched twice under
   ``torch.profiler`` with its outputs NaN-filled first: each kernel
   event's grid, block and shared bytes equal to the analysis's launch
   record and its registers to the ptxas report (names matched through
   ``cu++filt``, which must spell every ptxas symbol as the analysis's
   ``instance_name`` does), no NaN left, the plain version's values within
   phase 3's tolerances, the two launches bit for bit; a record with its
   shared bytes off by 16 must fail the same holder;
5. timings: each kernel, its plain version and the one-call PyTorch
   yardstick where one exists, timed with CUDA events at the slices'
   shapes, beside the card's bound for the same work; RMSNorm also at the
   decode rows and both training shapes, prefill at a long prompt
   (1 x 2048), at MLA's head dims (1 x 2048, 128 heads, 192 / 128) and at
   the vlm and audio shapes (a cross-attention decode step and prompt over
   1600 rows, whisper's 1500 x 1500 encoder, non-causal),
   decode at 32 slots over 2048-row caches, the scan at the
   plan the falcon-mamba train step launched (its launch options recorded
   in phase 4b), with a sweep of channels a block and chunk and the SM
   clock sampled under load; the scan and the SSD at serving's fixed
   batch (4 x 64) with and without the final state;
6. profiles: device time by kernel over a few decode steps of the fixed
   batch (no more launches per step than before the split decode; RMSNorm's
   time per step), and over one train step of each training model (with
   the share of the recompute backwards and the scan's, SSD's and
   RMSNorm's kernel time; each kernel of the step must show device time
   under its symbol), and the device's busy share.

Prints the kernel table, the serving, training, sim-to-real,
kernel-launch tuning, SSM, MoE, vlm / audio serving, every family's
training, fleet, distributed, sharded, dry-run and analysis summaries as
JSON lines, and, as the last line,
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
without that line.  Without a CUDA card, or
outside a checkout, it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}  # (atol, rtol)

ARCH = "llama3.2-1b"
SERVE_KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
                 "paged_decode_attention")
FIXED = dict(batch=4, prompt_len=64, gen=32)
LOGIT_STEPS = 5  # prefill + the first 4 decode steps


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _strict_json(obj):
    """``obj`` with every non-finite float as None, so each printed line is
    standard JSON (an infeasible measurement's y is inf)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _strict_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strict_json(v) for v in obj]
    return obj


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _rand(torch, gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _compare(torch, name, out, ref, dtype_name, errs, main, tol=None):
    atol, rtol = tol or TOL[dtype_name]
    o, r = out.float(), ref.float()
    check(bool(torch.isfinite(o).all()), f"{name}: non-finite kernel output")
    err = (o - r).abs()
    bad = err > atol + rtol * r.abs()
    check(not bool(bad.any()),
          f"{name}: {int(bad.sum())} elements off, max |err| "
          f"{float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    if main:
        errs.append(float(err.max()))
    return float(err.max())


def phase_kernels(torch, dev):
    from repro_torch.kernels.flash_attention.kernel import (
        decode_attention_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        attention_blockwise_ref, decode_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_decode_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.kernels.rmsnorm.kernel import (WARPS_PER_ROW,
                                                    plan_rmsnorm,
                                                    rmsnorm_cuda)
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    mla_gen = torch.Generator(device=dev).manual_seed(16)
    errs = {k: [] for k in ("rmsnorm", "flash_attention", "decode_attention",
                            "paged_decode_attention")}
    n_cases = 0
    plans = set()
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        # -- rmsnorm: prefill rows, decode rows, batcher prompt, the
        #    training rows of zamba2-2.7b (2560) and falcon-mamba-7b (4096)
        #    and a 4-row decode case at each width, 8192, edges (an odd
        #    width, and an unaligned view: element by element)
        for shape, res, main in (((4, 64, 2048), False, True),
                                 ((4, 1, 2048), False, True),
                                 ((1, 200, 2048), False, True),
                                 ((2, 1024, 2560), False, True),
                                 ((4, 1, 2560), False, False),
                                 ((2, 1024, 4096), False, True),
                                 ((4, 1, 4096), True, False),
                                 ((16, 8192), False, False),
                                 ((4, 1, 8192), True, False),
                                 ((4, 64, 2048), True, False),
                                 ((3, 17, 64), True, False),
                                 ((5, 100), False, False),
                                 ((4, 2048, "unaligned"), False, False)):
            if shape[-1] == "unaligned":
                shape = shape[:-1]
                n = shape[0] * shape[1]
                x = _rand(torch, gen, (n + 1,), dt, dev)[1:].view(shape)
            else:
                x = _rand(torch, gen, shape, dt, dev)
            w = _rand(torch, gen, shape[-1:], dt, dev)
            r = _rand(torch, gen, shape, dt, dev) if res else None
            vec = 16 // x.element_size()
            aligned = shape[-1] % vec == 0 and x.data_ptr() % 16 == 0
            for rb in ((1, 4, 8) if main else (4,)):
                plans.add(plan_rmsnorm(x.numel() // shape[-1], shape[-1],
                                       x.element_size(), aligned, rb))
                out = rmsnorm_cuda(x, w, eps=1e-5, residual=r, row_block=rb)
                ref = rmsnorm_ref(x, w, eps=1e-5, residual=r)
                _compare(torch, f"rmsnorm {shape} res={res} {dn}", out, ref,
                         dn, errs["rmsnorm"], main)
                n_cases += 1
        # -- prefill attention
        for (b, sq, skv, hq, hkv, d, kw, main) in (
                (4, 64, 64, 32, 8, 64, {}, True),
                (1, 200, 200, 32, 8, 64, {}, True),
                (2, 96, 96, 8, 2, 32, {}, False),
                (1, 33, 65, 4, 1, 16, {"causal": False}, False),
                (1, 33, 65, 4, 1, 16, {}, False),
                (2, 48, 48, 4, 2, 16, {"sliding_window": 7}, False),
                (2, 48, 48, 4, 2, 16, {"logit_softcap": 20.0}, False),
                (2, 48, 48, 4, 2, 16,
                 {"sliding_window": 9, "logit_softcap": 30.0}, False),
                (1, 16, 48, 4, 2, 64, {"q_offset": 32}, False),
                (1, 70, 70, 4, 4, 128, {}, False),
                # head dim 80: zamba2-2.7b's shared attention at its
                # training shape (32 q / 32 kv heads), GQA G=4, ragged
                (2, 1024, 1024, 32, 32, 80, {}, True),
                (1, 200, 200, 32, 8, 80, {}, False),
                (1, 77, 77, 8, 8, 80, {}, False)):
            q = _rand(torch, gen, (b, sq, hq, d), dt, dev)
            k = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
            v = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
            ref = attention_blockwise_ref(q, k, v, kv_block=64, **kw)
            for qb, kb in (((32, 32), (64, 64), (128, 64)) if main
                           else ((64, 64), (32, 32))):
                out = flash_attention_cuda(q, k, v, q_block=qb, kv_block=kb,
                                           **kw)
                _compare(torch, f"flash_attention {(b, sq, skv, hq, hkv, d)} "
                         f"{kw} q{qb}/kv{kb} {dn}", out, ref, dn,
                         errs["flash_attention"], main)
                n_cases += 1
        # -- MLA prefill: V narrower than Q/K, causal and not (its own
        #    generator, so the cases below see the data they always saw)
        for (b, sq, skv, hq, hkv, d, dv, kw) in MLA_PREFILL_CASES:
            q = _rand(torch, mla_gen, (b, sq, hq, d), dt, dev)
            k = _rand(torch, mla_gen, (b, skv, hkv, d), dt, dev)
            v = _rand(torch, mla_gen, (b, skv, hkv, dv), dt, dev)
            ref = attention_blockwise_ref(q, k, v, kv_block=64, **kw)
            for qb, kb in ((64, 64), (32, 32)):
                out = flash_attention_cuda(q, k, v, q_block=qb, kv_block=kb,
                                           **kw)
                check(tuple(out.shape) == (b, sq, hq, dv),
                      f"flash_attention d{d}/dv{dv}: output "
                      f"{tuple(out.shape)}")
                _compare(torch, f"flash_attention {(b, sq, skv, hq, hkv)} "
                         f"d{d}/dv{dv} {kw} q{qb}/kv{kb} {dn}", out, ref, dn,
                         errs["flash_attention"], False)
                n_cases += 1
        # -- dense decode: fixed-batch cache, batcher cache (one empty slot
        #    whose length ran past the cache), window / softcap edges
        for (b, skv, hq, hkv, d, lens, kw, main) in (
                (4, 96, 32, 8, 64, [65, 80, 96, 70], {}, True),
                (4, 512, 32, 8, 64, [217, 17, 600, 130], {}, True),
                (2, 80, 8, 2, 32, [13, 77], {"sliding_window": 9}, False),
                (2, 80, 8, 2, 32, [13, 77], {"logit_softcap": 20.0}, False),
                (3, 40, 4, 4, 16, [1, 40, 23], {}, False)):
            q = _rand(torch, gen, (b, 1, hq, d), dt, dev)
            kc = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
            vc = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            ref = decode_attention_ref(q, kc, vc, ln, **kw)
            for kb in (32, 64):
                out = decode_attention_cuda(q, kc, vc, ln, kv_block=kb, **kw)
                _compare(torch, f"decode_attention {(b, skv, hq, hkv, d)} "
                         f"{lens} {kw} kv{kb} {dn}", out, ref, dn,
                         errs["decode_attention"], main)
                n_cases += 1
        # -- paged decode: a permuted pool, unused table entries on the
        #    scratch page, one parked slot past its capacity; and the same
        #    rows through the dense kernel, bit for bit
        for (ps, pages_max, pool, lens, cap, main) in (
                (64, 8, 64, [217, 17, 600, 130], 0.0, True),
                (64, 8, 64, [217, 17, 600, 130], 30.0, False),
                (16, 4, 12, [5, 64, 33], 0.0, False)):
            b, hq, hkv, d = len(lens), 32, 8, 64
            kp = _rand(torch, gen, (pool + 1, ps, hkv, d), dt, dev)
            vp = _rand(torch, gen, (pool + 1, ps, hkv, d), dt, dev)
            perm = torch.randperm(pool, generator=gen, device=dev)
            table = torch.full((b, pages_max), pool, dtype=torch.int32,
                               device=dev)
            used = 0
            for i, n in enumerate(lens):
                need = min(-(-n // ps), pages_max) if n <= ps * pages_max else 0
                table[i, :need] = perm[used:used + need].to(torch.int32)
                used += need
            q = _rand(torch, gen, (b, 1, hq, d), dt, dev)
            ln = torch.tensor(lens, dtype=torch.int32, device=dev)
            ref = paged_decode_attention_ref(q, kp, vp, table, ln,
                                             logit_softcap=cap)
            out = paged_decode_attention_cuda(q, kp, vp, table, ln,
                                              logit_softcap=cap)
            _compare(torch, f"paged_decode_attention ps{ps} {lens} cap{cap} "
                     f"{dn}", out, ref, dn, errs["paged_decode_attention"],
                     main)
            dense_k = kp[table.long()].reshape(b, pages_max * ps, hkv, d)
            dense_v = vp[table.long()].reshape(b, pages_max * ps, hkv, d)
            dense = decode_attention_cuda(q, dense_k.contiguous(),
                                          dense_v.contiguous(), ln,
                                          logit_softcap=cap, kv_block=64)
            check(torch.equal(out, dense),
                  f"paged vs dense decode differ (ps{ps} {lens} {dn}): max "
                  f"{float((out.float() - dense.float()).abs().max()):.3e}")
            n_cases += 2
    torch.cuda.synchronize()
    reached = {p.warps_per_row for p in plans}
    check(reached == set(WARPS_PER_ROW) and
          {p.vectorized for p in plans} == {True, False},
          f"rmsnorm: the cases reached warps per row {sorted(reached)} and "
          f"vectorized {sorted({p.vectorized for p in plans})}; every plan "
          f"the planner can choose must be reached")
    log(f"rmsnorm plans reached: {sorted(set(p[:3] for p in plans))} "
        f"(warps per row, rows per block, slots)")
    return {k: max(v) for k, v in errs.items()}, n_cases


# --------------------------------------------------------------------------
# phase 3 (continued): the redesigned attention kernels at their edges — the
# bf16 tensor-core prefill at every instantiated head dim and block shape,
# and the split decode where the split matters
# --------------------------------------------------------------------------

# MLA prefill (b, sq, skv, hq, hkv, d, dv, kwargs): deepseek-v3-671b's head
# dims (q/k 192 = 128 + 64 rope, v 128) and its smoke config's (16, 8),
# causal and not, ragged
MLA_PREFILL_CASES = (
    (2, 96, 96, 8, 8, 192, 128, {}),
    (1, 77, 130, 4, 4, 192, 128, {"causal": False}),
    (2, 77, 77, 4, 4, 16, 8, {}),
    (1, 50, 33, 4, 4, 16, 8, {"causal": False}),
)

# (b, sq, skv, hq, hkv, kwargs): causal and ragged; non-causal Skv != Sq;
# q_offset positive (a chunk of a longer prompt) and negative (its first
# rows see nothing and give 0); window with softcap
PREFILL_EDGE_CASES = (
    (2, 77, 77, 8, 2, {}),
    (1, 77, 200, 8, 2, {"causal": False}),
    (1, 37, 77, 8, 2, {"q_offset": 40}),
    (2, 50, 50, 8, 8, {"q_offset": -20}),
    (1, 200, 200, 8, 2, {"sliding_window": 13, "logit_softcap": 20.0}),
)
PREFILL_BLOCKS = tuple((qb, kb) for qb in (32, 64) for kb in (32, 64))
# a vlm / audio decode step's cross-attention: one query row a slot over
# llama-3.2-vision-11b's 1600 patch rows (32 / 8 heads of 128) and
# whisper-large-v3's 1500 encoder rows (20 / 20 heads of 64), non-causal
# (b, sq, skv, hq, hkv, d)
CROSS_DECODE_CASES = ((4, 1, 1600, 32, 8, 128), (4, 1, 1500, 20, 20, 64))
# the other non-causal shapes of phase 4h's main path, in bf16: whisper's
# 1500 x 1500 encoder self-attention and the vision model's cross-attention
# at the 64-token prefill; at every block pair and at the serving blocks
CROSS_PREFILL_CASES = ((4, 1500, 1500, 20, 20, 64), (4, 64, 1600, 32, 8, 128))
# 16 slots over 4096-row caches (64 pages of 64): lengths 0, 1, on and just
# past the first split boundary, the capacity, past it, and ragged others
DECODE_SPLIT_SHAPE = dict(b=16, skv=4096, hq=32, hkv=8, d=64, ps=64)


def phase_attention_edges(torch, dev):
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention.kernel import (
        PREFILL_HEAD_DIMS, decode_attention_cuda, flash_attention_cuda,
        plan_decode_splits)
    from repro_torch.kernels.flash_attention.ref import (
        attention_blockwise_ref, decode_attention_ref,
        decode_attention_split_ref)
    from repro_torch.kernels.paged_attention.kernel import (
        KV_TILE, paged_decode_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import gather_pages
    from repro_torch.utils.config import ParallelConfig

    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    worst = []  # edge cases: checked, not reported as the slices' errors
    n_cases = 0
    for d, dv in PREFILL_HEAD_DIMS:
        for (b, sq, skv, hq, hkv, kw) in PREFILL_EDGE_CASES:
            q = _rand(torch, gen, (b, sq, hq, d), bf, dev)
            k = _rand(torch, gen, (b, skv, hkv, d), bf, dev)
            v = _rand(torch, gen, (b, skv, hkv, dv), bf, dev)
            ref = attention_blockwise_ref(q, k, v, kv_block=64, **kw)
            for qb, kb in PREFILL_BLOCKS:
                out = flash_attention_cuda(q, k, v, q_block=qb, kv_block=kb,
                                           **kw)
                _compare(torch, f"flash_attention (tensor cores) d{d}/dv{dv} "
                         f"{(b, sq, skv, hq, hkv)} {kw} q{qb}/kv{kb}", out,
                         ref, "bfloat16", worst, False)
                if kw.get("q_offset", 0) < 0:
                    dead = -kw["q_offset"]
                    check(bool((out[:, :dead] == 0).all()),
                          f"flash_attention d{d} q{qb}/kv{kb}: fully masked "
                          f"rows are not 0")
                n_cases += 1

    par = ParallelConfig()
    serving = ((par.attn_q_block, par.attn_kv_block),)
    for cases, dtypes, blocks in (
            (CROSS_DECODE_CASES, (torch.float32, bf), PREFILL_BLOCKS),
            (CROSS_PREFILL_CASES, (bf,), PREFILL_BLOCKS + serving)):
        for (b, sq, skv, hq, hkv, d) in cases:
            for dt in dtypes:
                dn = str(dt).split(".")[1]
                q = _rand(torch, gen, (b, sq, hq, d), dt, dev)
                k = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
                v = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
                ref = attention_blockwise_ref(q, k, v, causal=False,
                                              kv_block=64)
                for qb, kb in blocks:
                    out = flash_attention_cuda(q, k, v, causal=False,
                                               q_block=qb, kv_block=kb)
                    _compare(torch, f"flash_attention non-causal "
                             f"{(b, sq, skv, hq, hkv, d)} q{qb}/kv{kb} {dn}",
                             out, ref, dn, worst, False)
                    n_cases += 1
    n_cases += _mixed_dtype_ops(torch, gen, dev, worst)

    sh = DECODE_SPLIT_SHAPE
    b, skv, hq, hkv, d, ps = (sh[k] for k in ("b", "skv", "hq", "hkv", "d",
                                              "ps"))
    n_split, rows = plan_decode_splits(skv, KV_TILE, b, hkv,
                                       cuda_lib.sm_count(dev))
    check(n_split > 1, f"decode at {sh}: the plan does not split "
          f"({n_split} x {rows})")
    lens = [0, 1, rows, rows + 1, skv, skv + 904, 17, 3001, 2048, 640, 95,
            4000, 1500, 2222, 64, 3333]
    n_pages = skv // ps
    for dt in (torch.float32, bf):
        dn = str(dt).split(".")[1]
        q = _rand(torch, gen, (b, 1, hq, d), dt, dev)
        kc = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
        vc = _rand(torch, gen, (b, skv, hkv, d), dt, dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        for kw in ({}, {"sliding_window": 1000}, {"logit_softcap": 30.0}):
            out = decode_attention_cuda(q, kc, vc, ln, kv_block=KV_TILE,
                                        **kw)
            # the split oracle covers every slot (an empty one gives 0);
            # the one-pass oracle every slot with a visible row
            split = decode_attention_split_ref(q, kc, vc, ln,
                                               split_rows=rows, **kw)
            _compare(torch, f"decode_attention {sh} split {n_split} x {rows} "
                     f"{kw} {dn}", out, split, dn, worst, False)
            ref = decode_attention_ref(q, kc, vc, ln, **kw)
            _compare(torch, f"decode_attention {sh} {kw} {dn} (slots with "
                     f"rows)", out[1:], ref[1:], dn, worst, False)
            check(bool((out[0] == 0).all()),
                  f"decode_attention: the empty slot is not 0 ({dn})")
            n_cases += 2
        # paged: a permuted pool plus a scratch page; the parked slot (past
        # its capacity) points at the scratch page only
        pool = b * n_pages
        kp = torch.cat([kc.reshape(pool, ps, hkv, d),
                        torch.zeros((1, ps, hkv, d), dtype=dt, device=dev)])
        vp = torch.cat([vc.reshape(pool, ps, hkv, d),
                        torch.zeros((1, ps, hkv, d), dtype=dt, device=dev)])
        perm = torch.randperm(pool, generator=gen, device=dev)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(pool, device=dev)
        kp[:pool], vp[:pool] = kp[perm].clone(), vp[perm].clone()
        table = inv.to(torch.int32).reshape(b, n_pages)
        for i, n in enumerate(lens):
            if n > skv:
                table[i] = pool
        for cap in (0.0, 30.0):
            out = paged_decode_attention_cuda(q, kp, vp, table, ln,
                                              logit_softcap=cap)
            gk, gv = gather_pages(kp, table), gather_pages(vp, table)
            split = decode_attention_split_ref(q, gk, gv, ln, split_rows=rows,
                                               logit_softcap=cap)
            _compare(torch, f"paged_decode_attention {sh} cap{cap} {dn}", out,
                     split, dn, worst, False)
            dense = decode_attention_cuda(q, gk.contiguous(), gv.contiguous(),
                                          ln, logit_softcap=cap,
                                          kv_block=KV_TILE)
            check(torch.equal(out, dense),
                  f"paged vs dense decode differ at {sh} cap{cap} {dn}: max "
                  f"{float((out.float() - dense.float()).abs().max()):.3e}")
            n_cases += 2
    torch.cuda.synchronize()
    return n_cases


def _mixed_dtype_ops(torch, gen, dev, worst):
    """The stub frontends' fp32 inputs in a bf16 model, through ``ops``
    (which casts the operands to the widest dtype, so the fp32 kernels
    run, and returns the query's / the rows' dtype) against the plain
    versions on the same mixed inputs: a bf16 query over fp32 K/V at the
    vision model's cross shapes (one row and the 64-token prompt), and
    fp32 rows with a bf16 weight (whisper's encoder norms over fp32
    frames).  Counted: each call launches its kernel once."""
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_blockwise_ref)
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    n = 0
    for sq in (1, 64):
        q = _rand(torch, gen, (4, sq, 32, 128), torch.bfloat16, dev)
        k, v = (_rand(torch, gen, (4, 1600, 8, 128), torch.float32, dev)
                for _ in range(2))
        cuda_lib.reset_launches()
        out = ops.flash_attention(q, k, v, causal=False)
        check(out.dtype == torch.bfloat16 and
              cuda_lib.PREFILL_INSTANCES == {(128, 128, False, False): 1},
              f"mixed flash_attention: {out.dtype}, instances "
              f"{cuda_lib.PREFILL_INSTANCES}")
        _compare(torch, f"ops.flash_attention q bf16 / k, v fp32 sq {sq}",
                 out, attention_blockwise_ref(q, k, v, causal=False),
                 "bfloat16", worst, False)
        n += 1
    for x_dt, w_dt in ((torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.float32)):
        x = _rand(torch, gen, (4, 1500, 1280), x_dt, dev)
        w = _rand(torch, gen, (1280,), w_dt, dev)
        cuda_lib.reset_launches()
        y = ops.rmsnorm(x, w)
        dn = str(x_dt).split(".")[1]
        check(y.dtype == x_dt and cuda_lib.LAUNCHES["rmsnorm"] == 1,
              f"mixed rmsnorm: {y.dtype}, {cuda_lib.LAUNCHES['rmsnorm']} "
              f"launches")
        _compare(torch, f"ops.rmsnorm x {dn} / weight "
                 f"{str(w_dt).split('.')[1]}", y, rmsnorm_ref(x, w), dn,
                 worst, False)
        n += 1
    cuda_lib.reset_launches()
    return n


# --------------------------------------------------------------------------
# phase 3 (continued): the SSM kernels against their plain versions, and
# each autograd-wrapped op's gradient on the card
# --------------------------------------------------------------------------

# (b, l, c, n, chunk, c_block, dt_scale, main): the slice's falcon-mamba-7b
# shape with the train step's options (the config's TPU-sized chunk 256,
# the family's c_block 64) and with others, L not a multiple of chunk, L =
# 1, C not a multiple of the block nor of 8 (element-by-element staging of
# x and y), N = 4 (element-by-element B and C in bf16), 8, 24 (masked
# state slots), 64, 128, and dt * A down to -80 (decays that underflow)
# within a chunk and across 16 chunks at the slice's width.  Between them
# they reach every lanes-per-channel choice of the planner (1 to 32).
SCAN_CASES = (
    (2, 1024, 8192, 16, 256, 64, 0.1, True),
    (2, 1024, 8192, 16, 256, 512, 0.1, True),
    (2, 1024, 8192, 16, 64, 32, 0.1, True),
    (2, 1000, 8192, 16, 256, 64, 5.0, False),
    (4, 130, 8190, 16, 64, 64, 0.1, False),
    (1, 300, 12004, 16, 64, 64, 0.1, False),
    (3, 1, 72, 16, 64, 64, 0.1, False),
    (1, 50, 24, 16, 32, 8, 0.1, False),
    (2, 100, 200, 64, 32, 64, 0.1, False),
    (1, 77, 130, 16, 16, 128, 5.0, False),
    (2, 33, 40, 4, 16, 16, 0.1, False),
    (1, 64, 96, 8, 64, 64, 0.1, False),
    (2, 90, 500, 24, 64, 64, 0.1, False),
    (1, 40, 70, 128, 16, 32, 0.1, False),
)
# (b, l, h, p, g, n, chunk, dt_scale, main): zamba2-2.7b's shape (chunk 256
# snaps to 64), ragged L, G in {1, 2, 4}, N in {16, 64}, large dt * A (in
# one chunk and across 19 chunks of 16), a long chain (128 chunks on one
# (b, h) pair), many pairs with few chunks (512 pairs x 2), and N 8 / P 24,
# which bf16 takes through the SIMT kernel
SSD_CASES = (
    (2, 1024, 80, 64, 1, 64, 256, 0.1, True),
    (1, 100, 8, 64, 2, 64, 64, 0.1, False),
    (2, 70, 8, 32, 4, 16, 32, 0.1, False),
    (1, 45, 4, 80, 1, 16, 16, 0.1, False),
    (1, 64, 4, 64, 1, 64, 64, 5.0, False),
    (2, 129, 6, 16, 2, 16, 32, 0.1, False),
    (1, 300, 4, 64, 1, 64, 16, 5.0, False),
    (1, 8192, 1, 64, 1, 64, 64, 0.1, False),
    (8, 128, 64, 64, 1, 64, 64, 0.1, False),
    (1, 40, 4, 24, 1, 8, 16, 0.1, False),
)


# The SSD's decays are exp(cum_t - cum_s) of running sums cum of dt * A,
# in the plain version as in the kernel.  With dt * A near -20 per step the
# sums reach ~1e3 within a 64-step chunk, so each carries ~1e3 * 2^-24 =
# 6e-5 of rounding, and the two sum in different orders: decayed terms
# differ by ~1e-4 relative, and a sum of them that nearly cancels by more.
# The fp32 tolerance of those cases is set by that, not by the kernel.
LARGE_DECAY_TOL = (2e-3, 2e-3)

# The tensor-core SSD against its rounding-faithful plain version
# (ssd_tensor_core_ref), which rounds where the kernel rounds: the two
# differ by the order of fp32 sums and by the exponentials, which can move
# a bf16 output by one step (2^-8 relative, up to 2^-7 of the value), and
# by fp32 noise near zero.
FAITHFUL_TOL = (1e-3, 1e-2)


def scan_inputs(torch, gen, b, l, c, n, dt_scale, dtype, dev):
    x = _rand(torch, gen, (b, l, c), dtype, dev)
    dt = (torch.rand((b, l, c), generator=gen, device=dev) * dt_scale
          ).to(dtype)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(
        c, n).contiguous()
    Bm = _rand(torch, gen, (b, l, n), dtype, dev)
    Cm = _rand(torch, gen, (b, l, n), dtype, dev)
    D = _rand(torch, gen, (c,), torch.float32, dev)
    return x, dt, A, Bm, Cm, D


def ssd_inputs(torch, gen, b, l, h, p, g, n, dt_scale, dtype, dev):
    x = _rand(torch, gen, (b, l, h, p), dtype, dev)
    dt = (torch.rand((b, l, h), generator=gen, device=dev) * dt_scale
          ).to(dtype)
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    Bm = _rand(torch, gen, (b, l, g, n), dtype, dev)
    Cm = _rand(torch, gen, (b, l, g, n), dtype, dev)
    D = _rand(torch, gen, (h,), torch.float32, dev)
    return x, dt, A, Bm, Cm, D


def phase_ssm_kernels(torch, dev):
    from repro_torch.kernels.ssd.kernel import ssd_cuda, ssd_route
    from repro_torch.kernels.ssd.ref import ssd_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    errs = {"selective_scan": [], "ssd": []}
    faithful = []
    plans = set()
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        n_cases += _scan_cases(torch, gen, dt, dev, errs["selective_scan"],
                               plans)
        for (b, l, h, p, g, n, chunk, scale, main) in SSD_CASES:
            a = ssd_inputs(torch, gen, b, l, h, p, g, n, scale, dt, dev)
            ref = ssd_ref(*a, chunk=64)
            out = ssd_cuda(*a, chunk=chunk)
            tol = LARGE_DECAY_TOL if scale > 1 and dn == "float32" else None
            name = f"ssd {(b, l, h, p, g, n)} chunk {chunk} dt*{scale} {dn}"
            _compare(torch, name, out, ref, dn, errs["ssd"], main, tol)
            n_cases += 1
            q = min(chunk, 64)
            if ssd_route(a[0], a[3], a[4], q) == "mma":
                n_cases += _check_tensor_core_ssd(torch, name, a, q, out,
                                                  faithful)
    # bf16 x, B, C with fp32 dt (a bf16 model's fp32 dt_bias): the
    # tensor-core route, no widening
    a = list(ssd_inputs(torch, gen, 2, 1024, 80, 64, 1, 64, 0.1,
                        torch.bfloat16, dev))
    a[1] = torch.rand((2, 1024, 80), generator=gen, device=dev) * 0.1
    check(ssd_route(a[0], a[3], a[4], 64) == "mma",
          "ssd: bf16 x/B/C with fp32 dt left the tensor-core route")
    out = ssd_cuda(*a, chunk=256)
    name = "ssd bf16 x/B/C, fp32 dt"
    _compare(torch, name, out, ssd_ref(*a, chunk=64), "bfloat16",
             errs["ssd"], False)
    n_cases += 1 + _check_tensor_core_ssd(torch, name, a, 64, out, faithful)
    n_cases += _scan_mixed_and_unaligned(torch, gen, dev,
                                         errs["selective_scan"], plans)
    _check_scan_plans(plans)
    torch.cuda.synchronize()
    log(f"tensor-core SSD against its rounding-faithful plain version: max "
        f"|err| {max(faithful):.3e} (atol {FAITHFUL_TOL[0]}, rtol "
        f"{FAITHFUL_TOL[1]}); bit for bit across repeated launches")
    out = {k: max(v) for k, v in errs.items()}
    out["ssd_faithful"] = max(faithful)
    return out, n_cases


def _scan_check(torch, name, a, chunk, cb, dn, errs, main, plans):
    """One scan case: the kernel against the plain version, and a second
    launch on the same inputs bit for bit; records the plan launched."""
    from repro_torch.kernels.mamba_scan.kernel import (
        plan_scan, selective_scan_cuda, storage_size)
    from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref

    b, l, c = a[0].shape
    plan = plan_scan(b, l, c, a[2].shape[1], storage_size(*a[:2], *a[3:5]),
                     chunk, cb)
    plans.add(plan)
    ref = selective_scan_chunked_ref(*a, chunk=64)
    out = selective_scan_cuda(*a, chunk=chunk, c_block=cb)
    name = (f"{name} (lanes {plan.lanes}, channels {plan.channels}, chunk "
            f"{plan.chunk})")
    _compare(torch, name, out, ref, dn, errs, main)
    again = selective_scan_cuda(*a, chunk=chunk, c_block=cb)
    check(torch.equal(out, again), f"{name}: two launches differ, max "
          f"{float((out.float() - again.float()).abs().max()):.3e}")
    return 2


def _scan_cases(torch, gen, dtype, dev, errs, plans):
    dn = str(dtype).split(".")[1]
    n_cases = 0
    for (b, l, c, n, chunk, cb, scale, main) in SCAN_CASES:
        a = scan_inputs(torch, gen, b, l, c, n, scale, dtype, dev)
        n_cases += _scan_check(
            torch, f"selective_scan {(b, l, c, n)} chunk {chunk} c_block "
            f"{cb} dt*{scale} {dn}", a, chunk, cb, dn, errs, main, plans)
    return n_cases


def _scan_mixed_and_unaligned(torch, gen, dev, errs, plans):
    """bf16 x, B, C with fp32 dt (widened to fp32 storage, bf16 y), and
    bf16 inputs at an address that is not 16-byte aligned (staged element
    by element)."""
    b, l, c, n = 2, 200, 1024, 16
    a = list(scan_inputs(torch, gen, b, l, c, n, 0.1, torch.bfloat16, dev))
    a[1] = torch.rand((b, l, c), generator=gen, device=dev) * 0.1
    n_cases = _scan_check(torch, "selective_scan bf16 x/B/C, fp32 dt", a,
                          64, 64, "bfloat16", errs, False, plans)
    a = list(scan_inputs(torch, gen, b, l, c, n, 0.1, torch.bfloat16, dev))
    for i in (0, 1):
        store = torch.empty(a[i].numel() + 1, dtype=a[i].dtype, device=dev)
        a[i] = store[1:].view(a[i].shape).copy_(a[i])
        check(a[i].data_ptr() % 16 != 0, "unaligned scan input is aligned")
    return n_cases + _scan_check(torch, "selective_scan unaligned x/dt", a,
                                 64, 64, "bfloat16", errs, False, plans)


def _check_scan_plans(plans):
    """Every lanes-per-channel choice the planner can make (every
    instantiation of the kernel) was launched."""
    from repro_torch.kernels.mamba_scan.kernel import MAX_LANES

    reached = {p.lanes for p in plans}
    every = {1 << i for i in range(MAX_LANES.bit_length())}
    check(reached >= every, f"selective_scan: the cases reached lanes per "
          f"channel {sorted(reached)}, not every choice {sorted(every)}")
    log(f"selective_scan plans reached (lanes, channels, chunk): "
        f"{sorted({(p.lanes, p.channels, p.chunk) for p in plans})}")


def _check_tensor_core_ssd(torch, name, a, q, out, faithful):
    """The tensor-core SSD's output ``out`` against the rounding-faithful
    plain version, and a second launch on the same inputs bit for bit
    (which also shows the ticket and the flags ready for it)."""
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ref import ssd_tensor_core_ref

    ref = ssd_tensor_core_ref(*a, chunk=q)
    _compare(torch, f"{name} vs the rounding-faithful version", out, ref,
             "bfloat16", faithful, True, FAITHFUL_TOL)
    again = ssd_cuda(*a, chunk=q)
    check(torch.equal(out, again), f"{name}: two launches differ, max "
          f"{float((out.float() - again.float()).abs().max()):.3e}")
    return 2


# phase 3 (continued): what SSM serving launches — the final-state scan and
# SSD (and the SSD's initial state) at the prefill lengths of the kernels'
# edges at batch 1 (one step; inside, one short of, at and one past a
# 64-step chunk; several chunks) and at the fixed batch (4, 64), at
# falcon-mamba-7b's and zamba2-2.7b's widths; decode and paged decode at
# zamba2-2.7b's shared attention (32 / 32 heads, G = 1, head dim 80) and
# at llama4-maverick's (40 / 8 heads, G = 5, head dim 128)
STATE_LENGTHS = ((1, 1), (1, 17), (1, 63), (1, 64), (1, 65), (1, 200),
                 (4, 64))


def phase_ssm_state_kernels(torch, dev):
    """Each final-state case against the plain version (y and the state at
    the dtype's tolerance), y equal bit for bit to the same launch without
    the state; the tensor-core SSD also against its rounding-faithful
    version (y and state); a run of SSD prefills of other lengths queued
    between decode launches without a synchronize, checked after (no
    stale chain flag); decode and paged decode at head dim 80 (G 1) and
    128 (G 5).  Returns
    the largest errors and the number of cases."""
    from repro_torch.kernels.flash_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import decode_attention_ref
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref
    from repro_torch.kernels.paged_attention.kernel import (
        paged_decode_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.kernels.ssd.kernel import ssd_cuda, ssd_route
    from repro_torch.kernels.ssd.ref import ssd_ref, ssd_tensor_core_ref

    gen = torch.Generator(device=dev).manual_seed(18)
    errs = {"selective_scan": [], "ssd": [], "ssd_faithful": [],
            "decode_attention": [], "paged_decode_attention": []}
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for b, l in STATE_LENGTHS:
            name = f"selective_scan final state {(b, l, 8192, 16)} {dn}"
            a = scan_inputs(torch, gen, b, l, 8192, 16, 0.1, dt, dev)
            y, h = selective_scan_cuda(*a, chunk=256, c_block=64,
                                       return_state=True)
            ry, rh = selective_scan_chunked_ref(*a, chunk=64,
                                                return_state=True)
            _compare(torch, f"{name} y", y, ry, dn, errs["selective_scan"],
                     True)
            _compare(torch, f"{name} h", h, rh, dn, errs["selective_scan"],
                     True)
            check(torch.equal(y, selective_scan_cuda(*a, chunk=256,
                                                     c_block=64)),
                  f"{name}: y differs from the launch without the state")
            n_cases += 3
            a = ssd_inputs(torch, gen, b, l, 80, 64, 1, 64, 0.1, dt, dev)
            init = _rand(torch, gen, (b, 80, 64, 64), torch.float32, dev)
            mma = ssd_route(a[0], a[3], a[4], 64) == "mma"
            for s0 in (None, init):
                name = (f"ssd {'init + ' if s0 is not None else ''}final "
                        f"state {(b, l, 80, 64, 1, 64)} {dn}")
                y, st = ssd_cuda(*a, chunk=256, init_state=s0,
                                 return_state=True)
                ry, rs = ssd_ref(*a, chunk=64, init_state=s0,
                                 return_state=True)
                _compare(torch, f"{name} y", y, ry, dn, errs["ssd"], True)
                _compare(torch, f"{name} state", st, rs, dn, errs["ssd"],
                         True)
                n_cases += 2
                if s0 is None:
                    check(torch.equal(y, ssd_cuda(*a, chunk=256)),
                          f"{name}: y differs from the launch without the "
                          f"state")
                    n_cases += 1
                if mma:
                    fy, fs = ssd_tensor_core_ref(*a, chunk=64, init_state=s0,
                                                 return_state=True)
                    _compare(torch, f"{name} y vs the rounding-faithful "
                             f"version", y, fy, dn, errs["ssd_faithful"],
                             True, FAITHFUL_TOL)
                    _compare(torch, f"{name} state vs the rounding-faithful "
                             f"version", st, fs, dn, errs["ssd_faithful"],
                             True, FAITHFUL_TOL)
                    n_cases += 2
    # prefills of other lengths queued between decode launches, the
    # outputs read only after all were launched
    hq = hkv = 32
    lens = torch.tensor([217, 17, 600, 130], dtype=torch.int32, device=dev)
    q = _rand(torch, gen, (4, 1, hq, 80), torch.bfloat16, dev)
    kc, vc = (_rand(torch, gen, (4, 512, hkv, 80), torch.bfloat16, dev)
              for _ in range(2))
    queued = []
    for l in (200, 17, 65, 1, 64, 130):
        a = ssd_inputs(torch, gen, 1, l, 80, 64, 1, 64, 0.1, torch.bfloat16,
                       dev)
        queued.append((l, a, ssd_cuda(*a, chunk=256, return_state=True)))
        decode_attention_cuda(q, kc, vc, lens)
    for l, a, (y, st) in queued:
        ry, rs = ssd_ref(*a, chunk=64, return_state=True)
        _compare(torch, f"ssd queued prefill L {l} y", y, ry, "bfloat16",
                 errs["ssd"], True)
        _compare(torch, f"ssd queued prefill L {l} state", st, rs,
                 "bfloat16", errs["ssd"], True)
        n_cases += 2
    # decode and paged decode at the served shapes of the batchers' slots:
    # head dim 80, G = 1 (zamba2-2.7b) and head dim 128, 40 / 8 heads,
    # G = 5 (llama4-maverick)
    for (hq, hkv, d), dt in [(shape, dt) for shape in ((32, 32, 80),
                                                      (40, 8, 128))
                             for dt in (torch.float32, torch.bfloat16)]:
        dtn = str(dt).split(".")[1]
        dn = f"d{d} G{hq // hkv} {dtn}"
        q = _rand(torch, gen, (4, 1, hq, d), dt, dev)
        kc, vc = (_rand(torch, gen, (4, 512, hkv, d), dt, dev)
                  for _ in range(2))
        ref = decode_attention_ref(q, kc, vc, lens)
        for kb in (32, 64):
            _compare(torch, f"decode_attention {dn} kv{kb}",
                     decode_attention_cuda(q, kc, vc, lens, kv_block=kb),
                     ref, dtn, errs["decode_attention"], True)
            n_cases += 1
        ps, pages_max = 64, 8
        kp = torch.cat([kc.reshape(32, ps, hkv, d),
                        torch.zeros((1, ps, hkv, d), dtype=dt, device=dev)])
        vp = torch.cat([vc.reshape(32, ps, hkv, d),
                        torch.zeros((1, ps, hkv, d), dtype=dt, device=dev)])
        table = torch.randperm(32, generator=gen, device=dev).to(
            torch.int32).reshape(4, pages_max)
        out = paged_decode_attention_cuda(q, kp, vp, table, lens)
        _compare(torch, f"paged_decode_attention {dn}", out,
                 paged_decode_attention_ref(q, kp, vp, table, lens), dtn,
                 errs["paged_decode_attention"], True)
        dense_k = kp[table.long()].reshape(4, pages_max * ps, hkv, d)
        dense_v = vp[table.long()].reshape(4, pages_max * ps, hkv, d)
        check(torch.equal(out, decode_attention_cuda(
            q, dense_k.contiguous(), dense_v.contiguous(), lens,
            kv_block=64)), f"paged vs dense decode differ at {dn}")
        n_cases += 2
    torch.cuda.synchronize()
    out = {k: max(v) for k, v in errs.items()}
    log(f"SSM serving kernels: {n_cases} cases agree; max |err| {out}")
    return out, n_cases


GRAD_TOL = (2e-2, 2e-2)  # bf16 forward outputs feed the loss's gradient
GRAD_TOL_F32 = TOL["float32"]  # an fp32 forward: the kernel's fp32 rounding


def phase_grads(torch, dev):
    """Each autograd-wrapped op on CUDA tensors (kernel forward, recompute
    backward) against autograd through its plain version, on the loss
    sum(y^2): the gradients may differ only as far as the kernel's output
    differs from the plain one (bf16 inputs at GRAD_TOL, fp32 at
    GRAD_TOL_F32).  Prefill also at the instances training differentiates
    (phase 4i): MLA's 192 / 128, non-causal self-attention in fp32 and
    bf16, non-causal cross-attention (Sq != Skv, GQA), and a bf16 query
    over fp32 K/V through ``ops.flash_attention`` (each gradient in its
    input's dtype)."""
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels.flash_attention.ref import attention_blockwise_ref
    from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd.ref import ssd_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32

    def qkv(b, sq, skv, hq, hkv, d, dv, dtype, kv_dtype=None):
        kv_dtype = kv_dtype or dtype
        return (_rand(torch, gen, (b, sq, hq, d), dtype, dev),
                _rand(torch, gen, (b, skv, hkv, d), kv_dtype, dev),
                _rand(torch, gen, (b, skv, hkv, dv), kv_dtype, dev))

    def attn(causal):
        return (lambda q, k, v: ops.flash_attention(q, k, v, causal=causal),
                lambda q, k, v: attention_blockwise_ref(q, k, v,
                                                        causal=causal))

    # (label, family, inputs, op, plain, tolerance)
    cases = [
        ("rmsnorm", "rmsnorm",
         (_rand(torch, gen, (2, 64, 2560), bf, dev),
          _rand(torch, gen, (2560,), bf, dev)),
         lambda x, w: ops.rmsnorm(x, w), lambda x, w: rmsnorm_ref(x, w),
         GRAD_TOL),
        ("flash_attention", "flash_attention",
         qkv(1, 128, 128, 8, 8, 80, 80, bf), *attn(True), GRAD_TOL),
        ("flash_attention mla 192/128", "flash_attention",
         qkv(1, 128, 128, 16, 16, 192, 128, bf), *attn(True), GRAD_TOL),
        ("flash_attention non-causal fp32", "flash_attention",
         qkv(1, 256, 256, 20, 20, 64, 64, f32), *attn(False), GRAD_TOL_F32),
        ("flash_attention non-causal bf16", "flash_attention",
         qkv(1, 256, 256, 20, 20, 64, 64, bf), *attn(False), GRAD_TOL),
        ("flash_attention cross 64/1600", "flash_attention",
         qkv(1, 64, 1600, 32, 8, 128, 128, bf), *attn(False), GRAD_TOL),
        # jax's promotion: the fp32 K/V of the stub inputs against a bf16
        # query; the op computes in fp32 and returns the query's dtype
        ("flash_attention bf16 q / fp32 kv", "flash_attention",
         qkv(1, 64, 1500, 20, 20, 64, 64, bf, f32),
         lambda q, k, v: ops.flash_attention(q, k, v, causal=False),
         lambda q, k, v: attention_blockwise_ref(
             q.to(f32), k, v, causal=False).to(q.dtype), GRAD_TOL),
        ("selective_scan", "selective_scan",
         scan_inputs(torch, gen, 1, 100, 256, 16, 0.1, bf, dev),
         lambda *a: ops.selective_scan(*a, chunk=256),
         lambda *a: selective_scan_chunked_ref(*a, chunk=256), GRAD_TOL),
        ("ssd", "ssd", ssd_inputs(torch, gen, 1, 100, 8, 64, 1, 64, 0.1, bf,
                                  dev),
         lambda *a: ops.ssd(*a, chunk=256),
         lambda *a: ssd_ref(*a, chunk=256), GRAD_TOL),
    ]
    out = {}
    for label, name, inputs, op, plain, tol in cases:
        grads = []
        for fn in (op, plain):
            xs = [t.detach().clone().requires_grad_() for t in inputs]
            cuda_lib.reset_launches()
            ops.reset_recomputes()
            (fn(*xs).float() ** 2).sum().backward()
            check(all(t.grad.dtype == t.dtype for t in xs),
                  f"{label}: gradient dtypes "
                  f"{[t.grad.dtype for t in xs]} for inputs "
                  f"{[t.dtype for t in xs]}")
            grads.append([t.grad.float() for t in xs])
            if fn is op:
                check(cuda_lib.LAUNCHES[name] == 1 and
                      ops.RECOMPUTES[name] == 1,
                      f"{label}: the wrapped op launched "
                      f"{cuda_lib.LAUNCHES[name]} kernels and ran "
                      f"{ops.RECOMPUTES[name]} recomputes (want 1 and 1)")
        worst = 0.0
        for i, (gk, gp) in enumerate(zip(*grads)):
            check(bool(torch.isfinite(gk).all()),
                  f"{label}: non-finite gradient of input {i}")
            err = (gk - gp).abs()
            scale = float(gp.abs().max())
            # a relative bound on the whole tensor: reductions (w, A, D)
            # sum many rounded products
            bad = err > tol[0] * scale + tol[1] * gp.abs()
            check(not bool(bad.any()),
                  f"{label}: gradient of input {i} off in {int(bad.sum())} "
                  f"elements, max |err| {float(err.max()):.3e} (max |g| "
                  f"{scale:.3e})")
            worst = max(worst, float(err.max()) / max(scale, 1e-30))
        out[label] = worst
    torch.cuda.synchronize()
    return out


# --------------------------------------------------------------------------
# phase 4: the slice — llama3.2-1b served end to end
# --------------------------------------------------------------------------

def _requests(cfg, np):
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(7)
    lens = [16, 200, 37, 120, 64, 181, 23, 90]
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32),
                    max_new_tokens=int(rng.integers(8, 25)))
            for i, n in enumerate(lens)]


def _serve_plans():
    """The batcher's deployments: dense, paged, paged with chunked
    prefill (4 slots; 512 rows a slot either way)."""
    from repro_torch.serving.paging import PagedPlan

    return {
        "dense": None,
        "paged": PagedPlan(paging=True, pool_pages=64, page_size=64,
                           pages_per_slot_max=8),
        "paged_chunked": PagedPlan(paging=True, pool_pages=64, page_size=64,
                                   pages_per_slot_max=8, prefill_chunk=64),
    }


def _drain_batcher(torch, np, model, run, params, plan, decode=None):
    """``_requests`` through a 4-slot ``ContinuousBatcher`` of ``plan``,
    drained; what it produced and how long it took (host clock), and every
    decode step's logits (copied on the card as the step returns them,
    moved to the host after the drain).  The batcher's decode step is
    ``jitted_steps``' captured one unless ``decode`` (the eager step) is
    given."""
    from repro_torch.serving.scheduler import ContinuousBatcher

    b = ContinuousBatcher(model, run, params, num_slots=4, cache_len=512,
                          paged=plan)
    step = decode or b._decode
    logits_kept = []

    def kept(p, state, tokens):
        state, logits = step(p, state, tokens)
        logits_kept.append(logits.clone())
        return state, logits
    b._decode = kept
    for req in _requests(model.cfg, np):
        b.submit(req)
    t1 = time.perf_counter()
    done = b.run_until_drained(max_ticks=2000)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t1
    return {"completed": len(done), "ticks": b.ticks,
            "wall_s": wall_s, "prefill_s": b.prefill_s,
            "decode_s": b.decode_s,
            "tokens": sum(len(d.generated) for d in done),
            "order": [d.request.uid for d in done],
            "generated": [list(d.generated) for d in done],
            "prefill_chunks": b.prefill_chunks,
            "logits": [lg.cpu() for lg in logits_kept]}


def _check_batchers(served, n_req, what,
                    compared=("paged", "paged_chunked")):
    """Every geometry completed every request, and each geometry of
    ``compared`` (paged decode is the dense kernel's arithmetic on the same
    rows) gave the dense batcher's tokens; paging alone (no chunking)
    keeps the dense completion order."""
    for name, s in served.items():
        check(s["completed"] == n_req,
              f"{what}: {name} batcher completed {s['completed']} of {n_req}")
        log(f"{what} batcher {name}: {s['completed']} completed, "
            f"{s['ticks']} ticks, {s['tokens']} tokens, wall "
            f"{s['wall_s']:.3f} s (prefill {s['prefill_s']:.3f} s, decode "
            f"{s['decode_s']:.3f} s)")

    def by_uid(s):
        return dict(zip(s["order"], s["generated"]))
    for name in compared:
        check(by_uid(served[name]) == by_uid(served["dense"]),
              f"{what}: {name} batcher tokens differ from the dense "
              f"batcher's")
    if "paged" in compared:
        check(served["paged"]["order"] == served["dense"]["order"],
              f"{what}: paged batcher completion order differs from the "
              f"dense batcher's")


def _plain_logits(torch, model, run, params, prompt, tokens, cache_len,
                  extras=None):
    """Prefill and the first LOGIT_STEPS - 1 decode steps with the plain
    versions (``dispatch.use_mode("ref")``), teacher-forced with the
    kernel run's ``tokens``; the logits on the host.  The eager steps: a
    reference run is not captured."""
    from repro_torch.kernels import dispatch

    return _forced_logits(torch, model, run, params, prompt, tokens,
                          cache_len, dispatch.REF, extras)[0]


def _forced_logits(torch, model, run, params, prompt, tokens, cache_len,
                   mode, extras=None):
    """Prefill (of ``prompt`` with the batch's ``extras``: the vlm's
    ``vision_embeds``, the audio model's ``frames``) and the first
    LOGIT_STEPS - 1 decode steps, eager, in dispatch ``mode``,
    teacher-forced with ``tokens``: the logits on the host and every MoE
    layer's routes (``_recorded_routes``)."""
    from repro_torch.kernels import dispatch
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)

    prefill = make_prefill_step(model, run, cache_len=cache_len)
    decode = make_decode_step(model, run)
    toks = torch.as_tensor(tokens, device=prompt.device)
    out = []
    with torch.no_grad(), dispatch.use_mode(mode), \
            _recorded_routes() as routes:
        state, lg = prefill(params, {"tokens": prompt, **(extras or {})})
        out.append(lg.float().cpu())
        for i in range(LOGIT_STEPS - 1):
            state, lg = decode(params, state, toks[:, i:i + 1])
            out.append(lg.float().cpu())
    return out, routes


@contextlib.contextmanager
def _recorded_routes():
    """Every MoE layer call run inside, in call order: its fp32 router
    logits (G, Tg, E) and chosen experts (G, Tg, k).  The model's
    ``apply_moe`` is wrapped to run ``moe.route`` first on the same
    grouped tokens (the same ops on the same inputs, so the same choices);
    eager steps only."""
    from repro_torch.models import moe, transformer

    calls = []
    inner = transformer.apply_moe

    def recorded(p, cfg, x, router_mode="softmax", group_size=512, **kw):
        tg = moe._group_size(x.shape[0] * x.shape[1], group_size)
        logits, _, idx = moe.route(p, x.reshape(-1, tg, x.shape[-1]),
                                   cfg.moe_top_k, router_mode)
        calls.append((logits.detach().cpu(), idx.cpu()))
        return inner(p, cfg, x, router_mode=router_mode,
                     group_size=group_size, **kw)
    transformer.apply_moe = recorded
    try:
        yield calls
    finally:
        transformer.apply_moe = inner


def _compare_logits(torch, kernel_logits, plain_logits, vocab, what,
                    atol=None, held=None, batch=None):
    """Each step's logits within ``atol`` (LOGIT_ATOL unless given) +
    LOGIT_RTOL |x| of the plain run's, and the same argmax wherever the
    plain top-2 margin exceeds that tolerance; ``held`` (a (B,) bool mask
    a step) limits both to its rows.  Returns (max |diff|, decided rows,
    max |logit|)."""
    atol = LOGIT_ATOL if atol is None else atol
    batch = FIXED["batch"] if batch is None else batch
    worst = 0.0
    argmax_checked = 0
    for step, (kl, pl) in enumerate(zip(kernel_logits, plain_logits)):
        check(bool(torch.isfinite(kl).all()),
              f"{what} step {step}: non-finite logits")
        check(kl.shape == (batch, vocab),
              f"{what} step {step}: logits shape {tuple(kl.shape)}")
        if held is not None:
            kl, pl = kl[held[step]], pl[held[step]]
        err = (kl - pl).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        bad = err > atol + LOGIT_RTOL * pl.abs()
        check(not bool(bad.any()),
              f"{what} step {step}: {int(bad.sum())} logits differ from the "
              f"plain run beyond {atol} + {LOGIT_RTOL}|x| (max |diff| "
              f"{float(err.max())})")
        top2 = pl.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]
                   > atol + LOGIT_RTOL * top2[:, 0].abs())
        argmax_checked += int(decided.sum())
        same = kl.argmax(-1) == pl.argmax(-1)
        check(bool(same[decided].all()),
              f"{what} step {step}: argmax differs where the plain top-2 "
              f"margin exceeds the tolerance")
    scale = max(float(pl.abs().max()) for pl in plain_logits)
    log(f"{what} logits vs plain run"
        + ("" if held is None else
           f" ({sum(int(h.sum()) for h in held)} of "
           f"{sum(h.numel() for h in held)} step rows held: their routes "
           f"agree)")
        + f": max |diff| {worst:.4f} (tol "
        f"{atol:.4g} + {LOGIT_RTOL}|x|; max |logit| {scale:.1f}), argmax "
        f"equal on {argmax_checked} decided rows")
    return worst, argmax_checked, scale


def _fixed_batch_numbers(np, fixed):
    """Prefill time, decode p50 / p99 (after the first step) and tokens/s of
    a fixed-batch run (host clock around synchronized steps)."""
    lat = np.asarray(fixed.decode_s[1:]) * 1000
    return {"batch": FIXED["batch"], "prompt_len": FIXED["prompt_len"],
            "gen": FIXED["gen"], "prefill_ms": fixed.prefill_s * 1000,
            "decode_p50_ms": float(np.percentile(lat, 50)),
            "decode_p99_ms": float(np.percentile(lat, 99)),
            "tok_s": float(FIXED["batch"] / np.mean(lat) * 1000)}


def phase_slice(torch, np, dev):
    from repro_torch.configs.registry import get_model_config

    cfg = get_model_config(ARCH)
    cache_len = FIXED["prompt_len"] + FIXED["gen"]
    model, run, params, prompt, init_s = _build_served(torch, dev, cfg)
    n_params = cfg.param_count()
    log(f"{cfg.name}: {n_params / 1e9:.3f} B params, {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.dtype}; init {init_s:.1f} s")
    fixed, served, launches, _ = _counted_serve(
        torch, np, model, run, params, prompt, list(_serve_plans()),
        SERVE_KERNELS)
    _check_batchers(served, len(_requests(cfg, np)), ARCH)

    # ---- the plain-version run with the same weights, teacher-forced ----
    plain_logits = _plain_logits(torch, model, run, params, prompt,
                                 fixed.tokens, cache_len)
    worst, _, scale = _compare_logits(torch, fixed.logits, plain_logits,
                                      cfg.vocab_size, ARCH)
    fixed_out = {**_fixed_batch_numbers(np, fixed),
                 "logits_max_abs_diff": worst,
                 "logits_tol": {"atol": LOGIT_ATOL, "rtol": LOGIT_RTOL},
                 "logits_max_abs": scale}
    log(f"fixed batch {FIXED['batch']}x{FIXED['prompt_len']}+{FIXED['gen']}: "
        f"prefill {fixed_out['prefill_ms']:.2f} ms, decode p50 "
        f"{fixed_out['decode_p50_ms']:.2f} ms p99 "
        f"{fixed_out['decode_p99_ms']:.2f} ms, {fixed_out['tok_s']:.0f} tok/s")
    slice_out = {
        "arch": ARCH, "params": n_params, "dtype": cfg.dtype,
        "fixed_batch": fixed_out,
        "batcher": {k: {f: v[f] for f in ("completed", "ticks", "wall_s",
                                           "prefill_s", "decode_s", "tokens",
                                           "prefill_chunks")}
                    for k, v in served.items()},
        "launches": launches}
    return slice_out, launches, (model, run, params, prompt), served


# Logits of the random-weight llama3.2-1b reach ~1.8e3 in magnitude, where
# one bf16 ulp is 8; the kernels and the plain versions round their outputs
# to bf16 at different points, and 16 layers carry that forward.  Allowed:
# 2 ulps relative (2^-7) plus 2.0 absolute for the small logits.
LOGIT_ATOL = 2.0
LOGIT_RTOL = 2.0 ** -7
# zamba2-2.7b's untied random head gives logits of a few units (max |x|
# ~4), where 2.0 absolute would hold nothing: an SSM model's absolute term
# is at most 2^-5 of its plain run's largest |logit| (8 bf16 ulps of it)
SSM_LOGIT_ATOL_SHARE = 2.0 ** -5


# --------------------------------------------------------------------------
# phase 4b: the training slice — falcon-mamba-7b and zamba2-2.7b trained at
# full width through repro_torch.launch.train
# --------------------------------------------------------------------------

# full width, depth cut to fit one 80 GB card with fp32 master weights and
# AdamW moments (falcon-mamba-7b's 64 layers are 6.7 B parameters, ~107 GB
# of optimizer state): 8 of 64 layers, and 12 of 54 (two super-blocks)
TRAIN = {"falcon-mamba-7b": 8, "zamba2-2.7b": 12}
TRAIN_SHAPE = dict(batch=2, seq=1024, steps=4)
# the kernel-vs-plain step comparison: 2 layers, 1 super-block
COMPARE_LAYERS = {"falcon-mamba-7b": 2, "zamba2-2.7b": 6}
TRAIN_KERNELS = {"falcon-mamba-7b": ("selective_scan", "rmsnorm"),
                 "zamba2-2.7b": ("ssd", "flash_attention", "rmsnorm")}
# one AdamW step with the kernels against the same step with the plain
# versions, bf16 compute: both round their outputs to bf16 but sum in
# other orders, so the loss agrees to 1e-2 relative and the gradient norm
# to 5e-2; the first Adam update is lr * g / (|g| + eps), about lr *
# sign(g), so a parameter may move the other way only where its gradient
# is near 0: at most 2% of the parameters may differ by more than lr / 2
STEP_TOL = {"loss_rtol": 1e-2, "grad_norm_rtol": 5e-2, "flipped_share": 0.02}


def phase_train(torch, np, dev):
    from repro_torch.configs.registry import get_model_config
    from repro_torch.kernels import cuda_lib, dispatch, ops
    from repro_torch.launch.train import train

    out = {}
    for arch, layers in TRAIN.items():
        cfg = get_model_config(arch).replace(num_layers=layers)
        n_params = cfg.param_count()
        per_step = []

        def log_step(i, metrics, step_s):
            per_step.append({"launches": dict(cuda_lib.LAUNCHES),
                             "recomputes": dict(ops.RECOMPUTES)})
            cuda_lib.reset_launches()
            ops.reset_recomputes()
            log(f"{arch} step {i}: loss {float(metrics['loss']):.4f}, grad "
                f"norm {float(metrics['grad_norm']):.3f}, "
                f"{step_s * 1000:.1f} ms")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # ---- the main path, counted per step ---------------------------
        cuda_lib.reset_launches()
        ops.reset_recomputes()
        with dispatch.profile_dispatches() as prof, \
                dispatch.record_resolutions() as resolved:
            res = train(cfg, steps=TRAIN_SHAPE["steps"],
                        seq=TRAIN_SHAPE["seq"], batch=TRAIN_SHAPE["batch"],
                        device=dev, seed=0, log=log_step)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        plain = [k for k in prof.summary() if k.endswith(f"[{dispatch.REF}]")]
        check(not plain, f"{arch}: CUDA tensors resolved to plain versions "
              f"in the forward: {plain}")
        check(all(np.isfinite(res.losses)), f"{arch}: losses {res.losses}")
        for i, counts in enumerate(per_step):
            for name in TRAIN_KERNELS[arch]:
                check(counts["launches"][name] > 0,
                      f"{arch} step {i}: kernel {name} not launched")
        total = {k: sum(c["launches"][k] for c in per_step)
                 for k in cuda_lib.LAUNCHES}
        recomputes = {k: sum(c["recomputes"][k] for c in per_step)
                      for k in ops.RECOMPUTES}
        steady = res.step_s[1:]
        p50 = float(np.percentile(steady, 50))
        tokens = TRAIN_SHAPE["batch"] * TRAIN_SHAPE["seq"]
        out[arch] = {
            "layers": layers, "of_layers": get_model_config(arch).num_layers,
            "params": n_params, **TRAIN_SHAPE,
            "losses": res.losses, "grad_norms": res.grad_norms,
            "step_ms": [t * 1000 for t in res.step_s],
            "step_p50_ms": p50 * 1000, "tokens_per_s": tokens / p50,
            "peak_mem_gb": peak / 1e9,
            "launches": total,
            "launches_per_step": per_step[-1]["launches"],
            "recomputes_per_step": per_step[-1]["recomputes"],
            "recomputes": recomputes}
        # the scan's launch options as the step resolved them: phase 5
        # times the plan they give
        scan = {tuple(sorted(r.launch.items())) for r in resolved
                if r.family == "mamba_scan"}
        if scan:
            check(len(scan) == 1, f"{arch}: the scan resolved several launch "
                  f"options {scan}")
            out[arch]["scan_launch"] = dict(scan.pop())
        log(f"{arch} ({layers} of {out[arch]['of_layers']} layers, "
            f"{n_params / 1e9:.3f} B params): step p50 {p50 * 1000:.1f} ms "
            f"(steps 2-{TRAIN_SHAPE['steps']}), {tokens / p50:.0f} tok/s, "
            f"peak {peak / 1e9:.1f} GB; launches per step "
            f"{per_step[-1]['launches']}, recomputes per step "
            f"{per_step[-1]['recomputes']}")
        del res
        torch.cuda.empty_cache()
        out[arch]["vs_plain"] = _step_vs_plain(
            torch, np, dev, cfg.replace(num_layers=COMPARE_LAYERS[arch]),
            TRAIN_SHAPE["seq"], TRAIN_SHAPE["batch"], arch)
    return out


def _step_vs_plain(torch, np, dev, cfg, seq, batch_size, what,
                   prepare=None, routes=False):
    """One step of ``cfg`` with the kernels and the same step under
    ``dispatch.use_mode("ref")``, from the same weights (``model.init(0)``,
    changed by ``prepare``) on the same batch, one state on the card at a
    time (the initial and the kernel step's parameters wait on the host).
    With ``routes`` (MoE) the two forwards' expert choices are compared
    first (``_route_agreement``)."""
    from repro_torch.data.pipeline import make_data
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    run = make_run(cfg, seq=seq, batch=batch_size, steps=TRAIN_SHAPE["steps"])
    model = build_model(cfg, run.parallel, device=dev)
    opt = make_optimizer(run.train)
    step = make_train_step(model, run, opt)
    batch = make_data(cfg, run.shape, seed=0).batch_at(0)
    results, recorded = {}, {}
    init = kernel_params = None
    for mode in ("cuda", "ref"):
        params = model.init(0)
        if prepare is not None:
            prepare(params)
        state = init_train_state(model, run, opt, params=params)
        del params
        if init is None:
            init = {k: v.detach().to("cpu", copy=True)
                    for k, v in _flat(state.params)}
        with (dispatch.use_mode(dispatch.REF) if mode == "ref"
              else contextlib.nullcontext()), \
                (_recorded_routes() if routes
                 else contextlib.nullcontext([])) as calls:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        recorded[mode] = calls
        results[mode] = (float(m["loss"]), float(m["grad_norm"]))
        if mode == "cuda":
            kernel_params = {k: v.to("cpu", copy=True)
                             for k, v in _flat(state.params)}
            del state, m
            torch.cuda.empty_cache()
    lr_step = float(m["lr"])
    flipped = n = 0
    diff_sq = ref_sq = 0.0
    for k, v in _flat(state.params):  # the plain step's, on the card
        dr = (v - init[k].to(dev)).float()
        dk = (kernel_params[k].to(dev) - init[k].to(dev)).float()
        flipped += int(((dk - dr).abs() > lr_step / 2).sum())
        n += v.numel()
        diff_sq += float(((dk - dr) ** 2).sum())
        ref_sq += float((dr ** 2).sum())
    del state, m, init, kernel_params
    torch.cuda.empty_cache()
    (lk, gk), (lr_, gr) = results["cuda"], results["ref"]
    rel_l2 = math.sqrt(diff_sq / ref_sq)
    out = {"layers": cfg.num_layers, "loss": lk, "loss_plain": lr_,
           "grad_norm": gk, "grad_norm_plain": gr,
           "flipped_share": flipped / n, "update_rel_l2": rel_l2,
           "lr": lr_step, "tolerance": STEP_TOL}
    if routes:
        share, _, choices, gaps = _route_agreement(
            torch, cfg, batch_size, recorded["cuda"], recorded["ref"],
            steps=1)
        check(share <= MAX_FLIPPED_SHARE,
              f"{what}: {share:.2%} of the expert choices differ from the "
              f"plain step's (limit {MAX_FLIPPED_SHARE:.0%})")
        out["routes"] = {"moe_calls": len(recorded["cuda"]),
                         "choices": choices, "flipped_share": share,
                         "first_flip_gaps": gaps}
        log(f"{what} routes vs plain step: {share:.3%} of {choices} "
            f"choices differ, first-flip gaps {gaps}")
    log(f"{what} step vs plain ({cfg.num_layers} layers): loss {lk:.5f} vs "
        f"{lr_:.5f}, grad norm {gk:.4f} vs {gr:.4f}, updates differing by "
        f"> lr/2: {flipped} of {n} ({flipped / n:.2e}), update rel. L2 "
        f"{rel_l2:.3e}")
    check(abs(lk - lr_) <= STEP_TOL["loss_rtol"] * abs(lr_),
          f"{what}: loss {lk} vs plain {lr_}")
    check(abs(gk - gr) <= STEP_TOL["grad_norm_rtol"] * abs(gr),
          f"{what}: grad norm {gk} vs plain {gr}")
    check(flipped / n <= STEP_TOL["flipped_share"],
          f"{what}: {flipped} of {n} parameter updates differ by > lr/2")
    return out


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


# --------------------------------------------------------------------------
# phase 4c: the sim-to-real loop — CAMEO tunes the serving stack of
# llama3.2-1b at full width with the simulator as source and the batcher
# replaying a trace through the kernels on the card as target
# --------------------------------------------------------------------------

# about 20 requests and 500 output tokens at trace seed 0, the longest
# context near 150
SIM2REAL_SPEC = ("poisson:rate=1500,horizon=0.01,mean_prompt=96,"
                 "mean_output=24,max_len=256")
SIM2REAL_TUNE = dict(budget=4, n_source=32, n_target_init=2, seed=0)
SIM2REAL_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
#: counters that follow from the schedule alone (not the clock)
SIM2REAL_DETERMINISTIC = ("queue_depth_mean", "queue_depth_max",
                          "occupancy_mean", "rejected_rate")


def _replay_checked(torch, config, what):
    """One public replay of ``config`` under ``dispatch.record_resolutions``:
    rmsnorm, prefill and decode resolve to cuda and launch."""
    from repro_torch.kernels import cuda_lib, dispatch

    before = dict(cuda_lib.LAUNCHES)
    with dispatch.record_resolutions() as res:
        y = what(config)
        torch.cuda.synchronize()
    _check_resolved(res, f"sim2real: {what.__name__}({config})")
    grown = [k for k in SIM2REAL_KERNELS
             if cuda_lib.LAUNCHES[k] <= before[k]]
    check(not grown, f"sim2real: {what.__name__} launched no {grown} kernel")
    return y


def _check_resolved(res, where):
    modes = {(r.family, r.mode) for r in res}
    check({f for f, _ in modes} >= {"rmsnorm", "flash_attention"} and
          all(m == "cuda" for _, m in modes),
          f"{where} resolved {sorted(modes)}; rmsnorm, prefill and decode "
          f"must resolve to cuda")


def _tuning_measurements(events, rounds, sim):
    """The tuning run's target measurements, read off the trace: each
    ``measure`` span (config, replayed p99, ticks, completed / rejected and
    its wall time, warm-up included), the round its tuner ``ask`` opened
    (before the first ask: the initial target dataset), and the simulator's
    prediction for the same config.  Each round's wall time splits into
    replay (its measure spans) and tuner (the rest: surrogate fit and
    acquisition)."""
    asks = sorted(e["ts"] for e in events
                  if e["name"] == "ask" and e["cat"] == "tuner")
    out = []
    for e in events:
        if e["name"] != "measure" or e["cat"] != "env":
            continue
        a = e["args"]
        rnd = sum(ts <= e["ts"] for ts in asks) or None
        pred = sim.simulate(a["config"])
        out.append({
            "round": rnd, "config": a["config"], "stalled": "error" in a,
            "replay_p99_ms": a.get("p99_ms"), "ticks": a.get("ticks"),
            "completed": a.get("completed"), "rejected": a.get("rejected"),
            "replay_s": e["dur"] * 1e-6,
            "sim_p99_us": pred.p99_latency_us if pred.feasible else None,
            "sim_ticks": pred.ticks})
    for i, r in enumerate(rounds, start=1):
        mine = [m for m in out if m["round"] == i]
        r["replay_s"] = sum(m["replay_s"] for m in mine)
        r["tuner_s"] = r["wall_s"] - r["replay_s"]
        for m in mine:
            m["round_wall_s"], m["tuner_s"] = r["wall_s"], r["tuner_s"]
    return out


def phase_sim2real(torch, np, dev):
    """Returns (summary, launches of the counted tuning run)."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.envs.replay_env import make_sim2real_pair
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.obs import trace as obs_trace
    from repro_torch.tuner.runner import transfer_tune

    cfg = get_model_config(ARCH)

    def pair():
        return make_sim2real_pair(SIM2REAL_SPEC, model_cfg=cfg, seed=0,
                                  trace_seed=0, repeats=1, device="cuda")

    t0 = time.perf_counter()
    src, tgt = pair()
    torch.cuda.synchronize()
    tr = tgt.trace
    log(f"sim2real: {cfg.name} ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}) on {tgt.device}; trace {tr.spec}: "
        f"{len(tr.requests)} requests, {tr.total_output_tokens} output "
        f"tokens, longest context {tr.max_context}, {tgt.ticks_per_s:.0f} "
        f"ticks/s; families {tgt.families}; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    check(tgt.families == ("flash_attention", "rmsnorm"),
          f"sim2real: the tuned families are {tgt.families}")

    # two interventions on the default configuration: a finite y, and the
    # schedule (every clock-free counter) the same both times
    default = tgt.space.default_config()
    (c1, y1), (c2, y2) = (_replay_checked(torch, default, tgt.intervene)
                          for _ in range(2))
    check(np.isfinite(y1) and y1 > 0 and np.isfinite(y2),
          f"sim2real: default config measured {y1}, {y2}")
    for name in SIM2REAL_DETERMINISTIC:
        check(c1[name] == c2[name],
              f"sim2real: {name} differs between two replays of the "
              f"default config ({c1[name]} vs {c2[name]})")
    log(f"sim2real: default config twice: p99 {y1:.1f} / {y2:.1f} ms, "
        f"occupancy {c1['occupancy_mean']:.2f}; clock-free counters equal")
    check(tgt.measured_captures == 0,
          f"sim2real: {tgt.measured_captures} decode graphs captured inside "
          f"the default's measured replays")

    # the tuning run, counted, on a fresh pair (the model comes from the
    # env's cache) so it measures from scratch; traced, so each target
    # measurement and each round's split can be read back
    src, tgt = pair()
    check(obs_trace.active() is None, "sim2real: a tracer is already on")
    tracer = obs_trace.start()
    cuda_lib.reset_launches()
    t1 = time.perf_counter()
    try:
        with dispatch.record_resolutions() as resolved:
            res = transfer_tune("cameo", src, tgt,
                                query_text=tgt.query_text, **SIM2REAL_TUNE)
            torch.cuda.synchronize()
    finally:
        obs_trace.stop()
    tune_s = time.perf_counter() - t1
    launches = dict(cuda_lib.LAUNCHES)
    log(f"sim2real: tuning-run launches {launches}")
    _check_resolved(resolved, "sim2real: the tuning run")
    for k in SIM2REAL_KERNELS:
        check(launches[k] > 0, f"sim2real: the tuning run launched no {k}")
    check(np.isfinite(res.best_y) and res.best_y > 0,
          f"sim2real: best_y {res.best_y}")
    check(tracer.dropped == 0, f"sim2real: the trace dropped "
          f"{tracer.dropped} events")
    tuned = _tuning_measurements(tracer.events(), res.rounds, src)
    check(tuned and not all(m["stalled"] for m in tuned),
          "sim2real: the tuning run completed no replay")
    for m in tuned:
        knobs = {k.split(".", 1)[1]: v for k, v in m["config"].items()}
        where_s = (f"round {m['round']}" if m["round"] else "initial")
        split = (f"; round {m['round_wall_s']:.2f} s = tuner "
                 f"{m['tuner_s']:.2f} + replay {m['replay_s']:.2f}"
                 if "tuner_s" in m else f"; replay {m['replay_s']:.2f} s")
        sim = ("infeasible" if m["sim_p99_us"] is None
               else f"{m['sim_p99_us']:.0f} us modeled")
        got = ("did not drain (measured infeasible)" if m["stalled"] else
               f"{m['replay_p99_ms']:.1f} ms, {m['ticks']} ticks, "
               f"{m['completed']} completed / {m['rejected']} rejected")
        log(f"sim2real {where_s}: {knobs} -> replayed p99 {got} | "
            f"sim-predicted p99 {sim}{split}")
    n_gated = SIM2REAL_TUNE["budget"] + SIM2REAL_TUNE["n_target_init"] \
        - len(tuned)
    # the winner deploys
    final = _replay_checked(torch, res.best_config, tgt.replay)
    check(final.completed == len(tr.requests) - final.rejected and
          final.completed > 0, f"sim2real: the winner served {final}")
    captures = sum(e["name"] == "decode_graph_capture"
                   for e in tracer.events())
    check(tgt.measured_captures == 0,
          f"sim2real: {tgt.measured_captures} decode graphs captured inside "
          f"measured replays of the tuning run or the winner's")
    log(f"[{CARD}] sim2real on the captured decode step: {captures} graphs "
        f"captured in the tuning run (its trace), none inside a measured "
        f"replay of it or of the winner's deployment")
    log(f"sim2real: best {res.best_config} -> p99 {res.best_y:.1f} ms "
        f"(redeployed: {final.p99_latency_ms:.1f} ms, {final.ticks} "
        f"ticks); tuning run {tune_s:.1f} s "
        f"({sum(m['replay_s'] for m in tuned):.1f} s replaying, {n_gated} "
        f"measurements gated or memoized)")
    summary = {
        "spec": tr.spec, "requests": len(tr.requests),
        "output_tokens": tr.total_output_tokens,
        "max_context": tr.max_context, "tune": SIM2REAL_TUNE,
        "default_p99_ms": [y1, y2], "default_counters": c1,
        "best_config": res.best_config,
        "best_y_ms": res.best_y, "trace_best_y": res.trace_best_y,
        "rounds": res.rounds, "measurements": tuned,
        "winner": {"replay_p99_ms": final.p99_latency_ms,
                   "ticks": final.ticks, "completed": final.completed,
                   "rejected": final.rejected, "wall_s": final.wall_s},
        "tune_s": tune_s, "extras": res.extras,
        "decode_graph_captures": captures, "captures_in_measured": 0,
        "card": CARD}
    return summary, launches


# the GP surrogate's cost on each device at a tuning budget's scale: one
# fit and one predict, the devices taken in turns; three runs of 31 turns
GP_TIMING = dict(n=64, d=8, m=256, reps=31, runs=3)


def phase_gp_timing(torch, np, dev):
    """One fit and one predict at n = 64, d = 8 (256 candidates), on the
    CPU and on the card in turns; host clock around synchronized calls
    (the posterior comes back to the host either way).  The card would
    replace the CPU as the default only by the rule for a claimed gain:
    faster in at least nine tenths of all turns, and its median lower than
    the CPU's by more than the CPU's own quartile spread."""
    from repro_torch.core.gp import fit_gp, gp_predict

    g = GP_TIMING
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (g["n"], g["d"]))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 + 0.05 * rng.standard_normal(
        g["n"])
    xq = rng.uniform(0, 1, (g["m"], g["d"]))
    times = {"cpu": ([], []), "cuda": ([], [])}
    mus = {}
    runs = []
    for run in range(g["runs"]):
        n0 = len(times["cpu"][0])
        for rep in range(g["reps"] + 1):
            for where in (("cpu", "cuda") if rep % 2 else ("cuda", "cpu")):
                t0 = time.perf_counter()
                fit = fit_gp(x, y, device=where)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                mus[where] = gp_predict(fit, xq)[0].numpy()
                t2 = time.perf_counter()
                if rep:  # the first turn of a run warms both devices up
                    times[where][0].append((t1 - t0) * 1e3)
                    times[where][1].append((t2 - t1) * 1e3)
        tot = {w: np.add(*times[w])[n0:] for w in times}
        runs.append({"cuda_wins": int(np.sum(tot["cuda"] < tot["cpu"])),
                     "turns": len(tot["cpu"]),
                     "cpu_total_ms": float(np.median(tot["cpu"])),
                     "cuda_total_ms": float(np.median(tot["cuda"]))})
    check(np.allclose(mus["cpu"], mus["cuda"], atol=1e-4, rtol=1e-4),
          "gp: the card's posterior disagrees with the CPU's")
    out = {"runs": runs}
    for where, (fits, preds) in times.items():
        tot = np.add(fits, preds)
        out[where] = {"fit_ms": float(np.median(fits)),
                      "predict_ms": float(np.median(preds)),
                      "total_ms": float(np.median(tot)),
                      "total_iqr_ms": [float(np.percentile(tot, 25)),
                                       float(np.percentile(tot, 75))]}
    tot = {w: np.add(*times[w]) for w in times}
    wins = int(np.sum(tot["cuda"] < tot["cpu"]))
    ties = int(np.sum(tot["cuda"] == tot["cpu"]))
    spread = out["cpu"]["total_iqr_ms"][1] - out["cpu"]["total_iqr_ms"][0]
    gain = out["cpu"]["total_ms"] - out["cuda"]["total_ms"]
    out.update(cuda_wins=wins, turns=len(tot["cpu"]), ties=ties,
               cuda_wins_share=wins / max(len(tot["cpu"]) - ties, 1),
               cpu_spread_ms=spread, cuda_gain_ms=gain)
    out["cuda_by_the_rule"] = bool(out["cuda_wins_share"] >= 0.9 and
                                   gain > spread)
    log(f"gp fit + predict at n={g['n']}, d={g['d']}, {g['m']} candidates "
        f"({g['runs']} runs of {g['reps']} turns): cpu "
        f"{out['cpu']['fit_ms']:.2f} + {out['cpu']['predict_ms']:.2f} ms "
        f"(total IQR {out['cpu']['total_iqr_ms']}), cuda "
        f"{out['cuda']['fit_ms']:.2f} + {out['cuda']['predict_ms']:.2f} ms "
        f"(total IQR {out['cuda']['total_iqr_ms']}); the card faster in "
        f"{wins} of {out['turns']} turns ({ties} ties; by run "
        f"{[r['cuda_wins'] for r in runs]} of {g['reps']}), median gain "
        f"{gain:.2f} ms against the CPU's spread {spread:.2f} ms: the card "
        f"{'wins' if out['cuda_by_the_rule'] else 'does not win'} by the "
        f"nine-tenths rule")
    return out


def _serve_cli(args, expect):
    """The serve launcher as a user runs it, in a process of its own, with
    ``args``; it must exit 0 and print every string of ``expect``."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *args]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                         timeout=600,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"serve CLI | {line}")
    what = "serve CLI " + " ".join(args)
    check(res.returncode == 0,
          f"{what} exited {res.returncode}: {res.stderr[-2000:]}")
    missing = [e for e in expect if e not in res.stdout]
    check(not missing, f"{what}: no {missing} in its output")
    log(f"{what}: rc 0 in {wall:.1f} s")
    return {"cmd": " ".join(cmd[1:]), "wall_s": wall,
            "lines": [ln for ln in res.stdout.splitlines()
                      if ln.startswith("[serve]")]}


def phase_serve_cli():
    """The serve launcher's trace path: tune (4 measurements in the
    simulator), replay on the card, and print sim-predicted beside
    replayed-actual."""
    return _serve_cli(["--arch", ARCH, "--full-config", "--workload",
                       SIM2REAL_SPEC, "--tune-serving", "4",
                       "--sim2real-eval"],
                      ("sim-predicted", "replayed-actual",
                       "decode graphs: 1 captured"))


# --------------------------------------------------------------------------
# phase 4d: kernel-launch tuning on the card — CAMEO transfers the analytic
# launch geometry (source) to CUDA-event timings of the kernels (target)
# --------------------------------------------------------------------------

#: (kind, arch, batch, tokens, the families the model dispatches)
TUNE_LAUNCH_CELLS = (
    ("serve", "llama3.2-1b", 4, 96, ("flash_attention", "rmsnorm")),
    ("train", "falcon-mamba-7b", 2, 1024, ("mamba_scan", "rmsnorm")),
    ("train", "zamba2-2.7b", 2, 1024, ("flash_attention", "rmsnorm", "ssd")),
)
TUNE_LAUNCH = dict(budget=6, n_target_init=3, seed=0)
#: the default and the tuned config remeasured in turns (D T T D D T)
REMEASURE_ORDER = ("default", "tuned", "tuned", "default", "default",
                   "tuned")
FAMILY_KERNEL = {"flash_attention": "flash_attention",
                 "mamba_scan": "selective_scan", "rmsnorm": "rmsnorm",
                 "ssd": "ssd"}


def launch_key(family, args, params):
    """What the kernel wrapper launches for ``params`` on ``args``, from
    the shapes alone: the sizes snapped into the family's domain, then
    ``plan_rmsnorm`` / ``plan_scan`` / ``ssd_route``."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.mamba_scan.kernel import plan_scan, storage_size
    from repro_torch.kernels.rmsnorm.kernel import plan_rmsnorm
    from repro_torch.kernels.ssd.kernel import ssd_route

    def snap(name):
        return dispatch.snap_down(
            params[name], dispatch.get_family(family).option(name).values)

    if family == "rmsnorm":
        x, w = args
        d = x.shape[-1]
        vectorized = d % (16 // x.element_size()) == 0 and all(
            t.data_ptr() % 16 == 0 for t in args)
        return plan_rmsnorm(x.numel() // d, d, x.element_size(), vectorized,
                            snap("row_block"))
    if family == "flash_attention":
        return (str(args[0].dtype), snap("q_block"), snap("kv_block"))
    if family == "mamba_scan":
        x, dt, A, Bm, Cm, _ = args
        return plan_scan(*x.shape, A.shape[1], storage_size(x, dt, Bm, Cm),
                         params["chunk"], params["c_block"])
    if family == "ssd":
        q = snap("chunk")
        return (ssd_route(args[0], args[3], args[4], q), q)
    raise KeyError(family)


def inert_knobs(backend, families):
    """Per family: the points of its launch space and how many distinct
    launches they give on the backend's inputs."""
    from repro_torch.envs.measure import family_params
    from repro_torch.kernels import dispatch

    out = {}
    for fam in families:
        points = dispatch.launch_space([fam]).grid()
        keys = {launch_key(fam, backend.inputs(fam),
                           family_params(fam, p)) for p in points}
        out[fam] = {"points": len(points), "distinct": len(keys),
                    "launches": sorted(map(str, keys))}
    return out


#: the launch geometry's predictions must lie within this factor of the
#: card's median at every distinct launch of phase 4d's cells
GEOMETRY_RATIO = 4.0
#: the two sizes of each latency's slope: (first, second) of the SSD's
#: links on one (batch, head) pair, the scan's steps on one block of one
#: warp, and the prefill's K/V tiles under one block and under full SMs
GEOMETRY_SLOPES = {"chain_link_us": (8, 64), "scan_step_us": (1024, 8192),
                   "tile_latency": (16, 128), "tile_sm": (4, 32)}
#: small kernels that open each profiler window of the geometry's hold
GEOMETRY_PAD = 16


def measure_geometry_constants(torch, np, dev):
    """The latencies ``envs/measure.py``'s launch geometry prices with,
    measured here through ``WallClockBackend``'s CUDA-event timer (median
    of 3 timings, each the median of 9 calls): one launch of the port's
    smallest block (RMSNorm of one row of 8), and the slopes over two
    sizes of one chain or one block — the tensor-core SSD's links on one
    (batch, head) pair (N = P = 64, chunk 64, two chunks a link), the
    scan's steps on one block of one warp (8 channels, N 16, bf16 x with
    fp32 dt) — and, at every (head dim, q block, kv block) of
    ``TILE_US``, the bf16 prefill's K/V tiles: under one block of q rows
    at the end of the keys (the latency), and under as many such blocks
    as every SM holds, over one shared kv head (the SM's time a tile: the
    slope over the blocks an SM holds)."""
    from repro_torch.envs import measure
    from repro_torch.envs.measure import (KernelWorkload, WallClockBackend,
                                          resident_blocks)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, prefill_record)
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.utils.hardware import H100_SM_COUNT

    timer = WallClockBackend(KernelWorkload(batch=1, seq_len=1, d_model=8),
                             ["rmsnorm"], device=dev, warmup=2, repeats=9)
    gen = torch.Generator(device=dev).manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32

    def us(fn):
        with torch.no_grad():
            return float(np.median([timer._time_us(fn) for _ in range(3)]))

    def rand(*shape, dtype=bf):
        return _rand(torch, gen, shape, dtype, dev)

    def chain(links):
        l = links * 2 * 64
        a = (rand(1, l, 1, 64), rand(1, l, 1, dtype=f32).abs() * 0.05,
             -rand(1, dtype=f32).abs(), rand(1, l, 1, 64), rand(1, l, 1, 64),
             torch.ones(1, device=dev))
        return us(lambda: ssd_cuda(*a, chunk=64))

    def scan(steps):
        a = (rand(1, steps, 8), rand(1, steps, 8, dtype=f32).abs() * 0.05,
             -rand(8, 16, dtype=f32).abs(), rand(1, steps, 16),
             rand(1, steps, 16), torch.ones(8, device=dev))
        return us(lambda: selective_scan_cuda(*a))

    def tiles(d, qb, kb, heads, n):
        keys = n * kb
        q = rand(1, qb, heads, d)
        k, v = rand(1, keys, 1, d), rand(1, keys, 1, d)
        return us(lambda: flash_attention_cuda(
            q, k, v, q_offset=keys - qb, q_block=qb, kv_block=kb))

    def slope(name, fn):
        lo, hi = GEOMETRY_SLOPES[name]
        t_lo, t_hi = fn(lo), fn(hi)
        return (t_hi - t_lo) / (hi - lo), [t_lo, t_hi]

    x, w = rand(1, 8), rand(8)
    out = {"launch_us": us(lambda: rmsnorm_cuda(x, w))}
    samples = {"launch_us": [out["launch_us"]]}
    committed = {"launch_us": measure.LAUNCH_US,
                 "chain_link_us": measure.CHAIN_LINK_US,
                 "scan_step_us": measure.SCAN_STEP_US}
    for name, fn in (("chain_link_us", chain), ("scan_step_us", scan)):
        out[name], samples[name] = slope(name, fn)
    for (d, qb, kb), priced in sorted(measure.TILE_US.items()):
        held = resident_blocks(prefill_record(bf, 1, qb, 1, d, d, qb, kb))
        latency, t_one = slope("tile_latency",
                               lambda n: tiles(d, qb, kb, 1, n))
        full, t_full = slope("tile_sm", lambda n: tiles(
            d, qb, kb, H100_SM_COUNT * held, n))
        key = f"tile_us d{d} q{qb} kv{kb}"
        out[key] = [latency, full / held]
        samples[key] = t_one + t_full
        committed[key] = list(priced)
    for name, v in out.items():
        check(min(np.atleast_1d(v)) > 0, f"geometry constant {name}: "
              f"measured {v}")
        log(f"[{CARD}] geometry constant {name}: {np.round(v, 4).tolist()} "
            f"us measured (times {[round(t, 2) for t in samples[name]]} us;"
            f" the geometry prices with {committed[name]})")
    return {"measured": out, "samples_us": samples, "committed": committed}


def _spearman(a, b):
    from scipy.stats import spearmanr

    return float(spearmanr(a, b).statistic)


def _hold_geometry(torch, np, backend, families, cell):
    """Phase 4d's hold of the launch geometry: every distinct launch of
    each family's launch space (one config a distinct record of the
    geometry, as many as ``inert_knobs`` counts) timed on the card by
    ``backend`` (median of 3 timings) beside the geometry's price; one
    profiled call of each (one profiler window a cell; launches whose
    record the profiler lost, profiled again) held to the priced record
    (kernel, grid, block, shared bytes); every ratio within
    ``GEOMETRY_RATIO``; Spearman's rho for a family of 3 or more distinct
    launches; and the kv_block ordering (:func:`_kv_order`)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.envs.measure import family_params
    from repro_torch.kernels import dispatch

    geometry = backend.geometry
    inert = inert_knobs(backend, families)
    launches = []
    for fam in families:
        distinct = {}
        for point in dispatch.launch_space([fam]).grid():
            params = family_params(fam, point)
            r = geometry.record(fam, params)
            distinct.setdefault((r.kernel, r.grid, r.block, r.smem),
                                (fam, params, r))
        check(len(distinct) == inert[fam]["distinct"],
              f"geometry {cell} {fam}: {len(distinct)} distinct records, "
              f"{inert[fam]['distinct']} distinct launches")
        launches += distinct.values()

    def priced(rec):
        return (rec.kernel, list(rec.grid), list(rec.block), rec.smem)

    # late in the script the profiler loses a window's first kernel
    # records (up to 5 of them in the runs of this phase): each window
    # opens with GEOMETRY_PAD small PyTorch kernels and one extra call,
    # every event must be a priced record, and a launch with no event is
    # profiled again
    pad = torch.zeros(16, device=backend.device)
    ran, todo = {}, list(range(len(launches)))
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(GEOMETRY_PAD):
                pad.add_(1.0)
            for i in todo[:1] + todo:
                fam, params, _ = launches[i]
                backend.call(fam, params)
            torch.cuda.synchronize()
        events = [[name, args.get("grid"), args.get("block"),
                   args.get("shared memory")]
                  for name, args in _kernel_events(prof)]
        wanted = [list(priced(launches[i][2])) for i in todo]
        stray = [e for e in events if e not in wanted]
        check(not stray, f"geometry {cell}: the card ran {stray}, which "
              f"the geometry priced for no launch of {wanted}")
        ran.update({i: w for i, w in zip(todo, wanted) if w in events})
        todo = [i for i in todo if i not in ran]
        if not todo:
            break
        on_device = sum(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events())
        log(f"geometry {cell}: no profiled record of {len(todo)} of the "
            f"launches (attempt {attempt}; {len(events)} of the port's "
            f"kernel records, {on_device} device events in the window)")
    check(not todo, f"geometry {cell}: the profiler recorded no launch of "
          f"{[launches[i][:2] for i in todo]} in {PROFILE_ATTEMPTS} windows")
    out = {fam: {"launches": []} for fam in families}
    for i, (fam, params, rec) in enumerate(launches):
        with torch.no_grad():
            card = [backend._time_us(lambda: backend.call(fam, params))
                    for _ in range(3)]
        t, grid, vmem, _, _ = geometry.family_cost(fam, params)
        med = float(np.median(card))
        out[fam]["launches"].append({
            "params": params, "kernel": rec.kernel, "grid": list(rec.grid),
            "block": list(rec.block), "smem": rec.smem, "priced_grid": grid,
            "priced_vmem": vmem, "profiled": ran[i], "card_us": card,
            "predicted_us": t, "ratio": t / med})
        log(f"[{CARD}] geometry {cell} {fam} {params}: card {med:.2f} us "
            f"({[round(c, 2) for c in card]}), predicted {t:.2f} us, ratio "
            f"{t / med:.3f}; grid {list(rec.grid)}, {rec.smem} shared "
            f"bytes")
    for fam, held in out.items():
        rows = held["launches"]
        ratios = [r["ratio"] for r in rows]
        held["rho"] = (_spearman([r["predicted_us"] for r in rows],
                                 [float(np.median(r["card_us"]))
                                  for r in rows])
                       if len(rows) >= 3 else None)
        held["ratio_range"] = [min(ratios), max(ratios)]
        log(f"[{CARD}] geometry {cell} {fam}: {len(rows)} distinct "
            f"launches, predicted / card {min(ratios):.3f}-"
            f"{max(ratios):.3f}" + ("" if held["rho"] is None
                                    else f", Spearman rho {held['rho']:.3f}"))
        for r in rows:
            check(1 / GEOMETRY_RATIO <= r["ratio"] <= GEOMETRY_RATIO,
                  f"geometry {cell} {fam} {r['params']}: predicted "
                  f"{r['predicted_us']:.2f} us, the card "
                  f"{float(np.median(r['card_us'])):.2f} us (ratio "
                  f"{r['ratio']:.3f}, outside 1/{GEOMETRY_RATIO:g}-"
                  f"{GEOMETRY_RATIO:g})")
        held["kv_order"] = _kv_order(np, cell, fam, rows)
    return out


def _kv_order(np, cell, fam, rows):
    """Launches of ``fam`` that differ only in ``kv_block``: where the card
    tells them apart (the gap of their medians over the sum of their
    timings' spreads), the geometry must order them the same way."""
    pairs = []
    for i, a in enumerate(rows):
        for b in rows[i + 1:]:
            pa, pb = a["params"], b["params"]
            if "kv_block" not in pa or pa["kv_block"] == pb["kv_block"] \
                    or {k: v for k, v in pa.items() if k != "kv_block"} \
                    != {k: v for k, v in pb.items() if k != "kv_block"}:
                continue
            gap = float(np.median(a["card_us"]) - np.median(b["card_us"]))
            noise = (max(a["card_us"]) - min(a["card_us"])
                     + max(b["card_us"]) - min(b["card_us"]))
            pred = a["predicted_us"] - b["predicted_us"]
            told = abs(gap) > noise
            agree = (gap > 0) == (pred > 0)
            pairs.append({"params": [pa, pb], "card_gap_us": gap,
                          "card_noise_us": noise, "predicted_gap_us": pred,
                          "told_apart": told, "agree": agree})
            log(f"[{CARD}] geometry {cell} {fam} kv_block {pa['kv_block']} "
                f"vs {pb['kv_block']} at {pa}: card {gap:+.2f} us (noise "
                f"{noise:.2f}), predicted {pred:+.2f} us: "
                + ("agree" if agree else "disagree")
                + ("" if told else " (the card does not tell them apart)"))
            check(agree or not told,
                  f"geometry {cell} {fam}: kv_block {pa['kv_block']} vs "
                  f"{pb['kv_block']} at {pa}: the card {gap:+.2f} us "
                  f"(noise {noise:.2f}), the geometry {pred:+.2f} us")
    return pairs


def _plain(backend, family, params):
    import inspect

    from repro_torch.kernels import dispatch

    fn = dispatch.ref_fn(family)
    accepted = inspect.signature(fn).parameters
    return fn(*backend.inputs(family),
              **{k: v for k, v in params.items() if k in accepted})


def phase_tune_launch(torch, np, dev, train_out):
    """Returns (summary, launches of the counted tuning runs)."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.envs.measure import WallClockBackend, family_params
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.launch.tune import launch_workload_for
    from repro_torch.obs import trace as obs_trace
    from repro_torch.tuner.runner import tune_kernel_launch
    from repro_torch.tuner.space import launch_families_for

    out = {"geometry_constants": measure_geometry_constants(torch, np, dev)}
    launches = {k: 0 for k in cuda_lib.LAUNCHES}
    n_checked = 0
    with dispatch.record_resolutions() as resolved:
        for kind, arch, batch, tokens, fams in TUNE_LAUNCH_CELLS:
            t_cell = time.perf_counter()
            cfg = get_model_config(arch)
            workload = launch_workload_for(cfg, batch, tokens, kind=kind)
            families = tuple(sorted(launch_families_for(cfg)))
            check(families == fams, f"tune_launch {arch}: families "
                  f"{families}, expected {fams}")
            cell = f"{kind} {arch}"
            # ---- the tuning run: counted, traced -------------------------
            check(obs_trace.active() is None,
                  "tune_launch: a tracer is already on")
            tracer = obs_trace.start()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            try:
                res = tune_kernel_launch(
                    workload, families=families, target_backend="wallclock",
                    target_opts={"device": dev}, **TUNE_LAUNCH)
                torch.cuda.synchronize()
            finally:
                obs_trace.stop()
            tune_s = time.perf_counter() - t0
            counted = dict(cuda_lib.LAUNCHES)
            for k, n in counted.items():
                launches[k] += n
            for fam in families:
                check(counted[FAMILY_KERNEL[fam]] > 0,
                      f"tune_launch {cell}: the tuning run launched no "
                      f"{FAMILY_KERNEL[fam]}")
            check(tracer.dropped == 0, "tune_launch: the trace dropped "
                  f"{tracer.dropped} events")
            events = tracer.events()
            spans = [e for e in events
                     if e["name"] == "measure" and e.get("cat") == "env"]
            check(spans and np.isfinite(res.best_y) and res.best_y > 0,
                  f"tune_launch {cell}: {len(spans)} measurements, best_y "
                  f"{res.best_y}")
            measure_s = sum(e["dur"] for e in spans) / 1e6
            inputs_s = sum(e["dur"] for e in events
                           if e["name"] == "inputs"
                           and e.get("cat") == "env") / 1e6
            tuner_s = tune_s - measure_s - inputs_s
            tuned = res.launch_config
            for e in spans:
                knobs = {k: v for k, v in e["args"]["config"].items()
                         if k.split(".")[0] in families}
                log(f"tune_launch {cell}: {knobs} -> "
                    f"{e['args']['y']:.2f} us "
                    f"{ {f: round(t, 2) for f, t in e['args']['family_us'].items()} }")
            # ---- outputs under every configuration measured ------------
            backend = WallClockBackend(workload, families,
                                       seed=TUNE_LAUNCH["seed"] + 2,
                                       device=dev)
            default = dispatch.launch_space(families).default_config()
            configs = [default, res.best_config] + [
                e["args"]["config"] for e in spans]
            seen = set()
            errs = {}
            for config in configs:
                key = tuple((f, tuple(sorted(family_params(f, config).items())))
                            for f in families)
                if key in seen:
                    continue
                seen.add(key)
                for fam in families:
                    params = family_params(fam, config)
                    with torch.no_grad():
                        got = backend.call(fam, params)
                        want = _plain(backend, fam, params)
                    err = _compare(torch, f"tune_launch {cell} {fam} "
                                   f"{params}", got, want, "bfloat16", [],
                                   False)
                    errs[fam] = max(errs.get(fam, 0.0), err)
                    n_checked += 1
            # ---- default and tuned remeasured in turns -----------------
            which = {"default": default, "tuned": res.best_config}
            remeasured = {"default": [], "tuned": []}
            for w in REMEASURE_ORDER:
                remeasured[w].append(backend.measure(which[w])[1])
            geometry = backend.geometry
            predicted = {w: geometry.totals(families, c)[1]
                         for w, c in which.items()}
            spread = {w: max(v) - min(v) for w, v in remeasured.items()}
            med = {w: float(np.median(v)) for w, v in remeasured.items()}
            gain = med["default"] - med["tuned"]
            inert = inert_knobs(backend, families)
            held = _hold_geometry(torch, np, backend, families, cell)
            out[cell] = {
                "workload": {"batch": batch, "tokens": tokens,
                             "d_model": workload.d_model,
                             "head_dim": workload.head_dim,
                             "channels": workload.channels,
                             "ssm_heads": workload.ssm_heads,
                             "ssm_state": workload.ssm_state},
                "families": families, "tune": TUNE_LAUNCH,
                "tuned": tuned, "best_y_us": res.best_y,
                "trace_best_y_us": res.trace_best_y,
                "measurements": [{"config": e["args"]["config"],
                                  "y_us": e["args"]["y"],
                                  "family_us": e["args"]["family_us"]}
                                 for e in spans],
                "default_us": remeasured["default"],
                "tuned_us": remeasured["tuned"],
                "spread_us": spread, "gain_us": gain,
                "gain_beyond_spread": gain > max(spread.values()),
                "source_predicted_us": predicted,
                "tune_s": tune_s, "measure_s": measure_s,
                "inputs_s": inputs_s, "tuner_share": tuner_s / tune_s,
                "launches": {k: v for k, v in counted.items() if v},
                "max_abs_err": errs, "inert_knobs": inert,
                "geometry": held, "extras": res.extras}
            log(f"tune_launch {cell}: tuned {tuned}, best_y "
                f"{res.best_y:.2f} us; remeasured default "
                f"{[round(v, 2) for v in remeasured['default']]} us, tuned "
                f"{[round(v, 2) for v in remeasured['tuned']]} us (gain "
                f"{gain:.2f} us against spreads {spread}); the source "
                f"predicted default {predicted['default']:.2f} / tuned "
                f"{predicted['tuned']:.2f} us; tuning {tune_s:.2f} s: "
                f"measuring {measure_s:.2f} s, inputs {inputs_s:.2f} s, "
                f"tuner {tuner_s:.2f} s (share {tuner_s / tune_s:.2f}); "
                f"launches "
                f"{out[cell]['launches']}; max |err| {errs}")
            for fam, v in inert.items():
                log(f"tune_launch {cell}: {fam}: {v['points']} points of "
                    f"the launch space give {v['distinct']} distinct "
                    f"launches {v['launches']}")
            log(f"tune_launch {cell} done in "
                f"{time.perf_counter() - t_cell:.1f} s")
            del backend
            torch.cuda.empty_cache()
        # ---- deployment: the tuned configs in the train steps ----------
        for kind, arch, *_ in TUNE_LAUNCH_CELLS:
            if kind == "train":
                out[f"{kind} {arch}"]["deployed"] = _train_tuned(
                    torch, np, dev, arch, out[f"{kind} {arch}"]["tuned"],
                    train_out[arch])
    modes = {(r.family, r.mode) for r in resolved}
    check(all(m == "cuda" for _, m in modes),
          f"tune_launch: dispatch resolved {sorted(modes)}; every "
          f"resolution must be cuda")
    out["serve_cli"] = _serve_cli_tuned()
    out["outputs_checked"] = n_checked
    log(f"tune_launch: {n_checked} kernel outputs agree with their plain "
        f"versions; every resolution cuda ({sorted(modes)})")
    return out, launches


def _train_tuned(torch, np, dev, arch, tuned, default_run):
    """Two steps of the depth-cut model under the tuned launch config,
    against the first two steps ``phase_train`` ran at the default
    config (the same seed, data and learning rates)."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import train

    cfg = get_model_config(arch).replace(num_layers=TRAIN[arch])
    want = dispatch.split_launch_config(tuned)
    with dispatch.record_resolutions() as rec:
        res = train(cfg, steps=2, seq=TRAIN_SHAPE["seq"],
                    batch=TRAIN_SHAPE["batch"], device=dev, seed=0,
                    launch_config=tuned)
        torch.cuda.synchronize()
    check(all(np.isfinite(res.losses)), f"tune_launch {arch}: losses "
          f"{res.losses}")
    resolved = {}
    for r in rec:
        for p, v in want.get(r.family, {}).items():
            domain = dispatch.get_family(r.family).option(p).values
            check(r.launch[p] == v and dispatch.snap_down(v, domain) == v,
                  f"tune_launch {arch}: {r.family}.{p} resolved "
                  f"{r.launch[p]}, tuned {v}")
        if r.family in want:
            resolved.setdefault(r.family, set()).add(
                tuple(sorted(r.launch.items())))
    check(set(resolved) == set(want), f"tune_launch {arch}: resolved "
          f"{sorted(resolved)}, tuned {sorted(want)}")
    for i in range(2):
        lk, lr_ = res.losses[i], default_run["losses"][i]
        gk, gr = res.grad_norms[i], default_run["grad_norms"][i]
        check(abs(lk - lr_) <= STEP_TOL["loss_rtol"] * abs(lr_),
              f"tune_launch {arch} step {i}: loss {lk} vs default {lr_}")
        check(abs(gk - gr) <= STEP_TOL["grad_norm_rtol"] * abs(gr),
              f"tune_launch {arch} step {i}: grad norm {gk} vs default "
              f"{gr}")
    log(f"tune_launch {arch}: 2 steps under {tuned}: losses {res.losses} "
        f"(default {default_run['losses'][:2]}), grad norms "
        f"{res.grad_norms} (default {default_run['grad_norms'][:2]}), "
        f"{[round(t * 1e3, 1) for t in res.step_s]} ms; resolved "
        f"{ {f: sorted(v) for f, v in resolved.items()} }")
    out = {"losses": res.losses, "grad_norms": res.grad_norms,
           "default_losses": default_run["losses"][:2],
           "default_grad_norms": default_run["grad_norms"][:2],
           "step_ms": [t * 1e3 for t in res.step_s],
           "resolved": {f: [dict(t) for t in sorted(v)]
                        for f, v in resolved.items()}}
    del res
    torch.cuda.empty_cache()
    return out


def _serve_cli_tuned():
    """The serve launcher's fixed batch, tuning its launch config on the
    card first (wallclock target)."""
    return _serve_cli(["--arch", ARCH, "--full-config", "--tune-launch", "4",
                       "--measure-backend", "wallclock"],
                      ("tuned launch config", "decode p50"))


# --------------------------------------------------------------------------
# phase 4e: SSM serving — falcon-mamba-7b and zamba2-2.7b served at full
# width and depth through the fixed batch, the continuous batcher and the
# serve CLI
# --------------------------------------------------------------------------

# the kernels each model's serving path must launch
SSM_SERVE_KERNELS = {
    "falcon-mamba-7b": ("selective_scan", "rmsnorm"),
    "zamba2-2.7b": ("ssd", "flash_attention", "decode_attention",
                    "paged_decode_attention", "rmsnorm"),
}
PREFILL_LENGTHS = (1, 16, 64, 200)  # one request's prompt, batch 1
PREFILL_REPS = 5
SSM_PROFILE_STEPS = 4


def _build_served(torch, dev, cfg, extras=None):
    """``cfg`` on the card with seeded weights, at the fixed batch: (model,
    run, params, prompt, init seconds), the peak memory counted from the
    init, one short serve run (with the batch's ``extras``) as warm-up."""
    from repro_torch.launch.serve import make_batch, serve_fixed_batch
    from repro_torch.models.model import build_model
    from repro_torch.utils.config import MeshConfig, RunConfig, ShapeConfig

    cache_len = FIXED["prompt_len"] + FIXED["gen"]
    run = RunConfig(model=cfg, shape=ShapeConfig("serve_cli", cache_len,
                                                 FIXED["batch"], "decode"),
                    mesh=MeshConfig(shape=(1,), axes=("data",)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, run.parallel, device=dev)
    params = model.init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = make_batch(cfg, run.shape, FIXED["batch"], FIXED["prompt_len"],
                        dev)["tokens"]
    serve_fixed_batch(model, run, params, prompt[:, :8], gen=2,
                      extras=extras)  # warm-up
    torch.cuda.synchronize()
    return model, run, params, prompt, init_s


def _counted_serve(torch, np, model, run, params, prompt, plans, kernels,
                   extras=None):
    """The main path with every launch counter set to 0 before: the fixed
    batch (with ``extras``; its first LOGIT_STEPS logits kept) and the
    batchers of ``plans``; every resolution ``cuda``, every kernel of
    ``kernels`` launched.  Returns (fixed, served, launches, prefill
    instances)."""
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.launch.serve import serve_fixed_batch

    what = model.cfg.name
    cuda_lib.reset_launches()
    with dispatch.profile_dispatches() as prof, \
            dispatch.record_resolutions() as resolved:
        fixed = serve_fixed_batch(model, run, params, prompt,
                                  gen=FIXED["gen"], keep_logits=LOGIT_STEPS,
                                  extras=extras)
        served = {name: _drain_batcher(torch, np, model, run, params,
                                       _serve_plans()[name])
                  for name in plans}
    launches = dict(cuda_lib.LAUNCHES)
    instances = dict(cuda_lib.PREFILL_INSTANCES)
    modes = {(r.family, r.mode) for r in resolved}
    log(f"{what} serving launches: {launches}; prefill instances "
        f"{instances}; resolutions "
        f"{ {k: v['resolutions'] for k, v in prof.summary().items()} }")
    check(bool(modes) and all(m == dispatch.CUDA for _, m in modes),
          f"{what} serving resolved {sorted(modes)}; every resolution must "
          f"be cuda")
    for name in kernels:
        check(launches[name] > 0,
              f"{what}: kernel {name} was not launched on the serving path")
    check(fixed.tokens.shape == (FIXED["batch"], FIXED["gen"]),
          f"{what} fixed batch tokens shape {fixed.tokens.shape}")
    return fixed, served, launches, instances


def phase_ssm_serve(torch, np, dev):
    """Each SSM model served at full size, then its serve CLI; returns the
    summaries, the launches of the counted runs, summed, and each model's
    phase 4f summary."""
    from repro_torch.kernels import cuda_lib

    out, compiled = {}, {}
    launches = {name: 0 for name in cuda_lib.LAUNCHES}
    for arch, kernels in SSM_SERVE_KERNELS.items():
        out[arch], counted, compiled[arch] = _serve_ssm(torch, np, dev, arch,
                                                        kernels)
        for name, n in counted.items():
            launches[name] += n
        torch.cuda.empty_cache()
        out[arch]["serve_cli"] = _serve_cli(
            ["--arch", arch, "--full-config"],
            ("decode p50", "decode graphs: 1 captured"))
    return out, launches, compiled


def _serve_ssm(torch, np, dev, arch, kernels):
    """One SSM model at full width and depth, seeded bf16 weights: the
    fixed batch and the three batchers counted (every resolution ``cuda``,
    every kernel of ``kernels`` launched, the same tokens in every
    geometry), the fixed batch's logits against the plain versions', the
    prefill time by prompt length and a profiled decode step."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.train.serve_step import jitted_steps

    cfg = get_model_config(arch)
    cache_len = FIXED["prompt_len"] + FIXED["gen"]
    model, run, params, prompt, init_s = _build_served(torch, dev, cfg)
    log(f"{arch}: {cfg.param_count() / 1e9:.3f} B params, {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.dtype}; init {init_s:.1f} s")
    fixed, served, launches, _ = _counted_serve(
        torch, np, model, run, params, prompt, list(_serve_plans()), kernels)
    _check_batchers(served, len(_requests(cfg, np)), arch)

    # ---- the plain-version run with the same weights, teacher-forced ----
    plain_logits = _plain_logits(torch, model, run, params, prompt,
                                 fixed.tokens, cache_len)
    atol = min(LOGIT_ATOL, SSM_LOGIT_ATOL_SHARE * max(
        float(pl.abs().max()) for pl in plain_logits))
    worst, decided, scale = _compare_logits(torch, fixed.logits,
                                            plain_logits, cfg.vocab_size,
                                            arch, atol)
    fixed_out = {**_fixed_batch_numbers(np, fixed),
                 "logits_max_abs_diff": worst, "argmax_decided_rows": decided,
                 "logits_tol": {"atol": atol, "rtol": LOGIT_RTOL},
                 "logits_max_abs": scale}
    log(f"{arch} fixed batch {FIXED['batch']}x{FIXED['prompt_len']}+"
        f"{FIXED['gen']}: prefill {fixed_out['prefill_ms']:.2f} ms, decode "
        f"p50 {fixed_out['decode_p50_ms']:.2f} ms p99 "
        f"{fixed_out['decode_p99_ms']:.2f} ms, {fixed_out['tok_s']:.1f} "
        f"tok/s")

    # ---- one request's prefill by prompt length (the batcher's step) ----
    prefill, _ = jitted_steps(model, run, cache_len=512)
    gen = torch.Generator(device=dev).manual_seed(5)
    prefill_ms = {}
    for length in PREFILL_LENGTHS:
        toks = torch.randint(0, cfg.vocab_size, (1, length), generator=gen,
                             device=dev, dtype=torch.int32)
        times = []
        for _ in range(PREFILL_REPS + 1):
            t1 = time.perf_counter()
            prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        prefill_ms[length] = float(np.median(times[1:]))
    log(f"{arch} prefill by prompt length (ms, median of {PREFILL_REPS}, "
        f"batch 1): {prefill_ms}")

    profile, _ = _profile_decode(torch, model, run, params, prompt,
                                 SSM_PROFILE_STEPS)
    if profile["device_busy_ms"]:
        log(f"{arch} decode step profile: "
            f"{profile['window_ms'] / SSM_PROFILE_STEPS:.2f} ms/step under "
            f"the profiler, device busy "
            f"{profile['device_busy_ms'] / SSM_PROFILE_STEPS:.2f} ms/step "
            f"(idle share {profile['idle_share']:.2f}), "
            f"{profile['launches_per_step']:.0f} kernels/step")
    else:
        log(f"{arch} decode step profile: the profiler recorded no device "
            f"time (not measured)")
    summary = {
        "arch": arch, "params": cfg.param_count(), "layers": cfg.num_layers,
        "d_model": cfg.d_model, "dtype": cfg.dtype, "init_s": init_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "fixed_batch": fixed_out, "prefill_ms_by_length": prefill_ms,
        "batcher": {k: {f: v[f] for f in ("completed", "ticks", "wall_s",
                                           "prefill_s", "decode_s", "tokens",
                                           "prefill_chunks")}
                    for k, v in served.items()},
        "launches": launches, "decode_profile": profile}
    # phase 4f's part for this model, on its weights before they are freed
    compiled = _compiled_decode(torch, np, dev, arch, model, run, params,
                                prompt, served)
    del model, params, prefill
    return summary, launches, compiled


# --------------------------------------------------------------------------
# phase 4f: the compiled decode step — jitted_steps' decode captured in a
# CUDA graph, held against the eager step and timed beside it
# --------------------------------------------------------------------------

#: the fixed batch in turns, so drift falls on both
COMPILED_RUNS = ("eager", "captured", "captured", "eager")
COMPILED_PROFILE_STEPS = 8
#: replays after which the launch counters are read
COMPILED_REPLAYS = 10
#: profiled windows taken at most until one holds every recorded launch
PROFILE_WINDOWS = 3
#: the scratch-growth check: slots of the captured decode, then of the
#: eager decode that grows the split decode's scratch
GROWTH_SLOTS = (4, 32)
#: the card's ``name, power.limit`` (nvidia-smi), beside every number
CARD = ""


def _fixed_batch_with(torch, np, step_pair, params, prompt, gen,
                      extras=None):
    """The fixed batch (with ``extras``) through ``step_pair`` = (prefill,
    decode), greedy:
    the tokens (B, gen) on the host, each decode step's host time in ms
    (synchronized; the first step, a captured step's capture, left out)
    and every decode step's logits (fp32 copies on the card)."""
    from repro_torch.train.serve_step import sample_token

    prefill, decode = step_pair
    state, logits = prefill(params, {"tokens": prompt, **(extras or {})})
    tok = sample_token(logits, None, 0.0)
    toks, lats, kept = [tok], [], []
    torch.cuda.synchronize()
    for _ in range(gen - 1):
        t1 = time.perf_counter()
        state, logits = decode(params, state, tok[:, None])
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t1) * 1e3)
        kept.append(logits.to(torch.float32, copy=True))
        tok = sample_token(logits, None, 0.0)
        toks.append(tok)
    return (torch.stack(toks, dim=1).cpu().numpy(), np.asarray(lats[1:]),
            kept)


#: the port's decode kernels by the symbol the profiler names them with
#: (dense and paged decode are one template; the vlm and audio steps'
#: cross-attention is the bf16 prefill kernel at one query row)
DECODE_KERNEL_SYMBOLS = {"rmsnorm": "rmsnorm_kernel",
                         "decode_attention": "decode_attention_kernel",
                         "paged_decode_attention": "decode_attention_kernel",
                         "flash_attention": "flash_attention_mma_kernel"}


def _calls_per_kernel_symbol(launches):
    """A capture's recorded launches by kernel symbol, a step."""
    check(set(launches) <= set(DECODE_KERNEL_SYMBOLS),
          f"a decode graph launched {sorted(launches)}; only "
          f"{sorted(DECODE_KERNEL_SYMBOLS)} are known to the profile check")
    out = {sym: 0 for sym in DECODE_KERNEL_SYMBOLS.values()}
    for name, n in launches.items():
        out[DECODE_KERNEL_SYMBOLS[name]] += n
    return out


def _calls_by_symbol(kernels):
    """Profiler calls of each port decode kernel symbol over a window,
    from ``_profile_decode``'s [(kernel, device ms, calls)]."""
    out = {sym: 0 for sym in DECODE_KERNEL_SYMBOLS.values()}
    for key, _, calls in kernels:
        for sym in out:
            if re.search(rf"\b{sym}\b", key):
                out[sym] += calls
    return out


def _graph_numbers(decode):
    """The newest graph of a captured decode step: capture ms, pool MB."""
    g = next(reversed(decode.graphs.values()))
    return g.capture_s * 1e3, g.pool_bytes / 2 ** 20


def _compiled_decode(torch, np, dev, arch, model, run, params, prompt,
                     served, extras=None):
    """Phase 4f for one model at full width and depth: the fixed batch
    through the eager and the captured step in turns (the same tokens
    and logits, host p50 / p99 and tok/s), both profiled (device busy,
    idle share, kernels a step; each port kernel's calls a replayed step
    against the launches the profiled graph's capture recorded), the
    captured graph's capture time and pool, the launch counters after
    COMPILED_REPLAYS replays against the eager step's, and each batcher
    of ``served`` (phase 4 / 4e / 4g: the captured step) again with the
    eager step, every decode step's logits bit for bit.  ``extras`` go
    with the prompt (the vlm's ``vision_embeds``, the audio model's
    ``frames``)."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.train.serve_step import (jitted_steps,
                                              make_decode_step,
                                              make_prefill_step)

    t0 = time.perf_counter()
    cache_len = FIXED["prompt_len"] + FIXED["gen"]
    pairs = {"eager": (make_prefill_step(model, run, cache_len=cache_len),
                       make_decode_step(model, run)),
             "captured": jitted_steps(model, run, cache_len=cache_len)}
    decode = pairs["captured"][1]
    captures = decode.captures
    runs = {"eager": [], "captured": []}
    for name in COMPILED_RUNS:
        runs[name].append(_fixed_batch_with(torch, np, pairs[name], params,
                                            prompt, FIXED["gen"], extras))
    captures = decode.captures - captures
    first = runs["eager"][0][0]
    for name, rs in runs.items():
        for toks, _, _ in rs:
            check(np.array_equal(toks, first),
                  f"{arch}: the {name} fixed batch's tokens differ from the "
                  f"eager step's")
    diff = max(float((a - b).abs().max()) for rs in runs.values()
               for r in rs for a, b in zip(runs["eager"][0][2], r[2]))
    check(diff == 0.0, f"{arch}: the fixed batch's logits differ between "
          f"runs of the eager and the captured step (max |diff| {diff}); the "
          f"same kernels with the same launches give the same bits")
    check(captures <= 2, f"{arch}: {captures} captures in two fixed-batch "
          f"runs (one a run at most)")
    capture_ms, pool_mb = _graph_numbers(decode)
    numbers, kernel_calls = {}, {}
    for name, rs in runs.items():
        lat = np.concatenate([r[1] for r in rs])
        prof, kernels = _profile_decode(torch, model, run, params, prompt,
                                        COMPILED_PROFILE_STEPS, pairs[name],
                                        extras)
        kernel_calls[name] = _calls_by_symbol(kernels)
        busy = prof["device_busy_ms"]
        numbers[name] = {
            "host_p50_ms": float(np.percentile(lat, 50)),
            "host_p99_ms": float(np.percentile(lat, 99)),
            "tok_s": float(FIXED["batch"] / np.mean(lat) * 1e3),
            "steps_timed": int(lat.size),
            "profiled_ms_per_step": prof["window_ms"]
            / COMPILED_PROFILE_STEPS,
            "device_busy_ms_per_step": (busy / COMPILED_PROFILE_STEPS
                                        if busy else None),
            "idle_share": prof["idle_share"],
            "kernels_per_step": prof["launches_per_step"]}

    # the profiled graph's kernels, as the card ran them: each port
    # kernel's calls over the replayed window are the launches its
    # capture recorded (which each replay adds to the counters) times
    # the steps.  The profiler's trace loses kernel records now and then
    # (one of 520-584 in a window, in either step; 2 of 40 and 12 of 200
    # in single windows), never adds one: a window may come one call
    # short of that, and a window that comes shorter is taken again, up
    # to PROFILE_WINDOWS windows, one of which must match.  The eager
    # window's calls are reported beside them
    recorded = next(reversed(decode.graphs.values())).capture.launches
    want = {sym: n * COMPILED_PROFILE_STEPS
            for sym, n in _calls_per_kernel_symbol(recorded).items()}

    def matches(calls):
        return all(want[sym] - 1 <= calls[sym] <= want[sym] for sym in want)
    windows = [kernel_calls["captured"]]
    while not matches(windows[-1]) and len(windows) < PROFILE_WINDOWS:
        _, kernels = _profile_decode(torch, model, run, params, prompt,
                                     COMPILED_PROFILE_STEPS,
                                     pairs["captured"], extras)
        windows.append(_calls_by_symbol(kernels))
    check(matches(windows[-1]),
          f"{arch}: the captured step's profiled port kernels over "
          f"{COMPILED_PROFILE_STEPS} replays, window by window {windows}; "
          f"its graph records {recorded} a step = {want}")

    # the launch counters: COMPILED_REPLAYS replays count COMPILED_REPLAYS
    # eager steps' launches
    state, logits = pairs["captured"][0](params, {"tokens": prompt,
                                                  **(extras or {})})
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    cuda_lib.reset_launches()
    pairs["eager"][1](params, state, tok)
    per_step = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    decode(params, state, tok)  # the capture for this state
    cuda_lib.reset_launches()
    for _ in range(COMPILED_REPLAYS):
        decode(params, state, tok)
    torch.cuda.synchronize()
    replayed = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    check(replayed == {k: COMPILED_REPLAYS * v for k, v in per_step.items()},
          f"{arch}: launch counters after {COMPILED_REPLAYS} replays "
          f"{replayed}, the eager step launches {per_step}")
    del state, logits

    # the batchers with the eager step against the captured ones
    batchers = {}
    for name in served:
        eager = _drain_batcher(torch, np, model, run, params,
                               _serve_plans()[name],
                               decode=make_decode_step(model, run))
        got = served[name]
        for f in ("completed", "ticks", "order", "generated",
                  "prefill_chunks"):
            check(eager[f] == got[f],
                  f"{arch}: the {name} batcher's {f} with the captured step "
                  f"differ from the eager step's")
        bdiff = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(eager["logits"], got["logits"]))
        check(len(eager["logits"]) == len(got["logits"]) and bdiff == 0.0,
              f"{arch}: the {name} batcher's decode logits with the "
              f"captured step differ from the eager step's (max |diff| "
              f"{bdiff} over {len(got['logits'])} steps)")
        batchers[name] = {"ticks": got["ticks"], "logits_max_abs_diff": bdiff,
                          "decode_s": {"eager": eager["decode_s"],
                                       "captured": got["decode_s"]},
                          "wall_s": {"eager": eager["wall_s"],
                                     "captured": got["wall_s"]}}
    out = {"card": CARD, "tokens_equal": True, "logits_max_abs_diff": diff,
           "captures": captures, "capture_ms": capture_ms,
           "graph_pool_mb": pool_mb, "fixed_batch": numbers,
           "launches_per_step": per_step, "replays_counted": COMPILED_REPLAYS,
           "profiled_calls": {**kernel_calls,
                              "steps": COMPILED_PROFILE_STEPS,
                              "recorded": want,
                              "captured_windows": windows},
           "batchers": batchers, "phase_s": time.perf_counter() - t0}
    e, c = numbers["eager"], numbers["captured"]
    log(f"[{CARD}] {arch} compiled decode (fixed batch {FIXED['batch']}x"
        f"{FIXED['prompt_len']}+{FIXED['gen']}): tokens equal, logits max "
        f"|diff| {diff}; host p50 / p99 eager {e['host_p50_ms']:.2f} / "
        f"{e['host_p99_ms']:.2f} ms, captured {c['host_p50_ms']:.2f} / "
        f"{c['host_p99_ms']:.2f} ms; tok/s {e['tok_s']:.1f} -> "
        f"{c['tok_s']:.1f}; capture {capture_ms:.1f} ms, pool "
        f"{pool_mb:.1f} MB")
    for name, n in numbers.items():
        busy = n["device_busy_ms_per_step"]
        log(f"[{CARD}] {arch} {name} step under the profiler: "
            + (f"device busy {busy:.3f} ms/step, idle share "
               f"{n['idle_share']:.3f}, {n['kernels_per_step']:.0f} "
               f"kernels/step" if busy else "no device time recorded "
               "(not measured)"))
    log(f"[{CARD}] {arch} batchers, decode s eager -> captured: "
        + ", ".join(f"{k} {v['decode_s']['eager']:.3f} -> "
                    f"{v['decode_s']['captured']:.3f}"
                    for k, v in batchers.items())
        + f"; logits equal; launches a step {per_step} x "
          f"{COMPILED_REPLAYS} replays counted; over "
          f"{COMPILED_PROFILE_STEPS} profiled steps the graph records "
          f"{want}, the profiler saw {windows} captured (window by "
          f"window), {kernel_calls['eager']} eager")
    return out


def _scratch_growth(torch, np, model, run, params, prompt):
    """A GROWTH_SLOTS[0]-slot decode captured on a fresh split-decode
    scratch; a GROWTH_SLOTS[1]-slot eager decode grows the scratch (its
    old tensors are now held by the graph alone) and fresh NaN tensors
    take the freed memory; the graph's replays still give the eager
    step's logits."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.train.serve_step import (CapturedDecode,
                                              make_decode_step,
                                              make_prefill_step)
    from repro_torch.utils.trees import tree_map

    small_b, big_b = GROWTH_SLOTS
    cache_len = FIXED["prompt_len"] + FIXED["gen"]
    prefill = make_prefill_step(model, run, cache_len=cache_len)
    eager = make_decode_step(model, run)
    captured = CapturedDecode(make_decode_step(model, run))
    cuda_lib._decode_scratch.clear()  # the capture takes a fresh scratch
    state, logits = prefill(params, {"tokens": prompt[:small_b]})
    ref = tree_map(torch.clone, state)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    captured(params, state, tok)
    eager(params, ref, tok)
    key = state.lengths.device
    small = cuda_lib._decode_scratch[key][0].numel()
    big_prompt = prompt[:1].repeat(big_b, 1)
    big, big_logits = prefill(params, {"tokens": big_prompt})
    eager(params, big, big_logits.argmax(-1).to(torch.int32)[:, None])
    grown = cuda_lib._decode_scratch[key][0].numel()
    check(grown > small, f"scratch growth: a {big_b}-slot decode left the "
          f"scratch at {grown} floats (the {small_b}-slot one took {small})")
    del big, big_logits
    junk = [torch.full((1 << 22,), float("nan"), device=prompt.device)
            for _ in range(16)]
    worst = 0.0
    for _ in range(3):
        _, lg = captured(params, state, tok)
        _, ref_lg = eager(params, ref, tok)
        worst = max(worst, float((lg.float() - ref_lg.float()).abs().max()))
        check(torch.equal(lg, ref_lg), f"scratch growth: the {small_b}-slot "
              f"graph's replay differs from the eager step (max |diff| "
              f"{worst})")
    del junk
    log(f"[{CARD}] scratch growth: {small_b}-slot graph captured on a "
        f"{small}-float scratch, a {big_b}-slot eager decode grew it to "
        f"{grown}; 3 replays equal the eager step's logits")
    return {"slots": list(GROWTH_SLOTS), "scratch_floats": [small, grown],
            "replays_equal": True}


# --------------------------------------------------------------------------
# phase 4g: the MoE family (deepseek-v3-671b with MLA, llama4-maverick) and
# the three carried dense configs served on the card
# --------------------------------------------------------------------------

#: arch -> (depth cuts, the batchers it runs, the kernels its serving path
#: must launch, the prefill kernel instance (q/k dim, v dim, windowed,
#: causal) it must launch; danube's 64-token prompts leave its 4096-row window
#: unused, its long prompt runs the windowed instance).  Widths are the published ones; the depth is cut where one
#: 80 GB card forces it: deepseek's 2 of 61 MoE layers are 45 GB of
#: experts (its MTP head is never read when serving), llama4's one
#: super-block (a dense and a MoE layer) of 24 is 32 GB, and the dense
#: configs' init draws a stacked weight in fp32 twice
MOE_SERVE = {
    "deepseek-v3-671b": (dict(num_layers=2, mtp_depth=0), ("dense",),
                         ("rmsnorm", "flash_attention"),
                         (192, 128, False, True)),
    "llama4-maverick-400b-a17b": (
        dict(num_layers=2), ("dense", "paged", "paged_chunked"),
        ("rmsnorm", "flash_attention", "decode_attention",
         "paged_decode_attention"), (128, 128, False, True)),
    "h2o-danube-1.8b": ({}, ("dense",),
                        ("rmsnorm", "flash_attention", "decode_attention"),
                        (80, 80, False, True)),
    "nemotron-4-15b": (dict(num_layers=8), (),
                       ("rmsnorm", "flash_attention", "decode_attention"),
                       (128, 128, False, True)),
    "command-r-35b": (dict(num_layers=8), (),
                      ("rmsnorm", "flash_attention", "decode_attention"),
                      (128, 128, False, True)),
}
#: one request longer than the model's window: the ring cache packs at
#: prefill, the windowed prefill runs, decode reads the ring
LONG_PROMPT = {"h2o-danube-1.8b": 4608}
LONG_GEN = 8
#: the largest share of (token, k) expert choices allowed to differ
#: between the kernel run and the plain run (bf16 rounding near a tie)
MAX_FLIPPED_SHARE = 0.01
#: a flipped choice of a row whose routes agreed so far is a near tie:
#: in the plain run, the k-th chosen expert's router logit exceeds the
#: kernel run's choice's by less than this share of the token's max
#: |router logit| (each of the two logits moved by at most one bf16
#: rounding, 2^-7, of that scale)
NEAR_TIE_SHARE = 2.0 ** -6


def phase_moe_serve(torch, np, dev):
    """Each model of MOE_SERVE served on the card in turn, then the serve
    CLI at both MoE smoke configs; returns the summaries and the launches
    of the counted runs, summed."""
    from repro_torch.kernels import cuda_lib

    out = {}
    launches = {name: 0 for name in cuda_lib.LAUNCHES}
    for arch, spec in MOE_SERVE.items():
        out[arch], counted = _serve_family(torch, np, dev, arch, *spec)
        for name, n in counted.items():
            launches[name] += n
    for arch in ("deepseek-v3-671b", "llama4-maverick-400b-a17b"):
        out[arch]["serve_cli"] = _serve_cli(
            ["--arch", arch], ("decode p50", "decode graphs: 1 captured"))
    return out, launches


def _route_agreement(torch, cfg, batch, kernel_routes, plain_routes,
                     steps=LOGIT_STEPS):
    """The kernel run's and the plain run's routes (``_recorded_routes``),
    MoE layer by layer, step by step (prefill, then the decode steps): the
    share of (token, k) choices that differ; for each step the (B,) mask
    of rows whose every token so far chose and kept the same experts in
    every MoE layer (a kept set also depends on the other tokens of the
    group through the capacity), so a row is held up to the step before
    its first differing route; and the gaps of the first flips.  A flip in
    a row that agreed until this layer call (its router input differs
    from the plain run's only by rounding) must be a near tie in the plain
    run (NEAR_TIE_SHARE); a later flip in a row that already differs is
    its consequence.  Prefill (the first of ``steps`` forwards; a train
    step's one forward) drops past the capacity; decode is dropless."""
    from repro_torch.models.moe import capacity, queue_positions

    n_moe = len(kernel_routes) // steps
    check(len(kernel_routes) == len(plain_routes) == n_moe * steps
          and n_moe > 0, f"{cfg.name}: {len(kernel_routes)} / "
          f"{len(plain_routes)} routed calls, not {steps} steps' worth")
    k = cfg.moe_top_k
    flipped = total = 0
    gaps = []  # each first flip's plain-run gap / the token's max |logit|
    held, agree = [], torch.ones(batch, dtype=torch.bool)
    for i, ((_, a), (lp, p)) in enumerate(zip(kernel_routes, plain_routes)):
        check(a.shape == p.shape, f"{cfg.name}: routes {tuple(a.shape)} vs "
              f"{tuple(p.shape)}")
        cap = capacity(cfg, a.shape[1], dropless=i >= n_moe)

        def kept(idx):
            _, pos = queue_positions(idx, cfg.moe_num_experts)
            return torch.where(pos < cap, idx, -1)
        sa, sp = a.sort(-1).values, p.sort(-1).values
        ka, kp = kept(a).sort(-1).values, kept(p).sort(-1).values
        shared = (a[..., :, None] == p[..., None, :]).any(-1)  # (G, Tg, k)
        flipped += int((~shared).sum())
        total += a.numel()
        # the kernel run's choices the plain run left out, against the
        # plain run's k-th choice, in the plain run's router logits
        kth = lp.gather(-1, p).min(-1).values
        gap = (kth[..., None] - lp.gather(-1, a)) / \
            lp.abs().amax(-1)[..., None]
        first = ~shared & agree[:, None].expand(batch, a.shape[0] * a.shape[1]
                                                // batch).reshape(
            a.shape[:2])[..., None]
        gaps += gap[first].tolist()
        token_ok = ((sa == sp).all(-1) & (ka == kp).all(-1)).reshape(
            batch, -1)
        agree &= token_ok.all(-1)
        if i % n_moe == n_moe - 1:
            held.append(agree.clone())
    worst = max(gaps, default=0.0)
    check(worst < NEAR_TIE_SHARE,
          f"{cfg.name}: a first flipped expert choice is no near tie: its "
          f"plain-run gap is {worst:.3e} of the token's max |router logit| "
          f"(limit {NEAR_TIE_SHARE:.3e}; gaps {sorted(gaps)})")
    return flipped / total, held, total, gaps


def _serve_family(torch, np, dev, arch, overrides, plans, kernels, instance,
                  key=None):
    """One model at published widths (its depth cut by ``overrides``),
    seeded bf16 weights: the fixed batch and the batchers of ``plans``
    counted (every resolution ``cuda``, every kernel of ``kernels`` and the
    prefill ``instance`` launched), the teacher-forced eager kernel run
    equal to the served logits and held against the plain run (for MoE:
    the routes compared first, the logits of the rows whose routes agree
    held), the long prompt through the ring cache where the model has a
    window, and phase 4f's compiled decode on its weights.  With ``key``
    (the vlm / audio families) the fixed batch carries that stub frontend
    input in bf16 (the CLI's fp32 data, cast), the vision model's cross
    gates are opened (``_open_cross_gates``), ``_cross_path`` holds the
    cross path and the CLI's fp32 inputs, and the captured step must
    launch the cross-attention."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.model import count_params_analytic
    from repro_torch.train import serve_step
    from repro_torch.utils.config import ShapeConfig

    t_model = time.perf_counter()
    full = get_model_config(arch)
    cfg = full.replace(**overrides)
    cache_len = FIXED["prompt_len"] + FIXED["gen"]
    torch.cuda.empty_cache()
    extras = f32 = None
    if key:
        f32 = {key: make_batch(cfg, ShapeConfig("serve_cli", cache_len,
                                                FIXED["batch"], "decode"),
                               FIXED["batch"], FIXED["prompt_len"],
                               dev)[key]}
        extras = {key: f32[key].to(torch.bfloat16)}
    model, run, params, prompt, init_s = _build_served(torch, dev, cfg,
                                                       extras)
    gates = _open_cross_gates(torch, dev, cfg, params)
    n_params = count_params_analytic(cfg)
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    resident_gb = torch.cuda.memory_allocated() / 1e9
    log(f"[{CARD}] {arch}: {n_params / 1e9:.3f} B params "
        f"({count_params_analytic(cfg, True) / 1e9:.3f} B active), "
        f"{cfg.num_layers} of {full.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers"
           if cfg.family == "audio" else "")
        + f", d_model {cfg.d_model}, {cfg.dtype}"
        + (f", {key} {tuple(extras[key].shape)}" if key else "")
        + f"; init {init_s:.1f} s, peak {init_peak_gb:.2f} GB, resident "
        f"{resident_gb:.2f} GB"
        + (f"; cross gates {[round(x, 3) for x in gates]}" if gates else ""))
    fixed, served, launches, instances = _counted_serve(
        torch, np, model, run, params, prompt, plans, kernels, extras)
    check(instances.get(instance, 0) > 0,
          f"{arch}: the prefill instance {instance} was not launched "
          f"({instances})")
    # a MoE layer's capacity follows the chunk's tokens: chunked prefill
    # drops other tokens than whole-prompt prefill, so a MoE model's
    # chunked tokens are not compared with the dense batcher's; paging
    # alone prefills each prompt whole and decodes dropless, so its tokens
    # are the dense batcher's
    _check_batchers(served, len(_requests(cfg, np)), arch, tuple(
        name for name in ("paged", "paged_chunked") if name in served
        and not (cfg.is_moe and name == "paged_chunked")))

    # ---- the kernels against the plain versions, teacher-forced ---------
    kernel_logits, kernel_routes = _forced_logits(
        torch, model, run, params, prompt, fixed.tokens, cache_len,
        dispatch.CUDA, extras)
    for step, (a, b) in enumerate(zip(kernel_logits, fixed.logits)):
        check(torch.equal(a, b), f"{arch} step {step}: the eager kernel "
              f"run's logits differ from the served (captured) run's")
    plain_logits, plain_routes = _forced_logits(
        torch, model, run, params, prompt, fixed.tokens, cache_len,
        dispatch.REF, extras)
    routing = None
    held = None
    if cfg.is_moe:
        share, held, choices, gaps = _route_agreement(
            torch, cfg, FIXED["batch"], kernel_routes, plain_routes)
        routing = {"flipped_share": share, "choices": choices,
                   "held_rows": [int(h.sum()) for h in held],
                   "max_flipped_share": MAX_FLIPPED_SHARE,
                   "first_flip_gaps": gaps,
                   "near_tie_share": NEAR_TIE_SHARE}
        log(f"{arch} routes, kernel vs plain run: {share * 100:.3f}% of "
            f"{choices} (token, k) choices differ (limit "
            f"{MAX_FLIPPED_SHARE * 100:.0f}%); first flips' plain-run gaps "
            f"/ max |router logit| {[f'{g:.2e}' for g in sorted(gaps)]} "
            f"(limit {NEAR_TIE_SHARE:.2e}); rows held a step "
            f"{routing['held_rows']}")
        check(share < MAX_FLIPPED_SHARE,
              f"{arch}: {share:.4f} of the expert choices flipped between "
              f"the kernel and the plain run")
        check(sum(routing["held_rows"]) > 0,
              f"{arch}: no row's routes agree; no logits to hold")
    atol = min(LOGIT_ATOL, SSM_LOGIT_ATOL_SHARE * max(
        float(pl.abs().max()) for pl in plain_logits))
    worst, decided, scale = _compare_logits(
        torch, kernel_logits, plain_logits, cfg.vocab_size, arch, atol,
        held=held)
    fixed_out = {**_fixed_batch_numbers(np, fixed),
                 "logits_max_abs_diff": worst, "argmax_decided_rows": decided,
                 "logits_tol": {"atol": atol, "rtol": LOGIT_RTOL},
                 "logits_max_abs": scale, "routing": routing}
    log(f"[{CARD}] {arch} fixed batch {FIXED['batch']}x"
        f"{FIXED['prompt_len']}+{FIXED['gen']}: prefill "
        f"{fixed_out['prefill_ms']:.2f} ms, decode p50 "
        f"{fixed_out['decode_p50_ms']:.2f} ms p99 "
        f"{fixed_out['decode_p99_ms']:.2f} ms, {fixed_out['tok_s']:.1f} "
        f"tok/s")
    long_out = None
    if arch in LONG_PROMPT:
        long_out = _long_prompt(torch, np, dev, model, run, params,
                                LONG_PROMPT[arch], (*instance[:2], True, True))
    cross = None
    if key:
        cross = _cross_path(torch, np, arch, model, run, params, prompt,
                            fixed, extras, f32, kernel_logits, atol)
        cross["cross_gates"] = gates

    # ---- phase 4f on this model's weights -------------------------------
    compiled = _compiled_decode(torch, np, dev, arch, model, run, params,
                                prompt, served, extras)
    graph = None
    if key:
        decode = serve_step.jitted_steps(model, run, cache_len=cache_len)[1]
        capture = next(reversed(decode.graphs.values())).capture
        want = compiled["profiled_calls"]["recorded"]
        check(capture.launches.get("flash_attention", 0) > 0
              and capture.instances.get(instance, 0) > 0
              and want[DECODE_KERNEL_SYMBOLS["flash_attention"]] > 0,
              f"{arch}: the captured decode step records no cross-attention "
              f"({capture.launches}, {capture.instances}, {want})")
        graph = {"launches_per_step": capture.launches,
                 "prefill_instances": {str(k): v for k, v in
                                       capture.instances.items()}}
        log(f"[{CARD}] {arch}: the captured step launches "
            f"{capture.launches}, prefill instances {capture.instances}")
        del decode, capture
    step_bytes = _decode_weight_bytes(cfg, params)
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    busy = compiled["fixed_batch"]["captured"]["device_busy_ms_per_step"]
    log(f"[{CARD}] {arch} decode step reads {step_bytes / 1e9:.2f} GB of "
        f"weights: >= {floor_ms:.2f} ms at 3.35 TB/s; captured device busy "
        + (f"{busy:.2f} ms ({floor_ms / busy * 100:.0f}% of the floor)"
           if busy else "not measured"))
    summary = {
        "card": CARD, "arch": arch, "params": n_params,
        "active_params": count_params_analytic(cfg, True),
        "layers": cfg.num_layers, "full_layers": full.num_layers,
        "encoder_layers": cfg.encoder_layers,
        "reduced": overrides, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "extras": {k: list(v.shape) for k, v in (extras or {}).items()},
        "init_s": init_s, "init_peak_gb": init_peak_gb,
        "resident_gb": resident_gb,
        "fixed_batch": fixed_out,
        "batcher": {k: {f: v[f] for f in ("completed", "ticks", "wall_s",
                                           "prefill_s", "decode_s", "tokens",
                                           "prefill_chunks")}
                    for k, v in served.items()},
        "launches": launches,
        "prefill_instances": {str(k): v for k, v in instances.items()},
        "long_prompt": long_out, "cross_path": cross,
        "compiled_decode": compiled, "captured_cross": graph,
        "decode_weight_bytes": step_bytes, "decode_floor_ms": floor_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, params, fixed, served
    serve_step._jitted_steps_cached.cache_clear()  # the graphs' pools
    torch.cuda.empty_cache()
    summary["phase_s"] = time.perf_counter() - t_model
    log(f"[{CARD}] {arch} served in {summary['phase_s']:.1f} s, peak "
        f"memory {summary['peak_memory_gb']:.2f} GB")
    return summary, launches


def _decode_weight_bytes(cfg, params):
    """The weight bytes a decode step reads: every parameter but the
    encoder's (ENCODER_KEYS), and but the embedding table where the head
    is not tied (a tied table is the head, read whole); a MoE layer's
    dense dispatch computes every expert on its capacity rows."""
    from repro_torch.utils.trees import tree_leaves

    kept = {k: v for k, v in params.items() if k not in ENCODER_KEYS}
    if not cfg.tie_embeddings:
        kept["embed"] = {k: v for k, v in kept["embed"].items()
                         if k != "embedding"}
    return sum(x.numel() * x.element_size() for x in tree_leaves(kept))


def _long_prompt(torch, np, dev, model, run, params, length, instance):
    """One request of ``length`` tokens, longer than the model's window:
    the prefill packs the last ``window`` keys into the ring cache and
    runs the windowed prefill instance, decode attends over the ring with
    its lengths clamped; the logits against the plain run."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.serve import serve_fixed_batch
    from repro_torch.train.serve_step import make_prefill_step

    cfg = model.cfg
    window = cfg.sliding_window
    check(length > window > 0, f"{cfg.name}: prompt {length}, window "
          f"{window}")
    gen = torch.Generator(device=dev).manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (1, length), generator=gen,
                           device=dev, dtype=torch.int32)
    cache_len = length + LONG_GEN
    cuda_lib.reset_launches()
    res = serve_fixed_batch(model, run, params, prompt, gen=LONG_GEN,
                            keep_logits=LOGIT_STEPS)
    launches = dict(cuda_lib.LAUNCHES)
    instances = dict(cuda_lib.PREFILL_INSTANCES)
    check(instances.get(instance, 0) > 0 and launches["decode_attention"] > 0,
          f"{cfg.name} long prompt: launches {launches}, prefill instances "
          f"{instances}")
    state, _ = make_prefill_step(model, run, cache_len=cache_len)(
        params, {"tokens": prompt})
    rows = state.caches["sub0"].k.shape[2]
    check(rows == window and int(state.lengths[0]) == length,
          f"{cfg.name} long prompt: the cache holds {rows} rows (the window "
          f"is {window}) at length {int(state.lengths[0])}")
    del state
    plain = _plain_logits(torch, model, run, params, prompt, res.tokens,
                          cache_len)
    atol = min(LOGIT_ATOL, SSM_LOGIT_ATOL_SHARE * max(
        float(pl.abs().max()) for pl in plain))
    worst, decided, _ = _compare_logits(
        torch, res.logits, plain, cfg.vocab_size,
        f"{cfg.name} long prompt {length}", atol, batch=1)
    lat = np.asarray(res.decode_s[1:]) * 1e3
    out = {"prompt_len": length, "window": window, "ring_rows": rows,
           "prefill_ms": res.prefill_s * 1e3,
           "decode_p50_ms": float(np.percentile(lat, 50)),
           "launches": launches,
           "prefill_instances": {str(k): v for k, v in instances.items()},
           "logits_max_abs_diff": worst, "argmax_decided_rows": decided,
           "logits_tol": {"atol": atol, "rtol": LOGIT_RTOL}}
    log(f"[{CARD}] {cfg.name} long prompt 1x{length} (window {window}, "
        f"ring of {rows} rows): prefill {out['prefill_ms']:.1f} ms, decode "
        f"p50 {out['decode_p50_ms']:.2f} ms; launches {launches}")
    return out


# --------------------------------------------------------------------------
# phase 4h: the vlm and audio families (llama-3.2-vision-11b with gated
# cross-attention, the whisper-large-v3 encoder-decoder) at full depth
# --------------------------------------------------------------------------

#: arch -> (the key of its stub frontend's input, the non-causal prefill
#: instance its cross-attention (and whisper's encoder) must launch).
#: Published widths and full depth: 10.1 B / 1.5 B parameters fit one card
VLM_AUDIO = {
    "llama-3.2-vision-11b": ("vision_embeds", (128, 128, False, False)),
    "whisper-large-v3": ("frames", (64, 64, False, False)),
}
VLM_AUDIO_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
#: decode steps timed with the serve CLI's fp32 inputs (the first, the
#: capture, left out)
F32_EXTRAS_GEN = 8
#: parameters the decode step does not read: the encoder's
ENCODER_KEYS = ("enc_blocks", "frame_proj", "enc_norm")


def phase_vlm_audio_serve(torch, np, dev):
    """Each model of VLM_AUDIO served on the card in turn (the vision
    model freed before whisper is built), then the serve CLI with
    whisper-large-v3 at its full config; returns the summaries and the
    launches of the counted runs, summed."""
    from repro_torch.kernels import cuda_lib

    out = {}
    launches = {name: 0 for name in cuda_lib.LAUNCHES}
    for arch, (key, instance) in VLM_AUDIO.items():
        out[arch], counted = _serve_family(torch, np, dev, arch, {}, (),
                                           VLM_AUDIO_KERNELS, instance, key)
        for name, n in counted.items():
            launches[name] += n
    out["whisper-large-v3"]["serve_cli"] = _serve_cli(
        ["--arch", "whisper-large-v3", "--full-config"],
        ("decode p50", "decode graphs: 1 captured"))
    return out, launches


def _open_cross_gates(torch, dev, cfg, params):
    """The vision model's cross gates set to seeded values of either sign,
    |g| in [0.5, 1.5] (their init, tanh(0), makes every cross sublayer a
    no-op); None for a model without gates."""
    from repro_torch.models.transformer import block_pattern

    if cfg.family != "vlm":
        return None
    gate = params["blocks"][f"sub{len(block_pattern(cfg)) - 1}"][
        "cross_gate"]
    g = torch.Generator(device=dev).manual_seed(13)
    n = gate.shape[0]
    mag = 0.5 + torch.rand(n, generator=g, device=dev)
    sign = torch.where(torch.rand(n, generator=g, device=dev) < 0.5, -1.0,
                       1.0)
    gate.copy_(mag * sign)
    gates = gate.float().cpu().tolist()
    check(all(abs(x) >= 0.5 for x in gates),
          f"{cfg.name}: cross gates {gates}")
    return gates


def _cross_layer(cfg, params):
    """The model's first cross layer (its ``cross_norm`` and ``cross``
    parameters, unstacked) and its number of cross layers."""
    from repro_torch.models.transformer import block_pattern

    if cfg.family == "vlm":
        stacked = params["blocks"][f"sub{len(block_pattern(cfg)) - 1}"]
    else:
        stacked = params["dec_blocks"]
    layer = {name: {k: v[0] for k, v in stacked[name].items()}
             for name in ("cross_norm", "cross")}
    return layer, stacked["cross"]["wk"].shape[0]


def _hold(torch, what, kernel, plain, control):
    """A tensor of the cross path held directly: the kernel run's within
    TOL's pair for its dtype of the plain run's, the atol scaled by the
    plain tensor's max |x| (a cross sublayer's output is a few hundredths,
    below TOL's bf16 atol).  The same hold must reject ``control`` (the
    kernel run's tensor from another slot's source), or it could not see
    the path."""
    dn = str(plain.dtype).split(".")[1]
    share, rtol = TOL[dn]
    p = plain.float()
    scale = float(p.abs().max())
    atol = share * scale
    err = _compare(torch, what, kernel, plain, dn, [], False, (atol, rtol))
    tol = atol + rtol * p.abs()
    used = float(((kernel.float() - p).abs() / tol).max())
    off = (control.float() - p).abs()
    rejected = float((off > tol).float().mean())
    check(rejected > 0, f"{what}: the control (another slot's source) "
          f"passes the hold (atol {atol:.3e}, rtol {rtol}), so the hold "
          f"cannot see the path")
    norm = float(torch.linalg.vector_norm(p))
    out = {"max_abs_err": err, "atol": atol, "rtol": rtol, "max_abs": scale,
           "tol_used": used,
           "rel_err": float(torch.linalg.vector_norm(kernel.float() - p))
           / norm,
           "control_max_abs_diff": float(off.max()),
           "control_rel_diff": float(torch.linalg.vector_norm(
               control.float() - p)) / norm,
           "control_rejected_share": rejected}
    log(f"{what}: kernel vs plain max |err| {err:.3e} (tol {atol:.3e} + "
        f"{rtol}|x|, max |x| {scale:.3e}; at most {used:.2f} of the "
        f"tolerance), relative {out['rel_err']:.2e}; "
        f"the control differs by {out['control_max_abs_diff']:.3e} "
        f"(relative {out['control_rel_diff']:.2e}), "
        f"{rejected * 100:.1f}% of it rejected")
    return out


def _cross_path(torch, np, arch, model, run, params, prompt, fixed, extras,
                f32, kernel_logits, atol):
    """What phase 4h adds for a model with a cross path: the CLI's fp32
    inputs (prefill and LOGIT_STEPS - 1 decode steps, kernel against plain,
    and the captured step timed); direct holds (``_hold``) of whisper's
    encoder output and of the first cross sublayer at the prefill's and at
    a decode step's query rows, over the served bf16 source and the CLI's
    fp32 one; how far another slot's source moves the logits (against
    their tolerance: at full width the residual stream dwarfs the cross
    path, so the logits alone cannot hold it); and what recomputing the
    cross K/V costs a step."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.serve import serve_fixed_batch
    from repro_torch.models import attention as attn
    from repro_torch.models.encdec import encode
    from repro_torch.models.layers import apply_rmsnorm
    from repro_torch.models.model import torch_dtype

    cfg, par = model.cfg, run.parallel
    (key,) = extras
    cache_len = FIXED["prompt_len"] + FIXED["gen"]

    # ---- the serve CLI's fp32 inputs: the promotion path ---------------
    f32_kernel, _ = _forced_logits(torch, model, run, params, prompt,
                                   fixed.tokens, cache_len, dispatch.CUDA,
                                   f32)
    f32_plain = _plain_logits(torch, model, run, params, prompt,
                              fixed.tokens, cache_len, f32)
    f32_atol = min(LOGIT_ATOL, SSM_LOGIT_ATOL_SHARE * max(
        float(pl.abs().max()) for pl in f32_plain))
    f32_worst, f32_decided, _ = _compare_logits(
        torch, f32_kernel, f32_plain, cfg.vocab_size,
        f"{arch} with the CLI's fp32 {key}", f32_atol)
    res = serve_fixed_batch(model, run, params, prompt, gen=F32_EXTRAS_GEN,
                            extras=f32)
    f32_lat = np.asarray(res.decode_s[1:]) * 1e3
    f32_out = {"logits_max_abs_diff": f32_worst,
               "argmax_decided_rows": f32_decided,
               "logits_tol": {"atol": f32_atol, "rtol": LOGIT_RTOL},
               "prefill_ms": res.prefill_s * 1e3,
               "decode_p50_ms": float(np.percentile(f32_lat, 50)),
               "decode_p99_ms": float(np.percentile(f32_lat, 99)),
               "steps_timed": int(f32_lat.size)}
    log(f"[{CARD}] {arch} with the CLI's fp32 {key}: logits within "
        f"{f32_worst:.4f} of the plain run; captured step p50 "
        f"{f32_out['decode_p50_ms']:.2f} ms over {f32_lat.size} steps, "
        f"prefill {f32_out['prefill_ms']:.1f} ms")
    del res

    # ---- the cross path held directly, kernel run against plain run -----
    def ran(mode, fn, *args):
        with torch.no_grad(), dispatch.use_mode(mode):
            return fn(*args)

    def held(what, fn, src):
        return _hold(torch, what, ran(dispatch.CUDA, fn, src),
                     ran(dispatch.REF, fn, src),
                     ran(dispatch.CUDA, fn, src.roll(1, 0)))

    def enc(src):
        return encode(params, cfg, par, src)

    holds, sources = {}, {}
    for dn, src in (("bfloat16", extras[key]), ("float32", f32[key])):
        if cfg.family == "audio":
            holds[f"enc_out {dn}"] = held(
                f"{arch} encoder output ({dn} frames {tuple(src.shape)})",
                enc, src)
            src = ran(dispatch.CUDA, enc, src)
        sources[dn] = src
    layer, n_cross = _cross_layer(cfg, params)
    g = torch.Generator(device=prompt.device).manual_seed(19)
    for sq in (FIXED["prompt_len"], 1):
        x = torch.randn((FIXED["batch"], sq, cfg.d_model), generator=g,
                        device=prompt.device).to(torch_dtype(cfg.dtype))

        def sub(src):
            return attn.apply_cross_attn(
                layer["cross"], cfg, par,
                apply_rmsnorm(layer["cross_norm"], x, cfg.norm_eps), src)
        for dn, src in sources.items():
            holds[f"cross sq{sq} {dn}"] = held(
                f"{arch} first cross sublayer, {sq} query rows over the "
                f"{dn} source {tuple(src.shape)}", sub, src)

    # ---- how far the cross path moves the logits ------------------------
    moved, _ = _forced_logits(torch, model, run, params, prompt,
                              fixed.tokens, cache_len, dispatch.CUDA,
                              {key: extras[key].roll(1, 0)})
    diffs = [(a - b).abs() for a, b in zip(moved, kernel_logits)]
    effect = {"max_abs_diff": max(float(d.max()) for d in diffs),
              "beyond_logit_tol": sum(
                  int((d > atol + LOGIT_RTOL * b.abs()).sum())
                  for d, b in zip(diffs, kernel_logits)),
              "logits": sum(d.numel() for d in diffs)}
    log(f"{arch}: another slot's {key} moves the kernel run's logits by "
        f"at most {effect['max_abs_diff']:.4f}; {effect['beyond_logit_tol']}"
        f" of {effect['logits']} logits move beyond the logit tolerance "
        f"({atol:.4g} + {LOGIT_RTOL}|x|)")
    del moved, diffs

    cross_cost = _cross_cost(torch, cfg, par, layer["cross"], n_cross,
                             sources)
    return {"cli_fp32_extras": f32_out, "holds": holds,
            "other_source_at_logits": effect, "cross_cost": cross_cost}


def _cross_cost(torch, cfg, par, p, n_cross, sources):
    """What a decode step spends recomputing the cross-attention, as the
    reference does at every step: one cross layer's K and V projections of
    its source (the vision embeddings, or the encoder output) and the
    whole cross sublayer at one query row a slot, timed with CUDA events
    (median of 30, L2 flushed) on the cross layer ``p``, times the model's
    ``n_cross`` cross layers; for each source dtype of ``sources``."""
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import mm

    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=p["wk"].device)
    g = torch.Generator(device=l2.device).manual_seed(17)
    x = torch.randn((FIXED["batch"], 1, cfg.d_model), generator=g,
                    device=l2.device).to(p["wq"].dtype)
    out = {"cross_layers": n_cross}
    for name, src in sources.items():
        kv_ms = _time_ms(torch, lambda: (mm(src, p["wk"]), mm(src, p["wv"])),
                         l2.zero_)
        layer_ms = _time_ms(torch, lambda: attn.apply_cross_attn(
            p, cfg, par, x, src), l2.zero_)
        flops = 2 * 2 * src.shape[0] * src.shape[1] * src.shape[2] * \
            p["wk"].shape[1]
        out[name] = {"source": list(src.shape), "kv_ms_per_layer": kv_ms,
                     "cross_ms_per_layer": layer_ms,
                     "kv_ms_per_step": kv_ms * n_cross,
                     "cross_ms_per_step": layer_ms * n_cross,
                     "kv_tflop_per_step": flops * n_cross / 1e12,
                     "kv_tflop_s": flops / (kv_ms * 1e-3) / 1e12}
        log(f"[{CARD}] {cfg.name} cross K/V recomputed every step "
            f"({name} {tuple(src.shape)}): {kv_ms * 1e3:.1f} us a layer "
            f"({out[name]['kv_tflop_s']:.0f} TF/s), x {n_cross} layers = "
            f"{kv_ms * n_cross:.2f} ms a step; the whole cross sublayer "
            f"{layer_ms * n_cross:.2f} ms a step")
    return out


# --------------------------------------------------------------------------
# phase 4i: training every family — the moe, vlm and audio archs trained at
# published widths, the fault-tolerant driver on the card, the train CLI's
# resume from its checkpoints
# --------------------------------------------------------------------------

# arch -> (cuts, batch, seq, the step-vs-plain comparison's further cuts,
# the prefill instances every step launches).  Cut to fit one 80 GB card at
# 18 bytes a parameter (fp32 master, m, v and gradient, bf16 compute copy)
# with the widths, heads, top-k and vocabulary published: whisper at full
# depth (32 + 32); the vision model one super-block (5 of 40 layers, one
# gated cross layer); deepseek 1 of 61 layers and its MTP head, 12 of 256
# routed experts; llama4 one super-block (a dense and a MoE layer), 4 of
# 128 experts.  The comparison runs at 2 + 2 layers for whisper and at the
# training depth for the others (their least: one layer, one super-block).
TRAIN_FAMILIES = {
    "whisper-large-v3": (
        {}, 2, 448, dict(num_layers=2, encoder_layers=2),
        {(64, 64, False, False), (64, 64, False, True)}),
    "llama-3.2-vision-11b": (
        dict(num_layers=5), 2, 1024, {},
        {(128, 128, False, True), (128, 128, False, False)}),
    "deepseek-v3-671b": (
        dict(num_layers=1, moe_num_experts=12), 1, 1024, {},
        {(192, 128, False, True)}),
    "llama4-maverick-400b-a17b": (
        dict(num_layers=2, moe_num_experts=4), 1, 1024, {},
        {(128, 128, False, True)}),
}
TRAIN_FAMILY_STEPS = 3
TRAIN_FAMILY_KERNELS = ("rmsnorm", "flash_attention")
#: the driver on the card: whisper-large-v3 at full width, 4 + 4 layers,
#: 8 steps, a checkpoint every 3, faults injected before steps 5 and 8
DRIVER = dict(arch="whisper-large-v3",
              cuts=dict(num_layers=4, encoder_layers=4), batch=2, seq=448,
              steps=8, checkpoint_every=3, faults=(5, 8))
#: a faulted run's final parameters lie within this multiple of the
#: distance between two unbroken runs, when those differ (a step that is
#: not deterministic on the card)
DRIVER_SPREAD = 2.0
#: the train CLI runs twice on one checkpoint directory (smoke configs;
#: the two archs' processes side by side)
TRAIN_CLI_RESUME = (("deepseek-v3-671b", 6, 8), ("whisper-large-v3", 6, 8))
#: phase 6 profiles a train step of these cells: whisper's fp32 encoder,
#: deepseek's experts, two heads and the largest optimizer state
TRAIN_PROFILED = ("whisper-large-v3", "deepseek-v3-671b")


def phase_train_families(torch, np, dev):
    """Each model of TRAIN_FAMILIES trained on the card in turn (counted),
    then held against the plain step; the driver's restart on the card;
    the train CLI's resume.  Returns the summaries and the launches of the
    counted runs, summed."""
    from repro_torch.kernels import cuda_lib

    out = {}
    launches = {name: 0 for name in cuda_lib.LAUNCHES}
    for arch, (cuts, batch, seq, compare_cuts, instances) in \
            TRAIN_FAMILIES.items():
        out[arch], counted = _train_family(torch, np, dev, arch, cuts, batch,
                                           seq, instances)
        for name, n in counted.items():
            launches[name] += n
        cfg = out[arch]["cfg"].replace(**compare_cuts)
        del out[arch]["cfg"]
        out[arch]["vs_plain"] = _step_vs_plain(
            torch, np, dev, cfg, seq, batch, arch,
            prepare=(lambda p, c=cfg: _open_cross_gates(torch, dev, c, p))
            if cfg.family == "vlm" else None, routes=cfg.is_moe)
    out["driver"] = _driver_on_card(torch, np, dev)
    out["cli"] = _train_cli_resume(TRAIN_CLI_RESUME)
    return out, launches


def _opened_init(torch, dev, cfg):
    """The vision model's parameters from seed 0 with the cross gates
    opened (``_open_cross_gates``); None for the other families, which
    ``train`` draws from seed 0 itself."""
    from repro_torch.models.model import build_model

    if cfg.family != "vlm":
        return None
    params = build_model(cfg, device=dev).init(0)
    _open_cross_gates(torch, dev, cfg, params)
    return params


def _train_family(torch, np, dev, arch, cuts, batch, seq, instances):
    """``train`` on one model, counted step by step: every resolution
    ``cuda``, RMSNorm and prefill launched each step with exactly the
    expected prefill instances, their recompute backwards run, the loss
    and the family's aux terms finite."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.kernels import cuda_lib, dispatch, ops
    from repro_torch.launch.train import train

    cfg = get_model_config(arch).replace(**cuts)
    extra = (("moe_aux",) if cfg.is_moe else ()) + \
        (("mtp_loss",) if cfg.mtp_depth > 0 else ())
    per_step = []

    def log_step(i, metrics, step_s):
        per_step.append({
            "launches": dict(cuda_lib.LAUNCHES),
            "instances": dict(cuda_lib.PREFILL_INSTANCES),
            "recomputes": dict(ops.RECOMPUTES),
            "metrics": {k: float(metrics[k])
                        for k in ("loss", "grad_norm") + extra}})
        cuda_lib.reset_launches()
        ops.reset_recomputes()
        log(f"{arch} step {i}: {per_step[-1]['metrics']}, "
            f"{step_s * 1000:.1f} ms")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the earlier phases
    # ---- the main path, counted per step -------------------------------
    cuda_lib.reset_launches()
    ops.reset_recomputes()
    with dispatch.profile_dispatches() as prof, \
            dispatch.record_resolutions() as resolved:
        res = train(cfg, steps=TRAIN_FAMILY_STEPS, seq=seq, batch=batch,
                    device=dev, seed=0, log=log_step,
                    params=_opened_init(torch, dev, cfg))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    _check_resolved(resolved, f"{arch} training")
    plain = [k for k in prof.summary() if k.endswith(f"[{dispatch.REF}]")]
    check(not plain, f"{arch}: CUDA tensors resolved to plain versions in "
          f"the forward: {plain}")
    for i, counts in enumerate(per_step):
        for name in TRAIN_FAMILY_KERNELS:
            check(counts["launches"][name] > 0 and
                  counts["recomputes"][name] > 0,
                  f"{arch} step {i}: {name} launched "
                  f"{counts['launches'][name]} times, its recompute "
                  f"backward run {counts['recomputes'][name]} times")
        check(set(counts["instances"]) == instances,
              f"{arch} step {i}: prefill instances "
              f"{sorted(counts['instances'])}, want {sorted(instances)}")
        bad = {k: v for k, v in counts["metrics"].items()
               if not math.isfinite(v)}
        check(not bad, f"{arch} step {i}: non-finite {bad}")
    steady = res.step_s[1:]
    p50 = float(np.percentile(steady, 50))
    tokens = batch * seq
    summary = {
        "cfg": cfg, "cuts": cuts, "params": cfg.param_count(),
        "batch": batch, "seq": seq, "steps": TRAIN_FAMILY_STEPS,
        "metrics": [c["metrics"] for c in per_step],
        "step_ms": [t * 1000 for t in res.step_s],
        "step_p50_ms": p50 * 1000, "tokens_per_s": tokens / p50,
        "peak_mem_gb": peak / 1e9, "held_before_gb": held / 1e9,
        "launches_per_step": per_step[-1]["launches"],
        "prefill_instances_per_step": {
            str(k): n for k, n in per_step[-1]["instances"].items()},
        "recomputes_per_step": per_step[-1]["recomputes"]}
    log(f"[{CARD}] {arch} ({cfg.num_layers} layers, "
        f"{summary['params'] / 1e9:.3f} B params, batch {batch} x {seq}): "
        f"step p50 {p50 * 1000:.1f} ms (steps 2-{TRAIN_FAMILY_STEPS}), "
        f"{tokens / p50:.0f} tok/s, peak {peak / 1e9:.1f} GB ({held / 1e9:.1f}"
        f" of it held by earlier phases); launches per "
        f"step {per_step[-1]['launches']}, prefill instances "
        f"{summary['prefill_instances_per_step']}, recomputes per step "
        f"{per_step[-1]['recomputes']}")
    counted = {k: sum(c["launches"][k] for c in per_step)
               for k in cuda_lib.LAUNCHES}
    del res
    torch.cuda.empty_cache()
    return summary, counted


def _driver_run(torch, dev, cfg, root, name, faults):
    """``TrainDriver`` over DRIVER's run in ``root/name`` with ``faults``
    injected: (final state, driver, logged records, peak bytes beyond what
    the earlier phases hold, wall s)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.runtime.driver import FaultInjector, TrainDriver
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              train_state_template)
    from repro_torch.utils.logging import MetricsLogger

    run = make_run(cfg, seq=DRIVER["seq"], batch=DRIVER["batch"],
                   steps=DRIVER["steps"],
                   checkpoint_dir=os.path.join(root, name)).replace(
        checkpoint_every=DRIVER["checkpoint_every"], log_every=1)
    model = build_model(cfg, run.parallel, device=dev)
    opt = make_optimizer(run.train)
    path = os.path.join(root, f"{name}.jsonl")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # by the earlier phases
    t0 = time.perf_counter()
    with MetricsLogger(path=path, name=f"driver-{name}") as logger:
        driver = TrainDriver(
            run, make_train_step(model, run, opt),
            lambda: init_train_state(model, run, opt, seed=0),
            make_data(cfg, run.shape, seed=0),
            CheckpointManager(run.checkpoint_dir, keep=2), logger=logger,
            fault_injector=FaultInjector(list(faults)), device=dev,
            state_template=lambda: train_state_template(model, run, opt))
        state = driver.run_steps(DRIVER["steps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return (state, driver, records, torch.cuda.max_memory_allocated() - held,
            wall)


def _tree_bytes(tree):
    from repro_torch.utils.trees import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "element_size"))


def _driver_on_card(torch, np, dev):
    """DRIVER's run three times (unbroken, faulted, unbroken again), each
    into its own checkpoint directory under a temporary directory that is
    removed: the restored last checkpoint bit for bit equal to the state
    that was saved, the faulted run's peak memory no more than the
    unbroken run's plus the restore's staging (its largest leaf), the
    faulted run's final parameters equal to the unbroken run's bit for bit
    if the two unbroken runs agree bit for bit, else within DRIVER_SPREAD
    of their distance (and the leaves whose first update differs between
    two identical steps named); a save and a restore timed."""
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_model_config
    from repro_torch.utils.trees import flatten_with_paths

    cfg = get_model_config(DRIVER["arch"]).replace(**DRIVER["cuts"])
    out = {"arch": DRIVER["arch"], **{k: v for k, v in DRIVER.items()
                                      if k != "arch"}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        finals, peaks = {}, {}
        for name, faults in (("unbroken", ()), ("faulted", DRIVER["faults"]),
                             ("unbroken_again", ())):
            state, driver, records, peak, wall = _driver_run(
                torch, dev, cfg, root, name, faults)
            events = [(r["step"], r["event"]) for r in records
                      if "event" in r]
            out[name] = {"restarts": driver.restarts, "events": events,
                         "losses": {r["step"]: r["loss"] for r in records
                                    if "loss" in r},
                         "peak_mem_gb": peak / 1e9, "wall_s": wall}
            peaks[name] = peak
            check(state.step == DRIVER["steps"] and
                  driver.restarts == len(faults),
                  f"driver {name}: step {state.step}, {driver.restarts} "
                  f"restarts")
            if faults:
                check(events == [(0, "init_fresh"), (-1, "fault"),
                                 (3, "restored"), (-1, "fault"),
                                 (6, "restored")],
                      f"driver {name}: events {events}")
            if name == "unbroken":
                state_bytes = _tree_bytes(state)
                staging = max(t.numel() * t.element_size() for t in
                              flatten_with_paths(state).values()
                              if hasattr(t, "element_size"))
                out["state_gb"] = state_bytes / 1e9
                free = shutil.disk_usage(root).free
                out["disk_free_gb"] = free / 1e9
                check(free > 4 * state_bytes,
                      f"{free / 1e9:.1f} GB free under {root}: too little "
                      f"for the timed checkpoints of {state_bytes / 1e9:.2f}"
                      f" GB")
                out.update(_timed_checkpoint(torch, dev, cfg, root, state,
                                             state_bytes))
            finals[name] = {k: v.detach().to("cpu", copy=True)
                            for k, v in flatten_with_paths(state).items()
                            if hasattr(v, "detach")}
            del state, driver
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
            torch.cuda.empty_cache()
    a, f, b = finals["unbroken"], finals["faulted"], finals["unbroken_again"]

    def dist(x, y):
        return (max(float((x[k].float() - y[k].float()).abs().max())
                    for k in x),
                math.sqrt(sum(float(((x[k].float() - y[k].float()) ** 2)
                                    .sum()) for k in x)))
    deterministic = all(torch.equal(a[k], b[k]) for k in a)
    out["unbroken_runs_bit_equal"] = deterministic
    out["faulted_bit_equal"] = all(torch.equal(a[k], f[k]) for k in a)
    out["faulted_vs_unbroken"] = dist(f, a)
    out["unbroken_vs_unbroken"] = dist(b, a)
    out["staging_gb"] = staging / 1e9
    check(peaks["faulted"] <= peaks["unbroken"] + staging,
          f"driver: peak {peaks['faulted'] / 1e9:.3f} GB across the restarts"
          f" against {peaks['unbroken'] / 1e9:.3f} GB unbroken (staging "
          f"{staging / 1e9:.3f} GB)")
    if deterministic:
        check(out["faulted_bit_equal"],
              f"driver: the faulted run's final state differs from the "
              f"unbroken run's (max |diff|, L2 {out['faulted_vs_unbroken']})"
              f" though two unbroken runs agree bit for bit")
    else:
        out["nondeterministic_leaves"] = _first_step_spread(torch, dev, cfg)
        check(all(x <= DRIVER_SPREAD * y for x, y in
                  zip(out["faulted_vs_unbroken"],
                      out["unbroken_vs_unbroken"])),
              f"driver: faulted vs unbroken {out['faulted_vs_unbroken']} "
              f"beyond {DRIVER_SPREAD} x unbroken vs unbroken "
              f"{out['unbroken_vs_unbroken']}")
    log(f"[{CARD}] driver on the card ({DRIVER['arch']}, "
        f"{cfg.num_layers} + {cfg.encoder_layers} layers, state "
        f"{out['state_gb']:.2f} GB): peaks unbroken / faulted / again "
        f"{[round(peaks[k] / 1e9, 3) for k in peaks]} GB (staging "
        f"{staging / 1e9:.3f}); unbroken runs bit equal: {deterministic}; "
        f"faulted equal: {out['faulted_bit_equal']} (max |diff|, L2 "
        f"{out['faulted_vs_unbroken']}; unbroken vs unbroken "
        f"{out['unbroken_vs_unbroken']}); save: snapshot "
        f"{out['save_snapshot_gb_per_s']:.2f} GB/s, write "
        f"{out['save_write_gb_per_s']:.2f} GB/s, restore "
        f"{out['restore_gb_per_s']:.2f} GB/s")
    return out


def _timed_checkpoint(torch, dev, cfg, root, state, state_bytes):
    """One async save of ``state`` (the host snapshot until ``save``
    returns, then the write until ``wait`` returns) and its restore into
    a ``meta`` template, timed; the restored state equal to ``state`` bit
    for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import train_state_template
    from repro_torch.utils.trees import flatten_with_paths

    mgr = CheckpointManager(os.path.join(root, "timed"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state.step, state)
    t1 = time.perf_counter()
    mgr.wait()
    t2 = time.perf_counter()
    run = make_run(cfg, seq=DRIVER["seq"], batch=DRIVER["batch"],
                   steps=DRIVER["steps"])
    template = train_state_template(build_model(cfg, device="meta"), run,
                                    make_optimizer(run.train))
    t3 = time.perf_counter()
    restored = mgr.restore(state.step, template, device=dev)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    want, got = flatten_with_paths(state), flatten_with_paths(restored)
    same = sorted(want) == sorted(got) and all(
        (want[k] == got[k]) if isinstance(want[k], int) else
        (want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]))
        for k in want)
    check(same, "driver: the restored checkpoint differs from the state "
          "that was saved")
    del restored, got
    return {"restored_bit_equal": same,
            "save_snapshot_s": t1 - t0, "save_write_s": t2 - t1,
            "restore_s": t4 - t3,
            "save_snapshot_gb_per_s": state_bytes / 1e9 / (t1 - t0),
            "save_write_gb_per_s": state_bytes / 1e9 / (t2 - t1),
            "restore_gb_per_s": state_bytes / 1e9 / (t4 - t3)}


def _first_step_spread(torch, dev, cfg):
    """The leaves whose parameters differ after one step taken twice from
    the same state on the same batch: where the step is not deterministic
    on the card."""
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    run = make_run(cfg, seq=DRIVER["seq"], batch=DRIVER["batch"],
                   steps=DRIVER["steps"])
    model = build_model(cfg, run.parallel, device=dev)
    opt = make_optimizer(run.train)
    step = make_train_step(model, run, opt)
    batch = make_data(cfg, run.shape, seed=0).batch_at(0)
    after = []
    for _ in range(2):
        state, _ = step(init_train_state(model, run, opt, seed=0), batch)
        after.append({k: v.to("cpu", copy=True)
                      for k, v in _flat(state.params)})
        del state
    torch.cuda.empty_cache()
    return sorted(k for k in after[0]
                  if not torch.equal(after[0][k], after[1][k]))


def _train_cli_resume(specs):
    """The train launcher as a user runs it, twice on one checkpoint
    directory (a temporary one, removed) for each ``(arch, first,
    second)`` of ``specs``, the archs' processes side by side: ``--steps
    first`` from a fresh state, then ``--steps second``, which must log
    ``restored`` at step ``first`` and finish at step ``second``."""
    import tempfile

    out = {arch: [] for arch, _, _ in specs}
    with contextlib.ExitStack() as stack:
        dirs = {arch: stack.enter_context(tempfile.TemporaryDirectory(
            prefix="chip_smoke_cli_")) for arch, _, _ in specs}
        for run in (0, 1):
            procs = {}
            t0 = time.perf_counter()
            for arch, first, second in specs:
                steps = (first, second)[run]
                cmd = [sys.executable, "-m", "repro_torch.launch.train",
                       "--arch", arch, "--steps", str(steps),
                       "--ckpt-dir", dirs[arch]]
                procs[arch] = (cmd, steps, first, subprocess.Popen(
                    cmd, cwd=str(ROOT), stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True,
                    env={**os.environ, "PYTHONPATH": str(SRC)}))
            for arch, (cmd, steps, first, proc) in procs.items():
                try:
                    stdout, stderr = proc.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.communicate()
                    raise
                wall = time.perf_counter() - t0
                what = "train CLI " + " ".join(cmd[3:])
                check(proc.returncode == 0, f"{what} exited "
                      f"{proc.returncode}: {stderr[-2000:]}")
                tag = f"[train-{arch}] "
                lines = [ln for ln in stderr.splitlines()
                         if ln.startswith(tag)]
                events = [(int(ln.split("step=")[1].split()[0]),
                           ln.split("event=")[1].split()[0])
                          for ln in lines if "event=" in ln]
                want = [(0, "init_fresh")] if run == 0 else \
                    [(first, "restored")]
                check(events == want, f"{what}: events {events}, want "
                      f"{want}")
                check(f"[train] finished at step {steps}" in stdout,
                      f"{what}: no 'finished at step {steps}' in its output")
                for line in lines:
                    log(f"train CLI | {line}")
                log(f"{what}: rc 0 in {wall:.1f} s, events {events}")
                out[arch].append({"cmd": " ".join(cmd[1:]), "wall_s": wall,
                                  "events": events})
    return out


# --------------------------------------------------------------------------
# phase 4j: fleet replay over llama3.2-1b, and the data-parallel train CLI
# --------------------------------------------------------------------------

#: (name, overrides of the default fleet config: 2 replicas, round robin)
FLEET_CONFIGS = (
    ("2 round_robin", {}),
    ("2 join_shortest_queue", {"fleet.routing": "join_shortest_queue"}),
    ("2 power_of_two", {"fleet.routing": "power_of_two"}),
    ("4 dense", {"fleet.num_replicas": 4}),
    ("4 paged", {"fleet.num_replicas": 4, "pages.paging": "on"}),
)
FLEET_DEVICES = 8
FLEET_KERNELS = ("rmsnorm", "flash_attention", "decode_attention",
                 "paged_decode_attention")
#: replay report fields that follow from the schedule alone
FLEET_SCHEDULE = ("completed", "rejected", "ticks", "tokens",
                  "mean_occupancy", "queue_depth_mean", "queue_depth_max",
                  "page_pool_occupancy", "page_faults",
                  "prefill_chunks_inflight", "rejected_too_long")
#: pooled counters that read the clock
FLEET_WALL = ("latency", "throughput", "prefill_decode_ratio",
              "straggler_flagged")
#: pooled counters computed from the replay's wall-clock latencies: held
#: against the same computation on the measured replay's own latencies,
#: not against another replay's
FLEET_LATENCY_SHARES = ("slo_violation_rate",)
DP = dict(steps=3, seq=512, batch=2)


def _completed_tokens(batcher, start, n):
    return [(rs.request.uid, list(rs.generated))
            for rs in batcher.completed[start:start + n]]


def phase_fleet(torch, np, dev):
    """Fleet replay of phase 4c's trace over llama3.2-1b at full width:
    per config the router's plan, each replica's replay on the shared
    deployment against a plain replay of its sub-trace on a fresh batcher
    (schedule and tokens bit for bit), the plan against ``FleetSimulator``
    built apart, the pooled counters recomputed from the replicas'
    reports; then CAMEO over the fleet knobs.  Returns (summary, the fleet
    replays' own launches, the CAMEO run's launches): the counts are set
    to 0 just before each ``fleet_replay`` and read just after it, before
    the check's own replays; CAMEO's run is counted apart."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.envs.replay_env import make_sim2real_pair
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.serving.replay import replay_trace
    from repro_torch.tuner.runner import transfer_tune
    from repro_torch.workloads import FleetPlan, ServingPlan
    from repro_torch.workloads.sim import FleetSimulator, FleetSpec

    cfg = get_model_config(ARCH)

    def pair():
        return make_sim2real_pair(SIM2REAL_SPEC, model_cfg=cfg, seed=0,
                                  trace_seed=0, repeats=1, device="cuda",
                                  fleet=True, num_devices=FLEET_DEVICES)

    src, env = pair()
    launches = {k: 0 for k in cuda_lib.LAUNCHES}
    configs = {}
    with dispatch.record_resolutions() as resolved:
        for name, over in FLEET_CONFIGS:
            cfg_ = dict(env.space.default_config(), **over)
            check(env.infeasible_reason(cfg_) == "",
                  f"fleet {name}: infeasible ({env.infeasible_reason(cfg_)})")
            plan, fplan = ServingPlan.from_config(cfg_), \
                FleetPlan.from_config(cfg_)
            key = env._deploy_key(plan, cfg_)
            shared = env._fresh_batcher(*key)
            env._warm_deployment(shared, key[3])
            shared.interleave = plan.interleave
            cuda_lib.reset_launches()
            route, reports = env.fleet_replay(shared, cfg_, plan)
            torch.cuda.synchronize()
            own = {k: n for k, n in cuda_lib.LAUNCHES.items() if n}
            for k, n in own.items():
                launches[k] += n
            check(reports is not None, f"fleet {name}: plan infeasible")
            apart = FleetSimulator(
                env.cell, env.families, hardware=env.hardware,
                max_ticks=env.max_ticks,
                fleet=FleetSpec(num_devices=FLEET_DEVICES)).run(
                    env.trace, plan, fplan, cfg_)
            check(route.assignments == apart.assignments
                  and route.routing_imbalance == apart.routing_imbalance,
                  f"fleet {name}: the replay's routing differs from "
                  f"FleetSimulator's")
            subs = [st for st in env._subtraces(route.assignments)
                    if st is not None]
            check(len(subs) == len(reports),
                  f"fleet {name}: {len(reports)} reports for {len(subs)} "
                  f"sub-traces")
            start = 0
            for r, (st, rep) in enumerate(zip(subs, reports)):
                fresh = env._fresh_batcher(*key)
                env._warm_deployment(fresh, key[3])
                fresh.interleave = plan.interleave
                alone = replay_trace(fresh, st, admit_chunk=plan.admit_chunk,
                                     ticks_per_s=env.ticks_per_s, seed=0,
                                     max_ticks=env.max_ticks)
                for f in FLEET_SCHEDULE:
                    check(getattr(rep, f) == getattr(alone, f),
                          f"fleet {name} replica {r}: {f} "
                          f"{getattr(rep, f)} in the fleet, "
                          f"{getattr(alone, f)} alone")
                check(_completed_tokens(shared, start, rep.completed) ==
                      _completed_tokens(fresh, 0, alone.completed),
                      f"fleet {name} replica {r}: tokens differ from the "
                      f"replay alone")
                start += rep.completed
            pooled, y = env._pool_fleet(reports, route)
            lat = np.asarray([l for r in reports for l in r.latencies_ms])
            check(pooled["latency"] == float(np.percentile(lat, 99)) == y
                  and pooled["throughput"] == sum(r.completed
                                                  for r in reports)
                  / max(r.wall_s for r in reports)
                  and pooled["queue_depth_max"] == max(r.queue_depth_max
                                                       for r in reports),
                  f"fleet {name}: pooled counters differ from the "
                  f"replicas' reports")
            measured = []  # the reports the measurement pools
            env._pool_fleet = lambda reps, plan_report: (
                measured.append(reps) or type(env)._pool_fleet(
                    env, reps, plan_report))
            try:
                counters, y2 = env.intervene(cfg_)
            finally:
                del env._pool_fleet
            torch.cuda.synchronize()
            check(len(measured) == 1, f"fleet {name}: the measurement "
                  f"pooled {len(measured)} replays")
            own = np.asarray([l for r in measured[0] for l in r.latencies_ms],
                             np.float64)
            share = float((own > env.slo_ms).mean()) if own.size else 0.0
            check(counters["slo_violation_rate"] == share,
                  f"fleet {name}: slo_violation_rate "
                  f"{counters['slo_violation_rate']} measured, {share} from "
                  f"the measured replay's own {own.size} latencies")
            for k, v in counters.items():
                if k not in FLEET_WALL + FLEET_LATENCY_SHARES:
                    check(v == pooled[k], f"fleet {name}: {k} {v} measured, "
                          f"{pooled[k]} from the broken-out replay")
            check(all(math.isfinite(counters[k]) for k in FLEET_WALL) and
                  math.isfinite(y2) and y2 > 0,
                  f"fleet {name}: measured {counters}, {y2}")
            s_tick = [r.decode_s / r.ticks for r in reports]
            configs[name] = {
                "config": over, "assignments": [len(a) for a in
                                                route.assignments],
                "routing_imbalance": route.routing_imbalance,
                "p99_ms": y2, "broken_out_p99_ms": y,
                "decode_s_per_tick": s_tick,
                "straggler_flagged": counters["straggler_flagged"],
                "counters": counters, "launches": own}
            log(f"[{CARD}] fleet {name}: requests per replica "
                f"{configs[name]['assignments']}, imbalance "
                f"{route.routing_imbalance:.3f}, p99 {y2:.1f} ms "
                f"(broken out {y:.1f}), decode s/tick per replica "
                f"{[round(t * 1e3, 3) for t in s_tick]} ms, straggler_flagged "
                f"{counters['straggler_flagged']:.0f}; each replica equal "
                f"to its sub-trace alone; the fleet replay's launches {own}")
        check(env.measured_captures == 0, f"fleet: {env.measured_captures} "
              f"decode graphs captured inside measured replays")
        t0 = time.perf_counter()
        src, tgt = pair()
        cuda_lib.reset_launches()
        res = transfer_tune("cameo", src, tgt, query_text=tgt.query_text,
                            **SIM2REAL_TUNE)
        torch.cuda.synchronize()
        cameo_launches = dict(cuda_lib.LAUNCHES)
        tune_s = time.perf_counter() - t0
    _check_resolved(resolved, "fleet")
    for k in FLEET_KERNELS:
        check(launches[k] > 0, f"fleet: the fleet replays launched no {k}")
    check(math.isfinite(res.best_y) and res.best_y > 0,
          f"fleet: CAMEO's best_y {res.best_y}")
    check(tgt.measured_captures == 0, f"fleet: {tgt.measured_captures} "
          f"decode graphs captured inside the tuning run's measurements")
    best = {k: v for k, v in res.best_config.items()
            if k.startswith(("fleet.", "serving."))}
    log(f"[{CARD}] fleet CAMEO (budget {SIM2REAL_TUNE['budget']}): best "
        f"{best} -> p99 {res.best_y:.1f} ms in {tune_s:.1f} s; the fleet "
        f"replays' launches {launches}, CAMEO's {cameo_launches}")
    return {"spec": env.trace.spec, "requests": len(env.trace.requests),
            "num_devices": FLEET_DEVICES, "configs": configs,
            "cameo": {"best_config": res.best_config, "best_y_ms": res.best_y,
                      "trace_best_y": res.trace_best_y, "tune_s": tune_s,
                      "launches": cameo_launches},
            "card": CARD}, launches, cameo_launches


def _cli_logged(stderr, arch):
    """The train CLI's ``[train-<arch>]`` lines: {step: {key: value}}."""
    out = {}
    for line in stderr.splitlines():
        if line.startswith(f"[train-{arch}] ") and "loss=" in line:
            kv = dict(f.split("=", 1) for f in line.split()[1:])
            out[int(kv["step"])] = kv
    return out


def phase_distributed(torch, np, dev):
    """The data-parallel train path on one card: the train loop under an
    NCCL process group of one rank against the plain loop (counted); the
    train CLI under ``torch.distributed.run``, its logged step against the
    plain loop's; its checkpoint restored through ``remesh_state`` on the
    one-device mesh, held bit for bit against the NCCL loop's state, and
    its next step against the unbroken run's.  (The CLI is run once: the
    plain CLI would write and compare a second 14.8 GB checkpoint for
    what the in-process loops already hold.)  Returns (summary,
    launches)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_model_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.train import make_run, train
    from repro_torch.models.model import build_model
    from repro_torch.runtime.elastic import remesh_state
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (make_train_step,
                                              train_state_template)
    from repro_torch.utils.trees import flatten_with_paths

    cfg = get_model_config(ARCH)
    steps = DP["steps"]
    unbroken = train(cfg, steps=steps + 1, seq=DP["seq"], batch=DP["batch"],
                     device="cuda")
    unbroken.state = None  # its losses are held; the state is not
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        cuda_lib.reset_launches()
        with dispatch.record_resolutions() as resolved:
            dp = train(cfg, steps=steps, seq=DP["seq"], batch=DP["batch"],
                       device="cuda")
            torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
    finally:
        dist.destroy_process_group()
    _check_resolved(resolved, "distributed")
    for k in TRAIN_FAMILY_KERNELS:
        check(launches[k] > 0, f"distributed: the NCCL step launched no {k}")
    check(dp.losses == unbroken.losses[:steps] and
          dp.grad_norms == unbroken.grad_norms[:steps],
          f"distributed: NCCL world-1 losses {dp.losses} / grad norms "
          f"{dp.grad_norms}, plain {unbroken.losses[:steps]} / "
          f"{unbroken.grad_norms[:steps]}")
    dp_step_s = dp.step_s
    log(f"[{CARD}] distributed: the NCCL world-1 train loop equals the "
        f"plain one bit for bit over {steps} steps (losses "
        f"{unbroken.losses[:steps]}); launches {launches}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as root:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
               "--arch", ARCH, "--full-config", "--steps", str(steps),
               "--seq", str(DP["seq"]), "--batch", str(DP["batch"]),
               "--ckpt-dir", root]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=str(ROOT), capture_output=True,
                              text=True, timeout=600,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"distributed: the torchrun CLI exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        check("on 1 device(s)" in proc.stdout and
              f"[train] finished at step {steps}" in proc.stdout,
              f"distributed: the torchrun CLI printed {proc.stdout[-2000:]}")
        logged = _cli_logged(proc.stderr, ARCH)
        check(steps in logged, f"distributed: the torchrun CLI logged no "
              f"step {steps}: {proc.stderr[-2000:]}")
        got = logged[steps]
        # the logger writes 6 significant digits
        want = {"loss": f"{unbroken.losses[steps - 1]:.6g}",
                "grad_norm": f"{unbroken.grad_norms[steps - 1]:.6g}"}
        check({k: got[k] for k in want} == want,
              f"distributed: the torchrun CLI logged {got} at step {steps}, "
              f"the plain loop {want}")
        log(f"[{CARD}] distributed: torchrun CLI rc 0 in {wall:.1f} s: "
            f"step {steps} loss {got['loss']} grad_norm {got['grad_norm']} "
            f"(the plain loop's) step_time_s {got['step_time_s']}")
        run = make_run(cfg, seq=DP["seq"], batch=DP["batch"],
                       steps=steps + 1)
        model = build_model(cfg, run.parallel, device="cuda")
        opt = make_optimizer(run.train)
        template = train_state_template(model, run, opt)
        t0 = time.perf_counter()
        one = MeshSpec.of((1,), ("data",))
        state = remesh_state(CheckpointManager(root), steps, template, run,
                             one, device="cuda")
        restore_s = time.perf_counter() - t0
        a, b = (flatten_with_paths(s_) for s_ in (state, dp.state))
        def same(x, y):
            if torch.is_tensor(x) and torch.is_tensor(y):
                return x.dtype == y.dtype and torch.equal(x, y)
            return int(x) == int(y)
        differ = sorted(k for k in a if not (k in b and same(a[k], b[k])))
        check(a.keys() == b.keys() and not differ,
              f"distributed: the torchrun CLI's checkpoint differs from the "
              f"NCCL loop's state in {differ[:5]} "
              f"(keys {sorted(a.keys() ^ b.keys())[:5]})")
        n_leaves = len(a)
        del a, b, dp
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        data = make_data(cfg, run.shape, seed=0)
        step_fn = make_train_step(model, run, opt)
        state, metrics = step_fn(state, data.batch_at(steps))
        resumed = float(metrics["loss"])
        resume_s = time.perf_counter() - t0
        check(resumed == unbroken.losses[steps],
              f"distributed: resumed through remesh_state, step "
              f"{steps + 1} loss {resumed}; unbroken {unbroken.losses[steps]}")
        del state
    step_ms = {"nccl_world1": [t * 1e3 for t in dp_step_s],
               "plain": [t * 1e3 for t in unbroken.step_s]}
    log(f"[{CARD}] distributed: remesh_state onto the one-device mesh "
        f"gives the NCCL loop's state bit for bit ({n_leaves} leaves, "
        f"restored in {restore_s:.1f} s) and resumes to step {steps + 1}'s "
        f"loss {resumed} (the unbroken run's; step {resume_s:.1f} s); the "
        f"torchrun CLI's step {steps} time {got['step_time_s']} s; "
        f"in-process step ms {step_ms}")
    return {"arch": ARCH, "shape": DP, "losses": unbroken.losses,
            "grad_norms": unbroken.grad_norms, "step_ms": step_ms,
            "restore_s": restore_s, "resume_s": resume_s,
            "resumed_loss": resumed, "checkpoint_leaves": n_leaves,
            "cli": {"cmd": " ".join(cmd[1:]), "wall_s": wall,
                    "logged": got},
            "card": CARD}, launches


# --------------------------------------------------------------------------
# phase 4m: the sharded train step — tensor parallelism, sequence
# parallelism, FSDP and expert placements on a (2, 2) ("data", "model")
# mesh (whisper's tp=4: (1, 4)) of four thread-ranks on the one card,
# against the one-process loop
# --------------------------------------------------------------------------

SHARDED_WORLD = 4
#: llama3.2-1b at full width and depth, fp32 model and compute, under each
#: plan of ``plans`` (the second sequence-parallel) against one process
SHARDED_DENSE = dict(arch="llama3.2-1b",
                     plans=(dict(tp=2, fsdp=2), dict(tp=2, fsdp=2, sp=True)),
                     steps=3, batch=4, seq=512)
#: (arch, cuts, placements, batch, seq, optimizer) in the model dtype:
#: PR 22's cuts (the train slice's 8 and 12 layers; deepseek's 1 layer +
#: MTP with 12 experts), two rows so that each data coordinate steps on
#: one.  The four ranks hold one model's state on the one card beside
#: four ranks' activations and gathered blocks, so deepseek (its vocab
#: 1.85 B of its 3.5 B parameters) trains under Adafactor: factored second
#: moments, 4 bytes of state a parameter beside the masters instead of 8
#: (under AdamW its ranks peaked at 76.8 GB and then ran out of memory,
#: with an earlier run's graph still held: a leak since fixed)
SHARDED_FAMILIES = (
    ("falcon-mamba-7b", dict(num_layers=8), dict(tp=2), 2, 1024, "adamw"),
    ("zamba2-2.7b", dict(num_layers=12), dict(tp=2), 2, 1024, "adamw"),
    ("deepseek-v3-671b", dict(num_layers=1, moe_num_experts=12),
     dict(tp=2, fsdp=2), 2, 512, "adafactor"),
    ("deepseek-v3-671b", dict(num_layers=1, moe_num_experts=12),
     dict(tp=2, fsdp=2, moe_expert_axis="data"), 2, 512, "adafactor"),
    ("deepseek-v3-671b", dict(num_layers=1, moe_num_experts=12),
     dict(tp=2, fsdp=2, sp=True), 2, 512, "adafactor"),
    # the vlm and audio families on a model axis, at published widths,
    # on the train CLI's fp32 stub inputs (whisper's encoder runs in fp32;
    # the vision gate's gradient is held by ``gate_hold``):
    # llama-3.2-vision-11b one super-block (5 of 40 layers: 4 self, 1
    # gated cross over 1600 patch rows), Adafactor as deepseek (its vocab
    # and head are 1.05 B of its 2.2 B parameters; two data copies of the
    # state beside the one-process run's); whisper-large-v3 4 + 4 layers
    # at its default tp=4 (5 of 20 heads a rank, a (1, 4) mesh), where
    # ``sp`` cuts nothing (the reference constrains no audio activation)
    ("llama-3.2-vision-11b", dict(num_layers=5), dict(tp=2), 2, 1024,
     "adafactor"),
    ("llama-3.2-vision-11b", dict(num_layers=5), dict(tp=2, sp=True), 2,
     1024, "adafactor"),
    ("whisper-large-v3", dict(num_layers=4, encoder_layers=4), dict(tp=4),
     2, 448, "adamw"),
    ("whisper-large-v3", dict(num_layers=4, encoder_layers=4),
     dict(tp=4, sp=True), 2, 448, "adamw"),
)
SHARDED_FAMILY_STEPS = 2
#: the leaves whose gradient is one reduction over many products (the vlm
#: gate: ``sech^2(gate) sum(dL/d(gated) * cross(x))`` over 8.4 M products
#: at the vision model's widths, which nearly cancel): in bf16 their hold
#: bounds ``||g_rank - g_one||`` by ``SHARDED_REDUCTION_RTOL`` times the
#: root of the sum of the products' squares (``_gate_magnitudes``, in fp32
#: on the one-process run), not by the sum itself (with the train CLI's
#: fp32 embeddings the relative hold read 0.103 / 0.105 on an H100: the
#: ranks' bf16 rounding against a sum near 0).  Not by the sum of the
#: products' magnitudes either: an error made of N such products of
#: either sign is about sqrt(N) of them, so against their sum a fault
#: shrinks with N (on the CPU at 8192 products, ranks that drop the input
#: gradient's all-reduce read 0.014 and 0.022 of it; against the root of
#: the squares 0.83 and 1.32, the sound ranks 2.9e-3;
#: ``tests/test_torch_gate_hold.py``)
SHARDED_REDUCTION_LEAVES = ("cross_gate",)
SHARDED_REDUCTION_RTOL = 5e-2
#: the kernels each model's sharded train step (``"train"``) and serve
#: steps (``"serve"``) must launch, and the local shapes they must see:
#: (kernel, query heads, KV heads) for prefill and decode, prefill also
#: with (..., KV rows, causal), (kernel, channels) for the scan, (kernel,
#: heads) for the SSD
SHARDED_KERNELS = {
    ("train", "llama3.2-1b"): {("flash_attention", 16, 4)},
    ("train", "falcon-mamba-7b"): {("selective_scan", 4096)},
    ("train", "zamba2-2.7b"): {("ssd", 40), ("flash_attention", 16, 16)},
    ("train", "deepseek-v3-671b"): {("flash_attention", 64, 64)},
    ("train", "llama-3.2-vision-11b"): {
        ("flash_attention", 16, 4, 1024, True),
        ("flash_attention", 16, 4, 1600, False)},
    ("train", "whisper-large-v3"): {("flash_attention", 5, 5, 1500, False),
                                    ("flash_attention", 5, 5, 448, True)},
    ("serve", "llama3.2-1b"): {("flash_attention", 16, 4),
                               ("decode_attention", 16, 4)},
    ("serve", "zamba2-2.7b"): {("ssd", 40), ("flash_attention", 16, 16),
                               ("decode_attention", 16, 16)},
    ("serve", "deepseek-v3-671b"): {("flash_attention", 64, 64)},
}
#: phase 4m's sharded serve runs: (arch, cuts, dtype, placements (one
#: ParallelConfig's kwargs each), batch, prompt, decode steps), each on
#: the four thread-ranks against one process.  llama3.2-1b at full width
#: and depth; zamba2-2.7b one super-block (6 of 54 layers) in bf16;
#: deepseek-v3-671b one MoE layer with 12 experts on the model axis, no
#: MTP head (serving runs none), in fp32 so that no route flips at a near
#: tie between the ranks' and one process's rounding.  4 decode steps
#: at llama3.2-1b's width, 8 at the others': a sharded decode step of
#: four thread-ranks takes about 1 s there (its FSDP blocks gathered
#: every step), and the script keeps within its time
SHARDED_SERVE = (
    ("llama3.2-1b", {}, "float32",
     (dict(tp=2, fsdp=2), dict(tp=2, fsdp=2, sp=True)), 4, 512, 4),
    ("zamba2-2.7b", dict(num_layers=6), "bfloat16", (dict(tp=2),), 4, 512,
     8),
    ("deepseek-v3-671b", dict(num_layers=1, moe_num_experts=12,
                              mtp_depth=0), "float32",
     (dict(tp=2, fsdp=2),), 4, 256, 8),
)
#: fp32 serve logits against one process's: the CPU tests' 1e-5 + 1e-5|x|
#: with |x| the row's largest logit.  Elementwise, at llama3.2-1b's full
#: width, the prefill's logits read 1.221e-4 off one process's (an H100
#: 80GB HBM3 at 700 W): a logit near 0 sums 2048 products of the row's
#: scale, so the ranks' fp32 rounding upstream moves it by a share of that
#: scale, not of itself; a missing partial sum moves a row by its scale
SHARDED_SERVE_TOL = 1e-5
#: the share of a bf16 run's greedy tokens that may flip (each at a near
#: tie, ``_compare_logits``), PERF.md section 2's rule
SHARDED_SERVE_FLIPPED = 0.02
SHARDED_PARAM_TOL = 1e-5  # the CPU tests' (atol and rtol)
SHARDED_LOSS_RTOL = 1e-5
#: the model-dtype runs' losses and grad norms against one process's,
#: relative, beside phase 4i's ``STEP_TOL`` (the readings were 7.3e-6 and
#: 3.5e-5; a dropped all-reduce moves them by more than 1e-2)
SHARDED_STEP_RTOL = 1e-4
#: the step-1 gradient of every leaf the model axis leaves whole (the
#: weights that feed split heads or channels: norms, MLA's ``w_dq`` /
#: ``w_dkv``, the router, Mamba-2's ``w_B`` / ``w_C`` / ``A_log`` ...),
#: each rank's block against the same block of one process's, in
#: ``||g - g1|| / ||g1||``: the CPU tests' 1e-5 in fp32; in bf16 the
#: ranks' partial sums are rounded before they are reduced (at most 1.1e-2
#: on an H100, zamba2's ``A_log``), while a gradient that misses one model
#: rank's part (``w_B`` / ``w_C`` / ``conv_bc_*``, ``w_dkv``, the router
#: without their input-gradient all-reduce) is off by a fifth of its norm
#: or more
SHARDED_GRAD_RTOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _threaded_ranks(torch, world, fn):
    """``fn(rank)`` on ``world`` threads, each a rank of the ``"threaded"``
    process group of ``torch.testing._internal.distributed.
    multi_threaded_pg`` on this card (its collectives copy device tensors in
    place on the card); the results by rank.  A failing rank wakes the
    others and fails the phase."""
    import threading
    import traceback

    import torch.distributed as dist
    from torch.testing._internal.distributed import multi_threaded_pg as mtpg

    isolate = getattr(torch._C._distributed_c10d,
                      "_set_thread_isolation_mode", None)
    if isolate is not None:
        isolate(True)
    if not hasattr(mtpg.ThreadLocalWorld, "comms"):
        # this torch's destroy_process_group reads ``_world.comms``, which
        # its threaded world does not keep: an empty list a thread
        mtpg.ThreadLocalWorld.comms = property(
            lambda self: vars(self._get_world()).setdefault("comms", []))
    mtpg._install_threaded_pg()
    store = dist.HashStore()
    out, errors = [None] * world, []

    def worker(rank):
        try:
            torch.cuda.set_device(0)
            dist.init_process_group("threaded", rank=rank, world_size=world,
                                    store=store)
            try:
                out[rank] = fn(rank)
            finally:
                dist.destroy_process_group()
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(f"rank {rank}: {traceback.format_exc()}")
            mtpg.ProcessLocalGroup.exception_handle(e)

    threads = [threading.Thread(target=worker, args=(r,), daemon=True)
               for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
    finally:
        mtpg.ProcessLocalGroup.reset()
        mtpg._uninstall_threaded_pg()
        if isolate is not None:
            isolate(False)
    stuck = [i for i, t in enumerate(threads) if t.is_alive()]
    check(not stuck and not errors,
          f"sharded: ranks {stuck} did not finish; "
          f"{errors[0][-3000:] if errors else ''}")
    return out


@contextlib.contextmanager
def _local_shapes():
    """Record the heads / channels each prefill, decode, scan and SSD call
    sees, and the rows of each RMSNorm call (all threads): yields the set
    of (kernel, heads...) and ("rmsnorm", rows) tuples."""
    from repro_torch.kernels import ops

    seen = set()
    real = {n: getattr(ops, n) for n in
            ("flash_attention", "selective_scan", "ssd", "rmsnorm",
             "decode_attention")}

    def decode(q, k, v, *a, **kw):
        seen.add(("decode_attention", q.shape[2], k.shape[2]))
        return real["decode_attention"](q, k, v, *a, **kw)

    def flash(q, k, v, *a, **kw):
        seen.add(("flash_attention", q.shape[2], k.shape[2]))
        seen.add(("flash_attention", q.shape[2], k.shape[2], k.shape[1],
                  kw.get("causal", True)))
        return real["flash_attention"](q, k, v, *a, **kw)

    def rmsnorm(x, *a, **kw):
        seen.add(("rmsnorm", x.numel() // x.shape[-1]))
        return real["rmsnorm"](x, *a, **kw)

    def scan(u, *a, **kw):
        seen.add(("selective_scan", u.shape[-1]))
        return real["selective_scan"](u, *a, **kw)

    def ssd(x, *a, **kw):
        seen.add(("ssd", x.shape[2]))
        return real["ssd"](x, *a, **kw)

    ops.flash_attention, ops.selective_scan, ops.ssd = flash, scan, ssd
    ops.rmsnorm, ops.decode_attention = rmsnorm, decode
    try:
        yield seen
    finally:
        for n, f in real.items():
            setattr(ops, n, f)


def _sharded_mesh(par):
    """The ``MeshSpec`` the four ranks place ``par`` on: ``("data",
    "model")`` keeping ``tp``."""
    from repro_torch.launch.mesh import MeshSpec

    tp = par.tp
    return MeshSpec.of((SHARDED_WORLD // tp, tp), ("data", "model"))


@contextlib.contextmanager
def _gate_magnitudes(torch):
    """The magnitude of each vlm gate's gradient sum: yields a list that
    every ``tanh(gate) * y`` product of the runs inside
    (``models.transformer.gated``, hooked) fills, in forward call order,
    with ``sech^2(gate) * ||dL/d(gated) * y||`` (the root of the sum of the
    products' squares) in fp32, a (1,) tensor on the host, when its
    backward runs."""
    from repro_torch.models import transformer

    real = transformer.gated
    out = []

    def probed(gate, y):
        prod = real(gate, y)
        if prod.requires_grad:
            slot = len(out)
            out.append(None)

            def hook(g):
                sech2 = 1.0 - torch.tanh(gate.detach().float()) ** 2
                m = torch.linalg.vector_norm(g.float() * y.detach().float())
                out[slot] = (sech2 * m).reshape(1).cpu()
            prod.register_hook(hook)
        return prod

    transformer.gated = probed
    try:
        yield out
    finally:
        transformer.gated = real


def gate_hold(torch, g_rank, g_one, magnitude):
    """The bf16 hold of a gate's gradient (``SHARDED_REDUCTION_LEAVES``):
    ``||g_rank - g_one|| / ||magnitude||``, the error over the magnitude of
    what the gradient sums (``_gate_magnitudes``), to be at most
    ``SHARDED_REDUCTION_RTOL``."""
    err = float(torch.linalg.vector_norm(g_rank.float() - g_one.float()))
    return err / max(float(torch.linalg.vector_norm(magnitude.float())),
                     1e-30)


def _model_whole(cfg, par):
    """``{path: spec}`` of the parameters that the rules leave whole on
    the model axis of the four ranks' mesh under ``par`` (a
    ``ParallelConfig``; :func:`_sharded_mesh`): each one's gradient sums
    every model rank's part."""
    from repro_torch.models.model import build_model
    from repro_torch.sharding.specs import param_specs
    from repro_torch.utils.trees import flatten_with_paths

    def axes(entry):
        return () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))

    meta = build_model(cfg, par, device="meta").init(0)
    specs = flatten_with_paths(param_specs(meta, cfg, par,
                                           _sharded_mesh(par)))
    return {k: spec for k, spec in sorted(specs.items())
            if not any("model" in axes(e) for e in spec)}


@contextlib.contextmanager
def _step1_grads(torch, paths):
    """The first step's gradients of ``paths`` (after every reduction,
    before clipping) on the host, by rank (-1 without a process group):
    yields the dict the train step's calls of ``clip_by_global_norm`` fill
    (every thread of the threaded world)."""
    import torch.distributed as dist

    import repro_torch.train.train_step as ts
    from repro_torch.utils.trees import flatten_with_paths

    seen = {}
    clip = ts.clip_by_global_norm

    def spy(grads, max_norm, layout=None):
        rank = dist.get_rank() if dist.is_initialized() else -1
        if rank not in seen and paths:
            flat = flatten_with_paths(grads)
            seen[rank] = {k: flat[k].detach().to("cpu", torch.float32,
                                                 copy=True) for k in paths}
        return clip(grads, max_norm, layout)

    ts.clip_by_global_norm = spy
    try:
        yield seen
    finally:
        ts.clip_by_global_norm = clip


def _hold_grads(torch, what, ranks, one, specs, tol, par):
    """Each rank's step-1 gradients of the leaves ``specs`` names against
    the rank's blocks of one process's (``local_shard`` at the rank's
    coordinates of ``par``'s mesh, :func:`_sharded_mesh`): the worst
    ``||g - g1|| / ||g1||`` and its leaf, checked against ``tol``.  In
    bf16 (``tol`` the bf16 one) a leaf of ``SHARDED_REDUCTION_LEAVES`` is
    held by :func:`gate_hold` instead, against one process's magnitudes
    (``one["gate_magnitudes"]``); returns also the worst of those and its
    leaf."""
    from repro_torch.launch.mesh import coords_of, local_shard

    mesh = _sharded_mesh(par)
    worst, at = 0.0, None
    gworst, gat = 0.0, None
    scaled = tol == SHARDED_GRAD_RTOL["bfloat16"]
    for i, r in enumerate(ranks):
        check(set(r["grads"]) == set(specs),
              f"{what}: rank {i} recorded {sorted(r['grads'])}")
        for k, spec in specs.items():
            want = local_shard(one["grads"][k], spec, mesh,
                               coords_of(i, mesh))
            if scaled and k.endswith(SHARDED_REDUCTION_LEAVES):
                rel = gate_hold(torch, r["grads"][k], want,
                                one["gate_magnitudes"])
                if rel >= gworst:
                    gworst, gat = rel, k
                check(rel <= SHARDED_REDUCTION_RTOL,
                      f"{what}: rank {i}'s step-1 gradient of {k} is off "
                      f"by {rel:.3e} of the magnitude of its products "
                      f"(tolerance {SHARDED_REDUCTION_RTOL})")
                continue
            ref = float(torch.linalg.vector_norm(want))
            err = float(torch.linalg.vector_norm(r["grads"][k] - want))
            rel = err / ref if ref > 0 else err
            if rel >= worst:
                worst, at = rel, k
            check(rel <= tol, f"{what}: rank {i}'s step-1 gradient of {k} "
                  f"is {rel:.3e} of one process's norm {ref:.3e} from it "
                  f"(tolerance {tol})")
    return worst, at, gworst, gat


def _one_process(torch, dev, cfg, run, steps, grad_paths=()):
    """The one-process loop on the emptied card: losses, grad norms, the
    first step's gradients of ``grad_paths`` and the final parameters on
    the host."""
    from repro_torch.launch.train import train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _step1_grads(torch, grad_paths) as grads, \
            _gate_magnitudes(torch) as gates:
        res = train(cfg, steps=steps, seq=run.shape.seq_len,
                    batch=run.shape.global_batch, device=dev, seed=0,
                    run=run)
    torch.cuda.synchronize()
    params = {k: v.detach().to("cpu", copy=True)
              for k, v in _flat(res.state.params)}
    out = {"losses": res.losses, "grad_norms": res.grad_norms,
           "step_ms": [t * 1e3 for t in res.step_s], "params": params,
           "grads": grads.get(-1, {}),
           # the first step's gates (one a super-block)
           "gate_magnitudes": (torch.cat(gates[:len(gates) // steps])
                               if gates else None),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del res
    torch.cuda.empty_cache()
    return out


def _sharded_run(torch, dev, cfg, run, steps, kernels, what,
                 whole_params=False, grad_paths=()):
    """``run`` on four thread-ranks: each rank's losses, step times,
    resolutions, step-1 collective bytes and step-1 gradients of
    ``grad_paths`` (leaves the mesh leaves whole); with ``whole_params``
    rank 0's whole parameters on the host; the launches by family, the
    local shapes seen, the collectives of the dry run's trace of rank 0's
    step for the same run and mesh."""
    import repro_torch.launch.train as tl
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.launch.build import lower_step
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.train import gather_state, train
    from repro_torch.sharding import collectives

    def rank_fn(rank):
        counted = {}

        def log_step(i, metrics, step_s):
            if i == 0:
                counted.update(collectives.bytes_by_kind())

        collectives.reset_counts()
        with dispatch.record_resolutions() as resolved:
            res = train(cfg, steps=steps, seq=run.shape.seq_len,
                        batch=run.shape.global_batch, device=dev, seed=0,
                        log=log_step, run=run)
            torch.cuda.synchronize()
        modes = sorted({(r.family, r.mode) for r in resolved})
        state_bytes = _tensor_bytes(res.state)
        params = None
        if whole_params:  # the optimizer state goes first
            state = res.state._replace(opt_state=None, error_buf=None)
            res.state = None
            whole = gather_state(state, res.run, res.mesh,
                                 host=rank == 0)
            params = dict(_flat(whole.params)) if rank == 0 else None
            del state, whole
        out = {"losses": res.losses, "grad_norms": res.grad_norms,
               "step_ms": [t * 1e3 for t in res.step_s], "modes": modes,
               "counted": counted, "params": params,
               "state_gb": state_bytes / 1e9, "run": res.run}
        del res
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    with _local_shapes() as shapes, _step1_grads(torch,
                                                  grad_paths) as grads:
        ranks = _threaded_ranks(torch, SHARDED_WORLD, rank_fn)
    for i, r in enumerate(ranks):
        r["grads"] = grads.get(i, {})
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    gc.collect()  # what the rank threads left in cycles
    torch.cuda.empty_cache()
    placed = ranks[0]["run"]
    for r in ranks:
        bad = [m for m in r["modes"] if m[1] != "cuda"]
        check(r["modes"] and not bad, f"{what}: resolutions {r['modes']}")
    for name, *_ in kernels:
        check(launches.get(name, 0) > 0,
              f"{what}: the sharded step launched no {name}: {launches}")
    check(kernels <= shapes, f"{what}: the kernels saw {sorted(shapes)}, "
          f"want {sorted(kernels)} among them")
    # the trace at the dtype of the stub inputs the step received (the
    # train CLI's data: fp32 vision_embeds / frames)
    batch = tl.make_data(placed.model, placed.shape).batch_at(0)
    stub = next((torch.as_tensor(batch[k]).dtype
                 for k in ("frames", "vision_embeds") if k in batch), None)
    _, traced = lower_step(placed, MeshSpec.of(placed.mesh.shape,
                                               placed.mesh.axes),
                           stub_dtype=stub)
    recorded = {k: int(v) for k, v in
                traced.cost_analysis().collective_bytes.items()}
    for i, r in enumerate(ranks):
        check(r["counted"] == recorded,
              f"{what}: rank {i}'s step-1 collective bytes {r['counted']}, "
              f"the dry run's trace of rank 0 {recorded}")
    norms = {t for t in shapes if t[0] == "rmsnorm"}
    return ranks, {"launches": {k: v for k, v in launches.items() if v},
                   "local_shapes": sorted(shapes - norms, key=str),
                   "norm_rows": sorted(norms), "traced": recorded,
                   "peak_gb": peak / 1e9, "launch_counts": launches,
                   "dryrun_peak_gb_per_rank":
                       traced.memory_analysis().peak_memory_in_bytes / 1e9}


def _norm_rows(what, info, run, placed):
    """The rows RMSNorm launched at in a sharded run: under the sequence
    split the stream's sequence block, ``B S / m`` of a data rank's ``B``
    rows (and the MTP head's whole ``B S``), else ``B S`` (and the audio
    encoder's ``B T``); checked."""
    from repro_torch.sharding.specs import sequence_blocks

    cfg = run.model
    mesh = _sharded_mesh(placed.parallel)
    b = placed.shape.global_batch // mesh.shape["data"]
    rows = b * placed.shape.seq_len
    blocks = sequence_blocks(placed.parallel, mesh, placed.shape.seq_len,
                             cfg.family)
    seen = sorted(r for k, r in info["norm_rows"])
    want = {rows // blocks} | ({rows} if cfg.mtp_depth > 0 else set()) | (
        {b * cfg.encoder_seq} if cfg.family == "audio" else set())
    check(seen and set(seen) <= want and rows // blocks in seen,
          f"{what}: RMSNorm launched at {seen} rows, want {sorted(want)}")
    return seen


def _collective_gb(counted):
    return {k: round(v / 1e9, 6) for k, v in sorted(counted.items())}


def _serve_runs(cfg, plan, batch, prompt, steps):
    """The prefill and decode runs of a sharded serve run on the four
    ranks' ``("data", "model")`` mesh (:func:`_sharded_mesh`)."""
    from repro_torch.utils.config import (MeshConfig, ParallelConfig,
                                          RunConfig, ShapeConfig,
                                          TrainConfig)

    par = ParallelConfig(**plan)
    mesh = _sharded_mesh(par)
    runs = []
    for kind, seq in (("prefill", prompt), ("decode", prompt + steps)):
        runs.append(RunConfig(
            model=cfg, shape=ShapeConfig(f"serve_{kind}", seq, batch, kind),
            mesh=MeshConfig(shape=tuple(mesh.shape.values()),
                            axes=mesh.axis_names),
            parallel=par, train=TrainConfig(compute_dtype=cfg.dtype)))
    return runs


def _serve_steps(torch, model, runs, params, tokens, steps, mesh=None,
                 forced=None):
    """A prefill of ``tokens`` and ``steps`` decode steps (greedy, or
    teacher-forced with ``forced`` (B, steps)), eager, on ``mesh`` when
    given: the logits a step in fp32 on the host, the greedy tokens a step
    (B, 1 + steps) on the host, and the collective bytes by kind a step
    (counted when ``mesh`` is given)."""
    from repro_torch.sharding import collectives
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step,
                                              sample_token)

    run, drun = runs
    prefill = make_prefill_step(model, run, cache_len=drun.shape.seq_len,
                                mesh=mesh)
    decode = make_decode_step(model, drun, mesh=mesh)
    logits, greedy, counted = [], [], []
    with torch.no_grad():
        for i in range(1 + steps):
            collectives.reset_counts()
            if i == 0:
                state, lg = prefill(params, {"tokens": tokens})
            else:
                fed = (greedy[-1] if forced is None
                       else forced[:, i - 1].to(tokens.device))
                state, lg = decode(params, state, fed[:, None])
            tok = sample_token(lg, None)
            logits.append(lg.float().cpu())
            greedy.append(tok)
            counted.append(collectives.bytes_by_kind() if mesh is not None
                           and mesh.groups is not None else {})
    return logits, torch.stack([t.cpu() for t in greedy], 1), counted


def _sharded_serve(torch, dev, arch, cuts, dtype, plans, batch, prompt,
                   steps):
    """One model served on the four thread-ranks under each plan of
    ``plans`` against one process: per plan each rank's logits of its rows
    (teacher-forced with one process's greedy tokens) held to one
    process's (fp32: ``SHARDED_SERVE_TOL``; bf16: ``_compare_logits`` with
    at most ``SHARDED_SERVE_FLIPPED`` of the tokens flipped, each at a near
    tie), its collective bytes of the prefill and of every decode step
    equal to the dry run's trace of rank 0's prefill and decode steps,
    every resolution ``cuda``, the kernels at the local shapes of
    ``SHARDED_KERNELS["serve", arch]``.  Returns (summaries, launches)."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.launch.build import lower_step
    from repro_torch.launch.mesh import MeshSpec, make_mesh
    from repro_torch.models.model import build_model
    from repro_torch.sharding.layout import shard_params
    from repro_torch.sharding.specs import sequence_blocks

    cfg = get_model_config(arch).replace(dtype=dtype, **cuts)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=gen, device=dev, dtype=torch.int32)
    runs = _serve_runs(cfg, {}, batch, prompt, steps)
    t0 = time.perf_counter()
    one, greedy, _ = _serve_steps(torch, model, runs, params, tokens, steps)
    one_s = time.perf_counter() - t0
    launches = {k: 0 for k in cuda_lib.LAUNCHES}
    out = []
    for plan in plans:
        what = f"sharded serve {arch} {plan} {dtype}"
        runs = _serve_runs(cfg, plan, batch, prompt, steps)
        smodel = build_model(cfg, runs[0].parallel, device=dev)

        def rank_fn(rank):
            mesh = make_mesh(runs[0].mesh)
            data = mesh.groups["data"]
            n = batch // data.size
            lo = data.rank * n
            blocks = shard_params(params, runs[0], mesh, rank)
            with dispatch.record_resolutions() as resolved:
                t1 = time.perf_counter()
                logits, _, counted = _serve_steps(
                    torch, smodel, runs, blocks, tokens[lo:lo + n], steps,
                    mesh, forced=greedy[lo:lo + n, :steps])
                torch.cuda.synchronize()
                took = time.perf_counter() - t1
            return {"rows": (lo, lo + n), "logits": logits,
                    "counted": counted, "s": took,
                    "modes": sorted({(r.family, r.mode) for r in resolved})}

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        with _local_shapes() as shapes:
            ranks = _threaded_ranks(torch, SHARDED_WORLD, rank_fn)
        own = dict(cuda_lib.LAUNCHES)
        for k, v in own.items():
            launches[k] += v
        peak = torch.cuda.max_memory_allocated()
        want = SHARDED_KERNELS["serve", arch]
        for name, *_ in want:
            check(own.get(name, 0) > 0,
                  f"{what}: the sharded steps launched no {name}: {own}")
        check(want <= shapes, f"{what}: the kernels saw {sorted(shapes)}, "
              f"want {sorted(want)} among them")
        mesh_d = _sharded_mesh(runs[0].parallel)
        b = batch // mesh_d.shape["data"]
        blocks_ = sequence_blocks(runs[0].parallel, mesh_d, prompt,
                                  cfg.family)
        norms = sorted(r for k, r in (t for t in shapes
                                      if t[0] == "rmsnorm"))
        check(set(norms) == {b * prompt // blocks_, b},
              f"{what}: RMSNorm launched at {norms} rows, want "
              f"{sorted({b * prompt // blocks_, b})}")
        traced = [{k: int(v) for k, v in lower_step(
            r, MeshSpec.of(r.mesh.shape, r.mesh.axes))[1].cost_analysis()
            .collective_bytes.items()} for r in runs]
        worst, share, flipped, total = 0.0, 0.0, 0, 0
        for i, r in enumerate(ranks):
            bad = [m for m in r["modes"] if m[1] != "cuda"]
            check(r["modes"] and not bad, f"{what}: resolutions "
                  f"{r['modes']}")
            check(r["counted"][0] == traced[0],
                  f"{what}: rank {i}'s prefill collective bytes "
                  f"{r['counted'][0]}, the dry run's trace {traced[0]}")
            for j, c in enumerate(r["counted"][1:]):
                check(c == traced[1], f"{what}: rank {i}'s decode step {j} "
                      f"collective bytes {c}, the dry run's trace "
                      f"{traced[1]}")
            lo, hi = r["rows"]
            want_l = [lg[lo:hi] for lg in one]
            for j, (got, ref) in enumerate(zip(r["logits"], want_l)):
                check(bool(torch.isfinite(got).all()),
                      f"{what}: rank {i} step {j}: non-finite logits")
                worst = max(worst, float((got - ref).abs().max()))
                same = got.argmax(-1) == ref.argmax(-1)
                flipped += int((~same).sum())
                total += same.numel()
                if dtype == "float32":
                    err = (got - ref).abs()
                    row = ref.abs().amax(-1, keepdim=True)
                    share = max(share, float((err / row).max()))
                    check(bool((err <= SHARDED_SERVE_TOL + SHARDED_SERVE_TOL
                                * row).all()),
                          f"{what}: rank {i} step {j}: logits off one "
                          f"process's by {float(err.max()):.3e} (tolerance "
                          f"{SHARDED_SERVE_TOL} + {SHARDED_SERVE_TOL} x the "
                          f"row's largest |logit|)")
                    check(bool(same.all()), f"{what}: rank {i} step {j}: "
                          f"greedy tokens differ from one process's")
            if dtype != "float32":
                scale = max(float(lg.abs().max()) for lg in want_l)
                atol = (SSM_LOGIT_ATOL_SHARE * scale
                        if cfg.family in ("ssm", "hybrid") else None)
                _compare_logits(torch, r["logits"], want_l, cfg.vocab_size,
                                f"{what} rank {i}", atol=atol, batch=hi - lo)
        check(flipped <= SHARDED_SERVE_FLIPPED * total,
              f"{what}: {flipped} of {total} greedy tokens flipped")
        summary = {
            "arch": arch, "cuts": cuts, "dtype": dtype, "placements": plan,
            "batch": batch, "prompt": prompt, "decode_steps": steps,
            "max_abs_logit_diff": worst, "logit_scale": max(
                float(lg.abs().max()) for lg in one),
            "max_diff_over_row_scale": share, "flipped": flipped,
            "tokens": total, "prefill_bytes": traced[0],
            "decode_step_bytes": traced[1],
            "local_shapes": sorted((t for t in shapes if t[0] != "rmsnorm"),
                                   key=str),
            "rmsnorm_rows": norms, "launches": {k: v for k, v in own.items()
                                                if v},
            "rank_s": [r["s"] for r in ranks], "one_process_s": one_s,
            "peak_gb": peak / 1e9}
        log(f"[{CARD}] {what}: {batch} x {prompt} prefill + {steps} decode "
            f"steps on 4 thread-ranks (rows {[r['rows'] for r in ranks]}): "
            f"logits within {worst:.3e} of one process's (largest |logit| "
            f"{summary['logit_scale']:.1f}; {share:.3e} of a row's largest "
            f"in fp32), {flipped} of "
            f"{total} greedy tokens flipped; collective bytes = traced "
            f"(prefill {traced[0]}, a decode step {traced[1]}); kernel "
            f"shapes {summary['local_shapes']}; RMSNorm rows {norms}; "
            f"launches {summary['launches']}; ranks "
            f"{[round(r['s'], 2) for r in ranks]} s (one process "
            f"{one_s:.2f} s); peak {peak / 1e9:.1f} GB")
        out.append(summary)
        del ranks, smodel
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def phase_sharded(torch, np, dev):
    """Phase 4m: the train step under tensor parallelism, sequence
    parallelism, FSDP and the expert placements, and the vlm / audio
    families on a model axis, then the prefill and decode steps of three
    models (``SHARDED_SERVE``), four thread-ranks on the card.  Returns
    (summary, launches of the sharded runs by family)."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch.train import make_run
    from repro_torch.utils.config import ParallelConfig, TrainConfig

    launches = {name: 0 for name in cuda_lib.LAUNCHES}
    out = {"ranks": f"{SHARDED_WORLD} thread-ranks of the 'threaded' "
                    f"process group on cuda:0",
           "card": CARD, "note": "the four ranks share one card: step "
                                 "times are not a multi-card speed, and "
                                 "the peak is the four ranks' together"}
    gc.collect()
    torch.cuda.empty_cache()
    out["held_before_gb"] = torch.cuda.memory_allocated() / 1e9
    log(f"sharded: {out['ranks']} (torch.testing._internal.distributed."
        f"multi_threaded_pg), a ('data', 'model') mesh of (2, 2) "
        f"(tp=4: (1, 4)); {out['held_before_gb']:.1f} GB held by the "
        f"earlier phases")
    kinds = set()

    # -- llama3.2-1b, fp32, tp=2 + fsdp=2 (+ sp), against one process ----
    d = SHARDED_DENSE
    cfg = get_model_config(d["arch"]).replace(dtype="float32")
    one = None
    out["dense_plans"] = []
    for plan in d["plans"]:
        run = make_run(cfg, seq=d["seq"], batch=d["batch"], steps=d["steps"],
                       parallel=ParallelConfig(**plan))
        run = run.replace(train=TrainConfig(lr=1e-3, warmup_steps=10,
                                            total_steps=d["steps"],
                                            compute_dtype="float32"))
        t0 = time.perf_counter()
        what = f"sharded dense {plan}"
        paths = _model_whole(cfg, run.parallel)
        if one is None:  # one process steps the same for every plan
            one = _one_process(torch, dev, cfg, run.replace(
                parallel=ParallelConfig()), d["steps"], list(paths))
        ranks, info = _sharded_run(torch, dev, cfg, run, d["steps"],
                                   SHARDED_KERNELS["train", d["arch"]], what,
                                   whole_params=True, grad_paths=list(paths))
        gworst, gat, _, _ = _hold_grads(torch, what, ranks, one, paths,
                                        SHARDED_GRAD_RTOL["float32"],
                                        run.parallel)
        norm_rows = _norm_rows(what, info, run, ranks[0]["run"])
        for i, r in enumerate(ranks):
            rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                       one["losses"])]
            check(max(rel) <= SHARDED_LOSS_RTOL,
                  f"{what}: rank {i} losses {r['losses']}, one process "
                  f"{one['losses']}")
        got = ranks[0]["params"]
        check(set(got) == set(one["params"]), f"{what}: parameter paths")
        worst, outside, n = 0.0, 0, 0
        for k, want in one["params"].items():
            err = (got[k] - want).abs()
            tol = SHARDED_PARAM_TOL + SHARDED_PARAM_TOL * want.abs()
            outside += int((err > tol).sum())
            worst = max(worst, float((err - tol).max()))
            n += want.numel()
        log(f"[{CARD}] {what} {d['arch']} fp32, {d['steps']} steps of "
            f"{d['batch']} x {d['seq']}: losses {ranks[0]['losses']} (one "
            f"process {one['losses']}); parameters outside "
            f"{SHARDED_PARAM_TOL} + {SHARDED_PARAM_TOL}|p|: {outside} of "
            f"{n} (worst excess {worst:.3e}); step-1 gradients of the "
            f"{len(paths)} leaves the model axis leaves whole within "
            f"{gworst:.3e} of one process's (worst {gat}); collectives "
            f"{ranks[0]['counted']} = traced (GB "
            f"{_collective_gb(ranks[0]['counted'])}); "
            f"kernel shapes {info['local_shapes']}; RMSNorm rows "
            f"{norm_rows}; launches {info['launches']}; peak "
            f"{info['peak_gb']:.1f} GB for the four ranks, "
            f"{info['peak_gb'] / SHARDED_WORLD:.1f} an even share (one "
            f"process {one['peak_gb']:.1f} GB; the dry run's peak a rank "
            f"{info['dryrun_peak_gb_per_rank']:.2f} GB), state a rank "
            f"{ranks[0]['state_gb']:.2f} GB; step ms by rank "
            f"{[r['step_ms'] for r in ranks]} (one process "
            f"{one['step_ms']})")
        check(outside == 0, f"{what}: {outside} of {n} parameters outside "
              f"the CPU tests' tolerance (worst excess {worst:.3e})")
        kinds |= set(ranks[0]["counted"])
        out["dense_plans"].append({
            "arch": d["arch"], "placements": plan,
            "losses": ranks[0]["losses"],
            "losses_one_process": one["losses"],
            "grad_norms": ranks[0]["grad_norms"],
            "params_outside_tol": outside,
            "model_whole_grad_rel": gworst,
            "model_whole_grad_worst_leaf": gat,
            "model_whole_leaves": len(paths),
            "collective_bytes": ranks[0]["counted"],
            "collective_gb": _collective_gb(ranks[0]["counted"]),
            "rmsnorm_rows": norm_rows,
            "step_ms": [r["step_ms"] for r in ranks],
            "step_ms_one_process": one["step_ms"],
            "state_gb_per_rank": ranks[0]["state_gb"],
            "phase_s": time.perf_counter() - t0,
            **{k: v for k, v in info.items()
               if k not in ("launch_counts", "norm_rows")}})
        for k, v in info["launch_counts"].items():
            launches[k] += v
        del ranks, got
    out["dense"] = out["dense_plans"][0]
    del one

    # -- the other families in the model dtype ------------------------
    out["families"] = []
    ones = {}  # one process's run of a (arch, cuts, batch, seq), once
    equal = {}  # whisper's losses by plan: sp must not change them
    for arch, cuts, par, batch, seq, optimizer in SHARDED_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_model_config(arch).replace(**cuts)
        run = make_run(cfg, seq=seq, batch=batch,
                       steps=SHARDED_FAMILY_STEPS,
                       parallel=ParallelConfig(**par))
        run = run.replace(train=dataclasses.replace(run.train,
                                                    optimizer=optimizer))
        what = f"sharded {arch} {par} {optimizer}"
        key = (arch, tuple(sorted(cuts.items())), batch, seq, optimizer)
        paths = _model_whole(cfg, run.parallel)
        if key not in ones:  # the leaves of every placement sharing it
            shared = sorted({k for a, c, p, b, q, o in SHARDED_FAMILIES
                             if (a, tuple(sorted(c.items())), b, q, o)
                             == key for k in _model_whole(
                                 cfg, ParallelConfig(**p))})
            ones = {key: _one_process(torch, dev, cfg, run.replace(
                parallel=ParallelConfig()), SHARDED_FAMILY_STEPS,
                shared)}
        one = ones[key]
        ranks, info = _sharded_run(torch, dev, cfg, run,
                                   SHARDED_FAMILY_STEPS,
                                   SHARDED_KERNELS["train", arch], what,
                                   grad_paths=list(paths))
        got = ranks[0]
        for i, r in enumerate(ranks):
            for j, (lk, lr_) in enumerate(zip(r["losses"], one["losses"])):
                check(abs(lk - lr_) <= STEP_TOL["loss_rtol"] * abs(lr_)
                      and abs(lk - lr_) <= SHARDED_STEP_RTOL * abs(lr_),
                      f"{what}: rank {i} step {j} loss {lk}, one process "
                      f"{lr_}")
            for j, (gk, gr) in enumerate(zip(r["grad_norms"],
                                             one["grad_norms"])):
                check(abs(gk - gr) <= STEP_TOL["grad_norm_rtol"] * abs(gr)
                      and abs(gk - gr) <= SHARDED_STEP_RTOL * abs(gr),
                      f"{what}: rank {i} step {j} grad norm {gk}, one "
                      f"process {gr}")
        loss_rel = max(abs(a - b) / abs(b) for r in ranks
                       for a, b in zip(r["losses"], one["losses"]))
        gnorm_rel = max(abs(a - b) / abs(b) for r in ranks
                        for a, b in zip(r["grad_norms"], one["grad_norms"]))
        gworst, gat, gate_rel, gate_at = _hold_grads(
            torch, what, ranks, one, paths, SHARDED_GRAD_RTOL[cfg.dtype],
            run.parallel)
        norm_rows = _norm_rows(what, info, run, got["run"])
        if cfg.family == "audio":
            equal[par.get("sp", False)] = [r["losses"] for r in ranks]
        kinds |= set(got["counted"])
        log(f"[{CARD}] {what} ({cfg.num_layers} layers, {batch} x {seq}, "
            f"{cfg.dtype}): losses {got['losses']} (one process "
            f"{one['losses']}), grad norms {got['grad_norms']} "
            f"({one['grad_norms']}), relative {loss_rel:.3e} / "
            f"{gnorm_rel:.3e}; step-1 gradients of the {len(paths)} "
            f"leaves the model axis leaves whole within "
            f"{gworst:.3e} of one process's (worst "
            f"{gat})"
            + (f", the gate's within {gate_rel:.3e} of its products' "
               f"magnitude" if gate_at else "")
            + f"; collectives {got['counted']} = "
            f"traced (GB {_collective_gb(got['counted'])}); kernel shapes "
            f"{info['local_shapes']}; RMSNorm rows {norm_rows}; peak "
            f"{info['peak_gb']:.1f} GB for the four ranks, "
            f"{info['peak_gb'] / SHARDED_WORLD:.1f} an even share (one "
            f"process {one['peak_gb']:.1f} GB; the dry run's peak a rank "
            f"{info['dryrun_peak_gb_per_rank']:.2f} GB), state a rank "
            f"{got['state_gb']:.2f} GB; step ms by rank "
            f"{[r['step_ms'] for r in ranks]} (one process "
            f"{one['step_ms']})")
        out["families"].append({
            "arch": arch, "cuts": cuts, "placements": par,
            "optimizer": optimizer, "batch": batch, "seq": seq,
            "losses": got["losses"], "losses_one_process": one["losses"],
            "grad_norms": got["grad_norms"],
            "grad_norms_one_process": one["grad_norms"],
            "loss_rel": loss_rel, "grad_norm_rel": gnorm_rel,
            "model_whole_grad_rel": gworst,
            "model_whole_grad_worst_leaf": gat,
            "model_whole_leaves": len(paths),
            "gate_grad_over_magnitude": gate_rel if gate_at else None,
            "collective_bytes": got["counted"],
            "collective_gb": _collective_gb(got["counted"]),
            "rmsnorm_rows": norm_rows,
            "step_ms": [r["step_ms"] for r in ranks],
            "step_ms_one_process": one["step_ms"],
            "state_gb_per_rank": got["state_gb"],
            "tolerance": dict(STEP_TOL, rtol=SHARDED_STEP_RTOL,
                              model_whole_grad_rtol=SHARDED_GRAD_RTOL[
                                  cfg.dtype]),
            "phase_s": time.perf_counter() - t0,
            **{k: v for k, v in info.items()
               if k not in ("launch_counts", "norm_rows")}})
        for k, v in info["launch_counts"].items():
            launches[k] += v
        del one, ranks, got
        torch.cuda.empty_cache()
    check(len(equal) == 2 and equal[True] == equal[False],
          f"sharded whisper: tp=4 and tp=4 sp losses by rank {equal} "
          f"differ (sp must cut nothing of the audio family)")
    log(f"sharded whisper: tp=4 and tp=4 sp losses equal bit for bit: "
        f"{equal[False][0]}")

    # -- the serve steps: prefill and decode on the four ranks -----------
    out["serve"] = []
    for arch, cuts, dtype, plans, batch, prompt, steps in SHARDED_SERVE:
        t0 = time.perf_counter()
        served, own = _sharded_serve(torch, dev, arch, cuts, dtype, plans,
                                     batch, prompt, steps)
        for s in served:
            s["phase_s"] = time.perf_counter() - t0
            kinds |= set(s["prefill_bytes"]) | set(s["decode_step_bytes"])
        out["serve"] += served
        for k, v in own.items():
            launches[k] += v
    missing = [k for k in ("all-reduce", "all-gather", "reduce-scatter",
                           "all-to-all") if k not in kinds]
    out["collective_kinds_on_card"] = sorted(kinds)
    out["collective_kinds_not_run"] = missing
    log(f"sharded: collective kinds run on the card {sorted(kinds)}; not "
        f"run: {missing or 'none'}")
    check(not missing, f"sharded: no {missing} ran on the card")
    return out, launches


# --------------------------------------------------------------------------
# phase 5: timings
# --------------------------------------------------------------------------

SM_HZ = 1.98e9  # H100 SXM boost clock, for the spin kernel's length


# --------------------------------------------------------------------------
# phase 4k: the dry run against the card
# --------------------------------------------------------------------------

#: (shape, mesh) of phase 4k's llama3.2-1b cells under the plan the port
#: executes (data-only mesh, ``tp=1,fsdp=1``): one data rank's step is the
#: card's program; train at 2 x 4096 rows (128 data ranks): the dry run
#: puts 4 x 4096 at a 77.9 GiB peak (77.97 measured alone), which the
#: allocator's fragmentation after phase 3 does not leave room for
DRYRUN_CELLS = (("decode_32k", "16x1"), ("prefill_32k", "16x1"),
                ("train_4k", "128x1"))
DRYRUN_PLAN = "tp=1,fsdp=1"
#: the train cell's ``remat`` policies: the plan's ``"dots"`` first (its
#: summary keeps the cell's name), then the others under ``train_4k
#: remat=<policy>``
DRYRUN_REMAT = ("dots", "none", "full")


def _rank_inputs(torch, dev, run, model):
    """The real arguments of one data rank's step of ``run`` (already cut
    to the rank's batch) on the card, seeded: a decode state with every
    slot at the cache's last row."""
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.serve_step import (ServeState, make_decode_step,
                                              make_prefill_step)
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    gen = torch.Generator(device=dev).manual_seed(0)
    b, s = run.shape.global_batch, run.shape.seq_len
    vocab = run.model.vocab_size

    def tokens(*shape):
        return torch.randint(0, vocab, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    kind = run.shape.kind
    if kind == "train":
        opt = make_optimizer(run.train)
        state = init_train_state(model, run, opt, seed=0)
        return make_train_step(model, run, opt), [
            state, {"inputs": tokens(b, s), "targets": tokens(b, s)}]
    params = model.init(0)
    if kind == "prefill":
        return make_prefill_step(model, run), [params,
                                               {"tokens": tokens(b, s)}]
    state = ServeState(model.init_decode_state(b, s),
                       torch.full((b,), s - 1, dtype=torch.int32,
                                  device=dev), {})
    return make_decode_step(model, run), [params, state, tokens(b, 1)]


def _tensor_bytes(tree):
    from repro_torch.launch.hlo_analysis import tensors

    return sum(t.numel() * t.element_size() for t in tensors(tree))


def _scope_host_cost(torch, np, step, args, rounds=8, steps=10):
    """Host p50 (ms, synchronised) of an eager step with the kernel
    scopes as they are against ``ops._scoped`` swapped for a bare call,
    in turns (``rounds`` of ``steps`` each, the order flipped every
    round): what the scopes cost a step when no counter listens, beside
    the spread of the rounds' own p50s."""
    from repro_torch.kernels import ops

    scoped = ops._scoped

    def bare(name, body, *a, **k):
        return body(*a, **k)

    times = {"scoped": [], "bare": []}
    rounds_p50 = {"scoped": [], "bare": []}
    try:
        for r in range(rounds):
            for variant in (("scoped", "bare") if r % 2 == 0
                            else ("bare", "scoped")):
                ops._scoped = scoped if variant == "scoped" else bare
                got = []
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(*args)
                    torch.cuda.synchronize()
                    got.append(time.perf_counter() - t0)
                times[variant] += got
                rounds_p50[variant].append(float(np.median(got)) * 1e3)
    finally:
        ops._scoped = scoped
    out = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    out["rounds_p50"] = rounds_p50
    return out


def _scope_call_ns(calls=200000, rounds=5):
    """Host ns of one ``ops._scoped`` call with no counter listening,
    against the direct call it wraps (the best of ``rounds`` runs of
    ``calls`` each, in turns): the scopes' cost, resolved below the step's
    own spread."""
    from repro_torch.kernels import ops

    def body(*a, **k):
        return None

    best = {"scoped": math.inf, "direct": math.inf}
    for _ in range(rounds):
        for variant in best:
            t0 = time.perf_counter()
            if variant == "scoped":
                for _ in range(calls):
                    ops._scoped("rmsnorm", body, 1, x=2)
            else:
                for _ in range(calls):
                    body(1, x=2)
            best[variant] = min(best[variant],
                                (time.perf_counter() - t0) / calls * 1e9)
    return best


def _hold_remat(torch, np, summary, policies):
    """Phase 4k's train cell under each ``remat`` policy: the allocated
    peaks ordered none > dots > full, and every step's metrics and the
    parameters after the four steps equal across the policies, bit for
    bit where the card gives it, else within ``STEP_TOL`` (losses and
    grad norms; the parameters' largest difference recorded)."""
    shape = next(s for s, _ in DRYRUN_CELLS if s.startswith("train"))
    key = {r: shape if r == DRYRUN_REMAT[0] else f"{shape} remat={r}"
           for r in DRYRUN_REMAT}
    peak = {r: summary[key[r]]["max_allocated"] for r in DRYRUN_REMAT}
    check(peak["none"] > peak["dots"] > peak["full"],
          f"4k: allocated peaks not ordered none > dots > full: {peak}")
    base_metrics, base_params = policies["none"]
    out = {"allocated_peak_bytes": peak, "bit_for_bit": {}}
    for r in DRYRUN_REMAT:
        if r == "none":
            continue
        metrics, params = policies[r]
        same = metrics == base_metrics and all(
            torch.equal(a, b) for a, b in zip(params, base_params))
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(params, base_params))
        out["bit_for_bit"][r] = same
        out[f"param_max_abs_diff_{r}"] = diff
        if not same:
            for got, want in zip(metrics, base_metrics):
                check(abs(got["loss"] - want["loss"])
                      <= STEP_TOL["loss_rtol"] * abs(want["loss"]),
                      f"4k remat={r}: loss {got['loss']} vs {want['loss']}")
                check(abs(got["grad_norm"] - want["grad_norm"])
                      <= STEP_TOL["grad_norm_rtol"] * abs(want["grad_norm"]),
                      f"4k remat={r}: grad norm {got['grad_norm']} vs "
                      f"{want['grad_norm']}")
    log(f"[{CARD}] 4k {ARCH} {shape} remat: allocated peaks "
        f"{ {r: round(n / 2**30, 2) for r, n in peak.items()} } GiB; "
        f"losses, metrics and parameters against none: bit for bit "
        f"{out['bit_for_bit']}, parameters' max |diff| "
        f"{ {r: out[f'param_max_abs_diff_{r}'] for r in out['bit_for_bit']} }")
    return out


def phase_dryrun(torch, np, dev):
    """4k. ``dryrun_cell`` on three llama3.2-1b cells (``DRYRUN_CELLS``)
    under the plan the port executes, then one data rank's real step on
    the card from seeded weights: (a) the dry run's kernel scopes by family
    equal the step's launches, its ``<name>_bwd`` scopes the recompute
    backwards; (b) its argument bytes equal the real arguments' exactly;
    (c) its peak beside ``max_memory_allocated`` over the step; (d) the
    step's device time (CUDA events) against the roofline bound at the
    H100's constants.  The train cell runs under each ``remat`` policy
    (``DRYRUN_REMAT``: the recompute's launches among the scopes), held by
    :func:`_hold_remat`.  Then one ``CompiledPerfEnv`` intervention, timed.
    Returns (summary, launches)."""
    import tempfile

    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import tensors
    from repro_torch.launch.roofline import roofline_from_record
    from repro_torch.models.model import build_model
    from repro_torch.tuner.compiled_env import CompiledPerfEnv

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cuda_lib.reset_launches()
    summary = {}
    policies = {}  # remat -> (metrics of each call, parameters after)
    cells = [(shape, mesh_kv, remat) for shape, mesh_kv in DRYRUN_CELLS
             for remat in (DRYRUN_REMAT if shape.startswith("train")
                           else (None,))]
    for shape, mesh_kv, remat in cells:
        plan = DRYRUN_PLAN + (f",remat={remat}" if remat else "")
        key = (shape if remat in (None, DRYRUN_REMAT[0])
               else f"{shape} remat={remat}")
        t0 = time.perf_counter()
        rec = dryrun.dryrun_cell(ARCH, shape, par_kv=plan,
                                 mesh_kv=mesh_kv, save=False)
        dry_s = time.perf_counter() - t0
        check(all(c.split()[2] == "data"
                  for c in rec["collective_schedule_head"]),
              f"{shape}: collectives off the data axis on a data-only "
              f"mesh: {rec['collective_schedule_head']}")
        run = dryrun.cell_run(ARCH, shape, par_kv=plan, mesh_kv=mesh_kv)
        dsize = run.mesh.shape[0]
        b = run.shape.global_batch
        rank_run = run.replace(shape=dataclasses.replace(
            run.shape, global_batch=b // dsize if b % dsize == 0 else b))
        model = build_model(rank_run.model, rank_run.parallel, device=dev)
        step, args = _rank_inputs(torch, dev, rank_run, model)
        real_args = _tensor_bytes(args)
        # a train step's metrics of each call (a serve step's logits would
        # keep the prompt's whole logits alive)
        outs = []
        keep = outs.append if remat is not None else (lambda m: None)
        keep(step(*args)[1])  # warm-up
        torch.cuda.synchronize()
        before = dict(cuda_lib.LAUNCHES)
        ops.reset_recomputes()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        keep(step(*args)[1])
        end.record()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launched = {k: cuda_lib.LAUNCHES[k] - before[k]
                    for k in cuda_lib.LAUNCHES
                    if cuda_lib.LAUNCHES[k] != before[k]}
        recomputed = {f"{k}_bwd": v for k, v in ops.RECOMPUTES.items() if v}
        times = [start.elapsed_time(end)]
        for _ in range(2):
            start.record()
            keep(step(*args)[1])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        step_ms = float(np.median(times))
        if remat is not None:
            policies[remat] = (
                [{k: float(v) for k, v in m.items()} for m in outs],
                [p.detach().cpu() for p in tensors(args[0].params)])
        del outs
        scopes = rec["kernel_scopes"]
        fwd = {k: v for k, v in scopes.items() if not k.endswith("_bwd")}
        bwd = {k: v for k, v in scopes.items() if k.endswith("_bwd")}
        check(fwd == launched,
              f"{shape}: dry-run kernel scopes {fwd} != the step's "
              f"launches {launched}")
        check(bwd == recomputed,
              f"{shape}: dry-run backward scopes {bwd} != the recompute "
              f"backwards {recomputed}")
        predicted_args = rec["memory_analysis"]["argument_bytes"]
        check(predicted_args == real_args,
              f"{shape}: predicted argument bytes {predicted_args} != the "
              f"real arguments' {real_args}")
        row = roofline_from_record(rec)
        bound_ms = max(row.compute_s, row.memory_s) * 1e3
        predicted_peak = rec["memory_analysis"]["peak_bytes"]
        summary[key] = {
            "mesh": mesh_kv, "remat": remat, "rank_batch": rank_run.shape.global_batch,
            "seq": run.shape.seq_len, "dryrun_s": dry_s,
            "kernel_scopes": scopes, "launches": launched,
            "recomputes": recomputed, "argument_bytes": real_args,
            "predicted_peak_bytes": predicted_peak, "max_allocated": peak,
            "peak_ratio": predicted_peak / peak,
            "step_ms": step_ms, "step_ms_runs": times,
            "compute_ms": row.compute_s * 1e3,
            "memory_ms": row.memory_s * 1e3, "bound_ms": bound_ms,
            "bound_by": "compute" if row.compute_s >= row.memory_s
            else "memory",
            "step_over_bound": step_ms / bound_ms,
            "flops_per_chip": rec["hlo_analysis"]["flops_per_chip"],
            "bytes_per_chip": rec["hlo_analysis"]["bytes_per_chip"],
            "matmul_flops": rec["matmul_flops"]}
        rows = rank_run.shape.global_batch
        log(f"[{CARD}] 4k {ARCH} {key} ({mesh_kv}, rank {rows} x "
            f"{run.shape.seq_len}): dry run {dry_s:.2f} s; "
            f"scopes {scopes} = launches {launched} + recomputes "
            f"{recomputed}; argument bytes {real_args} predicted exactly; "
            f"peak predicted {predicted_peak / 2**30:.2f} GiB vs allocated "
            f"{peak / 2**30:.2f} GiB (ratio {predicted_peak / peak:.3f}); "
            f"step {step_ms:.3f} ms vs roofline {bound_ms:.3f} ms "
            f"({summary[key]['bound_by']}-bound, ratio "
            f"{step_ms / bound_ms:.2f})")
        if rank_run.shape.kind == "decode":
            host = _scope_host_cost(torch, np, step, args)
            summary[key]["scope_host_p50_ms"] = host
            call = _scope_call_ns()
            added_us = (call["scoped"] - call["direct"]) * sum(
                scopes.values()) / 1e3
            summary[key]["scope_call_ns"] = call
            summary[key]["scope_us_a_step"] = added_us
            log(f"[{CARD}] 4k eager decode step host p50 with the kernel "
                f"scopes {host['scoped']:.3f} ms, bare {host['bare']:.3f} "
                f"ms; the rounds' p50s {host['rounds_p50']}; a scope call "
                f"{call['scoped']:.1f} ns against the direct call's "
                f"{call['direct']:.1f} ns: {added_us:.2f} us for the "
                f"step's {sum(scopes.values())} scopes")
        del step, args, model
        torch.cuda.empty_cache()
    summary["remat"] = _hold_remat(torch, np, summary, policies)
    with tempfile.TemporaryDirectory() as cache:
        env = CompiledPerfEnv(ARCH, "decode_32k", cache_dir=cache)
        t0 = time.perf_counter()
        counters, y = env.intervene(env.space.default_config())
        summary["compiled_env"] = {"intervene_s": time.perf_counter() - t0,
                                   "step_bound_s": y, "counters": counters}
        check(math.isfinite(y) and y > 0,
              f"CompiledPerfEnv scored the default plan {y}")
    launches = dict(cuda_lib.LAUNCHES)
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"[{CARD}] 4k CompiledPerfEnv intervention (decode_32k, default "
        f"plan on 16x16) {summary['compiled_env']['intervene_s']:.2f} s, "
        f"bound {y * 1e3:.4f} ms; phase {summary['phase_s']:.1f} s")
    return summary, launches


# --------------------------------------------------------------------------
# phase 4l: the static analysis against the card
# --------------------------------------------------------------------------

#: the perturbation of the control: a record whose shared bytes are off by
#: this many must fail the holder
CONTROL_SMEM_OFFSET = 16
#: profiled windows a group of launches may take before a lost kernel
#: record fails the phase (the trace drops records at random; phase 4f)
PROFILE_ATTEMPTS = 3


def _device_limits(torch):
    """4l.1: the analysis's sm_90 limits against the card's properties,
    each where this torch exposes it."""
    from repro_torch.utils import hardware

    props = torch.cuda.get_device_properties(0)
    held, lacking = {}, []
    for field, want in (
            ("shared_memory_per_block_optin", hardware.H100_SMEM_PER_BLOCK),
            ("regs_per_multiprocessor", hardware.REGISTERS_PER_SM),
            ("max_threads_per_block", hardware.MAX_BLOCK_THREADS)):
        have = getattr(props, field, None)
        if have is None:
            lacking.append(field)
            continue
        check(int(have) == want, f"4l: the card's {field} is {have}; the "
              f"analysis holds launches to {want}")
        held[field] = int(have)
    log(f"[{CARD}] 4l limits held against the card: {held}; not exposed by "
        f"torch {torch.__version__} (not checked): {lacking}")
    return held, lacking


def _demangled(symbols):
    """``{symbol: demangled name}`` by the toolkit's ``cu++filt``."""
    from repro_torch.kernels import cuda_lib

    filt = Path(cuda_lib.nvcc_path()).parent / "cu++filt"
    out = subprocess.run([str(filt)], input="\n".join(symbols) + "\n",
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.splitlines()
    check(len(out) == len(symbols), f"4l: cu++filt gave {len(out)} names "
          f"for {len(symbols)} symbols")
    return dict(zip(symbols, out))


def _analysis_gate(ptxas_log):
    """4l.2: the port's gate with the build's ptxas report, as a
    subprocess; it must exit 0."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate", "--format",
         "json", "--ptxas", str(ptxas_log), "src/repro_torch"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(SRC)),
        capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"4l: python -m repro_torch.analysis --gate "
          f"--ptxas exited {res.returncode}:\n{res.stdout[-4000:]}\n"
          f"{res.stderr[-4000:]}")
    doc = json.loads(res.stdout)
    summary = doc["summary"]
    warnings = [f"{f['rule']}: {f['message']}" for f in doc["findings"]]
    log(f"4l gate: exit 0, {summary['configs_checked']} launch configs "
        f"checked, {summary['files_scanned']} files, "
        f"{len(doc['suppressed'])} suppressed, warnings {warnings} "
        f"({time.perf_counter() - t0:.1f} s)")
    return {"configs_checked": summary["configs_checked"],
            "warnings": warnings, "gate_s": time.perf_counter() - t0}


@contextlib.contextmanager
def _nan_outputs(torch):
    """Every float tensor the wrappers allocate with ``torch.empty``,
    ``torch.empty_like`` or ``Tensor.new_empty`` underneath starts as NaN,
    so an output element no block writes stays NaN."""
    saved = (torch.empty, torch.empty_like, torch.Tensor.new_empty)

    def poisoned(fn):
        def call(*args, **kwargs):
            t = fn(*args, **kwargs)
            if t.is_cuda and t.is_floating_point():
                t.fill_(float("nan"))
            return t
        return call

    torch.empty, torch.empty_like = poisoned(saved[0]), poisoned(saved[1])
    torch.Tensor.new_empty = poisoned(saved[2])
    try:
        yield
    finally:
        torch.empty, torch.empty_like, torch.Tensor.new_empty = saved


def _attention_case(torch, dev, shape, dtype, cfg, seed):
    """The prefill (and, where the shape is decoded, the split decode) at
    ``shape``: (kernel call, plain call) pairs, in launch order."""
    from repro_torch.kernels.flash_attention.kernel import (
        decode_attention_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        attention_blockwise_ref, decode_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hkv, g = shape["batch"], shape["kv_heads"], shape["g"]
    d, dv, sq, skv = shape["d"], shape["dv"], shape["sq"], shape["skv"]
    q = _rand(torch, gen, (b, sq, hkv * g, d), dtype, dev)
    k = _rand(torch, gen, (b, skv, hkv, d), dtype, dev)
    v = _rand(torch, gen, (b, skv, hkv, dv), dtype, dev)
    kw = dict(causal=shape["causal"])
    calls = [(lambda: flash_attention_cuda(q, k, v, q_block=cfg["q_block"],
                                           kv_block=cfg["kv_block"], **kw),
              lambda: attention_blockwise_ref(q, k, v, kv_block=64, **kw))]
    if shape["decode"]:
        qd = _rand(torch, gen, (b, 1, hkv * g, d), dtype, dev)
        lens = torch.tensor([skv, skv // 2 + 1][:b], dtype=torch.int32,
                            device=dev)
        calls.append((lambda: decode_attention_cuda(
            qd, k, v, lens, kv_block=cfg["kv_block"]),
            lambda: decode_attention_ref(qd, k, v, lens)))
    return calls


def _paged_case(torch, dev, shape, dtype, cfg, seed):
    from repro_torch.kernels.paged_attention.kernel import (
        paged_decode_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(seed)
    b, hkv, g, d = shape["batch"], shape["kv_heads"], shape["g"], shape["d"]
    ps, n_pages = cfg["page_size"], cfg["pages_per_slot_max"]
    pool = b * n_pages + 1
    kp = _rand(torch, gen, (pool, ps, hkv, d), dtype, dev)
    vp = _rand(torch, gen, (pool, ps, hkv, d), dtype, dev)
    table = (torch.randperm(pool - 1, generator=gen, device=dev)[
        :b * n_pages] + 1).view(b, n_pages).to(torch.int32)
    cap = ps * n_pages
    lens = torch.tensor([cap - 3, cap // 2 + 1][:b], dtype=torch.int32,
                        device=dev)
    q = _rand(torch, gen, (b, 1, hkv * g, d), dtype, dev)
    return [(lambda: paged_decode_attention_cuda(q, kp, vp, table, lens),
             lambda: paged_decode_attention_ref(q, kp, vp, table, lens))]


def _scan_case(torch, dev, shape, dtype, cfg, seed):
    from repro_torch.kernels.mamba_scan.kernel import selective_scan_cuda
    from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    a = scan_inputs(torch, gen, shape["batch"], shape["len"],
                    shape["channels"], shape["n"], 0.1, dtype, dev)
    rs = shape["return_state"]
    return [(lambda: selective_scan_cuda(*a, chunk=cfg["chunk"],
                                         c_block=cfg["c_block"],
                                         return_state=rs),
             lambda: selective_scan_chunked_ref(*a, chunk=64,
                                                return_state=rs))]


def _ssd_case(torch, dev, shape, dtype, cfg, seed):
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ref import ssd_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    b, l, h = shape["batch"], shape["len"], shape["heads"]
    p, g, n = shape["p"], shape["groups"], shape["n"]
    a = list(ssd_inputs(torch, gen, b, l, h, p, g, n, 0.1, dtype, dev))
    # a model's dt: fp32, from its fp32 dt_bias (what the records assume)
    a[1] = torch.rand((b, l, h), generator=gen, device=dev) * 0.1
    kw = dict(return_state=True) if shape["states"] else {}
    if shape["states"]:
        kw["init_state"] = _rand(torch, gen, (b, h, n, p), torch.float32,
                                 dev)
    return [(lambda: ssd_cuda(*a, chunk=cfg["chunk"], **kw),
             lambda: ssd_ref(*a, chunk=64, **kw))]


def _rmsnorm_case(torch, dev, shape, dtype, cfg, seed):
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _rand(torch, gen, (shape["rows"], shape["dim"]), dtype, dev)
    w = _rand(torch, gen, (shape["dim"],), dtype, dev)
    return [(lambda: rmsnorm_cuda(x, w, row_block=cfg["row_block"]),
             lambda: rmsnorm_ref(x, w))]


#: each registered family's calls at one shape, dtype and launch config;
#: a family registered without one fails the phase
FAMILY_CASES = {"flash_attention": _attention_case,
                "paged_attention": _paged_case, "mamba_scan": _scan_case,
                "ssd": _ssd_case, "rmsnorm": _rmsnorm_case}


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _kernel_events(prof):
    """The profiled kernel events of the port's kernels, in launch order:
    ``(canonical name, args)``."""
    import tempfile

    from repro_torch.analysis.kernels import canonical_name

    with tempfile.TemporaryDirectory(prefix="chip_smoke_4l_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    return [(canonical_name(e["name"]), e.get("args", {}))
            for e in kernels
            if canonical_name(e["name"]).startswith("repro::")]


def _hold_launch(event, record, registers):
    """What differs between one profiled launch and the analysis's record
    of it (empty when they agree): name, grid, block, shared bytes, and
    registers against ptxas.  A field the event lacks is a difference."""
    name, args = event
    diffs = []
    if name != record.kernel:
        diffs.append(f"kernel {name} != {record.kernel}")
    for key, want in (("grid", list(record.grid)),
                      ("block", list(record.block)),
                      ("shared memory", record.smem),
                      ("registers per thread", registers)):
        if key not in args:
            diffs.append(f"no {key!r} in the profiler's record")
        elif args[key] != want:
            diffs.append(f"{key} {args[key]} != {want}")
    return diffs


def _largest_shape(records_fn, shapes, dtype, configs, extra):
    """The shape of the set whose launches take the most shared bytes (the
    most threads on a tie) over every config."""
    def weight(shape):
        return max((r.smem, r.threads) for cfg in configs
                   for r in records_fn(shape, dtype, **cfg, **extra))
    return max(shapes, key=weight)


def _check_outputs(torch, what, dn, first, second, plain, errs):
    """A kernel call's outputs: no NaN left where the plain version has
    none (the grid covers the output), the plain version's values within
    phase 3's tolerances, and a second launch bit for bit."""
    for i, (o, o2, r) in enumerate(zip(first, second, plain)):
        tag = f"{what} output {i}"
        left = torch.isnan(o) & ~torch.isnan(r)
        check(not bool(left.any()), f"4l {tag}: {int(left.sum())} of "
              f"{o.numel()} elements never written (still NaN)")
        _compare(torch, f"4l {tag}", o, r, dn, errs, True)
        check(torch.equal(o, o2), f"4l {tag}: two launches differ, max "
              f"{float((o.float() - o2.float()).abs().max()):.3e}")


def phase_analysis(torch, dev, lib_path):
    """4l. the static analysis against the card: (1) its sm_90 limits
    against the device's properties; (2) ``python -m repro_torch.analysis
    --gate --ptxas <build>/ptxas.log src/repro_torch`` exits 0; (3) every
    config of every family's launch domain launched at the shape of the set
    with the most shared bytes (each dtype) under ``torch.profiler``: each
    kernel event's grid, block and shared bytes equal the analysis's
    record and its registers the ptxas report (names matched through
    ``cu++filt``, which must spell every ptxas symbol as
    ``instance_name`` does), every output covered (NaN-filled first),
    within phase 3's tolerances of the plain version and bit for bit across
    two launches; (4) a record with its shared bytes off by 16 must fail
    the same holder."""
    import inspect

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import kernels as analysis
    from repro_torch.kernels import cuda_lib, dispatch

    t_phase = time.perf_counter()
    summary = {}
    summary["limits"], summary["limits_not_exposed"] = _device_limits(torch)
    ptxas_log = lib_path.parent / "ptxas.log"
    summary["gate"] = _analysis_gate(ptxas_log)

    usage = analysis.ptxas_usage(ptxas_log.read_text())
    filt = _demangled(sorted(usage))
    for sym, text in filt.items():
        check(analysis.canonical_name(text) == analysis.instance_name(sym),
              f"4l: cu++filt spells {sym} as {text!r}; instance_name gives "
              f"{analysis.instance_name(sym)!r}")
    by_name = {analysis.canonical_name(filt[s]): u for s, u in usage.items()}
    summary["ptxas"] = {n: {"registers": u.registers,
                            "spill_stores": u.spill_stores,
                            "spill_loads": u.spill_loads,
                            "static_smem": u.smem}
                        for n, u in sorted(by_name.items())}
    log(f"[{CARD}] 4l ptxas by instance (registers / spill stores + loads "
        f"/ static smem): " + "; ".join(
            f"{n} {u.registers}r/{u.spill_stores}+{u.spill_loads}B/"
            f"{u.smem}B" for n, u in sorted(by_name.items())))

    cfgs = analysis.model_configs()
    missing = set(dispatch.families()) - set(FAMILY_CASES)
    check(not missing, f"4l: no launch case for families {sorted(missing)}")
    errs, launched, largest = [], 0, {}
    cuda_lib.reset_launches()
    held = None
    for family in dispatch.families():
        _, shapes_fn, records_fn = analysis.launch_plan(family)
        extra = ({"sm_count": cuda_lib.sm_count(dev)}
                 if "sm_count" in inspect.signature(records_fn).parameters
                 else {})
        configs = analysis.option_configs(family)
        shapes = shapes_fn(cfgs)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            shape = _largest_shape(records_fn, shapes, dtype, configs, extra)
            cases = []
            for i, cfg in enumerate(configs):
                records = records_fn(shape, dtype, **cfg, **extra)
                calls = FAMILY_CASES[family](torch, dev, shape, dtype, cfg, i)
                check(len(calls) == len(records), f"4l {family}: "
                      f"{len(calls)} calls for {len(records)} records")
                cases.append((cfg, records, calls,
                              [_outputs(plain()) for _, plain in calls]))
            expected = [r for _, records, _, _ in cases for r in records
                        for _ in range(2)]
            for attempt in range(1, PROFILE_ATTEMPTS + 1):
                with _nan_outputs(torch), profile(activities=[
                        ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    outs = [[(_outputs(kernel()), _outputs(kernel()))
                             for kernel, _ in calls]
                            for _, _, calls, _ in cases]
                    torch.cuda.synchronize()
                events = _kernel_events(prof)
                if len(events) == len(expected):
                    break
                log(f"4l {family} {dn}: {len(events)} kernel records for "
                    f"{len(expected)} launches (attempt {attempt})")
            check(len(events) == len(expected), f"4l {family} {dn}: the "
                  f"profiler recorded {len(events)} of {len(expected)} "
                  f"launches in {PROFILE_ATTEMPTS} windows")
            # the launches: each call twice, the calls in their records'
            # order
            order = [(cfg, r) for cfg, records, _, _ in cases
                     for r in records for _ in range(2)]
            for event, (cfg, rec) in zip(events, order):
                u = by_name.get(rec.kernel)
                check(u is not None and u.smem == rec.static_smem,
                      f"4l: {rec.kernel}: static shared bytes "
                      f"{rec.static_smem} against the ptxas report's "
                      f"{u.smem if u else 'missing entry'}")
                diffs = _hold_launch(event, rec, u.registers)
                check(not diffs, f"4l {family} {dn} {cfg} at {shape}: the "
                      f"launch differs from its record: {diffs}")
                held = held or (event, rec, u.registers)
            for (cfg, records, calls, plains), pairs in zip(cases, outs):
                for j, ((first, second), plain) in enumerate(zip(pairs,
                                                                 plains)):
                    _check_outputs(torch, f"{family} {dn} {cfg} call {j}",
                                   dn, first, second, plain, errs)
            launched += len(events)
            rec = max((r for _, rs, _, _ in cases for r in rs),
                      key=lambda r: r.smem)
            largest[f"{family} {dn}"] = {
                "kernel": rec.kernel, "smem": rec.smem,
                "static_smem": rec.static_smem, "threads": rec.threads,
                "shape": shape, "configs": len(configs)}
            log(f"4l {family} {dn}: {len(configs)} configs at {shape}, "
                f"{len(events)} launches held to their records; most shared "
                f"bytes {rec.smem} ({rec.kernel}) of "
                f"{cuda_lib.SMEM_LIMIT}")
    launches = dict(cuda_lib.LAUNCHES)
    # 4. the control: the same holder must reject a record off by 16 bytes
    event, rec, regs = held
    off = dataclasses.replace(rec, dynamic_smem=rec.dynamic_smem
                              + CONTROL_SMEM_OFFSET)
    control = _hold_launch(event, off, regs)
    check(any(d.startswith("shared memory") for d in control),
          f"4l control: a record with {CONTROL_SMEM_OFFSET} more shared "
          f"bytes passed the holder")
    summary.update(launches_held=launched, largest_smem=largest,
                   smem_limit=cuda_lib.SMEM_LIMIT, control=control,
                   max_abs_err=max(errs),
                   phase_s=time.perf_counter() - t_phase)
    log(f"[{CARD}] 4l analysis against the card: {launched} launches of "
        f"{sum(len(analysis.option_configs(f)) for f in dispatch.families())}"
        f" configs x 2 dtypes held to their records; control rejected "
        f"({control}); phase {summary['phase_s']:.1f} s")
    return summary, launches


def _time_ms(torch, fn, flush, reps=30, warmup=5):
    """Median device time of one call of ``fn`` over ``reps`` runs.

    The device is first held busy by a spin kernel long enough for the host
    to queue every run, so the host's launch overhead (tens of us per call
    through Python on this machine) is not counted.  Each run is bracketed
    by its own pair of events, after an L2 flush (``flush``), since on the
    serving path a layer's inputs were last touched a whole forward ago."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flush()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = min(max(3.0 * host_s * reps, 1e-3), 2.0)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(spin_s * SM_HZ))
    for start, end in pairs:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[reps // 2]


def _bound(nbytes, flops, dtype_name, elementwise=False):
    rate = PEAK_FLOPS["float32"] if elementwise else PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def _work(work):
    """The bytes and operations of a kernel's ``launch_work`` (the count
    the launch geometry prices with), as ``row`` / ``extra`` take them."""
    return {"nbytes": work.hbm, "flops": work.flops}


def _scan_clock(torch, fn, calls=3000):
    """The SM clock sampled by nvidia-smi while ``calls`` launches of the
    scan keep the card busy, and the card's top SM clock (MHz)."""
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in ln.split(",")] for ln in out.splitlines()
               if ln.count(",") == 1]
    check(bool(samples), "nvidia-smi gave no SM clock samples")
    busy = [s for s, _ in samples]
    log(f"selective_scan: SM clock {min(busy):.0f}-{max(busy):.0f} MHz "
        f"under load (max {samples[-1][1]:.0f})")
    return busy, samples[-1][1]


def _scan_sweep(torch, a, flush, channels, chunks):
    """The scan on ``a`` at each of ``channels`` a block and ``chunks``
    steps a pass (explicit plans, the planner's rules off): the sweep
    behind the planner's default of 64 channels and chunk 64."""
    from repro_torch.kernels.mamba_scan.kernel import (launch_scan,
                                                       make_plan)

    b, l, c = a[0].shape
    out = {}
    for chunk in chunks:
        for ch in channels:
            p = make_plan(b, c, a[2].shape[1], a[0].element_size(), ch, chunk)
            out[f"lanes{p.lanes}/ch{p.channels}/chunk{p.chunk}"] = _time_ms(
                torch, lambda: launch_scan(p, *a), flush)
    best = min(out, key=out.get)
    log(f"selective_scan sweep at {tuple(a[0].shape)} (us): "
        f"{ {k: round(v * 1e3, 1) for k, v in out.items()} }; fastest "
        f"{best}")
    return out


def phase_timings(torch, dev, errs, launches, scan_launch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        decode_attention_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        attention_blockwise_ref, decode_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_decode_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.mamba_scan.kernel import (plan_scan,
                                                       selective_scan_cuda)
    from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd.kernel import ssd_cuda
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.kernels.flash_attention.kernel import (
        decode_work, launch_work as attention_work)
    from repro_torch.kernels.mamba_scan.kernel import (
        launch_work as scan_work)
    from repro_torch.kernels.paged_attention.kernel import (
        launch_work as paged_work)
    from repro_torch.kernels.rmsnorm.kernel import launch_work as norm_work
    from repro_torch.kernels.ssd.kernel import launch_work as ssd_work
    from repro_torch.utils.hardware import SFU_PER_SM

    def prefill(b, sq, skv, hq, hkv, d, dv, causal=True):
        (work,) = attention_work(dict(
            d=d, dv=dv, g=hq // hkv, causal=causal, decode=False, batch=b,
            kv_heads=hkv, sq=sq, skv=skv), bf)
        return _work(work)

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    es = 2
    rows = []

    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def flush():
        l2.zero_()

    def extra(entry, key, shape, kernel, plain, library, nbytes, flops,
              elementwise=False):
        """Time the same kernel at another shape, as ``entry[key]``."""
        ms = _time_ms(torch, kernel, flush)
        plain_ms = _time_ms(torch, plain, flush)
        lib_ms = (_time_ms(torch, library, flush) if library is not None
                  else None)
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16", elementwise)
        entry[key] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        log(f"{entry['name']} {key} {shape}: kernel {ms * 1e3:.1f} us, "
            f"plain {plain_ms * 1e3:.1f} us, library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by})")

    def row(name, source, replaces, shape, kernel, plain, library, nbytes,
            flops, elementwise=False, note=None):
        ms = _time_ms(torch, kernel, flush)
        plain_ms = _time_ms(torch, plain, flush)
        lib_ms = (_time_ms(torch, library, flush) if library is not None
                  else None)
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16", elementwise)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "dtype": "bfloat16",
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name], "max_abs_err": errs[name],
            "tolerance": {"float32": TOL["float32"],
                          "bfloat16": TOL["bfloat16"]},
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            **({"note": note} if note else {})})
        log(f"{name} {shape}: kernel {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, library "
            f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.1f} us'}, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by})")

    # rmsnorm at the fixed-batch prefill rows (4 x 64 x 2048)
    x = _rand(torch, gen, (4, 64, 2048), bf, dev)
    w = _rand(torch, gen, (2048,), bf, dev)
    n = x.numel()
    row("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/kernel.py:66", [4, 64, 2048],
        lambda: rmsnorm_cuda(x, w), lambda: rmsnorm_ref(x, w),
        lambda: F.rms_norm(x, (2048,), w, 1e-5),
        **_work(norm_work(dict(rows=n // 2048, dim=2048), bf)[0]),
        elementwise=True)
    # the decode step's rows (4 slots x 1 token) and the training rows
    # (2 x 1024 tokens) of falcon-mamba-7b (4096) and zamba2-2.7b (2560)
    for key, shape in (("decode", (4, 1, 2048)),
                       ("train_falcon_mamba", (2048, 4096)),
                       ("train_zamba2", (2048, 2560))):
        xe = _rand(torch, gen, shape, bf, dev)
        we = _rand(torch, gen, shape[-1:], bf, dev)
        ne = xe.numel()
        extra(rows[-1], key, list(shape),
              lambda: rmsnorm_cuda(xe, we), lambda: rmsnorm_ref(xe, we),
              lambda: F.rms_norm(xe, shape[-1:], we, 1e-5),
              **_work(norm_work(dict(rows=ne // shape[-1], dim=shape[-1]),
                                bf)[0]), elementwise=True)

    # prefill attention at the fixed-batch prompt (causal, 4 x 64 tokens)
    b, s, hq, hkv, d = 4, 64, 32, 8, 64
    q = _rand(torch, gen, (b, s, hq, d), bf, dev)
    k = _rand(torch, gen, (b, s, hkv, d), bf, dev)
    v = _rand(torch, gen, (b, s, hkv, d), bf, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:142", [b, s, hq, hkv, d],
        lambda: flash_attention_cuda(q, k, v),
        lambda: attention_blockwise_ref(q, k, v, kv_block=64),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        **prefill(b, s, s, hq, hkv, d, d))

    # the same kernel at zamba2-2.7b's training shape: head dim 80, 32 / 32
    # heads, 2 x 1024 tokens, causal (extra fields of the row above)
    shape = [2, 1024, 32, 32, 80]  # b, s, hq, hkv, d
    tq, tk, tv = (_rand(torch, gen, (2, 1024, 32, 80), bf, dev)
                  for _ in range(3))
    tqt, tkt, tvt = (t.transpose(1, 2) for t in (tq, tk, tv))
    t_ms = _time_ms(torch, lambda: flash_attention_cuda(
        tq, tk, tv, q_block=512, kv_block=1024), flush)
    t_plain = _time_ms(torch, lambda: attention_blockwise_ref(
        tq, tk, tv, kv_block=1024), flush)
    t_lib = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        tqt, tkt, tvt, is_causal=True), flush)
    t_bound, t_by = _bound(**prefill(2, 1024, 1024, 32, 32, 80, 80),
                           dtype_name="bfloat16")
    rows[-1]["train_shape"] = {
        "shape": shape, "ms": t_ms, "plain_ms": t_plain,
        "library_ms": t_lib, "bound_ms": t_bound, "bound_by": t_by}
    log(f"flash_attention {shape}: kernel {t_ms * 1e3:.1f} us, plain "
        f"{t_plain * 1e3:.1f} us, library {t_lib * 1e3:.1f} us, bound "
        f"{t_bound * 1e3:.2f} us ({t_by})")

    # a long serving prompt: llama3.2-1b, 1 x 2048 tokens, causal, with the
    # block sizes the serving path resolves (512 / 1024, snapped down)
    b, s, hq, hkv, d = 1, 2048, 32, 8, 64
    lq = _rand(torch, gen, (b, s, hq, d), bf, dev)
    lk, lv = (_rand(torch, gen, (b, s, hkv, d), bf, dev) for _ in range(2))
    lqt, lkt, lvt = (t.transpose(1, 2) for t in (lq, lk, lv))
    extra(rows[-1], "long_prompt", [b, s, hq, hkv, d],
          lambda: flash_attention_cuda(lq, lk, lv, q_block=512,
                                       kv_block=1024),
          lambda: attention_blockwise_ref(lq, lk, lv, kv_block=1024),
          lambda: F.scaled_dot_product_attention(
              lqt, lkt, lvt, is_causal=True, enable_gqa=True),
          **prefill(b, s, s, hq, hkv, d, d))
    # MLA prefill at deepseek-v3-671b's head dims: q/k 192, v 128, 128
    # heads, 1 x 2048 tokens, causal; SDPA takes a value head dim of its
    # own, so it is the library yardstick here too
    # (its own names and generator: the timings below reuse b, s, d and
    # draw from gen)
    mla = (1, 2048, 128, 192, 128)  # b, s, heads, d, dv
    mgen = torch.Generator(device=dev).manual_seed(16)
    mq, mk = (_rand(torch, mgen, mla[:3] + (mla[3],), bf, dev)
              for _ in range(2))
    mv = _rand(torch, mgen, mla[:3] + (mla[4],), bf, dev)
    mqt, mkt, mvt = (t.transpose(1, 2) for t in (mq, mk, mv))
    extra(rows[-1], "mla_prefill", [mla[0], mla[1], mla[2], mla[2],
                                    mla[3], mla[4]],
          lambda: flash_attention_cuda(mq, mk, mv),
          lambda: attention_blockwise_ref(mq, mk, mv, kv_block=64),
          lambda: F.scaled_dot_product_attention(
              mqt, mkt, mvt, is_causal=True),
          **prefill(mla[0], mla[1], mla[1], mla[2], mla[2], mla[3], mla[4]))
    # ... and at the shape phase 4g serves it: deepseek-v3-671b's fixed
    # batch, 4 x 64 tokens, with the serving path's block sizes
    sq_, sh_ = (4, 64, 128), (4, 64, 128, 128, 192, 128)
    sq, sk = (_rand(torch, mgen, sq_ + (192,), bf, dev) for _ in range(2))
    sv = _rand(torch, mgen, sq_ + (128,), bf, dev)
    sqt, skt, svt = (t.transpose(1, 2) for t in (sq, sk, sv))
    extra(rows[-1], "mla_prefill_served", list(sh_),
          lambda: flash_attention_cuda(sq, sk, sv, q_block=512,
                                       kv_block=1024),
          lambda: attention_blockwise_ref(sq, sk, sv, kv_block=1024),
          lambda: F.scaled_dot_product_attention(sqt, skt, svt,
                                                 is_causal=True),
          **prefill(4, 64, 64, 128, 128, 192, 128))
    # the vlm and audio families' non-causal shapes (phase 4h), with the
    # serving path's block sizes: a vision decode step's cross-attention
    # (4 slots x 1 query row over 1600 patch rows, 32 / 8 heads of 128) and
    # its prompt's (4 x 64 over 1600), and whisper's encoder
    # self-attention (4 x 1500 frames, 20 / 20 heads of 64)
    xgen = torch.Generator(device=dev).manual_seed(21)
    for key, (xb, xsq, xskv, xhq, xhkv, xd) in (
            ("cross_decode", (4, 1, 1600, 32, 8, 128)),
            ("cross_prefill", (4, 64, 1600, 32, 8, 128)),
            ("whisper_encoder", (4, 1500, 1500, 20, 20, 64))):
        xq = _rand(torch, xgen, (xb, xsq, xhq, xd), bf, dev)
        xk, xv = (_rand(torch, xgen, (xb, xskv, xhkv, xd), bf, dev)
                  for _ in range(2))
        xqt, xkt, xvt = (t.transpose(1, 2) for t in (xq, xk, xv))
        extra(rows[-1], key, [xb, xsq, xskv, xhq, xhkv, xd],
              lambda: flash_attention_cuda(xq, xk, xv, causal=False,
                                           q_block=512, kv_block=1024),
              lambda: attention_blockwise_ref(xq, xk, xv, causal=False,
                                              kv_block=1024),
              lambda: F.scaled_dot_product_attention(xqt, xkt, xvt,
                                                     enable_gqa=True),
              **prefill(xb, xsq, xskv, xhq, xhkv, xd, xd, causal=False))
    # the tensor-core kernel's block shapes (q_block x kv_block) at the
    # training shape and the long prompt
    sweep = {}
    for qb in (32, 64):
        for kb in (32, 64):
            sweep[f"q{qb}/kv{kb}"] = [_time_ms(torch, lambda: (
                flash_attention_cuda(x, y, z, q_block=qb, kv_block=kb)),
                flush) for x, y, z in ((tq, tk, tv), (lq, lk, lv))]
    rows[-1]["block_sweep_ms"] = {"shapes": ["train_shape", "long_prompt"],
                                  **sweep}
    log(f"flash_attention by block shape (train, long prompt): "
        f"{ {k: [round(t * 1e3, 1) for t in v] for k, v in sweep.items()} }"
        f" us")

    # dense and paged decode at the batcher's deployment: 4 slots, 512-row
    # caches (8 pages of 64), ragged lengths
    lens = [217, 100, 50, 181]
    b, skv = len(lens), 512
    q = _rand(torch, gen, (b, 1, hq, d), bf, dev)
    kc = _rand(torch, gen, (b, skv, hkv, d), bf, dev)
    vc = _rand(torch, gen, (b, skv, hkv, d), bf, dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(skv, device=dev)[None, :] < ln[:, None])[:, None, None]
    kvt, vvt = kc.transpose(1, 2), vc.transpose(1, 2)
    dec_work = _work(decode_work(bf, b, hkv, hq // hkv, d, skv, 64, lens))
    row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:263",
        [b, skv, hq, hkv, d],
        lambda: decode_attention_cuda(q, kc, vc, ln),
        lambda: decode_attention_ref(q, kc, vc, ln),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kvt, vvt, attn_mask=mask, enable_gqa=True),
        **dec_work)

    ps, n_pages = 64, 8
    kp = torch.cat([kc.reshape(b * n_pages, ps, hkv, d),
                    torch.zeros((1, ps, hkv, d), dtype=bf, device=dev)])
    vp = torch.cat([vc.reshape(b * n_pages, ps, hkv, d),
                    torch.zeros((1, ps, hkv, d), dtype=bf, device=dev)])
    table = torch.arange(b * n_pages, dtype=torch.int32,
                         device=dev).reshape(b, n_pages)
    row("paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:126",
        [b, n_pages, ps, hq, hkv, d],
        lambda: paged_decode_attention_cuda(q, kp, vp, table, ln),
        lambda: paged_decode_attention_ref(q, kp, vp, table, ln),
        None, **_work(paged_work(dict(batch=b, kv_heads=hkv, g=hq // hkv,
                                      d=d, lens=lens), bf, page_size=ps,
                                 pages_per_slot_max=n_pages)[0]))

    # dense and paged decode at a larger batch: 32 slots over 2048-row
    # caches (32 pages of 64), half full on average (seeded ragged lengths
    # in [512, 1536])
    b, skv, n_pages = 32, 2048, 32
    lens = torch.randint(512, 1537, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    q = _rand(torch, gen, (b, 1, hq, d), bf, dev)
    kc = _rand(torch, gen, (b, skv, hkv, d), bf, dev)
    vc = _rand(torch, gen, (b, skv, hkv, d), bf, dev)
    mask = (torch.arange(skv, device=dev)[None, :] < lens[:, None])[:, None,
                                                                    None]
    kvt, vvt = kc.transpose(1, 2), vc.transpose(1, 2)
    dec_work = _work(decode_work(bf, b, hkv, hq // hkv, d, skv, 64,
                                 lens.tolist()))
    extra(rows[-2], "batch32", [b, skv, hq, hkv, d],
          lambda: decode_attention_cuda(q, kc, vc, lens),
          lambda: decode_attention_ref(q, kc, vc, lens),
          lambda: F.scaled_dot_product_attention(
              q.transpose(1, 2), kvt, vvt, attn_mask=mask, enable_gqa=True),
          **dec_work)
    # the split planner's target at this shape: blocks per SM 8 / 16 / 32
    # (one of them is the planner's constant)
    import repro_torch.kernels.flash_attention.kernel as fa_kernel
    target, sweep = fa_kernel.DECODE_BLOCKS_PER_SM, {}
    try:
        for per_sm in (8, 16, 32):
            fa_kernel.DECODE_BLOCKS_PER_SM = per_sm
            fa_kernel.plan_decode_splits.cache_clear()
            sweep[per_sm] = _time_ms(
                torch, lambda: decode_attention_cuda(q, kc, vc, lens), flush)
    finally:
        fa_kernel.DECODE_BLOCKS_PER_SM = target
        fa_kernel.plan_decode_splits.cache_clear()
    rows[-2]["batch32"]["blocks_per_sm_ms"] = sweep
    log(f"decode_attention batch32 by the planner's blocks per SM: "
        f"{ {k: round(v * 1e3, 1) for k, v in sweep.items()} } us")
    kp = torch.cat([kc.reshape(b * n_pages, ps, hkv, d),
                    torch.zeros((1, ps, hkv, d), dtype=bf, device=dev)])
    vp = torch.cat([vc.reshape(b * n_pages, ps, hkv, d),
                    torch.zeros((1, ps, hkv, d), dtype=bf, device=dev)])
    table = torch.arange(b * n_pages, dtype=torch.int32,
                         device=dev).reshape(b, n_pages)
    extra(rows[-1], "batch32", [b, n_pages, ps, hq, hkv, d],
          lambda: paged_decode_attention_cuda(q, kp, vp, table, lens),
          lambda: paged_decode_attention_ref(q, kp, vp, table, lens), None,
          **_work(paged_work(dict(batch=b, kv_heads=hkv, g=hq // hkv, d=d,
                                  lens=lens.tolist()), bf, page_size=ps,
                             pages_per_slot_max=n_pages)[0]))

    # the Mamba-1 scan at falcon-mamba-7b's training shape, with the launch
    # options the train step resolved in phase 4b (the config's chunk 256,
    # the family's c_block), so the plan timed is the plan the step
    # launches; the plain version at the same chunk, as the recompute
    # backward runs it
    b, l, c, n = 2, 1024, 8192, 16
    a = scan_inputs(torch, gen, b, l, c, n, 0.1, bf, dev)
    plan = plan_scan(b, l, c, n, es, scan_launch["chunk"],
                     scan_launch["c_block"])
    row("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
        "src/repro/kernels/mamba_scan/kernel.py:87", [b, l, c, n],
        lambda: selective_scan_cuda(*a, **scan_launch),
        lambda: selective_scan_chunked_ref(*a, chunk=scan_launch["chunk"]),
        None,
        **_work(scan_work(dict(batch=b, len=l, channels=c, n=n,
                               return_state=False), bf)[0]),
        elementwise=True,
        note="operations: 7 per (b, t, c, n) (dt*A, exp, two products, two "
             "FMAs' worth) at the fp32 rate; the exponentials alone, on the "
             "special-function units (16 a clock an SM at clocks.max.sm), "
             "need B*L*C*N / (16 * SMs * clock)")
    rows[-1]["launch"] = dict(scan_launch)
    rows[-1]["plan"] = plan._asdict()
    busy, max_mhz = _scan_clock(
        torch, lambda: selective_scan_cuda(*a, **scan_launch))
    rows[-1]["sm_clock_mhz_samples"] = busy
    rows[-1]["sm_clock_max_mhz"] = max_mhz
    # the floor the exponentials set, kept as text: the row's only
    # computed time is bound_ms
    floor_us = b * l * c * n / (SFU_PER_SM * cuda_lib.sm_count(dev)
                                * max_mhz * 1e6) * 1e6
    rows[-1]["note"] += f" = {floor_us:.1f} us at {max_mhz:.0f} MHz"
    log(f"selective_scan: the exponentials alone need {floor_us:.1f} us on "
        f"the special-function units at {max_mhz:.0f} MHz")
    rows[-1]["sweep_ms"] = _scan_sweep(torch, a, flush, (8, 16, 32, 64),
                                       (32, 64))
    # serving's prefill: the fixed batch (4 x 64) of falcon-mamba-7b with
    # the serving path's options, without and with the final state (its
    # (B, C, N) fp32 store adds to the bytes)
    b, l = FIXED["batch"], FIXED["prompt_len"]
    a = scan_inputs(torch, gen, b, l, c, n, 0.1, bf, dev)
    for key, state in (("serve_prefill", False), ("serve_prefill_state", True)):
        extra(rows[-1], key, [b, l, c, n],
              lambda: selective_scan_cuda(*a, chunk=256, c_block=64,
                                          return_state=state),
              lambda: selective_scan_chunked_ref(*a, chunk=256,
                                                 return_state=state),
              None, **_work(scan_work(dict(batch=b, len=l, channels=c, n=n,
                                           return_state=state), bf)[0]),
              elementwise=True)

    # the Mamba-2 SSD at zamba2-2.7b's training shape (chunk 256 -> 64).
    # Its bound: the bytes (x, dt, B, C read, y written once) against the
    # chunked form's products at the bf16 tensor-core rate, per (b, h,
    # chunk of q steps): C B^T (q q n), M x (q q p), the chunk state
    # (n q p) and C S_in (q n p), two operations per multiply-add
    b, l, h, p, g, n, q = 2, 1024, 80, 64, 1, 64, 64
    a = ssd_inputs(torch, gen, b, l, h, p, g, n, 0.1, bf, dev)
    (ssd,) = ssd_work(dict(batch=b, len=l, heads=h, p=p, groups=g, n=n,
                           states=False), bf, chunk=q, dt_dtype=bf)
    ssd_bytes, ssd_flops = ssd.hbm, ssd.flops
    old_bound_ms, _ = _bound(ssd_bytes, 5 * b * l * h * n * p, "float32",
                             elementwise=True)
    row("ssd", "src/repro_torch/csrc/ssd.cu",
        "src/repro/kernels/ssd/kernel.py:108", [b, l, h, p, g, n],
        lambda: ssd_cuda(*a, chunk=256), lambda: ssd_ref(*a, chunk=256),
        None, nbytes=ssd_bytes, flops=ssd_flops,
        note=f"bound: bytes against the chunked form's {ssd_flops / 1e9:.2f}"
             f" GFLOP at the bf16 tensor-core rate; the recurrence's 5 N P "
             f"fp32 operations per (b, t, h) at the fp32 SIMT rate, the "
             f"bound stated before, give {old_bound_ms * 1e3:.1f} us")
    rows[-1]["faithful_max_abs_err"] = errs["ssd_faithful"]
    rows[-1]["faithful_tolerance"] = FAITHFUL_TOL
    # a long chain: 128 chunks of 64 on one (b, h) pair, where the state's
    # hand-over from chunk to chunk is all the kernel waits for
    b, l, h = 1, 8192, 1
    a = ssd_inputs(torch, gen, b, l, h, p, g, n, 0.1, bf, dev)
    extra(rows[-1], "chain128", [b, l, h, p, g, n],
          lambda: ssd_cuda(*a, chunk=64), lambda: ssd_ref(*a, chunk=64),
          None, **_work(ssd_work(dict(batch=b, len=l, heads=h, p=p,
                                      groups=g, n=n, states=False), bf,
                                 chunk=q, dt_dtype=bf)[0]))
    # serving's prefill: zamba2-2.7b's fixed batch (4 x 64, one chunk per
    # pair), without and with the final state ((B, H, N, P) fp32 written)
    b, l, h = FIXED["batch"], FIXED["prompt_len"], 80
    a = ssd_inputs(torch, gen, b, l, h, p, g, n, 0.1, bf, dev)
    for key, state in (("serve_prefill", False), ("serve_prefill_state", True)):
        extra(rows[-1], key, [b, l, h, p, g, n],
              lambda: ssd_cuda(*a, chunk=256, return_state=state),
              lambda: ssd_ref(*a, chunk=256, return_state=state), None,
              **_work(ssd_work(dict(batch=b, len=l, heads=h, p=p, groups=g,
                                    n=n, states=state), bf, chunk=q,
                               dt_dtype=bf)[0]))
    return rows


# --------------------------------------------------------------------------
# phase 6: where a decode step's time goes
# --------------------------------------------------------------------------

PROFILE_STEPS = 8
# the substring of each kernel's symbol in the profiler's names
KERNEL_SYMBOLS = {"selective_scan": "selective_scan_kernel",
                  "ssd": "ssd_", "rmsnorm": "rmsnorm_kernel",
                  "flash_attention": "flash_attention"}
# kernels per decode step of the fixed batch with the unsplit decode
# kernel: splitting the KV axis must not add launches
MAX_DECODE_LAUNCHES = 1099


def _profile_decode(torch, model, run, params, prompt, steps,
                    step_pair=None, extras=None):
    """Trace ``steps`` decode steps of the fixed batch with torch.profiler,
    after one decode step outside the window (the captured step's
    capture): the window's host time, the device's busy time and idle
    share (the profiler's own overhead makes the idle share a ceiling),
    kernels per step and the largest by device time.  ``step_pair`` is
    ``(prefill, decode)``, ``jitted_steps``' unless given; ``extras`` go
    with the prompt.  Returns (summary, [(kernel, device ms, calls)]
    sorted by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.train.serve_step import jitted_steps

    prefill, decode = step_pair or jitted_steps(model, run,
                                                cache_len=run.shape.seq_len)
    state, logits = prefill(params, {"tokens": prompt, **(extras or {})})
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    state, logits = decode(params, state, tok)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    traced = {}
    # one warm-up step before the window: the device tracing starts in
    # it, so the kernels that run before it is up (the first layers of a
    # replayed graph, queued at once) fall outside the window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1),
                 on_trace_ready=lambda p: traced.setdefault(
                     "events", p.key_averages())) as prof:
        for i in range(steps + 1):
            state, logits = decode(params, state, tok)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            if i == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            elif i == steps:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    # the schedule marks each step with a device-side "ProfilerStep#N"
    # range, which spans the step's kernels: not a kernel
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in traced["events"]
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    out = {"steps": steps, "window_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "launches_per_step": sum(c for _, _, c in kernels) / steps,
           "top": [{"kernel": k[:80], "ms_per_step": t / steps,
                    "share": t / busy_ms, "calls_per_step": c / steps}
                   for k, t, c in kernels[:12]]}
    return out, kernels


def phase_profile(torch, np, dev, ctx):
    """PROFILE_STEPS dense decode steps of llama3.2-1b's fixed batch under
    the profiler, with decode attention's and RMSNorm's time a step."""
    out, kernels = _profile_decode(torch, *ctx, PROFILE_STEPS)
    busy_ms, wall_ms = out["device_busy_ms"], out["window_ms"]
    out.update({
        "decode_attention_us_per_step": sum(
            t for k, t, _ in kernels if "decode_attention_kernel" in k)
        * 1e3 / PROFILE_STEPS,
        "rmsnorm_us_per_step": sum(
            t for k, t, _ in kernels if "rmsnorm_kernel" in k)
        * 1e3 / PROFILE_STEPS,
        "rmsnorm_calls_per_step": sum(
            c for k, _, c in kernels if "rmsnorm_kernel" in k)
        / PROFILE_STEPS})
    if busy_ms:
        log(f"decode step profile: {wall_ms / PROFILE_STEPS:.2f} ms/step "
            f"under the profiler, device busy {busy_ms / PROFILE_STEPS:.2f} "
            f"ms/step (idle share {out['idle_share']:.2f}), "
            f"{out['launches_per_step']:.0f} kernels/step")
        dec_us = out["decode_attention_us_per_step"]
        log(f"  decode attention {dec_us:.1f} us/step ("
            f"{dec_us * 1e-1 * PROFILE_STEPS / busy_ms:.1f}% of device busy)")
        log(f"  rmsnorm {out['rmsnorm_us_per_step']:.1f} us/step over "
            f"{out['rmsnorm_calls_per_step']:.0f} calls")
        check(out["launches_per_step"] <= MAX_DECODE_LAUNCHES,
              f"{out['launches_per_step']} kernels per decode step, more "
              f"than {MAX_DECODE_LAUNCHES}")
        for t in out["top"][:8]:
            log(f"  {t['ms_per_step'] * 1e3:8.1f} us/step "
                f"{t['share'] * 100:5.1f}%  x{t['calls_per_step']:.0f}  "
                f"{t['kernel']}")
    else:
        log("decode step profile: the profiler recorded no device time "
            "(not measured)")
    return out


def phase_profile_train(torch, np, dev, arch, family=None):
    """Trace one steady train step (after one warm-up step) of the
    training slice's ``arch`` (or, with ``family``, of phase 4i's cut of
    it) with torch.profiler: device busy share, time by kernel, and the
    share of the device time spent in the recompute backwards (the plain
    versions run under ``recompute_bwd.*`` ranges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_model_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    if family:
        cuts, batch, seq, _, _ = TRAIN_FAMILIES[arch]
        cfg = get_model_config(arch).replace(**cuts)
        wrapped = TRAIN_FAMILY_KERNELS
    else:
        cfg = get_model_config(arch).replace(num_layers=TRAIN[arch])
        batch, seq = TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"]
        wrapped = TRAIN_KERNELS[arch]
    run = make_run(cfg, seq=seq, batch=batch, steps=TRAIN_SHAPE["steps"])
    model = build_model(cfg, run.parallel, device=dev)
    opt = make_optimizer(run.train)
    step = make_train_step(model, run, opt)
    state = init_train_state(model, run, opt, seed=0,
                             params=_opened_init(torch, dev, cfg))
    data = make_data(cfg, run.shape, seed=0)
    state, _ = step(state, data.batch_at(0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, data.batch_at(1))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0]
    # a record_function range also appears on the device timeline, as the
    # span of its kernels: it is not a kernel, and counting it would count
    # its kernels twice
    ranges = [e for e in on_device
              if getattr(e, "is_user_annotation", False)
              or e.key.startswith("recompute_bwd.")]
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in on_device if e not in ranges]
    busy_ms = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    # the device span of each recompute range (kernels and the gaps
    # between them): an upper bound on their busy time
    recompute = {e.key: e.self_device_time_total / 1e3 for e in ranges
                 if e.key.startswith("recompute_bwd.")}
    ours = set(KERNEL_SYMBOLS.values())
    port_ms = sum(t for k, t, _ in kernels if any(o in k for o in ours))

    def by_name(sub):
        return (sum(t for k, t, _ in kernels if sub in k),
                sum(c for k, _, c in kernels if sub in k))
    out = {"arch": arch, "layers": cfg.num_layers, "window_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "kernels_launched": sum(c for _, _, c in kernels),
           "port_kernels_ms": port_ms,
           "ssd_kernel_ms": by_name("ssd_")[0],
           "ssd_calls": by_name("ssd_")[1],
           "rmsnorm_kernel_ms": by_name("rmsnorm_kernel")[0],
           "rmsnorm_calls": by_name("rmsnorm_kernel")[1],
           "scan_kernel_ms": by_name("selective_scan_kernel")[0],
           "scan_calls": by_name("selective_scan_kernel")[1],
           "recompute_bwd_ms": recompute,
           "recompute_share": (sum(recompute.values()) / busy_ms
                               if busy_ms and recompute else None),
           "top": [{"kernel": k[:80], "ms": t, "share": t / busy_ms,
                    "calls": c} for k, t, c in kernels[:12]]}
    if busy_ms:
        log(f"{arch} train step profile: {wall_ms:.1f} ms under the "
            f"profiler, device busy {busy_ms:.1f} ms (idle share "
            f"{out['idle_share']:.2f}), {out['kernels_launched']} kernels; "
            f"the port's kernels {port_ms:.1f} ms; recompute backwards "
            f"{ {k: round(v, 1) for k, v in recompute.items()} } ms "
            f"(share {out['recompute_share']})")
        log(f"  scan kernel {out['scan_kernel_ms']:.2f} ms over "
            f"{out['scan_calls']} calls; SSD kernel "
            f"{out['ssd_kernel_ms']:.2f} ms over {out['ssd_calls']} calls; "
            f"RMSNorm kernel {out['rmsnorm_kernel_ms']:.2f} ms over "
            f"{out['rmsnorm_calls']}")
        # a renamed kernel would drop out of the port's sum silently
        for name in wrapped:
            check(by_name(KERNEL_SYMBOLS[name])[1] > 0,
                  f"{arch} train step profile: no device time under "
                  f"{KERNEL_SYMBOLS[name]!r} for the {name} kernel")
        for t in out["top"][:8]:
            log(f"  {t['ms']:8.2f} ms {t['share'] * 100:5.1f}%  "
                f"x{t['calls']}  {t['kernel']}")
    else:
        log(f"{arch} train step profile: the profiler recorded no device "
            f"time (not measured)")
    del state
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------

def tensor_core_instructions(lib_path, kernel_substring):
    """HMMA instructions per kernel whose mangled name holds
    ``kernel_substring``, read from the library's SASS with the toolkit's
    ``cuobjdump``."""
    from repro_torch.kernels import cuda_lib

    cuobjdump = Path(cuda_lib.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = name if kernel_substring in name else None
            if current:
                counts[current] = 0
        elif current and "HMMA" in line:
            counts[current] += 1
    return counts


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test "
              "runs only on the GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    from repro_torch.analysis.kernels import instance_name, ptxas_usage
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    log(f"built {lib_path.name} from {len(cuda_lib.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    usage = ptxas_usage((lib_path.parent / "ptxas.log").read_text())
    scan = {}
    for fn, u in usage.items():
        regs, st, ld = u.registers, u.spill_stores, u.spill_loads
        m = re.search(r"selective_scan_kernelI(.*)Li(\d+)EE", fn)
        if m:
            io = {"ff": "f32", "f13__nv_bfloat16": "f32>bf16"}.get(
                m.group(1), "bf16")
            scan[f"{io} L{m.group(2)}"] = f"{regs}r/{st}+{ld}B"
        else:
            log(f"ptxas: {instance_name(fn) or fn[:90]}: {regs} registers, "
                f"spill {st} bytes stored, {ld} loaded, {u.smem} bytes of "
                f"static shared memory")
    log(f"ptxas, selective_scan_kernel (dtype, lanes: registers / spill "
        f"stores + loads): {scan}")
    hmma = tensor_core_instructions(lib_path, "flash_attention_mma_kernel")
    log(f"tensor-core instructions (HMMA) in the bf16 prefill kernels' "
        f"SASS: {hmma}")
    check(bool(hmma) and all(n > 0 for n in hmma.values()),
          "the bf16 prefill kernels have no HMMA instruction in their SASS")
    hmma_ssd = tensor_core_instructions(lib_path, "ssd_mma_kernel")
    log(f"tensor-core instructions (HMMA) in the bf16 SSD kernels' SASS: "
        f"{hmma_ssd}")
    check(bool(hmma_ssd) and all(n > 0 for n in hmma_ssd.values()),
          "the bf16 SSD kernels have no HMMA instruction in their SASS")

    # 3. kernels vs plain, and the wrapped ops' gradients
    t0 = time.perf_counter()
    errs, n_cases = phase_kernels(torch, dev)
    n_cases += phase_attention_edges(torch, dev)
    ssm_errs, n_ssm = phase_ssm_kernels(torch, dev)
    errs.update(ssm_errs)
    state_errs, n_state = phase_ssm_state_kernels(torch, dev)
    n_ssm += n_state
    for kernel, err in state_errs.items():
        errs[kernel] = max(errs[kernel], err)
    grad_errs = phase_grads(torch, dev)
    log(f"kernels vs plain: {n_cases + n_ssm} cases agree; max |err| at the "
        f"slices' shapes {errs}; gradients through the recompute wrapper "
        f"agree (max |err| / max |g|: {grad_errs}) "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4k. the dry run against the card, before the phases that keep
    # models and caches alive
    dryrun, dryrun_launches = phase_dryrun(torch, np, dev)

    # 4l. the static analysis against the card
    analysis_out, analysis_launches = phase_analysis(torch, dev, lib_path)

    # 4. the serving slice
    t0 = time.perf_counter()
    slice_out, launches, ctx, served = phase_slice(torch, np, dev)
    log(f"serving slice done in {time.perf_counter() - t0:.1f} s")

    # 4b. the training slice
    t0 = time.perf_counter()
    train_out = phase_train(torch, np, dev)
    log(f"training slice done in {time.perf_counter() - t0:.1f} s")

    # 4c. the sim-to-real loop, the GP's device and the serve CLI
    t0 = time.perf_counter()
    sim2real, sim2real_launches = phase_sim2real(torch, np, dev)
    sim2real["gp_timing"] = phase_gp_timing(torch, np, dev)
    sim2real["serve_cli"] = phase_serve_cli()
    sim2real["phase_s"] = time.perf_counter() - t0
    log(f"sim-to-real loop done in {sim2real['phase_s']:.1f} s")

    # 4d. kernel-launch tuning on the card, and its deployment
    t0 = time.perf_counter()
    tune_launch, tune_launch_launches = phase_tune_launch(torch, np, dev,
                                                          train_out)
    tune_launch["phase_s"] = time.perf_counter() - t0
    log(f"kernel-launch tuning done in {tune_launch['phase_s']:.1f} s")

    # 4e. SSM serving: falcon-mamba-7b and zamba2-2.7b at full width
    t0 = time.perf_counter()
    ssm_serve, ssm_serve_launches, compiled = phase_ssm_serve(torch, np,
                                                              dev)
    ssm_serve["phase_s"] = time.perf_counter() - t0
    log(f"SSM serving (with phase 4f's SSM part) done in "
        f"{ssm_serve['phase_s']:.1f} s")

    # 4f. the compiled decode step: llama3.2-1b (the SSM models' part ran
    # in 4e, on their weights) and the scratch-growth replay
    t0 = time.perf_counter()
    compiled = {ARCH: _compiled_decode(torch, np, dev, ARCH, *ctx, served),
                **compiled}
    compiled["scratch_growth"] = _scratch_growth(torch, np, *ctx)
    log(f"compiled decode (llama3.2-1b part) done in "
        f"{time.perf_counter() - t0:.1f} s")

    # 4g. the MoE family and the three carried dense configs
    t0 = time.perf_counter()
    moe_serve, moe_serve_launches = phase_moe_serve(torch, np, dev)
    moe_serve["phase_s"] = time.perf_counter() - t0
    log(f"[{CARD}] MoE and carried dense serving done in "
        f"{moe_serve['phase_s']:.1f} s")

    # 4h. the vlm and audio families at full depth
    t0 = time.perf_counter()
    vlm_audio, vlm_audio_launches = phase_vlm_audio_serve(torch, np, dev)
    vlm_audio["phase_s"] = time.perf_counter() - t0
    log(f"[{CARD}] vlm and audio serving done in "
        f"{vlm_audio['phase_s']:.1f} s")

    # 4i. training every family, the driver and the train CLI's resume
    t0 = time.perf_counter()
    train_families, train_families_launches = phase_train_families(torch, np,
                                                                   dev)
    train_families["phase_s"] = time.perf_counter() - t0
    log(f"[{CARD}] training every family done in "
        f"{train_families['phase_s']:.1f} s")

    # 4j. fleet replay, and the data-parallel train path
    t0 = time.perf_counter()
    fleet, fleet_launches, fleet_cameo_launches = phase_fleet(torch, np,
                                                              dev)
    fleet["phase_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    distributed, distributed_launches = phase_distributed(torch, np, dev)
    distributed["phase_s"] = time.perf_counter() - t1
    log(f"[{CARD}] fleet replay ({fleet['phase_s']:.1f} s) and the "
        f"data-parallel train path ({distributed['phase_s']:.1f} s) done")

    # 4m. the sharded train step: tp, fsdp and the expert placements
    t0 = time.perf_counter()
    sharded, sharded_launches = phase_sharded(torch, np, dev)
    sharded["phase_s"] = time.perf_counter() - t0
    log(f"[{CARD}] sharded train and serve steps done in "
        f"{sharded['phase_s']:.1f} s")

    by_path = {name: {"serve": launches.get(name, 0),
                      "train": sum(t["launches"][name]
                                   for t in train_out.values()),
                      "sim2real": sim2real_launches[name],
                      "tune_launch": tune_launch_launches[name],
                      "ssm_serve": ssm_serve_launches[name],
                      "moe_serve": moe_serve_launches[name],
                      "vlm_audio_serve": vlm_audio_launches[name],
                      "train_families": train_families_launches[name],
                      "fleet": fleet_launches[name],
                      "fleet_cameo": fleet_cameo_launches[name],
                      "distributed": distributed_launches[name],
                      "sharded": sharded_launches[name],
                      "dryrun": dryrun_launches[name],
                      "analysis": analysis_launches[name]}
               for name in cuda_lib.LAUNCHES}

    # 5. timings
    rows = phase_timings(torch, dev, errs, by_path,
                         train_out["falcon-mamba-7b"]["scan_launch"])
    torch.cuda.synchronize()

    # 6. where a decode step's and a train step's time goes
    slice_out["decode_profile"] = phase_profile(torch, np, dev, ctx)
    del ctx
    torch.cuda.empty_cache()
    for arch in TRAIN:
        train_out[arch]["step_profile"] = phase_profile_train(torch, np, dev,
                                                              arch)
    for arch in TRAIN_PROFILED:
        train_families[arch]["step_profile"] = phase_profile_train(
            torch, np, dev, arch, family=True)

    for line in ({"kernels": rows}, {"slice": slice_out},
                 {"train": train_out, "grad_check": grad_errs,
                  "grad_tolerance": GRAD_TOL}, {"sim2real": sim2real},
                 {"tune_launch": tune_launch}, {"ssm_serve": ssm_serve},
                 {"compiled_decode": compiled}, {"moe_serve": moe_serve},
                 {"vlm_audio_serve": vlm_audio},
                 {"train_families": train_families}, {"fleet": fleet},
                 {"distributed": distributed}, {"sharded": sharded},
                 {"dryrun": dryrun},
                 {"analysis": analysis_out}):
        print(json.dumps(_strict_json(line), allow_nan=False, default=str),
              flush=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
