#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one Hopper GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an sm_90 card.  Phases:

1. device: the card's name and power limit; TF32 off for fp32 products
   and convolutions;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc``; print
   each kernel's registers and spills (``-Xptxas -v``);
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
   recompute backward) against autograd through its plain version;
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
5. timings: each kernel, its plain version and the one-call PyTorch
   yardstick where one exists, timed with CUDA events at the slices'
   shapes, beside the card's bound for the same work; RMSNorm also at the
   decode rows and both training shapes, prefill at a long prompt
   (1 x 2048) and at MLA's head dims (1 x 2048, 128 heads, 192 / 128),
   decode at 32 slots over 2048-row caches, the scan at the
   plan the falcon-mamba train step launched (its launch options recorded
   in phase 4b), with a sweep of channels a block and chunk and the SM
   clock sampled under load;
6. profiles: device time by kernel over a few decode steps of the fixed
   batch (no more launches per step than before the split decode; RMSNorm's
   time per step), and over one train step of each training model (with
   the share of the recompute backwards and the scan's, SSD's and
   RMSNorm's kernel time; each kernel of the step must show device time
   under its symbol), and the device's busy share.

Prints the kernel table, the serving, training and sim-to-real summaries
as JSON lines, and, as the last line, ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero without that line.  Without a CUDA card, or
outside a checkout, it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
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


GRAD_TOL = (2e-2, 2e-2)  # bf16 forward outputs feed the loss's gradient


def phase_grads(torch, dev):
    """Each autograd-wrapped op on CUDA tensors (kernel forward, recompute
    backward) against autograd through its plain version, bf16 inputs, on
    the loss sum(y^2): the gradients may differ only as far as the kernel's
    bf16 output differs from the plain one."""
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.kernels.flash_attention.ref import attention_blockwise_ref
    from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd.ref import ssd_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    cases = {
        "rmsnorm": ((_rand(torch, gen, (2, 64, 2560), bf, dev),
                     _rand(torch, gen, (2560,), bf, dev)),
                    lambda x, w: ops.rmsnorm(x, w),
                    lambda x, w: rmsnorm_ref(x, w)),
        "flash_attention": (
            tuple(_rand(torch, gen, (1, 128, 8, 80), bf, dev)
                  for _ in range(3)),
            lambda q, k, v: ops.flash_attention(q, k, v),
            lambda q, k, v: attention_blockwise_ref(q, k, v)),
        "selective_scan": (
            scan_inputs(torch, gen, 1, 100, 256, 16, 0.1, bf, dev),
            lambda *a: ops.selective_scan(*a, chunk=256),
            lambda *a: selective_scan_chunked_ref(*a, chunk=256)),
        "ssd": (ssd_inputs(torch, gen, 1, 100, 8, 64, 1, 64, 0.1, bf, dev),
                lambda *a: ops.ssd(*a, chunk=256),
                lambda *a: ssd_ref(*a, chunk=256)),
    }
    out = {}
    for name, (inputs, op, plain) in cases.items():
        grads = []
        for fn in (op, plain):
            xs = [t.detach().clone().requires_grad_() for t in inputs]
            cuda_lib.reset_launches()
            ops.reset_recomputes()
            (fn(*xs).float() ** 2).sum().backward()
            grads.append([t.grad.float() for t in xs])
            if fn is op:
                check(cuda_lib.LAUNCHES[name] == 1 and
                      ops.RECOMPUTES[name] == 1,
                      f"{name}: the wrapped op launched "
                      f"{cuda_lib.LAUNCHES[name]} kernels and ran "
                      f"{ops.RECOMPUTES[name]} recomputes (want 1 and 1)")
        worst = 0.0
        for i, (gk, gp) in enumerate(zip(*grads)):
            check(bool(torch.isfinite(gk).all()),
                  f"{name}: non-finite gradient of input {i}")
            err = (gk - gp).abs()
            scale = float(gp.abs().max())
            # a relative bound on the whole tensor: reductions (w, A, D)
            # sum many rounded products
            bad = err > GRAD_TOL[0] * scale + GRAD_TOL[1] * gp.abs()
            check(not bool(bad.any()),
                  f"{name}: gradient of input {i} off in {int(bad.sum())} "
                  f"elements, max |err| {float(err.max()):.3e} (max |g| "
                  f"{scale:.3e})")
            worst = max(worst, float(err.max()) / max(scale, 1e-30))
        out[name] = worst
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


def phase_slice(torch, np, dev):
    from repro_torch.configs.registry import get_model_config
    from repro_torch.kernels import cuda_lib, dispatch
    from repro_torch.launch.serve import make_prompt, serve_fixed_batch
    from repro_torch.models.model import build_model
    from repro_torch.serving.paging import PagedPlan
    from repro_torch.serving.scheduler import ContinuousBatcher
    from repro_torch.train.serve_step import jitted_steps
    from repro_torch.utils.config import MeshConfig, RunConfig, ShapeConfig

    cfg = get_model_config(ARCH)
    cache_len = FIXED["prompt_len"] + FIXED["gen"]
    run = RunConfig(model=cfg, shape=ShapeConfig("serve_cli", cache_len,
                                                 FIXED["batch"], "decode"),
                    mesh=MeshConfig(shape=(1,), axes=("data",)))
    t0 = time.perf_counter()
    model = build_model(cfg, run.parallel, device=dev)
    params = model.init(0)
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    log(f"{cfg.name}: {n_params / 1e9:.3f} B params, {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.dtype}; init "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = make_prompt(cfg, run.shape, FIXED["batch"], FIXED["prompt_len"],
                         dev)

    plans = {
        "dense": None,
        "paged": PagedPlan(paging=True, pool_pages=64, page_size=64,
                           pages_per_slot_max=8),
        "paged_chunked": PagedPlan(paging=True, pool_pages=64, page_size=64,
                                   pages_per_slot_max=8, prefill_chunk=64),
    }
    # warm-up outside the counted run: one short step pair per path
    serve_fixed_batch(model, run, params, prompt[:, :8], gen=2)
    torch.cuda.synchronize()

    # ---- the main path, counted -----------------------------------------
    cuda_lib.reset_launches()
    with dispatch.profile_dispatches() as prof:
        fixed = serve_fixed_batch(model, run, params, prompt,
                                  gen=FIXED["gen"], keep_logits=LOGIT_STEPS)
        served = {}
        for name, plan in plans.items():
            b = ContinuousBatcher(model, run, params, num_slots=4,
                                  cache_len=512, paged=plan)
            for req in _requests(cfg, np):
                b.submit(req)
            t1 = time.perf_counter()
            done = b.run_until_drained(max_ticks=2000)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            served[name] = {
                "completed": len(done), "ticks": b.ticks,
                "wall_s": wall, "prefill_s": b.prefill_s,
                "decode_s": b.decode_s,
                "tokens": sum(len(d.generated) for d in done),
                "order": [d.request.uid for d in done],
                "generated": [list(d.generated) for d in done],
                "prefill_chunks": b.prefill_chunks}
    launches = dict(cuda_lib.LAUNCHES)
    summary = prof.summary()
    log(f"main-path launches: {launches}")
    log(f"dispatch resolutions: { {k: v['resolutions'] for k, v in summary.items()} }")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    plain = [k for k in summary if k.endswith(f"[{dispatch.REF}]")]
    check(not plain, f"CUDA tensors resolved to plain versions: {plain}")

    n_req = len(_requests(cfg, np))
    for name, s in served.items():
        check(s["completed"] == n_req,
              f"{name} batcher completed {s['completed']} of {n_req}")
        log(f"batcher {name}: {s['completed']} completed, {s['ticks']} "
            f"ticks, {s['tokens']} tokens, wall {s['wall_s']:.3f} s "
            f"(prefill {s['prefill_s']:.3f} s, decode {s['decode_s']:.3f} s)")
    # paged decode runs the dense kernel's arithmetic on the same rows: the
    # three deployments generate the same tokens for every request, and
    # paging alone (no chunking) keeps the dense completion order
    def by_uid(s):
        return dict(zip(s["order"], s["generated"]))
    for name in ("paged", "paged_chunked"):
        check(by_uid(served[name]) == by_uid(served["dense"]),
              f"{name} batcher tokens differ from the dense batcher's")
    check(served["paged"]["order"] == served["dense"]["order"],
          "paged batcher completion order differs from the dense batcher's")

    # ---- the plain-version run with the same weights, teacher-forced ----
    prefill, decode = jitted_steps(model, run, cache_len=cache_len)
    toks = torch.as_tensor(fixed.tokens, device=dev)
    plain_logits = []
    with torch.no_grad(), dispatch.use_mode(dispatch.REF):
        state, lg = prefill(params, {"tokens": prompt})
        plain_logits.append(lg.float().cpu())
        for i in range(LOGIT_STEPS - 1):
            state, lg = decode(params, state, toks[:, i:i + 1])
            plain_logits.append(lg.float().cpu())
    worst = 0.0
    argmax_checked = 0
    for step, (kl, pl) in enumerate(zip(fixed.logits, plain_logits)):
        check(bool(torch.isfinite(kl).all()), f"step {step}: non-finite logits")
        check(kl.shape == (FIXED["batch"], cfg.vocab_size),
              f"step {step}: logits shape {tuple(kl.shape)}")
        err = (kl - pl).abs()
        worst = max(worst, float(err.max()))
        bad = err > LOGIT_ATOL + LOGIT_RTOL * pl.abs()
        check(not bool(bad.any()),
              f"step {step}: {int(bad.sum())} logits differ from the plain "
              f"run beyond {LOGIT_ATOL} + {LOGIT_RTOL}|x| (max |diff| "
              f"{float(err.max())})")
        top2 = pl.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]
                   > LOGIT_ATOL + LOGIT_RTOL * top2[:, 0].abs())
        argmax_checked += int(decided.sum())
        same = kl.argmax(-1) == pl.argmax(-1)
        check(bool(same[decided].all()),
              f"step {step}: argmax differs where the plain top-2 margin "
              f"exceeds the tolerance")
    scale = max(float(pl.abs().max()) for pl in plain_logits)
    log(f"logits vs plain run: max |diff| {worst:.4f} (tol {LOGIT_ATOL} + "
        f"{LOGIT_RTOL}|x|; max |logit| {scale:.1f}), argmax equal on "
        f"{argmax_checked} decided rows")

    lat = np.asarray(fixed.decode_s[1:]) * 1000
    fixed_out = {
        "batch": FIXED["batch"], "prompt_len": FIXED["prompt_len"],
        "gen": FIXED["gen"], "prefill_ms": fixed.prefill_s * 1000,
        "decode_p50_ms": float(np.percentile(lat, 50)),
        "decode_p99_ms": float(np.percentile(lat, 99)),
        "tok_s": float(FIXED["batch"] / np.mean(lat) * 1000),
        "logits_max_abs_diff": worst,
        "logits_tol": {"atol": LOGIT_ATOL, "rtol": LOGIT_RTOL},
        "logits_max_abs": scale}
    log(f"fixed batch {FIXED['batch']}x{FIXED['prompt_len']}+{FIXED['gen']}: "
        f"prefill {fixed_out['prefill_ms']:.2f} ms, decode p50 "
        f"{fixed_out['decode_p50_ms']:.2f} ms p99 "
        f"{fixed_out['decode_p99_ms']:.2f} ms, {fixed_out['tok_s']:.0f} tok/s")
    check(fixed.tokens.shape == (FIXED["batch"], FIXED["gen"]),
          f"fixed batch tokens shape {fixed.tokens.shape}")
    slice_out = {
        "arch": ARCH, "params": n_params, "dtype": cfg.dtype,
        "fixed_batch": fixed_out,
        "batcher": {k: {f: v[f] for f in ("completed", "ticks", "wall_s",
                                           "prefill_s", "decode_s", "tokens",
                                           "prefill_chunks")}
                    for k, v in served.items()},
        "launches": launches}
    return slice_out, launches, (model, run, params, prompt)


# Logits of the random-weight llama3.2-1b reach ~1.8e3 in magnitude, where
# one bf16 ulp is 8; the kernels and the plain versions round their outputs
# to bf16 at different points, and 16 layers carry that forward.  Allowed:
# 2 ulps relative (2^-7) plus 2.0 absolute for the small logits.
LOGIT_ATOL = 2.0
LOGIT_RTOL = 2.0 ** -7


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
        out[arch]["vs_plain"] = _compare_step(torch, np, dev, arch)
    return out


def _compare_step(torch, np, dev, arch):
    """One step with the kernels and the same step under
    ``dispatch.use_mode("ref")``, from the same weights on the same
    batch."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    cfg = get_model_config(arch).replace(num_layers=COMPARE_LAYERS[arch])
    run = make_run(cfg, seq=TRAIN_SHAPE["seq"], batch=TRAIN_SHAPE["batch"],
                   steps=TRAIN_SHAPE["steps"])
    model = build_model(cfg, run.parallel, device=dev)
    opt = make_optimizer(run.train)
    step = make_train_step(model, run, opt)
    batch = make_data(cfg, run.shape, seed=0).batch_at(0)
    results = {}
    init = None
    for mode in ("cuda", "ref"):
        state = init_train_state(model, run, opt, seed=0)
        if init is None:
            init = {k: v.detach().clone() for k, v in _flat(state.params)}
        with (dispatch.use_mode(dispatch.REF) if mode == "ref"
              else contextlib.nullcontext()):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        results[mode] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: (v - init[k]).float()
                          for k, v in _flat(state.params)})
        del state
        torch.cuda.empty_cache()
    (lk, gk, dk), (lr_, gr, dr) = results["cuda"], results["ref"]
    lr_step = float(m["lr"])
    flipped = sum(int(((dk[k] - dr[k]).abs() > lr_step / 2).sum())
                  for k in dk)
    n = sum(v.numel() for v in dk.values())
    rel_l2 = float(torch.sqrt(sum(((dk[k] - dr[k]) ** 2).sum() for k in dk))
                   / torch.sqrt(sum((dr[k] ** 2).sum() for k in dr)))
    out = {"layers": cfg.num_layers, "loss": lk, "loss_plain": lr_,
           "grad_norm": gk, "grad_norm_plain": gr,
           "flipped_share": flipped / n, "update_rel_l2": rel_l2,
           "lr": lr_step, "tolerance": STEP_TOL}
    log(f"{arch} step vs plain ({cfg.num_layers} layers): loss {lk:.5f} vs "
        f"{lr_:.5f}, grad norm {gk:.4f} vs {gr:.4f}, updates differing by "
        f"> lr/2: {flipped} of {n} ({flipped / n:.2e}), update rel. L2 "
        f"{rel_l2:.3e}")
    check(abs(lk - lr_) <= STEP_TOL["loss_rtol"] * abs(lr_),
          f"{arch}: loss {lk} vs plain {lr_}")
    check(abs(gk - gr) <= STEP_TOL["grad_norm_rtol"] * abs(gr),
          f"{arch}: grad norm {gk} vs plain {gr}")
    check(flipped / n <= STEP_TOL["flipped_share"],
          f"{arch}: {flipped} of {n} parameter updates differ by > lr/2")
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
        "tune_s": tune_s, "extras": res.extras}
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


def phase_serve_cli():
    """The serve launcher's trace path as a user runs it, in a process of
    its own: tune (4 measurements in the simulator), replay on the card,
    and print sim-predicted beside replayed-actual."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
           "--full-config", "--workload", SIM2REAL_SPEC, "--tune-serving",
           "4", "--sim2real-eval"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=str(ROOT), capture_output=True, text=True,
                         timeout=600,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    wall = time.perf_counter() - t0
    for line in res.stdout.splitlines():
        log(f"serve CLI | {line}")
    check(res.returncode == 0,
          f"serve CLI exited {res.returncode}: {res.stderr[-2000:]}")
    check("sim-predicted" in res.stdout and "replayed-actual" in res.stdout,
          "serve CLI: no sim-predicted / replayed-actual line")
    log(f"serve CLI: rc 0 in {wall:.1f} s")
    return {"cmd": " ".join(cmd[1:]), "wall_s": wall,
            "lines": [ln for ln in res.stdout.splitlines()
                      if ln.startswith("[serve]")]}


# --------------------------------------------------------------------------
# phase 5: timings
# --------------------------------------------------------------------------

SM_HZ = 1.98e9  # H100 SXM boost clock, for the spin kernel's length


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


SFU_EX2_PER_CLOCK_SM = 16  # CUDA C Programming Guide, compute capability 9.0


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
        nbytes=2 * n * es + 2048 * es, flops=4 * n, elementwise=True)
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
              nbytes=2 * ne * es + shape[-1] * es, flops=4 * ne,
              elementwise=True)

    # prefill attention at the fixed-batch prompt (causal, 4 x 64 tokens)
    b, s, hq, hkv, d = 4, 64, 32, 8, 64
    q = _rand(torch, gen, (b, s, hq, d), bf, dev)
    k = _rand(torch, gen, (b, s, hkv, d), bf, dev)
    v = _rand(torch, gen, (b, s, hkv, d), bf, dev)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = b * hq * s * (s + 1) // 2
    row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:142", [b, s, hq, hkv, d],
        lambda: flash_attention_cuda(q, k, v),
        lambda: attention_blockwise_ref(q, k, v, kv_block=64),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True),
        nbytes=(2 * q.numel() + k.numel() + v.numel()) * es,
        flops=4 * d * pairs)

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
    t_bound, t_by = _bound(4 * tq.numel() * es,
                           4 * 80 * 2 * 32 * 1024 * 1025 // 2, "bfloat16")
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
          nbytes=(2 * lq.numel() + lk.numel() + lv.numel()) * es,
          flops=4 * d * hq * s * (s + 1) // 2)
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
          nbytes=(mq.numel() + mk.numel() + 2 * mv.numel()) * es,
          flops=2 * (mla[3] + mla[4]) * mla[2] * mla[1] * (mla[1] + 1) // 2)
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
    valid = sum(lens)
    kv_bytes = 2 * valid * hkv * d * es
    dec_bytes = 2 * q.numel() * es + kv_bytes + 4 * b
    dec_flops = 4 * d * hq * valid
    row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:263",
        [b, skv, hq, hkv, d],
        lambda: decode_attention_cuda(q, kc, vc, ln),
        lambda: decode_attention_ref(q, kc, vc, ln),
        lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kvt, vvt, attn_mask=mask, enable_gqa=True),
        nbytes=dec_bytes, flops=dec_flops)

    ps, n_pages = 64, 8
    kp = torch.cat([kc.reshape(b * n_pages, ps, hkv, d),
                    torch.zeros((1, ps, hkv, d), dtype=bf, device=dev)])
    vp = torch.cat([vc.reshape(b * n_pages, ps, hkv, d),
                    torch.zeros((1, ps, hkv, d), dtype=bf, device=dev)])
    table = torch.arange(b * n_pages, dtype=torch.int32,
                         device=dev).reshape(b, n_pages)
    used_pages = sum(-(-n_ // ps) for n_ in lens)
    row("paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention/kernel.py:126",
        [b, n_pages, ps, hq, hkv, d],
        lambda: paged_decode_attention_cuda(q, kp, vp, table, ln),
        lambda: paged_decode_attention_ref(q, kp, vp, table, ln),
        None, nbytes=dec_bytes + 4 * used_pages, flops=dec_flops)

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
    valid = int(lens.sum())
    dec_bytes = 2 * q.numel() * es + 2 * valid * hkv * d * es + 4 * b
    dec_flops = 4 * d * hq * valid
    extra(rows[-2], "batch32", [b, skv, hq, hkv, d],
          lambda: decode_attention_cuda(q, kc, vc, lens),
          lambda: decode_attention_ref(q, kc, vc, lens),
          lambda: F.scaled_dot_product_attention(
              q.transpose(1, 2), kvt, vvt, attn_mask=mask, enable_gqa=True),
          nbytes=dec_bytes, flops=dec_flops)
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
    used_pages = int(((lens + ps - 1) // ps).sum())
    extra(rows[-1], "batch32", [b, n_pages, ps, hq, hkv, d],
          lambda: paged_decode_attention_cuda(q, kp, vp, table, lens),
          lambda: paged_decode_attention_ref(q, kp, vp, table, lens), None,
          nbytes=dec_bytes + 4 * used_pages, flops=dec_flops)

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
        nbytes=3 * b * l * c * es + 2 * b * l * n * es + 4 * c * n + 4 * c,
        flops=7 * b * l * c * n, elementwise=True,
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
    floor_us = b * l * c * n / (SFU_EX2_PER_CLOCK_SM * cuda_lib.sm_count(dev)
                                * max_mhz * 1e6) * 1e6
    rows[-1]["note"] += f" = {floor_us:.1f} us at {max_mhz:.0f} MHz"
    log(f"selective_scan: the exponentials alone need {floor_us:.1f} us on "
        f"the special-function units at {max_mhz:.0f} MHz")
    rows[-1]["sweep_ms"] = _scan_sweep(torch, a, flush, (8, 16, 32, 64),
                                       (32, 64))

    # the Mamba-2 SSD at zamba2-2.7b's training shape (chunk 256 -> 64).
    # Its bound: the bytes (x, dt, B, C read, y written once) against the
    # chunked form's products at the bf16 tensor-core rate, per (b, h,
    # chunk of q steps): C B^T (q q n), M x (q q p), the chunk state
    # (n q p) and C S_in (q n p), two operations per multiply-add
    b, l, h, p, g, n, q = 2, 1024, 80, 64, 1, 64, 64
    a = ssd_inputs(torch, gen, b, l, h, p, g, n, 0.1, bf, dev)
    ssd_bytes = (2 * b * l * h * p + b * l * h + 2 * b * l * g * n) * es \
        + 8 * h
    ssd_flops = b * h * (l // q) * 2 * q * (q * n + q * p + 2 * n * p)
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
          None, nbytes=(2 * b * l * h * p + b * l * h + 2 * b * l * g * n)
          * es + 8 * h,
          flops=b * h * (l // q) * 2 * q * (q * n + q * p + 2 * n * p))
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


def phase_profile(torch, np, dev, ctx):
    """Trace PROFILE_STEPS dense decode steps of the fixed batch with
    torch.profiler: device time by kernel and the device's busy share of
    the window (the profiler's own overhead makes the share a floor)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.serve_step import jitted_steps

    model, run, params, prompt = ctx
    prefill, decode = jitted_steps(model, run, cache_len=run.shape.seq_len)
    state, logits = prefill(params, {"tokens": prompt})
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            state, logits = decode(params, state, tok)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(t for _, t, _ in kernels)
    kernels.sort(key=lambda k: -k[1])
    out = {"steps": PROFILE_STEPS, "window_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "idle_share": (1.0 - busy_ms / wall_ms) if busy_ms else None,
           "launches_per_step": sum(c for _, _, c in kernels) / PROFILE_STEPS,
           "decode_attention_us_per_step": sum(
               t for k, t, _ in kernels if "decode_attention_kernel" in k)
           * 1e3 / PROFILE_STEPS,
           "rmsnorm_us_per_step": sum(
               t for k, t, _ in kernels if "rmsnorm_kernel" in k)
           * 1e3 / PROFILE_STEPS,
           "rmsnorm_calls_per_step": sum(
               c for k, _, c in kernels if "rmsnorm_kernel" in k)
           / PROFILE_STEPS,
           "top": [{"kernel": k[:80], "ms_per_step": t / PROFILE_STEPS,
                    "share": t / busy_ms, "calls_per_step": c / PROFILE_STEPS}
                   for k, t, c in kernels[:12]]}
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


def phase_profile_train(torch, np, dev, arch):
    """Trace one steady train step (after one warm-up step) of the
    training slice's ``arch`` with torch.profiler: device busy share, time
    by kernel, and the share of the device time spent in the recompute
    backwards (the plain versions run under ``recompute_bwd.*`` ranges)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_model_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)

    cfg = get_model_config(arch).replace(num_layers=TRAIN[arch])
    run = make_run(cfg, seq=TRAIN_SHAPE["seq"], batch=TRAIN_SHAPE["batch"],
                   steps=TRAIN_SHAPE["steps"])
    model = build_model(cfg, run.parallel, device=dev)
    opt = make_optimizer(run.train)
    step = make_train_step(model, run, opt)
    state = init_train_state(model, run, opt, seed=0)
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
        for name in TRAIN_KERNELS[arch]:
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

def ptxas_usage(text):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from ``nvcc -Xptxas -v`` output."""
    usage, fn, spill = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn] = (int(m.group(1)),) + spill
            fn = None
    return usage


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"device {name}, capability {torch.cuda.get_device_capability(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    from repro_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    lib_path = cuda_lib.build()
    cuda_lib.library()
    log(f"built {lib_path.name} from {len(cuda_lib.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    usage = ptxas_usage((lib_path.parent / "ptxas.log").read_text())
    scan = {}
    for fn, (regs, st, ld) in usage.items():
        m = re.search(r"selective_scan_kernelI(.*)Li(\d+)EE", fn)
        if m:
            io = {"ff": "f32", "f13__nv_bfloat16": "f32>bf16"}.get(
                m.group(1), "bf16")
            scan[f"{io} L{m.group(2)}"] = f"{regs}r/{st}+{ld}B"
        else:
            log(f"ptxas: {fn[:90]}: {regs} registers, spill {st} bytes "
                f"stored, {ld} loaded")
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
    grad_errs = phase_grads(torch, dev)
    log(f"kernels vs plain: {n_cases + n_ssm} cases agree; max |err| at the "
        f"slices' shapes {errs}; gradients through the recompute wrapper "
        f"agree (max |err| / max |g|: {grad_errs}) "
        f"({time.perf_counter() - t0:.1f} s)")

    # 4. the serving slice
    t0 = time.perf_counter()
    slice_out, launches, ctx = phase_slice(torch, np, dev)
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
    by_path = {name: {"serve": launches.get(name, 0),
                      "train": sum(t["launches"][name]
                                   for t in train_out.values()),
                      "sim2real": sim2real_launches[name]}
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

    for line in ({"kernels": rows}, {"slice": slice_out},
                 {"train": train_out, "grad_check": grad_errs,
                  "grad_tolerance": GRAD_TOL}, {"sim2real": sim2real}):
        print(json.dumps(_strict_json(line), allow_nan=False, default=str),
              flush=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
