#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one Hopper GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an sm_90 card.  Phases:

1. device: the card's name and power limit; TF32 off for fp32 products;
2. build: compile the CUDA kernels from ``src/repro_torch/csrc``;
3. kernels vs plain: every kernel against its plain PyTorch version on the
   card, fp32 and bf16, at the slice's shapes and at edge shapes; paged
   decode against dense decode on the same rows (bit for bit);
4. slice: llama3.2-1b at full width and depth (bf16, seeded random
   weights) through the fixed-batch serve path and through the continuous
   batcher (dense, paged, paged with chunked prefill), with every launch
   counter set to 0 before and read after; prefill and decode logits
   against a plain-version run with the same weights;
5. timings: each kernel, its plain version and the one-call PyTorch
   yardstick, timed with CUDA events at the slice's shapes, beside the
   card's bound for the same work;
6. profile: device time by kernel over a few decode steps of the fixed
   batch, and the device's busy share.

Prints the kernel table and the slice summary as JSON lines, and, as the
last line, ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero without that line.  Without a CUDA card, or outside a checkout,
it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
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
FIXED = dict(batch=4, prompt_len=64, gen=32)
LOGIT_STEPS = 5  # prefill + the first 4 decode steps


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _rand(torch, gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _compare(torch, name, out, ref, dtype_name, errs, main):
    atol, rtol = TOL[dtype_name]
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
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {k: [] for k in ("rmsnorm", "flash_attention", "decode_attention",
                            "paged_decode_attention")}
    n_cases = 0
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        # -- rmsnorm: prefill rows, decode rows, batcher prompt, edges
        for shape, res, main in (((4, 64, 2048), False, True),
                                 ((4, 1, 2048), False, True),
                                 ((1, 200, 2048), False, True),
                                 ((4, 64, 2048), True, False),
                                 ((3, 17, 64), True, False),
                                 ((5, 100), False, False)):
            x = _rand(torch, gen, shape, dt, dev)
            w = _rand(torch, gen, shape[-1:], dt, dev)
            r = _rand(torch, gen, shape, dt, dev) if res else None
            for rb in ((1, 4, 8) if main else (4,)):
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
                (1, 70, 70, 4, 4, 128, {}, False)):
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
    return {k: max(v) for k, v in errs.items()}, n_cases


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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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


def phase_timings(torch, dev, errs, launches):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        decode_attention_cuda, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        attention_blockwise_ref, decode_attention_ref)
    from repro_torch.kernels.paged_attention.kernel import (
        paged_decode_attention_cuda)
    from repro_torch.kernels.paged_attention.ref import (
        paged_decode_attention_ref)
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    es = 2
    rows = []

    l2 = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > 50 MB L2

    def flush():
        l2.zero_()

    def row(name, source, replaces, shape, kernel, plain, library, nbytes,
            flops, elementwise=False):
        ms = _time_ms(torch, kernel, flush)
        plain_ms = _time_ms(torch, plain, flush)
        lib_ms = (_time_ms(torch, library, flush) if library is not None
                  else None)
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16", elementwise)
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "dtype": "bfloat16",
            "launches": launches[name], "max_abs_err": errs[name],
            "tolerance": {"float32": TOL["float32"],
                          "bfloat16": TOL["bfloat16"]},
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by})
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
    return rows


# --------------------------------------------------------------------------
# phase 6: where a decode step's time goes
# --------------------------------------------------------------------------

PROFILE_STEPS = 8


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
           "top": [{"kernel": k[:80], "ms_per_step": t / PROFILE_STEPS,
                    "share": t / busy_ms, "calls_per_step": c / PROFILE_STEPS}
                   for k, t, c in kernels[:12]]}
    if busy_ms:
        log(f"decode step profile: {wall_ms / PROFILE_STEPS:.2f} ms/step "
            f"under the profiler, device busy {busy_ms / PROFILE_STEPS:.2f} "
            f"ms/step (idle share {out['idle_share']:.2f}), "
            f"{out['launches_per_step']:.0f} kernels/step")
        for t in out["top"][:8]:
            log(f"  {t['ms_per_step'] * 1e3:8.1f} us/step "
                f"{t['share'] * 100:5.1f}%  x{t['calls_per_step']:.0f}  "
                f"{t['kernel']}")
    else:
        log("decode step profile: the profiler recorded no device time "
            "(not measured)")
    return out


# --------------------------------------------------------------------------

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
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            log(f"ptxas: {line.strip()}")

    # 3. kernels vs plain
    t0 = time.perf_counter()
    errs, n_cases = phase_kernels(torch, dev)
    log(f"kernels vs plain: {n_cases} cases agree; max |err| at the slice's "
        f"shapes {errs} ({time.perf_counter() - t0:.1f} s)")

    # 4. the slice
    t0 = time.perf_counter()
    slice_out, launches, ctx = phase_slice(torch, np, dev)
    log(f"slice done in {time.perf_counter() - t0:.1f} s")

    # 5. timings
    rows = phase_timings(torch, dev, errs, launches)
    torch.cuda.synchronize()

    # 6. where a decode step's time goes
    slice_out["decode_profile"] = phase_profile(torch, np, dev, ctx)

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"slice": slice_out}), flush=True)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
