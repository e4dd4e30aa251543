"""Serving launcher: batched prefill + decode for an assigned architecture
— the port of :mod:`repro.launch.serve`, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 64 --gen 32 [--full-config] [--device cpu]

The prompts are the reference's (the same seeded synthetic data).

``--workload <spec>`` switches to trace-driven continuous batching: a
seeded request trace (``repro_torch.workloads`` grammar, e.g.
``bursty:rate=2000``) is replayed through the port's ``ContinuousBatcher``.
With ``--tune-serving N`` the full serving stack — scheduler knobs AND
kernel launch geometry — is transfer-tuned against that trace in the
workload simulator first, and the winning plan + launch config drive the
batcher.  ``--sim2real-eval`` additionally prices the deployed plan in the
simulator and prints sim-predicted vs replayed-actual:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --full-config --workload "poisson:rate=1500,horizon=0.01" \
        --tune-serving 4 --sim2real-eval

Kernel-launch tuning (the reference's ``--tune-launch`` and
``--measure-backend``) comes with the kernel-launch slice.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import (get_model_config, get_smoke_config,
                                          list_archs)
from repro_torch.data.pipeline import make_data
from repro_torch.launch.tune import tune_serving_config
from repro_torch.models.model import build_model
from repro_torch.obs import trace as obs_trace
from repro_torch.train.serve_step import jitted_steps, sample_token
from repro_torch.utils.config import MeshConfig, RunConfig, ShapeConfig
from repro_torch.utils.device import synchronize


@dataclass
class FixedBatchResult:
    """What one fixed-batch serve run produced and how long it took."""
    tokens: np.ndarray            # (B, gen) generated token ids
    prefill_s: float              # host wall time of the prefill step
    decode_s: List[float]         # host wall time of each decode step
    logits: List[torch.Tensor] = field(default_factory=list)  # kept steps


def serve_fixed_batch(model, run: RunConfig, params, prompt: torch.Tensor, *,
                      gen: int, temperature: float = 0.0,
                      keep_logits: int = 0) -> FixedBatchResult:
    """Prefill ``prompt`` (B, S), then decode ``gen - 1`` steps.  Each step
    is timed on the host around a device synchronize.  The last-position
    logits of prefill and of the first ``keep_logits - 1`` decode steps
    are kept (on the host) for comparison."""
    cache_len = prompt.shape[1] + gen
    prefill, decode = jitted_steps(model, run, cache_len=cache_len)
    gen_rng = torch.Generator(device=prompt.device).manual_seed(1)
    kept: List[torch.Tensor] = []
    # repro: ignore[wall-clock] -- serve-CLI step latency, as the reference's serve CLI reports it
    t0 = time.perf_counter()
    state, logits = prefill(params, {"tokens": prompt})
    synchronize(prompt.device)
    # repro: ignore[wall-clock] -- serve-CLI step latency, as the reference's serve CLI reports it
    prefill_s = time.perf_counter() - t0
    if keep_logits > 0:
        kept.append(logits.float().cpu())
    tok = sample_token(logits, gen_rng, temperature)
    outs = [tok]
    lats = []
    for i in range(gen - 1):
        # repro: ignore[wall-clock] -- serve-CLI step latency, as the reference's serve CLI reports it
        t1 = time.perf_counter()
        state, logits = decode(params, state, tok[:, None])
        synchronize(prompt.device)
        # repro: ignore[wall-clock] -- serve-CLI step latency, as the reference's serve CLI reports it
        lats.append(time.perf_counter() - t1)
        if len(kept) < keep_logits:
            kept.append(logits.float().cpu())
        tok = sample_token(logits, gen_rng, temperature)
        outs.append(tok)
    tokens = torch.stack(outs, dim=1).cpu().numpy()
    return FixedBatchResult(tokens, prefill_s, lats, kept)


def serve_workload(model, run, params, workload_spec: str, *,
                   tune_budget: int = 0, seed: int = 0,
                   ticks_per_s=None, method: str = "cameo",
                   query_batch: int = 1, sim2real_eval: bool = False):
    """Trace-driven serving: generate the trace, optionally transfer-tune
    the serving stack against it in the simulator, then replay it through
    the port's ``ContinuousBatcher`` under the tuned plan, on the model's
    device.  Returns ``(plan, launch_config, replay_report)`` so callers
    (and tests) can audit exactly what was deployed.  ``sim2real_eval``
    additionally prices the deployed configuration in the simulator and
    prints sim-predicted vs replayed-actual."""
    from repro_torch.launch.tune import predicted_serving_report
    from repro_torch.serving.replay import replay_trace
    from repro_torch.serving.scheduler import ContinuousBatcher, DrainStall
    from repro_torch.workloads import ServingPlan, make_workload

    workload = make_workload(workload_spec)
    trace = workload.generate(seed)
    print(f"[serve] workload {workload.spec}: {len(trace)} requests, "
          f"max context {trace.max_context}, "
          f"~{trace.mean_rate():.0f} req/s modeled")

    launch_config = None
    best_config = None
    plan = ServingPlan()
    if tune_budget > 0:
        result = tune_serving_config(model.cfg, workload_spec, tune_budget,
                                     method=method, query_batch=query_batch,
                                     seed=seed)
        best_config = result.best_config or {}
        plan = ServingPlan.from_config(best_config)
        launch_config = result.launch_config
    batcher = ContinuousBatcher(model, run, params,
                                num_slots=plan.num_slots,
                                cache_len=plan.cache_len,
                                interleave=plan.interleave,
                                launch_config=launch_config)
    report = replay_trace(batcher, trace, admit_chunk=plan.admit_chunk,
                          ticks_per_s=ticks_per_s, seed=seed)
    print(f"[serve] replay: {report.completed} completed "
          f"({report.rejected} rejected), {report.ticks} ticks, "
          f"{report.tokens} tokens in {report.wall_s:.2f}s wall, "
          f"occupancy {report.mean_occupancy:.2f}, "
          f"latency p50={report.p50_latency_ms:.1f} ms "
          f"p99={report.p99_latency_ms:.1f} ms")
    if sim2real_eval:
        try:
            pred = predicted_serving_report(model.cfg, trace, best_config)
        except DrainStall as e:
            # the replay above already drained — a simulator that cannot is
            # itself a sim-to-real finding, not a crash
            print(f"[serve] sim2real: simulator stalled pricing the "
                  f"deployed plan ({e}) while the replay drained — a "
                  f"fidelity gap worth investigating")
            return plan, launch_config, report
        if not pred.feasible:
            print(f"[serve] sim2real: simulator calls the deployed plan "
                  f"infeasible ({pred.reason}) — the replay measured it "
                  f"anyway, a fidelity gap worth investigating")
        else:
            print(f"[serve] sim2real: sim-predicted p99="
                  f"{pred.p99_latency_us:.0f} us modeled, occupancy "
                  f"{pred.occupancy_mean:.2f}, queue depth "
                  f"{pred.queue_depth_mean:.2f} | replayed-actual p99="
                  f"{report.p99_latency_ms:.1f} ms wall, occupancy "
                  f"{report.mean_occupancy:.2f}, queue depth "
                  f"{report.queue_depth_mean:.2f}")
    return plan, launch_config, report


def make_prompt(cfg, shape: ShapeConfig, batch: int, prompt_len: int,
                device) -> torch.Tensor:
    """The reference CLI's prompts: the first batch of the data seeded for
    the run's shape (whose sequence length is prompt + generation)."""
    raw = make_data(cfg, shape, seed=0).batch_at(0)
    return torch.as_tensor(raw["inputs"][:batch, :prompt_len],
                           device=device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--workload", default=None, metavar="SPEC",
                    help="request-trace spec (repro_torch.workloads grammar, "
                         "e.g. 'bursty:rate=2000'): replay it through the "
                         "continuous batcher instead of a fixed batch")
    ap.add_argument("--tune-serving", type=int, default=0, metavar="BUDGET",
                    help="with --workload: intervention budget for a "
                         "serving-stack tuning run in the workload simulator "
                         "(0 = serve with the default plan)")
    ap.add_argument("--query-batch", type=int, default=1, metavar="K",
                    help="measurements per ask/tell tuning round for "
                         "--tune-serving (1 = sequential)")
    ap.add_argument("--sim2real-eval", action="store_true",
                    help="with --workload: after the replay, price the "
                         "deployed configuration in the simulator too and "
                         "report sim-predicted vs replayed-actual")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export a Chrome trace-event JSON of the run")
    args = ap.parse_args(argv)

    if args.trace_out:
        with obs_trace.trace_to(args.trace_out):
            rc = _run(args)
        print(f"[serve] trace written to {args.trace_out}")
        return rc
    return _run(args)


def _run(args) -> int:
    cfg = (get_model_config(args.arch) if args.full_config
           else get_smoke_config(args.arch))
    cache_len = args.prompt_len + args.gen
    run = RunConfig(model=cfg,
                    shape=ShapeConfig("serve_cli", cache_len, args.batch,
                                      "decode"),
                    mesh=MeshConfig(shape=(1,), axes=("data",)))
    model = build_model(cfg, run.parallel, device=args.device)
    params = model.init(0)
    print(f"[serve] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"batch={args.batch}, device={model.device}")
    if args.workload:
        serve_workload(model, run, params, args.workload,
                       tune_budget=args.tune_serving,
                       query_batch=args.query_batch,
                       sim2real_eval=args.sim2real_eval)
        return 0
    prompt = make_prompt(cfg, run.shape, args.batch, args.prompt_len,
                         model.device)
    res = serve_fixed_batch(model, run, params, prompt, gen=args.gen,
                            temperature=args.temperature)
    print(f"[serve] prefill {args.batch}x{args.prompt_len}: "
          f"{res.prefill_s * 1000:.1f} ms")
    if len(res.decode_s) > 1:
        lat = np.asarray(res.decode_s[1:]) * 1000
        print(f"[serve] decode p50={np.percentile(lat, 50):.2f} ms "
              f"p99={np.percentile(lat, 99):.2f} ms "
              f"({args.batch / np.mean(lat) * 1000:.0f} tok/s)")
    print("[serve] sample:", res.tokens[0][:16])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
