"""Serving launcher: batched prefill + decode for an assigned architecture
— the fixed-batch path of :mod:`repro.launch.serve`, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 4 --prompt-len 64 --gen 32 [--full-config] [--device cpu]

The prompts are the reference's (the same seeded synthetic data).  The
``--workload``, ``--tune-*`` and ``--sim2real-eval`` paths of the reference
come with the tuner in a later slice.
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
