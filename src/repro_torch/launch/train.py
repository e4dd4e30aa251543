"""Training launcher — the port of :mod:`repro.launch.train`, on the GPU by
default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \
        --steps 3 [--seq 128] [--batch 8] [--full-config] [--device cpu]

Without ``--full-config`` it trains the architecture's smoke config, as the
reference's CLI does; :func:`train` takes any config (``chip_smoke.py``
trains full-width configs with their depth cut).  The data and the
training config are the reference's:
``make_data(cfg, shape, seed=0)`` and ``TrainConfig(lr=1e-3,
warmup_steps=10)``.  The steps run in a plain loop that prints the loss,
the gradient norm and the step time.  The reference's fault-tolerant
driver, checkpointing and metrics logger come in a later slice.

``--tune-launch N`` closes the CAMEO loop before training (mirroring
serve): a transfer-tuning run (analytic source, ``--measure-backend``
target) over the kernel-launch space picks block sizes / chunk lengths for
this training shape, and the winning configuration is handed to the train
step (``train(..., launch_config=...)``).
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.configs.registry import (get_model_config, get_smoke_config,
                                          list_archs)
from repro_torch.data.pipeline import make_data
from repro_torch.launch.tune import measure_backend_arg, tune_launch_config
from repro_torch.models.model import build_model
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.config import (MeshConfig, ModelConfig, ParallelConfig,
                                      RunConfig, ShapeConfig, TrainConfig)
from repro_torch.utils.device import DeviceLike, synchronize


@dataclass
class TrainResult:
    """What a training run produced and how long each step took."""
    run: RunConfig
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)  # host wall, synced
    state: object = None


def make_run(cfg: ModelConfig, *, seq: int, batch: int,
             steps: int) -> RunConfig:
    """The reference CLI's run: one data shard, ``ParallelConfig()`` and
    ``TrainConfig(lr=1e-3, warmup_steps=10, total_steps=steps)``."""
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("train_cli", seq, batch, "train"),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        parallel=ParallelConfig(),
        train=TrainConfig(lr=1e-3, warmup_steps=10, total_steps=steps))


def train(cfg: ModelConfig, *, steps: int, seq: int, batch: int,
          device: DeviceLike = None, seed: int = 0,
          log: Optional[Callable] = None,
          launch_config: Optional[Dict[str, Any]] = None) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps on the reference's synthetic data
    (seed 0), parameters drawn from ``seed``, the step built with
    ``launch_config`` (a tuned ``family.param`` config).  Each step is
    timed on the host around a device synchronize."""
    run = make_run(cfg, seq=seq, batch=batch, steps=steps)
    run.validate()
    model = build_model(cfg, run.parallel, device=device)
    optimizer = make_optimizer(run.train)
    step_fn = make_train_step(model, run, optimizer,
                              launch_config=launch_config)
    state = init_train_state(model, run, optimizer, seed=seed)
    data = make_data(cfg, run.shape, seed=0)
    out = TrainResult(run)
    for i in range(steps):
        batch_np = data.batch_at(i)
        # repro: ignore[wall-clock] -- train-CLI step time, as the reference's driver logs it
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch_np)
        synchronize(model.device)
        # repro: ignore[wall-clock] -- train-CLI step time, as the reference's driver logs it
        out.step_s.append(time.perf_counter() - t0)
        out.losses.append(float(metrics["loss"]))
        out.grad_norms.append(float(metrics["grad_norm"]))
        if log is not None:
            log(i, metrics, out.step_s[-1])
    out.state = state
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full-config", action="store_true",
                    help="the full (not smoke) architecture config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions)")
    ap.add_argument("--tune-launch", type=int, default=0, metavar="BUDGET",
                    help="intervention budget for a kernel-launch tuning run "
                         "before training (0 = train with registry defaults)")
    ap.add_argument("--measure-backend", type=measure_backend_arg,
                    default=None,
                    help="target measurement backend for --tune-launch: "
                         "analytic, wallclock, or shifted:<kind> "
                         "(default: REPRO_MEASURE_BACKEND, then analytic)")
    ap.add_argument("--query-batch", type=int, default=1, metavar="K",
                    help="measurements per ask/tell tuning round for "
                         "--tune-launch (1 = sequential)")
    args = ap.parse_args(argv)

    cfg = (get_model_config(args.arch) if args.full_config
           else get_smoke_config(args.arch))
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, batch {args.batch} x seq {args.seq}")

    def log(i: int, metrics: Dict, step_s: float) -> None:
        print(f"[train] step {i}: loss {float(metrics['loss']):.4f} "
              f"grad_norm {float(metrics['grad_norm']):.4f} "
              f"lr {metrics['lr']:.2e} {step_s * 1000:.1f} ms")

    launch_config = None
    if args.tune_launch > 0:
        launch_config = tune_launch_config(cfg, args.batch, args.seq,
                                           args.tune_launch,
                                           args.measure_backend, kind="train",
                                           query_batch=args.query_batch,
                                           device=args.device)
    res = train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
                device=args.device, log=log, launch_config=launch_config)
    if not all(map(math.isfinite, res.losses)):
        print("[train] non-finite loss")
        return 1
    print(f"[train] finished at step {res.state.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
