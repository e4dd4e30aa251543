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
driver, checkpointing, metrics logger and ``--tune-launch`` come in a
later slice.
"""

from __future__ import annotations

import argparse
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.configs.registry import (get_model_config, get_smoke_config,
                                          list_archs)
from repro_torch.data.pipeline import make_data
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
          log: Optional[Callable] = None) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps on the reference's synthetic data
    (seed 0), parameters drawn from ``seed``.  Each step is timed on the
    host around a device synchronize."""
    run = make_run(cfg, seq=seq, batch=batch, steps=steps)
    run.validate()
    model = build_model(cfg, run.parallel, device=device)
    optimizer = make_optimizer(run.train)
    step_fn = make_train_step(model, run, optimizer)
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
    args = ap.parse_args(argv)

    cfg = (get_model_config(args.arch) if args.full_config
           else get_smoke_config(args.arch))
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, batch {args.batch} x seq {args.seq}")

    def log(i: int, metrics: Dict, step_s: float) -> None:
        print(f"[train] step {i}: loss {float(metrics['loss']):.4f} "
              f"grad_norm {float(metrics['grad_norm']):.4f} "
              f"lr {metrics['lr']:.2e} {step_s * 1000:.1f} ms")

    res = train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
                device=args.device, log=log)
    if not all(map(math.isfinite, res.losses)):
        print("[train] non-finite loss")
        return 1
    print(f"[train] finished at step {res.state.step}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
