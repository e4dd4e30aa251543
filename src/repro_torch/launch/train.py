"""Training launcher — the port of :mod:`repro.launch.train`, on the GPU by
default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \
        --steps 50 [--seq 128] [--batch 8] [--full-config] [--device cpu] \
        [--ckpt-dir DIR]

It trains any of the registry's ten archs (the smoke config unless
``--full-config``) through the fault-tolerant driver
(:class:`~repro_torch.runtime.driver.TrainDriver`): checkpoints every 25
steps and at the last into ``--ckpt-dir`` (the reference's on-disk format,
:mod:`repro_torch.checkpoint.manager`; default
``repro_torch_launch_train`` under the temporary directory, apart from
the reference CLI's, whose checkpoints hold a jax ``TrainState``), the
metrics logged every 5 steps and at the last through
:class:`~repro_torch.utils.logging.MetricsLogger` (to stderr, ``[train-<arch>]
step=... loss=...``).  A second run with the same directory resumes from
its latest checkpoint.  One device; no mesh.  The data and the training
config are the reference's: ``make_data(cfg, shape, seed=0)`` and
``TrainConfig(lr=1e-3, warmup_steps=10)``.

:func:`train` is the in-process loop without the driver that
``chip_smoke.py`` uses for per-step losses and times; it takes any config
(full-width configs with their depth cut).

``--tune-launch N`` closes the CAMEO loop before training (mirroring
serve): a transfer-tuning run (analytic source, ``--measure-backend``
target) over the kernel-launch space picks block sizes / chunk lengths for
this training shape, and the winning configuration is handed to the train
step.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import (get_model_config, get_smoke_config,
                                          list_archs)
from repro_torch.data.pipeline import make_data
from repro_torch.launch.tune import measure_backend_arg, tune_launch_config
from repro_torch.models.model import build_model
from repro_torch.runtime.driver import TrainDriver
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          train_state_template)
from repro_torch.utils.config import (MeshConfig, ModelConfig, ParallelConfig,
                                      RunConfig, ShapeConfig, TrainConfig)
from repro_torch.utils.device import DeviceLike, synchronize
from repro_torch.utils.logging import MetricsLogger

#: the CLI's checkpoint directory unless ``--ckpt-dir`` names one
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_launch_train")


@dataclass
class TrainResult:
    """What a training run produced and how long each step took."""
    run: RunConfig
    losses: List[float] = field(default_factory=list)
    grad_norms: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)  # host wall, synced
    state: object = None


def make_run(cfg: ModelConfig, *, seq: int, batch: int, steps: int,
             checkpoint_dir: str = DEFAULT_CKPT_DIR) -> RunConfig:
    """The reference CLI's run: one data shard, ``ParallelConfig()``,
    ``TrainConfig(lr=1e-3, warmup_steps=10, total_steps=steps)``, a
    checkpoint every 25 steps into ``checkpoint_dir`` and a log line every
    5."""
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("train_cli", seq, batch, "train"),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        parallel=ParallelConfig(),
        train=TrainConfig(lr=1e-3, warmup_steps=10, total_steps=steps),
        checkpoint_dir=checkpoint_dir, checkpoint_every=25, log_every=5)


def train(cfg: ModelConfig, *, steps: int, seq: int, batch: int,
          device: DeviceLike = None, seed: int = 0,
          log: Optional[Callable] = None,
          launch_config: Optional[Dict[str, Any]] = None,
          params: Optional[Dict] = None) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps on the reference's synthetic data
    (seed 0), from ``params`` or parameters drawn from ``seed``, the step
    built with ``launch_config`` (a tuned ``family.param`` config).  Each
    step is timed on the host around a device synchronize."""
    run = make_run(cfg, seq=seq, batch=batch, steps=steps)
    run.validate()
    model = build_model(cfg, run.parallel, device=device)
    optimizer = make_optimizer(run.train)
    step_fn = make_train_step(model, run, optimizer,
                              launch_config=launch_config)
    state = init_train_state(model, run, optimizer, seed=seed, params=params)
    del params  # the masters are their copy in the param dtype
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
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR,
                    help="checkpoint directory; a run resumes from its "
                         "latest checkpoint")
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
    run = make_run(cfg, seq=args.seq, batch=args.batch, steps=args.steps,
                   checkpoint_dir=args.ckpt_dir)
    run.validate()
    model = build_model(cfg, run.parallel, device=args.device)
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, batch {args.batch} x seq {args.seq} "
          f"on {model.device}")
    optimizer = make_optimizer(run.train)

    launch_config = None
    if args.tune_launch > 0:
        launch_config = tune_launch_config(cfg, args.batch, args.seq,
                                           args.tune_launch,
                                           args.measure_backend, kind="train",
                                           query_batch=args.query_batch,
                                           device=args.device)
    step_fn = make_train_step(model, run, optimizer,
                              launch_config=launch_config)

    def init_state():
        return init_train_state(model, run, optimizer, seed=run.train.seed)

    with MetricsLogger(name=f"train-{args.arch}") as logger:
        driver = TrainDriver(
            run, step_fn, init_state, make_data(cfg, run.shape, seed=0),
            CheckpointManager(run.checkpoint_dir, keep=run.keep_checkpoints),
            logger=logger, device=model.device,
            state_template=lambda: train_state_template(model, run,
                                                        optimizer))
        state = driver.run_steps(args.steps)
    print(f"[train] finished at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
