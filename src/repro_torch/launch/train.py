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
its latest checkpoint.  The data and the training config are the
reference's: ``make_data(cfg, shape, seed=0)`` and
``TrainConfig(lr=1e-3, warmup_steps=10)``.

Run as is, it trains on one device.  Under ``torch.distributed.run`` it
trains data-parallel over every rank, as the reference's CLI runs over
every device of a data mesh:

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m repro_torch.launch.train --arch llama3.2-1b --steps 50

The process group is NCCL on the GPU and gloo with ``--device cpu``; the
rendezvous is on this host.  The CLI trains with ``ParallelConfig()``, so
its run goes on a ``("data", "model")`` mesh of the world size with a
model axis of 1 (:func:`data_parallel`) and every parameter is
replicated.  :func:`drive` and :func:`train` take a run's
``ParallelConfig`` (tp, fsdp, ``moe_expert_axis``): the mesh keeps
``run.parallel.tp`` (:func:`~repro_torch.runtime.elastic.
adjust_run_for_devices`), or is ``run.mesh`` itself when that matches the
world (the ``("pod", "data", "model")`` mesh), and each rank holds its
blocks of the state under the rules' placements.  The ranks of data
coordinate ``d`` of ``D`` step on rows ``[d B/D, (d+1) B/D)`` of the
global batch of ``make_data(..., num_shards=1)``, and the step
(:func:`~repro_torch.train.train_step.make_train_step`'s ``mesh``) sums
what the ranks share, so every rank computes what one process computes on
the whole batch.  Rank 0 writes the checkpoints (each leaf gathered
whole, the reference's layout); every rank restores its blocks
(:func:`~repro_torch.runtime.elastic.remesh_state`).

:func:`train` is the in-process loop without the driver that
``chip_smoke.py`` uses for per-step losses and times; it takes any config
(full-width configs with their depth cut), data-parallel over the process
group when one is up.

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

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import (get_model_config, get_smoke_config,
                                          list_archs)
from repro_torch.data.pipeline import SyntheticLMData, make_data
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.tune import measure_backend_arg, tune_launch_config
from repro_torch.models.model import build_model
from repro_torch.runtime.driver import FaultInjector, TrainDriver
from repro_torch.runtime.elastic import adjust_run_for_devices, remesh_state
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (TrainState, init_train_state,
                                          make_train_step,
                                          train_state_template)
from repro_torch.utils.config import (MeshConfig, ModelConfig, ParallelConfig,
                                      RunConfig, ShapeConfig, TrainConfig)
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize
from repro_torch.utils.trees import tree_map
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
    state: object = None  # this rank's blocks on a sharded mesh
    mesh: object = None


def make_run(cfg: ModelConfig, *, seq: int, batch: int, steps: int,
             checkpoint_dir: str = DEFAULT_CKPT_DIR,
             parallel: Optional[ParallelConfig] = None) -> RunConfig:
    """The reference CLI's run of a chosen global ``batch`` and ``seq``:
    one data shard, ``parallel`` (``ParallelConfig()`` unless given),
    ``TrainConfig(lr=1e-3,
    warmup_steps=10, total_steps=steps)``, a checkpoint every 25 steps
    into ``checkpoint_dir`` and a log line every 5.  (The run of an
    assigned shape cell on the production mesh is
    :func:`repro_torch.configs.registry.make_run`.)"""
    return RunConfig(
        model=cfg,
        shape=ShapeConfig("train_cli", seq, batch, "train"),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        parallel=parallel or ParallelConfig(),
        train=TrainConfig(lr=1e-3, warmup_steps=10, total_steps=steps),
        checkpoint_dir=checkpoint_dir, checkpoint_every=25, log_every=5)


class RankRows:
    """Rank ``rank``'s rows of ``data``'s global batch: rows ``[rank B/N,
    (rank+1) B/N)`` of ``batch_at(step)`` over ``world`` ranks."""

    def __init__(self, data: SyntheticLMData, rank: int, world: int):
        if data.shard_batch % world:
            raise ValueError(f"global batch {data.shard_batch} does not "
                             f"split over {world} ranks")
        self.data, self.rank = data, rank
        self.rows = data.shard_batch // world

    def batch_at(self, step: int) -> Dict[str, Any]:
        lo = self.rank * self.rows
        return {k: v[lo:lo + self.rows]
                for k, v in self.data.batch_at(step).items()}


def data_parallel(run: RunConfig, device: torch.device):
    """``(run, mesh)`` of ``run`` over the ranks of the process group:
    ``run.mesh`` when it has as many devices as the world, else the
    reference's placement through :func:`adjust_run_for_devices` (a
    ``("data", "model")`` mesh keeping ``run.parallel.tp``), and the mesh
    with its process groups (:func:`make_mesh`); without a process group
    ``run`` itself on the one-device mesh."""
    if not dist.is_initialized():
        run.validate()
        return run, make_mesh(run.mesh)
    world = dist.get_world_size()
    if run.mesh.num_devices != world:
        run = adjust_run_for_devices(run, world)
    run.validate()
    return run, make_mesh(run.mesh)


def rank_rows(data: SyntheticLMData, group):
    """``data`` itself without a group; with the data axes' group, the rows
    of this rank's data coordinate (its rank in the group)."""
    if group is None:
        return data
    return RankRows(data, dist.get_rank(group), dist.get_world_size(group))


def train(cfg: ModelConfig, *, steps: int, seq: int, batch: int,
          device: DeviceLike = None, seed: int = 0,
          log: Optional[Callable] = None,
          launch_config: Optional[Dict[str, Any]] = None,
          params: Optional[Dict] = None,
          run: Optional[RunConfig] = None) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps on the reference's synthetic data
    (seed 0), from ``params`` (whole) or parameters drawn from ``seed``,
    the step built with ``launch_config`` (a tuned ``family.param``
    config).  ``run`` (default: :func:`make_run`) gives the placements and
    the optimizer, and must be of ``cfg``, ``seq`` and ``batch``.  When a
    process group is up, sharded over its ranks (:func:`data_parallel`),
    ``batch`` the global batch.  Each step is timed on the host around a
    device synchronize."""
    if run is None:
        run = make_run(cfg, seq=seq, batch=batch, steps=steps)
    elif (run.model, run.shape.seq_len, run.shape.global_batch) != (
            cfg, seq, batch):
        raise ValueError(
            f"train: the run is of {run.model.name} at "
            f"{run.shape.global_batch} x {run.shape.seq_len}, the call of "
            f"{cfg.name} at {batch} x {seq}")
    model = build_model(cfg, run.parallel, device=device)
    run, mesh = data_parallel(run, model.device)
    group = mesh.data_group()
    optimizer = make_optimizer(run.train)
    step_fn = make_train_step(model, run, optimizer,
                              launch_config=launch_config, mesh=mesh)
    state = init_train_state(model, run, optimizer, seed=seed, params=params,
                             mesh=mesh)
    del params  # the masters are their copy in the param dtype
    data = rank_rows(make_data(cfg, run.shape, seed=0), group)
    out = TrainResult(run, mesh=mesh)
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


class RankZeroCheckpoints:
    """The driver's checkpoints over the ranks of ``mesh``, in the
    reference's layout of whole leaves: a save gathers each leaf's blocks
    (``train_state_specs`` of ``run``), and rank 0 alone copies them to
    the host and writes, after a barrier; every rank restores its blocks
    through :func:`~repro_torch.runtime.elastic.remesh_state`.  ``wait``
    ends in a barrier once rank 0's write has committed, and
    ``latest_step`` checks that every rank sees rank 0's restart point."""

    def __init__(self, ckpt: CheckpointManager, mesh, run: RunConfig,
                 device: torch.device):
        self.ckpt, self.mesh, self.run, self.device = ckpt, mesh, run, device
        self.rank = mesh.rank

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        if self.rank == 0:  # the last write ends before the next copy
            self.ckpt.wait()
        dist.barrier()
        whole = gather_state(tree, self.run, self.mesh, host=self.rank == 0)
        if self.rank == 0:  # the gather's host copies are the snapshot
            self.ckpt.save(step, whole, extra=extra, blocking=blocking,
                           copied=True)

    def wait(self) -> None:
        if self.rank == 0:
            self.ckpt.wait()
        dist.barrier()

    def latest_step(self) -> Optional[int]:
        latest = self.ckpt.latest_step()
        mine = torch.tensor([-1 if latest is None else latest],
                            dtype=torch.int64, device=self.device)
        first = mine.clone()
        dist.broadcast(first, src=0)
        if int(first) != int(mine):
            raise RuntimeError(f"rank {self.rank} restarts from step "
                               f"{latest}, rank 0 from {int(first)}")
        return latest

    def restore(self, step: int, template: Any, device: DeviceLike = None):
        return remesh_state(self.ckpt, step, template, self.run, self.mesh,
                            rank=self.rank, device=device)


def gather_state(state: TrainState, run: RunConfig, mesh,
                 host: bool = True) -> TrainState:
    """The whole train state from every rank's blocks under the
    placements of ``run`` on ``mesh`` (``train_state_specs``): each leaf
    that an axis splits all-gathered on its device, and with ``host`` every
    leaf copied to the host before the next, one host copy a leaf that
    nothing else holds (without ``host`` the rank takes part in the
    gathers and keeps nothing)."""
    from repro_torch.sharding.layout import Layout
    from repro_torch.sharding.specs import train_state_specs

    meta = build_model(run.model, run.parallel, device="meta")
    specs = train_state_specs(
        train_state_template(meta, run, make_optimizer(run.train)),
        run.model, run.parallel, mesh)
    layout = Layout({}, mesh)

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        whole = layout.gather_whole(leaf, spec)
        return whole.to("cpu", copy=True) if host else None

    return tree_map(one, state, specs)


def drive(run: RunConfig, *, device: DeviceLike = None,
          launch_config: Optional[Dict[str, Any]] = None,
          fault_injector: Optional[FaultInjector] = None,
          name: Optional[str] = None) -> TrainState:
    """Train ``run`` for ``run.train.total_steps`` steps through the
    fault-tolerant driver, checkpointing into ``run.checkpoint_dir``
    (resuming from its latest checkpoint), sharded over the process group
    under ``run.parallel``'s placements when one is up (see
    :func:`data_parallel`); the final state (this rank's blocks)."""
    cfg = run.model
    model = build_model(cfg, run.parallel, device=device)
    run, mesh = data_parallel(run, model.device)
    group = mesh.data_group()
    optimizer = make_optimizer(run.train)
    step_fn = make_train_step(model, run, optimizer,
                              launch_config=launch_config, mesh=mesh)
    ckpt = CheckpointManager(run.checkpoint_dir, keep=run.keep_checkpoints)
    if mesh.groups is not None:
        ckpt = RankZeroCheckpoints(ckpt, mesh, run, model.device)
    name = name or f"train-{cfg.name}"
    if mesh.groups is not None and dist.get_world_size() > 1:
        name = f"{name}-rank{mesh.rank}"

    def init_state():
        return init_train_state(model, run, optimizer, seed=run.train.seed,
                                mesh=mesh)

    with MetricsLogger(name=name) as logger:
        driver = TrainDriver(
            run, step_fn, init_state,
            rank_rows(make_data(cfg, run.shape, seed=0), group), ckpt,
            logger=logger, fault_injector=fault_injector,
            device=model.device,
            state_template=lambda: train_state_template(model, run,
                                                        optimizer))
        return driver.run_steps(run.train.total_steps)


def init_distributed(device: torch.device) -> bool:
    """Under ``torch.distributed.run`` (its ``WORLD_SIZE`` set), join the
    process group: NCCL for a CUDA ``device`` (this rank's card taken by
    ``LOCAL_RANK``), gloo for the CPU; the rendezvous must be on this host.
    False when not launched so."""
    import socket

    if "WORLD_SIZE" not in os.environ:
        return False
    addr = os.environ.get("MASTER_ADDR", "")
    if addr not in ("localhost", "127.0.0.1", "::1", socket.gethostname(),
                    socket.getfqdn()):
        raise RuntimeError(f"the rendezvous address {addr!r} is not this "
                           f"host; launch with torch.distributed.run "
                           f"--standalone")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    elif device.type == "cpu":
        dist.init_process_group("gloo")
    else:
        raise ValueError(f"no process group for device {device}")
    return True


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8,
                    help="the global batch (split over the ranks)")
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

    device = resolve_device(args.device)
    distributed = init_distributed(device)
    try:
        return _main(args, device)
    finally:
        if distributed:
            dist.destroy_process_group()


def _main(args, device: torch.device) -> int:
    cfg = (get_model_config(args.arch) if args.full_config
           else get_smoke_config(args.arch))
    run = make_run(cfg, seq=args.seq, batch=args.batch, steps=args.steps,
                   checkpoint_dir=args.ckpt_dir)
    run.validate()
    ndev = dist.get_world_size() if dist.is_initialized() else 1
    print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, batch {args.batch} x seq {args.seq} "
          f"on {ndev} device(s) ({device})")

    launch_config = None
    if args.tune_launch > 0:
        # one config for every rank: rank 0 tunes, the others take its pick
        picked = [None]
        if not dist.is_initialized() or dist.get_rank() == 0:
            picked[0] = tune_launch_config(
                cfg, args.batch, args.seq, args.tune_launch,
                args.measure_backend, kind="train",
                query_batch=args.query_batch, device=device)
        if dist.is_initialized():
            dist.broadcast_object_list(picked, src=0)
        launch_config = picked[0]
    state = drive(run, device=device, launch_config=launch_config,
                  name=f"train-{args.arch}")
    print(f"[train] finished at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
