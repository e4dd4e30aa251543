"""Fault-tolerant training driver — the port of :mod:`repro.runtime.driver`.

The driver owns the restart contract of the reference:

  1. on start (or after a fault) restore the latest durable checkpoint —
     params, optimizer state, step counter — or start from
     ``init_state()``; the data pipeline needs no state because batches
     are addressed by step;
  2. run train steps, checkpointing every ``checkpoint_every`` steps and
     at the last;
  3. on a step fault (``RuntimeError``: a device error, an injected fault)
     drop the faulted state, restore, and continue — the run ends where
     an unbroken one does, bit for bit where the step is deterministic;
  4. feed the straggler monitor with the step times.

Three things differ from the reference.  A restart first waits for the
checkpoint save in flight, which the fault did not stop, so the restart
point is the latest save, whatever the writer thread's timing (the
reference lists the directory at once and may restart from an older
checkpoint).  The restore template is built by
``state_template()``, a state of the same structure whose tensors allocate
nothing (:func:`~repro_torch.train.train_step.train_state_template`
builds one on the ``meta`` device), where the reference traces
``jax.eval_shape(init_state)``: a second real state would not fit beside
the first on one card at the sizes trained.  And the faulted state is
released before the restore: leaving the ``except`` clause unbinds the
exception, whose traceback holds the frames that hold the state, so the
restored state takes its place instead of joining it.

``FaultInjector`` deterministically raises at chosen steps so the fault
paths are testable on the CPU.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train.train_step import TrainState
from repro_torch.utils.device import DeviceLike, resolve_device, synchronize
from repro_torch.utils.logging import MetricsLogger


class FaultInjector:
    """Raises RuntimeError at the given (1-indexed) global steps, once each."""

    def __init__(self, fault_steps: List[int]):
        self._pending = set(fault_steps)

    def check(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            raise RuntimeError(f"injected fault at step {step}")


class TrainDriver:
    def __init__(
        self,
        run,
        train_step: Callable[[TrainState, Dict], Any],
        init_state: Callable[[], TrainState],
        data: SyntheticLMData,
        ckpt: CheckpointManager,
        logger: Optional[MetricsLogger] = None,
        fault_injector: Optional[FaultInjector] = None,
        num_hosts: int = 1,
        max_restarts: int = 8,
        *,
        state_template: Callable[[], TrainState],
        device: DeviceLike = None,
    ):
        self.run = run
        self.train_step = train_step
        self.init_state = init_state
        self.state_template = state_template
        self.device = resolve_device(device)
        self.data = data
        self.ckpt = ckpt
        # remember whether we created the logger: run_steps closes a
        # self-owned logger on exit (a caller-provided one stays open —
        # the caller's context manager owns its lifetime)
        self._owns_logger = logger is None
        self.logger = logger or MetricsLogger(name="driver")
        self.fault_injector = fault_injector
        self.straggler = StragglerMonitor(num_hosts)
        self.max_restarts = max_restarts
        self.restarts = 0

    # -- state bootstrap -----------------------------------------------------

    def _bootstrap(self) -> TrainState:
        # a fault in a step does not stop the writer thread: let the save
        # in flight commit, so that the restart point does not depend on
        # the thread's timing (the reference reads the directory at once)
        self.ckpt.wait()
        latest = self.ckpt.latest_step()
        if latest is None:
            state = self.init_state()
            self.logger.log(0, event="init_fresh")
            return state
        state = self.ckpt.restore(latest, self.state_template(),
                                  device=self.device)
        self.logger.log(latest, event="restored")
        return state

    # -- main loop -----------------------------------------------------------

    def run_steps(self, total_steps: int) -> TrainState:
        try:
            while True:
                try:
                    return self._run_from_checkpoint(total_steps)
                except RuntimeError as e:
                    self.restarts += 1
                    if self.restarts > self.max_restarts:
                        raise
                    self.logger.log(-1, event="fault", error=str(e),
                                    restart=self.restarts)
                # the exception is unbound here, and with its traceback
                # the faulted state: the next iteration restores from the
                # latest durable checkpoint into the freed memory
        finally:
            if self._owns_logger:
                self.logger.close()

    def _run_from_checkpoint(self, total_steps: int) -> TrainState:
        state = self._bootstrap()
        step = int(state.step)
        while step < total_steps:
            if self.fault_injector is not None:
                self.fault_injector.check(step + 1)
            batch = self.data.batch_at(step)
            # repro: ignore[wall-clock] -- step time for the log and the straggler monitor, as the reference's driver takes it
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            synchronize(self.device)
            # repro: ignore[wall-clock] -- step time for the log and the straggler monitor, as the reference's driver takes it
            dt = time.perf_counter() - t0
            step = int(state.step)
            self.straggler.report({0: dt})
            if step % self.run.log_every == 0 or step == total_steps:
                self.logger.log(step, loss=float(metrics["loss"]),
                                grad_norm=float(metrics["grad_norm"]),
                                step_time_s=round(dt, 4))
            if step % self.run.checkpoint_every == 0 or step == total_steps:
                self.ckpt.save(step, state, extra={"step": step})
        self.ckpt.wait()
        return state
