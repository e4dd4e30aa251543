"""Kernel-launch tuning environment: the dispatch registry's launch space as
a CAMEO performance environment — the port of
:mod:`repro.envs.kernel_launch`.

The configuration options are exactly the launch parameters the dispatch
layer (:mod:`repro_torch.kernels.dispatch`) hands to the CUDA kernels —
block sizes and chunk lengths, prefixed ``family.param``, with the domains
the sm_90 kernels take.  Measurement is delegated to a
:class:`repro_torch.envs.measure.MeasurementBackend`:

- ``analytic`` (default) — the launch-geometry model (grid extent, block
  footprints, streamed bytes, per-launch overhead): the cheap source;
- ``wallclock`` — the port's kernels timed with CUDA events under the
  candidate configuration (the plain versions on the host clock when the
  backend is put on the CPU): the costly target;
- ``shifted:<kind>`` — the analytic model under a registered environment
  shift (``repro_torch.envs.measure.SHIFT_KINDS``): the reproducible target
  side of a source→target transfer pair (see ``repro_torch.tuner.bench``).

Select with the ``backend=`` constructor argument or the
``REPRO_MEASURE_BACKEND`` env var.  Counters play the role of the paper's
system events C.  A tuned optimum is deployable directly:
``dispatch.use_launch_config(best_config)`` routes every subsequently
dispatched kernel with the tuned launch parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Tuple, Union

from repro_torch.envs import measure as measure_mod
from repro_torch.envs.base import PooledEnv
from repro_torch.envs.measure import KernelWorkload, MeasurementBackend
from repro_torch.kernels import dispatch

__all__ = ["KernelLaunchEnv", "KernelWorkload"]


class KernelLaunchEnv(PooledEnv):
    """PerfEnv over ``dispatch.launch_space()`` for a fixed workload.

    ``backend`` is a backend name (``"analytic"`` | ``"wallclock"`` |
    ``"shifted:<kind>"``), an object satisfying
    :class:`~repro_torch.envs.measure.MeasurementBackend`, or ``None`` (the
    ``REPRO_MEASURE_BACKEND`` env var, default analytic).  ``backend_opts``
    are forwarded to the backend constructor (e.g. ``device`` / ``repeats``
    / ``clock`` for wallclock, ``hardware`` for the analytic ones).
    """

    counter_names = measure_mod.COUNTER_NAMES

    def __init__(self, workload: Optional[KernelWorkload] = None,
                 families: Optional[Iterable[str]] = None, seed: int = 0,
                 backend: Union[None, str, MeasurementBackend] = None,
                 backend_opts: Optional[Dict[str, Any]] = None):
        self.workload = workload or KernelWorkload()
        if isinstance(backend, (str, type(None))):
            if families is None:
                # the registry is open; model only the families there is a
                # geometry model for
                modeled = measure_mod.modeled_families()
                families = [f for f in dispatch.families() if f in modeled]
            self.families = sorted(families)
            self.backend: MeasurementBackend = measure_mod.make_backend(
                backend, self.workload, self.families, seed,
                **(backend_opts or {}))
        else:
            if backend_opts:
                raise ValueError(
                    "backend_opts only apply when the backend is built here; "
                    "pass a configured backend instance instead")
            # the instance is authoritative: its families define the tuning
            # space and its counter_names the counter schema
            self.backend = backend
            self.families = sorted(backend.families)
            if families is not None and sorted(families) != self.families:
                raise ValueError(
                    f"families {sorted(families)} conflict with the backend "
                    f"instance's {self.families}; pass one or the other")
        super().__init__(dispatch.launch_space(self.families),
                         tuple(self.backend.counter_names), seed=seed)

    def _measure(self, config: Dict[str, Any]) -> Tuple[Dict[str, float], float]:
        return self.backend.measure(config)

    def intervene_batch(self, configs):
        """Route a q-batch through the backend's ``measure_batch`` when it
        has one (one noise draw for analytic, one timing per distinct
        launch tuple for wallclock); otherwise the sequential default."""
        batch = getattr(self.backend, "measure_batch", None)
        if batch is None:
            return super().intervene_batch(configs)
        results = batch(list(configs))
        for cfg, (counters, y) in zip(configs, results):
            self._remember(cfg, counters, y)
        return results

    # -- deployment -----------------------------------------------------

    def apply(self, config: Dict[str, Any]):
        """Context manager installing ``config`` on the dispatch registry —
        the measured optimum is the deployed launch configuration."""
        return dispatch.use_launch_config(config)
