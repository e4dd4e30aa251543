"""Tuning environments: the ``PerfEnv`` contract, the paper's sandbox
SCM, the analytic TPU environment of the transfer experiments, the
kernel-launch environment and its measurement backends, the simulated
serving environment and the replay environment over the real batcher."""

from repro_torch.envs.base import PerfEnv, PooledEnv  # noqa: F401
from repro_torch.envs.sandbox import SandboxSCMEnv, make_sandbox_pair  # noqa: F401
from repro_torch.envs.analytic import (  # noqa: F401
    AnalyticTPUEnv, PaddedAnalyticEnv, environment_pair, tpu_config_space)
from repro_torch.envs.kernel_launch import (  # noqa: F401
    KernelLaunchEnv, KernelWorkload)
from repro_torch.envs.measure import (  # noqa: F401
    SHIFT_KINDS, AnalyticBackend, EnvShift, FakeClock, HardwareSpec,
    LaunchGeometry, MeasurementBackend, ShiftedAnalyticBackend, TimingResult,
    WallClockBackend, backend_names, make_backend, register_backend,
    shift_kinds, shifts_for, timeit)


# ServingEnv / ReplayServingEnv sit above the workloads subsystem, which
# itself measures through repro_torch.envs.measure — importing them eagerly
# here would close an import cycle (workloads.sim -> repro_torch.envs ->
# serving_env -> workloads.sim), so the re-exports are lazy (PEP 562).
_SERVING_EXPORTS = {
    "ServingEnv": "serving_env",
    "make_serving_pair": "serving_env",
    "make_fleet_pair": "serving_env",
    "fleet_spec_for": "serving_env",
    "ReplayServingEnv": "replay_env",
    "make_sim2real_pair": "replay_env",
}


def __getattr__(name):
    module = _SERVING_EXPORTS.get(name)
    if module is not None:
        import importlib

        return getattr(importlib.import_module(f"repro_torch.envs.{module}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
