"""The reference's launch geometry behind the port's name, for parity tests.

The port prices its Hopper kernels' launches (``repro_torch.envs.measure.
LaunchGeometry``); the reference prices its Pallas blocks on a TPU.  Tests
that hold the port's event loops, admission, routing, counters and tuner
proposals bit for bit against the reference's must price both packages
alike, so they rebind the port's ``LaunchGeometry`` — in every module that
bound the name — to :class:`ReferenceGeometry`, an adapter over
``repro.envs.measure.LaunchGeometry``.  The TPU formulae live only in the
reference.

Import the fixture into a test file and name it on each parity test::

    from torch_reference_geometry import reference_geometry  # noqa: F401

    @pytest.mark.usefixtures("reference_geometry")
    def test_simulator_counters_are_the_reference_bit_for_bit(): ...

Tests of the port alone (its own constants, gates and CLIs) keep the
Hopper geometry.
"""

import dataclasses
import importlib

import pytest

from repro.envs.measure import HardwareSpec as JHardwareSpec
from repro.envs.measure import KernelWorkload as JKernelWorkload
from repro.envs.measure import LaunchGeometry as JLaunchGeometry
from repro_torch.envs import measure as measure_mod

#: every module of the port that binds ``LaunchGeometry`` at import
BINDING_MODULES = ("repro_torch.envs", "repro_torch.envs.measure",
                   "repro_torch.envs.replay_env", "repro_torch.workloads.sim")


class ReferenceGeometry:
    """The port's ``LaunchGeometry`` interface over the reference's
    formulae: the port's workload and card mapped field by field onto the
    reference's, the port's launch defaults (``family_params``) and the
    port's accumulation order, as the port priced before its geometry was
    the Hopper kernels'."""

    MODELS = JLaunchGeometry.MODELS

    def __init__(self, workload, hardware=None, dtype=None):
        self.workload = workload
        self.hardware = hardware or measure_mod.HardwareSpec()
        fields = [f.name for f in dataclasses.fields(JKernelWorkload)]
        self._ref = JLaunchGeometry(
            JKernelWorkload(**{f: getattr(workload, f) for f in fields}),
            JHardwareSpec(self.hardware.mxu_flops_per_us,
                          self.hardware.vpu_flops_per_us,
                          self.hardware.hbm_bytes_per_us))

    def family_cost(self, family, params):
        return self._ref.family_cost(family, params)

    def totals(self, families, config):
        total_us, grid_pts, vmem_peak, flops, hbm = 0.0, 0.0, 0.0, 0.0, 0.0
        feasible = True
        for family in families:
            t, grid, vmem, fl, hb = self.family_cost(
                family, measure_mod.family_params(family, config))
            total_us += t
            grid_pts += grid
            vmem_peak = max(vmem_peak, vmem)
            flops += fl
            hbm += hb
            if vmem > self.workload.vmem_limit:
                feasible = False
        counters = {"grid_points": grid_pts, "vmem_peak_bytes": vmem_peak,
                    "hbm_bytes": hbm, "flops": flops}
        return counters, total_us, feasible


@pytest.fixture
def reference_geometry():
    """Rebinds the port's ``LaunchGeometry`` to :class:`ReferenceGeometry`
    for one test, and restores it after."""
    with pytest.MonkeyPatch.context() as mp:
        for name in BINDING_MODULES:
            mp.setattr(importlib.import_module(name), "LaunchGeometry",
                       ReferenceGeometry)
        yield ReferenceGeometry
