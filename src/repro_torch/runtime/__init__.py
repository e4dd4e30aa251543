"""Runtime pieces: the fault-tolerant train driver
(:mod:`repro_torch.runtime.driver`), the straggler monitor (carried) and
elastic re-meshing (:mod:`repro_torch.runtime.elastic`)."""

from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.elastic import (  # noqa: F401
    adjust_run_for_devices, remesh_state, viable_mesh_shape)
