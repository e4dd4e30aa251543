"""Runtime pieces: the fault-tolerant train driver, the straggler monitor
(carried) and the mesh-split rule of :mod:`repro_torch.runtime.elastic`.
Elastic re-meshing of checkpoints comes with sharding."""

from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.elastic import viable_mesh_shape  # noqa: F401
