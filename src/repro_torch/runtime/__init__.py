"""Runtime pieces the serving simulator's fleet model needs: the straggler
monitor (carried) and the mesh-split rule of :mod:`repro_torch.runtime.elastic`.
The train driver and elastic re-meshing of checkpoints come with the train
tooling."""

from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
from repro_torch.runtime.elastic import viable_mesh_shape  # noqa: F401
