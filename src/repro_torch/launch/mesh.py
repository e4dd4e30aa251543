"""Mesh construction and placement assembly — the port of
:mod:`repro.launch.mesh`.

:class:`MeshSpec` describes a mesh without devices (axis names and their
sizes), which is all the placement rules of
:mod:`repro_torch.sharding.specs` read; :func:`make_production_mesh` is
such a description, so importing this module touches no device and no
process group.  :func:`make_mesh` builds the mesh a run executes on: a
``torch.distributed`` device mesh over every rank when a process group is
up, the one-device description when none is.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.sharding.specs import (
    PartitionSpec, batch_specs, data_axes_of, param_specs,
    serve_state_specs, to_placements, train_state_specs)
from repro_torch.utils.config import MeshConfig, RunConfig
from repro_torch.utils.trees import tree_map


@dataclass(frozen=True)
class MeshSpec:
    """A mesh: ``axis_names`` and ``shape`` (axis name -> size, in the
    axes' order), and, on an executing mesh, the
    ``torch.distributed`` ``DeviceMesh`` over its ranks."""
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]
    device_mesh: Any = field(default=None, compare=False)

    @classmethod
    def of(cls, shape: Tuple[int, ...], axes: Tuple[str, ...],
           device_mesh: Any = None) -> "MeshSpec":
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             f"in length")
        return cls(tuple(axes), dict(zip(axes, shape)), device_mesh)

    def data_group(self):
        """The process group over the data axis of an executing mesh, which
        a data-parallel step's reductions run over; None on a mesh without
        ranks (the one-device description)."""
        if self.device_mesh is None:
            return None
        daxes = data_axes_of(self.axis_names)
        if len(daxes) != 1:
            raise NotImplementedError(
                f"a data-parallel step over the axes {daxes}: the train CLI "
                f"runs on one ('data',) axis")
        return self.device_mesh.get_group(daxes[0])


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) ``("pod", "data", "model")``, as a description."""
    if multi_pod:
        return MeshSpec.of((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec.of((16, 16), ("data", "model"))


def make_mesh(cfg: MeshConfig, device_type: Optional[str] = None
              ) -> MeshSpec:
    """The mesh of ``cfg`` over the ranks of the process group, built with
    ``init_device_mesh`` on ``device_type`` (``"cuda"`` unless given);
    without a process group, the one-device description.  Raises when the
    mesh's device count differs from the ranks (or, without a group, from
    one)."""
    import torch.distributed as dist

    n = cfg.num_devices
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise RuntimeError(
                f"mesh {cfg.shape} needs {n} devices; without a process "
                f"group there is one (launch under torch.distributed.run)")
        return MeshSpec.of(cfg.shape, cfg.axes)
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"mesh {cfg.shape} needs {n} devices, the "
                           f"process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device_type or "cuda", tuple(cfg.shape),
                          mesh_dim_names=tuple(cfg.axes))
    return MeshSpec.of(cfg.shape, cfg.axes, dm)


def _placements(specs, mesh: MeshSpec):
    return tree_map(lambda s: to_placements(s, mesh.axis_names), specs)


def state_shardings(state_template, run: RunConfig, mesh: MeshSpec):
    """DTensor placements for a ``TrainState`` template
    (params / opt / step / error_buf)."""
    return _placements(
        train_state_specs(state_template, run.model, run.parallel, mesh),
        mesh)


def serve_shardings(state_template, run: RunConfig, mesh: MeshSpec):
    return _placements(
        serve_state_specs(state_template, run.model, run.parallel, mesh),
        mesh)


def params_shardings(params_template, run: RunConfig, mesh: MeshSpec):
    return _placements(
        param_specs(params_template, run.model, run.parallel, mesh), mesh)


def batch_shardings(batch_template, mesh: MeshSpec):
    return _placements(batch_specs(batch_template, mesh), mesh)


def coords_of(rank: int, mesh: MeshSpec) -> Dict[str, int]:
    """Mesh coordinates (axis name -> index) of ``rank``, row-major over
    the axes as ``init_device_mesh`` lays ranks out."""
    out: Dict[str, int] = {}
    for a in reversed(mesh.axis_names):
        rank, out[a] = divmod(rank, mesh.shape[a])
    return {a: out[a] for a in mesh.axis_names}


def local_shard(tensor, spec: PartitionSpec, mesh: MeshSpec,
                coords: Mapping[str, int]):
    """The block of ``tensor`` that the rank at mesh coordinates ``coords``
    (axis name -> index) holds under ``spec``: each split dim cut into as
    many equal blocks as its axes' sizes multiply to, the rank's block
    numbered row-major over those axes.  A view of ``tensor``."""
    sizes = mesh.shape
    out = tensor
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + int(coords[a])
        if out.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(tensor.shape)} does not "
                             f"split into {n} blocks")
        block = out.shape[d] // n
        out = out.narrow(d, idx * block, block)
    return out
