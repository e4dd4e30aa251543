"""Mesh construction and placement assembly — the port of
:mod:`repro.launch.mesh`.

:class:`MeshSpec` describes a mesh without devices (axis names and their
sizes), which is all the placement rules of
:mod:`repro_torch.sharding.specs` read; :func:`make_production_mesh` is
such a description, so importing this module touches no device and no
process group.  :func:`make_mesh` builds the mesh a run executes on: the
process groups of its data and model axes over every rank when a process
group is up, the one-device description when none is.
:meth:`MeshSpec.traced` is a mesh whose groups only record their
collectives (:class:`~repro_torch.sharding.collectives.Recorder`): the
mesh of one rank's program traced on ``meta`` tensors
(:func:`repro_torch.launch.build.lower_step`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.sharding.collectives import Axis, Recorder
from repro_torch.sharding.specs import (
    PartitionSpec, batch_specs, data_axes_of, param_specs,
    serve_state_specs, to_placements, train_state_specs)
from repro_torch.utils.config import MeshConfig, RunConfig
from repro_torch.utils.trees import tree_map


@dataclass(frozen=True)
class MeshSpec:
    """A mesh: ``axis_names`` and ``shape`` (axis name -> size, in the
    axes' order), and, on an executing mesh, this process's ``rank`` and
    its process ``groups`` (``"data"``: the data axes, ``"model"``, and
    ``"world"``, each a :class:`~repro_torch.sharding.collectives.Axis`).
    A description has neither."""
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]
    groups: Optional[Mapping[str, Axis]] = field(default=None,
                                                 compare=False)
    rank: Optional[int] = field(default=None, compare=False)

    @classmethod
    def of(cls, shape: Tuple[int, ...], axes: Tuple[str, ...]
           ) -> "MeshSpec":
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             f"in length")
        return cls(tuple(axes), dict(zip(axes, shape)))

    @classmethod
    def traced(cls, shape: Tuple[int, ...], axes: Tuple[str, ...],
               rank: int = 0) -> "MeshSpec":
        """The mesh of ``shape`` / ``axes`` as rank ``rank`` sees it, with
        groups that move no data: each of ``"data"``, ``"model"`` and
        ``"world"`` is an :class:`~repro_torch.sharding.collectives.Axis`
        at the rank's coordinates (:func:`coords_of`) whose group is one
        shared :class:`~repro_torch.sharding.collectives.Recorder`
        (:attr:`recorder`)."""
        desc = cls.of(shape, axes)
        rec = Recorder()
        coords = coords_of(rank, desc)

        def axis(over):
            idx = 0
            for a in over:
                idx = idx * desc.shape[a] + coords[a]
            return Axis(rec, ",".join(over) or "none", desc.size(over), idx)

        model = ("model",) if "model" in desc.axis_names else ()
        groups = {"data": axis(data_axes_of(desc.axis_names)),
                  "model": axis(model),
                  "world": Axis(rec, ",".join(desc.axis_names),
                                desc.size(desc.axis_names), rank)}
        return cls(desc.axis_names, desc.shape, groups, rank)

    @property
    def recorder(self) -> Optional[Recorder]:
        """The recorder of a traced mesh's groups; None on another mesh."""
        if self.groups is None:
            return None
        group = self.groups["world"].group
        return group if isinstance(group, Recorder) else None

    def size(self, axes) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def axis(self, name: str) -> Optional[Axis]:
        """The process group over ``name``'s axes (``"data"``: every data
        axis, flattened row-major; ``"model"``; ``"world"``) on an
        executing or traced mesh; None on a description whose axes are
        all of size 1.  A description with such an axis above 1 raises:
        it has no process group to reduce over, and a step on it is not
        the step of one process."""
        axes = {"data": data_axes_of(self.axis_names),
                "model": tuple(a for a in self.axis_names if a == "model"),
                "world": self.axis_names}[name]
        if self.groups is None:
            if self.size(axes) > 1:
                raise RuntimeError(
                    f"the mesh {dict(self.shape)} has no process group "
                    f"over {axes} (size {self.size(axes)}): build it with "
                    f"make_mesh under an initialized torch.distributed")
            return None
        return self.groups[name]

    def data_group(self):
        """The process group over the data axes of an executing mesh, which
        the step's data reductions run over; None on a description of
        size 1 (see :meth:`axis`)."""
        ax = self.axis("data")
        return None if ax is None else ax.group

    def model_group(self):
        """The process group over the model axis, as :meth:`data_group`."""
        ax = self.axis("model")
        return None if ax is None else ax.group


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production mesh, (16, 16) ``("data", "model")`` or
    (2, 16, 16) ``("pod", "data", "model")``, as a description."""
    if multi_pod:
        return MeshSpec.of((2, 16, 16), ("pod", "data", "model"))
    return MeshSpec.of((16, 16), ("data", "model"))


def make_mesh(cfg: MeshConfig) -> MeshSpec:
    """The mesh of ``cfg`` over the ranks of the process group (rank ``r``
    at :func:`coords_of`), with a process group over its data axes and
    one over its model axis for each rank (``dist.new_group``, every rank
    creating every group in the same order); without a process group, the
    one-device description.  Raises when the mesh's device count differs
    from the ranks (or, without a group, from one)."""
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
    desc = MeshSpec.of(cfg.shape, cfg.axes)
    rank = dist.get_rank()
    daxes = data_axes_of(desc.axis_names)
    groups = {"data": _axis_group(desc, daxes, rank),
              "model": _axis_group(desc, ("model",) if "model" in
                                   desc.axis_names else (), rank),
              "world": Axis(dist.group.WORLD, ",".join(desc.axis_names),
                            world, rank)}
    return MeshSpec(desc.axis_names, desc.shape, groups, rank)


def _axis_group(mesh: MeshSpec, axes: Tuple[str, ...], rank: int) -> Axis:
    """This rank's group over ``axes``: the ranks whose other coordinates
    are its own, in row-major order over ``axes``.  Every rank creates the
    group of every coordinate of the other axes, in the same order, as
    ``dist.new_group`` requires."""
    import itertools

    import torch.distributed as dist

    others = [a for a in mesh.axis_names if a not in axes]
    world = mesh.size(mesh.axis_names)
    found = None
    for fixed in itertools.product(*(range(mesh.shape[a]) for a in others)):
        ranks = [r for r in range(world)
                 if all(coords_of(r, mesh)[a] == c
                        for a, c in zip(others, fixed))]
        group = dist.new_group(ranks)
        if rank in ranks:
            found = Axis(group, ",".join(axes) or "none", len(ranks),
                         ranks.index(rank))
    return found


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
