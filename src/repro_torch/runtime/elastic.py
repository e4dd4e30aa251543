"""Elastic re-meshing: continue a run on a different device count — the
port of :mod:`repro.runtime.elastic`.

The checkpoint format is mesh-agnostic (host arrays per leaf), so scaling
is: build the new mesh, recompute the placement rules for the same model
under the new mesh, and restore each rank's blocks.  The only global-batch
constraint is divisibility by the new data-parallel size;
:func:`adjust_run_for_devices` raises the microbatching to keep the global
batch (so the loss trajectory is unchanged across the re-mesh, modulo
data order).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.utils.config import MeshConfig, RunConfig
from repro_torch.utils.device import DeviceLike


def viable_mesh_shape(num_devices: int, model_parallel: int) -> Tuple[int, int]:
    """Largest (data, model) grid for `num_devices` keeping TP degree.

    When the requested TP does not divide the device count, degrade to the
    LARGEST divisor of ``num_devices`` that is <= the request (prefer keeping
    TP large) — halving skips valid divisors (8 devices at TP 6 would land on
    TP 1 when TP 4 is viable; 100 devices at TP 16 on TP 4 when TP 10 is).
    """
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    tp = max(1, min(int(model_parallel), num_devices))
    while num_devices % tp != 0:
        tp -= 1
    return num_devices // tp, tp


def remesh_state(ckpt, step: int, state_template: Any, run: RunConfig,
                 new_mesh, *, rank: Optional[int] = None,
                 device: DeviceLike = None) -> Any:
    """Restore checkpoint ``step`` (the reference's layout, read by
    :class:`~repro_torch.checkpoint.manager.CheckpointManager`) as the
    blocks one rank holds under ``new_mesh``'s placements of ``run``'s
    rules: a tree like ``state_template`` (a ``TrainState`` of ``meta``
    tensors) whose tensors are that rank's local shards, on ``device``.
    ``rank`` defaults to this process's rank on an executing mesh, and to
    0 on a description; on a one-device mesh the blocks are the whole
    state."""
    from repro_torch.launch.mesh import coords_of, local_shard
    from repro_torch.sharding.specs import train_state_specs
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.trees import tree_map

    if rank is None:
        rank = new_mesh.rank if new_mesh.rank is not None else 0
    coords = coords_of(rank, new_mesh)
    dev = resolve_device(device)
    specs = train_state_specs(state_template, run.model, run.parallel,
                              new_mesh)
    whole = ckpt.restore(step, state_template, device="cpu")

    def block(leaf, spec):
        if isinstance(leaf, int):
            return leaf
        return local_shard(leaf, spec, new_mesh, coords).to(
            dev, copy=True).contiguous()

    return tree_map(block, whole, specs)


def adjust_run_for_devices(run: RunConfig, num_devices: int) -> RunConfig:
    """Rescale the mesh (and microbatching if needed) to `num_devices`."""
    tp = run.parallel.tp
    data, model = viable_mesh_shape(num_devices, tp)
    mesh = MeshConfig(shape=(data, model), axes=("data", "model"))
    par = run.parallel
    if par.tp != model:
        par = par.replace(tp=model)
    # keep the global batch: if the new data size no longer divides it,
    # increase microbatching
    gb = run.shape.global_batch
    micro = par.microbatch
    while gb % (data * micro) != 0 and micro < gb:
        micro *= 2
    if gb % (data * micro) != 0:
        # doubling can walk past every valid microbatch (e.g. data=3,
        # global_batch=32): surface it instead of returning a RunConfig
        # whose validate() would reject the batch split
        raise ValueError(
            f"cannot preserve global_batch={gb} on {num_devices} devices: "
            f"no power-of-two microbatch makes it divisible by "
            f"data={data} x microbatch")
    if micro != par.microbatch:
        par = par.replace(microbatch=micro)
    return run.replace(mesh=mesh, parallel=par)
