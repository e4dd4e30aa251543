"""Elastic re-meshing — the part the fleet simulator uses so far: the
(data, model) split of a device block.  Restoring a checkpoint onto a new
device mesh comes with the train tooling (checkpoints, a torch device
mesh)."""

from __future__ import annotations

from typing import Tuple


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
