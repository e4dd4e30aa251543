"""Device resolution for every entry point of the port.

The port runs on the GPU.  An entry point that is handed no device takes
``cuda``; on a host without a CUDA card that raises instead of quietly
running on the CPU.  The CPU is used only when the caller asks for it
(``device="cpu"``), as the parity tests do.  ``meta`` is accepted for
shape-only work (parameter counting).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' explicitly to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued device work (a no-op off the GPU) — the counterpart
    of ``jax.block_until_ready`` around a timed step."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
