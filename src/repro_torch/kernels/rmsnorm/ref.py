"""Plain PyTorch RMSNorm (optionally with residual-add) — the port of
:func:`repro.kernels.rmsnorm.ref.rmsnorm_ref`, and the plain version beside
the CUDA kernel in :mod:`.kernel`."""

from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return y.to(x.dtype)
