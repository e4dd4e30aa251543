"""CUDA RMSNorm wrapper (kernel: ``repro_torch/csrc/rmsnorm.cu``).

Replaces the TPU kernel ``repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas``
(``_rms_kernel``, ``_rms_res_kernel``).  Bound on the H100 by bytes: a row
is read and written once for a handful of flops per element.  The kernel
gives each row one warp (register sum + warp-shuffle reduction, no shared
memory), with 16-byte vector loads; ``row_block`` rows share a CUDA block.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5,
                 residual: Optional[torch.Tensor] = None,
                 row_block: int = 4) -> torch.Tensor:
    """``rmsnorm(x [+ residual]) * weight`` over the last axis.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps=eps, residual=residual)
    tensors = (x, weight) + ((residual,) if residual is not None else ())
    cuda_lib.require("rmsnorm", *tensors, dtype=x.dtype)
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} != ({d},)")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"rmsnorm: residual {tuple(residual.shape)} != "
                         f"x {tuple(x.shape)}")
    y = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    vec = 16 // x.element_size()
    vectorized = int(d % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors + (y,)))
    row_block = dispatch.snap_down(
        row_block, dispatch.get_family("rmsnorm").option("row_block").values)
    err = cuda_lib.library().repro_rmsnorm(
        x.data_ptr(), residual.data_ptr() if residual is not None else None,
        weight.data_ptr(), y.data_ptr(), rows, d, eps, cuda_lib.dtype_code(x),
        row_block, vectorized, cuda_lib.stream_of(x))
    cuda_lib.check(err, "rmsnorm")
    cuda_lib.LAUNCHES["rmsnorm"] += 1
    return y
