"""CUDA Mamba-2 SSD wrapper (kernel: ``repro_torch/csrc/ssd.cu``).

Replaces the TPU kernel ``repro/kernels/ssd/kernel.py::ssd_pallas``
(``_ssd_kernel``).  Bound by fp32 operations at zamba2-2.7b's training
shape.  One block per (head, batch) walks the chunks in order with the
(N, P) state in shared memory; per chunk it builds the decayed score tile
(only on and below the diagonal, where the decay cannot overflow), the
chunk's outputs and the next state with fp32 FMAs.  Ragged L is masked,
not padded.

``ssd.chunk`` snaps down into the family's domain (at most 64, so the
Q x Q tile fits beside the state): the config's 256 becomes 64, which
changes only the rounding.  The continuation variants (``init_state``,
``return_state``) are the plain version's, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.ssd.ref import ssd_ref


def smem_bytes(n: int, p: int, q: int) -> int:
    """Shared memory of one block (``ssd_smem`` in the kernel)."""
    return (n * p + q * p + 2 * q * (n + 1) + q * q + 3 * q) * 4


def ssd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor, *,
             chunk: int = 64) -> torch.Tensor:
    """x (B, L, H, P); dt (B, L, H); A, D (H,); Bmat, Cmat (B, L, G, N) ->
    y (B, L, H, P) in x's dtype.  A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, Bmat, Cmat, D, chunk=chunk)
    b, l, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    if dt.shape != (b, l, h) or A.shape != (h,) or D.shape != (h,) \
            or Bmat.shape != (b, l, g, n) or Cmat.shape != Bmat.shape \
            or h % g:
        raise ValueError(
            f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bmat.shape)}, C {tuple(Cmat.shape)}, "
            f"D {tuple(D.shape)}")
    q = dispatch.snap_down(chunk,
                           dispatch.get_family("ssd").option("chunk").values)
    smem = smem_bytes(n, p, q)
    if smem > cuda_lib.SMEM_LIMIT:
        raise ValueError(f"ssd: {smem} bytes of shared memory (chunk {q}, "
                         f"N {n}, P {p})")
    out_code = cuda_lib.dtype_code(x)
    xs, dts, bs, cs = cuda_lib.one_storage(x, dt, Bmat, Cmat)
    a32 = A.to(torch.float32).contiguous()
    d32 = D.to(torch.float32).contiguous()
    cuda_lib.require("ssd", xs, dts, bs, cs, a32, d32)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    err = cuda_lib.library().repro_ssd(
        xs.data_ptr(), dts.data_ptr(), a32.data_ptr(), bs.data_ptr(),
        cs.data_ptr(), d32.data_ptr(), y.data_ptr(), b, l, h, p, g, n, q,
        cuda_lib.dtype_code(xs), out_code, cuda_lib.stream_of(x))
    cuda_lib.check(err, "ssd")
    cuda_lib.LAUNCHES["ssd"] += 1
    return y
