"""CUDA Mamba-2 SSD wrapper (kernel: ``repro_torch/csrc/ssd.cu``).

Replaces the TPU kernel ``repro/kernels/ssd/kernel.py::ssd_pallas``
(``_ssd_kernel``).  Bound by bytes at zamba2-2.7b's training shape.  Two
routes, picked by :func:`ssd_route` from dtypes, shapes and alignment:

- ``"mma"`` (bf16 x, B and C): the chunks in parallel, one CUDA block of
  eight warps per two consecutive chunks of a (batch, head) pair, each
  chunk's products on the tensor cores (``mma.sync``), the (N, P) state
  handed from block to block inside the one launch through a per-device
  scratch (two fp32 state slots per (batch, head), one flag per block, a
  ticket counter) with an acquire/release flag per link.
  :func:`ref.ssd_tensor_core_ref` rounds where this route rounds.
- ``"simt"`` (fp32, and bf16 shapes the first does not cover): one block
  per (head, batch) walks the chunks in order with the state in shared
  memory, with fp32 FMAs, the decayed score tile only on and below the
  diagonal.

x, B and C are read in their own storage (widened to fp32 together only
when they disagree); dt in its own dtype, so a bf16 model's fp32 dt (from
its fp32 ``dt_bias``) keeps the tensor-core route.  Ragged L is masked,
not padded.  ``ssd.chunk`` snaps down into the family's domain (at most
64): the config's 256 becomes 64, which changes only the rounding.  The
continuation variants (``init_state``, ``return_state``) are the plain
version's, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.ssd.ref import ssd_ref

#: head widths P the tensor-core route is instantiated for
MMA_HEAD_DIMS = (16, 32, 64, 80, 128)
#: the tensor-core route's largest state size N (one 16-row slab per warp)
MMA_MAX_STATE = 64


def smem_bytes(n: int, p: int, q: int) -> int:
    """Shared memory of one block of the SIMT route (``ssd_smem``)."""
    return (n * p + q * p + 2 * q * (n + 1) + q * q + 3 * q) * 4


def ssd_route(x: torch.Tensor, Bmat: torch.Tensor, Cmat: torch.Tensor,
              q: int) -> str:
    """``"mma"`` where the tensor-core kernel takes these tensors (bf16 x,
    B and C, 16-byte-aligned, N a multiple of 16 up to 64, P one of
    :data:`MMA_HEAD_DIMS`, chunk a multiple of 16), else ``"simt"``."""
    n, p = Bmat.shape[-1], x.shape[-1]
    ok = (all(t.dtype == torch.bfloat16 for t in (x, Bmat, Cmat))
          and all(t.data_ptr() % 16 == 0 for t in (x, Bmat, Cmat))
          and n % 16 == 0 and 0 < n <= MMA_MAX_STATE
          and p in MMA_HEAD_DIMS and q % 16 == 0)
    return "mma" if ok else "simt"


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
    out_code = cuda_lib.dtype_code(x)
    xs, bs, cs = cuda_lib.one_storage(x, Bmat, Cmat)
    dts = (dt if dt.dtype in cuda_lib.DTYPE_CODES else dt.float()).contiguous()
    a32 = A.to(torch.float32).contiguous()
    d32 = D.to(torch.float32).contiguous()
    cuda_lib.require("ssd", xs, dts, bs, cs, a32, d32)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    route = ssd_route(xs, bs, cs, q)
    if route == "mma":
        n_chunks = -(-l // q)
        states, flags, ticket = cuda_lib.ssd_scratch(
            x.device, b * h * 2 * n * p, b * h * n_chunks)
        chain = (states.data_ptr(), flags.data_ptr(), ticket.data_ptr(),
                 cuda_lib.next_epoch(x.device))
    else:
        smem = smem_bytes(n, p, q)
        if smem > cuda_lib.SMEM_LIMIT:
            raise ValueError(f"ssd: {smem} bytes of shared memory (chunk "
                             f"{q}, N {n}, P {p})")
        chain = (None, None, None, 0)
    err = cuda_lib.library().repro_ssd(
        xs.data_ptr(), dts.data_ptr(), a32.data_ptr(), bs.data_ptr(),
        cs.data_ptr(), d32.data_ptr(), y.data_ptr(), b, l, h, p, g, n, q,
        cuda_lib.dtype_code(xs), cuda_lib.dtype_code(dts), out_code,
        int(route == "mma"), *chain, cuda_lib.stream_of(x))
    cuda_lib.check(err, "ssd")
    cuda_lib.LAUNCHES["ssd"] += 1
    return y
