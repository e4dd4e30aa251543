"""CUDA Mamba-1 selective-scan wrapper (kernel:
``repro_torch/csrc/selective_scan.cu``).

Replaces the TPU kernel
``repro/kernels/mamba_scan/kernel.py::selective_scan_pallas``
(``_scan_kernel``).  At the training shape the exponentials (B*L*C*N of
them) and the bytes of x, dt and y bound it about equally.  The kernel
runs the sequence loop inside each block with the state in registers:
``lpc`` lanes per channel (4 states each, shuffle-summed for y), ``c_block``
channels per block, ``chunk`` steps of x, dt, B and C staged in shared
memory at a time.  Ragged L and C are masked, not padded.

Launch options snap down into the family's domains (the reference's
TPU-sized ``ssm_chunk`` of 256 becomes 64); the chunk sets only how much
is staged per step, not the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.kernels.mamba_scan.ref import selective_scan_chunked_ref

#: states each lane holds (``kStatesPerLane`` in the kernel)
STATES_PER_LANE = 4


def lanes_per_channel(n: int) -> int:
    """The smallest power of two ``lpc`` with ``lpc * 4 >= n`` (<= 32)."""
    lpc = 1
    while lpc * STATES_PER_LANE < n:
        lpc *= 2
    if lpc > 32:
        raise ValueError(f"selective_scan: state size {n} > "
                         f"{32 * STATES_PER_LANE}")
    return lpc


def launch_geometry(n: int, chunk: int, c_block: int):
    """(lpc, c_block, chunk, shared bytes) the kernel launches with: the
    requested sizes snapped into the family's domains, then ``c_block``
    clamped so a block has a whole number of warps and at most 1024
    threads."""
    fam = dispatch.get_family("mamba_scan")
    chunk = dispatch.snap_down(chunk, fam.option("chunk").values)
    c_block = dispatch.snap_down(c_block, fam.option("c_block").values)
    lpc = lanes_per_channel(n)
    c_block = min(max(c_block, 32 // lpc), 1024 // lpc)
    smem = (3 * chunk * c_block + 2 * chunk * n) * 4
    return lpc, c_block, chunk, smem


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        D: torch.Tensor, *, chunk: int = 64,
                        c_block: int = 64) -> torch.Tensor:
    """x, dt (B, L, C); A (C, N); Bmat, Cmat (B, L, N); D (C,) -> y (B, L,
    C) in x's dtype.  A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return selective_scan_chunked_ref(x, dt, A, Bmat, Cmat, D,
                                          chunk=chunk)
    b, l, c = x.shape
    n = A.shape[1]
    if dt.shape != x.shape or A.shape != (c, n) or D.shape != (c,) \
            or Bmat.shape != (b, l, n) or Cmat.shape != (b, l, n):
        raise ValueError(
            f"selective_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
            f"{tuple(A.shape)}, B {tuple(Bmat.shape)}, C {tuple(Cmat.shape)}, "
            f"D {tuple(D.shape)}")
    lpc, c_block, chunk, smem = launch_geometry(n, chunk, c_block)
    if smem > cuda_lib.SMEM_LIMIT:
        raise ValueError(f"selective_scan: {smem} bytes of shared memory "
                         f"(chunk {chunk}, c_block {c_block}, N {n})")
    out_code = cuda_lib.dtype_code(x)
    xs, dts, bs, cs = cuda_lib.one_storage(x, dt, Bmat, Cmat)
    a32 = A.to(torch.float32).contiguous()
    d32 = D.to(torch.float32).contiguous()
    cuda_lib.require("selective_scan", xs, dts, bs, cs, a32, d32)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    err = cuda_lib.library().repro_selective_scan(
        xs.data_ptr(), dts.data_ptr(), a32.data_ptr(), bs.data_ptr(),
        cs.data_ptr(), d32.data_ptr(), y.data_ptr(), b, l, c, n, lpc,
        c_block, chunk, cuda_lib.dtype_code(xs), out_code,
        cuda_lib.stream_of(x))
    cuda_lib.check(err, "selective_scan")
    cuda_lib.LAUNCHES["selective_scan"] += 1
    return y
