"""Plain PyTorch Mamba-1 selective scan — the port of
:mod:`repro.kernels.mamba_scan.ref`, and the plain version beside the CUDA
kernel in :mod:`.kernel`.

Recurrence (per batch, per channel c, state dim n):
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = sum_n C_t[n] * h_t[n] + D * x_t

PyTorch has no ``lax.associative_scan``.  Inside a chunk this version runs
a log-step (Hillis–Steele) inclusive scan with the reference's ``combine``,
``(a1, b1), (a2, b2) -> (a2 a1, a2 b1 + b2)``: ceil(log2(chunk)) rounds of
whole-tensor products, so it stays a few large launches on the GPU (where
it runs inside the recompute backward of :mod:`repro_torch.kernels.ops`)
instead of a launch per time step.  The chunks run in sequence, carrying
the (B, C, N) state, as in the reference.  All math is fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = 0``)
    along axis 1, Hillis–Steele.  Returns (prod of a up to t, h_t)."""
    k, n = 1, a.shape[1]
    while k < n:
        a_hi, b_hi = a[:, k:], b[:, k:]
        b = torch.cat([b[:, :k], a_hi * b[:, :-k] + b_hi], dim=1)
        a = torch.cat([a[:, :k], a_hi * a[:, :-k]], dim=1)
        k *= 2
    return a, b


def _terms(x, dt, A, Bmat):
    """Decays exp(dt*A) and inputs dt*x*B, both (B, L, C, N) fp32."""
    dtf = dt.to(torch.float32)
    dA = torch.exp(dtf[..., None] * A.to(torch.float32))
    dBx = (dtf * x.to(torch.float32))[..., None] \
        * Bmat.to(torch.float32)[:, :, None, :]
    return dA, dBx


def selective_scan_ref(
    x: torch.Tensor,     # (B, L, C)  channels = d_inner
    dt: torch.Tensor,    # (B, L, C)  softplus-activated step sizes
    A: torch.Tensor,     # (C, N)     negative
    Bmat: torch.Tensor,  # (B, L, N)
    Cmat: torch.Tensor,  # (B, L, N)
    D: torch.Tensor,     # (C,)
) -> torch.Tensor:
    """Returns y: (B, L, C) in x's dtype; one scan over the whole length."""
    _, h = linear_scan(*_terms(x, dt, A, Bmat))
    y = torch.einsum("blcn,bln->blc", h, Cmat.to(torch.float32))
    y = y + x.to(torch.float32) * D.to(torch.float32)[None, None, :]
    return y.to(x.dtype)


def _chunk_step(h0, xc, dtc, A, Bc, Cc):
    a_all, h_local = linear_scan(*_terms(xc, dtc, A, Bc))
    # fold in the carried state: h_t = h_local_t + (prod of decays) * h0
    h_full = h_local + a_all * h0[:, None]
    y = torch.einsum("blcn,bln->blc", h_full, Cc.to(torch.float32))
    return h_full[:, -1], y


def selective_scan_chunked_ref(x, dt, A, Bmat, Cmat, D, chunk: int = 256,
                               return_state: bool = False):
    """Chunked variant: sequential over chunks, scan inside.

    Matches :func:`selective_scan_ref`; memory O(B * chunk * C * N).  With
    ``return_state`` also returns the final state (B, C, N) fp32 (the
    zero-padded tail has dt = 0, so it leaves the state alone).  Under
    autograd each chunk is checkpointed, as the reference's
    ``jax.checkpoint(chunk_step)``: the backward keeps only the (B, C, N)
    chunk-entry states and recomputes each chunk's (chunk, C, N) terms.
    """
    b, l, c = x.shape
    n = A.shape[1]
    pad = (-l) % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bmat, Cmat = F.pad(Bmat, (0, 0, 0, pad)), F.pad(Cmat, (0, 0, 0, pad))
    grad = torch.is_grad_enabled()
    h = torch.zeros((b, c, n), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, l + pad, chunk):
        args = (h, x[:, t0:t0 + chunk], dt[:, t0:t0 + chunk], A,
                Bmat[:, t0:t0 + chunk], Cmat[:, t0:t0 + chunk])
        if grad:
            h, y = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            h, y = _chunk_step(*args)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :l]
    y = y + x[:, :l].to(torch.float32) * D.to(torch.float32)[None, None, :]
    y = y.to(x.dtype)
    if return_state:
        return y, h
    return y


def selective_scan_step_ref(h, x_t, dt_t, A, B_t, C_t, D):
    """Single decode step.  h: (B, C, N); x_t, dt_t: (B, C); B_t, C_t:
    (B, N).  Returns (h_new fp32, y_t: (B, C) in x_t's dtype)."""
    dtf = dt_t.to(torch.float32)
    dA = torch.exp(dtf[..., None] * A.to(torch.float32))
    dBx = (dtf * x_t.to(torch.float32))[..., None] \
        * B_t.to(torch.float32)[:, None, :]
    h_new = dA * h.to(torch.float32) + dBx
    y = torch.einsum("bcn,bn->bc", h_new, C_t.to(torch.float32))
    y = y + x_t.to(torch.float32) * D.to(torch.float32)[None, :]
    return h_new, y.to(x_t.dtype)
