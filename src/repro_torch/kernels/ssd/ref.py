"""Plain PyTorch Mamba-2 SSD (state-space duality, chunked) — the port of
:mod:`repro.kernels.ssd.ref`, and the plain version beside the CUDA kernel
in :mod:`.kernel`.

Semantics (per head h, scalar decay per head per step):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t^T      (state: (N, P))
    y_t = C_t^T h_t + D_h * x_t

The chunked decomposition of the reference: an intra-chunk quadratic term,
chunk-final states, a recurrence over chunk states, and the inter-chunk
output.  Where the reference runs the chunk-state recurrence with
``lax.associative_scan``, this version loops over the chunks in order
(there are L / chunk of them), starting from ``init_state`` or zeros.
All math is fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """S[i, j] = sum_{k=j+1..i} log_a[k] on and below the diagonal, -inf
    above it.  log_a: (..., L) -> (..., L, L)."""
    n = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, s, torch.full_like(s, float("-inf")))


def ssd_ref(
    x: torch.Tensor,     # (B, L, H, P)   head channels
    dt: torch.Tensor,    # (B, L, H)      positive step sizes
    A: torch.Tensor,     # (H,)           negative scalars
    Bmat: torch.Tensor,  # (B, L, G, N)   G groups (G divides H)
    Cmat: torch.Tensor,  # (B, L, G, N)
    D: torch.Tensor,     # (H,)
    chunk: int = 64,
    init_state: Optional[torch.Tensor] = None,  # (B, H, N, P)
    return_state: bool = False,
):
    """Returns y: (B, L, H, P) in x's dtype (and the final state (B, H, N,
    P) fp32 if requested)."""
    b, l, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    rep = h // g
    orig_l = l
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
        l = x.shape[1]
    nc = l // chunk
    f32 = torch.float32

    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(b, nc, chunk, h)
    Bh = torch.repeat_interleave(Bmat.to(f32).reshape(b, nc, chunk, g, n),
                                 rep, dim=3)  # (b, nc, c, h, n)
    Ch = torch.repeat_interleave(Cmat.to(f32).reshape(b, nc, chunk, g, n),
                                 rep, dim=3)

    log_a = dtf * A.to(f32)[None, None, None, :]  # (b, nc, c, h) <= 0
    xdt = xf * dtf[..., None]

    # 1) intra-chunk (quadratic) term
    L_mat = torch.exp(_segsum(log_a.permute(0, 1, 3, 2)))  # (b, nc, h, c, c)
    scores = torch.einsum("bzchn,bzshn->bzhcs", Ch, Bh)
    y_diag = torch.einsum("bzhcs,bzshp->bzchp", scores * L_mat, xdt)

    # 2) chunk-final states: S_z = sum_s a(end..s) * B_s x_s^T
    cum = torch.cumsum(log_a, dim=2)
    a_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, c, h)
    states = torch.einsum("bzshn,bzshp->bzhnp", Bh * a_end[..., None], xdt)

    # 3) recurrence over chunk states, in order
    a_chunk = torch.exp(torch.sum(log_a, dim=2))  # (b, nc, h)
    s = (torch.zeros((b, h, n, p), dtype=f32, device=x.device)
         if init_state is None else init_state.to(f32))
    prev = []  # the state entering each chunk
    for z in range(nc):
        prev.append(s)
        s = s * a_chunk[:, z, :, None, None] + states[:, z]
    prev = torch.stack(prev, dim=1)  # (b, nc, h, n, p)

    # 4) inter-chunk output: C_t^T (a(chunk start..t) * entering state)
    a_start = torch.exp(cum)
    y_off = torch.einsum("bzchn,bzhnp->bzchp", Ch * a_start[..., None], prev)

    y = (y_diag + y_off).reshape(b, l, h, p)[:, :orig_l]
    y = y + x[:, :orig_l].to(f32) * D.to(f32)[None, None, :, None]
    y = y.to(x.dtype)
    if return_state:
        return y, s
    return y


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _split(t: torch.Tensor) -> torch.Tensor:
    """An fp32 operand as the kernel feeds it to the tensor cores: a bf16
    high part plus the bf16 rounding of the rest."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def ssd_tensor_core_ref(x, dt, A, Bmat, Cmat, D, chunk: int = 64):
    """The tensor-core SSD kernel's arithmetic in plain PyTorch: the same
    chunked decomposition as :func:`ssd_ref`, rounded to bf16 exactly where
    the kernel (``ssd_mma_kernel`` in ``csrc/ssd.cu``) feeds an MMA, with
    the chunk states chained in order.  An operand the kernel computes in
    fp32 enters as split(v) = hi + lo, hi = bf16(v), lo = bf16(v - hi).
    Per chunk, fp32 unless said:

    - M = split(<C_t, B_s> exp(cum_t - cum_s) dt_s) for s <= t, else 0;
      y = M x;
    - S_z = split(B_s exp(cum_end - cum_s) dt_s)^T x;
    - S_out = exp(cum_end) S_in + S_z, in order over the chunks;
    - y += exp(cum_t) C_t split(S_in);
    - y += D x, stored in x's dtype.

    x, B and C are taken as the kernel takes them (bf16 values); it
    differs from the kernel only by the order of its fp32 sums and its
    exponentials.  Holds the kernel's precision budget against
    :func:`ssd_ref` on the CPU, and the kernel to it on the card."""
    b, l, h, p = x.shape
    g, n = Bmat.shape[2], Bmat.shape[3]
    rep = h // g
    orig_l = l
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
        l = x.shape[1]
    nc = l // chunk
    f32 = torch.float32
    # (b, h, nc, c, .) per head
    xf = x.to(f32).reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    dtf = dt.to(f32).reshape(b, nc, chunk, h).permute(0, 3, 1, 2)
    Bh = torch.repeat_interleave(Bmat.to(f32).reshape(b, nc, chunk, g, n),
                                 rep, dim=3).permute(0, 3, 1, 2, 4)
    Ch = torch.repeat_interleave(Cmat.to(f32).reshape(b, nc, chunk, g, n),
                                 rep, dim=3).permute(0, 3, 1, 2, 4)
    cum = torch.cumsum(dtf * A.to(f32)[None, :, None, None], dim=-1)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    seg = torch.where(tri, cum[..., :, None] - cum[..., None, :],
                      torch.zeros((), dtype=f32, device=x.device))
    scores = Ch @ Bh.transpose(-1, -2)
    M = torch.where(tri, _split(scores * torch.exp(seg) * dtf[..., None, :]),
                    torch.zeros((), dtype=f32, device=x.device))
    y = M @ xf
    cum_end = cum[..., -1:]
    w = torch.exp(cum_end - cum) * dtf
    states = _split(Bh * w[..., None]).transpose(-1, -2) @ xf  # (b, h, nc, n, p)
    decay = torch.exp(cum_end[..., 0])  # (b, h, nc)
    s = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    prev = []
    for z in range(nc):
        prev.append(s)
        s = decay[:, :, z, None, None] * s + states[:, :, z]
    s_in = torch.stack(prev, dim=2)  # (b, h, nc, n, p)
    y = y + torch.exp(cum)[..., None] * (Ch @ _split(s_in))
    y = y + xf * D.to(f32)[None, :, None, None, None]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, l, h, p)[:, :orig_l]
    return y.to(x.dtype)


def ssd_step_ref(state, x_t, dt_t, A, B_t, C_t, D):
    """Single decode step.  state: (B, H, N, P); x_t: (B, H, P); dt_t:
    (B, H); B_t/C_t: (B, G, N).  Returns (state_new fp32, y_t: (B, H, P))."""
    hh = state.shape[1]
    rep = hh // B_t.shape[1]
    f32 = torch.float32
    Bh = torch.repeat_interleave(B_t, rep, dim=1).to(f32)  # (B, H, N)
    Ch = torch.repeat_interleave(C_t, rep, dim=1).to(f32)
    dtf = dt_t.to(f32)
    a = torch.exp(dtf * A.to(f32)[None, :])  # (B, H)
    xdt = x_t.to(f32) * dtf[..., None]  # (B, H, P)
    new_state = state.to(f32) * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh, xdt)
    y = torch.einsum("bhn,bhnp->bhp", Ch, new_state)
    y = y + x_t.to(f32) * D.to(f32)[None, :, None]
    return new_state, y.to(x_t.dtype)
