"""Plain float32 reference of a Mamba-1 language model (falcon-mamba-7b's
layer equations as the program defines them).

Per layer, with ``x`` the stream (B, L, d):

    u = silu(causal_conv(rmsnorm(x) @ w_x));  z = rmsnorm(x) @ w_z
    dt_low, B, C = split(u @ w_bcdt, [R, N, N])
    dt = softplus(dt_low @ w_dt + dt_bias);  A = -exp(A_log)
    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t;  y_t = C_t . h_t + D u_t
    x = x + (y * silu(z)) @ w_out

then ``rmsnorm`` and the head.  The recurrence runs step by step over
time (one fused multiply-add a step, for every sequence at once), the
decays and inputs formed a block of steps at a time.  The sequences are
right-padded to one length: every operation is causal, so padding after
a sequence changes none of its positions.  Departures from the
published FalconMamba: it has no RMS norms on B, C and dt (the program
has none).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ref_common import causal_conv, embed, layer, mm, rmsnorm, whole

#: time steps whose decays and inputs are formed at once
TIME_BLOCK = 128


def scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """The selective scan from a zero state.  u, dt: (B, L, C); A: (C, N);
    Bm, Cm: (B, L, N); D: (C,).  Returns y (B, L, C)."""
    b, l, c = u.shape
    n = A.shape[1]
    h = torch.zeros((b, c, n), dtype=torch.float32, device=u.device)
    y = torch.empty_like(u)
    for t0 in range(0, l, TIME_BLOCK):
        t1 = min(t0 + TIME_BLOCK, l)
        # time first, so that each step's operands are contiguous
        dtb = dt[:, t0:t1].transpose(0, 1)
        dA = torch.exp(dtb[..., None] * A)
        dBu = (dtb * u[:, t0:t1].transpose(0, 1))[..., None] \
            * Bm[:, t0:t1].transpose(0, 1)[:, :, None, :]
        hs = torch.empty_like(dA)
        for t in range(t1 - t0):
            h = torch.addcmul(dBu[t], dA[t], h, out=hs[t])
        y[:, t0:t1] = torch.einsum("tbcn,btn->btc", hs, Cm[:, t0:t1])
        del dA, dBu, hs
    return y + u * D


def hidden(params: Dict, sizes: Dict, tokens: torch.Tensor,
           fp8: bool = False) -> torch.Tensor:
    """The final-normed stream (B, L, d) in fp32 of ``tokens`` (B, L),
    layer by layer; ``fp8``: every product as the control computes it."""
    eps, n = float(sizes["norm_eps"]), int(sizes["ssm_state"])
    rank = -(-int(sizes["d_model"]) // 16)
    dtype = getattr(torch, sizes["dtype"])
    x = embed(params["embed"]["embedding"], tokens, dtype)
    blocks = params["blocks"]["sub0"]
    for i in range(int(sizes["num_layers"])):
        p = layer(blocks, i)
        m = p["mixer"]
        xn = rmsnorm(x, p["norm"]["scale"], eps)
        u = F.silu(causal_conv(mm(xn, m["w_x"], fp8), m["conv_w"],
                               m["conv_b"]))
        z = mm(xn, m["w_z"], fp8)
        del xn
        xdbc = mm(u, m["w_bcdt"], fp8)
        dt = F.softplus(mm(xdbc[..., :rank], m["w_dt"], fp8) + m["dt_bias"])
        y = scan(u, dt, -torch.exp(m["A_log"]), xdbc[..., rank:rank + n],
                 xdbc[..., rank + n:], m["D"])
        del u, dt, xdbc
        x = x + mm(y * F.silu(z), m["w_out"], fp8)
        del y, z
    return rmsnorm(x, whole(params["final_norm"])["scale"], eps)
