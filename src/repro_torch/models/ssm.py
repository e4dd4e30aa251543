"""State-space blocks: Mamba-1 (falcon-mamba) and Mamba-2 (zamba2) — the
port of :mod:`repro.models.ssm`.

Both have a sequence form (training and prefill, dispatching to the scan /
SSD ops) and a recurrent single-step form (decode) with explicit carried
state.  Projections are separate matrices (x, z, B, C, dt), as in the
reference.  ``A_log``, ``dt_bias`` and ``D`` are fp32 whatever the model's
dtype, as there.

The depthwise causal convolution keeps the reference's fp32 loop over the
taps (:func:`_causal_conv_seq`): ``F.conv1d`` in fp32 would go through
cuDNN, which computes in TF32 by default.  Initializers draw the
reference's distributions from a ``torch.Generator`` (not the same
numbers; parity tests import the reference's parameters).

Tensor parallelism (a :class:`~repro_torch.sharding.layout.Scope`
``sc``) splits ``d_inner`` — Mamba-1's channels, Mamba-2's heads — over
the model axis: the scan and the SSD run on the rank's share.  What every
rank computes whole and feeds the split channels (Mamba-1's ``w_bcdt``
sums, Mamba-2's ``B`` / ``C`` / ``dt`` / ``A``) enters through
``sc.enter`` or an all-reduce both ways, so the replicated weights'
gradients sum every channel's share; Mamba-2's gated norm all-reduces its
sums of squares over the whole ``d_inner``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init
from repro_torch.sharding.layout import LOCAL, Scope
from repro_torch.utils.config import ModelConfig


class MambaState(NamedTuple):
    """Decode state for one mamba block."""
    conv: torch.Tensor  # (B, K-1, conv_channels) last inputs of the conv
    ssm: torch.Tensor   # mamba1: (B, C, N); mamba2: (B, H, N, P), fp32


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def _causal_conv_seq(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d in fp32.  x: (B, L, C); w: (K, C); b: (C,)."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + l, :].to(torch.float32) * w[i].to(torch.float32)
    return (out + b.to(torch.float32)).to(x.dtype)


def _causal_conv_step(state: torch.Tensor, x_t: torch.Tensor,
                      w: torch.Tensor, b: torch.Tensor):
    """state: (B, K-1, C); x_t: (B, C).  Returns (new_state, y_t)."""
    window = torch.cat([state, x_t[:, None, :]], dim=1)  # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                     w.to(torch.float32))
    y = (y + b.to(torch.float32)).to(x_t.dtype)
    return window[:, 1:], y


def _conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """Last k-1 inputs of the sequence, zero-padded on the left — the decode
    conv state after prefilling with ``x`` (B, S, C)."""
    xp = F.pad(x, (0, 0, k - 1, 0))
    return xp[:, xp.shape[1] - (k - 1):, :]


def _dt_softplus_init(gen, shape: Tuple[int, ...], device) -> torch.Tensor:
    """Inverse softplus of dt drawn log-uniformly in [1e-3, 1e-1]."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return dt + torch.log1p(-torch.exp(-dt))


def _conv_init(gen, k: int, ch: int, dtype, device, lead) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(lead + (k, ch), dtype=dtype, device=device)
    w = torch.randn(lead + (k, ch), generator=gen, dtype=torch.float32,
                    device=device)
    return (w / math.sqrt(k)).to(dtype)


# --------------------------------------------------------------------------
# Mamba-1
# --------------------------------------------------------------------------

def init_mamba1(gen, cfg: ModelConfig, dtype, device,
                lead: Tuple[int, ...] = ()) -> Dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    n, rank, k = cfg.ssm_state, _dt_rank(cfg), cfg.ssm_conv
    f32 = torch.float32
    a = torch.arange(1, n + 1, dtype=f32, device=device)
    return {
        "w_x": dense_init(gen, cfg.d_model, d_inner, dtype, device, lead),
        "w_z": dense_init(gen, cfg.d_model, d_inner, dtype, device, lead),
        "conv_w": _conv_init(gen, k, d_inner, dtype, device, lead),
        "conv_b": torch.zeros(lead + (d_inner,), dtype=dtype, device=device),
        "w_bcdt": dense_init(gen, d_inner, rank + 2 * n, dtype, device, lead),
        "w_dt": dense_init(gen, rank, d_inner, dtype, device, lead),
        "dt_bias": _dt_softplus_init(gen, lead + (d_inner,), device),
        # stored as log(-A), fp32
        "A_log": torch.log(a).expand(lead + (d_inner, n)).clone(),
        "D": torch.ones(lead + (d_inner,), dtype=f32, device=device),
        "w_out": dense_init(gen, d_inner, cfg.d_model, dtype, device, lead),
    }


def _split(sc: Scope, cols, rows, vecs) -> bool:
    """Whether the model axis splits the mixer's channels: ``cols`` on
    their last dim, ``rows`` on their first, ``vecs`` on their first, all
    of them or none."""
    dims = ([sc.model_dim(n) for n in cols], [sc.model_dim(n) for n in rows],
            [sc.model_dim(n) for n in vecs])
    whole = all(d is None for part in dims for d in part)
    if whole:
        return False
    if dims != ([1] * len(cols), [0] * len(rows), [0] * len(vecs)):
        raise ValueError(f"mixer at {sc.prefix}: {cols}, {rows}, {vecs} "
                         f"split on {dims}: the channels split all or none")
    return True


def apply_mamba1(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[MambaState] = None, decode: bool = False,
                 return_state: bool = False, sc: Scope = LOCAL
                 ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    n, rank = cfg.ssm_state, _dt_rank(cfg)
    split = _split(sc, ("w_x", "w_z", "conv_w", "w_dt"),
                   ("w_bcdt", "w_out", "A_log"), ("conv_b", "dt_bias", "D"))
    x = sc.gather_in(x, split)  # the conv and the scan need the sequence
    xi = x @ p["w_x"]
    z = x @ p["w_z"]
    A = -torch.exp(p["A_log"])

    if decode:
        assert state is not None and x.shape[1] == 1
        conv_state, y_t = _causal_conv_step(state.conv, xi[:, 0],
                                            p["conv_w"], p["conv_b"])
        u = F.silu(y_t)  # (B, C)
        xdbc = u @ p["w_bcdt"]
        if split:
            xdbc = sc.all_reduce(xdbc)
        dt_low, Bc, Cc = (xdbc[..., :rank], xdbc[..., rank:rank + n],
                          xdbc[..., rank + n:])
        dt = F.softplus(dt_low @ p["w_dt"] + p["dt_bias"][None, :])
        ssm_state, y = ops.selective_scan_step(state.ssm, u, dt, A, Bc, Cc,
                                               p["D"])
        y = y * F.silu(z[:, 0])
        out = sc.leave_out((y @ p["w_out"])[:, None, :], split)
        return out, MambaState(conv_state, ssm_state)

    u = F.silu(_causal_conv_seq(xi, p["conv_w"], p["conv_b"]))
    xdbc = u @ p["w_bcdt"]
    if split:  # partial sums over the channels; every consumer is split
        xdbc = sc.all_reduce(xdbc)
    dt_low, Bc, Cc = (xdbc[..., :rank], xdbc[..., rank:rank + n],
                      xdbc[..., rank + n:])
    dt = F.softplus(dt_low @ p["w_dt"] + p["dt_bias"][None, None, :])
    new_state = None
    if return_state:
        y, h_final = ops.selective_scan(u, dt, A, Bc, Cc, p["D"],
                                        chunk=cfg.ssm_chunk,
                                        return_state=True)
        new_state = MambaState(_conv_tail(xi, cfg.ssm_conv), h_final)
    else:
        y = ops.selective_scan(u, dt, A, Bc, Cc, p["D"], chunk=cfg.ssm_chunk)
    y = y * F.silu(z)
    return sc.leave_out(y @ p["w_out"], split), new_state


def _local(sc: Scope, n: int) -> int:
    """``n`` channels or heads, this rank's share where the model axis
    splits the mixer (``sc``)."""
    return n // sc.model.size if sc.model_dim("w_x") == 1 else n


def init_mamba1_state(cfg: ModelConfig, batch: int, dtype, device,
                      lead: Tuple[int, ...] = (), sc: Scope = LOCAL
                      ) -> MambaState:
    """The decode state at the rank's channels under a model split
    (``sc``: the mixer's scope)."""
    d_inner = _local(sc, cfg.ssm_expand * cfg.d_model)
    return MambaState(
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, d_inner),
                         dtype=dtype, device=device),
        ssm=torch.zeros(lead + (batch, d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=device),
    )


# --------------------------------------------------------------------------
# Mamba-2
# --------------------------------------------------------------------------

def _m2_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = cfg.ssm_num_heads
    return d_inner, heads, d_inner // heads, 1  # groups = 1


def init_mamba2(gen, cfg: ModelConfig, dtype, device,
                lead: Tuple[int, ...] = ()) -> Dict:
    d_inner, heads, _, g = _m2_dims(cfg)
    n, k = cfg.ssm_state, cfg.ssm_conv
    f32 = torch.float32
    return {
        "w_z": dense_init(gen, cfg.d_model, d_inner, dtype, device, lead),
        "w_x": dense_init(gen, cfg.d_model, d_inner, dtype, device, lead),
        "w_B": dense_init(gen, cfg.d_model, g * n, dtype, device, lead),
        "w_C": dense_init(gen, cfg.d_model, g * n, dtype, device, lead),
        "w_dtp": dense_init(gen, cfg.d_model, heads, dtype, device, lead),
        "conv_x_w": _conv_init(gen, k, d_inner, dtype, device, lead),
        "conv_x_b": torch.zeros(lead + (d_inner,), dtype=dtype,
                                device=device),
        "conv_bc_w": _conv_init(gen, k, 2 * g * n, dtype, device, lead),
        "conv_bc_b": torch.zeros(lead + (2 * g * n,), dtype=dtype,
                                 device=device),
        "dt_bias": _dt_softplus_init(gen, lead + (heads,), device),
        "A_log": torch.log(torch.arange(1, heads + 1, dtype=f32,
                                        device=device)
                           ).expand(lead + (heads,)).clone(),
        "D": torch.ones(lead + (heads,), dtype=f32, device=device),
        "norm_scale": torch.ones(lead + (d_inner,), dtype=dtype,
                                 device=device),
        "w_out": dense_init(gen, d_inner, cfg.d_model, dtype, device, lead),
    }


def apply_mamba2(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[MambaState] = None, decode: bool = False,
                 return_state: bool = False, sc: Scope = LOCAL
                 ) -> Tuple[torch.Tensor, Optional[MambaState]]:
    d_whole, heads_whole, head_dim, g = _m2_dims(cfg)
    n = cfg.ssm_state
    split = _split(sc, ("w_z", "w_x", "conv_x_w"), ("w_out",),
                   ("conv_x_b", "dt_bias", "D", "norm_scale"))
    # the whole sequence for the conv and the SSD; its gradient is
    # complete (``xe`` enters the split channels, and B / C / dt enter
    # below), so a sequence gather takes the rank's slice back
    x = sc.gather_in(x, False)
    b, s, _ = x.shape
    xe = sc.enter(x) if split else x
    z = xe @ p["w_z"]
    xi = xe @ p["w_x"]
    bc = torch.cat([x @ p["w_B"], x @ p["w_C"]], dim=-1)
    dt_raw = x @ p["w_dtp"]
    A = -torch.exp(p["A_log"])
    d_inner, heads = d_whole, heads_whole
    if split:  # the heads of this rank; B / C enter below, after the conv
        heads = p["D"].shape[-1]
        d_inner = heads * head_dim
        dt_raw = sc.local(sc.enter(dt_raw), -1, heads_whole)
        A = sc.local(sc.enter(A), 0, heads_whole)

    if decode:
        assert state is not None and s == 1
        cs_x, cs_bc = state.conv[..., :d_inner], state.conv[..., d_inner:]
        cs_x, x_t = _causal_conv_step(cs_x, xi[:, 0], p["conv_x_w"],
                                      p["conv_x_b"])
        cs_bc, bc_t = _causal_conv_step(cs_bc, bc[:, 0], p["conv_bc_w"],
                                        p["conv_bc_b"])
        x_t = F.silu(x_t).reshape(b, heads, head_dim)
        bc_t = F.silu(bc_t)
        Bt = bc_t[..., :g * n].reshape(b, g, n)
        Ct = bc_t[..., g * n:].reshape(b, g, n)
        dt = F.softplus(dt_raw[:, 0] + p["dt_bias"][None, :])  # (B, H)
        ssm_state, y = ops.ssd_step(state.ssm, x_t, dt, A, Bt, Ct, p["D"])
        y = _gated_rmsnorm(y.reshape(b, d_inner), z[:, 0], p["norm_scale"],
                           cfg.norm_eps, sc if split else None, d_whole)
        out = sc.leave_out((y @ p["w_out"])[:, None, :], split)
        return out, MambaState(torch.cat([cs_x, cs_bc], -1), ssm_state)

    xs_ = F.silu(_causal_conv_seq(xi, p["conv_x_w"], p["conv_x_b"]))
    bcs = F.silu(_causal_conv_seq(bc, p["conv_bc_w"], p["conv_bc_b"]))
    if split:
        bcs = sc.enter(bcs)
    xs_ = xs_.reshape(b, s, heads, head_dim)
    Bs = bcs[..., :g * n].reshape(b, s, g, n)
    Cs = bcs[..., g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw + p["dt_bias"][None, None, :])  # (B, S, H)
    new_state = None
    if return_state:
        y, ssm_final = ops.ssd(xs_, dt, A, Bs, Cs, p["D"],
                               chunk=cfg.ssm_chunk, return_state=True)
        conv_tail = _conv_tail(torch.cat([xi, bc], -1), cfg.ssm_conv)
        new_state = MambaState(conv_tail, ssm_final)
    else:
        y = ops.ssd(xs_, dt, A, Bs, Cs, p["D"], chunk=cfg.ssm_chunk)
    y = _gated_rmsnorm(y.reshape(b, s, d_inner), z, p["norm_scale"],
                       cfg.norm_eps, sc if split else None, d_whole)
    return sc.leave_out(y @ p["w_out"], split), new_state


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float, sc: Optional[Scope] = None,
                   width: int = 0) -> torch.Tensor:
    """The reference's norm over the whole ``d_inner``; with ``sc`` the
    channels are this rank's share of ``width`` and the sums of squares
    are all-reduced over the model axis."""
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    if sc is None:
        var = torch.mean(torch.square(yf), dim=-1, keepdim=True)
    else:
        var = sc.all_reduce(torch.sum(torch.square(yf), dim=-1,
                                      keepdim=True)) / width
    return (yf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(y.dtype)


def init_mamba2_state(cfg: ModelConfig, batch: int, dtype, device,
                      lead: Tuple[int, ...] = (), sc: Scope = LOCAL
                      ) -> MambaState:
    """The decode state at the rank's heads under a model split (``sc``:
    the mixer's scope)."""
    _, heads, head_dim, g = _m2_dims(cfg)
    heads = _local(sc, heads)
    d_inner = heads * head_dim
    conv_ch = d_inner + 2 * g * cfg.ssm_state
    return MambaState(
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_ch),
                         dtype=dtype, device=device),
        ssm=torch.zeros(lead + (batch, heads, cfg.ssm_state, head_dim),
                        dtype=torch.float32, device=device),
    )
