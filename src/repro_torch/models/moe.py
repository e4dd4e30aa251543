"""Mixture-of-Experts layer (DeepSeek-V3 / Llama-4 style) — the port of
:mod:`repro.models.moe`.

GShard-style grouped dense dispatch, as in the reference: tokens are split
into routing groups of ``group_size`` tokens (halved until it divides the
token count); within a group one-hot dispatch / combine einsums route at
most ``capacity`` tokens to each expert, in the order of the flattened
``(token, k)`` choices, so the same tokens are dropped.  Top-k softmax
routing (llama4: top-1) or DeepSeek's sigmoid scoring renormalised over
the chosen experts; a shared (always-on) expert; the Switch-style
load-balance auxiliary loss.  The products are ``torch.einsum`` (cuBLAS on
the card), as the reference computes them outside any Pallas kernel; every
expert computes on its ``capacity`` rows, so a step reads every expert's
weights.

The step is graph-safe: the one-hot masks are comparisons with an
``arange`` (no ``F.one_hot``, which reads its input's range on the host),
and the capacity and group size come from shapes alone.

In a sharded train step (``apply_moe``'s ``sc``, a
:class:`~repro_torch.sharding.layout.Scope`) each data rank routes its own
tokens, in the routing groups one process would form over the whole
batch, and the aux loss's mean router probabilities and expert loads are
averaged over the data ranks (with autograd) before their product, as
they are means over the global batch in the reference.  The expert dim of
the expert weights says where the experts run:

- split over the model axis (``moe_expert_axis="model"``): every model
  rank routes the same tokens and runs its experts on them; the tokens
  and the gate weights enter the split (``sc.enter``) and the partial
  combine (with the shared expert's, when its hidden width is split too)
  is all-reduced;
- split over the data axes (``"data"``): the ``(G, E, C, D)`` dispatch
  goes to the experts' ranks by an all-to-all, and the experts' outputs
  come back by a second one (the backward's two run the other way);
  under a model split of the experts' hidden width the experts are
  column / row products as the dense MLP's.

Under sequence parallelism (the scope's ``seq``) ``x`` is the rank's
sequence block: the layer routes the whole sequence, all-gathered first
(so the routing groups and the capacity are those without it; the
gradient of the gathered tokens is complete, through the router's fp32
path and the ``enter`` of the split branches, so the gather's backward
takes the rank's slice), and the output leaves for the block
(:meth:`~repro_torch.sharding.layout.Scope.leave_out`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, init_mlp
from repro_torch.sharding import collectives
from repro_torch.sharding.layout import LOCAL, Scope
from repro_torch.utils.config import ModelConfig

#: experts drawn at a time by :func:`_stack_init`, so the fp32 draw of a
#: stacked expert weight never exists whole (deepseek-v3's ``w_gate`` is
#: 3.8 B values a layer)
_INIT_EXPERTS = 16


def init_moe(gen, cfg: ModelConfig, dtype, device,
             lead: Tuple[int, ...] = ()) -> Dict:
    e, dff = cfg.moe_num_experts, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, cfg.d_model, e, torch.float32, device,
                             lead=lead),
        # expert weights stacked on a leading expert axis
        "w_gate": _stack_init(gen, e, cfg.d_model, dff, dtype, device, lead),
        "w_up": _stack_init(gen, e, cfg.d_model, dff, dtype, device, lead),
        "w_down": _stack_init(gen, e, dff, cfg.d_model, dtype, device, lead),
    }
    if cfg.moe_num_shared > 0:
        p["shared"] = init_mlp(gen, cfg.d_model, dff * cfg.moe_num_shared,
                               "swiglu", dtype, device, lead=lead)
    return p


def _stack_init(gen, e: int, din: int, dout: int, dtype, device,
                lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """``lead + (e, din, dout)`` drawn from the truncated normal on [-2, 2]
    scaled by ``din ** -0.5`` (the reference's distribution), written into
    a tensor of ``dtype`` :data:`_INIT_EXPERTS` experts of one layer at a
    time, each block drawn in fp32 and scaled in place."""
    out = torch.empty(lead + (e, din, dout), dtype=dtype, device=device)
    if out.device.type == "meta":  # shape-only (parameter counting)
        return out
    flat = out.view(-1, e, din, dout)
    block = torch.empty((min(e, _INIT_EXPERTS), din, dout),
                        dtype=torch.float32, device=device)
    for layer in flat:
        for i in range(0, e, block.shape[0]):
            part = block[:min(block.shape[0], e - i)]
            torch.nn.init.trunc_normal_(part, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            part.mul_(din ** -0.5)
            layer[i:i + part.shape[0]].copy_(part)
    return out


def _group_size(t: int, group_size: int) -> int:
    """The reference's routing group: ``group_size`` capped at the token
    count, halved until it divides it."""
    tg = min(group_size, t)
    while t % tg != 0:
        tg //= 2
    return tg


def capacity(cfg: ModelConfig, tg: int, dropless: bool) -> int:
    """Per-group slots an expert takes: ``tg`` when ``dropless``, else
    ``max(1, int(tg * k * capacity_factor / E))`` capped at ``tg``."""
    if dropless:
        return tg
    c = max(1, int(tg * cfg.moe_top_k * cfg.moe_capacity_factor
                   / cfg.moe_num_experts))
    return min(c, tg)


def queue_positions(top_idx: torch.Tensor, num_experts: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The queue position of each (token, k) choice within its expert, per
    group, in the flattened ``(token, k)`` order: top_idx (G, Tg, k) ->
    (one-hot (G, Tg, k, E) int32, positions (G, Tg, k))."""
    g, tg, k = top_idx.shape
    experts = torch.arange(num_experts, device=top_idx.device)
    onehot = (top_idx[..., None] == experts).to(torch.int32)
    flat = onehot.reshape(g, tg * k, num_experts)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(g, tg, k, num_experts)
    return onehot, (pos * onehot).sum(-1)


def route(p: Dict, tokens: torch.Tensor, k: int, router_mode: str
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on grouped tokens (G, Tg, D): the fp32 router logits
    (G, Tg, E) and the top-k (weights, experts), each (G, Tg, k) — softmax
    scores, or sigmoid scores renormalised over the chosen experts.  The
    router is drawn in fp32, as in the reference; a train step's bf16
    compute copy of it is widened here, as jax promotes it against the
    fp32 tokens."""
    logits = torch.einsum("gtd,de->gte", tokens.to(torch.float32),
                          p["router"].to(torch.float32))
    if router_mode == "sigmoid":  # deepseek-v3 scoring
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(scores, k, dim=-1)
    if router_mode == "sigmoid":
        top_vals = top_vals / (top_vals.sum(-1, keepdim=True) + 1e-20)
    return logits, top_vals, top_idx


def apply_moe(p: Dict, cfg: ModelConfig, x: torch.Tensor,
              router_mode: str = "softmax", group_size: int = 512,
              dropless: bool = False, sc: Scope = LOCAL
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D).  Returns (out, aux_loss).

    ``dropless`` forces capacity = group size (no token dropped), as on
    the decode path: every token then reaches its experts whatever the
    routing groups, so a data rank routes its own tokens in groups of its
    own.  Under a sharded step (``sc`` with data ranks) ``x``
    is this data rank's share of the global batch, and ``x`` the stream
    (the rank's sequence block under the sequence split)."""
    x = sc.gather_in(x, False)
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    t = b * s
    tg = _group_size(t, group_size)
    data = sc.data
    world = data.size if data is not None else 1
    if world > 1 and not dropless and \
            _group_size(t * world, group_size) != tg:
        raise ValueError(
            f"{t} tokens a rank route in groups of {tg}, the batch of "
            f"{world} ranks in groups of "
            f"{_group_size(t * world, group_size)}: a rank's token "
            f"count must be a multiple of the global routing group")
    g = t // tg
    tokens = x.reshape(g, tg, d)

    logits, top_vals, top_idx = route(p, tokens, k, router_mode)
    cap = capacity(cfg, tg, dropless)

    # queue position of each (token, slot) within its expert, per group
    onehot, pos = queue_positions(top_idx, e)
    keep = pos < cap

    gate = top_vals * keep.to(top_vals.dtype)  # dropped slots contribute 0
    slots = torch.arange(cap, device=x.device)
    slot = (pos[..., None] == slots).to(torch.float32)  # (G, Tg, k, C)
    mask = onehot.to(torch.float32) * keep[..., None].to(torch.float32)

    model_experts = sc.model_dim("w_gate") == 0
    data_experts = sc.data_dim("w_gate") == 0
    shared_split = (cfg.moe_num_shared > 0
                    and sc["shared"].model_dim("w_up") == 1)
    xin = tokens
    if model_experts:  # this model rank's experts, on every token
        mask = sc.local(mask, -1, e)
        xin, gate = sc.enter(tokens), sc.enter(gate)
    elif shared_split:
        xin = sc.enter(tokens)
    # (G, Tg, E, C) dispatch / combine tensors
    dispatch = torch.einsum("gtke,gtkc->gtec", mask, slot).to(x.dtype)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", mask, slot,
                           gate.to(torch.float32))

    # route -> expert compute -> unroute
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch,
                             xin if model_experts else tokens)
    if data_experts:  # to the experts' ranks: (n, G, E/n, C, D)
        expert_in = collectives.all_to_all(
            expert_in.unflatten(1, (world, -1)).transpose(0, 1), data)
        expert_in = expert_in.flatten(0, 1)  # (n G, E/n, C, D)
    ffn_split = sc.model_dim("w_gate") == 2
    if ffn_split:
        expert_in = sc.enter(expert_in)
    h_gate = torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"])
    h_up = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"])
    h = F.silu(h_gate) * h_up
    expert_out = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    if ffn_split:
        expert_out = sc.leave(expert_out)
    if data_experts:  # back to the tokens' ranks: (G, E, C, D)
        expert_out = collectives.all_to_all(
            expert_out.unflatten(0, (world, -1)), data)
        expert_out = expert_out.transpose(0, 1).flatten(1, 2)
    out = torch.einsum("gtec,gecd->gtd", combine.to(x.dtype), expert_out)

    # ``out`` is this rank's experts' share when they are on the model axis
    out = out.reshape(b, s, d)
    if cfg.moe_num_shared > 0:
        shared = apply_mlp(p["shared"], xin if shared_split else tokens,
                           "swiglu", sc["shared"], reduce=False
                           ).reshape(b, s, d)
        if shared_split == model_experts:  # one reduction carries both
            out = sc.leave_out(out + shared, model_experts)
        else:
            out = (sc.leave_out(out, model_experts)
                   + sc.leave_out(shared, shared_split))
    else:
        out = sc.leave_out(out, model_experts)

    # load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e
    me = torch.softmax(logits, dim=-1).mean(dim=(0, 1))  # mean router prob
    ce = onehot.to(torch.float32).sum(2).mean(dim=(0, 1)) / k
    if data is not None and torch.is_grad_enabled():
        # means over the global batch (a train step's; serving keeps its
        # rank's own)
        me = collectives.all_reduce(me, data) / world
        ce = collectives.all_reduce(ce, data) / world
    aux = e * torch.sum(me * ce)
    return out, aux
