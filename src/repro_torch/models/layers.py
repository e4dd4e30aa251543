"""Shared layers: norms, rotary embeddings, MLP variants, embedding/head —
the port of :mod:`repro.models.layers`.

Functional as in the reference: ``init_*`` returns a dict of tensors, the
apply functions take (params, activations).  Weights keep the reference's
``(in, out)`` layout and are applied as ``x @ w``; the tied head is
``h @ embedding.T``.  Initializers draw the reference's distributions
(truncated normal on [-2, 2], fan-in scaled) from an explicit
``torch.Generator`` — the same distributions, not the same numbers, since
``jax.random`` cannot be reproduced; parity tests import the reference's
parameters instead (:mod:`repro_torch.models.interop`).  ``lead`` prepends
axes (the stacked layer axis) to a parameter's shape.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def _trunc_normal(shape: Tuple[int, ...], gen: Optional[torch.Generator],
                  dtype: torch.dtype, device: torch.device,
                  scale: float = 1.0) -> torch.Tensor:
    if device.type == "meta":  # shape-only (parameter counting)
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device,
               lead: Tuple[int, ...] = ()):
    return _trunc_normal(lead + (in_dim, out_dim), gen, dtype, device,
                         1.0 / math.sqrt(in_dim))


def embed_init(gen, vocab: int, dim: int, dtype, device):
    return _trunc_normal((vocab, dim), gen, dtype, device)


# -- RMSNorm ---------------------------------------------------------------

def init_rmsnorm(dim: int, dtype, device, lead: Tuple[int, ...] = ()) -> Dict:
    return {"scale": torch.ones(lead + (dim,), dtype=dtype, device=device)}


def apply_rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, p["scale"], eps=eps)


# -- Rotary ----------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with even D; positions: (S,) or (B, S).  Split
    halves (not interleaved pairs), computed in fp32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)  # (D/2,)
    if positions.ndim == 1:
        angles = positions[:, None].to(torch.float32) * freqs[None, :]
        angles = angles[None, :, None, :]  # (1, S, 1, D/2)
    else:
        angles = positions[..., None].to(torch.float32) * freqs  # (B, S, D/2)
        angles = angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLP variants ----------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, mlp_type: str, dtype, device,
             lead: Tuple[int, ...] = ()) -> Dict:
    if mlp_type == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device, lead=lead),
        }
    # relu2 (squared ReLU) and gelu share a 2-matrix shape
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device, lead=lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device, lead=lead),
    }


def apply_mlp(p: Dict, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif mlp_type == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
    else:  # gelu — jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["w_up"], approximate="tanh")
    return h @ p["w_down"]


# -- Embedding + LM head ---------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, dtype, device,
               tie: bool) -> Dict:
    p = {"embedding": embed_init(gen, vocab, d_model, dtype, device)}
    if not tie:
        p["lm_head"] = dense_init(gen, d_model, vocab, dtype, device)
    return p


def embed_tokens(p: Dict, tokens: torch.Tensor, d_model: int) -> torch.Tensor:
    emb = p["embedding"]
    # the scale is rounded to the embedding's dtype first, as in the
    # reference: in bf16 sqrt(2048) is 45.25, not 45.2548...
    scale = torch.tensor(math.sqrt(d_model), dtype=emb.dtype,
                         device=emb.device)
    return F.embedding(tokens, emb) * scale


def lm_logits(p: Dict, h: torch.Tensor) -> torch.Tensor:
    if "lm_head" in p:
        return h @ p["lm_head"]
    return h @ p["embedding"].T
