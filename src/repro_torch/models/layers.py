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

Tensor parallelism: the apply functions take a
:class:`~repro_torch.sharding.layout.Scope` (``sc``; the unsharded model
by default), which says per weight which dim the model axis splits.  A
column-split product takes its input through ``sc.gather_in`` (the
input gradient's partial sums all-reduced, or reduce-scattered from the
whole sequence under sequence parallelism), a row-split one gives partial
sums that ``sc.leave_out`` all-reduces (reduce-scatters to the rank's
sequence block); the embedding and the head split the vocab, and the
head's logits stay the rank's vocab block.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.sharding import collectives
from repro_torch.sharding.layout import LOCAL, Scope


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


# -- products ----------------------------------------------------------------

def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jax's promotion of mixed float dtypes: the reference's
    ``jnp.einsum`` of an fp32 operand and a bf16 one computes in fp32 (the
    stub frontends hand fp32 frames and patch embeddings to a bf16 model),
    where ``torch.matmul`` refuses mixed operands.  The narrower operand is
    widened first; equal dtypes multiply as they are."""
    if a.dtype != b.dtype:
        wide = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(wide), b.to(wide)
    return a @ b


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


def apply_mlp(p: Dict, x: torch.Tensor, mlp_type: str,
              sc: Scope = LOCAL, reduce: bool = True) -> torch.Tensor:
    """The MLP of ``x``; under a model split of ``w_up`` (column) and
    ``w_down`` (row) the hidden width is this rank's, and with ``reduce``
    False the caller takes ``x`` in and the partial output out itself
    (``x`` is then the whole sequence); with ``reduce`` ``x`` is the
    stream (:meth:`~repro_torch.sharding.layout.Scope.gather_in`)."""
    split = sc.model_dim("w_up") == 1
    if split != (sc.model_dim("w_down") == 0):
        raise ValueError(f"mlp at {sc.prefix}: w_up split on "
                         f"{sc.model_dim('w_up')}, w_down on "
                         f"{sc.model_dim('w_down')}")
    if reduce:
        x = sc.gather_in(x, split)
    if mlp_type == "swiglu":
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
    elif mlp_type == "relu2":
        h = torch.square(F.relu(mm(x, p["w_up"])))
    else:  # gelu — jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(mm(x, p["w_up"]), approximate="tanh")
    out = mm(h, p["w_down"])
    return sc.leave_out(out, split) if reduce else out


# -- Embedding + LM head ---------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, dtype, device,
               tie: bool) -> Dict:
    p = {"embedding": embed_init(gen, vocab, d_model, dtype, device)}
    if not tie:
        p["lm_head"] = dense_init(gen, d_model, vocab, dtype, device)
    return p


@functools.lru_cache(maxsize=None)
def _embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype`` first, as in the reference (in
    bf16 sqrt(2048) is 45.25, not 45.2548...), as a Python float computed
    once on the host: a step captured in a CUDA graph may not copy host
    data to the device."""
    return torch.tensor(math.sqrt(d_model), dtype=dtype).item()


def embed_tokens(p: Dict, tokens: torch.Tensor, d_model: int,
                 sc: Scope = LOCAL) -> torch.Tensor:
    """The scaled embedding rows of ``tokens``, as the stream holds them
    (:meth:`~repro_torch.sharding.layout.Scope.leave_out`: the rank's
    sequence block under the sequence split).  With the vocab split over
    the model axis each rank looks up the tokens its rows hold (the
    others give zeros) and the partial rows are summed."""
    emb = p["embedding"]
    scale = _embed_scale(d_model, emb.dtype)
    if sc.model_dim("embedding") != 0:
        return sc.leave_out(F.embedding(tokens, emb) * scale, False)
    rows = emb.shape[0]
    local = tokens - sc.model.rank * rows
    inside = ((local >= 0) & (local < rows))[..., None]
    e = F.embedding(local.clamp(0, rows - 1), emb) * scale
    return sc.leave_out(torch.where(inside, e, torch.zeros_like(e)))


def vocab_axis(p: Dict, sc: Scope = LOCAL):
    """The model axis when the head splits the vocab over it (each rank's
    logits are its block of ``V / m`` columns, in rank order), else
    None."""
    split = (sc.model_dim("lm_head") == 1 if "lm_head" in p
             else sc.model_dim("embedding") == 0)
    return sc.model if split else None


def lm_logits(p: Dict, h: torch.Tensor, sc: Scope = LOCAL,
              last: bool = False) -> torch.Tensor:
    """Logits of the stream ``h`` over the whole sequence (gathered first
    under the sequence split).  With the vocab split over the model axis
    (:func:`vocab_axis`) they are the rank's vocab block: the loss runs
    on the blocks (:func:`repro_torch.train.grad.cross_entropy_loss`),
    and ``h`` enters the split, so its gradient sums over the model
    ranks.  With ``last`` the last position's ``(B, V)``: the product over
    every position, as the reference's prefill computes it, then its last
    row, all-gathered over the vocab blocks."""
    w = p["lm_head"] if "lm_head" in p else p["embedding"].T
    axis = vocab_axis(p, sc)
    h = sc.gather_in(h, axis is not None)
    logits = h @ w
    if not last:
        return logits
    return collectives.gather(logits[:, -1], axis, -1, backward="slice")
