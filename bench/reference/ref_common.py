"""Pieces that both plain references share: fp32 products (or the fp8
control's), norms, the causal depthwise convolution, the embedding.

Plain PyTorch in float32, with TF32 off while a reference runs.  Imports
nothing of the program under test.  ``Numerics`` says how a product is
computed: ``fp32``, or ``fp8`` for the control, which rounds each
product's operands to float8 e4m3 (the weight per tensor, the
activations per row, each scaled so that its largest magnitude is the
format's largest) and multiplies in fp32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
import torch.nn.functional as F

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """Float32 products in float32, not TF32, for the block's duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _to_f8(x: torch.Tensor, dim) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim`` (all
    of it when None), returned in fp32 at its own magnitude."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True))
    scale = F8_MAX / torch.clamp(amax, min=1e-30)
    return (x * scale).to(F8).to(torch.float32) / scale


def mm(x: torch.Tensor, w: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """``x @ w`` in fp32; with ``fp8`` both operands rounded to e4m3 first
    (``x`` per row, ``w`` per tensor)."""
    x, w = x.to(torch.float32), w.to(torch.float32)
    if fp8:
        x, w = _to_f8(x, -1), _to_f8(w, None)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale.to(torch.float32)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over time.  x: (B, L, C); w: (K, C);
    b: (C,).  Output t sums taps ``w[i] * x[t - (K - 1) + i]``."""
    k, l = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = w.to(torch.float32)
    out = b.to(torch.float32).expand_as(x).clone()
    for i in range(k):
        out += xp[:, i:i + l] * w[i]
    return out


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Embedding rows times ``sqrt(d_model)``, the factor rounded to the
    model's dtype as the model defines it."""
    d = table.shape[1]
    factor = torch.tensor(math.sqrt(d), dtype=dtype).item()
    return table[tokens].to(torch.float32) * factor


def layer(tree, i: int):
    """Layer ``i`` of a tree of stacked leaves, each in fp32."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i].to(torch.float32)


def whole(tree):
    """A tree of unstacked leaves, each in fp32."""
    if isinstance(tree, dict):
        return {k: whole(v) for k, v in tree.items()}
    return tree.to(torch.float32)


def head(params) -> torch.Tensor:
    """The output head ``(d_model, vocab)`` in fp32: the untied
    ``lm_head``, else the embedding's transpose."""
    emb = params["embed"]
    w = emb["lm_head"] if "lm_head" in emb else emb["embedding"].T
    return w.to(torch.float32)
