"""Seeded random weights, made on the device by the benchmark.

The layout is the port's parameter tree (read on the ``meta`` device,
where nothing is allocated); every number in it is drawn here, from a
``torch.Generator`` on the weights' device seeded by ``--seed``, in one
call for all the Gaussian matrices (carved into aligned views) and a few
for the rest.  The same tree is handed to the port and, read leaf by
leaf, to the plain reference.

Distributions (the configuration files list them under ``assumed``):
matrices ``N(0, 1 / fan_in)``; the embedding ``N(0, (0.1 / sqrt(d))^2)``,
so the stream starts at rms 0.1 after the port's ``sqrt(d)`` scale and
the layers' outputs, not the input token, set the logits (with a tied
head a larger embedding makes every token's best next token itself, by a
margin no rounding could close); an untied head ``N(0, (2 /
sqrt(d))^2)``; depthwise convolutions ``N(0,
1 / K)`` with zero bias; norms 1; ``D`` 1; ``dt_bias`` the inverse
softplus of a step drawn log-uniformly in [1e-3, 1e-1]; Mamba-1's
``A = -(1..N)`` on every channel (S4D-real), Mamba-2's ``A`` per head
uniform in [-16, -1].
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

#: every view starts on a multiple of this many elements (128 bytes at
#: fp16), so vectorised loads stay aligned
ALIGN = 64
EMBED_STD = 0.1
HEAD_STD = 2.0


def _leaves(tree: Dict[str, Any], prefix: str = "") -> List[Tuple[str, Any]]:
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += _leaves(val, f"{prefix}{key}/")
        else:
            out.append((f"{prefix}{key}", val))
    return out


def _set(tree: Dict[str, Any], path: str, value: torch.Tensor) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def _gaussian_scale(path: str, shape: Tuple[int, ...], d_model: int):
    """The standard deviation of a Gaussian leaf, or None for a leaf that
    is not Gaussian."""
    name = path.rsplit("/", 1)[-1]
    if name == "embedding":
        return EMBED_STD / math.sqrt(d_model)
    if name == "lm_head":
        return HEAD_STD / math.sqrt(d_model)
    if name in ("conv_w", "conv_x_w", "conv_bc_w"):
        return 1.0 / math.sqrt(shape[-2])
    if name.startswith("w"):
        return 1.0 / math.sqrt(shape[-2])
    return None


def make_params(cfg, seed: int, device: torch.device) -> Dict[str, Any]:
    """The port's parameter tree for ``cfg`` (a port ``ModelConfig``),
    every leaf drawn from ``seed`` on ``device``."""
    from repro_torch.models.model import init_params_tree, torch_dtype

    dtype = torch_dtype(cfg.dtype)
    shapes = init_params_tree(cfg, None, dtype, torch.device("meta"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    leaves = _leaves(shapes)
    params: Dict[str, Any] = {}
    # the Gaussian leaves: one draw, carved into aligned views
    gauss = [(p, t) for p, t in leaves
             if t.dtype == dtype and _gaussian_scale(p, tuple(t.shape),
                                                     cfg.d_model)]
    offsets, total = [], 0
    for _, t in gauss:
        offsets.append(total)
        total += -(-t.numel() // ALIGN) * ALIGN
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    for (path, t), off in zip(gauss, offsets):
        view = flat[off:off + t.numel()].view(t.shape)
        view.mul_(_gaussian_scale(path, tuple(t.shape), cfg.d_model))
        _set(params, path, view)
    done = {p for p, _ in gauss}
    for path, t in leaves:
        if path in done:
            continue
        name = path.rsplit("/", 1)[-1]
        shape = tuple(t.shape)
        if name in ("scale", "norm_scale", "D"):
            val = torch.ones(shape, dtype=t.dtype, device=device)
        elif name in ("conv_b", "conv_x_b", "conv_bc_b"):
            val = torch.zeros(shape, dtype=t.dtype, device=device)
        elif name == "dt_bias":
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=device)
            step = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                             + math.log(1e-3))
            val = (step + torch.log(-torch.expm1(-step))).to(t.dtype)
        elif name == "A_log" and len(shape) >= 2 and cfg.ssm_num_heads == 0:
            n = shape[-1]
            a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
            val = torch.log(a).expand(shape).contiguous().to(t.dtype)
        elif name == "A_log":
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=device)
            val = torch.log(1.0 + 15.0 * u).to(t.dtype)
        else:
            raise KeyError(f"no rule for the port's parameter {path} "
                           f"{shape} {t.dtype}")
        _set(params, path, val)
    return params
