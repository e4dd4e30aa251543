"""Loss and gradient compression — the port of :mod:`repro.train.grad`."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.utils.trees import tree_map


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       z_loss: float = 0.0
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE with optional z-loss.  logits (B, S, V), targets
    (B, S); a negative target is masked out."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - gold
    mask = (targets >= 0).to(torch.float32)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    metrics = {"ce_loss": loss}
    if z_loss > 0.0:
        zl = z_loss * (torch.square(lse) * mask).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    hit = (logits.argmax(-1) == targets).to(torch.float32)
    metrics["accuracy"] = (hit * mask).sum() / denom
    return loss, metrics


def compress_int8_ef(grads, error_buf):
    """Int8 quantization with error feedback: returns (the dequantized
    gradients to apply, the new error buffer), trees like ``grads``.  The
    reference keeps the int8 form for the wire; on one device only the
    quantization error dynamics matter, and they are exact here."""
    if isinstance(grads, dict):
        pairs = {k: compress_int8_ef(g, error_buf[k])
                 for k, g in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    gf = grads.to(torch.float32) + error_buf
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq


def init_error_buffer(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
