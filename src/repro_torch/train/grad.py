"""Loss and gradient compression — the port of :mod:`repro.train.grad`."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.sharding import collectives
from repro_torch.utils.trees import tree_map


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       z_loss: float = 0.0, group=None, vocab=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level CE with optional z-loss.  logits (B, S, V), targets
    (B, S); a negative target is masked out.

    With ``group`` (the data axes'
    :class:`~repro_torch.sharding.collectives.Axis`) the rows are this
    rank's share of a global batch: the masked sums and the mask's count
    are summed over the group, the returned loss is this rank's share of
    the global mean (its sum over the global count; the shares add up to
    the loss over the whole batch) and the metrics are the global
    values.

    With ``vocab`` (the model axis that splits the vocab,
    :func:`~repro_torch.models.layers.vocab_axis`) ``logits`` are this
    rank's block of ``V / m`` columns, at offset ``vocab.rank * V / m``,
    and no rank forms a whole row: the row maximum is all-reduced (no
    gradient), the block's sum of ``exp(l - max)`` and its gold logit
    (zero where the target lies in another block) are summed over the
    axis in one all-reduce whose backward is the identity, so each rank's
    gradient is its block's; every model rank holds the same loss.  The
    accuracy all-gathers each row's (max value, index) pair, fp32 and
    int32, and the first block holding the maximum wins a tie, as
    ``argmax`` over the whole row does."""
    logits = logits.to(torch.float32)
    if vocab is None or vocab.size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            targets.clamp(min=0).long()[..., None])[..., 0]
        pred = logits.argmax(-1)
    else:
        lse, gold, pred = _vocab_parallel(logits, targets, vocab)
    nll = lse - gold
    mask = (targets >= 0).to(torch.float32)
    sums = {"ce_loss": (nll * mask).sum(), "count": mask.sum()}
    if z_loss > 0.0:
        sums["z_loss"] = (torch.square(lse) * mask).sum()
    hit = (pred == targets).to(torch.float32)
    sums["accuracy"] = (hit * mask).sum()
    totals = sums
    if group is not None:
        totals = all_reduce_sum({k: v.detach() for k, v in sums.items()},
                                group)
    denom = torch.clamp(totals["count"], min=1.0)
    loss = sums["ce_loss"] / denom
    metrics = {"ce_loss": totals["ce_loss"] / denom}
    if z_loss > 0.0:
        loss = loss + z_loss * sums["z_loss"] / denom
        metrics["z_loss"] = z_loss * totals["z_loss"] / denom
    metrics["accuracy"] = totals["accuracy"] / denom
    return loss, metrics


def _vocab_parallel(logits: torch.Tensor, targets: torch.Tensor, vocab
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(log-sum-exp, gold logit, argmax) of each row of the whole vocab
    from this rank's block ``logits`` (:func:`cross_entropy_loss`)."""
    width = logits.shape[-1]
    offset = vocab.rank * width
    top, idx = logits.detach().max(-1)  # the first maximum on a tie
    m = collectives.all_reduce_max(top, vocab)
    local = targets.long() - offset
    inside = (local >= 0) & (local < width)
    gold = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])
    parts = torch.stack([torch.exp(logits - m[..., None]).sum(-1),
                         torch.where(inside, gold[..., 0],
                                     torch.zeros_like(gold[..., 0]))])
    sumexp, gold = collectives.leave(parts, vocab).unbind()
    pairs = [collectives.all_gather_values(t[..., None], vocab, -1)
             for t in (top, (idx + offset).to(torch.int32))]
    best = pairs[0].argmax(-1, keepdim=True)  # the first block on a tie
    pred = torch.gather(pairs[1], -1, best)[..., 0]
    return m + torch.log(sumexp), gold, pred


def all_reduce_sum(tensors: Dict[str, torch.Tensor], group
                   ) -> Dict[str, torch.Tensor]:
    """The sums over ``group`` (an
    :class:`~repro_torch.sharding.collectives.Axis`) of a dict of 0-d
    tensors, in one collective."""
    keys = list(tensors)
    buf = torch.stack([tensors[k].to(torch.float32) for k in keys])
    return dict(zip(keys, collectives.sum_(buf, group).unbind()))


#: elements a gradient bucket holds before a new one starts (256 MB of
#: fp32)
GRAD_BUCKET = 1 << 26


def all_reduce_grads(grads: List[torch.Tensor], group,
                     bucket: int = GRAD_BUCKET) -> None:
    """Sum fp32 gradients over ``group`` (an
    :class:`~repro_torch.sharding.collectives.Axis`) in place: consecutive
    leaves packed into flat buckets of up to ``bucket`` elements (a larger
    leaf alone), one all-reduce a bucket."""
    for start, end in bucket_ranges([g.numel() for g in grads], bucket):
        part = grads[start:end]
        flat = collectives.sum_(torch.cat([g.reshape(-1) for g in part]),
                                group)
        off = 0
        for g in part:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def bucket_ranges(sizes: List[int], bucket: int = GRAD_BUCKET
                  ) -> List[Tuple[int, int]]:
    """The ``[start, end)`` leaf ranges :func:`all_reduce_grads` packs
    leaves of ``sizes`` elements into: consecutive leaves up to ``bucket``
    elements, a larger leaf alone."""
    out = []
    start = 0
    while start < len(sizes):
        end, n = start, 0
        while end < len(sizes) and (end == start
                                    or n + sizes[end] <= bucket):
            n += sizes[end]
            end += 1
        out.append((start, end))
        start = end
    return out


def compress_int8_ef(grads, error_buf, split=None, path: str = ""):
    """Int8 quantization with error feedback: returns (the dequantized
    gradients to apply, the new error buffer), trees like ``grads``.  The
    reference keeps the int8 form for the wire; on one device only the
    quantization error dynamics matter, and they are exact here.  On
    sharded leaves ``split(path)`` gives the group over the axes that
    split leaf ``path`` (:meth:`~repro_torch.sharding.layout.Layout.
    split_axes`), and the scale is the whole leaf's maximum."""
    if isinstance(grads, dict):
        pairs = {k: compress_int8_ef(g, error_buf[k], split,
                                     f"{path}{k}/")
                 for k, g in grads.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    gf = grads.to(torch.float32) + error_buf
    peak = gf.abs().max()
    if split is not None:
        peak = collectives.all_reduce_max(peak, split(path[:-1]))
    scale = torch.clamp(peak, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq


def init_error_buffer(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
