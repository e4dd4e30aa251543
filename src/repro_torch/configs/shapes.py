"""Assigned input-shape cells (same 4-shape set for all 10 LM archs).

``train_*`` lowers train_step; ``prefill_*`` lowers the prefill serve step;
``decode_*`` / ``long_*`` lower one decode step against a cache of seq_len.
``long_500k`` requires sub-quadratic context handling — it runs for
SSM / hybrid / sliding-window archs and is a documented skip for pure
full-attention archs (see DESIGN.md §Arch-applicability).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.utils.config import ShapeConfig

SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}

# reduced shapes used by smoke tests / examples
SMOKE_SHAPES: Dict[str, ShapeConfig] = {
    "train_smoke": ShapeConfig("train_smoke", seq_len=64, global_batch=4, kind="train"),
    "prefill_smoke": ShapeConfig("prefill_smoke", seq_len=64, global_batch=2, kind="prefill"),
    "decode_smoke": ShapeConfig("decode_smoke", seq_len=64, global_batch=2, kind="decode"),
}


def shape_runs_for(sub_quadratic: bool) -> Dict[str, ShapeConfig]:
    """The shape cells that actually compile for an arch family."""
    out = dict(SHAPES)
    if not sub_quadratic:
        out.pop("long_500k")
    return out
