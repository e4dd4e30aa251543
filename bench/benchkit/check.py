"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests the program
finished, drawn from the seed with the one that served the most tokens
in it, is run through the plain fp32 reference of the configuration's
family (``reference/<family>.py``), teacher-forced with the prompt and
the served tokens.  At each served token's position the reference's
logits give the gap by which the served token lies below the
reference's best; the number compared is the widest gap over the sample
(``served_gap``).  A greedy program in the stated precision serves
tokens that the reference ranks first, or within rounding of first.

The control (``control=True``, never in a benchmark run) reads, at the
same positions of the same sequences, the gap of the token that the
reference computed with fp8 products puts first (``control_gap``).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchkit import spec

#: positions whose logits are formed at once
POSITION_BLOCK = 2048


def sample(finished: Dict[int, int], seed: int, k: int) -> List[int]:
    """``k`` uids of ``finished`` (uid -> tokens served): the one that
    served the most (the lowest uid among equals) and ``k - 1`` more drawn
    from the seed."""
    if not finished:
        return []
    uids = sorted(finished)
    top = max(uids, key=lambda u: (finished[u], -u))
    rest = [u for u in uids if u != top]
    rng = np.random.default_rng([int(seed), 1])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [top] + sorted(rest[i] for i in pick)


def reference_module(cell: spec.Cell):
    ref_dir = str(cell.bench_dir / "reference")
    if ref_dir not in sys.path:
        sys.path.insert(0, ref_dir)
    return cell.module("reference", cell.config["family"])


def _gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, chosen[:, None])[:, 0]


@torch.no_grad()
def compare(cell: spec.Cell, params, prompts: Sequence[np.ndarray],
            served: Sequence[Sequence[int]], device: torch.device,
            control: bool = False) -> Dict[str, float]:
    """The widest gap of the served tokens (and, with ``control``, of the
    fp8 reference's first choices) under the fp32 reference, over the
    sequences ``prompts[i] + served[i]``."""
    ref = reference_module(cell)
    from ref_common import exact_fp32, head, mm

    sizes = cell.config["port"]
    lens = [len(p) + len(s) - 1 for p, s in zip(prompts, served)]
    tokens = torch.zeros((len(lens), max(lens)), dtype=torch.long)
    for i, (p, s) in enumerate(zip(prompts, served)):
        seq = np.concatenate([np.asarray(p, np.int64),
                              np.asarray(s[:-1], np.int64)])
        tokens[i, :len(seq)] = torch.from_numpy(seq)
    tokens = tokens.to(device)
    out = {"served_gap": 0.0, "served_tokens": 0}
    with exact_fp32():
        w = head(params)
        h_ref = ref.hidden(params, sizes, tokens)
        h_ctl = ref.hidden(params, sizes, tokens, fp8=True) if control \
            else None
        if control:
            out["control_gap"] = 0.0
        for i, (p, s) in enumerate(zip(prompts, served)):
            first = len(p) - 1
            want = torch.as_tensor(np.asarray(s, np.int64), device=device)
            for a in range(0, len(s), POSITION_BLOCK):
                pos = slice(first + a, first + min(a + POSITION_BLOCK,
                                                   len(s)))
                lg = mm(h_ref[i, pos], w)
                g = _gaps(lg, want[a:a + POSITION_BLOCK])
                out["served_gap"] = max(out["served_gap"], float(g.max()))
                if control:
                    pick = mm(h_ctl[i, pos], w, fp8=True).argmax(-1)
                    out["control_gap"] = max(out["control_gap"],
                                             float(_gaps(lg, pick).max()))
            out["served_tokens"] += len(s)
    return out
