"""Roofline analysis over the port's dry-run records — the port of
:mod:`repro.launch.roofline`, at the H100's constants.

Per (arch x shape) cell on the single-pod mesh:

    compute term    = FLOPs_per_chip / peak FLOP/s       (989 TFLOP/s bf16)
    memory term     = bytes_per_chip / HBM bandwidth     (3.35 TB/s)
    collective term = collective_bytes_per_chip / link   (450 GB/s NVLink)

The records' numbers are per chip (:mod:`repro_torch.launch.dryrun`), so
they divide by per-chip peaks.  MODEL_FLOPS uses the standard
conventions:

    train   6 * N * D      (N = params, active params for MoE; D = tokens)
    prefill 2 * N * D
    decode  2 * N * B      (one token per sequence)

and the useful-compute ratio MODEL_FLOPS / (FLOPs_per_chip * chips)
exposes recompute, redundancy and routing waste.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline   # after dryrun --all
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List

from repro_torch.configs.registry import get_model_config
from repro_torch.utils.hardware import H100_SXM, HardwareSpec

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")


@dataclass
class RooflineRow:
    arch: str
    shape: str
    kind: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    step_time_s: float          # max of the three terms (no-overlap bound)
    roofline_frac: float        # the model FLOPs' time at peak / step bound
    note: str = ""

    def as_dict(self) -> Dict:
        return dict(self.__dict__)


def model_flops_for(arch: str, shape_kind: str, global_batch: int,
                    seq_len: int) -> float:
    cfg = get_model_config(arch)
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * global_batch * seq_len
    if shape_kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch  # decode: one token per sequence


_SHAPE_DIMS = {
    "train_4k": (256, 4096), "prefill_32k": (32, 32768),
    "decode_32k": (128, 32768), "long_500k": (1, 524288),
}


def roofline_from_record(rec: Dict, hw: HardwareSpec = H100_SXM
                         ) -> RooflineRow:
    h = rec["hlo_analysis"]
    chips = rec["chips"]
    compute_s = h["flops_per_chip"] / hw.peak_flops_bf16
    memory_s = h["bytes_per_chip"] / hw.hbm_bandwidth
    collective_s = h["total_collective_bytes_per_chip"] / hw.ici_bandwidth
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    gb, sl = _SHAPE_DIMS[rec["shape"]]
    mf = model_flops_for(rec["arch"], rec["kind"], gb, sl)
    hlo_global = h["flops_per_chip"] * chips
    step = max(terms.values())
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], kind=rec["kind"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        step_time_s=step,
        roofline_frac=(mf / hw.peak_flops_bf16 / chips) / step if step else 0.0,
    )


def load_records(pattern: str = "*__pod.json") -> List[Dict]:
    out = []
    for fn in sorted(glob.glob(os.path.join(ARTIFACT_DIR, pattern))):
        with open(fn) as f:
            out.append(json.load(f))
    return out


def format_table(rows: List[RooflineRow]) -> str:
    hdr = (f"{'arch':26s} {'shape':12s} {'chips':5s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
           f"{'dominant':>10s} {'useful':>7s} {'MFU-bound':>9s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:26s} {r.shape:12s} {r.chips:5d} "
            f"{r.compute_s:10.3e} {r.memory_s:10.3e} {r.collective_s:10.3e} "
            f"{r.dominant:>10s} {r.useful_ratio:7.2f} {r.roofline_frac:9.3f}")
    return "\n".join(lines)


def main() -> int:
    recs = load_records()
    if not recs:
        print("no dry-run artifacts found; run repro_torch.launch.dryrun "
              "--all first")
        return 1
    rows = [roofline_from_record(r) for r in recs]
    rows.sort(key=lambda r: (r.arch, r.shape))
    print(format_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
