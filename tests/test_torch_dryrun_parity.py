"""The dry run's FLOP count against the reference's compiled HLO, on the
smoke cells where the two agree exactly.

The port's ``matmul_flops`` (``repro_torch.launch.hlo_analysis``: 2·M·N·K
for each dispatched matmul-class aten op of one traced step on ``meta``
tensors) equals the dot FLOPs of the reference's compiled step (its
``analyze_hlo`` dot term, trip-scaled; ``torch_dryrun_reference.py``)
number for number on every forward cell listed here and on three train
cells.  The total FLOPs (every other op 1 per output element, by both
packages' rule) lie within ``FLOPS_BAND`` of ``analyze_hlo(...).flops``:
the packages' elementwise ops differ (the reference's one-hot cache write
touches every cache row a decode step; the port's indexed write does not).
The five train cells whose matmul FLOPs differ are held at their counts in
``test_torch_dryrun_held.py``.
"""

import pytest
import torch

from repro_torch.configs.registry import make_run
from repro_torch.launch.build import lower_step
from repro_torch.launch.mesh import MeshSpec
from torch_dryrun_reference import reference_costs

torch.set_num_threads(1)

#: port / reference total FLOPs lies in this band on every smoke cell
#: (measured 0.70-1.19 over all 30)
FLOPS_BAND = (0.65, 1.25)

EXACT = (
    ("llama3.2-1b", "prefill_smoke"), ("zamba2-2.7b", "prefill_smoke"),
    ("falcon-mamba-7b", "prefill_smoke"),
    ("deepseek-v3-671b", "prefill_smoke"),
    ("llama4-maverick-400b-a17b", "prefill_smoke"),
    ("whisper-large-v3", "prefill_smoke"),
    ("llama3.2-1b", "decode_smoke"), ("llama-3.2-vision-11b", "decode_smoke"),
    ("llama3.2-1b", "train_smoke"), ("whisper-large-v3", "train_smoke"),
    ("h2o-danube-1.8b", "train_smoke"),
)


def port_costs(arch, shape):
    run = make_run(arch, shape, smoke=True)
    _, traced = lower_step(run, MeshSpec.of(run.mesh.shape, run.mesh.axes))
    return traced.cost_analysis()


@pytest.mark.parametrize("arch,shape", EXACT,
                         ids=[f"{a}-{s}" for a, s in EXACT])
def test_matmul_flops_equal_the_reference_dots(arch, shape):
    ref_dots, ref_flops = reference_costs(arch, shape)
    costs = port_costs(arch, shape)
    assert costs.matmul_flops == ref_dots > 0
    lo, hi = FLOPS_BAND
    assert lo <= costs.flops / ref_flops <= hi
