"""The five smoke train cells whose matmul FLOPs differ between the port's
dry run and the reference's compiled HLO, each held at both packages'
counts.  ``ROADMAP.md`` queue 3 says where each difference lies: the
reference's compiled step holds no recompute of some attention scopes
(vision, llama4, deepseek's MTP head), where the port's recompute
backward runs the plain forward again and needs its products; zamba2's
SSD and falcon-mamba's scan differentiate to other small products in each
autodiff (zamba2's SSD backward formed its unused output until the fix
logged there).  A change on either side shows here.  Total FLOPs stay within the parity file's band.
"""

import pytest
import torch

from test_torch_dryrun_parity import FLOPS_BAND, port_costs
from torch_dryrun_reference import reference_costs

torch.set_num_threads(1)

#: arch -> (port matmul FLOPs, reference dot FLOPs) of ``train_smoke``
HELD = {
    "llama-3.2-vision-11b": (780140544, 708837376),
    "llama4-maverick-400b-a17b": (758906880, 691982336),
    "zamba2-2.7b": (697827328, 698155008),
    "deepseek-v3-671b": (636616704, 633716736),
    "falcon-mamba-7b": (96468992, 97517568),
}


@pytest.mark.parametrize("arch", sorted(HELD))
def test_train_cell_held_at_its_counts(arch):
    port, ref = HELD[arch]
    ref_dots, ref_flops = reference_costs(arch, "train_smoke")
    costs = port_costs(arch, "train_smoke")
    assert (costs.matmul_flops, ref_dots) == (port, ref)
    lo, hi = FLOPS_BAND
    assert lo <= costs.flops / ref_flops <= hi
