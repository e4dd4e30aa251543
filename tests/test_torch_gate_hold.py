"""``chip_smoke.py``'s bf16 hold of the vlm gate's gradient, on the CPU.

The gate's step-1 gradient is one sum over many products that nearly
cancel, so phase 4m bounds each rank's error by 5e-2 of the root of the
sum of the products' squares (``chip_smoke.gate_hold``, the magnitudes
from ``chip_smoke._gate_magnitudes`` on the one-process run) instead of
by the gradient's own norm.  Here llama-3.2-vision-11b's smoke config trains in
bf16 compute on the train CLI's fp32 embeddings at tp=2 on two gloo
ranks: the ranks meet the hold, and ranks whose ``enter`` drops the
all-reduce of its input gradient (a partial input gradient, the mutation
the sharded tests are checked against) fail it.
"""

import dataclasses
import os
import sys

import pytest
import torch
import torch.multiprocessing as mp

import torch_sharded_cases as sc

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

GATE = "blocks/sub1/cross_gate"


def _run(tp):
    run = sc.make_run("llama-3.2-vision-11b", 4, 32, dict(tp=tp))
    return run.replace(train=dataclasses.replace(run.train,
                                                compute_dtype="bfloat16"))


def _rank(rank, root, mutate):
    import torch.distributed as dist

    from repro_torch.sharding import collectives as C

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, f"store{int(mutate)}"), 2), rank=rank,
        world_size=2)
    try:
        if mutate:
            C._Enter.backward = staticmethod(lambda ctx, g: (g, None))
        grads = sc.loop(_run(2))[2]
        torch.save(grads[GATE], os.path.join(
            root, f"gate{int(mutate)}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gates(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gate_hold"))
    with chip_smoke._gate_magnitudes(torch) as seen:
        one = sc.loop(_run(1))[2][GATE]
    out = {"one": one, "magnitude": torch.cat(seen[:one.numel()])}
    for mutate in (False, True):
        mp.spawn(_rank, args=(root, mutate), nprocs=2, join=True)
        out[mutate] = [torch.load(os.path.join(
            root, f"gate{int(mutate)}_rank{r}.pt")) for r in range(2)]
    return out


def test_the_gate_hold_passes_the_sharded_gradient(gates):
    assert float(gates["magnitude"].abs().min()) > 0
    for g in gates[False]:
        rel = chip_smoke.gate_hold(torch, g, gates["one"],
                                   gates["magnitude"])
        assert rel <= chip_smoke.SHARDED_REDUCTION_RTOL, rel


def test_a_dropped_input_gradient_sum_fails_the_gate_hold(gates):
    for g in gates[True]:
        rel = chip_smoke.gate_hold(torch, g, gates["one"],
                                   gates["magnitude"])
        assert rel > chip_smoke.SHARDED_REDUCTION_RTOL, rel
