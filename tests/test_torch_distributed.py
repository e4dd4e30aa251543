"""The data-parallel train step of the port, on the CPU: two gloo ranks
(``torch.multiprocessing.spawn``, a ``FileStore``, no network) against one
process stepping on the same global batch.

For the smoke configs of llama3.2-1b (dense), falcon-mamba-7b (SSM) and
deepseek-v3-671b (MoE, with its aux and MTP losses), in float32 (model and
compute), 3 steps: each rank's losses (and the other metrics: the CE and
z-losses, accuracy, gradient norm, ``moe_aux``, ``mtp_loss``) equal the one
process's within 1e-6 relative, and each rank's final parameters within
1e-5 + 1e-5 |p|.  Rank
``r`` takes rows ``[r B/2, (r+1) B/2)`` of the global batch; the loss's
sums and counts, the MoE statistics and the gradients are summed over the
ranks.  A MoE batch whose per-rank token count is not a multiple of the
global routing group raises.  The fault-tolerant driver over the two ranks
(rank 0 writes, every rank restores) with faults injected ends where an
unbroken two-rank run ends, bit for bit, and where the one-process driver
ends, within the parameter tolerance.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import make_data
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import build_model
from repro_torch.runtime.driver import FaultInjector
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.config import TrainConfig
from repro_torch.utils.trees import flatten_with_paths

torch.set_num_threads(1)

WORLD = 2
STEPS = 3
#: (arch, global batch, seq): deepseek's 2 x 512 tokens give each rank one
#: routing group of 512, the global group
CASES = (("llama3.2-1b", 4, 32), ("falcon-mamba-7b", 4, 32),
         ("deepseek-v3-671b", 2, 512))
LOSS_RTOL = 1e-6
PARAM_TOL = 1e-5  # atol and rtol
DRIVER = dict(arch="llama3.2-1b", batch=4, seq=32, steps=6, every=2,
              faults=(3, 6))


def _run(arch, batch, seq, steps, ckpt_dir="unused"):
    cfg = get_smoke_config(arch).replace(dtype="float32")
    run = tlaunch.make_run(cfg, seq=seq, batch=batch, steps=steps,
                           checkpoint_dir=ckpt_dir)
    return run.replace(train=TrainConfig(
        lr=1e-3, warmup_steps=10, total_steps=steps,
        compute_dtype="float32"))


def _losses_and_params(run):
    """The train CLI's loop at fp32: the step data-parallel over the process
    group when one is up (``data_parallel``, this rank's rows)."""
    model = build_model(run.model, run.parallel, device="cpu")
    run, mesh = tlaunch.data_parallel(run, model.device)
    group = mesh.data_group()
    optimizer = make_optimizer(run.train)
    step = make_train_step(model, run, optimizer, mesh=mesh)
    state = init_train_state(model, run, optimizer, seed=0)
    data = tlaunch.rank_rows(make_data(run.model, run.shape, seed=0), group)
    logged = []
    for i in range(STEPS):
        state, metrics = step(state, data.batch_at(i))
        logged.append({k: float(v) for k, v in metrics.items()})
    return logged, _host(state.params)


def _host(params):
    return {k: v.detach().clone() for k, v in
            flatten_with_paths(params).items()}


def _driver_params(root, name, faults):
    run = _run(DRIVER["arch"], DRIVER["batch"], DRIVER["seq"],
               DRIVER["steps"], os.path.join(root, name))
    run = run.replace(checkpoint_every=DRIVER["every"])
    state = tlaunch.drive(run, device="cpu",
                          fault_injector=FaultInjector(list(faults)))
    return int(state.step), _host(state.params)


def _rank(rank, root):
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(root, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        out = {"steps": {arch: _losses_and_params(_run(arch, b, s, STEPS))
                         for arch, b, s in CASES}}
        try:
            _losses_and_params(_run("deepseek-v3-671b", 4, 32, STEPS))
        except ValueError as e:
            out["moe_group_error"] = str(e)
        out["unbroken"] = _driver_params(root, "unbroken", ())
        out["faulted"] = _driver_params(root, "faulted", DRIVER["faults"])
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp"))
    mp.spawn(_rank, args=(root,), nprocs=WORLD, join=True)
    return [torch.load(os.path.join(root, f"rank{r}.pt"))
            for r in range(WORLD)], root


def _close(a, b):
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch,batch,seq", CASES, ids=[c[0] for c in CASES])
def test_two_ranks_step_as_one_process(ranks, arch, batch, seq):
    outs, _ = ranks
    logged, params = _losses_and_params(_run(arch, batch, seq, STEPS))
    names = sorted(logged[0])
    assert {"loss", "ce_loss", "z_loss", "accuracy", "grad_norm"} <= \
        set(names)
    if arch == "deepseek-v3-671b":
        assert {"moe_aux", "mtp_loss"} <= set(names)
    for out in outs:
        got_logged, got_params = out["steps"][arch]
        for k in names:
            want = [m[k] for m in logged]
            assert np.isfinite(want).all(), k
            np.testing.assert_allclose([m[k] for m in got_logged], want,
                                       rtol=LOSS_RTOL, atol=0, err_msg=k)
        assert set(got_params) == set(params)
        _close(got_params, params)
    # the replicas stay equal bit for bit: every rank applies the summed
    # gradients
    a, b = (out["steps"][arch][1] for out in outs)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_moe_rank_tokens_must_fill_the_global_group(ranks):
    outs, _ = ranks
    for out in outs:
        assert "multiple of the global routing group" in \
            out["moe_group_error"]


def test_faulted_driver_over_two_ranks_equals_unbroken(ranks, tmp_path):
    outs, root = ranks
    steps = DRIVER["steps"]
    for out in outs:
        assert out["unbroken"][0] == out["faulted"][0] == steps
        a, b = out["unbroken"][1], out["faulted"][1]
        assert all(torch.equal(a[k], b[k]) for k in a)
    # rank 0 alone wrote; the last checkpoint is the last step
    assert sorted(os.listdir(os.path.join(root, "faulted")))[-1] == \
        f"step_{steps}"
    one_step, one = _driver_params(str(tmp_path), "one", ())
    assert one_step == steps
    _close(outs[0]["unbroken"][1], one)
