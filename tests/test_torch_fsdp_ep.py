"""FSDP and expert parallelism of the port's train step on the CPU: gloo
ranks on a ``FileStore`` (``torch_sharded_cases``) against one process
stepping on the same global batch, smoke configs in fp32, 3 steps.

Cases on two ranks: llama3.2-1b at fsdp=2 on ``(2, 1)`` (with AdamW, and
with ``int8_ef`` gradient compression), deepseek-v3-671b with its experts
on the data axis (expert all-to-alls), zamba2-2.7b at tp=2 under
Adafactor (its factored statistics over split leaves); on four ranks
deepseek-v3-671b with its experts on the data axis and their hidden width
on the model axis, and zamba2-2.7b at tp=2 and fsdp=2 under Adafactor.
Each is held as ``test_torch_tensor_parallel.py`` holds its cases (metrics,
every leaf's step-1 gradient, final parameters, the collective bytes
against the dry run's derivation).  The fault-tolerant driver over two
FSDP ranks (each leaf gathered whole to rank 0's checkpoint, every rank
restoring its blocks) with faults injected ends where an unbroken sharded
run ends, bit for bit, and its checkpoint restores in one process within
the parameter tolerance of the one-process driver's state.  A checkpoint
save copies each leaf off the state once, and ``train`` refuses a run
that is not of its model and shape.
"""

import os

import pytest
import torch

import torch_sharded_cases as sc

torch.set_num_threads(1)

TWO = (
    ("llama-fsdp2", "llama3.2-1b", 4, 32, dict(fsdp=2), None, "adamw"),
    ("llama-fsdp2-int8", "llama3.2-1b", 4, 32,
     dict(fsdp=2, grad_compression="int8_ef"), None, "adamw"),
    ("deepseek-experts-data", "deepseek-v3-671b", 2, 512,
     dict(moe_expert_axis="data"), None, "adamw"),
    ("zamba2-tp2-adafactor", "zamba2-2.7b", 4, 32, dict(tp=2), None,
     "adafactor"),
)
FOUR = (
    ("deepseek-experts-data-tp2", "deepseek-v3-671b", 4, 512,
     dict(tp=2, moe_expert_axis="data"), None, "adamw"),
    ("zamba2-tp2-fsdp2-adafactor", "zamba2-2.7b", 4, 32, dict(tp=2, fsdp=2),
     None, "adafactor"),
)
#: int8 error feedback rounds each gradient to 1/127 of its leaf's
#: maximum: an element within float rounding of a quantum's midpoint may
#: round the other way after the ranks' reordered sums, a step of up to
#: lr / 127 of Adam's normalized update for that element
INT8_PARAM_TOL = 1e-4
DRIVER = dict(arch="llama3.2-1b", batch=4, seq=32, steps=6, every=2,
              faults=(3, 6), par=dict(fsdp=2))


def _drive(root, name, faults):
    from repro_torch.launch import train as tlaunch
    from repro_torch.runtime.driver import FaultInjector

    run = sc.make_run(DRIVER["arch"], DRIVER["batch"], DRIVER["seq"],
                      DRIVER["par"], ckpt_dir=os.path.join(root, name),
                      steps=DRIVER["steps"])
    run = run.replace(checkpoint_every=DRIVER["every"])
    state = tlaunch.drive(run, device="cpu",
                          fault_injector=FaultInjector(list(faults)))
    return int(state.step), {k: v.detach().clone() for k, v in
                             sc.flatten_with_paths(state.params).items()}


def _drives(rank, root):
    return {"unbroken": _drive(root, "unbroken", ()),
            "faulted": _drive(root, "faulted", DRIVER["faults"])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fsdp_ep"))
    return {2: sc.spawn(root, 2, TWO, extra=_drives),
            4: sc.spawn(root, 4, FOUR), "root": root}


@pytest.mark.parametrize("case", TWO, ids=[c[0] for c in TWO])
def test_two_ranks_step_as_one_process(ranks, case):
    tol = INT8_PARAM_TOL if "int8" in case[0] else sc.PARAM_TOL
    sc.hold(ranks[2], case, param_tol=tol)


@pytest.mark.parametrize("case", FOUR, ids=[c[0] for c in FOUR])
def test_four_ranks_step_as_one_process(ranks, case):
    sc.hold(ranks[4], case)


def test_faulted_sharded_driver_equals_unbroken_and_restores_whole(
        ranks, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import train_state_template

    steps = DRIVER["steps"]
    for rec in ranks[2]:
        assert rec["unbroken"][0] == rec["faulted"][0] == steps
        a, b = rec["unbroken"][1], rec["faulted"][1]
        assert all(torch.equal(a[k], b[k]) for k in a)
    # the two ranks hold different blocks of an FSDP leaf
    w = "blocks/sub0/attn/wq"
    assert not torch.equal(ranks[2][0]["faulted"][1][w],
                           ranks[2][1]["faulted"][1][w])
    root = os.path.join(ranks["root"], "faulted")
    assert sorted(os.listdir(root))[-1] == f"step_{steps}"
    one_step, one = _drive(str(tmp_path), "one", ())
    assert one_step == steps
    run = sc.make_run(DRIVER["arch"], DRIVER["batch"], DRIVER["seq"],
                      DRIVER["par"], steps=steps)
    model = build_model(run.model, run.parallel, device="meta")
    template = train_state_template(model, run, make_optimizer(run.train))
    restored = CheckpointManager(root).restore(steps, template, device="cpu")
    sc.close_params({k: v for k, v in
                     sc.flatten_with_paths(restored.params).items()}, one)


def test_a_checkpoint_save_makes_one_host_copy_a_leaf(tmp_path, monkeypatch):
    """``gather_state``'s host copies are the checkpoint's snapshot: each
    leaf is copied off the state once (a leaf no axis splits without a
    gather), and the manager writes the copies as they are."""
    from repro_torch.checkpoint import manager as cm
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.train import gather_state
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import init_train_state

    run = sc.make_run("llama3.2-1b", 2, 16, {}, ckpt_dir=str(tmp_path))
    model = build_model(run.model, run.parallel, device="cpu")
    state = init_train_state(model, run, make_optimizer(run.train), seed=0)
    whole = gather_state(state, run, MeshSpec.of((1,), ("data",)))
    mine = sc.flatten_with_paths(state)
    held = {t.untyped_storage().data_ptr() for t in mine.values()
            if isinstance(t, torch.Tensor)}
    got = sc.flatten_with_paths(whole)
    for k, v in mine.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
            assert got[k].untyped_storage().data_ptr() not in held, k
    snapped = []
    snapshot = cm._snapshot
    monkeypatch.setattr(cm, "_snapshot",
                        lambda v: snapped.append(v) or snapshot(v))
    ckpt = cm.CheckpointManager(str(tmp_path))
    ckpt.save(0, whole, blocking=True, copied=True)
    assert not any(isinstance(v, torch.Tensor) for v in snapped)
    restored = sc.flatten_with_paths(ckpt.restore(0, state, device="cpu"))
    for k, v in mine.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(restored[k], v), k


def test_train_refuses_a_run_of_another_model_or_shape():
    from repro_torch.launch.train import train

    run = sc.make_run("llama3.2-1b", 2, 16, dict(tp=2))
    for kw in (dict(seq=32, batch=2), dict(seq=16, batch=4)):
        with pytest.raises(ValueError, match="the run is of"):
            train(run.model, steps=1, device="cpu", run=run, **kw)
    with pytest.raises(ValueError, match="the run is of"):
        train(run.model.replace(num_layers=1), steps=1, seq=16, batch=2,
              device="cpu", run=run)
