"""The port's fault-tolerant driver (``repro_torch.runtime.driver``), its
metrics logger (``repro_torch.utils.logging``) and the train CLI's
checkpoints, on the CPU: the reference's driver cases
(``tests/test_checkpoint_runtime.py``) at the port's counterpart of
``tiny_model_config``; a run with faults injected at steps 5 and 8 equal to
an unbroken run bit for bit, with the faulted state freed before each
restore; the driver's logged losses against the reference driver's from
the same imported initialisation (fp32: rtol 1e-5, as the train steps'
parity tests); the reference's ``MetricsLogger`` cases
(``tests/test_obs.py``); the train CLI on ``--device cpu`` for the moe,
vlm and audio archs, resuming from its ``--ckpt-dir``.
"""

import json
import weakref

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_model_config
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.data.pipeline import make_data as jmake_data
from repro.models.model import build_model as jbuild
from repro.runtime.driver import TrainDriver as JTrainDriver
from repro.train import optimizer as joptim
from repro.train.train_step import init_train_state as jinit_state
from repro.train.train_step import make_train_step as jmake_step
from repro.utils.config import MeshConfig as JMesh
from repro.utils.config import ParallelConfig as JPar
from repro.utils.config import RunConfig as JRun
from repro.utils.config import ShapeConfig as JShape
from repro.utils.config import TrainConfig as JTrain
from repro.utils.logging import MetricsLogger as JMetricsLogger
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import make_data
from repro_torch.launch import train as tlaunch
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.runtime.driver import FaultInjector, TrainDriver
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          train_state_template)
from repro_torch.utils.config import RunConfig
from repro_torch.utils.logging import MetricsLogger
from repro_torch.utils.trees import flatten_with_paths, tree_leaves

torch.set_num_threads(1)


def _jrun(tmp_path, log_every=100, compute="bfloat16"):
    """The reference's driver run (bf16 compute, its default), or the same
    in fp32 for the loss parity."""
    return JRun(
        model=tiny_model_config(), shape=JShape("train", 16, 4, "train"),
        mesh=JMesh(shape=(1,), axes=("data",)),
        parallel=JPar(),
        train=JTrain(lr=1e-3, warmup_steps=2, total_steps=20,
                     compute_dtype=compute),
        checkpoint_dir=str(tmp_path), checkpoint_every=3,
        log_every=log_every)


def _make_driver(tmp_path, fault_steps=(), params=None, logger=None,
                 log_every=100, compute="bfloat16"):
    run = RunConfig.from_json(_jrun(tmp_path, compute=compute).to_json()) \
        .replace(log_every=log_every)
    model = build_model(run.model, run.parallel, device="cpu")
    opt = make_optimizer(run.train)
    step_fn = make_train_step(model, run, opt)

    def init_state():
        return init_train_state(model, run, opt, seed=0, params=params)

    data = make_data(run.model, run.shape, seed=0)
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    return TrainDriver(run, step_fn, init_state, data, ckpt,
                       logger=logger or MetricsLogger(name="test"),
                       fault_injector=FaultInjector(list(fault_steps)),
                       state_template=lambda: train_state_template(model, run,
                                                                   opt),
                       device="cpu")


def _params_equal(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return sorted(fa) == sorted(fb) and all(torch.equal(fa[k], fb[k])
                                            for k in fa)


# --------------------------------------------------------------------------
# the reference's driver cases, on the port
# --------------------------------------------------------------------------

def test_driver_runs_to_completion(tmp_path):
    d = _make_driver(tmp_path)
    state = d.run_steps(10)
    assert state.step == 10
    assert CheckpointManager(str(tmp_path)).all_steps() == [9, 10]


def test_driver_restarts_after_faults_bitexact(tmp_path):
    d_fault = _make_driver(tmp_path / "a", fault_steps=[5, 8])
    s_fault = d_fault.run_steps(10)
    assert d_fault.restarts == 2

    d_clean = _make_driver(tmp_path / "b")
    s_clean = d_clean.run_steps(10)
    assert s_fault.step == s_clean.step == 10
    assert _params_equal(s_fault.params, s_clean.params)
    assert _params_equal(s_fault.opt_state, s_clean.opt_state)


def test_driver_gives_up_after_max_restarts(tmp_path):
    d = _make_driver(tmp_path, fault_steps=list(range(1, 50)))
    d.max_restarts = 3
    with pytest.raises(RuntimeError):
        d.run_steps(10)
    assert d.restarts == 4


# --------------------------------------------------------------------------
# the port's own restart contract
# --------------------------------------------------------------------------

def test_faulted_state_is_freed_before_the_restore(tmp_path):
    """Every tensor of a state the driver trained is gone when the next
    restore starts: the faulted state does not live beside the restored
    one."""
    d = _make_driver(tmp_path, fault_steps=[5, 8])
    seen, restores = [], []
    step_fn, restore = d.train_step, d.ckpt.restore

    def step(state, batch):
        seen.extend(weakref.ref(t) for t in
                    tree_leaves(state.params) + tree_leaves(state.opt_state))
        return step_fn(state, batch)

    def checked_restore(*a, **kw):
        restores.append(sum(r() is not None for r in seen))
        return restore(*a, **kw)

    d.train_step, d.ckpt.restore = step, checked_restore
    assert d.run_steps(10).step == 10
    assert restores == [0, 0]


def test_restore_template_allocates_nothing(tmp_path):
    d = _make_driver(tmp_path)
    template = d.state_template()
    assert template.step == 0
    devices = {t.device.type for t in tree_leaves(template)
               if isinstance(t, torch.Tensor)}
    assert devices == {"meta"}


def test_driver_losses_match_the_reference_driver(tmp_path):
    """Both drivers from the same initialisation, fp32 compute, a fault
    at step 5 in each, one logged loss a step."""
    jrun = _jrun(tmp_path / "ref", log_every=1, compute="float32")
    jmodel = jbuild(jrun.model, jrun.parallel)
    jopt = joptim.make_optimizer(jrun.train)
    jstate = jinit_state(jmodel, jrun, jopt, jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, jstate.params)
    jlog, tlog = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    with JMetricsLogger(path=str(jlog), name="ref") as logger:
        from repro.runtime.driver import FaultInjector as JFaultInjector
        JTrainDriver(jrun, jax.jit(jmake_step(jmodel, jrun, jopt)),
                     lambda: jstate, jmake_data(jrun.model, jrun.shape, seed=0),
                     JCheckpointManager(str(tmp_path / "ref"), keep=2),
                     logger=logger,
                     fault_injector=JFaultInjector([5])).run_steps(8)
    run = RunConfig.from_json(jrun.to_json())
    params = params_from_jax(init, run.model, device="cpu")
    with MetricsLogger(path=str(tlog), name="port") as logger:
        _make_driver(tmp_path / "port", fault_steps=[5], params=params,
                     logger=logger, log_every=1,
                     compute="float32").run_steps(8)

    def losses(path):
        """The last loss logged at each step (the reference may restart
        from its fresh state: it lists the checkpoints without waiting for
        the step-3 save in flight) and the events."""
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        return ({r["step"]: r["loss"] for r in recs if "loss" in r},
                [r["event"] for r in recs if "event" in r])

    (want, jevents), (got, events) = losses(jlog), losses(tlog)
    assert events == ["init_fresh", "fault", "restored"]
    assert jevents[:2] == ["init_fresh", "fault"]

    assert sorted(got) == sorted(want) == list(range(1, 9))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)], rtol=1e-5)


# --------------------------------------------------------------------------
# MetricsLogger: the reference's cases, on the port
# --------------------------------------------------------------------------

def test_metrics_logger_context_manager_and_registry(tmp_path):
    p = tmp_path / "m.jsonl"
    with MetricsLogger(path=str(p), name="obs-test") as log:
        log.log(1, loss=0.5, event="init")
        fh = log._fh
        assert fh is not None and not fh.closed
    assert log._fh is None and fh.closed
    log.close()                     # idempotent
    log.log(2, loss=0.25)           # after close: stderr only, no raise
    recs = [json.loads(line) for line in p.read_text().splitlines()]
    assert len(recs) == 1 and recs[0]["loss"] == 0.5
    # numeric metrics are mirrored into the registry as labeled gauges
    assert obs_metrics.REGISTRY.value("loss", logger="obs-test") == 0.25


def test_metrics_logger_closes_on_exception(tmp_path):
    p = tmp_path / "m.jsonl"
    with pytest.raises(RuntimeError):
        with MetricsLogger(path=str(p), name="t") as log:
            log.log(0, a=1.0)
            raise RuntimeError("boom")
    assert log._fh is None


def test_metrics_logger_no_path_is_safe():
    with MetricsLogger(name="nofile") as log:
        log.log(0, x=1.0)
    log.close()


def test_metrics_logger_writes_the_reference_record(tmp_path, capsys):
    """Tensors become floats; the record and the stderr line are the
    reference logger's for the same metrics."""
    for cls, name, loss in ((JMetricsLogger, "ref", np.float32(0.75)),
                            (MetricsLogger, "port", torch.tensor(0.75))):
        with cls(path=str(tmp_path / f"{name}.jsonl"), name="same") as log:
            log.log(3, loss=loss, event="x", n=2)
    ref, port = (json.loads((tmp_path / f"{n}.jsonl").read_text())
                 for n in ("ref", "port"))
    assert {k: v for k, v in port.items() if k != "t"} == \
        {k: v for k, v in ref.items() if k != "t"} == \
        {"step": 3, "loss": 0.75, "event": "x", "n": 2}
    lines = [line.split(" t=")[1].split(" ", 1)[1]
             for line in capsys.readouterr().err.splitlines()]
    assert lines[0] == lines[1] == "loss=0.75 event=x n=2"


# --------------------------------------------------------------------------
# the train CLI: every new family, resumed from its checkpoint directory
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-11b", "whisper-large-v3"])
def test_train_cli_resumes_from_its_checkpoint(arch, tmp_path, capsys):
    argv = ["--device", "cpu", "--arch", arch, "--seq", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path)]
    assert tlaunch.main(argv + ["--steps", "3"]) == 0
    first = capsys.readouterr()
    assert "[train] finished at step 3" in first.out
    assert tlaunch.main(argv + ["--steps", "5"]) == 0
    second = capsys.readouterr()
    assert "[train] finished at step 5" in second.out
    tag = f"[train-{arch}] "
    events = [(line.split("step=")[1].split()[0], line.split("event=")[1])
              for line in (first.err + second.err).splitlines()
              if line.startswith(tag) and "event=" in line]
    assert events == [("0", "init_fresh"), ("3", "restored")]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in (first.err + second.err).splitlines()
              if line.startswith(tag) and "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 5]
