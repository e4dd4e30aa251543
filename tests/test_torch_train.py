"""The port's training stack against the JAX reference on the CPU: two train
steps of ``llama3.2-smoke``, ``falcon-mamba-smoke`` and ``zamba2-smoke``
from the same imported initialisation on the same batches (loss, gradient
norm, parameters), microbatch accumulation and int8 error feedback through
the step, one update of each optimizer, the schedules, clipping, the loss
with z-loss, and the train CLI.

Tolerances, each against the reference:
- fp32 compute: loss rtol 1e-5, gradient norm rtol 1e-4 (fp32 sums in
  different orders).  Parameters: with SGD-momentum, whose update is
  linear in the gradient, atol 2e-5 / rtol 1e-4 on every element — a
  gradient check; with AdamW, atol 1e-4 / rtol 1e-4 on all but 0.1% of the
  elements, and the rest within the 2 * lr * steps an update can move
  them: Adam's first update is g / (|g| + 1e-8), which maps a gradient of
  order 1e-9 (a near-cancelling sum, taken in another order) to anything
  in (-lr, lr);
- bf16 compute (fp32 master): loss rtol 1e-2, gradient norm rtol 5e-2,
  parameters atol 1e-3 + rtol 1e-2 (the two frameworks round activations
  to bf16 at different points; the first Adam update is ~sign(g) * lr, so a
  parameter whose gradient is near 0 may move either way by up to 2 * lr
  = 2e-2 — the test holds the share of such parameters under 2%);
- the optimizers, schedules, clipping, loss and int8-EF: rtol 1e-5 /
  atol 1e-6 (elementwise fp32 arithmetic in the same order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.falcon_mamba_7b import SMOKE as J_FALCON_SMOKE
from repro.configs.llama3p2_1b import SMOKE as J_LLAMA_SMOKE
from repro.configs.zamba2_2p7b import SMOKE as J_ZAMBA_SMOKE
from repro.data.pipeline import make_data as jmake_data
from repro.models.model import build_model as jbuild
from repro.train import grad as jgrad
from repro.train import optimizer as joptim
from repro.train.train_step import init_train_state as jinit_state
from repro.train.train_step import make_train_step as jmake_step
from repro.utils.config import MeshConfig as JMesh
from repro.utils.config import ParallelConfig as JPar
from repro.utils.config import RunConfig as JRun
from repro.utils.config import ShapeConfig as JShape
from repro.utils.config import TrainConfig as JTrain
from repro_torch.data.pipeline import make_data as tmake_data
from repro_torch.launch import train as tlaunch
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model as tbuild
from repro_torch.train import grad as tgrad
from repro_torch.train import optimizer as toptim
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.config import RunConfig, TrainConfig
from repro_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

SMOKES = {"llama3.2-smoke": J_LLAMA_SMOKE,
          "falcon-mamba-smoke": J_FALCON_SMOKE,
          "zamba2-smoke": J_ZAMBA_SMOKE}
EXACT = dict(rtol=1e-5, atol=1e-6)


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return np.array(t.detach().cpu())  # a copy: the optimizer works in place


LR = 1e-2


def jrun(jcfg, compute="float32", optimizer="adamw", **par):
    return JRun(model=jcfg, shape=JShape("train", 24, 4, "train"),
                mesh=JMesh(shape=(1,), axes=("data",)),
                parallel=JPar(**par),
                train=JTrain(lr=LR, warmup_steps=1, total_steps=10,
                             compute_dtype=compute, optimizer=optimizer))


@functools.lru_cache(maxsize=None)
def reference_steps(name, compute="float32", optimizer="adamw", **par):
    """The reference: init, and the parameters and metrics after each of
    two jitted steps (as numpy)."""
    run = jrun(SMOKES[name], compute, optimizer, **par)
    model = jbuild(run.model, run.parallel)
    opt = joptim.make_optimizer(run.train)
    state = jinit_state(model, run, opt, jax.random.PRNGKey(0))
    init = jax.tree.map(np.array, state.params)
    step = jax.jit(jmake_step(model, run, opt))
    data = jmake_data(run.model, run.shape, seed=0)
    out = []
    for i in range(2):
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch_at(i).items()})
        out.append((jax.tree.map(np.array, state.params),
                    {k: float(v) for k, v in m.items()}))
    return run, init, out


def port_steps(run_j, init):
    run = RunConfig.from_json(run_j.to_json())
    model = tbuild(run.model, run.parallel, device="cpu")
    opt = toptim.make_optimizer(run.train)
    params = params_from_jax(init, run.model, device="cpu")
    state = init_train_state(model, run, opt, params=params)
    step = make_train_step(model, run, opt)
    data = tmake_data(run.model, run.shape, seed=0)
    out = []
    for i in range(2):
        state, m = step(state, data.batch_at(i))
        out.append((jax.tree.map(N, state.params),
                    {k: float(v) for k, v in m.items()}))
    return out


def _flat(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _adam_close(p, jp, steps):
    a = np.concatenate([x.ravel() for x in _flat(p)])
    b = np.concatenate([x.ravel() for x in _flat(jp)])
    off = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b)
    assert off.mean() <= 1e-3, off.mean()
    assert np.abs(a - b).max() <= 2 * LR * steps


@pytest.mark.parametrize("optimizer", ["sgdm", "adamw"])
@pytest.mark.parametrize("name", list(SMOKES))
def test_two_train_steps_match_reference_fp32(name, optimizer):
    run, init, ref = reference_steps(name, optimizer=optimizer)
    out = port_steps(run, init)
    for step, ((p, m), (jp, jm)) in enumerate(zip(out, ref), 1):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["ce_loss"], jm["ce_loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(m["lr"], jm["lr"], rtol=1e-6)
        np.testing.assert_allclose(m["accuracy"], jm["accuracy"], atol=1e-6)
        assert jax.tree.structure(p) == jax.tree.structure(jp)
        if optimizer == "sgdm":
            for a, b in zip(_flat(p), _flat(jp)):
                np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-4)
        else:
            _adam_close(p, jp, step)


def test_two_train_steps_match_reference_bf16_compute():
    run, init, ref = reference_steps("zamba2-smoke", "bfloat16")
    out = port_steps(run, init)
    for (p, m), (jp, jm) in zip(out, ref):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-2)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=5e-2)
        a, b = np.concatenate([x.ravel() for x in _flat(p)]), \
            np.concatenate([x.ravel() for x in _flat(jp)])
        off = np.abs(a - b) > 1e-3 + 1e-2 * np.abs(b)
        assert off.mean() < 0.02, off.mean()
        assert np.abs(a - b).max() <= 2 * LR * 2 + 1e-3  # two steps


@pytest.mark.parametrize("par", [{"microbatch": 2},
                                 {"grad_compression": "int8_ef"}],
                         ids=["microbatch2", "int8_ef"])
def test_train_step_options_match_reference(par):
    run, init, ref = reference_steps("falcon-mamba-smoke", **par)
    out = port_steps(run, init)
    for (p, m), (jp, jm) in zip(out, ref):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4)
        _adam_close(p, jp, 2)


def test_microbatch_matches_full_batch():
    run, init, _ = reference_steps("falcon-mamba-smoke")
    full = port_steps(run, init)
    halves = port_steps(run.replace(parallel=JPar(microbatch=2)), init)
    for (a, _), (b, _) in zip(full, halves):
        for x, y in zip(_flat(a), _flat(b)):
            np.testing.assert_allclose(x, y, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------
# optimizers, schedules, clipping, loss, compression
# --------------------------------------------------------------------------

def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)  # noqa
    return {"w": f(6, 5), "stack": {"k": f(2, 3, 4)}, "bias": f(5)}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor", "sgdm"])
def test_optimizer_updates_match_reference(optimizer):
    cfg = dict(optimizer=optimizer, lr=3e-2, warmup_steps=2, total_steps=10)
    jopt = joptim.make_optimizer(JTrain(**cfg))
    topt = toptim.make_optimizer(TrainConfig(**cfg))
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(T, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = _tree(10 + step, 0.1)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp,
                             jnp.asarray(step))
        tp, ts = topt.update(jax.tree.map(T, grads), ts, tp, step)
        for a, b in zip(jax.tree.leaves(jax.tree.map(N, tp)),
                        jax.tree.leaves(jp)):
            np.testing.assert_allclose(a, np.array(b), **EXACT)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=40, schedule=schedule)
    js = joptim.make_schedule(JTrain(**cfg))
    ts = toptim.make_schedule(TrainConfig(**cfg))
    for step in (0, 3, 5, 17, 39, 60):
        np.testing.assert_allclose(ts(step), float(js(jnp.asarray(step))),
                                   rtol=1e-6)


def test_clip_by_global_norm_matches_reference():
    for scale in (0.01, 10.0):
        g = _tree(3, scale)
        jc, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tc, tn = toptim.clip_by_global_norm(jax.tree.map(T, g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), **EXACT)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(N(a), np.array(b), **EXACT)


def test_cross_entropy_with_z_loss_matches_reference():
    rng = np.random.default_rng(4)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    targets = rng.integers(0, 11, (3, 7)).astype(np.int32)
    targets[0, :3] = -1  # masked
    for z in (0.0, 1e-4):
        jl, jm = jgrad.cross_entropy_loss(jnp.asarray(logits),
                                          jnp.asarray(targets), z_loss=z)
        tl, tm = tgrad.cross_entropy_loss(T(logits), T(targets), z_loss=z)
        np.testing.assert_allclose(float(tl), float(jl), **EXACT)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **EXACT)


def test_int8_error_feedback_matches_reference():
    grads, err = _tree(5), jax.tree.map(lambda x: x * 0.01, _tree(6))
    jd, je = jgrad.compress_int8_ef(jax.tree.map(jnp.asarray, grads),
                                    jax.tree.map(jnp.asarray, err))
    td, te = tgrad.compress_int8_ef(jax.tree.map(T, grads),
                                    jax.tree.map(T, err))
    for a, b in zip(tree_leaves(td) + tree_leaves(te),
                    jax.tree.leaves(jd) + jax.tree.leaves(je)):
        np.testing.assert_allclose(N(a), np.array(b), **EXACT)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_train_cli_runs_on_cpu(arch, capsys, tmp_path):
    """The CLI trains through the driver, which logs through
    ``MetricsLogger`` to stderr every 5 steps and at the last: a fresh
    start, then finite losses at steps 5 and 6."""
    assert tlaunch.main(["--device", "cpu", "--arch", arch, "--steps", "6",
                         "--seq", "16", "--batch", "2",
                         "--ckpt-dir", str(tmp_path)]) == 0
    lines = [line for line in capsys.readouterr().err.splitlines()
             if line.startswith(f"[train-{arch}] ")]
    assert "event=init_fresh" in lines[0]
    logged = {int(line.split("step=")[1].split()[0]):
              float(line.split("loss=")[1].split()[0])
              for line in lines if " loss=" in line}
    assert sorted(logged) == [5, 6] and np.isfinite(list(logged.values())).all()


def test_train_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        return  # the default device exists here; nothing to refuse
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "falcon-mamba-7b", "--steps", "1"])
