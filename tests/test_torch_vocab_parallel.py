"""The vocab-parallel cross-entropy of the port's sharded train step
(``train/grad.py::cross_entropy_loss(..., vocab=)``, the head's logits a
rank's vocab block: ``models/layers.py::lm_logits``), on the CPU.

- The loss alone on two and four gloo ranks (a model axis of 2 and 4, and
  2 data x 2 model ranks) against one process on the whole logits: the
  metrics within 1e-6 relative, each rank's gradient of its block within
  1e-5 of the one process's in norm.  The targets fall in every rank's
  block, some are masked (-1), a row's maximum is tied across a block
  boundary (the first index wins, as ``argmax`` over the row), the
  z-loss is on.
- Train steps on gloo ranks against one process
  (``torch_sharded_cases.hold``: metrics 1e-6, gradients 1e-5, bytes equal
  to the dry run's trace): llama3.2-1b with the vocab over two ranks under
  ``sp``, over four ranks, and under ``sp`` and FSDP; deepseek-v3-671b's
  main and MTP losses over two.
- The traces: at llama3.2-1b ``train_smoke`` tp=2 the all-gather bytes
  equal the reference's partitioned compile's (each row's fp32 maximum
  and int32 index), and no collective's operand has a dim of the whole
  vocab; in every family's sharded train step (smoke configs with a vocab
  of 136 at tp=2, and llama3.2-1b under ``sp`` and FSDP) no op makes a
  tensor with a dim of 136, and the head makes the 68-column block.
- ``CompiledPerfEnv`` prices the default train_4k plans of llama3.2-1b,
  h2o-danube-1.8b and zamba2-2.7b (at or under 80 GiB a chip) instead of
  refusing them.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

import torch_sharded_cases as sc
from repro_torch.configs.registry import make_run
from repro_torch.kernels import ops
from repro_torch.launch.build import lower_step
from repro_torch.launch.mesh import MeshSpec
from repro_torch.sharding import collectives
from repro_torch.train.grad import cross_entropy_loss
from repro_torch.utils.config import MeshConfig

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
B, S, V = 4, 8, 24
Z_LOSS = 1e-2
#: world -> (data ranks, model ranks) meshes the loss runs on
MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}


def _inputs(blocks):
    """Seeded logits and targets: the targets in every one of ``blocks``
    vocab blocks, masked (-1) targets, and rows whose maximum is tied
    across the first block boundary, each targeting the tie's first
    index."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(B, S, V)).astype(np.float32)
    width = V // blocks
    targets = rng.integers(0, V, size=(B, S))
    targets[0, :blocks] = np.arange(blocks) * width + 1  # every block
    targets[1, :3] = -1
    for s in (4, 5):  # hits only where the first index wins
        logits[2, s, width - 1] = logits[2, s, width] = 9.0
        targets[2, s] = width - 1
    return logits, targets


def _one_process(blocks):
    logits, targets = _inputs(blocks)
    x = torch.tensor(logits, requires_grad=True)
    loss, metrics = cross_entropy_loss(x, torch.tensor(targets), Z_LOSS)
    loss.backward()
    return ({k: float(v.detach()) for k, v in metrics.items()},
            float(loss.detach()), x.grad)


def _loss_rank(rank, root, world):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(root, f"loss{world}"), world), rank=rank,
        world_size=world)
    try:
        out = {}
        for data, model in MESHES[world]:
            groups = {}
            for name, members in (
                    ("model", [[d * model + m for m in range(model)]
                               for d in range(data)]),
                    ("data", [[d * model + m for d in range(data)]
                              for m in range(model)])):
                for ranks in members:  # every rank makes every group
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[name] = collectives.Axis(
                            g, name, len(ranks), ranks.index(rank))
            vocab, rows = groups["model"], groups["data"]
            logits, targets = _inputs(model)
            n, width = B // data if B % data == 0 else B, V // model
            r0 = rows.rank * n if data > 1 else 0
            block = torch.tensor(logits[r0:r0 + n, :, vocab.rank * width:
                                        (vocab.rank + 1) * width],
                                 requires_grad=True)
            loss, metrics = cross_entropy_loss(
                block, torch.tensor(targets[r0:r0 + n]), Z_LOSS,
                group=rows if data > 1 else None, vocab=vocab)
            loss.backward()
            out[data, model] = ({k: float(v.detach())
                                 for k, v in metrics.items()},
                                float(loss.detach()), block.grad,
                                (r0, n, width))
        torch.save(out, os.path.join(root, f"loss{world}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def loss_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vocab"))
    out = {}
    for world in MESHES:
        mp.spawn(_loss_rank, args=(root, world), nprocs=world, join=True)
        out[world] = [torch.load(os.path.join(root, f"loss{world}_{r}.pt"))
                      for r in range(world)]
    return out


LOSS_CASES = [(w, m) for w, ms in MESHES.items() for m in ms]


@pytest.mark.parametrize("world,mesh", LOSS_CASES,
                         ids=[f"{d}x{m}" for _, (d, m) in LOSS_CASES])
def test_loss_on_blocks_as_one_process(loss_ranks, world, mesh):
    data, model = mesh
    metrics, loss, grad = _one_process(model)
    assert metrics["z_loss"] > 0 and 0 < metrics["accuracy"] < 1
    shares = {}
    for rank, rec in enumerate(loss_ranks[world]):
        got, got_loss, got_grad, (r0, n, width) = rec[mesh]
        for k, v in metrics.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
        m = rank % model
        want = grad[r0:r0 + n, :, m * width:(m + 1) * width]
        assert float((got_grad - want).norm()) <= \
            1e-5 * float(want.norm()), (rank, mesh)
        shares[rank // model] = got_loss  # the same on every model rank
    np.testing.assert_allclose(sum(shares.values()), loss, rtol=1e-6)


@pytest.mark.parametrize("blocks", (2, 4))
def test_the_tied_rows_are_hits_of_the_first_index(blocks):
    """The one process's accuracy, which every rank's equals, counts the
    tied rows: a block that took the second index would miss both."""
    logits, targets = _inputs(blocks)
    whole = torch.tensor(logits).argmax(-1)
    width = V // blocks
    assert int(whole[2, 4]) == int(whole[2, 5]) == width - 1
    assert int(targets[2, 4]) == int(targets[2, 5]) == width - 1


TWO = (
    ("llama-sp", "llama3.2-1b", 4, 32, dict(tp=2, sp=True), None, "adamw"),
    ("deepseek-mtp", "deepseek-v3-671b", 2, 512, dict(tp=2), None,
     "adamw"),
)
FOUR = (
    ("llama-tp4", "llama3.2-1b", 4, 32, dict(tp=4), None, "adamw"),
    ("llama-sp-fsdp", "llama3.2-1b", 4, 32, dict(tp=2, fsdp=2, sp=True),
     None, "adamw"),
)


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vocab_steps"))
    return {2: sc.spawn(root, 2, TWO), 4: sc.spawn(root, 4, FOUR)}


@pytest.mark.parametrize("case", TWO + FOUR,
                         ids=[c[0] for c in TWO + FOUR])
def test_vocab_split_steps_as_one_process(step_ranks, case):
    records = step_ranks[2 if case in TWO else 4]
    run = records[0][case[0]][0]
    assert run.model.vocab_size % run.parallel.tp == 0
    sc.hold(records, case)
    if case[0] == "deepseek-mtp":
        assert "mtp_loss" in records[0][case[0]][1][0]


def _tp2(arch, shape="train_smoke"):
    run = make_run(arch, shape, smoke=True)
    return run.replace(mesh=MeshConfig(shape=(1, 2), axes=("data", "model")),
                       parallel=run.parallel.replace(tp=2, fsdp=1))


def test_all_gathers_equal_the_partitioned_compile():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dryrun_reference.py"),
         "--collectives", "llama3.2-1b:train_smoke"], env=env,
        capture_output=True, text=True, timeout=600, check=True)
    want = json.loads(out.stdout.strip().splitlines()[-1])
    want = want["llama3.2-1b:train_smoke"]["all-gather"]
    run = _tp2("llama3.2-1b")
    shapes = []
    count = collectives._count

    def spy(kind, axis, t):
        shapes.append((kind, tuple(t.shape)))
        return count(kind, axis, t)

    collectives._count = spy
    try:
        _, traced = lower_step(run, MeshSpec.of(run.mesh.shape,
                                                run.mesh.axes))
    finally:
        collectives._count = count
    got = traced.cost_analysis().collective_bytes
    b, s = run.shape.global_batch, run.shape.seq_len
    assert got["all-gather"] == want == 2 * b * s * 4
    assert sorted(shape for kind, shape in shapes
                  if kind == "all-gather") == [(b, s, 1)] * 2
    assert all(run.model.vocab_size not in shape for _, shape in shapes)


class _Shapes(TorchDispatchMode):
    """Every dim of every tensor an op of the traced step makes (while the
    dry run's counter listens: not the arguments' templates)."""

    def __init__(self):
        super().__init__()
        self.dims = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if ops.KERNEL_SCOPE.counter is not None:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.dims.update(t.shape)
        return out


WIDE = 136  # a vocab no other dim of the smoke configs has
TRACED = [(a, {}) for a in ("llama3.2-1b", "deepseek-v3-671b",
                            "falcon-mamba-7b", "zamba2-2.7b",
                            "llama-3.2-vision-11b", "whisper-large-v3")]
TRACED.append(("llama3.2-1b", dict(fsdp=2, sp=True)))


@pytest.mark.parametrize("arch,par", TRACED,
                         ids=[a + ("-sp-fsdp" if p else "")
                              for a, p in TRACED])
def test_no_rank_makes_a_whole_vocab_tensor(arch, par):
    run = _tp2(arch)
    run = run.replace(model=run.model.replace(vocab_size=WIDE),
                      parallel=run.parallel.replace(**par))
    if par.get("fsdp", 1) > 1:
        run = run.replace(mesh=MeshConfig(shape=(2, 2),
                                          axes=("data", "model")))
    spy = _Shapes()
    with spy:
        lower_step(run, MeshSpec.of(run.mesh.shape, run.mesh.axes))
    assert WIDE // 2 in spy.dims
    assert WIDE not in spy.dims


@pytest.mark.parametrize("arch", ("llama3.2-1b", "h2o-danube-1.8b",
                                  "zamba2-2.7b"))
def test_compiled_env_prices_the_default_train_plan(arch, tmp_path):
    from repro_torch.configs.registry import default_parallel
    from repro_torch.tuner.compiled_env import CompiledPerfEnv

    env = CompiledPerfEnv(arch, "train_4k", cache_dir=str(tmp_path))
    config = env.space.default_config()
    config["remat"] = default_parallel(arch, "train").remat
    counters, y = env.intervene(config)
    assert config["remat"] == "dots"
    assert counters["peak_mem_gb"] <= 80
    assert math.isfinite(y) and y > 0
