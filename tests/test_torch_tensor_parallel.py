"""Tensor parallelism of the port's train step on the CPU: gloo ranks on a
``FileStore`` (``torch_sharded_cases``) against one process stepping on
the same global batch, smoke configs in fp32, 3 steps.

Cases: llama3.2-1b (dense GQA), deepseek-v3-671b (MLA, MoE with its
experts on the model axis, MTP), falcon-mamba-7b (Mamba-1) and
zamba2-2.7b (Mamba-2 and the shared attention block) at tp=2 on a
``(1, 2)`` ``("data", "model")`` mesh; llama3.2-1b at tp=2 and fsdp=2 on
``(2, 2)`` and on ``(2, 1, 2)`` ``("pod", "data", "model")``.  Each rank's
metrics are held within 1e-6 relative, every leaf's step-1 gradient
(gathered whole) within 1e-5 in norm, the final parameters within 1e-5 +
1e-5 |p|, and the bytes its collectives sent within a step equal the dry
run's derivation for the same run and mesh.  The llama3.2 tp=2 ranks also
start from the reference's parameters (``params_from_jax``): the first
loss is the reference's one-device ``make_train_step`` loss.
"""

import os

import numpy as np
import pytest
import torch

import torch_sharded_cases as sc

torch.set_num_threads(1)

TWO = (
    ("llama-tp2", "llama3.2-1b", 4, 32, dict(tp=2), None, "adamw"),
    ("deepseek-tp2", "deepseek-v3-671b", 2, 512, dict(tp=2), None, "adamw"),
    ("falcon-mamba-tp2", "falcon-mamba-7b", 4, 32, dict(tp=2), None,
     "adamw"),
    ("zamba2-tp2", "zamba2-2.7b", 4, 32, dict(tp=2), None, "adamw"),
)
FOUR = (
    ("llama-tp2-fsdp2", "llama3.2-1b", 4, 32, dict(tp=2, fsdp=2), None,
     "adamw"),
    ("llama-pod", "llama3.2-1b", 4, 32, dict(tp=2, fsdp=2),
     ((2, 1, 2), ("pod", "data", "model")), "adamw"),
)
#: the replicated leaves that feed split heads or channels (their
#: gradients sum every model rank's share)
FEEDS = {
    "deepseek-tp2": ("blocks/sub0/attn/w_dq", "blocks/sub0/attn/w_dkv",
                     "blocks/sub0/moe/router", "mtp/block/attn/w_dkv"),
    "falcon-mamba-tp2": ("blocks/sub0/mixer/w_bcdt",),
    "zamba2-tp2": ("blocks/sub0/mixer/w_B", "blocks/sub0/mixer/w_C",
                   "blocks/sub0/mixer/w_dtp", "blocks/sub0/mixer/A_log",
                   "blocks/sub0/mixer/conv_bc_w",
                   "blocks/sub0/mixer/conv_bc_b",
                   "shared_attn/attn/wq"),
}
REF_LR = 1e-2  # the reference train test's run (tests/test_torch_train.py)


def _reference_run():
    from repro_torch.utils.config import (MeshConfig, ParallelConfig,
                                          RunConfig, ShapeConfig, TrainConfig)
    cfg = sc.get_smoke_config("llama3.2-1b").replace(dtype="float32")
    return RunConfig(model=cfg, shape=ShapeConfig("train", 24, 4, "train"),
                     mesh=MeshConfig(shape=(1,), axes=("data",)),
                     parallel=ParallelConfig(tp=2),
                     train=TrainConfig(lr=REF_LR, warmup_steps=1,
                                       total_steps=10,
                                       compute_dtype="float32"))


def _from_reference(rank, root):
    """tp=2 from the reference's parameters: this rank's first loss."""
    from repro_torch.models.interop import params_from_jax

    run = _reference_run()
    init = torch.load(os.path.join(root, "ref_init.pt"), weights_only=False)
    params = params_from_jax(init, run.model, device="cpu")
    _, logged, _, _, _ = sc.loop(run, params)
    return {"reference": logged[0]["loss"]}


def _reference_first_loss(root):
    """The reference's one-device ``make_train_step`` on its own
    parameters (saved for the ranks): the first step's loss."""
    import jax
    import jax.numpy as jnp
    from repro.data.pipeline import make_data as jmake_data
    from repro.models.model import build_model as jbuild
    from repro.train import optimizer as joptim
    from repro.train.train_step import init_train_state as jinit_state
    from repro.train.train_step import make_train_step as jmake_step
    from repro.utils.config import RunConfig as JRun

    run = JRun.from_json(_reference_run().replace(
        parallel=sc.ParallelConfig()).to_json())
    model = jbuild(run.model, run.parallel)
    opt = joptim.make_optimizer(run.train)
    state = jinit_state(model, run, opt, jax.random.PRNGKey(0))
    torch.save(jax.tree.map(np.array, state.params),
               os.path.join(root, "ref_init.pt"))
    batch = jmake_data(run.model, run.shape, seed=0).batch_at(0)
    _, m = jax.jit(jmake_step(model, run, opt))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m["loss"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    ref = _reference_first_loss(root)
    two = sc.spawn(root, 2, TWO, extra=_from_reference)
    four = sc.spawn(root, 4, FOUR)
    return {2: two, 4: four, "reference": ref}


@pytest.mark.parametrize("case", TWO, ids=[c[0] for c in TWO])
def test_tp2_steps_as_one_process(ranks, case):
    sc.hold(ranks[2], case, FEEDS.get(case[0], ()))


@pytest.mark.parametrize("case", FOUR, ids=[c[0] for c in FOUR])
def test_tp2_fsdp2_steps_as_one_process(ranks, case):
    sc.hold(ranks[4], case)


def test_tp2_from_reference_parameters_gives_the_reference_loss(ranks):
    want = ranks["reference"]
    for rec in ranks[2]:
        np.testing.assert_allclose(rec["reference"], want, rtol=1e-5)


def test_split_heads_run_at_their_local_shapes():
    """The kernels see a rank's heads and channels: llama3.2-1b's 32 / 8
    heads are 16 / 4 at tp=2, zamba2's 80 SSD heads 40, falcon-mamba's
    8192 scan channels 4096 (the placements on a description)."""
    from repro_torch.configs.registry import get_model_config
    from repro_torch.launch.mesh import MeshSpec, local_shard
    from repro_torch.models.model import build_model
    from repro_torch.sharding.layout import specs_at
    from repro_torch.sharding.specs import param_specs
    from repro_torch.utils.config import ParallelConfig

    mesh = MeshSpec.of((1, 2), ("data", "model"))
    par = ParallelConfig(tp=2)
    want = {"llama3.2-1b": {"blocks/sub0/attn/wq": 16 * 64,
                            "blocks/sub0/attn/wk": 4 * 64},
            "zamba2-2.7b": {"blocks/sub0/mixer/D": 40},
            "falcon-mamba-7b": {"blocks/sub0/mixer/D": 4096}}
    for arch, leaves in want.items():
        cfg = get_model_config(arch)
        params = build_model(cfg, par, device="meta").init(0)
        specs = param_specs(params, cfg, par, mesh)
        for path, width in leaves.items():
            leaf = local_shard(specs_at(params, path),
                               specs_at(specs, path), mesh,
                               {"data": 0, "model": 1})
            assert leaf.shape[-1] == width, (arch, path, leaf.shape)


def test_a_split_through_a_head_raises_with_the_shapes():
    """tp=2 on one KV head of 64: the rule splits ``wk``'s 64 columns, a
    rank would hold half a head."""
    from repro_torch.models.attention import _local_heads
    from repro_torch.sharding.layout import Layout, Scope
    from repro_torch.sharding.specs import P
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.sharding.collectives import Axis

    mesh = MeshSpec(("data", "model"), {"data": 1, "model": 2},
                    {"data": Axis(None, "data", 1, 0),
                     "model": Axis(None, "model", 2, 0),
                     "world": Axis(None, "data,model", 2, 0)}, 0)
    specs = {f"attn/{w}": P(None, "model") for w in ("wq", "wk", "wv")}
    specs["attn/wo"] = P("model", None)
    scope = Scope(Layout(specs, mesh), "attn/")
    with pytest.raises(ValueError, match="whole heads"):
        _local_heads(scope, ("wq", "wk", "wv", "wo"), (4, 1, 1, 4), 64)
    assert _local_heads(scope, ("wq", "wk", "wv", "wo"), (4, 2, 2, 4),
                        64) == (2, 1)
