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

import functools

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
#: the reference-parameter check: tp=2 ranks from the reference's init
REFERENCE = (("reference", sc.reference_run("llama3.2-1b", tp=2)),)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp"))
    ref = sc.reference_first_loss(root, REFERENCE[0][1], "reference")
    two = sc.spawn(root, 2, TWO, extra=functools.partial(
        sc.from_reference, runs=REFERENCE))
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
    rank would hold half a head.  That split executes (it raised before
    the head plan): each rank gathers the key and value products and
    takes the whole head its query heads read.  What raises, with the
    shapes, is a split the plan cannot execute: the output weight split
    by columns."""
    from repro_torch.models.attention import head_split
    from repro_torch.sharding.layout import Layout, Scope
    from repro_torch.sharding.specs import P
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.sharding.collectives import Axis

    mesh = MeshSpec(("data", "model"), {"data": 1, "model": 2},
                    {"data": Axis(None, "data", 1, 0),
                     "model": Axis(None, "model", 2, 1),
                     "world": Axis(None, "data,model", 2, 1)}, 1)
    specs = {f"attn/{w}": P(None, "model") for w in ("wq", "wk", "wv")}
    specs["attn/wo"] = P("model", None)
    scope = Scope(Layout(specs, mesh), "attn/")
    plan = head_split(scope, 4, 1, 64)
    assert (plan.q, plan.kv, plan.gather_q, plan.gather_kv) == (
        (2, 4), (0, 1), False, True)
    plan = head_split(scope, 4, 2, 64)
    assert (plan.q, plan.kv, plan.gather_q, plan.gather_kv) == (
        (2, 4), (1, 2), False, False)
    specs["attn/wo"] = P(None, "model")
    with pytest.raises(ValueError, match=r"split on dims \[1, 1, 1, 1\]"):
        head_split(Scope(Layout(specs, mesh), "attn/"), 4, 2, 64)
