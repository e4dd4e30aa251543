"""Sequence parallelism (``ParallelConfig.sp``) in the port's train step on
the CPU: gloo ranks on a ``FileStore`` (``torch_sharded_cases``) against
one process stepping on the same global batch, smoke configs in fp32, 3
steps.

Under ``sp`` the residual stream between sublayers is each model rank's
sequence block, as the reference's ``activation_sharding`` asks: the
embedding reduce-scatters, each sublayer all-gathers its input and
reduce-scatters its row-parallel output, the head gathers the sequence,
and the gradients of the norm scales (applied to the blocks) are summed
over the model axis.  Cases: llama3.2-1b (dense GQA), deepseek-v3-671b
(MLA, MoE with its experts on the model axis, MTP), falcon-mamba-7b
(Mamba-1) and zamba2-2.7b (Mamba-2 and the shared attention block) at
``tp=2, sp`` on a ``(1, 2)`` ``("data", "model")`` mesh; llama3.2-1b at an
odd sequence length, where the rule keeps the stream whole, beside the
same run without ``sp``, and at a vocab of 127 that the model axis does
not divide (the embedding and the head whole); llama3.2-1b at ``tp=2,
fsdp=2, sp`` on ``(2, 2)`` and on ``(2, 1, 2)`` ``("pod", "data",
"model")``, and deepseek-v3-671b there with its experts on the data axis;
llama3.2-1b with 6 query heads at ``tp=4, sp``, a split through the
heads (1.5 query heads and half a KV head a rank: the products
gathered, each rank taking the heads its rows read).  Each rank's
metrics are held within 1e-6 relative, every
leaf's step-1 gradient (gathered whole) within 1e-5 in norm, the final
parameters within 1e-5 + 1e-5 |p|, and the bytes its collectives sent
within a step equal the dry run's derivation for the same run and mesh.
The llama3.2 ranks also start from the reference's parameters
(``params_from_jax``) under ``sp``: the first loss is the reference's
one-device ``make_train_step`` loss.
"""

import functools

import numpy as np
import pytest
import torch

import torch_sharded_cases as sc

torch.set_num_threads(1)

TWO = (
    ("llama-sp", "llama3.2-1b", 4, 32, dict(tp=2, sp=True), None, "adamw"),
    ("deepseek-sp", "deepseek-v3-671b", 2, 512, dict(tp=2, sp=True), None,
     "adamw"),
    ("falcon-mamba-sp", "falcon-mamba-7b", 4, 32, dict(tp=2, sp=True), None,
     "adamw"),
    ("zamba2-sp", "zamba2-2.7b", 4, 32, dict(tp=2, sp=True), None, "adamw"),
    ("llama-sp-odd", "llama3.2-1b", 4, 31, dict(tp=2, sp=True), None,
     "adamw"),
    # a vocab the model axis does not divide: the embedding and the head
    # stay whole, the lookup leaves for the block by its slice
    ("llama-sp-vocab", ("llama3.2-1b", {"vocab_size": 127}), 4, 32,
     dict(tp=2, sp=True), None, "adamw"),
)
#: the odd length's run without ``sp`` (compared with it, not with one
#: process)
TP_ODD = ("llama-tp2-odd", "llama3.2-1b", 4, 31, dict(tp=2), None, "adamw")
FOUR = (
    ("llama-sp-fsdp2", "llama3.2-1b", 4, 32, dict(tp=2, fsdp=2, sp=True),
     None, "adamw"),
    ("llama-sp-pod", "llama3.2-1b", 4, 32, dict(tp=2, fsdp=2, sp=True),
     ((2, 1, 2), ("pod", "data", "model")), "adamw"),
    # experts behind the all-to-alls: the routed share whole, the shared
    # expert's partial, each leaving for the block its own way
    ("deepseek-sp-ep", "deepseek-v3-671b", 4, 256,
     dict(tp=2, fsdp=2, sp=True, moe_expert_axis="data"), None, "adamw"),
    # a split through the heads (llama4-maverick's 2.5 query heads a rank
    # at tp=16, and half a KV head): 6 query and 2 KV heads over 4 ranks
    ("llama-sp-heads-cut", ("llama3.2-1b", {"num_heads": 6}), 4, 32,
     dict(tp=4, sp=True), None, "adamw"),
)
#: leaves applied to the stream's sequence blocks (their gradients sum
#: every model rank's block), and replicated leaves that feed split
#: heads or channels
STREAM = {
    "llama-sp": ("blocks/sub0/attn_norm/scale", "blocks/sub0/mlp_norm/scale",
                 "final_norm/scale"),
    "deepseek-sp": ("blocks/sub0/attn_norm/scale",
                    "blocks/sub0/mlp_norm/scale", "final_norm/scale",
                    "blocks/sub0/attn/w_dq", "blocks/sub0/attn/w_dkv",
                    "blocks/sub0/moe/router", "mtp/norm/scale",
                    "mtp/block/attn_norm/scale"),
    "falcon-mamba-sp": ("blocks/sub0/norm/scale", "final_norm/scale",
                        "blocks/sub0/mixer/w_bcdt"),
    "zamba2-sp": ("blocks/sub0/norm/scale", "shared_attn/norm/scale",
                  "shared_attn/mlp_norm/scale", "blocks/sub0/mixer/w_B",
                  "blocks/sub0/mixer/w_C", "blocks/sub0/mixer/w_dtp",
                  "blocks/sub0/mixer/A_log"),
}
#: the reference-parameter check: tp=2, sp ranks from the reference's init
REFERENCE = (("reference", sc.reference_run("llama3.2-1b", tp=2, sp=True)),)


def _norm_rows(rank, root):
    """One ``tp=2, sp`` step of llama3.2-1b at 4 x 32: the rows each
    ``ops.rmsnorm`` call saw on this rank."""
    from repro_torch.kernels import ops

    rows, real = [], ops.rmsnorm

    def spy(x, *a, **k):
        rows.append(x.numel() // x.shape[-1])
        return real(x, *a, **k)

    ops.rmsnorm = spy
    try:
        sc.loop(sc.make_run("llama3.2-1b", 4, 32, dict(tp=2, sp=True),
                            steps=1))
    finally:
        ops.rmsnorm = real
    return {"norm_rows": rows}


def _extra(rank, root):
    out = sc.from_reference(rank, root, REFERENCE)
    out.update(_norm_rows(rank, root))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sp"))
    ref = sc.reference_first_loss(root, REFERENCE[0][1], "reference")
    two = sc.spawn(root, 2, TWO + (TP_ODD,), extra=_extra)
    four = sc.spawn(root, 4, FOUR)
    return {2: two, 4: four, "reference": ref}


@pytest.mark.parametrize("case", TWO, ids=[c[0] for c in TWO])
def test_sp_steps_as_one_process(ranks, case):
    sc.hold(ranks[2], case, STREAM.get(case[0], ()))


@pytest.mark.parametrize("case", FOUR, ids=[c[0] for c in FOUR])
def test_sp_fsdp2_steps_as_one_process(ranks, case):
    sc.hold(ranks[4], case, STREAM["llama-sp"][-1:])


def test_sp_at_an_odd_length_steps_and_counts_as_tp_alone(ranks):
    """31 tokens do not split over 2 model ranks: the rule keeps the stream
    whole, so the run is ``tp=2``'s, bit for bit, collectives included."""
    from repro_torch.launch.build import lower_step
    from repro_torch.launch.mesh import MeshSpec

    for rec in ranks[2]:
        run, logged, grads, params, counted = rec["llama-sp-odd"]
        _, t_logged, t_grads, t_params, t_counted = rec["llama-tp2-odd"]
        assert logged == t_logged
        for k in grads:
            assert torch.equal(grads[k], t_grads[k]), k
        for k in params:
            assert torch.equal(params[k], t_params[k]), k
        assert counted == t_counted
        assert "reduce-scatter" not in counted
    mesh = MeshSpec.of(run.mesh.shape, run.mesh.axes)
    derived = [lower_step(r, mesh)[1].cost_analysis().collective_bytes
               for r in (run, run.replace(parallel=run.parallel.replace(
                   sp=False)))]
    assert derived[0] == derived[1]


def test_sp_norms_run_on_the_ranks_sequence_block(ranks):
    """Every RMSNorm of a ``tp=2, sp`` forward at 4 x 32 sees the rank's
    block of 4 x 16 rows."""
    for rec in ranks[2]:
        assert rec["norm_rows"] and set(rec["norm_rows"]) == {4 * 16}


def test_sp_from_reference_parameters_gives_the_reference_loss(ranks):
    want = ranks["reference"]
    for rec in ranks[2]:
        np.testing.assert_allclose(rec["reference"], want, rtol=1e-5)


def test_the_sequence_rule_and_the_stream_leaves():
    """``sequence_blocks`` is the reference's ``seq_spec``: the model
    axis' size under ``sp`` where it divides the sequence, else 1; the
    stream leaves are the norm scales and the vlm gate outside the MTP
    head; the audio family's layout never cuts its sequence."""
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models.model import build_model
    from repro_torch.sharding.collectives import Axis
    from repro_torch.sharding.layout import Layout
    from repro_torch.sharding.specs import sequence_blocks
    from repro_torch.utils.config import ParallelConfig

    sp = ParallelConfig(tp=2, sp=True)
    mesh = MeshSpec.of((1, 2), ("data", "model"))
    assert sequence_blocks(sp, mesh, 32) == 2
    assert sequence_blocks(sp, mesh, 31) == 1
    assert sequence_blocks(sp, mesh, 1) == 1  # decode
    assert sequence_blocks(ParallelConfig(tp=2), mesh, 32) == 1
    assert sequence_blocks(sp, MeshSpec.of((2,), ("data",)), 32) == 1
    assert sequence_blocks(sp, MeshSpec.of((2,), ("model",)), 32) == 1
    assert [p for p in ("blocks/sub0/attn_norm/scale", "final_norm/scale",
                        "blocks/sub1/cross_gate", "shared_attn/norm/scale",
                        "blocks/sub0/mixer/norm_scale", "mtp/norm/scale",
                        "blocks/sub0/attn/wq") if Layout.on_stream(p)] == [
        "blocks/sub0/attn_norm/scale", "final_norm/scale",
        "blocks/sub1/cross_gate", "shared_attn/norm/scale"]
    groups = MeshSpec(("data", "model"), {"data": 1, "model": 2},
                      {"data": Axis(None, "data", 1, 0),
                       "model": Axis(None, "model", 2, 0),
                       "world": Axis(None, "data,model", 2, 0)}, 0)
    for arch, want in (("llama3.2-1b", True), ("whisper-large-v3", False)):
        run = sc.make_run(arch, 4, 32, dict(tp=2, sp=True))
        params = build_model(run.model, run.parallel, device="meta").init(0)
        layout = Layout.of(params, run, groups)
        assert (layout.seq_axis(32) is not None) == want, arch


def test_scatter_and_shard_are_identities_without_a_split():
    """The sequence operators on one rank (no axis, or an axis of 1) give
    their input back; a block that does not divide raises."""
    from repro_torch.sharding import collectives as C

    x = torch.arange(24.0).reshape(2, 4, 3)
    one = C.Axis(None, "model", 1, 0)
    for axis in (None, one):
        assert C.scatter(x, axis, 1) is x
        assert C.shard(x, axis, 1) is x
    with pytest.raises(ValueError, match="does not split"):
        C.shard(x, C.Axis(None, "model", 3, 0), 1)
    got = functools.reduce(torch.add, (C._slice(x, C.Axis(None, "m", 2, r),
                                                 1) for r in range(2)))
    assert torch.equal(got, x[:, :2] + x[:, 2:])
