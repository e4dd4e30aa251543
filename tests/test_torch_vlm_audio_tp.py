"""The vlm and audio families on a model axis in the port's train step, on
the CPU: gloo ranks on a ``FileStore`` (``torch_sharded_cases``) against
one process stepping on the same global batch, smoke configs in fp32, 3
steps, the vision gates opened (``open_gates``: the reference's zeros
would zero every cross weight's gradient).

llama-3.2-vision-11b (a gated cross-attention sublayer: ``cross/wq|wk|wv``
split by head, ``cross/wo`` by rows over the patch embeddings every rank
holds whole) at ``tp=2`` and ``tp=2, sp``; whisper-large-v3 (the
encoder-decoder: ``frame_proj`` split by columns and all-gathered, the
encoder's and the decoder's attention on split heads, the encoder output
entering the decoder's cross K/V once) at ``tp=2``, at ``tp=4`` on 4 ranks
(1 of the smoke config's 4 heads a rank) and at ``tp=2, sp``, which is
``tp=2`` bit for bit: as in the reference no activation of the audio
family is constrained; on 4 ranks also whisper at ``tp=2, fsdp=2``, the
vision model at ``tp=2, fsdp=2, sp`` and at ``tp=4``, where two ranks
share each of the smoke config's 2 KV heads (the published ``tp=16``
over 8 KV heads: the key / value products all-gathered, each rank taking
the head its query heads read).  Each rank's metrics are held within
1e-6 relative, every leaf's step-1 gradient (gathered whole) within 1e-5
in norm, the final parameters within 1e-5 + 1e-5 |p|, and the bytes its
collectives sent within a step equal the dry run's derivation.  Both
families also start from the reference's parameters at ``tp=2``: the first
loss is the reference's one-device ``make_train_step`` loss.
"""

import functools

import numpy as np
import pytest
import torch

import torch_sharded_cases as sc

torch.set_num_threads(1)

TWO = (
    ("vision-tp2", "llama-3.2-vision-11b", 4, 32, dict(tp=2), None,
     "adamw"),
    ("vision-sp", "llama-3.2-vision-11b", 4, 32, dict(tp=2, sp=True), None,
     "adamw"),
    ("whisper-tp2", "whisper-large-v3", 4, 32, dict(tp=2), None, "adamw"),
    ("whisper-sp", "whisper-large-v3", 4, 32, dict(tp=2, sp=True), None,
     "adamw"),
)
FOUR = (
    ("whisper-tp4", "whisper-large-v3", 4, 32, dict(tp=4), None, "adamw"),
    # FSDP beside the model axis: no backward gather of the weights that
    # read a stub input (``frame_proj``, the vision cross K/V)
    ("whisper-tp2-fsdp2", "whisper-large-v3", 4, 32, dict(tp=2, fsdp=2),
     None, "adamw"),
    ("vision-sp-fsdp2", "llama-3.2-vision-11b", 4, 32,
     dict(tp=2, fsdp=2, sp=True), None, "adamw"),
    # two ranks a KV head, as the published tp=16 gives 8 KV heads: the
    # key / value products gathered, self and cross
    ("vision-tp4", "llama-3.2-vision-11b", 4, 32, dict(tp=4), None,
     "adamw"),
)
_VISION = ("blocks/sub1/cross_norm/scale", "blocks/sub1/cross_gate",
           "blocks/sub1/cross/wk", "blocks/sub1/attn_norm/scale")
_WHISPER = ("enc_norm/scale", "final_norm/scale", "frame_proj",
            "dec_blocks/cross_norm/scale", "dec_blocks/cross/wk",
            "enc_blocks/attn/wq")
#: the leaves the model axis leaves whole that the split must sum (the
#: stream leaves under ``sp``: the norm scales and the gate), and the
#: split weights of the cross path and the encoder
MUST = {"vision-tp2": _VISION, "vision-sp": _VISION,
        "vision-sp-fsdp2": _VISION, "vision-tp4": _VISION,
        "whisper-tp2": _WHISPER,
        "whisper-sp": _WHISPER, "whisper-tp4": _WHISPER,
        "whisper-tp2-fsdp2": _WHISPER}
REFERENCE = (("vision", sc.reference_run("llama-3.2-vision-11b", tp=2)),
             ("whisper", sc.reference_run("whisper-large-v3", tp=2)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vlm_audio"))
    ref = {name: sc.reference_first_loss(root, run, name)
           for name, run in REFERENCE}
    two = sc.spawn(root, 2, TWO, extra=functools.partial(
        sc.from_reference, runs=REFERENCE))
    four = sc.spawn(root, 4, FOUR)
    return {2: two, 4: four, "reference": ref}


@pytest.mark.parametrize("case", TWO, ids=[c[0] for c in TWO])
def test_tp2_steps_as_one_process(ranks, case):
    sc.hold(ranks[2], case, MUST[case[0]])


@pytest.mark.parametrize("case", FOUR, ids=[c[0] for c in FOUR])
def test_four_ranks_step_as_one_process(ranks, case):
    sc.hold(ranks[4], case, MUST[case[0]])


def test_the_cross_path_moves_under_the_split(ranks):
    """The opened gates give the cross weights a gradient, so the vision
    runs hold the cross path itself (not zeros against zeros)."""
    _, _, grads, _, _ = ranks[2][0]["vision-tp2"]
    for k in ("blocks/sub1/cross/wq", "blocks/sub1/cross/wk",
              "blocks/sub1/cross/wo", "blocks/sub1/cross_gate"):
        assert float(grads[k].norm()) > 0, k


def test_whisper_sp_is_tp2_bit_for_bit(ranks):
    for rec in ranks[2]:
        _, logged, grads, params, counted = rec["whisper-sp"]
        _, t_logged, t_grads, t_params, t_counted = rec["whisper-tp2"]
        assert logged == t_logged
        for k in grads:
            assert torch.equal(grads[k], t_grads[k]), k
        for k in params:
            assert torch.equal(params[k], t_params[k]), k
        assert counted == t_counted


def test_reference_parameters_give_the_reference_loss(ranks):
    for name, _ in REFERENCE:
        want = ranks["reference"][name]
        for rec in ranks[2]:
            np.testing.assert_allclose(rec[name], want, rtol=1e-5,
                                       err_msg=name)


def test_cross_and_encoder_heads_split_at_the_published_plans():
    """At the published widths and default plans: llama-3.2-vision-11b at
    tp=16 holds 2 of 32 query heads a rank and half of one of its 8 KV
    heads (64 of 1024 ``wk`` columns), self and cross (the cross K/V over
    4096-wide patch embeddings), so each rank gathers the key and value
    products and reads KV head ``rank // 2``; whisper-large-v3 at tp=4
    holds 5 of 20 heads in the encoder, the decoder and the cross path
    (``frame_proj`` 320 of 1280 columns; its vocab of 51866 does not
    divide by 4, so the embedding stays whole), no gather."""
    from repro_torch.configs.registry import default_parallel
    from repro_torch.configs.registry import get_model_config
    from repro_torch.launch.mesh import MeshSpec, local_shard
    from repro_torch.models.attention import split_heads
    from repro_torch.models.model import build_model
    from repro_torch.sharding.layout import specs_at
    from repro_torch.sharding.specs import P, param_specs

    want = {
        "llama-3.2-vision-11b": {
            "blocks/sub4/cross/wq": (4096, 2 * 128),
            "blocks/sub4/cross/wk": (4096, 64),
            "blocks/sub4/cross/wo": (2 * 128, 4096),
            "blocks/sub0/attn/wq": (4096, 2 * 128),
            "blocks/sub0/attn/wv": (4096, 64)},
        "whisper-large-v3": {
            "enc_blocks/attn/wq": (1280, 5 * 64),
            "dec_blocks/cross/wk": (1280, 5 * 64),
            "dec_blocks/cross/wo": (5 * 64, 1280),
            "frame_proj": (1280, 320),
            "embed/embedding": (51866, 1280)},
    }
    for arch, leaves in want.items():
        cfg = get_model_config(arch)
        par = default_parallel(arch, "train")
        tp = par.tp
        mesh = MeshSpec.of((1, tp), ("data", "model"))
        params = build_model(cfg, par, device="meta").init(0)
        specs = param_specs(params, cfg, par, mesh)
        for path, shape in leaves.items():
            leaf = local_shard(specs_at(params, path), specs_at(specs, path),
                               mesh, {"data": 0, "model": tp - 1})
            assert tuple(leaf.shape[-2:]) == shape, (arch, path, leaf.shape)
        assert specs_at(specs, "embed/embedding") == (
            P("model", None) if arch.startswith("llama") else P(None, None))
        for r in range(tp):
            plan = split_heads(cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, tp, r, True)
            if arch.startswith("llama"):
                assert (plan.q, plan.kv, plan.gather_q, plan.gather_kv,
                        plan.group) == ((2 * r, 2 * r + 2),
                                        (r // 2, r // 2 + 1), False, True,
                                        None)
            else:
                assert (plan.q, plan.kv, plan.gather_q,
                        plan.gather_kv) == ((5 * r, 5 * r + 5),
                                            (5 * r, 5 * r + 5), False, False)


@pytest.mark.parametrize("arch", [
    "llama3.2-1b", "nemotron-4-15b", "command-r-35b", "h2o-danube-1.8b",
    "llama4-maverick-400b-a17b", "llama-3.2-vision-11b", "whisper-large-v3",
    "zamba2-2.7b"])
def test_every_published_plan_gives_each_rank_its_heads(arch):
    """At each arch's default train plan every model rank's head plan
    covers exactly its ``wo`` rows: the query heads it computes hold its
    row block, its KV heads are the ones they read, and the ranks' row
    blocks tile the output.  nemotron, command-r and the vision model
    split their 8 KV heads over 16 ranks; llama4-maverick also gives each
    rank 2.5 of its 40 query heads (it computes 3, gathered)."""
    from repro_torch.configs.registry import default_parallel
    from repro_torch.configs.registry import get_model_config
    from repro_torch.models.attention import split_heads

    cfg = get_model_config(arch)
    tp, hd = default_parallel(arch, "train").tp, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    kv_split = hkv * hd % tp == 0
    rows = []
    for r in range(tp):
        plan = split_heads(hq, hkv, hd, tp, r, kv_split)
        lo, hi = plan.out
        q0, q1 = plan.q
        rows.append((q0 * hd + lo, q0 * hd + hi))
        assert 0 <= lo < hi <= (q1 - q0) * hd
        assert plan.kv == (q0 // (hq // hkv), (q1 - 1) // (hq // hkv) + 1)
        assert plan.gather_q == (hq % tp != 0)
        assert plan.gather_kv == (kv_split and hkv % tp != 0)
    assert rows == [(r * hq * hd // tp, (r + 1) * hq * hd // tp)
                    for r in range(tp)]
    if arch == "llama4-maverick-400b-a17b":
        assert {split_heads(hq, hkv, hd, tp, r, kv_split).q[1]
                - split_heads(hq, hkv, hd, tp, r, kv_split).q[0]
                for r in range(tp)} == {3}
