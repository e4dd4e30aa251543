"""The port's MoE serving against the JAX reference on the CPU, at the
``deepseek-smoke`` (MLA, sigmoid top-2 of 8, shared expert) and
``llama4-smoke`` (GQA, dense and MoE layers in turn, softmax top-1)
configs, parameters imported from the reference: the decode-state trees;
prefill and decode logits; greedy ``generate`` tokens; the continuous
batcher's tokens, completion order and counters (dense for both; llama4
also paged and paged with chunked prefill); deepseek's paged serving
raising as the reference's does; the serve CLI on ``--device cpu``.

Chunked prefill changes which tokens a MoE layer drops (the capacity
follows the chunk's token count), in the reference as in the port, so
each batcher geometry is held to the reference's same geometry, not to
the other geometries.  Tolerance: logits atol 2e-4 / rtol 1e-4 (fp32,
several layers); tokens and counters exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deepseek_v3_671b import SMOKE as J_DEEPSEEK_SMOKE
from repro.configs.llama4_maverick_400b import SMOKE as J_LLAMA4_SMOKE
from repro.models.model import build_model as jbuild
from repro.serving.paging import PagedPlan as JPagedPlan
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.train.serve_step import generate as jgenerate
from repro.train.serve_step import make_decode_step as jmake_decode
from repro.train.serve_step import make_prefill_step as jmake_prefill
from repro.utils.config import RunConfig as JRunConfig
from repro.utils.config import ShapeConfig as JShapeConfig
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.paging import PagedPlan
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.utils.config import ModelConfig, RunConfig, ShapeConfig

torch.set_num_threads(1)

SMOKES = {"deepseek-v3-671b": J_DEEPSEEK_SMOKE,
          "llama4-maverick-400b-a17b": J_LLAMA4_SMOKE}
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)


def _served(arch):
    jcfg = SMOKES[arch]
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("s", 64, 4, "decode"))
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    run = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 4, "decode"))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    return (jm, jrun, jp), (tm, run, tp)


# one module fixture per arch: loadfile puts this file on one worker
@pytest.fixture(scope="module")
def deepseek_served():
    return _served("deepseek-v3-671b")


@pytest.fixture(scope="module")
def llama4_served():
    return _served("llama4-maverick-400b-a17b")


@pytest.fixture
def served(request, deepseek_served, llama4_served):
    return {"deepseek-v3-671b": deepseek_served,
            "llama4-maverick-400b-a17b": llama4_served}[request.param]


ARCHS = pytest.mark.parametrize("served", list(SMOKES), indirect=True)


def _leaves(tree, prefix=""):
    """{path: (shape, dtype name)} of a decode-state tree of either
    package (dicts and named tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for name, v in zip(tree._fields, tree):
            out.update(_leaves(v, f"{prefix}.{name}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


# --------------------------------------------------------------------------
# decode-state trees
# --------------------------------------------------------------------------

@ARCHS
def test_decode_state_tree_matches_reference(served):
    (jm, _, _), (tm, _, _) = served
    assert _leaves(tm.init_decode_state(3, 20)) == \
        _leaves(jm.init_decode_state(3, 20))
    if tm.cfg.attn_type == "mla":
        assert {type(v).__name__ for v in
                tm.init_decode_state(3, 20).values()} == {"MLACache"}
        for init in (jm.init_paged_decode_state, tm.init_paged_decode_state):
            with pytest.raises(NotImplementedError, match="MLA"):
                init(3, 6, 4, 5)
    else:
        assert _leaves(tm.init_paged_decode_state(3, 6, 4, 5)) == \
            _leaves(jm.init_paged_decode_state(3, 6, 4, 5))


# --------------------------------------------------------------------------
# prefill / decode and generation against the reference
# --------------------------------------------------------------------------

@ARCHS
def test_prefill_and_decode_logits_match_reference(served):
    (jm, jrun, jp), (tm, run, tp) = served
    b, s, steps = 2, 8, 4
    toks = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (b, s + steps)).astype(np.int32)
    jpre = jax.jit(jmake_prefill(jm, jrun, cache_len=16))
    jdec = jax.jit(jmake_decode(jm, jrun))
    tpre, tdec = make_prefill_step(tm, run, cache_len=16), \
        make_decode_step(tm, run)
    jst, jl = jpre(jp, {"tokens": jnp.asarray(toks[:, :s])})
    tst, tl = tpre(tp, {"tokens": torch.as_tensor(toks[:, :s])})
    np.testing.assert_allclose(tl.numpy(), np.array(jl), **LOGIT_TOL)
    for i in range(steps):
        col = toks[:, s + i:s + i + 1]
        jst, jl = jdec(jp, jst, jnp.asarray(col))
        tst, tl = tdec(tp, tst, torch.as_tensor(col))
        np.testing.assert_allclose(tl.numpy(), np.array(jl), **LOGIT_TOL)
    for path, leaf in _flat(tst.caches).items():
        np.testing.assert_allclose(leaf.numpy(),
                                   np.array(_flat(jst.caches)[path]),
                                   **LOGIT_TOL)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {f"{prefix}.{name}": v for name, v in zip(tree._fields, tree)}


@ARCHS
def test_greedy_generate_matches_reference(served):
    from repro_torch.train.serve_step import generate

    (jm, jrun, jp), (tm, run, tp) = served
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (3, 9)).astype(np.int32)
    ref = np.array(jgenerate(jm, jrun, jp, {"tokens": jnp.asarray(toks)},
                             num_steps=6))
    out = generate(tm, run, tp, {"tokens": torch.as_tensor(toks)},
                   num_steps=6).numpy()
    np.testing.assert_array_equal(out, ref)


# --------------------------------------------------------------------------
# the continuous batcher
# --------------------------------------------------------------------------

GEOMETRIES = {
    "dense": None,
    "paged": dict(pool_pages=8, page_size=4, pages_per_slot_max=8),
    "paged_chunked": dict(pool_pages=8, page_size=4, pages_per_slot_max=8,
                          prefill_chunk=2),
}


def _run_both(served, geometry, *, n_requests=4, max_new=5, num_slots=2,
              lengths=(5, 3, 7, 4)):
    (jm, jrun, jp), (tm, run, tp) = served
    g = GEOMETRIES[geometry]
    jb = JBatcher(jm, jrun, jp, num_slots=num_slots, cache_len=32,
                  paged=None if g is None else JPagedPlan(paging=True, **g))
    tb = ContinuousBatcher(
        tm, run, tp, num_slots=num_slots, cache_len=32,
        paged=None if g is None else PagedPlan(paging=True, **g))
    rng = np.random.default_rng(2)
    for i in range(n_requests):
        p = rng.integers(0, tm.cfg.vocab_size,
                         lengths[i % len(lengths)]).astype(np.int32)
        jb.submit(JRequest(uid=i, prompt=p, max_new_tokens=max_new + i % 2))
        tb.submit(Request(uid=i, prompt=p, max_new_tokens=max_new + i % 2))
    jdone = [(d.request.uid, list(d.generated))
             for d in jb.run_until_drained()]
    tdone = [(d.request.uid, list(d.generated))
             for d in tb.run_until_drained()]
    assert tdone == jdone  # tokens AND completion order
    assert (tb.ticks, tb.prefill_chunks, tb.mean_occupancy) == \
        (jb.ticks, jb.prefill_chunks, jb.mean_occupancy)
    if g is not None:
        assert sorted(tb._free_pages) == list(range(g["pool_pages"]))
    return tdone


@pytest.mark.parametrize("served,geometry", [
    ("deepseek-v3-671b", "dense"),
    ("llama4-maverick-400b-a17b", "dense"),
    ("llama4-maverick-400b-a17b", "paged"),
    ("llama4-maverick-400b-a17b", "paged_chunked"),
], indirect=["served"])
def test_batcher_matches_reference(served, geometry):
    _run_both(served, geometry)


@pytest.mark.parametrize("served", ["deepseek-v3-671b"], indirect=True)
def test_paged_mla_serving_raises_like_reference(served):
    (jm, jrun, jp), (tm, run, tp) = served
    g = GEOMETRIES["paged"]
    with pytest.raises(NotImplementedError, match="MLA"):
        JBatcher(jm, jrun, jp, num_slots=2, cache_len=32,
                 paged=JPagedPlan(paging=True, **g))
    with pytest.raises(NotImplementedError, match="MLA"):
        ContinuousBatcher(tm, run, tp, num_slots=2, cache_len=32,
                          paged=PagedPlan(paging=True, **g))


# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("served", list(SMOKES), indirect=True)
def test_serve_cli_on_cpu_matches_reference_tokens(served, capsys):
    from repro.data.pipeline import make_data as jmake_data
    from repro_torch.launch import serve

    (jm, _, jp), (tm, _, tp) = served
    arch = {"deepseek-smoke": "deepseek-v3-671b",
            "llama4-smoke": "llama4-maverick-400b-a17b"}[tm.cfg.name]
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {tm.cfg.name}" in out and "decode p50" in out
    shape = ShapeConfig("serve_cli", 12, 2, "decode")
    jshape = JShapeConfig("serve_cli", 12, 2, "decode")
    prompt = serve.make_batch(tm.cfg, shape, 2, 8, "cpu")["tokens"]
    ref = jmake_data(jm.cfg, jshape, seed=0).batch_at(0)["inputs"][:2, :8]
    np.testing.assert_array_equal(prompt.numpy(), ref)
    res = serve.serve_fixed_batch(tm, RunConfig(model=tm.cfg, shape=shape),
                                  tp, prompt, gen=4)
    want = np.array(jgenerate(jm, JRunConfig(model=jm.cfg, shape=jshape), jp,
                              {"tokens": jnp.asarray(ref)}, num_steps=4))
    np.testing.assert_array_equal(res.tokens, want)
