"""The port's serving stack against the JAX reference on the CPU, at
temperature 0: greedy ``generate`` tokens; the continuous batcher — dense,
paged, and paged with chunked prefill — on the same requests (the same
tokens, completion order, tick counts, chunk counts and rejections);
``PromptTooLong`` / ``DrainStall``; the step cache; and the serve CLI on
``--device cpu``.  Token and counter comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model import build_model as jbuild
from repro.serving.paging import PagedPlan as JPagedPlan
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro.train.serve_step import generate as jgenerate
from repro.utils.config import ModelConfig as JModelConfig
from repro.utils.config import RunConfig as JRunConfig
from repro.utils.config import ShapeConfig as JShapeConfig
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.serving.paging import PagedPlan
from repro_torch.serving.scheduler import (ContinuousBatcher, DrainStall,
                                           PromptTooLong, Request)
from repro_torch.train.serve_step import generate, jitted_steps, sample_token
from repro_torch.utils.config import ModelConfig, RunConfig, ShapeConfig

# tiny shapes: one intra-op thread per test process, so parallel test
# workers do not oversubscribe the CPU under wall-clock-timed tests
torch.set_num_threads(1)

TINY = dict(vocab_size=64, d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
            num_layers=2, dtype="float32")


@pytest.fixture(scope="module")
def served():
    jcfg = JModelConfig(**TINY)
    jrun = JRunConfig(model=jcfg, shape=JShapeConfig("s", 64, 4, "decode"))
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", 64, 4, "decode"))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    return (jm, jrun, jp), (tm, run, tp)


def _prompts(n, lengths=(5,), seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"],
                         lengths[i % len(lengths)]).astype(np.int32)
            for i in range(n)]


def test_greedy_generate_matches_reference(served):
    (jm, jrun, jp), (tm, run, tp) = served
    toks = np.random.default_rng(0).integers(0, 64, (3, 9)).astype(np.int32)
    ref = np.array(jgenerate(jm, jrun, jp, {"tokens": jnp.asarray(toks)},
                             num_steps=7))
    out = generate(tm, run, tp, {"tokens": torch.as_tensor(toks)},
                   num_steps=7).numpy()
    np.testing.assert_array_equal(out, ref)


def _run_both(served, *, jpaged=None, paged=None, n_requests=3, max_new=4,
              num_slots=2, cache_len=32, eos_token=None, lengths=(5,),
              on_too_long="raise"):
    (jm, jrun, jp), (tm, run, tp) = served
    jb = JBatcher(jm, jrun, jp, num_slots=num_slots, cache_len=cache_len,
                  paged=jpaged, eos_token=eos_token, on_too_long=on_too_long)
    tb = ContinuousBatcher(tm, run, tp, num_slots=num_slots,
                           cache_len=cache_len, paged=paged,
                           eos_token=eos_token, on_too_long=on_too_long)
    for i, p in enumerate(_prompts(n_requests, lengths)):
        jb.submit(JRequest(uid=i, prompt=p, max_new_tokens=max_new))
        tb.submit(Request(uid=i, prompt=p, max_new_tokens=max_new))
    jdone = [(d.request.uid, list(d.generated)) for d in jb.run_until_drained()]
    tdone = [(d.request.uid, list(d.generated)) for d in tb.run_until_drained()]
    return jdone, tdone, jb, tb


def _assert_same(jdone, tdone, jb, tb):
    assert tdone == jdone  # tokens AND completion order
    assert tb.ticks == jb.ticks
    assert tb.rejected_too_long == jb.rejected_too_long
    assert tb.prefill_chunks == jb.prefill_chunks
    assert tb.mean_occupancy == jb.mean_occupancy
    assert tb._pool_occ_sum == jb._pool_occ_sum
    assert tb._chunks_inflight_sum == jb._chunks_inflight_sum


GEOMETRIES = {
    "dense": None,
    "paged_one_page": dict(pool_pages=2, page_size=32, pages_per_slot_max=1),
    "paged_multi_page": dict(pool_pages=8, page_size=4, pages_per_slot_max=8),
    "paged_chunked": dict(pool_pages=8, page_size=4, pages_per_slot_max=8,
                          prefill_chunk=2),
    "paged_pool_exhausted": dict(pool_pages=2, page_size=4,
                                 pages_per_slot_max=8),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_batcher_matches_reference(served, geometry):
    g = GEOMETRIES[geometry]
    jdone, tdone, jb, tb = _run_both(
        served,
        jpaged=None if g is None else JPagedPlan(paging=True, **g),
        paged=None if g is None else PagedPlan(paging=True, **g),
        lengths=(5, 3, 4))
    _assert_same(jdone, tdone, jb, tb)
    if g is not None:
        assert sorted(tb._free_pages) == list(range(g["pool_pages"]))


def test_batcher_geometries_agree_with_each_other(served):
    runs = {}
    for name, g in GEOMETRIES.items():
        _, tdone, _, _ = _run_both(
            served, jpaged=None if g is None else JPagedPlan(paging=True, **g),
            paged=None if g is None else PagedPlan(paging=True, **g))
        runs[name] = tdone
    for name, tdone in runs.items():
        assert tdone == runs["dense"], name


def test_slot_churn_with_eos_matches_reference(served):
    (jm, jrun, jp), _ = served
    p0 = _prompts(1)[0]
    ref = np.array(jgenerate(jm, jrun, jp, {"tokens": jnp.asarray(p0)[None]},
                             num_steps=1))[0]
    eos = int(ref[0])
    for g in (None, dict(pool_pages=4, page_size=4, pages_per_slot_max=8)):
        jdone, tdone, jb, tb = _run_both(
            served, n_requests=4, max_new=6, eos_token=eos,
            jpaged=None if g is None else JPagedPlan(paging=True, **g),
            paged=None if g is None else PagedPlan(paging=True, **g))
        _assert_same(jdone, tdone, jb, tb)


def test_empty_slot_runs_past_cache_len_like_reference(served):
    # one long request next to short ones: the short slots empty out and
    # keep decoding pad tokens until their lengths pass the 16-row cache
    jdone, tdone, jb, tb = _run_both(
        served, n_requests=3, max_new=12, cache_len=16, lengths=(4, 2, 2))
    _assert_same(jdone, tdone, jb, tb)
    assert int(tb.state.caches["sub0"].length.max()) > 16


def test_prompt_too_long_raise_and_reject(served):
    _, (tm, run, tp) = served
    b = ContinuousBatcher(tm, run, tp, num_slots=1, cache_len=16)
    with pytest.raises(PromptTooLong, match="dense cache") as e:
        b.submit(Request(uid=7, prompt=np.arange(14), max_new_tokens=8))
    assert (e.value.uid, e.value.needed, e.value.limit) == (7, 21, 16)
    b = ContinuousBatcher(tm, run, tp, num_slots=1, paged=PagedPlan(
        paging=True, pool_pages=2, page_size=4, pages_per_slot_max=8))
    with pytest.raises(PromptTooLong, match="paged slot") as e:
        b.submit(Request(uid=8, prompt=np.arange(6), max_new_tokens=4))
    assert e.value.limit == 8
    jdone, tdone, jb, tb = _run_both(
        served, n_requests=3, max_new=8, cache_len=16, lengths=(2, 12, 3),
        on_too_long="reject")
    _assert_same(jdone, tdone, jb, tb)
    assert tb.rejected_too_long == 1
    with pytest.raises(ValueError, match="on_too_long"):
        ContinuousBatcher(tm, run, tp, on_too_long="bogus")


def test_drain_stall(served):
    _, (tm, run, tp) = served
    b = ContinuousBatcher(tm, run, tp, num_slots=1, cache_len=32)
    for i in range(2):
        b.submit(Request(uid=i, prompt=np.asarray([1, 2]), max_new_tokens=5))
    with pytest.raises(DrainStall) as e:
        b.run_until_drained(max_ticks=3)
    assert e.value.pending == 2
    with pytest.warns(RuntimeWarning, match="not drained"):
        b.run_until_drained(max_ticks=1, on_limit="warn")
    assert b.stalled


def test_sampled_rows_draw_from_the_seeded_generator(served):
    _, (tm, run, tp) = served
    logits = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    a = sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    b = sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    assert torch.equal(a, b) and a.dtype == torch.int32
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0])
    mixed = sample_token(logits, torch.Generator().manual_seed(3), temps)
    greedy = logits.argmax(-1).to(torch.int32)
    assert mixed[0] == greedy[0] and mixed[2] == greedy[2]


def test_step_cache_keys_on_launch_config(served):
    _, (tm, run, tp) = served
    a = jitted_steps(tm, run, cache_len=16)
    assert jitted_steps(tm, run, cache_len=16) is a
    assert jitted_steps(tm, run, cache_len=16,
                        launch_config={"rmsnorm.row_block": 8}) is not a
    assert jitted_steps(tm, run, cache_len=16,
                        launch_config={"rmsnorm": {"row_block": 8}}) is \
        jitted_steps(tm, run, cache_len=16,
                     launch_config={"rmsnorm.row_block": 8})


def test_serve_cli_on_cpu_matches_reference_prompts_and_tokens(capsys):
    from repro.configs.llama3p2_1b import SMOKE as JSMOKE
    from repro.data.pipeline import make_data as jmake_data
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                       "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out
    assert "[serve] llama3.2-smoke" in out and "decode p50" in out
    # the CLI's prompts are the reference CLI's
    shape = ShapeConfig("serve_cli", 12, 2, "decode")
    prompt = serve.make_batch(serve.get_smoke_config("llama3.2-1b"), shape,
                              2, 8, "cpu")["tokens"]
    ref = jmake_data(JSMOKE, JShapeConfig("serve_cli", 12, 2, "decode"),
                     seed=0).batch_at(0)["inputs"][:2, :8]
    np.testing.assert_array_equal(prompt.numpy(), ref)
    # and the fixed-batch path decodes them as the reference does
    jm = jbuild(JSMOKE)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig.from_dict(JSMOKE.to_dict())
    run = RunConfig(model=cfg, shape=shape)
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
    res = serve.serve_fixed_batch(tm, run, tp, prompt, gen=4, keep_logits=2)
    want = np.array(jgenerate(jm, JRunConfig(model=JSMOKE, shape=JShapeConfig(
        "serve_cli", 12, 2, "decode")), jp, {"tokens": jnp.asarray(ref)},
        num_steps=4))
    np.testing.assert_array_equal(res.tokens, want)
    assert len(res.logits) == 2 and len(res.decode_s) == 3


def test_serve_cli_defaults_to_cuda():
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "2", "--prompt-len", "4"])
