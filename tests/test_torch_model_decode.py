"""The port's dense GQA model against the JAX reference on the CPU: the
three ``apply_gqa`` branches — prefill into a dense cache then dense decode,
paged decode over a permuted pool, and the ring (sliding-window) cache — on
``llama3.2-smoke``, ``default_replay_model()`` and the quickstart config;
plus the empty-slot cases where a slot's length runs past its cache (JAX
drops or clamps the index, where PyTorch would fault).

Tolerance: fp32 logits agree to atol 1e-4 / rtol 1e-4 (both packages
accumulate in fp32, in different orders); caches, which are written, not
computed, to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.envs.replay_env import default_replay_model
from repro.models import attention as jattn
from repro.models.transformer import block_pattern as jblock_pattern
from repro.utils.config import ModelConfig as JModelConfig
from repro.utils.config import ParallelConfig as JParallelConfig
from repro_torch.models import attention as tattn
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.transformer import block_pattern
from repro_torch.utils.config import ModelConfig, ParallelConfig
from test_torch_model import (CONFIGS, TOL, N, T, both, cache_to_port,
                              port_cfg, tokens)


def _decode_both(jm, jp, tm, tp, jstate, tstate, toks, lengths, steps):
    """Run `steps` teacher-forced decode steps in both packages."""
    for t in range(steps):
        pos = lengths[:, None] + t
        jl, jstate, _ = jm.forward(jp, jnp.asarray(toks[:, t:t + 1]),
                                   positions=jnp.asarray(pos),
                                   decode_state=jstate, decode=True)
        tl, tstate, _ = tm.forward(tp, T(toks[:, t:t + 1]), positions=T(pos),
                                   decode_state=tstate, decode=True)
        np.testing.assert_allclose(N(tl), np.array(jl), **TOL)
    return jstate, tstate


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_into_cache_then_dense_decode(name):
    jm, jp, tm, tp = both(CONFIGS[name])
    b, s, cache_len = 2, 7, 16
    toks = tokens(tm.cfg, b, s + 4)
    jst = jm.init_decode_state(b, cache_len)
    tst = tm.init_decode_state(b, cache_len)
    jl, jst, _ = jm.forward(jp, jnp.asarray(toks[:, :s]), decode_state=jst)
    tl, tst, _ = tm.forward(tp, T(toks[:, :s]), decode_state=tst)
    np.testing.assert_allclose(N(tl), np.array(jl), **TOL)
    np.testing.assert_allclose(N(tst["sub0"].k), np.array(jst["sub0"].k),
                               atol=1e-5)
    lengths = np.full((b,), s, np.int32)
    jst, tst = _decode_both(jm, jp, tm, tp, jst, tst, toks[:, s:], lengths, 4)
    np.testing.assert_array_equal(N(tst["sub0"].length),
                                  np.array(jst["sub0"].length))
    np.testing.assert_allclose(N(tst["sub0"].v), np.array(jst["sub0"].v),
                               atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_decode_over_permuted_pool(name):
    jm, jp, tm, tp = both(CONFIGS[name])
    cfg = tm.cfg
    b, pool, ps, per_slot = 2, 6, 4, 3
    jst = jm.init_paged_decode_state(b, pool, ps, per_slot)
    # slot 0 owns pages [4, 1, 5], slot 1 owns [0, 3]; its 3rd entry stays
    # on the scratch page; both hold 5 tokens of a random history
    table = np.full((b, per_slot), pool, np.int32)
    table[0] = [4, 1, 5]
    table[1, :2] = [0, 3]
    rng = np.random.default_rng(3)
    nsb, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    kp = rng.normal(size=(nsb, pool + 1, ps, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    jst = {"sub0": jattn.PagedKVCache(
        jnp.asarray(kp), jnp.asarray(vp),
        jnp.broadcast_to(jnp.asarray(table), (nsb, b, per_slot)),
        jnp.full((nsb, b), 5, jnp.int32))}
    tst = {"sub0": cache_to_port(jst["sub0"], tattn.PagedKVCache)}
    toks = tokens(cfg, b, 4)
    lengths = np.full((b,), 5, np.int32)
    jst, tst = _decode_both(jm, jp, tm, tp, jst, tst, toks, lengths, 4)
    np.testing.assert_allclose(N(tst["sub0"].k_pages),
                               np.array(jst["sub0"].k_pages), atol=1e-5)


@pytest.mark.parametrize("name", ["llama3.2-smoke", "replay-tiny"])
def test_ring_cache_sliding_window(name):
    jcfg = CONFIGS[name].replace(sliding_window=5)
    jm, jp, tm, tp = both(jcfg)
    b, s = 2, 8  # the prompt outgrows the 5-row ring
    toks = tokens(tm.cfg, b, s + 6)
    jst = jm.init_decode_state(b, 32)
    tst = tm.init_decode_state(b, 32)
    assert tuple(tst["sub0"].k.shape) == jst["sub0"].k.shape  # ring of 5
    jl, jst, _ = jm.forward(jp, jnp.asarray(toks[:, :s]), decode_state=jst)
    tl, tst, _ = tm.forward(tp, T(toks[:, :s]), decode_state=tst)
    np.testing.assert_allclose(N(tl), np.array(jl), **TOL)
    lengths = np.full((b,), s, np.int32)
    jst, tst = _decode_both(jm, jp, tm, tp, jst, tst, toks[:, s:], lengths, 6)
    np.testing.assert_allclose(N(tst["sub0"].k), np.array(jst["sub0"].k),
                               atol=1e-5)


def test_sliding_window_longer_cache_uses_window_mask():
    # a dense cache longer than the window: decode masks by the window
    jcfg = default_replay_model().replace(sliding_window=4)
    jm, jp, tm, tp = both(jcfg)
    b, s, cache_len = 2, 6, 16
    par = JParallelConfig()
    toks = tokens(tm.cfg, b, s + 3)
    # build a plain (non-ring) 16-row cache by hand: the init would ring it
    hkv, hd, nsb = jcfg.num_kv_heads, jcfg.head_dim, jcfg.num_layers
    z = np.zeros((nsb, b, cache_len, hkv, hd), np.float32)
    jst = {"sub0": jattn.KVCache(jnp.asarray(z), jnp.asarray(z),
                                 jnp.zeros((nsb, b), jnp.int32))}
    tst = {"sub0": cache_to_port(jst["sub0"], tattn.KVCache)}
    jl, jst, _ = jm.forward(jp, jnp.asarray(toks[:, :s]), decode_state=jst)
    tl, tst, _ = tm.forward(tp, T(toks[:, :s]), decode_state=tst)
    np.testing.assert_allclose(N(tl), np.array(jl), **TOL)
    _decode_both(jm, jp, tm, tp, jst, tst, toks[:, s:],
                 np.full((b,), s, np.int32), 3)
    assert par.attn_kv_block == ParallelConfig().attn_kv_block


# --------------------------------------------------------------------------
# empty slots past their capacity (JAX drops / clamps, torch would fault)
# --------------------------------------------------------------------------

def test_dense_decode_empty_slot_past_cache_len():
    jm, jp, tm, tp = both(default_replay_model())
    b, cache_len = 3, 8
    jst = jm.init_decode_state(b, cache_len)
    rng = np.random.default_rng(4)
    k = rng.normal(size=jst["sub0"].k.shape).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    # slot 1 is an empty slot that kept decoding: its length is past the
    # cache, and drives further past it for 3 more ticks
    lengths = np.asarray([3, 8, 5], np.int32)
    jst = {"sub0": jattn.KVCache(
        jnp.asarray(k), jnp.asarray(v),
        jnp.broadcast_to(jnp.asarray(lengths), (k.shape[0], b)))}
    tst = {"sub0": cache_to_port(jst["sub0"], tattn.KVCache)}
    toks = tokens(tm.cfg, b, 3)
    jst, tst = _decode_both(jm, jp, tm, tp, jst, tst, toks, lengths, 3)
    # the out-of-range writes were dropped: slot 1's rows are untouched
    np.testing.assert_array_equal(N(tst["sub0"].k)[:, 1], k[:, 1])
    np.testing.assert_allclose(N(tst["sub0"].k), np.array(jst["sub0"].k),
                               atol=1e-5)
    np.testing.assert_array_equal(N(tst["sub0"].length),
                                  np.array(jst["sub0"].length))


def test_paged_decode_parked_slot_past_capacity():
    jm, jp, tm, tp = both(default_replay_model())
    b, pool, ps, per_slot = 2, 4, 4, 2
    jst = jm.init_paged_decode_state(b, pool, ps, per_slot)
    nsb = jst["sub0"].k_pages.shape[0]
    rng = np.random.default_rng(5)
    kp = rng.normal(size=jst["sub0"].k_pages.shape).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    table = np.asarray([[2, 0], [pool, pool]], np.int32)  # slot 1 parked
    lengths = np.asarray([3, 9], np.int32)  # 9 > capacity 8: column clamps
    jst = {"sub0": jattn.PagedKVCache(
        jnp.asarray(kp), jnp.asarray(vp),
        jnp.broadcast_to(jnp.asarray(table), (nsb, b, per_slot)),
        jnp.broadcast_to(jnp.asarray(lengths), (nsb, b)))}
    tst = {"sub0": cache_to_port(jst["sub0"], tattn.PagedKVCache)}
    toks = tokens(tm.cfg, b, 3)
    jst, tst = _decode_both(jm, jp, tm, tp, jst, tst, toks, lengths, 3)
    # the parked slot wrote only to the scratch page; live pages agree
    np.testing.assert_allclose(N(tst["sub0"].k_pages),
                               np.array(jst["sub0"].k_pages), atol=1e-5)
    np.testing.assert_array_equal(N(tst["sub0"].k_pages)[:, 1], kp[:, 1])


def test_paged_prefill_and_sliding_window_are_rejected_like_reference():
    cfg = port_cfg(default_replay_model())
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tattn.init_paged_kv_cache(cfg.replace(sliding_window=4), 1, 2, 4, 2,
                                  torch.float32, torch.device("cpu"))
    tm = tbuild(cfg, device="cpu")
    tp = tm.init(0)
    st = tm.init_paged_decode_state(1, 2, 4, 2)
    with pytest.raises(NotImplementedError, match="prefill"):
        tm.forward(tp, torch.zeros((1, 3), dtype=torch.int32),
                   decode_state=st)


def test_unported_families_raise():
    """No family is left unported: the vlm and audio configs, which raised
    here until they were ported, build on the CPU and their block patterns
    are the reference's."""
    for kw in (dict(family="vlm"), dict(family="vlm", cross_attn_period=2),
               dict(family="audio")):
        assert block_pattern(ModelConfig(**kw)) == \
            jblock_pattern(JModelConfig(**kw))
    for kw in (dict(family="vlm", num_layers=4, cross_attn_period=2,
                    vision_seq=3, vision_dim=32),
               dict(family="audio", encoder_layers=2, encoder_seq=5)):
        model = tbuild(ModelConfig(**kw), device="cpu")
        assert model.device.type == "cpu"
        assert (model.init_paged_decode_state is None) == \
            (kw["family"] == "audio")
        assert model.init(0)


def test_build_model_defaults_to_cuda():
    cfg = port_cfg(default_replay_model())
    if torch.cuda.is_available():
        assert tbuild(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbuild(cfg)
    assert tbuild(cfg, device="cpu").device.type == "cpu"
