"""The port's MoE family and MLA attention against the JAX reference on the
CPU: the five configs carried in this slice and the registry; ``apply_moe``
(deepseek's sigmoid top-2 of 8 with a shared expert, llama4's softmax
top-1) dropless, with a group size that forces drops, and at a token count
that forces the group-size halving; ``apply_mla`` prefill and decode with
the compressed cache's contents; ``forward`` logits and aux for the five
new smoke configs; deepseek's ``mtp_logits``; the parameter counts of the
five full configs, with and without ``active_only``.

Tolerance: fp32 outputs agree to atol 1e-4 / rtol 1e-4 (both packages
accumulate in fp32, in different orders), the aux loss to 1e-6, the
chosen expert sets exactly (as sets: ``torch.topk`` and ``jax.lax.top_k``
may order ties differently).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import command_r_35b as j_command_r
from repro.configs import deepseek_v3_671b as j_deepseek
from repro.configs import h2o_danube_1p8b as j_danube
from repro.configs import llama4_maverick_400b as j_llama4
from repro.configs import nemotron_4_15b as j_nemotron
from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild
from repro.models.model import count_params_analytic as jcount
from repro.utils.config import ParallelConfig as JParallelConfig
from repro_torch.configs import command_r_35b as t_command_r
from repro_torch.configs import deepseek_v3_671b as t_deepseek
from repro_torch.configs import h2o_danube_1p8b as t_danube
from repro_torch.configs import llama4_maverick_400b as t_llama4
from repro_torch.configs import nemotron_4_15b as t_nemotron
from repro_torch.configs import registry as tregistry
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import build_model as tbuild
from repro_torch.models.model import count_params_analytic as tcount
from repro_torch.utils.config import ModelConfig, ParallelConfig

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
AUX_TOL = 1e-6
CONFIGS = {"deepseek-v3-671b": (t_deepseek, j_deepseek),
           "llama4-maverick-400b-a17b": (t_llama4, j_llama4),
           "command-r-35b": (t_command_r, j_command_r),
           "h2o-danube-1.8b": (t_danube, j_danube),
           "nemotron-4-15b": (t_nemotron, j_nemotron)}
MOE = ("deepseek-v3-671b", "llama4-maverick-400b-a17b")


def port_cfg(jcfg):
    return ModelConfig.from_dict(jcfg.to_dict())


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.detach().cpu().numpy()


def tree_T(tree):
    return jax.tree.map(T, tree)


def hidden(seed, b, s, d):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


# --------------------------------------------------------------------------
# configs and registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(CONFIGS))
def test_configs_equal_reference(arch):
    tmod, jmod = CONFIGS[arch]
    assert tmod.CONFIG.to_dict() == jmod.CONFIG.to_dict()
    assert tmod.SMOKE.to_dict() == jmod.SMOKE.to_dict()
    for kind in ("train", "decode"):
        assert dataclasses.asdict(tmod.default_parallel(kind)) == \
            dataclasses.asdict(jmod.default_parallel(kind))
    assert tregistry.get_model_config(arch) is tmod.CONFIG
    assert tregistry.get_smoke_config(arch) is tmod.SMOKE


def test_registry_lists_the_reference_decoder_archs_in_order():
    ref = [a for a in jregistry.list_archs()
           if jregistry.get_model_config(a).family not in ("vlm", "audio")]
    ported = [a for a in tregistry.list_archs()
              if tregistry.get_model_config(a).family not in ("vlm", "audio")]
    assert ported == ref and len(ref) == 8
    # the vlm and audio archs follow them, as in the reference
    assert tregistry.list_archs() == jregistry.list_archs()


# --------------------------------------------------------------------------
# apply_moe
# --------------------------------------------------------------------------

def _moe_params(jcfg):
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jp, tree_T(jp)


def _ref_routes(jp, jcfg, x, group_size):
    """The reference's chosen experts (G, Tg, k), by its own routing ops."""
    b, s, d = x.shape
    t = b * s
    tg = min(group_size, t)
    while t % tg:
        tg //= 2
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(-1, tg, d),
                        jp["router"])
    scores = (jax.nn.sigmoid(logits) if jcfg.moe_router == "sigmoid"
              else jax.nn.softmax(logits, axis=-1))
    return np.array(jax.lax.top_k(scores, jcfg.moe_top_k)[1])


# (tokens b x s, group size, dropless): 24 tokens in one group; groups of
# 8 from 16 (halved: 16 does not divide 24) with capacity 2 (deepseek) /
# 1 (llama4), so tokens are dropped; the same dropless
MOE_CASES = {"one_group": ((2, 12), 512, False),
             "halved_with_drops": ((2, 12), 16, False),
             "halved_dropless": ((2, 12), 16, True),
             "decode_dropless": ((4, 1), 512, True)}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(arch, case):
    (b, s), gs, dropless = MOE_CASES[case]
    jcfg = CONFIGS[arch][1].SMOKE
    cfg = port_cfg(jcfg)
    jp, tp = _moe_params(jcfg)
    x = hidden(1, b, s, cfg.d_model)
    ref, jaux = jax.jit(jmoe.apply_moe, static_argnums=(1,),
                        static_argnames=("router_mode", "group_size",
                                         "dropless"))(
        jp, jcfg, jnp.asarray(x), router_mode=jcfg.moe_router,
        group_size=gs, dropless=dropless)
    out, aux = tmoe.apply_moe(tp, cfg, T(x), router_mode=cfg.moe_router,
                              group_size=gs, dropless=dropless)
    np.testing.assert_allclose(N(out), np.array(ref), **TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    want = _ref_routes(jp, jcfg, x, gs)
    tg = tmoe._group_size(b * s, gs)
    _, _, got = tmoe.route(tp, T(x).reshape(-1, tg, cfg.d_model),
                           cfg.moe_top_k, cfg.moe_router)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.sort(N(got), -1), np.sort(want, -1))
    if case == "halved_with_drops":  # the capacity dropped some choices
        full, _ = tmoe.apply_moe(tp, cfg, T(x), router_mode=cfg.moe_router,
                                 group_size=gs, dropless=True)
        assert not torch.allclose(full, out, **TOL)


def test_moe_capacity_and_group_size_follow_the_reference():
    cfg = port_cfg(j_deepseek.CONFIG)
    # tg * k * cf / E: 256 * 8 * 1.25 / 256 = 10; 7 for 200 tokens
    assert tmoe.capacity(cfg, 256, False) == 10
    assert tmoe.capacity(cfg, 200, False) == 7
    assert tmoe.capacity(cfg, 4, False) == 1
    assert tmoe.capacity(cfg, 4, True) == 4
    assert [tmoe._group_size(t, 512) for t in (4, 200, 256, 600, 1024)] == \
        [4, 200, 256, 8, 512]
    # capped at the group: top-1 of 2 experts, capacity factor 4
    small = port_cfg(j_llama4.SMOKE).replace(moe_num_experts=2,
                                             moe_capacity_factor=4.0)
    assert tmoe.capacity(small, 8, False) == 8


def test_stacked_expert_init_is_blockwise_and_in_the_model_dtype():
    gen = torch.Generator().manual_seed(0)
    w = tmoe._stack_init(gen, 40, 16, 8, torch.bfloat16, torch.device("cpu"),
                         (2,))
    assert w.shape == (2, 40, 16, 8) and w.dtype == torch.bfloat16
    f = w.float()
    assert float(f.abs().max()) <= 2.0 * 16 ** -0.5 + 1e-2
    assert 0.6 < float(f.std()) * 16 ** 0.5 < 1.0  # trunc. normal: 0.88
    # every block drawn afresh: no two experts equal
    flat = f.reshape(80, -1)
    assert torch.unique(flat, dim=0).shape[0] == 80
    meta = tmoe._stack_init(None, 256, 7168, 2048, torch.bfloat16,
                            torch.device("meta"), (2,))
    assert meta.shape == (2, 256, 7168, 2048) and meta.is_meta


# --------------------------------------------------------------------------
# apply_mla
# --------------------------------------------------------------------------

def test_apply_mla_prefill_decode_and_cache_match_reference():
    jcfg = j_deepseek.SMOKE
    cfg = port_cfg(jcfg)
    jpar, par = JParallelConfig(), ParallelConfig()
    jp = jattn.init_mla(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = tree_T(jp)
    b, s, max_len, steps = 2, 5, 9, 3
    x = hidden(2, b, s + steps, cfg.d_model)
    jcache = jattn.init_mla_cache(jcfg, b, max_len, jnp.float32)
    tcache = tattn.init_mla_cache(cfg, b, max_len, torch.float32,
                                  torch.device("cpu"))
    # prefill: the whole prompt, filling the cache from row 0
    japply = jax.jit(jattn.apply_mla, static_argnums=(1, 2),
                     static_argnames=("decode",))
    ref, jcache = japply(jp, jcfg, jpar, jnp.asarray(x[:, :s]),
                         jnp.arange(s), cache=jcache)
    out, tcache = tattn.apply_mla(tp, cfg, par, T(x[:, :s]),
                                  torch.arange(s), cache=tcache)
    np.testing.assert_allclose(N(out), np.array(ref), **TOL)
    # the sequence form, without a cache, gives the same rows
    seq, none = tattn.apply_mla(tp, cfg, par, T(x[:, :s]), torch.arange(s))
    assert none is None
    np.testing.assert_allclose(N(seq), N(out), **TOL)
    c_ptr = tcache.c_kv.data_ptr()
    for i in range(steps):
        pos = np.full((b, 1), s + i, np.int32)
        ref, jcache = japply(jp, jcfg, jpar,
                             jnp.asarray(x[:, s + i:s + i + 1]),
                             jnp.asarray(pos), cache=jcache, decode=True)
        out, tcache = tattn.apply_mla(tp, cfg, par, T(x[:, s + i:s + i + 1]),
                                      T(pos), cache=tcache, decode=True)
        np.testing.assert_allclose(N(out), np.array(ref), **TOL)
    for got, want in zip(tcache, jcache):
        np.testing.assert_allclose(N(got), np.array(want), **TOL)
    assert tcache.length.tolist() == [s + steps] * b
    assert tcache.c_kv.data_ptr() == c_ptr  # written in place


def test_mla_decode_past_the_cache_writes_nothing():
    """A parked batcher slot's length grows past the cache: the
    reference's one-hot write writes nothing there, nor does the port's."""
    cfg = port_cfg(j_deepseek.SMOKE)
    tp = tattn.init_mla(torch.Generator().manual_seed(0), cfg, torch.float32,
                        torch.device("cpu"))
    cache = tattn.init_mla_cache(cfg, 2, 4, torch.float32,
                                 torch.device("cpu"))
    cache.c_kv.normal_()
    cache.length.copy_(torch.tensor([4, 2], dtype=torch.int32))
    before = cache.c_kv.clone()
    x = torch.randn(2, 1, cfg.d_model)
    tattn.apply_mla(tp, cfg, ParallelConfig(), x, cache.length[:, None],
                    cache=cache, decode=True)
    assert torch.equal(cache.c_kv[0], before[0])
    assert not torch.equal(cache.c_kv[1, 2], before[1, 2])
    assert torch.equal(cache.c_kv[1, :2], before[1, :2])


# --------------------------------------------------------------------------
# the whole model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_models():
    out = {}
    for arch, (_, jmod) in CONFIGS.items():
        jcfg = jmod.SMOKE
        jm = jbuild(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        cfg = port_cfg(jcfg)
        tm = tbuild(cfg, device="cpu")
        tp = params_from_jax(jax.tree.map(np.array, jp), cfg, device="cpu")
        out[arch] = (jm, jp, tm, tp)
    return out


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_forward_logits_and_aux_match_reference(smoke_models, arch):
    jm, jp, tm, tp = smoke_models[arch]
    toks = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (2, 20)).astype(np.int32)
    ref, _, jaux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    out, _, aux = tm.forward(tp, T(toks))
    np.testing.assert_allclose(N(out), np.array(ref), **TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL
    assert (float(aux) > 0) == tm.cfg.is_moe


def test_block_patterns_match_reference():
    for arch, (_, jmod) in CONFIGS.items():
        for cfg in (jmod.CONFIG, jmod.SMOKE):
            assert ttransformer.block_pattern(port_cfg(cfg)) == \
                jtransformer.block_pattern(cfg), arch
    assert ttransformer.block_pattern(port_cfg(j_llama4.CONFIG)) == \
        ["dense", "moe"]


def test_mtp_logits_match_reference(smoke_models):
    jm, jp, tm, tp = smoke_models["deepseek-v3-671b"]
    assert set(tp["mtp"]) == {"proj", "block", "norm"}
    assert "moe" in tp["mtp"]["block"]
    jcfg, cfg = jm.cfg, tm.cfg
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jh, _, _ = jax.jit(functools.partial(jm.forward, return_hidden=True))(
        jp, jnp.asarray(toks[:, :-1]))
    th, _, _ = tm.forward(tp, T(toks[:, :-1]), return_hidden=True)
    ref = jax.jit(jtransformer.mtp_logits, static_argnums=(1, 2))(
        jp, jcfg, JParallelConfig(), jh, jnp.asarray(toks[:, 1:]),
        jnp.arange(9))
    out = ttransformer.mtp_logits(tp, cfg, ParallelConfig(), th,
                                  T(toks[:, 1:]), torch.arange(9))
    np.testing.assert_allclose(N(out), np.array(ref), **TOL)


@pytest.mark.parametrize("active_only", [False, True])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_param_counts_match_reference(arch, active_only):
    _, jmod = CONFIGS[arch]
    assert tcount(port_cfg(jmod.CONFIG), active_only) == \
        jcount(jmod.CONFIG, active_only)


def test_router_is_fp32_in_a_bf16_model():
    cfg = port_cfg(j_llama4.SMOKE).replace(dtype="bfloat16")
    tp = ttransformer.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                     torch.bfloat16, torch.device("cpu"))
    moe = tp["blocks"]["sub1"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert {moe[w].dtype for w in ("w_gate", "w_up", "w_down")} == \
        {torch.bfloat16}
    jp = jax.jit(jbuild(j_llama4.SMOKE.replace(dtype="bfloat16")).init)(
        jax.random.PRNGKey(0))
    imported = params_from_jax(jax.tree.map(np.array, jp), cfg,
                               device="cpu")
    assert imported["blocks"]["sub1"]["moe"]["router"].dtype == torch.float32
    assert imported["blocks"]["sub1"]["moe"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_build_model_builds_the_new_archs(arch, device):
    cfg = tregistry.get_smoke_config(arch)
    model = tbuild(cfg, device=device)
    params = model.init(0)
    leaves = [t for t in _leaves(params)]
    assert all(t.device.type == device for t in leaves)
    state = model.init_decode_state(2, 8)
    kind = "MLACache" if cfg.attn_type == "mla" else "KVCache"
    assert {type(v).__name__ for v in state.values()} == {kind}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
