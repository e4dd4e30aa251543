"""On an sm_90 card only: each CUDA kernel of the port against its plain
PyTorch version, the recompute wrapper's gradients, the compiled decode
step, and the checkpoints and the train driver on the card (marked
``gpu``; skips without the card).  Imports no jax,
so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: fp32 atol 2e-5 / rtol 1e-4; bf16 2e-2 (both sides round their
fp32 results to bf16, at different points).
"""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ref as tfr
from repro_torch.kernels.paged_attention import kernel as tpk
from repro_torch.kernels.paged_attention import ref as tpr
from repro_torch.kernels.rmsnorm import kernel as trk
from repro_torch.kernels.mamba_scan import kernel as tsk
from repro_torch.kernels.mamba_scan import ref as tsr
from repro_torch.kernels.rmsnorm import ref as trr
from repro_torch.kernels.ssd import kernel as tdk
from repro_torch.kernels.ssd import ref as tdr
from repro_torch.utils.trees import tree_leaves, tree_map

FP32 = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the CUDA kernels are built for sm_90a")
    return torch.device("cuda")


def _cmp(out, ref, dtype):
    tol = FP32 if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(sm90, dtype):
    g = torch.Generator(device=sm90).manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    x, w, r = rnd(3, 17, 64), rnd(64), rnd(3, 17, 64)
    _cmp(trk.rmsnorm_cuda(x, w, residual=r),
         trr.rmsnorm_ref(x, w, residual=r), dtype)
    q, k, v = rnd(2, 96, 8, 32), rnd(2, 96, 2, 32), rnd(2, 96, 2, 32)
    _cmp(tfk.flash_attention_cuda(q, k, v, sliding_window=9,
                                  logit_softcap=30.0),
         tfr.attention_blockwise_ref(q, k, v, sliding_window=9,
                                     logit_softcap=30.0), dtype)
    lens = torch.tensor([13, 140], dtype=torch.int32, device=sm90)
    qd, kc, vc = rnd(2, 1, 8, 32), rnd(2, 96, 2, 32), rnd(2, 96, 2, 32)
    _cmp(tfk.decode_attention_cuda(qd, kc, vc, lens),
         tfr.decode_attention_ref(qd, kc, vc, lens), dtype)
    kp, vp = rnd(9, 16, 2, 32), rnd(9, 16, 2, 32)
    table = torch.randperm(8, generator=g, device=sm90).to(
        torch.int32).reshape(2, 4)
    lens = torch.tensor([13, 64], dtype=torch.int32, device=sm90)
    _cmp(tpk.paged_decode_attention_cuda(qd, kp, vp, table, lens),
         tpr.paged_decode_attention_ref(qd, kp, vp, table, lens), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernels_and_head_dim_80_match_plain_versions(sm90, dtype):
    g = torch.Generator(device=sm90).manual_seed(1)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    def pos(*s):
        return (torch.rand(s, generator=g, device=sm90) * 0.1).to(dtype)

    q, k, v = rnd(1, 77, 8, 80), rnd(1, 77, 2, 80), rnd(1, 77, 2, 80)
    _cmp(tfk.flash_attention_cuda(q, k, v), tfr.attention_blockwise_ref(
        q, k, v), dtype)
    A = -torch.rand((100, 16), generator=g, device=sm90) * 4
    scan = (rnd(2, 50, 100), pos(2, 50, 100), A, rnd(2, 50, 16),
            rnd(2, 50, 16), rnd(100).float())
    _cmp(tsk.selective_scan_cuda(*scan, chunk=16, c_block=32),
         tsr.selective_scan_chunked_ref(*scan, chunk=16), dtype)
    A = -torch.rand((8,), generator=g, device=sm90) * 4
    ssd = (rnd(2, 70, 8, 32), pos(2, 70, 8), A, rnd(2, 70, 2, 16),
           rnd(2, 70, 2, 16), rnd(8).float())
    _cmp(tdk.ssd_cuda(*ssd, chunk=32), tdr.ssd_ref(*ssd, chunk=32), dtype)


@pytest.mark.gpu
def test_recompute_wrapper_gradients_on_the_card(sm90):
    g = torch.Generator(device=sm90).manual_seed(2)
    scan = [torch.randn((1, 40, 64), generator=g, device=sm90),
            torch.rand((1, 40, 64), generator=g, device=sm90) * 0.1,
            -torch.rand((64, 16), generator=g, device=sm90) * 4,
            torch.randn((1, 40, 16), generator=g, device=sm90),
            torch.randn((1, 40, 16), generator=g, device=sm90),
            torch.randn((64,), generator=g, device=sm90)]
    grads = []
    for fn in (lambda *a: ops.selective_scan(*a, chunk=16),
               lambda *a: tsr.selective_scan_chunked_ref(*a, chunk=16)):
        xs = [t.clone().requires_grad_() for t in scan]
        (fn(*xs) ** 2).sum().backward()
        grads.append([t.grad for t in xs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,dv", [(192, 128), (16, 8)])
def test_prefill_with_narrower_v_matches_plain_version(sm90, dtype, d, dv):
    """MLA prefill's head dims: q/k D wide, v and the output Dv wide."""
    g = torch.Generator(device=sm90).manual_seed(5)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    for (sq, skv, kw) in ((77, 77, {}), (50, 120, {"causal": False})):
        q, k, v = rnd(2, sq, 4, d), rnd(2, skv, 4, d), rnd(2, skv, 4, dv)
        ref = tfr.attention_blockwise_ref(q, k, v, **kw)
        for qb, kb in ((32, 32), (64, 64)):
            out = tfk.flash_attention_cuda(q, k, v, q_block=qb, kv_block=kb,
                                           **kw)
            assert out.shape == (2, sq, 4, dv)
            _cmp(out, ref, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128])
def test_tensor_core_prefill_matches_plain_version(sm90, d):
    g = torch.Generator(device=sm90).manual_seed(3)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(torch.bfloat16)

    for (sq, skv, kw) in ((77, 77, {}), (77, 200, {"causal": False}),
                          (50, 50, {"q_offset": -20}),
                          (120, 120, {"sliding_window": 13,
                                      "logit_softcap": 20.0})):
        q, k, v = rnd(2, sq, 8, d), rnd(2, skv, 2, d), rnd(2, skv, 2, d)
        ref = tfr.attention_blockwise_ref(q, k, v, **kw)
        for qb, kb in ((32, 32), (64, 64)):
            out = tfk.flash_attention_cuda(q, k, v, q_block=qb, kv_block=kb,
                                           **kw)
            _cmp(out, ref, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1600, 32, 8, 128),
                                   (4, 1500, 20, 20, 64)])
def test_cross_attention_at_one_query_matches_plain_version(sm90, dtype,
                                                            shape):
    """A decode step's cross-attention: one query row a slot over the
    vision model's 1600 patch rows (32 / 8 heads of 128) and whisper's
    1500 encoder rows (20 / 20 heads of 64), non-causal, every block."""
    b, skv, hq, hkv, d = shape
    g = torch.Generator(device=sm90).manual_seed(8)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    q, k, v = rnd(b, 1, hq, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d)
    ref = tfr.attention_blockwise_ref(q, k, v, causal=False)
    for qb in (32, 64):
        for kb in (32, 64):
            out = tfk.flash_attention_cuda(q, k, v, causal=False,
                                           q_block=qb, kv_block=kb)
            _cmp(out, ref, dtype)


@pytest.mark.gpu
def test_mixed_dtype_ops_match_plain_versions(sm90):
    """The stub frontends' fp32 inputs in a bf16 model: ``ops`` casts the
    operands to the widest dtype (the fp32 kernels run) and returns the
    query's / the rows' dtype, as the reference's kernels do."""
    from repro_torch.kernels import cuda_lib

    g = torch.Generator(device=sm90).manual_seed(9)
    q = torch.randn((4, 3, 8, 64), generator=g, device=sm90).bfloat16()
    k, v = (torch.randn((4, 100, 2, 64), generator=g, device=sm90)
            for _ in range(2))
    cuda_lib.reset_launches()
    out = ops.flash_attention(q, k, v, causal=False)
    assert out.dtype == torch.bfloat16
    _cmp(out, tfr.attention_blockwise_ref(q, k, v, causal=False),
         torch.bfloat16)
    x = torch.randn((4, 7, 1280), generator=g, device=sm90)
    w = torch.randn((1280,), generator=g, device=sm90).bfloat16()
    y = ops.rmsnorm(x, w)
    assert y.dtype == torch.float32
    _cmp(y, trr.rmsnorm_ref(x, w), torch.float32)
    assert cuda_lib.LAUNCHES["flash_attention"] == 1
    assert cuda_lib.LAUNCHES["rmsnorm"] == 1
    assert cuda_lib.PREFILL_INSTANCES == {(64, 64, False, False): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_matches_split_oracle_and_paged_equals_dense(sm90,
                                                                  dtype):
    g = torch.Generator(device=sm90).manual_seed(4)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    b, ps, n_pages = 8, 64, 16
    cap = ps * n_pages
    n_split, rows = tfk.plan_decode_splits(
        cap, tpk.KV_TILE, b, 2, torch.cuda.get_device_properties(
            sm90).multi_processor_count)
    assert n_split > 1
    lens = torch.tensor([0, 1, rows, rows + 1, cap, cap + 50, 300, 777],
                        dtype=torch.int32, device=sm90)
    q, kc, vc = rnd(b, 1, 8, 64), rnd(b, cap, 2, 64), rnd(b, cap, 2, 64)
    out = tfk.decode_attention_cuda(q, kc, vc, lens, kv_block=tpk.KV_TILE)
    _cmp(out, tfr.decode_attention_split_ref(q, kc, vc, lens,
                                             split_rows=rows), dtype)
    kp = torch.cat([kc.reshape(b * n_pages, ps, 2, 64),
                    torch.zeros((1, ps, 2, 64), dtype=dtype, device=sm90)])
    vp = torch.cat([vc.reshape(b * n_pages, ps, 2, 64),
                    torch.zeros((1, ps, 2, 64), dtype=dtype, device=sm90)])
    table = torch.arange(b * n_pages, dtype=torch.int32,
                         device=sm90).reshape(b, n_pages)
    paged = tpk.paged_decode_attention_cuda(q, kp, vp, table, lens)
    assert torch.equal(paged, out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1, 2048), (4, 64, 2048),
                                   (2048, 2560), (2048, 4096), (4, 1, 8192),
                                   (5, 100)])
def test_rmsnorm_plans_match_plain_version(sm90, dtype, shape):
    """Decode rows (several warps a row), prefill and training rows (one or
    two warps a row), and an odd width (element by element)."""
    g = torch.Generator(device=sm90).manual_seed(5)
    x = torch.randn(shape, generator=g, device=sm90).to(dtype)
    w = torch.randn(shape[-1:], generator=g, device=sm90).to(dtype)
    r = torch.randn(shape, generator=g, device=sm90).to(dtype)
    for res in (None, r):
        _cmp(trk.rmsnorm_cuda(x, w, residual=res),
             trr.rmsnorm_ref(x, w, residual=res), dtype)


@pytest.mark.gpu
def test_tensor_core_ssd_long_chain_and_repeat(sm90):
    """128 chunks chained on one (batch, head) pair, against the plain
    version and the rounding-faithful one; two launches give the same
    bits (the ticket and the epoch flags are ready for the second)."""
    g = torch.Generator(device=sm90).manual_seed(6)
    bf = torch.bfloat16
    b, l, h, p, n = 1, 8192, 1, 64, 64
    x = torch.randn((b, l, h, p), generator=g, device=sm90).to(bf)
    dt = (torch.rand((b, l, h), generator=g, device=sm90) * 0.1).to(bf)
    A = -torch.ones((h,), device=sm90)
    Bm = torch.randn((b, l, 1, n), generator=g, device=sm90).to(bf)
    Cm = torch.randn((b, l, 1, n), generator=g, device=sm90).to(bf)
    D = torch.randn((h,), generator=g, device=sm90)
    assert tdk.ssd_route(x, Bm, Cm, 64) == "mma"
    out = tdk.ssd_cuda(x, dt, A, Bm, Cm, D, chunk=64)
    _cmp(out, tdr.ssd_ref(x, dt, A, Bm, Cm, D, chunk=64), bf)
    torch.testing.assert_close(
        out.float(), tdr.ssd_tensor_core_ref(x, dt, A, Bm, Cm, D,
                                             chunk=64).float(),
        atol=1e-3, rtol=1e-2)
    assert torch.equal(out, tdk.ssd_cuda(x, dt, A, Bm, Cm, D, chunk=64))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_plans_match_plain_version_and_repeat(sm90, dtype):
    """Every lanes-per-channel choice of the scan's planner (N from 4 to
    128), at small sizes (ragged L and C), against the plain version, and
    bit for bit across two launches."""
    g = torch.Generator(device=sm90).manual_seed(7)
    reached = set()
    for b, l, c, n in ((1, 70, 40, 16), (2, 33, 200, 64), (1, 20, 24, 4),
                       (1, 45, 70, 128), (3, 1, 72, 8), (2, 50, 96, 24)):
        scan = (torch.randn((b, l, c), generator=g, device=sm90).to(dtype),
                (torch.rand((b, l, c), generator=g, device=sm90) * 0.5
                 ).to(dtype),
                -torch.rand((c, n), generator=g, device=sm90) * 4,
                torch.randn((b, l, n), generator=g, device=sm90).to(dtype),
                torch.randn((b, l, n), generator=g, device=sm90).to(dtype),
                torch.randn((c,), generator=g, device=sm90))
        reached.add(tsk.plan_scan(b, l, c, n, scan[0].element_size(), 64,
                                  64).lanes)
        out = tsk.selective_scan_cuda(*scan, chunk=64, c_block=64)
        _cmp(out, tsr.selective_scan_chunked_ref(*scan, chunk=64), dtype)
        assert torch.equal(out, tsk.selective_scan_cuda(*scan, chunk=64,
                                                        c_block=64))
    assert reached == {1, 2, 4, 8, 16, 32}


SMALL_CELL = dict(name="small", batch=2, seq_len=128, heads=4, kv_heads=2,
                  head_dim=64, d_model=256, channels=256, scan_state=16,
                  ssm_heads=4, ssm_head_dim=64, ssm_state=64)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wallclock_env_times_the_kernels_on_the_card(sm90, dtype):
    """The wall-clock environment at a small workload: every dispatch
    resolves to ``cuda``, each launch config's times are finite, and its
    outputs agree with the plain versions."""
    import inspect

    import numpy as np

    from repro_torch.envs import KernelLaunchEnv
    from repro_torch.envs.measure import KernelWorkload, family_params
    from repro_torch.kernels import dispatch
    from repro_torch.obs import trace as obs_trace

    fams = ["flash_attention", "mamba_scan", "rmsnorm", "ssd"]
    env = KernelLaunchEnv(KernelWorkload(**SMALL_CELL), families=fams,
                          backend="wallclock",
                          backend_opts={"dtype": dtype, "repeats": 3})
    backend = env.backend
    configs = [env.space.default_config()] + env.space.sample(
        np.random.default_rng(0), 3)
    tracer = obs_trace.start()
    try:
        with dispatch.record_resolutions() as rec:
            for config in configs:
                counters, y = env.intervene(config)
                assert 0 < y < float("inf") and counters["grid_points"] > 0
    finally:
        obs_trace.stop()
    spans = [e["args"] for e in tracer.events() if e["name"] == "measure"]
    assert len(spans) == len(configs)
    with dispatch.record_resolutions() as checked:
        for config, span in zip(configs, spans):
            assert set(span["family_us"]) == set(fams)
            assert all(0 < t < 1e5 for t in span["family_us"].values())
            for fam in fams:
                params = family_params(fam, config)
                plain = dispatch.ref_fn(fam)
                kw = {k: v for k, v in params.items()
                      if k in inspect.signature(plain).parameters}
                _cmp(backend.call(fam, params),
                     plain(*backend.inputs(fam), **kw), dtype)
    for res in (rec, checked):
        assert res and {r.mode for r in res} == {"cuda"}
        assert {r.family for r in res} == set(fams)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 17, 63, 64, 65, 200])
def test_final_state_scan_and_ssd_match_plain_versions(sm90, dtype, l):
    """Serving's prefill variants: the scan's final state, and the SSD's
    initial and final states on both routes (bf16 at P 64, N 64 takes the
    tensor cores, fp32 the SIMT kernel)."""
    g = torch.Generator(device=sm90).manual_seed(l)

    def rnd(*s):
        return torch.randn(s, generator=g, device=sm90).to(dtype)

    def pos(*s):
        return (torch.rand(s, generator=g, device=sm90) * 0.1).to(dtype)

    A = -torch.rand((256, 16), generator=g, device=sm90) * 4
    scan = (rnd(2, l, 256), pos(2, l, 256), A, rnd(2, l, 16), rnd(2, l, 16),
            rnd(256).float())
    y, h = tsk.selective_scan_cuda(*scan, chunk=64, return_state=True)
    ry, rh = tsr.selective_scan_chunked_ref(*scan, chunk=64,
                                            return_state=True)
    _cmp(y, ry, dtype)
    _cmp(h, rh, dtype)
    A = -torch.arange(1, 9, dtype=torch.float32, device=sm90)
    ssd = (rnd(2, l, 8, 64), pos(2, l, 8), A, rnd(2, l, 1, 64),
           rnd(2, l, 1, 64), rnd(8).float())
    s0 = torch.randn((2, 8, 64, 64), generator=g, device=sm90)
    for init in (None, s0):
        y, s = tdk.ssd_cuda(*ssd, chunk=64, init_state=init,
                            return_state=True)
        ry, rs = tdr.ssd_ref(*ssd, chunk=64, init_state=init,
                             return_state=True)
        _cmp(y, ry, dtype)
        _cmp(s, rs, dtype)


# --------------------------------------------------------------------------
# the captured decode step (jitted_steps' decode in a CUDA graph)
# --------------------------------------------------------------------------

GRAPH_ARCHS = ("llama3.2-1b", "falcon-mamba-7b", "zamba2-2.7b")


def _smoke_served(dev, arch, batch=4, cache_len=32):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.utils.config import RunConfig, ShapeConfig

    cfg = get_smoke_config(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig("s", cache_len, batch,
                                                 "decode"))
    model = build_model(cfg, device=dev)
    return model, run, model.init(0)


def _served_state(model, run, params, geometry, batch=4, prompt=6,
                  cache_len=32):
    """The prefilled decode state of ``batch`` seeded prompts: dense, or
    its rows copied into a paged state (4 pages of 8 rows a slot)."""
    from repro_torch.train.serve_step import make_prefill_step
    from test_torch_graph_safe import paged_state

    cfg = model.cfg
    g = torch.Generator(device=model.device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=g, device=model.device, dtype=torch.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.randn(
            (batch, cfg.vision_seq, cfg.vision_dim), generator=g,
            device=model.device)
    if cfg.family == "audio":
        extras["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                       generator=g, device=model.device)
    state, logits = make_prefill_step(model, run, cache_len=cache_len)(
        params, {"tokens": toks, **extras})
    if geometry == "dense":
        return state, logits
    return paged_state(model, state, cache_len // 4, 4), logits


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["dense", "paged"])
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_captured_decode_matches_eager(sm90, arch, geometry):
    """Teacher-forced steps of the captured step and of the eager step on
    two copies of one state: the same logits and states, bit for bit (the
    same kernels with the same launches), one capture, then replays."""
    _captured_matches_eager(sm90, arch, geometry)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,geometry", [
    ("deepseek-v3-671b", "dense"),            # MLA has no paged cache
    ("llama4-maverick-400b-a17b", "dense"),
    ("llama4-maverick-400b-a17b", "paged"),
])
def test_captured_moe_decode_matches_eager(sm90, arch, geometry):
    """The MoE smoke configs' decode step (routing, dense dispatch, the
    shared expert; MLA's absorbed attention for deepseek) captured against
    the eager step, bit for bit."""
    _captured_matches_eager(sm90, arch, geometry)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,geometry", [
    ("llama-3.2-vision-11b", "dense"),
    ("llama-3.2-vision-11b", "paged"),
    ("whisper-large-v3", "dense"),            # audio has no paged state
])
def test_captured_vlm_and_audio_decode_matches_eager(sm90, arch, geometry):
    """The vlm and audio smoke configs' decode step — the cross-attention
    over ``vision_embeds`` / ``enc_out`` recomputed every step (the
    prefill kernel at one query row), the vlm's gates opened — captured
    against the eager step, bit for bit, with the cross-attention's
    launches inside the graph."""
    _captured_matches_eager(sm90, arch, geometry)


def _captured_matches_eager(sm90, arch, geometry):
    from repro_torch.train.serve_step import CapturedDecode, make_decode_step

    model, run, params = _smoke_served(sm90, arch)
    for sub in params.get("blocks", {}).values():
        if "cross_gate" in sub:  # tanh(0) would hide the cross sublayer
            sub["cross_gate"].fill_(0.75)
    eager = make_decode_step(model, run)
    captured = CapturedDecode(make_decode_step(model, run))
    state, logits = _served_state(model, run, params, geometry)
    ref = tree_map(torch.clone, state)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(5):
        out, lg = captured(params, state, tok)
        ref, ref_lg = eager(params, ref, tok)
        assert out is state
        assert torch.equal(lg, ref_lg)
        tok = ref_lg.argmax(-1, keepdim=True).to(torch.int32)
    assert (captured.captures, captured.replays) == (1, 4)
    assert len(captured.graphs) == 1
    graph = next(iter(captured.graphs.values()))
    cross = model.cfg.family in ("vlm", "audio")
    assert (graph.capture.launches.get("flash_attention", 0) > 0) == cross
    for got, want in zip(tree_leaves(state), tree_leaves(ref)):
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_first_captured_call_advances_the_state_by_one_token(sm90, arch):
    from repro_torch.train.serve_step import CapturedDecode, make_decode_step

    model, run, params = _smoke_served(sm90, arch)
    captured = CapturedDecode(make_decode_step(model, run))
    state, logits = _served_state(model, run, params, "dense")
    before = tree_map(torch.clone, state)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    captured(params, state, tok)
    assert torch.equal(state.lengths, before.lengths + 1)
    for new, old in zip(tree_leaves(state.caches),
                        tree_leaves(before.caches)):
        if new.dtype == torch.int32 and new.ndim == 2:   # stacked lengths
            assert torch.equal(new, old + 1)
        elif new.ndim == 5 and new.shape[2] == 32:       # dense K / V rows
            pos = int(before.lengths[0])
            assert not torch.equal(new[:, :, pos], old[:, :, pos])
            assert torch.equal(new[:, :, pos + 1:], old[:, :, pos + 1:])
            assert torch.equal(new[:, :, :pos], old[:, :, :pos])


@pytest.mark.gpu
def test_captured_graph_survives_scratch_growth(sm90):
    """A 4-slot graph keeps the split decode's scratch it captured: a
    32-slot eager decode grows the scratch (the old tensors would be
    freed), fresh tensors take the freed memory, and the replays still
    give the eager step's logits."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.train.serve_step import CapturedDecode, make_decode_step

    model, run, params = _smoke_served(sm90, "llama3.2-1b")
    eager = make_decode_step(model, run)
    cuda_lib._decode_scratch.clear()  # the capture takes a fresh scratch
    captured = CapturedDecode(make_decode_step(model, run))
    state, logits = _served_state(model, run, params, "dense")
    ref = tree_map(torch.clone, state)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    captured(params, state, tok)
    eager(params, ref, tok)
    small = cuda_lib._decode_scratch[state.lengths.device][0]
    big_state, big_logits = _served_state(model, run, params, "dense",
                                          batch=32, cache_len=512)
    eager(params, big_state, big_logits.argmax(-1, keepdim=True).int())
    grown = cuda_lib._decode_scratch[state.lengths.device][0]
    assert grown.numel() > small.numel()
    graph = next(iter(captured.graphs.values()))
    assert any(t is small for t in graph.capture.scratch)
    del small
    junk = [torch.full((1 << 20,), float("nan"), device=sm90)
            for _ in range(8)]
    for _ in range(3):
        _, lg = captured(params, state, tok)
        _, ref_lg = eager(params, ref, tok)
        assert torch.equal(lg, ref_lg)
    del junk


@pytest.mark.gpu
def test_launch_counters_count_replays(sm90):
    from repro_torch.kernels import cuda_lib
    from repro_torch.train.serve_step import CapturedDecode, make_decode_step

    model, run, params = _smoke_served(sm90, "zamba2-2.7b")
    eager = make_decode_step(model, run)
    captured = CapturedDecode(make_decode_step(model, run))
    state, logits = _served_state(model, run, params, "dense")
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    cuda_lib.reset_launches()
    eager(params, tree_map(torch.clone, state), tok)
    per_step = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    assert per_step.get("rmsnorm") and per_step.get("decode_attention")
    cuda_lib.reset_launches()
    captured(params, state, tok)  # the eager run counts, the capture not
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == per_step
    cuda_lib.reset_launches()
    n = 6
    for _ in range(n):
        captured(params, state, tok)
    assert {k: v for k, v in cuda_lib.LAUNCHES.items() if v} == {
        k: n * v for k, v in per_step.items()}


@pytest.mark.gpu
def test_a_failed_capture_raises_and_does_not_fall_back(sm90):
    from repro_torch.train.serve_step import CapturedDecode, ServeState

    def host_read(params, state, tokens):
        state.lengths.add_(int(tokens.sum()))  # .item(): refused in capture
        return state, tokens.float()

    state = ServeState({}, torch.zeros(4, dtype=torch.int32, device=sm90),
                       {})
    step = CapturedDecode(host_read)
    tok = torch.ones((4, 1), dtype=torch.int32, device=sm90)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(None, state, tok)
        torch.cuda.synchronize()
    assert step.graphs == {} and step.captures == 0


@pytest.mark.gpu
def test_graphs_are_kept_per_signature_and_evicted_least_recent_first(
        sm90, monkeypatch):
    """Three states, two graphs kept: the third capture evicts the least
    recently used one, and a call on its state captures again."""
    from repro_torch.train import serve_step
    from repro_torch.train.serve_step import CapturedDecode, make_decode_step

    monkeypatch.setattr(serve_step, "MAX_GRAPHS", 2)
    model, run, params = _smoke_served(sm90, "llama3.2-1b")
    eager = make_decode_step(model, run)
    captured = CapturedDecode(make_decode_step(model, run))
    served = [_served_state(model, run, params, "dense") for _ in range(3)]
    refs = [tree_map(torch.clone, state) for state, _ in served]
    toks = [lg.argmax(-1, keepdim=True).to(torch.int32) for _, lg in served]
    for i in (0, 1, 0, 2, 0, 1):  # 2 evicts 1 (0 was used after it)
        _, lg = captured(params, served[i][0], toks[i])
        _, ref_lg = eager(params, refs[i], toks[i])
        assert torch.equal(lg, ref_lg)
    assert captured.captures == 4  # 0, 1, 2, then 1 again
    assert len(captured.graphs) == 2


# --------------------------------------------------------------------------
# checkpoints and the fault-tolerant driver on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_checkpoint_roundtrip_survives_in_place_updates(sm90, tmp_path):
    """An async save of CUDA tensors (fp32, bf16, int32) copies them to
    the host before it returns: updating them in place afterwards leaves
    the checkpoint as it was; the restore lands on the card bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager

    g = torch.Generator(device=sm90).manual_seed(7)
    tree = {"w": torch.randn(64, 48, generator=g, device=sm90),
            "n": {"s": torch.randn(48, generator=g, device=sm90)
                  .to(torch.bfloat16),
                  "i": torch.arange(5, dtype=torch.int32, device=sm90)}}
    want = tree_map(torch.clone, tree)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(3, tree)
    for leaf in tree_leaves(tree):
        leaf.add_(1)
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), want)
    got = mgr.restore(3, meta, device=sm90)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_driver_restarts_on_the_card(sm90, tmp_path):
    """A short driver run on ``cuda`` with a fault before step 3: it
    restores step 2 and finishes, its losses finite."""
    import json

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import make_data
    from repro_torch.launch.train import make_run
    from repro_torch.models.model import build_model
    from repro_torch.runtime.driver import FaultInjector, TrainDriver
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              train_state_template)
    from repro_torch.utils.logging import MetricsLogger

    cfg = get_smoke_config("deepseek-v3-671b")
    run = make_run(cfg, seq=32, batch=2, steps=4,
                   checkpoint_dir=str(tmp_path / "ckpt")).replace(
        checkpoint_every=2, log_every=1)
    model = build_model(cfg, run.parallel, device=sm90)
    opt = make_optimizer(run.train)
    with MetricsLogger(path=str(tmp_path / "log.jsonl"), name="gpu") as log:
        driver = TrainDriver(
            run, make_train_step(model, run, opt),
            lambda: init_train_state(model, run, opt, seed=0),
            make_data(cfg, run.shape, seed=0),
            CheckpointManager(run.checkpoint_dir, keep=2), logger=log,
            fault_injector=FaultInjector([3]), device=sm90,
            state_template=lambda: train_state_template(model, run, opt))
        state = driver.run_steps(4)
    assert state.step == 4 and driver.restarts == 1
    assert tree_leaves(state.params)[0].device.type == "cuda"
    recs = [json.loads(line)
            for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert [(r["step"], r["event"]) for r in recs if "event" in r] == \
        [(0, "init_fresh"), (-1, "fault"), (2, "restored")]
    assert all(torch.isfinite(torch.tensor(r["loss"]))
               for r in recs if "loss" in r)


# --------------------------------------------------------------------------
# the data-parallel train step and fleet replay on the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_nccl_world_one_step_equals_the_plain_step(sm90):
    """The train loop under an NCCL process group of one rank (the loss's
    sums, the MoE statistics and the gradients all-reduced) gives the
    plain loop's losses, gradient norms and parameters bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.train import train
    from repro_torch.utils.trees import flatten_with_paths

    cfg = get_smoke_config("deepseek-v3-671b")
    kw = dict(steps=2, seq=256, batch=2, device=sm90)
    plain = train(cfg, **kw)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dp = train(cfg, **kw)
    finally:
        dist.destroy_process_group()
    assert dp.losses == plain.losses and dp.grad_norms == plain.grad_norms
    a, b = (flatten_with_paths(r.state.params) for r in (dp, plain))
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.gpu
def test_fleet_intervention_runs_on_the_card(sm90):
    """``ReplayServingEnv(fleet=True)`` on ``cuda``: two replicas routed
    by join-shortest-queue, every resolution the CUDA kernels, a finite
    p99, no decode graph captured inside the measured replays."""
    import math

    from repro_torch.envs.replay_env import (ReplayServingEnv,
                                             default_replay_model)
    from repro_torch.kernels import dispatch

    # head dim 16: the narrowest the prefill kernel is built for
    model_cfg = default_replay_model().replace(d_model=64, d_ff=128,
                                               head_dim=16)
    env = ReplayServingEnv("poisson:rate=2000,horizon=0.01,mean_prompt=5,"
                           "mean_output=3,max_len=12", model_cfg, seed=0,
                           repeats=1, fleet=True, num_devices=4, device=sm90)
    cfg = dict(env.space.default_config(),
               **{"fleet.routing": "join_shortest_queue"})
    with dispatch.record_resolutions() as res:
        counters, y = env.intervene(cfg)
    assert math.isfinite(y) and y > 0
    assert {r.mode for r in res} == {"cuda"}
    assert {"rmsnorm", "flash_attention"} <= {r.family for r in res}
    assert counters["routing_imbalance"] >= 1.0
    assert env.measured_captures == 0


@pytest.mark.gpu
def test_analysis_gate_with_the_builds_ptxas_report(sm90):
    """``python -m repro_torch.analysis --gate --ptxas`` over the port with
    the ``ptxas.log`` of the kernels just built: exit 0 (registers x
    threads of every launch record within an SM, every record's instance
    in the report), every launch config checked."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import cuda_lib

    root = Path(__file__).resolve().parents[1]
    log = cuda_lib.build().parent / "ptxas.log"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--gate", "--format",
         "json", "--ptxas", str(log), "src/repro_torch"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    doc = json.loads(res.stdout)
    assert doc["summary"]["configs_checked"] == 87
    assert not [f for f in doc["findings"]
                if f["rule"] == "kernel-unanalyzable"], doc["findings"]
