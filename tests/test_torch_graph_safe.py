"""The decode step that ``jitted_steps`` returns can be captured in a CUDA
graph: checked on the CPU at the smoke configs of the served families
(``llama3.2-1b`` dense, ``falcon-mamba-7b`` ssm, ``zamba2-2.7b`` hybrid,
``deepseek-v3-671b`` moe with MLA, ``llama4-maverick-400b-a17b`` moe
with GQA, ``llama-3.2-vision-11b`` vlm and ``whisper-large-v3`` audio,
the last two with their ``vision_embeds`` / ``enc_out`` in the state's
extras), with dense and paged decode state (deepseek's MLA cache has no
paged form: its paged cases check that it raises, as the reference does;
the audio family has no paged state, as in the reference).  The batcher
keeps no extras for the vlm and audio families, as the reference's does
not: their requests fail at prefill.

- Under a ``TorchDispatchMode`` the decode step runs no operation that a
  stream under capture refuses or that reads device data on the host:
  ``aten.lift_fresh`` (Python data to a tensor), ``aten._local_scalar_dense``
  (``.item()``, ``int(t)``) and ``aten.nonzero``.
- The step leaves every state leaf on its input storage (data pointers
  equal, lengths included) and gives the eager step's values, bit for bit.
- The batcher's state keeps one signature from tick to tick, so a graph
  is captured once per batcher.
- The helpers: the input signature (a changed shape, dtype, stride, data
  pointer or dispatch mode gives a new one, an unchanged input does not),
  the in-place check, the launch accounting and scratch keeping of a
  capture, the embedding scale.

The graph itself needs the card: ``tests/test_torch_gpu.py`` (marked
``gpu``) and ``chip_smoke.py`` phase 4f.
"""

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.models.layers import embed_tokens
from repro_torch.models.model import build_model
from repro_torch.serving.paging import PagedPlan
from repro_torch.serving.scheduler import ContinuousBatcher, Request
from repro_torch.train.serve_step import (
    CapturedDecode, ServeState, check_in_place, jitted_steps,
    make_decode_step, make_prefill_step, step_signature)
from repro_torch.utils.config import RunConfig, ShapeConfig
from repro_torch.utils.trees import tree_leaves, tree_map

torch.set_num_threads(1)

ARCHS = ("llama3.2-1b", "falcon-mamba-7b", "zamba2-2.7b",
         "deepseek-v3-671b", "llama4-maverick-400b-a17b",
         "llama-3.2-vision-11b", "whisper-large-v3")
#: families whose decode step reads a per-request input from the extras
EXTRAS_FAMILIES = ("vlm", "audio")
GEOMETRIES = ("dense", "paged")
#: what a capturing stream refuses, or a host read of device data
REFUSED = {"aten::lift_fresh", "aten::_local_scalar_dense", "aten::nonzero"}
B, PROMPT, CACHE_LEN, STEPS = 2, 5, 16, 3
PAGE, PAGES_PER_SLOT = 4, 4


class RefusedOps(TorchDispatchMode):
    """Records every refused operation run underneath."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in REFUSED:
            self.hits.append(func._schema.name)
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        run = RunConfig(model=cfg, shape=ShapeConfig("s", CACHE_LEN, B,
                                                     "decode"))
        model = build_model(cfg, device="cpu")
        out[arch] = (model, run, model.init(0))
    return out


def _batch(cfg):
    """The prompts and, for the vlm and audio families, their seeded
    ``vision_embeds`` / ``frames``."""
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.vision_seq, cfg.vision_dim)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return batch


def paged_state(model, state, page, pages_per_slot):
    """``state`` (a dense decode state) with its KV rows copied into a
    paged state of ``pages_per_slot`` pages of ``page`` rows a slot: slot
    b on pages b * pages_per_slot onwards, in order."""
    b = state.lengths.shape[0]
    pool = b * pages_per_slot
    caches = model.init_paged_decode_state(b, pool, page, pages_per_slot)

    def fill(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                fill(dst[k], src[k])
        elif hasattr(dst, "page_table"):
            nsb = src.k.shape[0]
            for pool_t, dense in ((dst.k_pages, src.k), (dst.v_pages, src.v)):
                pool_t[:, :pool] = dense.reshape(nsb, pool, page,
                                                 *dense.shape[3:])
            dst.page_table.copy_(torch.arange(
                pool, dtype=torch.int32, device=dst.page_table.device)
                .reshape(b, pages_per_slot).expand(nsb, b, pages_per_slot))
            dst.length.copy_(src.length)
        else:
            for d, s in zip(dst, src):
                d.copy_(s)
    fill(caches, state.caches)
    return ServeState(caches, state.lengths.clone(), state.extras)


def _paged_absent(model, geometry) -> bool:
    """True (after checking it) where ``geometry`` is paged and the model
    has no paged state: MLA's compressed cache has no paged form (the
    paged state raises, as the reference's does), and the audio family
    has no paged state at all (as in the reference)."""
    if geometry == "dense":
        return False
    if model.cfg.family == "audio":
        assert model.init_paged_decode_state is None
        return True
    if model.cfg.attn_type != "mla":
        return False
    with pytest.raises(NotImplementedError, match="MLA"):
        model.init_paged_decode_state(B, B * PAGES_PER_SLOT, PAGE,
                                      PAGES_PER_SLOT)
    return True


def _state(model, run, params, geometry):
    """A decode state after prefilling ``_batch``: the dense prefill's
    state, or its :func:`paged_state`."""
    prefill = make_prefill_step(model, run, cache_len=CACHE_LEN)
    state, logits = prefill(params, _batch(model.cfg))
    if geometry == "dense":
        return state, logits
    return paged_state(model, state, PAGE, PAGES_PER_SLOT), logits


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_runs_no_refused_operation(models, arch, geometry):
    model, run, params = models[arch]
    if _paged_absent(model, geometry):
        return
    _, decode = jitted_steps(model, run, cache_len=CACHE_LEN)
    state, logits = _state(model, run, params, geometry)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    with RefusedOps() as mode:
        for _ in range(STEPS):
            state, logits = decode(params, state, tok)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    assert mode.hits == []


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_jitted_decode_keeps_state_storage_and_eager_values(models, arch,
                                                           geometry):
    model, run, params = models[arch]
    if _paged_absent(model, geometry):
        return
    _, decode = jitted_steps(model, run, cache_len=CACHE_LEN)
    eager = make_decode_step(model, run)
    state, logits = _state(model, run, params, geometry)
    ref_state = tree_map(torch.clone, state)
    ptrs = [t.data_ptr() for t in tree_leaves(state)]
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(STEPS):
        out, logits = decode(params, state, tok)
        ref_state, ref_logits = eager(params, ref_state, tok)
        assert out is state
        assert torch.equal(logits, ref_logits)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    assert [t.data_ptr() for t in tree_leaves(state)] == ptrs
    for got, want in zip(tree_leaves(state), tree_leaves(ref_state)):
        assert torch.equal(got, want)
    assert state.lengths.tolist() == [PROMPT + STEPS] * B
    for leaf in tree_leaves(state.caches):
        if leaf.dtype == torch.int32 and leaf.shape[-1:] == (B,):
            assert leaf.eq(PROMPT + STEPS).all()  # every stacked length


@pytest.mark.parametrize("geometry", ["dense", "paged", "paged_chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_state_keeps_one_signature(models, arch, geometry):
    """Tick after tick the batcher hands the step the same tensors, so a
    graph is captured once per batcher: the scatters, the lengths and the
    parked page tables write into the state's own storage."""
    model, run, params = models[arch]
    plans = {"dense": None,
             "paged": PagedPlan(paging=True, pool_pages=8, page_size=4,
                                pages_per_slot_max=4),
             "paged_chunked": PagedPlan(paging=True, pool_pages=8,
                                        page_size=4, pages_per_slot_max=4,
                                        prefill_chunk=2)}
    if _paged_absent(model, geometry):
        with pytest.raises(NotImplementedError,
                           match="MLA|no paged decode state"):
            ContinuousBatcher(model, run, params, num_slots=2, cache_len=16,
                              paged=plans[geometry])
        return
    b = ContinuousBatcher(model, run, params, num_slots=2, cache_len=16,
                          paged=plans[geometry])
    rng = np.random.default_rng(1)
    for uid, n in enumerate((5, 3, 6)):
        b.submit(Request(uid=uid, prompt=rng.integers(0, 100, n)
                         .astype(np.int32), max_new_tokens=4))
    if model.cfg.family in EXTRAS_FAMILIES:
        # the batcher keeps no per-request extras, as the reference's
        # does not: the prefill finds no vision_embeds / frames
        with pytest.raises(KeyError, match="vision_embeds|frames"):
            b.run_until_drained(max_ticks=100)
        return
    seen = []
    step = b._decode

    def spy(p, state, tokens):
        seen.append(step_signature(p, state, tokens))
        return step(p, state, tokens)
    b._decode = spy
    done = b.run_until_drained(max_ticks=100)
    assert len(done) == 3 and len(seen) == b.ticks > 3
    assert all(sig == seen[0] for sig in seen)


def test_signature_changes_with_the_inputs_it_covers(models):
    model, run, params = models["llama3.2-1b"]
    state, logits = _state(model, run, params, "dense")
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    sig = step_signature(params, state, tok)
    # unchanged: the same tensors, other token values, another token tensor
    assert step_signature(params, state, tok) == sig
    assert step_signature(params, state, (tok + 1) % 7) == sig
    # the tokens' shape and dtype
    assert step_signature(params, state, tok[:1]) != sig
    assert step_signature(params, state, tok.long()) != sig
    # a state leaf's data pointer (a copy of the same values), dtype, stride
    moved = state._replace(lengths=state.lengths.clone())
    assert torch.equal(moved.lengths, state.lengths)
    assert step_signature(params, moved, tok) != sig
    assert step_signature(params, state._replace(
        lengths=state.lengths.long()), tok) != sig
    kv = state.caches["sub0"]
    strided = kv._replace(k=kv.k.transpose(1, 2).contiguous().transpose(1, 2))
    assert strided.k.shape == kv.k.shape
    assert step_signature(params, state._replace(
        caches={"sub0": strided}), tok) != sig
    # a parameter leaf's data pointer
    other = dict(params, final_norm={"scale": params["final_norm"]["scale"]
                                     .clone()})
    assert step_signature(other, state, tok) != sig
    # the tree's structure
    assert step_signature(params, state._replace(extras={"x": tok}),
                          tok) != sig
    # the dispatch mode in force
    with dispatch.use_mode(dispatch.CUDA):
        assert step_signature(params, state, tok) != sig
    assert step_signature(params, state, tok) == sig


def test_check_in_place_accepts_the_same_tensors_and_refuses_new_ones():
    t = torch.zeros(3)
    kv = (torch.zeros(2), torch.ones(2))
    state = ServeState({"sub0": kv}, t, {})
    check_in_place(state, ServeState({"sub0": kv}, t, {}))
    with pytest.raises(ValueError, match="state.lengths"):
        check_in_place(state, ServeState({"sub0": kv}, t + 1, {}))
    with pytest.raises(ValueError, match=r"caches.sub0.1"):
        check_in_place(state, ServeState({"sub0": (kv[0], kv[1].clone())},
                                         t, {}))
    with pytest.raises(ValueError, match="keys"):
        check_in_place(state, ServeState({"sub1": kv}, t, {}))


def test_cpu_decode_refuses_a_step_that_returns_new_state():
    def functional(params, state, tokens):
        return state._replace(lengths=state.lengths + 1), tokens.float()

    state = ServeState({}, torch.zeros(2, dtype=torch.int32), {})
    with pytest.raises(ValueError, match="in place"):
        CapturedDecode(functional)(None, state, torch.zeros(2, 1))


def test_capture_scope_moves_launch_counts_and_keeps_scratch():
    cuda_lib.reset_launches()
    cuda_lib.LAUNCHES["rmsnorm"] += 2
    dev = torch.device("cpu")
    with cuda_lib.capture_scope() as rec:
        cuda_lib.LAUNCHES["rmsnorm"] += 3
        cuda_lib.LAUNCHES["decode_attention"] += 1
        part, cnt = cuda_lib.decode_scratch(dev, 10 ** 6, 8)
    # a capture launches nothing: the counts it added are its delta
    assert rec.launches == {"rmsnorm": 3, "decode_attention": 1}
    assert cuda_lib.LAUNCHES["rmsnorm"] == 2
    assert cuda_lib.LAUNCHES["decode_attention"] == 0
    for _ in range(4):
        cuda_lib.add_launches(rec.launches)
    assert cuda_lib.LAUNCHES["rmsnorm"] == 2 + 4 * 3
    assert cuda_lib.LAUNCHES["decode_attention"] == 4
    # a larger call grows the scratch; the capture still holds the old one
    bigger, _ = cuda_lib.decode_scratch(dev, 2 * 10 ** 6, 8)
    assert bigger.data_ptr() != part.data_ptr()
    assert any(t is part for t in rec.scratch)
    assert any(t is cnt for t in rec.scratch)
    # outside a capture nothing more is kept
    cuda_lib.decode_scratch(dev, 3 * 10 ** 6, 8)
    assert len(rec.scratch) == 2
    cuda_lib.reset_launches()
    cuda_lib._decode_scratch.pop(dev)


def test_capture_scope_restores_counts_when_the_capture_fails():
    cuda_lib.reset_launches()
    with pytest.raises(RuntimeError, match="boom"):
        with cuda_lib.capture_scope():
            cuda_lib.LAUNCHES["rmsnorm"] += 5
            raise RuntimeError("boom")
    assert cuda_lib.LAUNCHES["rmsnorm"] == 0
    assert cuda_lib._recording == []


def test_the_ssd_epoch_refuses_a_capture():
    dev = torch.device("cpu")
    with cuda_lib.capture_scope():
        with pytest.raises(RuntimeError, match="host-side epoch"):
            cuda_lib.next_epoch(dev)
    assert cuda_lib.next_epoch(dev) >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d_model", [64, 80, 2048, 2560, 4096])
def test_embed_scale_is_the_rounded_tensor_scale(dtype, d_model):
    g = torch.Generator().manual_seed(d_model)
    emb = torch.randn(50, d_model, generator=g).to(dtype)
    toks = torch.randint(0, 50, (3, 7), generator=g)
    old = torch.nn.functional.embedding(toks, emb) * torch.tensor(
        math.sqrt(d_model), dtype=dtype)
    assert torch.equal(embed_tokens({"embedding": emb}, toks, d_model), old)


def test_cpu_decode_captures_nothing(models):
    model, run, params = models["zamba2-2.7b"]
    _, decode = jitted_steps(model, run, cache_len=CACHE_LEN)
    state, logits = _state(model, run, params, "dense")
    before = (decode.captures, decode.replays)
    decode(params, state, logits.argmax(-1, keepdim=True).to(torch.int32))
    assert (decode.captures, decode.replays) == before == (0, 0)
    assert decode.graphs == {}
