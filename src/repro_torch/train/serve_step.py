"""Serve-step factories: prefill / decode / generate — the port of
:mod:`repro.train.serve_step`.

``make_prefill_step`` runs the whole prompt, filling the KV caches and
computing the recurrent (SSM) states, and returns the last-position
logits; ``make_decode_step`` advances one token per slot.  The vlm and
audio families carry a per-request input in ``ServeState.extras``: the
prefill keeps the batch's ``vision_embeds``, or encodes the batch's
``frames`` once and keeps ``enc_out``, and every decode step attends over
it (the graph reads it where it lies, so its address is part of the
signature).  Both run their
body under an *exclusive* ``dispatch.use_launch_config`` so a step is a
pure function of its ``launch_config``.  They run eagerly.

With ``mesh`` (the :class:`~repro_torch.launch.mesh.MeshSpec` the run
executes on, as ``make_train_step`` takes it) a step is one rank's:
``params`` are the rank's blocks under the rules' placements
(:func:`~repro_torch.sharding.layout.shard_params`), the batch, tokens
and state are the rows of the rank's data coordinate, and the forward
runs on the :class:`~repro_torch.sharding.layout.Layout` of the train
step: tensor-parallel products, FSDP blocks gathered before use, experts
on their ranks, the stream in sequence blocks under ``sp`` (prefill).
The decode state holds the rank's KV heads, channels or SSM heads
(``init_decode_state(..., layout=)``); every model rank ends with the
whole vocab's logits.  The sharded decode runs eagerly (no graph).
Without a mesh nothing of this runs.

:func:`jitted_steps` keeps its name and its cache key ``(model, run,
cache_len, frozen launch config)``.  Its prefill is the eager step (one
shape per prompt length; the tensor-core SSD's host-side epoch cannot be
captured).  Its decode is :class:`CapturedDecode`, the counterpart of the
reference's ``jax.jit``: on CUDA inputs it captures the eager step in a
CUDA graph at the first call with an input signature
(:func:`step_signature`: the tokens' shape, the trees' structure, shapes,
dtypes, strides and data pointers, the device and the dispatch mode) and
replays that graph afterwards.  The first call runs the eager step on the
live state — its result is the call's result and its run is the capture's
warm-up — and then records the step without running it, so the state
moves by exactly one token.  Later calls copy the tokens into the graph's
own buffer and replay.  The logits come back in the graph's static output,
overwritten by the next replay: the batcher and :func:`generate` consume
them (sample, copy to the host) before their next step.  Dispatch
resolutions, ``DispatchProfile`` entries and obs spans inside the step are
recorded when it is captured, as the reference records them at trace time,
and not again at a replay; the kernels' launch counts are added at every
replay (:func:`repro_torch.kernels.cuda_lib.capture_scope`).  A capture or
replay that fails raises: there is no eager fallback and no switch.  On
the CPU the decode is the eager step.

Unlike the reference's functional steps, a step updates the state it is
given in place — KV rows, page tables, lengths and recurrent states — and
returns a state over the same tensors; the step that :func:`jitted_steps`
returns checks that (:func:`check_in_place`: a graph keeps writing where
its capture wrote) and returns the input state itself.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import cuda_lib, dispatch
from repro_torch.models import encdec
from repro_torch.models.model import Model, build_model
from repro_torch.obs import trace as obs_trace
from repro_torch.sharding.layout import Layout
from repro_torch.utils.config import RunConfig


def freeze_launch_config(launch_config: Optional[Dict[str, Any]]
                         ) -> Tuple[Tuple[str, Tuple[Tuple[str, Any], ...]], ...]:
    """Hashable canonical form of a launch config (flat or nested) — the
    step-cache key component, so equivalent spellings share one entry."""
    if not launch_config:
        return ()
    nested = dispatch.split_launch_config(launch_config)
    return tuple((f, tuple(sorted(p.items()))) for f, p in sorted(nested.items()))


class ServeState(NamedTuple):
    caches: Any                   # stacked per-super-block decode state
    lengths: torch.Tensor         # (B,) int32 tokens consumed so far
    extras: Dict[str, torch.Tensor]  # enc_out / vision_embeds, per request


def _sharded(model: Model, run: RunConfig, mesh):
    """``(layout_of, gathered)`` of a step on ``mesh``: the step's
    :class:`~repro_torch.sharding.layout.Layout` (None without a mesh;
    made here on an executing or traced mesh, at the step's first call on
    a description, which a bundle's step may be built on); and the context
    that gives the rank's parameters with every FSDP block but the stacked
    layers' gathered (the forward gathers those a layer slice at a time),
    forgetting them after."""
    bound: Dict[str, Any] = {}

    def layout_of() -> Optional[Layout]:
        if mesh is None:
            return None
        if "layout" not in bound:
            shapes = build_model(model.cfg, run.parallel,
                                 device="meta").init(0)
            bound["layout"] = Layout.of(shapes, run, mesh)
        return bound["layout"]

    if mesh is not None and mesh.groups is not None:
        layout_of()

    @contextlib.contextmanager
    def gathered(params, layout):
        if layout is None:
            yield params
            return
        try:
            yield {k: v if k == "blocks" else layout.gather(v, f"{k}/")
                   for k, v in params.items()}
        finally:
            layout.release()

    return layout_of, gathered


def make_prefill_step(model: Model, run: RunConfig,
                      cache_len: Optional[int] = None,
                      launch_config: Optional[Dict[str, Any]] = None, *,
                      mesh=None
                      ) -> Callable[..., Tuple[ServeState, torch.Tensor]]:
    """Returns prefill(params, batch) -> (ServeState, last_logits (B, V));
    with ``mesh`` one rank's (module docstring)."""
    cfg = model.cfg
    max_len = cache_len or run.shape.seq_len
    dispatch.split_launch_config(launch_config or {})  # eager validation
    layout_of, gathered = _sharded(model, run, mesh)

    @torch.no_grad()
    def prefill_step(params, batch: Dict) -> Tuple[ServeState, torch.Tensor]:
        layout = layout_of()
        with dispatch.use_launch_config(launch_config, exclusive=True), \
                gathered(params, layout) as params:
            tokens = batch["tokens"]
            b, s = tokens.shape
            with obs_trace.span("prefill.state", cat="serve"):
                caches = model.init_decode_state(b, max_len, layout=layout)
            extras: Dict[str, torch.Tensor] = {}
            with obs_trace.span("prefill.forward", cat="serve"):
                if cfg.family == "audio":
                    par = run.parallel
                    enc_out = encdec.encode(params, cfg, par,
                                            batch["frames"], layout)
                    extras["enc_out"] = enc_out
                    logits, new_caches = encdec.decode_forward(
                        params, cfg, par, tokens, enc_out,
                        decode_state=caches, decode=False, layout=layout,
                        last=True)
                else:
                    fkw = {}
                    if cfg.family == "vlm":
                        extras["vision_embeds"] = batch["vision_embeds"]
                        fkw["vision_embeds"] = batch["vision_embeds"]
                    logits, new_caches, _ = model.forward(
                        params, tokens, decode_state=caches, decode=False,
                        layout=layout, last=True, **fkw)
            lengths = torch.full((b,), s, dtype=torch.int32,
                                 device=tokens.device)
            return ServeState(new_caches, lengths, extras), logits

    return prefill_step


def make_decode_step(model: Model, run: RunConfig,
                     launch_config: Optional[Dict[str, Any]] = None, *,
                     mesh=None
                     ) -> Callable[..., Tuple[ServeState, torch.Tensor]]:
    """Returns decode(params, state, tokens (B,1)) -> (state', logits (B,
    V)); with ``mesh`` one rank's (module docstring)."""
    cfg = model.cfg
    dispatch.split_launch_config(launch_config or {})  # eager validation
    layout_of, gathered = _sharded(model, run, mesh)

    @torch.no_grad()
    def decode_step(params, state: ServeState, tokens: torch.Tensor
                    ) -> Tuple[ServeState, torch.Tensor]:
        layout = layout_of()
        with dispatch.use_launch_config(launch_config, exclusive=True), \
                gathered(params, layout) as params:
            positions = state.lengths[:, None]  # (B, 1) per-request positions
            if cfg.family == "audio":
                logits, new_caches = encdec.decode_forward(
                    params, cfg, run.parallel, tokens,
                    state.extras["enc_out"], positions=positions,
                    decode_state=state.caches, decode=True, layout=layout,
                    last=True)
            else:
                fkw = {}
                if cfg.family == "vlm":
                    fkw["vision_embeds"] = state.extras["vision_embeds"]
                logits, new_caches, _ = model.forward(
                    params, tokens, positions=positions,
                    decode_state=state.caches, decode=True, layout=layout,
                    last=True, **fkw)
            state.lengths.add_(1)
            new_state = ServeState(new_caches, state.lengths, state.extras)
            return new_state, logits

    return decode_step


# --------------------------------------------------------------------------
# the captured decode step
# --------------------------------------------------------------------------

#: graphs kept by one cached decode step, least recently used evicted
MAX_GRAPHS = 4


def _describe(node: Any, out: List) -> None:
    if isinstance(node, torch.Tensor):
        out.append((tuple(node.shape), node.dtype, node.stride(),
                    node.data_ptr(), node.device))
    elif isinstance(node, dict):
        keys = sorted(node)
        out.append(("dict", tuple(keys)))
        for k in keys:
            _describe(node[k], out)
    elif isinstance(node, tuple):
        out.append((type(node).__name__, len(node)))
        for x in node:
            _describe(x, out)
    elif node is None:
        out.append(None)
    else:
        raise TypeError(f"unexpected node in a step's inputs: "
                        f"{type(node).__name__}")


def step_signature(params, state: ServeState, tokens: torch.Tensor) -> Tuple:
    """What a captured decode graph is valid for, as ``jax.jit`` retraces
    per input signature: the tokens' shape, dtype and device (their values
    are copied in), every leaf of ``params`` and ``state`` by structure,
    shape, dtype, strides, data pointer and device (the graph reads and
    writes those addresses), and the dispatch mode in force."""
    out: List = [("tokens", tuple(tokens.shape), tokens.dtype, tokens.device),
                 ("mode", dispatch.default_mode(tokens.device))]
    _describe(params, out)
    _describe(state, out)
    return tuple(out)


def check_in_place(state: Any, new_state: Any, path: str = "state") -> None:
    """Raise unless every tensor leaf of ``new_state`` (what a step
    returned) is ``state``'s own tensor.  A graph's replays write where its
    capture wrote: a leaf that the step returned as a new tensor would live
    in the graph's pool and never reach the caller's state."""
    if isinstance(state, torch.Tensor):
        if new_state is not state:
            raise ValueError(f"the decode step returned {path} as a new "
                             f"tensor; it must update the state in place")
    elif isinstance(state, dict):
        if state.keys() != new_state.keys():
            raise ValueError(f"{path}: keys {sorted(new_state)} != "
                             f"{sorted(state)}")
        for k in state:
            check_in_place(state[k], new_state[k], f"{path}.{k}")
    elif isinstance(state, tuple):
        if type(new_state) is not type(state) or len(new_state) != len(state):
            raise ValueError(f"{path}: {type(new_state).__name__} does not "
                             f"match {type(state).__name__}")
        names = getattr(state, "_fields", None) or range(len(state))
        for name, a, b in zip(names, state, new_state):
            check_in_place(a, b, f"{path}.{name}")
    elif state is not None or new_state is not None:
        raise TypeError(f"{path}: unexpected node {type(state).__name__}")


class _Graph(NamedTuple):
    graph: Any                    # torch.cuda.CUDAGraph
    tokens: torch.Tensor          # the static token buffer
    logits: torch.Tensor          # the static output
    capture: cuda_lib.Capture     # launches per replay, scratch kept alive
    pool_bytes: int               # device memory its capture reserved
    capture_s: float


_capture_streams: Dict[torch.device, Any] = {}


def _capture_stream(device: torch.device):
    """One side stream per device for the first calls and their captures
    (the ``torch.cuda.graphs`` recipe warms up on the capture stream)."""
    s = _capture_streams.get(device)
    if s is None:
        s = _capture_streams[device] = torch.cuda.Stream(device)
    return s


class CapturedDecode:
    """The decode step of :func:`jitted_steps` (see the module docstring):
    ``decode(params, state, tokens (B, 1)) -> (state, logits (B, V))`` with
    ``state`` the input state, updated in place.  :attr:`graphs` maps each
    input signature to its graph, at most :data:`MAX_GRAPHS` of them;
    each graph has its own memory pool, released when it is evicted.  It
    counts its captures, their wall time (capture and instantiation, not
    the eager warm-up) and its replays."""

    def __init__(self, eager: Callable):
        self.eager = eager
        self.graphs: "OrderedDict[Tuple, _Graph]" = OrderedDict()
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def __call__(self, params, state: ServeState, tokens: torch.Tensor
                 ) -> Tuple[ServeState, torch.Tensor]:
        if tokens.device.type != "cuda":
            new_state, logits = self.eager(params, state, tokens)
            check_in_place(state, new_state)
            return state, logits
        sig = step_signature(params, state, tokens)
        g = self.graphs.get(sig)
        if g is None:
            return self._first_call(sig, params, state, tokens)
        self.graphs.move_to_end(sig)
        g.tokens.copy_(tokens)
        g.graph.replay()
        cuda_lib.add_launches(g.capture.launches, g.capture.instances)
        self.replays += 1
        return state, g.logits

    def _first_call(self, sig: Tuple, params, state: ServeState,
                    tokens: torch.Tensor) -> Tuple[ServeState, torch.Tensor]:
        dev = tokens.device
        stream = _capture_stream(dev)
        current = torch.cuda.current_stream(dev)
        static_tokens = torch.empty_like(
            tokens, memory_format=torch.contiguous_format)
        static_tokens.copy_(tokens)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            # this call's step, on the live state: the capture's warm-up
            new_state, logits = self.eager(params, state, tokens)
        current.wait_stream(stream)
        check_in_place(state, new_state)
        graph = torch.cuda.CUDAGraph()
        # repro: ignore[wall-clock] -- capture time, reported beside the step times
        t0 = time.perf_counter()
        with obs_trace.span("decode_graph_capture", cat="graph",
                            track=obs_trace.TRACK_KERNEL,
                            graphs=len(self.graphs)), \
                cuda_lib.capture_scope() as rec:
            with torch.cuda.graph(graph, stream=stream):
                reserved = torch.cuda.memory_reserved(dev)
                cap_state, cap_logits = self.eager(params, state,
                                                   static_tokens)
            pool = torch.cuda.memory_reserved(dev) - reserved
        check_in_place(state, cap_state)
        # repro: ignore[wall-clock] -- capture time, reported beside the step times
        dt = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += dt
        self.graphs[sig] = _Graph(graph, static_tokens, cap_logits, rec,
                                  pool, dt)
        while len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return state, logits


# --------------------------------------------------------------------------
# step cache
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _jitted_steps_cached(model: Model, run: RunConfig,
                         cache_len: Optional[int],
                         frozen_launch: Tuple) -> Tuple[Callable, Callable]:
    launch_config = {f: dict(p) for f, p in frozen_launch}
    return (make_prefill_step(model, run, cache_len=cache_len,
                              launch_config=launch_config),
            CapturedDecode(make_decode_step(model, run,
                                            launch_config=launch_config)))


def jitted_steps(model: Model, run: RunConfig,
                 cache_len: Optional[int] = None,
                 launch_config: Optional[Dict[str, Any]] = None
                 ) -> Tuple[Callable, Callable]:
    """Cached ``(prefill, decode)`` step pair for this serving setup, keyed
    as in the reference on (model, run, cache_len, canonical launch
    config); LRU-bounded.  The decode is a :class:`CapturedDecode`."""
    return _jitted_steps_cached(model, run, cache_len,
                                freeze_launch_config(launch_config))


# --------------------------------------------------------------------------
# generation loop
# --------------------------------------------------------------------------

def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: Any = 0.0) -> torch.Tensor:
    """logits (B, V) -> (B,) int32. temperature 0 = greedy (argmax, first
    index on ties, as ``jnp.argmax``).

    A scalar temperature applies to every row; a (B,) tensor samples each
    row at its own temperature (0 rows decode greedily).  Sampled rows draw
    from ``generator`` — the reference's ``jax.random`` stream cannot be
    reproduced, so only greedy rows match it."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not torch.is_tensor(temperature):
        if temperature <= 0.0:
            return greedy
        return _categorical(logits.float() / temperature, generator)
    temps = temperature.to(device=logits.device, dtype=torch.float32)
    safe = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    sampled = _categorical(logits.float() / safe[:, None], generator)
    return torch.where(temps > 0.0, sampled, greedy)


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def generate(model: Model, run: RunConfig, params, batch: Dict, *,
             num_steps: int, temperature: float = 0.0, seed: int = 0,
             cache_len: Optional[int] = None,
             launch_config: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Prefill + autoregressive decode. Returns generated tokens (B, steps)."""
    prompt = batch["tokens"]
    cache_len = cache_len or (prompt.shape[1] + num_steps)
    prefill, decode = jitted_steps(model, run, cache_len=cache_len,
                                   launch_config=launch_config)
    gen = torch.Generator(device=prompt.device).manual_seed(seed)
    state, logits = prefill(params, batch)
    tok = sample_token(logits, gen, temperature)
    toks = [tok]
    for _ in range(num_steps - 1):
        state, logits = decode(params, state, tok[:, None])
        tok = sample_token(logits, gen, temperature)
        toks.append(tok)
    return torch.stack(toks, dim=1)
