"""Unified kernel dispatch: one registry routing every kernel family to its
hand-written CUDA kernel or to its plain PyTorch version.

Port of :mod:`repro.kernels.dispatch`, with the same API (``resolve``,
``use_launch_config`` including ``exclusive=True``, ``split_launch_config``,
``record_resolutions``, ``profile_dispatches``, ``launch_space``, and the
generic router :func:`dispatch`) and the same ``family.param`` option
names.

Modes
-----
``ref`` | ``cuda``.  **The mode follows the tensor's device**: a CPU tensor
takes the plain version, a CUDA tensor takes the kernel.  On a CUDA device
that is not Hopper (sm_90) :func:`resolve` raises, and a kernel that fails
to build or to launch raises from its wrapper — nothing sends a CUDA tensor
to the plain version behind the caller's back, and no environment variable
can.  The one way to run the plain versions on the GPU is to ask for it in
code with :func:`use_mode`, which reference runs (tests, the chip smoke
comparison) do; the serving path never does.

Launch parameters resolve as in the reference: an active tuned config
installed via :func:`use_launch_config` wins, then explicit call-site
keyword arguments, then the registry defaults.  The option domains are
sized for the simple sm_90 kernels (one thread per query row, KV tiles
staged in shared memory), not for TPU VMEM.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.core.spaces import ConfigSpace, Option
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

REF = "ref"
CUDA = "cuda"
MODES = (REF, CUDA)

#: the compute capability the CUDA kernels are built for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


def default_mode(device: Any = None) -> str:
    """The dispatch mode for tensors on ``device``: the thread's
    :func:`use_mode` override if one is active, else ``ref`` for the CPU
    and ``cuda`` for a Hopper card.  Any other CUDA card raises."""
    forced = getattr(_local, "mode", None)
    if forced is not None:
        return forced
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return REF
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a; device {dev} is "
            f"sm_{cap[0]}{cap[1]}")
    return CUDA


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelFamily:
    """One kernel family: implementations + its tunable launch surface.

    ``kernel``/``ref`` are lazy ``"module:attr"`` references so importing
    the registry never imports kernel modules.  ``variants`` holds secondary
    entry points that share the family's launch surface (decode attention).
    ``consumers`` names (as ``"module:attr"``) what takes launch options
    that shape the serving stack rather than the kernel call — the static
    analysis counts their parameters beside the implementations' when it
    checks that every option lands somewhere (``kernel-option-unused``).
    """

    name: str
    kernel: str
    ref: str
    launch_options: Tuple[Option, ...] = ()
    variants: Tuple[Tuple[str, Tuple[str, str]], ...] = ()  # (name, (kernel, ref))
    consumers: Tuple[str, ...] = ()

    def option(self, name: str) -> Option:
        for o in self.launch_options:
            if o.name == name:
                return o
        raise KeyError(f"{self.name} has no launch option {name!r}")


_REGISTRY: Dict[str, KernelFamily] = {}


def register_family(fam: KernelFamily) -> KernelFamily:
    if fam.name in _REGISTRY:
        raise ValueError(f"kernel family {fam.name!r} already registered")
    _REGISTRY[fam.name] = fam
    return fam


def get_family(name: str) -> KernelFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel family {name!r}; known: {sorted(_REGISTRY)}")


def families() -> List[str]:
    return sorted(_REGISTRY)


@functools.lru_cache(maxsize=None)
def _load(ref: str) -> Callable:
    module, attr = ref.split(":")
    return getattr(importlib.import_module(module), attr)


def _impl_ref(fam: KernelFamily, mode: str, variant: Optional[str]) -> str:
    kernel, ref = fam.kernel, fam.ref
    if variant is not None:
        kernel, ref = dict(fam.variants)[variant]
    return ref if mode == REF else kernel


def kernel_fn(family: str, variant: Optional[str] = None) -> Callable:
    return _load(_impl_ref(get_family(family), CUDA, variant))


def ref_fn(family: str, variant: Optional[str] = None) -> Callable:
    return _load(_impl_ref(get_family(family), REF, variant))


# --------------------------------------------------------------------------
# launch configuration
# --------------------------------------------------------------------------

_local = threading.local()


def _active() -> Dict[str, Dict[str, Any]]:
    return getattr(_local, "launch", {})


def split_launch_config(config: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Normalize flat ``{"family.param": v}`` / nested dicts to nested form.

    Unknown families or parameters raise — a tuned configuration that cannot
    land on a real launch knob is a bug in the space, not noise to ignore.
    """
    nested: Dict[str, Dict[str, Any]] = {}
    for key, val in (config or {}).items():
        if isinstance(val, dict):
            fam_name, params = key, val
        elif "." in key:
            fam_name, pname = key.split(".", 1)
            params = {pname: val}
        else:
            raise KeyError(
                f"launch config key {key!r} is not 'family.param' or nested")
        fam = get_family(fam_name)
        for pname, v in params.items():
            fam.option(pname)  # existence check
            nested.setdefault(fam_name, {})[pname] = v
    return nested


class use_launch_config:
    """Install a tuned launch configuration for dispatches underneath.

    Accepts flat (``{"flash_attention.q_block": 64}``) or nested
    (``{"flash_attention": {"q_block": 64}}``) form; nests are merged over
    any outer active config.  With ``exclusive=True`` the config underneath
    is exactly this one — any outer active config is shadowed, not merged
    (the serve step factories use this so a step is a pure function of its
    ``launch_config``).  Re-entrant, reusable and thread-safe as in the
    reference: the save-stack is per-thread, and the prior configuration is
    restored on exit even when the body raises.  Validation against the
    registry happens eagerly at construction.
    """

    def __init__(self, config: Optional[Dict[str, Any]], *,
                 exclusive: bool = False):
        self._overrides = split_launch_config(config or {})
        self._exclusive = exclusive

    def __enter__(self) -> Dict[str, Dict[str, Any]]:
        prev = _active()
        if self._exclusive:
            merged = {f: dict(p) for f, p in self._overrides.items()}
        else:
            merged = {f: dict(p) for f, p in prev.items()}
            for f, p in self._overrides.items():
                merged.setdefault(f, {}).update(p)
        saved = getattr(_local, "saved_configs", None)
        if saved is None:
            saved = _local.saved_configs = []
        saved.append(prev)
        _local.launch = merged
        return merged

    def __exit__(self, exc_type, exc, tb) -> bool:
        _local.launch = _local.saved_configs.pop()
        return False


@contextlib.contextmanager
def use_mode(mode: str):
    """Run every dispatch underneath (this thread) in ``mode``, whatever the
    tensors' device.  ``use_mode("ref")`` is how a reference run puts CUDA
    tensors through the plain versions on purpose; it is never entered on
    the serving path."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not one of {MODES}")
    prev = getattr(_local, "mode", None)
    _local.mode = mode
    try:
        yield
    finally:
        _local.mode = prev


def launch_params(family: str, **explicit: Any) -> Dict[str, Any]:
    """Resolved launch parameters: active tuned > explicit (non-None) > default."""
    fam = get_family(family)
    out = {o.name: o.default for o in fam.launch_options}
    out.update({k: v for k, v in explicit.items() if v is not None})
    out.update(_active().get(family, {}))
    unknown = set(explicit) - {o.name for o in fam.launch_options}
    if unknown:
        raise KeyError(f"{family} has no launch options {sorted(unknown)}")
    return out


@dataclass(frozen=True)
class Resolution:
    """Outcome of one dispatch decision."""
    family: str
    mode: str
    launch: Dict[str, Any] = field(default_factory=dict)

    @property
    def impl(self) -> Callable:
        return kernel_fn(self.family) if self.mode != REF else ref_fn(self.family)


@contextlib.contextmanager
def record_resolutions():
    """Observe every dispatch decision made underneath (same thread).

    Yields a list that each :func:`resolve` call appends its
    :class:`Resolution` to.  Spies isolate exactly as in the reference:
    each gets its own list, and detachment matches by identity.
    """
    rec: List[Resolution] = []
    _local.recorders = getattr(_local, "recorders", ()) + (rec,)
    try:
        yield rec
    finally:
        active = getattr(_local, "recorders", ())
        for i in range(len(active) - 1, -1, -1):
            if active[i] is rec:
                _local.recorders = active[:i] + active[i + 1:]
                break


def _notify_recorders(res: Resolution) -> None:
    for rec in getattr(_local, "recorders", ()):
        rec.append(res)


def resolve(family: str, mode: Optional[str] = None, *, device: Any = None,
            **explicit: Any) -> Resolution:
    """One dispatch decision for tensors on ``device`` (see
    :func:`default_mode`); an explicit ``mode`` wins."""
    mode = mode or default_mode(device)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not one of {MODES}")
    res = Resolution(family=family, mode=mode,
                     launch=launch_params(family, **explicit))
    _notify_recorders(res)
    _notify_profiles(res)
    return res


# --------------------------------------------------------------------------
# dispatch profiling (obs hooks)
# --------------------------------------------------------------------------

class DispatchProfile:
    """Aggregated dispatch telemetry: per-(family, mode) resolution counts
    and wall time spent inside calls made through the generic router
    :func:`dispatch` (the wall-clock measurement backend's path).

    Built on the same notification path as :func:`record_resolutions`, but
    *cross-thread*, as in the reference: a profile observes every
    resolution process-wide while active."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.resolutions: Dict[Tuple[str, str], int] = {}
        self.wall_s: Dict[Tuple[str, str], float] = {}

    def _saw(self, res: Resolution) -> None:
        key = (res.family, res.mode)
        with self._lock:
            self.resolutions[key] = self.resolutions.get(key, 0) + 1

    def _timed(self, family: str, mode: str, dt: float) -> None:
        key = (family, mode)
        with self._lock:
            self.wall_s[key] = self.wall_s.get(key, 0.0) + dt

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """``{"family [mode]": {"resolutions": n, "wall_s": s}}``."""
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for (fam, mode), n in self.resolutions.items():
                out[f"{fam} [{mode}]"] = {
                    "resolutions": n,
                    "wall_s": round(self.wall_s.get((fam, mode), 0.0), 6)}
            for (fam, mode), s in self.wall_s.items():
                out.setdefault(f"{fam} [{mode}]",
                               {"resolutions": 0})["wall_s"] = round(s, 6)
        return out


_PROFILES: List[DispatchProfile] = []
_PROFILES_LOCK = threading.Lock()


def _notify_profiles(res: Resolution) -> None:
    if _PROFILES:
        with _PROFILES_LOCK:
            active = list(_PROFILES)
        for p in active:
            p._saw(res)


@contextlib.contextmanager
def profile_dispatches():
    """Profile every dispatch made while active (all threads): yields a
    :class:`DispatchProfile` accumulating per-family resolution counts and
    the wall time spent inside calls made through :func:`dispatch`.  When
    the obs tracer is active, each routed call additionally exports a span
    on the kernel track and bumps the ``dispatch_wall_s`` /
    ``dispatch_resolutions_total`` registry instruments."""
    prof = DispatchProfile()
    with _PROFILES_LOCK:
        _PROFILES.append(prof)
    try:
        yield prof
    finally:
        with _PROFILES_LOCK:
            for i in range(len(_PROFILES) - 1, -1, -1):
                if _PROFILES[i] is prof:
                    del _PROFILES[i]
                    break


def dispatch(family: str, *args: Any, mode: Optional[str] = None,
             variant: Optional[str] = None, launch: Optional[Dict] = None,
             **kwargs: Any) -> Any:
    """Generic router: run ``family`` on the implementation resolved for
    the device of the first tensor in ``args`` (an explicit ``mode``
    wins).

    Launch parameters the chosen implementation does not accept (e.g.
    ``row_block`` on the plain RMSNorm, which has no blocking) are dropped
    by signature inspection, so one launch config drives every mode.

    On the card the call returns once the kernel is queued, so the
    profiled wall time is the host's share of a call (resolution, checks,
    allocation, launch), not the kernel's device time, which the
    wall-clock measurement backend times with CUDA events.
    """
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)
    res = resolve(family, mode=mode, device=device, **(launch or {}))
    fn = _load(_impl_ref(get_family(family), res.mode, variant))
    accepted = set(inspect.signature(fn).parameters)
    kw = {k: v for k, v in res.launch.items() if k in accepted}
    kw.update(kwargs)
    if not _PROFILES and not obs_trace.enabled():
        return fn(*args, **kw)
    # repro: ignore[wall-clock] -- dispatch profiling (host time inside a routed call), as the reference's router records it
    t0 = time.perf_counter()
    with obs_trace.span(family, cat="dispatch", track=obs_trace.TRACK_KERNEL,
                        mode=res.mode, variant=variant if variant else ""):
        out = fn(*args, **kw)
    # repro: ignore[wall-clock] -- dispatch profiling (host time inside a routed call), as the reference's router records it
    dt = time.perf_counter() - t0
    if _PROFILES:
        with _PROFILES_LOCK:
            active = list(_PROFILES)
        for p in active:
            p._timed(family, res.mode, dt)
    if obs_trace.enabled():
        obs_metrics.REGISTRY.inc("dispatch_resolutions_total",
                                 family=family, mode=res.mode)
        obs_metrics.REGISTRY.inc("dispatch_wall_s", dt,
                                 family=family, mode=res.mode)
    return out


# --------------------------------------------------------------------------
# the tunable launch surface
# --------------------------------------------------------------------------

def launch_space(names: Optional[Iterable[str]] = None) -> ConfigSpace:
    """Every registered launch parameter as one CAMEO ``ConfigSpace``,
    options prefixed ``family.param``."""
    opts: List[Option] = []
    for fname in (sorted(names) if names is not None else families()):
        fam = get_family(fname)
        for o in fam.launch_options:
            opts.append(Option(f"{fname}.{o.name}", o.values,
                               default=o.default, kind=o.kind))
    return ConfigSpace(opts)


def snap_down(value: int, domain: Tuple[int, ...]) -> int:
    """The largest domain value <= ``value`` (the smallest if none is) —
    how a kernel wrapper takes a block size requested for another machine
    (the reference's TPU-sized ``ParallelConfig.attn_*_block`` defaults),
    as the Pallas kernels clamp theirs to the sequence length."""
    fits = [v for v in domain if v <= value]
    return max(fits) if fits else min(domain)


# --------------------------------------------------------------------------
# built-in families
# --------------------------------------------------------------------------
# Domains are what the sm_90 kernels take:
# - flash_attention.q_block: query rows per CUDA block (bf16 prefill: 16 per
#   warp on the tensor cores; fp32 prefill: one thread per row).  No 128:
#   eight warps of ~150 registers a thread fill an SM alone (the kernel
#   note has why that is slow), so the reference's 512 snaps to 64;
# - flash_attention.kv_block: K/V rows per shared-memory stage (prefill and
#   dense decode; the split decode's ranges are whole numbers of them);
# - rmsnorm.row_block: rows per CUDA block when a row has one warp; the
#   planner (rmsnorm/kernel.py::plan_rmsnorm) gives a row 2, 4 or 8 warps,
#   one row a block, when the row is wide or the rows are few;
# - mamba_scan.chunk: time steps of x, dt, B, C staged in shared memory per
#   pass of the cp.async ring (raised to one unrolled group, lowered while
#   a block would take more than half an SM's shared memory);
#   mamba_scan.c_block: the most channels a CUDA block takes — the planner
#   (mamba_scan/kernel.py::plan_scan) clamps it to 256 threads and takes
#   fewer (down to 8) while the grid has fewer than 64 blocks; a lane holds
#   4 states and lanes per channel follow from N;
# - ssd.chunk: the SSD chunk Q, at most 64: one 16-step slab per warp of
#   the tensor-core kernel's block, and the SIMT kernel's Q x Q score tile
#   fits beside the (N, P) state in shared memory.

register_family(KernelFamily(
    name="flash_attention",
    kernel="repro_torch.kernels.flash_attention.kernel:flash_attention_cuda",
    ref="repro_torch.kernels.flash_attention.ref:attention_blockwise_ref",
    launch_options=(
        Option("q_block", (32, 64), default=64),
        Option("kv_block", (32, 64), default=64),
    ),
    variants=(
        ("decode", ("repro_torch.kernels.flash_attention.kernel:decode_attention_cuda",
                    "repro_torch.kernels.flash_attention.ref:decode_attention_ref")),
    ),
))

# As in the reference, the paged family's options shape the KV pool and the
# batcher's chunked admission, not the kernel call: the kernel reads its
# geometry off the pool tensors it is handed.  The reference suppresses the
# static analysis's unused-option finding inline here; the port names the
# plan that takes them instead, which the analysis checks.
register_family(KernelFamily(
    name="paged_attention",
    kernel="repro_torch.kernels.paged_attention.kernel:paged_decode_attention_cuda",
    ref="repro_torch.kernels.paged_attention.ref:paged_decode_attention_ref",
    launch_options=(
        Option("page_size", (32, 64, 128, 256), default=64),
        Option("pages_per_slot_max", (4, 8, 16, 32), default=8),
        Option("prefill_chunk", (0, 64, 128, 256), default=0),
    ),
    consumers=("repro_torch.serving.paging:PagedPlan",),
))

register_family(KernelFamily(
    name="mamba_scan",
    kernel="repro_torch.kernels.mamba_scan.kernel:selective_scan_cuda",
    ref="repro_torch.kernels.mamba_scan.ref:selective_scan_chunked_ref",
    launch_options=(
        Option("chunk", (16, 32, 64), default=64),
        Option("c_block", (16, 32, 64, 128), default=64),
    ),
))

register_family(KernelFamily(
    name="ssd",
    kernel="repro_torch.kernels.ssd.kernel:ssd_cuda",
    ref="repro_torch.kernels.ssd.ref:ssd_ref",
    launch_options=(
        Option("chunk", (16, 32, 64), default=64),
    ),
))

register_family(KernelFamily(
    name="rmsnorm",
    kernel="repro_torch.kernels.rmsnorm.kernel:rmsnorm_cuda",
    ref="repro_torch.kernels.rmsnorm.ref:rmsnorm_ref",
    launch_options=(
        Option("row_block", (1, 2, 4, 8), default=4),
    ),
))
