"""Build, load and call the port's hand-written CUDA kernels.

The sources live in ``repro_torch/csrc/``.  At first use they are compiled
by ``nvcc`` for ``sm_90a`` — one ``nvcc -c`` per ``.cu`` file, all started
together, then one link — into a single shared library with a plain C
interface, loaded with :mod:`ctypes`.  The library lands in
``<checkout>/build/cuda/<hash of the sources and flags>/``, so an edited
source is rebuilt and an unchanged one is reused.  Nothing here runs when
the module is imported: the CPU hosts that run the tests have no ``nvcc``.

Each kernel wrapper checks its tensors, calls the C entry point on
PyTorch's current stream, raises if the entry point reports a CUDA error
(a refused launch never runs, and a later synchronize would not say so),
and adds one to its count in :data:`LAUNCHES`.

A CUDA graph capture (:func:`capture_scope`) records the kernels without
running them: the counts its wrappers add are taken back out and kept as
the graph's delta, which each replay adds again (:func:`add_launches`), so
:data:`LAUNCHES` counts launches on the card either way.  The scope also
keeps the scratch tensors handed out while it records, so a later growth
of the scratch cannot free memory that a captured graph writes.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.utils.hardware import H100_SMEM_PER_BLOCK

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: ``src/repro_torch/kernels`` -> the checkout root
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "cuda"
LIB_NAME = "librepro_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: launches of each kernel since the last :func:`reset_launches` — each
#: wrapper adds one where it launches its kernel, and nowhere else
LAUNCHES: Dict[str, int] = {
    "rmsnorm": 0,
    "flash_attention": 0,
    "decode_attention": 0,
    "paged_decode_attention": 0,
    "selective_scan": 0,
    "ssd": 0,
}
#: prefill launches since the last :func:`reset_launches` by kernel
#: instance, ``(q/k head dim, v head dim, windowed, causal)`` (windowed:
#: the window is shorter than the keys, so it hides some): added beside
#: ``LAUNCHES["flash_attention"]``, and by a replayed graph as its capture
#: recorded them (the vlm and audio decode steps' cross-attention)
PREFILL_INSTANCES: Dict[Tuple[int, int, bool, bool], int] = {}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the C++ type of each dtype, as kernel instances' names spell it
CTYPE_NAMES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}

#: shared memory one block may use on sm_90 (227 KB, opted into)
SMEM_LIMIT = H100_SMEM_PER_BLOCK

_c_int, _c_float, _ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
_SIGNATURES = {
    # x, residual, w, y, rows, dim, eps, dtype, rows_per_block,
    # warps_per_row, slots, vectorized, stream
    "repro_rmsnorm": [_ptr] * 4 + [_c_int, _c_int, _c_float] + [_c_int] * 5
                     + [_ptr],
    # q, k, v, o, B, Sq, Skv, Hq, Hkv, D, Dv, causal, window, softcap,
    # scale, q_offset, q_block, kv_block, dtype, stream
    "repro_flash_attention": [_ptr] * 4 + [_c_int] * 9 + [_c_float] * 2
                             + [_c_int] * 4 + [_ptr],
    # q, k, v, cache_len, o, B, Skv, Hq, Hkv, D, window, softcap, scale,
    # kv_block, n_split, split_rows, partial, counters, dtype, stream
    "repro_decode_attention": [_ptr] * 5 + [_c_int] * 6 + [_c_float] * 2
                              + [_c_int] * 3 + [_ptr] * 2 + [_c_int, _ptr],
    # q, k_pages, v_pages, page_table, cache_len, o, B, page_size, n_pages,
    # Hq, Hkv, D, softcap, scale, kv_block, n_split, split_rows, partial,
    # counters, dtype, stream
    "repro_paged_decode_attention": [_ptr] * 6 + [_c_int] * 6
                                    + [_c_float] * 2 + [_c_int] * 3
                                    + [_ptr] * 2 + [_c_int, _ptr],
    # x, dt, A, B, C, D, y, B, L, C, N, lanes, channels, chunk, in_dtype,
    # out_dtype, h_out, stream
    "repro_selective_scan": [_ptr] * 7 + [_c_int] * 9 + [_ptr] * 2,
    # x, dt, A, B, C, D, y, B, L, H, P, G, N, chunk, in_dtype, dt_dtype,
    # out_dtype, route, init_state, state_out, states, flags, ticket, epoch,
    # stream
    "repro_ssd": [_ptr] * 7 + [_c_int] * 11 + [_ptr] * 5 + [_c_int, _ptr],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: per device: the split decode's fp32 partials and its int32 ticket
#: counters (zero between launches; the kernel's last block resets them)
_decode_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
#: per device: the tensor-core SSD's chain scratch (fp32 state slots, int32
#: flags, one int32 ticket counter) and the last launch's epoch
_ssd_scratch: Dict[torch.device,
                   Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
_epochs: Dict[torch.device, int] = {}
_sm_counts: Dict[torch.device, int] = {}


@dataclass(frozen=True)
class Tile:
    """A box of one tensor that a block writes: ``(lo, hi)`` per axis of
    the tensor ``tensor`` (the C entry point's name for it)."""
    tensor: str
    box: Tuple[Tuple[int, int], ...]

    def overlaps(self, other: "Tile") -> bool:
        return self.tensor == other.tensor and all(
            lo < o_hi and o_lo < hi
            for (lo, hi), (o_lo, o_hi) in zip(self.box, other.box))


@dataclass(frozen=True)
class LaunchRecord:
    """One C launch of a kernel, derived from shapes, dtype and launch
    config alone (nothing is launched to build it): the launch plan that
    ``kernels/<family>/kernel.py::launch_records`` gives and that the
    static analysis (:mod:`repro_torch.analysis.kernels`) and the chip
    smoke test hold against the card.

    ``kernel`` is the instance's name as ``cu++filt`` and the profiler
    print it, up to its argument list (``repro::rmsnorm_kernel<float, 4,
    true>``).  ``in_order`` lists the grid dimensions whose blocks are
    combined in order (the split decode's last-block combine through its
    ticket counters, the tensor-core SSD's chain): blocks that differ only
    there may write one tile.  ``writes`` maps a block index to the tiles
    it writes, a mirror of the kernel's own indexing."""
    kernel: str
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    dynamic_smem: int
    static_smem: int = 0
    in_order: Tuple[int, ...] = ()
    writes: Optional[Callable[[Tuple[int, int, int]], Tuple[Tile, ...]]] = \
        field(default=None, compare=False)

    @property
    def threads(self) -> int:
        return self.block[0] * self.block[1] * self.block[2]

    @property
    def smem(self) -> int:
        """Static plus dynamic shared bytes of one block."""
        return self.static_smem + self.dynamic_smem


class LaunchWork(NamedTuple):
    """What one launch computes, beside its :class:`LaunchRecord`: the
    work that ``kernels/<family>/kernel.py::launch_work`` counts from
    shapes alone, the same count the chip smoke test's bounds take.

    ``flops`` and ``exps`` (exponentials) run on the tensor cores where
    ``tensor``, else on the CUDA cores; ``hbm`` is the compulsory
    device-memory bytes (each input read once, each output written once).
    ``steps`` gives each block's serial steps in launch order (the
    attention kernels' K/V tiles, the scan's time steps), ``tile`` the
    ``(d, dv, q rows, kv rows)`` of an attention step (None for a time
    step); ``links`` is the depth of an in-order chain between blocks;
    ``copies`` / ``copy_bytes`` the wrapper's widening copies."""
    flops: float
    exps: float
    hbm: float
    tensor: bool = False
    steps: Optional[np.ndarray] = None
    tile: Optional[Tuple[int, int, int, int]] = None
    links: int = 0
    copies: int = 0
    copy_bytes: float = 0.0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PREFILL_INSTANCES.clear()


def add_launches(delta: Dict[str, int],
                 instances: Optional[Dict[Tuple, int]] = None) -> None:
    """Count the launches of a replayed graph: ``delta`` and ``instances``
    are what its capture recorded (:attr:`Capture.launches`,
    :attr:`Capture.instances`)."""
    for name, n in delta.items():
        LAUNCHES[name] += n
    for inst, n in (instances or {}).items():
        PREFILL_INSTANCES[inst] = PREFILL_INSTANCES.get(inst, 0) + n


@dataclass
class Capture:
    """What one graph capture recorded: the launches each replay makes, by
    kernel and by prefill instance, and the scratch tensors its kernels
    write (kept alive here)."""
    launches: Dict[str, int] = field(default_factory=dict)
    instances: Dict[Tuple, int] = field(default_factory=dict)
    scratch: List[torch.Tensor] = field(default_factory=list)


#: the captures recording now (scratch handed out is kept by each)
_recording: List[Capture] = []


@contextlib.contextmanager
def capture_scope() -> Iterator[Capture]:
    """Around a CUDA graph capture: on exit the counts that the wrappers
    added inside are moved from :data:`LAUNCHES` and
    :data:`PREFILL_INSTANCES` into the yielded :class:`Capture` (a capture
    launches nothing), and every scratch tensor handed out inside is kept
    by it."""
    rec = Capture()
    before = dict(LAUNCHES)
    before_inst = dict(PREFILL_INSTANCES)
    with _lock:
        _recording.append(rec)
    try:
        yield rec
    finally:
        with _lock:
            _recording.remove(rec)
        rec.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                        if LAUNCHES[k] != before[k]}
        rec.instances = {k: n - before_inst.get(k, 0)
                         for k, n in PREFILL_INSTANCES.items()
                         if n != before_inst.get(k, 0)}
        LAUNCHES.update(before)
        PREFILL_INSTANCES.clear()
        PREFILL_INSTANCES.update(before_inst)


def _keep(*tensors: torch.Tensor) -> None:
    """Hand ``tensors`` to every capture recording now (call under
    ``_lock``)."""
    for rec in _recording:
        rec.scratch.extend(tensors)


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source and header plus the compiler flags."""
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "are built at first use and need the CUDA toolkit")


def _run_all(cmds: Sequence[Sequence[str]]) -> List[str]:
    """Start every command at once, wait for all, raise on any failure.
    Returns each command's stderr (ptxas's register/spill report)."""
    procs = [subprocess.Popen(list(c), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed ({' '.join(cmd)}):"
                               f"\n{out}\n{err}")
    return [err for _, err in outs]


def build() -> Path:
    """Compile (if needed) and return the path of the kernel library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"tmp{os.getpid()}"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    logs = _run_all([
        [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        for src, obj in zip(sources(), objs)])
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    tmp_lib = out_dir / f"{LIB_NAME}.{tag}"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
               *map(str, objs)]])
    os.replace(tmp_lib, lib)  # atomic: a concurrent builder sees all or none
    for obj in objs:
        obj.unlink()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


def dtype_code(t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"got {t.dtype}")


def require(kernel: str, *tensors: torch.Tensor,
            dtype: Optional[torch.dtype] = None) -> None:
    """Device, dtype and contiguity checks shared by the wrappers: every
    tensor on one CUDA device, contiguous, and (if given) of ``dtype``."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{kernel}: every tensor must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous "
                             f"(shape {tuple(t.shape)})")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{kernel}: expected {dtype}, got {t.dtype}")


def require_aligned(kernel: str, *tensors: torch.Tensor) -> None:
    """The kernels copy rows 16 bytes at a time: every base address must be
    16-byte aligned (a fresh allocation is; a view at an odd offset may
    not be)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: tensor data must be 16-byte aligned "
                             f"(shape {tuple(t.shape)}, address "
                             f"{t.data_ptr():#x})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def one_storage(*tensors: torch.Tensor) -> List[torch.Tensor]:
    """Contiguous copies (or the tensors) in one storage type for a kernel
    that reads them all as one type: theirs if they agree, else fp32 — a
    widening, so no input is rounded."""
    dt = tensors[0].dtype
    if not (all(t.dtype == dt for t in tensors) and dt in DTYPE_CODES):
        dt = torch.float32
    return [t.to(dt).contiguous() for t in tensors]


def as_int32(t: torch.Tensor) -> torch.Tensor:
    """Index tensors go to the kernels as contiguous int32."""
    return t.to(torch.int32).contiguous()


def sm_count(device: torch.device) -> int:
    """The device's number of SMs, read once per device."""
    n = _sm_counts.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = n
    return n


def decode_scratch(device: torch.device, partial_floats: int,
                   counters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split decode's scratch on ``device``, at least the sizes asked
    for: allocated once and grown only when a larger call comes, so a decode
    step allocates nothing.  Kernels on one stream share it in stream
    order; the decode kernels are not launched on two streams at once.  A
    graph that captured a launch keeps the tensors it was given
    (:func:`capture_scope`), so growing them here does not free them."""
    with _lock:
        part, cnt = _decode_scratch.get(device, (None, None))
        if part is None or part.numel() < partial_floats:
            part = torch.empty(max(partial_floats, 1), dtype=torch.float32,
                               device=device)
        if cnt is None or cnt.numel() < counters:
            cnt = torch.zeros(max(counters, 1), dtype=torch.int32,
                              device=device)
        _decode_scratch[device] = (part, cnt)
        _keep(part, cnt)
        return part, cnt


def ssd_scratch(device: torch.device, state_floats: int, flags: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core SSD's chain scratch on ``device``, at least the sizes
    asked for: fp32 state slots, int32 flags (zeroed when allocated; a
    launch writes its epoch into them, so they need no reset) and one
    int32 ticket counter (zero between launches; the block that draws the
    last ticket resets it).  Allocated once and grown only when a larger
    call comes; kernels on one stream share it in stream order."""
    with _lock:
        st, fl, tk = _ssd_scratch.get(device, (None, None, None))
        if st is None or st.numel() < state_floats:
            st = torch.empty(max(state_floats, 1), dtype=torch.float32,
                             device=device)
        if fl is None or fl.numel() < flags:
            fl = torch.zeros(max(flags, 1), dtype=torch.int32, device=device)
        if tk is None:
            tk = torch.zeros(1, dtype=torch.int32, device=device)
        _ssd_scratch[device] = (st, fl, tk)
        _keep(st, fl, tk)
        return st, fl, tk


def next_epoch(device: torch.device) -> int:
    """A flag value no earlier launch on ``device`` used (1, 2, ...; it
    wraps past 2**31 - 1 back to 1, never to 0, the value of a fresh
    flag).  The epoch is host data: a graph capture would freeze it, so a
    capture that reaches here raises."""
    with _lock:
        if _recording:
            raise RuntimeError(
                "the tensor-core SSD takes a host-side epoch per launch, "
                "which a CUDA graph would freeze; it cannot be captured")
        e = _epochs.get(device, 0) % (2 ** 31 - 1) + 1
        _epochs[device] = e
        return e
