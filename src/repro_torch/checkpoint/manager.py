"""Atomic, async, keep-k checkpoint manager — the port of
:mod:`repro.checkpoint.manager`, on the reference's on-disk format, so
that either package reads what the other wrote.

The format: a directory ``step_N/`` per checkpoint holding
``manifest.json`` (``step``, ``leaves: {path: {shape, dtype}}``, ``extra``)
and one ``.npy`` per leaf, named by :func:`_leaf_file` from the leaf's
path (:func:`~repro_torch.utils.trees.flatten_with_paths`).  Dtypes carry
numpy's names (``"float32"``, ``"bfloat16"``, ``"int32"``); a bf16 leaf is
stored as its 16-bit pattern (``u2``) and read back through the manifest.
A Python ``int`` leaf (``TrainState.step``) is written as a 0-d ``int32``,
as the reference's step is, and restored as an ``int``.

Properties, as in the reference:

- **Atomicity** — a checkpoint is written into ``step_N.tmp.<pid>``, each
  file fsynced, and renamed to ``step_N`` (the commit point); a crash
  mid-save leaves no readable-but-corrupt latest checkpoint, since only
  committed directories with a manifest are listed.
- **Async save** — ``save()`` copies every leaf to host memory before it
  returns and hands serialization to a background thread; one write is
  outstanding at a time, and its error is re-raised at the next
  ``wait()`` / ``save()``.  The copy is required here: the port's
  optimizer updates parameters and moments in place
  (:mod:`repro_torch.train.optimizer`), so a view of a CPU tensor would be
  serialised half-updated by the next step.
- **Keep-k GC** — old checkpoints are deleted only after a newer one is
  durable.
- **Integrity** — every leaf's shape is checked against the manifest and
  the restore template; a missing leaf raises ``KeyError``, a mismatch
  ``ValueError``.

The reference's ``shardings`` (cross-mesh restore) is dropped: a
checkpoint holds whole leaves, and a sharded run's ranks cut their blocks
from them (:func:`repro_torch.runtime.elastic.remesh_state`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.trees import flatten_with_paths, tree_map_with_path

_STEP_RE = re.compile(r"^step_(\d+)$")
#: numpy's name of each torch dtype a leaf may have (bf16 is stored as u2)
_NUMPY_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


def _snapshot(v: Any) -> Any:
    """A host copy of one leaf that nothing else holds: a tensor copied
    off its device (or its CPU storage), an ``int`` as a 0-d ``int32``."""
    if isinstance(v, torch.Tensor) and v.dtype in _NUMPY_NAMES:
        return v.detach().to("cpu", copy=True)
    if isinstance(v, int) and not isinstance(v, bool):
        return np.asarray(v, np.int32)
    raise TypeError(f"no checkpoint format for a leaf of type "
                    f"{type(v).__name__} ({getattr(v, 'dtype', '')})")


def _dtype_name(v) -> str:
    return _NUMPY_NAMES[v.dtype] if isinstance(v, torch.Tensor) else \
        str(v.dtype)


def _to_numpy(v) -> np.ndarray:
    """The array written for a host leaf: bf16 as its bits (``u2``)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16)
        return v.numpy()
    return v


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save --------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             blocking: bool = False, copied: bool = False) -> None:
        """Snapshot ``tree`` at ``step`` (copied to host before this
        returns) and persist it, in the background unless ``blocking``.
        ``copied``: the tree's tensors are host copies that nothing else
        holds, written as they are (a sharded save's gathered leaves)."""
        self.wait()  # one outstanding save at a time
        host = {k: v if copied and isinstance(v, torch.Tensor)
                else _snapshot(v) for k, v in flatten_with_paths(tree).items()}
        meta = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v)}
                       for k, v in host.items()},
            "extra": extra or {},
        }

        def _write():
            tmp = os.path.join(self.directory,
                               f"step_{step}.tmp.{os.getpid()}")
            final = os.path.join(self.directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            try:
                for k, v in host.items():
                    with open(os.path.join(tmp, _leaf_file(k)), "wb") as f:
                        np.save(f, _to_numpy(v))
                        f.flush()
                        os.fsync(f.fileno())
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(meta, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # the atomic commit point
                self._gc()
            # repro: ignore[broad-except] -- async writer thread: failure is stored and re-raised on the next wait()/save()
            except BaseException as e:  # surfaced on next wait()/save()
                self._error = e
                shutil.rmtree(tmp, ignore_errors=True)

        if blocking:
            _write()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- restore -----------------------------------------------------------

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any,
                device: DeviceLike = None) -> Any:
        """Restore into the structure of ``template``, whose leaves give
        the shapes: tensors (on the ``meta`` device for a template that
        allocates nothing), arrays, or ``int``s (restored as ``int``).
        Tensors land on ``device`` (``cuda`` unless the caller asks for
        another) in the checkpoint's dtypes."""
        self.wait()
        dev = resolve_device(device)
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)

        def load(k: str, spec: Any) -> Any:
            if k not in meta["leaves"]:
                raise KeyError(f"checkpoint {step} missing leaf {k}")
            rec = meta["leaves"][k]
            t = _from_numpy(np.load(os.path.join(d, _leaf_file(k))),
                            rec["dtype"])
            if list(t.shape) != rec["shape"] or \
                    _NUMPY_NAMES.get(t.dtype) != rec["dtype"]:
                raise ValueError(f"leaf {k}: manifest/file mismatch")
            want = () if isinstance(spec, int) else tuple(spec.shape)
            if tuple(t.shape) != want:
                raise ValueError(f"leaf {k}: checkpoint shape "
                                 f"{tuple(t.shape)} != target {want}")
            if isinstance(spec, int):
                return int(t)
            return t.to(dev)

        return tree_map_with_path(load, template)

    def restore_extra(self, step: int) -> Dict:
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)["extra"]

    # -- gc ------------------------------------------------------------------

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)


def _leaf_file(key: str) -> str:
    return key.replace("/", "__") + ".npy"
