"""What one cell is, read from files by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``configs/<name>.json``, the mix ``mixes/<name>.json``,
each per-layer metric's reader ``metrics/<name>.py``, each kernel's count
of operations and bytes ``roofline/<kernel>.py`` and each family's plain
reference ``reference/<family>.py``, all under the benchmark's folder.  A
later cell, mix or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

#: the benchmark's folder (``bench/``) and the checkout around it
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    config: Dict[str, Any]        # configs/<config>.json
    mix: Dict[str, Any]           # mixes/<traffic>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path

    def module(self, kind: str, name: str) -> ModuleType:
        """``<bench_dir>/<kind>/<name>.py`` loaded as a module (names may
        hold dots, so it is loaded from its path)."""
        return load_module(self.bench_dir / kind / f"{name}.py")


def load_module(path: Path) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((bench_dir / "mixes" / f"{w['traffic']}.json")
                     .read_text())
    return Cell(workload, config, mix,
                [m for m in spec["end_to_end"] if _applies(m, workload)],
                [m for m in spec["per_layer"] if _applies(m, workload)],
                bench_dir)


def port_model_config(config: Dict[str, Any]):
    """The port's ``ModelConfig`` that the configuration file describes:
    the registry's architecture ``config["arch"]`` with every field of
    ``config["port"]`` set as the file gives it.  Raises if the file names
    a field the port does not have, so the file is what runs."""
    from repro_torch.configs.registry import get_model_config

    base = get_model_config(config["arch"])
    fields = dict(config["port"])
    unknown = sorted(set(fields) - set(base.to_dict()))
    if unknown:
        raise KeyError(f"{config['name']}: the port's ModelConfig has no "
                       f"field {unknown}")
    cfg = base.replace(**fields)
    for key, val in fields.items():
        if getattr(cfg, key) != val:
            raise ValueError(f"{config['name']}: {key} runs as "
                             f"{getattr(cfg, key)!r}, the file says {val!r}")
    return cfg
