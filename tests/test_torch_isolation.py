"""The port stands alone: ``repro_torch`` (and ``chip_smoke.py``) import
neither ``jax`` nor the reference package ``repro`` — not even its pure
modules, whose package ``__init__`` loads jax."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n.startswith('jaxlib') or n == 'repro' "
        "or n.startswith('repro.'))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) == len(_modules()) > 20


def test_package_init_is_import_light():
    code = ("import sys, repro_torch\n"
            "heavy = [n for n in sys.modules if n.startswith('repro_torch.')]\n"
            "sys.exit(1 if heavy or 'torch' in sys.modules else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.lineno, node.module


def test_no_jax_or_reference_import_in_source():
    paths = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [(str(p.relative_to(ROOT)), line, name) for p in paths
           for line, name in _imports(p)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(paths) > 20 and not bad, bad
