"""AST contract linter: the port's standing contracts as machine checks —
carried over from :mod:`repro.analysis.contracts`.

Rules (ids in :data:`repro_torch.analysis.engine.RULES`).  Shared with the
reference, giving its findings on the same file bit for bit:

- ``unseeded-randomness`` — ``np.random.<fn>`` module-level sampler calls,
  argless ``default_rng()``, and any stdlib ``random`` use; in the port
  also torch's global RNG: ``torch.manual_seed`` / ``torch.seed`` /
  ``torch.cuda.manual_seed(_all)`` / ``torch.random.*`` calls, and torch's
  module-level samplers (``rand``, ``randn``, ``randint``, ``randperm``,
  ``normal``, ``bernoulli``, ``multinomial``) without ``generator=``.
  Bit-exact replay parity is the repo's core test invariant; every RNG
  must be an explicitly seeded generator (``gen.manual_seed(seed)`` on a
  ``torch.Generator`` is one).
- ``wall-clock`` — ``time.time`` / ``perf_counter`` / ``monotonic`` /
  ``datetime.now`` reads outside the allow-listed measurement/trace
  modules.  :data:`WALLCLOCK_ALLOWED` is the reference's list, verbatim,
  with its ``repro/...`` suffixes, which no file of the port ends with:
  the port's clock reads carry inline ``# repro: ignore[wall-clock]``
  suppressions, which the reference's gate over ``src/`` needs (it walks
  the port too).  An allow-list of the port's paths would leave those
  suppressions unused under this gate, an error here, while the
  reference's gate still needs them.
- ``broad-except`` — bare ``except`` or catching ``Exception`` /
  ``BaseException``.
- ``span-balance`` — ``async_begin`` without a matching ``async_end`` in
  the same module, and ``.span(...)`` handles that are created but never
  entered (assigned and never used in a ``with``, or discarded as a bare
  expression statement).
- ``parse-error`` — a file that does not parse.

The port's own, one for each of the reference's TPU-only rules:

- ``port-import-boundary`` (for ``pallas-tpu-outside-compat``) — any
  import of ``jax``, ``jaxlib`` or the reference package ``repro``: the
  port stands alone.
- ``kernel-import-location`` (for ``pallas-import-location``) — ``triton``,
  ``ctypes`` or ``torch.utils.cpp_extension`` imported outside
  ``kernels/*/kernel.py`` and ``kernels/cuda_lib.py``; everything else
  reaches the kernels through the dispatch registry.  Importing the
  port's own ``cuda_lib`` (launch counting) is not the binding.
- ``version-gate`` (for ``sharding-version-gate``) — ``getattr`` /
  ``hasattr`` probing on ``torch`` or ``torch.*`` anywhere: the port has
  no compat layer and targets one PyTorch.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.engine import ERROR, Finding, norm_path

# Modules whose business IS reading the clock: the tracer, the measurement
# backends, replay/scheduler wall accounting, dispatch profiling, the
# benchmark/runner harnesses, run logging, and the compile-sweep dry-runner.
WALLCLOCK_ALLOWED = (
    "repro/obs/trace.py",
    "repro/envs/measure.py",
    "repro/serving/replay.py",
    "repro/serving/scheduler.py",
    "repro/kernels/dispatch.py",
    "repro/runtime/driver.py",
    "repro/utils/logging.py",
    "repro/tuner/bench.py",
    "repro/tuner/runner.py",
    "repro/launch/dryrun.py",
)

_KERNEL_FILE_RE = re.compile(
    r"repro_torch/kernels/(?:[^/]+/kernel|cuda_lib)\.py$")

#: packages the port never imports
FOREIGN_PACKAGES = frozenset({"jax", "jaxlib", "repro"})
#: modules that bind the CUDA kernels, legal only in the kernel files
BINDING_MODULES = ("triton", "ctypes", "torch.utils.cpp_extension")

# numpy.random module-level samplers/state (the legacy global RNG surface)
NP_GLOBAL_SAMPLERS = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "ranf", "sample",
    "choice", "shuffle", "permutation", "bytes", "uniform", "normal",
    "standard_normal", "poisson", "exponential", "beta", "binomial", "gamma",
    "geometric", "gumbel", "laplace", "logistic", "lognormal", "multinomial",
    "multivariate_normal", "pareto", "rayleigh", "triangular", "vonmises",
    "wald", "weibull", "zipf", "seed", "get_state", "set_state",
})

# torch's global RNG: module-level samplers (flagged without generator=) and
# the seeding calls
TORCH_SAMPLERS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
})
TORCH_GLOBAL_SEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
})

WALLCLOCK_TIME_FNS = frozenset({
    "time", "time_ns", "perf_counter", "perf_counter_ns",
    "monotonic", "monotonic_ns", "clock_gettime",
})


def _binding_ok(path: str) -> bool:
    return _KERNEL_FILE_RE.search(path) is not None


def _is_binding(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in BINDING_MODULES)


def _wallclock_ok(path: str) -> bool:
    return any(path.endswith(s) for s in WALLCLOCK_ALLOWED)


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain as a string, or None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: List[Finding] = []
        self.torch_names: Dict[str, str] = {}     # name -> torch path bound
        self.numpy_aliases: Set[str] = set()      # names bound to numpy
        self.np_random_aliases: Set[str] = set()  # names bound to numpy.random
        self.time_aliases: Set[str] = set()       # names bound to time module
        self.time_fn_names: Set[str] = set()      # from time import perf_counter
        self.random_aliases: Set[str] = set()     # names bound to stdlib random
        self.random_fn_names: Set[str] = set()    # from random import choice
        self.default_rng_names: Set[str] = set()  # from numpy.random import default_rng
        self.datetime_names: Set[str] = set()     # datetime module/class names

    def flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(self.path, getattr(node, "lineno", 1),
                                     rule, message, ERROR))

    # -- imports ----------------------------------------------------------

    def _boundary(self, node: ast.AST, module: str) -> None:
        if module.split(".")[0] in FOREIGN_PACKAGES:
            self.flag(node, "port-import-boundary",
                      f"import of {module} in the port — it imports neither "
                      f"jax nor the reference package; keep a copy of what "
                      f"it needs")
        elif _is_binding(module) and not _binding_ok(self.path):
            self.flag(node, "kernel-import-location",
                      f"import of {module} outside kernels/*/kernel.py / "
                      f"kernels/cuda_lib.py — dispatch through the kernel "
                      f"registry instead")

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            name, bound = alias.name, alias.asname or alias.name.split(".")[0]
            self._boundary(node, name)
            if name == "torch" or name.startswith("torch."):
                self.torch_names[bound] = name if alias.asname else "torch"
            if name == "numpy" or name.startswith("numpy."):
                self.numpy_aliases.add(bound)
            elif name == "time":
                self.time_aliases.add(bound)
            elif name == "random":
                self.random_aliases.add(bound)
                self.flag(node, "unseeded-randomness",
                          "stdlib random imported — use a seeded numpy "
                          "default_rng(seed)")
            elif name == "datetime":
                self.datetime_names.add(bound)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        names = {a.name: (a.asname or a.name) for a in node.names}
        if node.level == 0:
            # ``from torch.utils import cpp_extension`` binds as the module
            bound_modules = [f"{mod}.{n}" for n in names
                             if _is_binding(f"{mod}.{n}")]
            self._boundary(node, mod if _is_binding(mod) or not bound_modules
                           else bound_modules[0])
            if mod == "torch" or mod.startswith("torch."):
                for name, bound in names.items():
                    self.torch_names[bound] = f"{mod}.{name}"
        if mod in ("numpy.random", "numpy"):
            if mod == "numpy" and "random" in names:
                self.np_random_aliases.add(names["random"])
            if "default_rng" in names:
                self.default_rng_names.add(names["default_rng"])
            for name, bound in names.items():
                if mod == "numpy.random" and name in NP_GLOBAL_SAMPLERS:
                    self.flag(node, "unseeded-randomness",
                              f"numpy.random.{name} (global-RNG sampler) "
                              f"imported — use a seeded default_rng(seed)")
        elif mod == "time":
            for name, bound in names.items():
                if name in WALLCLOCK_TIME_FNS:
                    self.time_fn_names.add(bound)
        elif mod == "random":
            self.flag(node, "unseeded-randomness",
                      "stdlib random imported — use a seeded "
                      "numpy default_rng(seed)")
            self.random_fn_names.update(names.values())
        elif mod == "datetime":
            if "datetime" in names:
                self.datetime_names.add(names["datetime"])
        self.generic_visit(node)

    # -- expressions ------------------------------------------------------

    def _torch_path(self, chain: Optional[str]) -> Optional[str]:
        """``chain`` with its head replaced by the torch path it binds, or
        None when the head is not a torch name."""
        if not chain:
            return None
        head, _, rest = chain.partition(".")
        if head not in self.torch_names:
            return None
        return self.torch_names[head] + ("." + rest if rest else "")

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        chain = _dotted(fn)

        # version-gate probing on torch
        if (isinstance(fn, ast.Name) and fn.id in ("getattr", "hasattr")
                and node.args):
            target = _dotted(node.args[0])
            if self._torch_path(target):
                self.flag(node, "version-gate",
                          f"{fn.id}({target}, ...) probes torch — the port "
                          f"targets one PyTorch; call the API it has")

        # torch's global RNG
        path = self._torch_path(chain)
        if path and (path in TORCH_GLOBAL_SEEDS
                     or path.startswith("torch.random.")):
            self.flag(node, "unseeded-randomness",
                      f"{chain}() uses torch's global RNG — seed a "
                      f"torch.Generator and pass it")
        elif (path and path.startswith("torch.")
              and path[len("torch."):] in TORCH_SAMPLERS
              and not any(k.arg == "generator" for k in node.keywords)):
            self.flag(node, "unseeded-randomness",
                      f"{chain}() without generator= draws from torch's "
                      f"global RNG — pass a seeded torch.Generator")

        # unseeded randomness
        if chain:
            head, _, tail = chain.rpartition(".")
            if tail in NP_GLOBAL_SAMPLERS and head and (
                    head in self.np_random_aliases
                    or any(head == f"{np}.random" for np in self.numpy_aliases)):
                self.flag(node, "unseeded-randomness",
                          f"{chain}() uses the numpy global RNG — use a "
                          f"seeded default_rng(seed)")
            if head and (head in self.random_aliases):
                self.flag(node, "unseeded-randomness",
                          f"stdlib {chain}() — use a seeded numpy "
                          f"default_rng(seed)")
        if isinstance(fn, ast.Name) and fn.id in self.random_fn_names:
            self.flag(node, "unseeded-randomness",
                      f"stdlib random.{fn.id}() — use a seeded numpy "
                      f"default_rng(seed)")
        is_default_rng = (
            (chain and chain.split(".")[-1] == "default_rng")
            or (isinstance(fn, ast.Name) and fn.id in self.default_rng_names))
        if is_default_rng and not node.args and not node.keywords:
            self.flag(node, "unseeded-randomness",
                      "default_rng() without a seed draws OS entropy — pass "
                      "an explicit seed")

        # wall clock
        if not _wallclock_ok(self.path):
            if chain:
                head, _, tail = chain.rpartition(".")
                if head in self.time_aliases and tail in WALLCLOCK_TIME_FNS:
                    self.flag(node, "wall-clock",
                              f"{chain}() outside the measurement/trace "
                              f"allow-list")
                elif (tail in ("now", "utcnow", "today")
                      and head and head.split(".")[-1] in self.datetime_names):
                    self.flag(node, "wall-clock",
                              f"{chain}() outside the measurement/trace "
                              f"allow-list")
            if isinstance(fn, ast.Name) and fn.id in self.time_fn_names:
                self.flag(node, "wall-clock",
                          f"{fn.id}() outside the measurement/trace "
                          f"allow-list")
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self.flag(node, "broad-except",
                      "bare except: — name the exception types")
        else:
            broad = sorted({
                n.id if isinstance(n, ast.Name) else n.attr
                for n in ast.walk(node.type)
                if (isinstance(n, ast.Name)
                    and n.id in ("Exception", "BaseException"))
                or (isinstance(n, ast.Attribute)
                    and n.attr in ("Exception", "BaseException"))})
            if broad:
                self.flag(node, "broad-except",
                          f"except {'/'.join(broad)} — narrow to the "
                          f"exception types this block can actually handle")
        self.generic_visit(node)


# --------------------------------------------------------------------------
# span balance (module-level pass: needs begin/end pairing across functions)
# --------------------------------------------------------------------------

def _span_balance(tree: ast.Module, path: str) -> List[Finding]:
    findings: List[Finding] = []

    begins: List[Tuple[str, int]] = []
    ends: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr in ("async_begin", "async_end"):
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                name = node.args[0].value
                if node.func.attr == "async_begin":
                    begins.append((name, node.lineno))
                else:
                    ends.add(name)
    for name, line in begins:
        if name not in ends:
            findings.append(Finding(
                path, line, "span-balance",
                f'async_begin("{name}") has no matching async_end in this '
                f"module"))

    def _is_span_call(value: ast.expr) -> bool:
        return (isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr == "span")

    scopes: List[ast.AST] = [tree]
    scopes += [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        assigned: List[Tuple[str, int]] = []
        entered: Set[str] = set()
        for node in ast.walk(scope if not isinstance(scope, ast.Module)
                             else tree):
            if isinstance(node, ast.Assign) and _is_span_call(node.value) \
                    and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigned.append((node.targets[0].id, node.lineno))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if isinstance(item.context_expr, ast.Name):
                        entered.add(item.context_expr.id)
            elif isinstance(node, ast.Expr) and _is_span_call(node.value):
                findings.append(Finding(
                    path, node.lineno, "span-balance",
                    "span created and discarded — enter it with `with` or "
                    "keep the handle and close it"))
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("__enter__", "__exit__")
                  and isinstance(node.func.value, ast.Name)):
                entered.add(node.func.value.id)
        if isinstance(scope, ast.Module):
            # module scope: only statements directly at top level
            assigned = [(n, l) for n, l in assigned
                        if any(isinstance(s, ast.Assign) and s.lineno == l
                               for s in tree.body)]
        for name, line in assigned:
            if name not in entered:
                findings.append(Finding(
                    path, line, "span-balance",
                    f"span handle {name!r} assigned but never entered "
                    f"(`with {name}:`)"))
    # deduplicate: nested function scopes are walked twice (module + self)
    return sorted(set(findings))


def lint_file(path: str) -> List[Finding]:
    path = norm_path(path)
    try:
        with open(path) as f:
            source = f.read()
    except OSError as e:
        return [Finding(path, 1, "parse-error", f"unreadable: {e}")]
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "parse-error",
                        f"syntax error: {e.msg}")]
    linter = _Linter(path)
    linter.visit(tree)
    return sorted(set(linter.findings + _span_balance(tree, path)))
