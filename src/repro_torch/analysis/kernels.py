"""Hopper kernel safety checker: static analysis of the port's launch plans —
the counterpart of :mod:`repro.analysis.kernels`, which reads Pallas
``BlockSpec``\\ s and checks them against TPU VMEM.

Registry-driven: :func:`check_registered_families` walks every family in
``repro_torch.kernels.dispatch``.  What the reference reconstructs from a
``pallas_call``'s AST, the port reads off each family's **launch plan**:
its ``kernel.py`` exposes ``launch_shapes(model_configs)``, the shapes the
registry's archs give it, and ``launch_records(shape, dtype, **launch)``,
one :class:`~repro_torch.kernels.cuda_lib.LaunchRecord` per C launch it
makes for those shapes, dtype and launch config — built from shapes alone,
with the same plan functions and shared-memory mirrors that size the real
launch.  A family registered later gets every check with no change here;
one whose module lacks the two functions, or whose plan refuses a shape,
gives the non-gating ``kernel-unanalyzable`` warning.

(a) **write races** (``kernel-write-race``): each record's tile map (the
    mirror of the kernel's indexing) is enumerated over
    :data:`GRID_POINTS_PER_DIM` points of every grid dimension (first,
    second, last).  Two blocks that differ on a *parallel* dimension and
    write overlapping tiles race; blocks that differ only on dimensions the
    kernel combines in order (``LaunchRecord.in_order``: the split decode's
    last-block combine, the tensor-core SSD's chain) are the legal pattern,
    as the reference's ``"arbitrary"`` dimensions are.

(b) **shared memory and threads** (``kernel-smem-budget``, for the
    reference's ``kernel-vmem-budget``): every config of the family's
    registered ``Option`` domains, at every shape of its set, in fp32 and
    bf16.  A block's static plus dynamic shared bytes above the opt-in
    limit of one H100 block (:data:`~repro_torch.utils.hardware.
    H100_SMEM_PER_BLOCK`), or its threads above 1024, fire only where the
    analytic feasibility gate (:class:`repro_torch.envs.measure.
    LaunchGeometry`, ``family_cost(...)[2]``) admits the config, as in the
    reference: ``dispatch.launch_space()`` must never offer a launch the
    card refuses.

(c) **registers and spills**, given the build's ``ptxas.log``
    (``--ptxas``; ``cuda_lib.build()`` writes it): registers x block
    threads of any record above an SM's register file
    (``kernel-register-budget``), and any instance that spills
    (``kernel-spill``, a non-gating warning with the bytes).

(d) **signature contracts** (``kernel-signature`` /
    ``kernel-option-unused``): the kernel and plain entry points (variants
    included) agree on required positional names and return annotations,
    and every registered launch ``Option`` lands on a parameter of some
    implementation or of a declared consumer (``KernelFamily.consumers``).
    The reference's ``interpret=`` requirement has no counterpart: the
    port's mode follows the tensors' device, so no implementation takes a
    mode flag.
"""

from __future__ import annotations

import importlib
import inspect
import itertools
import re
from typing import (Any, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

from repro_torch.analysis.engine import WARNING, Finding, norm_path
from repro_torch.utils.hardware import (H100_SMEM_PER_BLOCK,
                                        MAX_BLOCK_THREADS, REGISTERS_PER_SM)

GRID_POINTS_PER_DIM = 3
#: the dtypes every launch config is checked in
DTYPE_NAMES = ("float32", "bfloat16")


# --------------------------------------------------------------------------
# the ptxas report and kernel instance names
# --------------------------------------------------------------------------

class PtxasUsage(NamedTuple):
    registers: int
    spill_stores: int   # bytes
    spill_loads: int    # bytes
    smem: int           # static shared bytes


def ptxas_usage(text: str) -> Dict[str, PtxasUsage]:
    """``{kernel symbol: PtxasUsage}`` from ``nvcc -Xptxas -v`` output (the
    symbols mangled, as ptxas prints them)."""
    usage: Dict[str, PtxasUsage] = {}
    fn: Optional[str] = None
    spill = (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            usage[fn] = PtxasUsage(int(m.group(1)), *spill,
                                   int(smem.group(1)) if smem else 0)
            fn = None
    return usage


_BUILTIN_TYPES = {
    "v": "void", "b": "bool", "c": "char", "a": "signed char",
    "h": "unsigned char", "s": "short", "t": "unsigned short", "i": "int",
    "j": "unsigned int", "l": "long", "m": "unsigned long",
    "x": "long long", "y": "unsigned long long", "f": "float", "d": "double",
}
_LITERAL_SUFFIX = {"i": "", "j": "u", "l": "l", "m": "ul"}


def instance_name(symbol: str) -> Optional[str]:
    """The name of the kernel instance a mangled symbol denotes, up to its
    argument list, as the demanglers print it
    (``_ZN5repro14rmsnorm_kernelIfLi4ELb1EEEv...`` ->
    ``repro::rmsnorm_kernel<float, 4, true>``); None for a symbol outside
    the small part of the Itanium grammar the port's kernels use (nested
    names, builtin and class types, substitutions of earlier names, and
    integer / bool literals as template arguments)."""
    pos = 0
    subs: List[str] = []  # the substitution candidates, in order

    def peek() -> str:
        return symbol[pos:pos + 1]

    def take(n: int = 1) -> str:
        nonlocal pos
        out = symbol[pos:pos + n]
        if len(out) != n:
            raise ValueError(symbol)
        pos += n
        return out

    def source_name() -> str:
        m = re.match(r"\d+", symbol[pos:])
        if not m:
            raise ValueError(symbol)
        take(len(m.group(0)))
        return take(int(m.group(0)))

    def substitution() -> str:
        take()  # S
        m = re.match(r"([0-9A-Z]*)_", symbol[pos:])
        if not m:
            raise ValueError(symbol)
        take(len(m.group(0)))
        return subs[int(m.group(1), 36) + 1 if m.group(1) else 0]

    def template_args() -> str:
        take()  # I
        args = []
        while peek() != "E":
            args.append(arg())
        take()  # E
        return "<" + ", ".join(args) + ">"

    def arg() -> str:
        c = peek()
        if c == "L":
            take()
            kind = take()
            m = re.match(r"(n?)(\d+)E", symbol[pos:])
            if not m or kind not in _LITERAL_SUFFIX and kind != "b":
                raise ValueError(symbol)
            take(len(m.group(0)))
            if kind == "b":
                return "true" if m.group(2) != "0" else "false"
            return ("-" if m.group(1) else "") + m.group(2) + \
                _LITERAL_SUFFIX[kind]
        if c in _BUILTIN_TYPES:
            take()
            return _BUILTIN_TYPES[c]
        if c == "S":
            return substitution()
        return name()

    def name() -> str:
        if peek() != "N":
            out = source_name()
            subs.append(out)
            if peek() == "I":
                out += template_args()
            return out
        take()  # N
        prefix = ""
        while peek() != "E":
            substituted = peek() == "S"
            if peek() == "I" and prefix:
                prefix += template_args()
            else:
                part = substitution() if substituted else source_name()
                prefix = f"{prefix}::{part}" if prefix else part
            if peek() != "E" and not substituted:  # each prefix, once
                subs.append(prefix)
        take()  # E
        return prefix

    if not symbol.startswith("_Z"):
        return None
    pos = 2
    try:
        return name()
    except (ValueError, IndexError):
        return None


def canonical_name(demangled: str) -> str:
    """A demangled kernel name as :func:`instance_name` spells it: no
    leading ``void``, no argument list, no integer or bool casts
    (``(int)4``, ``(bool)1``), no space between closing brackets."""
    name = demangled.strip()
    if name.startswith("void "):
        name = name[len("void "):]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    name = re.sub(r"\(bool\)1\b", "true", name)
    name = re.sub(r"\(bool\)0\b", "false", name)
    name = re.sub(r"\((?:unsigned )?(?:int|long|short|char)\)(-?\d+)", r"\1",
                  name)
    return name.replace("> >", ">>").strip()


# --------------------------------------------------------------------------
# (a) write races
# --------------------------------------------------------------------------

def grid_points(extent: int) -> List[int]:
    """The first, second and last index of a grid dimension (fewer when it
    is shorter): :data:`GRID_POINTS_PER_DIM` points."""
    return sorted({0, min(1, extent - 1), extent - 1})[:GRID_POINTS_PER_DIM]


def race_findings(record, path: str, line: int) -> List[Finding]:
    """Enumerate ``record``'s tile map over :func:`grid_points` of every
    grid dimension and flag tiles written by two blocks that differ on a
    parallel dimension."""
    who = record.kernel
    if record.writes is None:
        return [Finding(path, line, "kernel-unanalyzable",
                        f"{who}: the launch record has no tile map",
                        WARNING)]
    blocks = list(itertools.product(*(grid_points(e) for e in record.grid)))
    written = [(idx, tuple(record.writes(idx))) for idx in blocks]
    parallel = [d for d in range(3) if d not in record.in_order]
    raced = []
    for (ia, ta), (ib, tb) in itertools.combinations(written, 2):
        if all(ia[d] == ib[d] for d in parallel):
            continue
        hit = next((t for t in ta if any(t.overlaps(u) for u in tb)), None)
        if hit is not None:
            raced.append((ia, ib, hit))
    if not raced:
        return []
    ia, ib, tile = raced[0]
    return [Finding(
        path, line, "kernel-write-race",
        f"{who}: {len(raced)} pair(s) of blocks that differ on a parallel "
        f"grid dimension write overlapping tiles (first: blocks {ia} and "
        f"{ib}, {tile.tensor} {list(tile.box)}) — combine that dimension in "
        f"order or fix the tile map")]


# --------------------------------------------------------------------------
# (b) shared memory and threads
# --------------------------------------------------------------------------

def smem_findings(family: str, configs: Iterable[Tuple[Dict[str, Any],
                                                       Sequence[Any]]],
                  path: str, line: int) -> Tuple[List[Finding], int]:
    """Cross-check each launch config's records — ``(params, [(shape,
    dtype name, record), ...])`` — against the opt-in shared-memory limit
    and the block thread limit AND the analytic feasibility gate (the
    launch geometry on ``KernelWorkload()``, which reads the family's own
    records at that workload's shapes).  Fires
    where a block is over a limit for a config the analytic gate admits
    (or cannot see); returns the findings and the configs checked."""
    from repro_torch.envs.measure import KernelWorkload, LaunchGeometry

    limit, thread_limit = H100_SMEM_PER_BLOCK, MAX_BLOCK_THREADS
    geometry = (LaunchGeometry(KernelWorkload())
                if family in LaunchGeometry.MODELS else None)
    findings: List[Finding] = []
    checked = 0
    for params, records in configs:
        checked += 1
        over = [(shape, dt, r) for shape, dt, r in records
                if r.smem > limit or r.threads > thread_limit]
        if not over:
            continue
        if geometry is not None and (geometry.family_cost(family, params)[2]
                                     > geometry.workload.vmem_limit):
            continue  # the gate rejects it: launch_space() never runs it
        shape, dt, rec = max(over, key=lambda o: (o[2].smem, o[2].threads))
        what = (f"{rec.smem} shared bytes a block ({rec.static_smem} static "
                f"+ {rec.dynamic_smem} dynamic), over the {limit}-byte "
                f"opt-in limit of one H100 block"
                if rec.smem > limit else
                f"{rec.threads} threads a block, over the {thread_limit} "
                f"an sm_90 block holds")
        findings.append(Finding(
            path, line, "kernel-smem-budget",
            f"{family} config {dict(sorted(params.items()))}: {rec.kernel} "
            f"takes {what} at {dt} {shape}, and the analytic feasibility "
            f"gate does not reject it — tighten the Option domains in "
            f"dispatch.py or snap the config in the wrapper"))
    return sorted(set(findings)), checked


# --------------------------------------------------------------------------
# (c) registers and spills
# --------------------------------------------------------------------------

def usage_by_instance(usage: Dict[str, PtxasUsage]
                      ) -> Dict[str, PtxasUsage]:
    return {n: u for s, u in usage.items()
            for n in (instance_name(s),) if n is not None}


def register_findings(records: Iterable[Any],
                      by_instance: Dict[str, PtxasUsage], path: str,
                      line: int) -> List[Finding]:
    """Registers x threads of each record against an SM's register file;
    a record whose instance the report lacks cannot be checked."""
    findings = []
    for rec in records:
        u = by_instance.get(rec.kernel)
        if u is None:
            findings.append(Finding(
                path, line, "kernel-unanalyzable",
                f"{rec.kernel}: no entry in the ptxas report", WARNING))
        elif u.registers * rec.threads > REGISTERS_PER_SM:
            findings.append(Finding(
                path, line, "kernel-register-budget",
                f"{rec.kernel}: {u.registers} registers x {rec.threads} "
                f"threads = {u.registers * rec.threads}, over the "
                f"{REGISTERS_PER_SM} registers of an SM — the launch "
                f"cannot start"))
    return sorted(set(findings))


def spill_findings(usage: Dict[str, PtxasUsage], path: str,
                   line: int) -> List[Finding]:
    return sorted(
        Finding(path, line, "kernel-spill",
                f"{instance_name(sym) or sym}: spills {u.spill_stores} bytes "
                f"stored, {u.spill_loads} bytes loaded", WARNING)
        for sym, u in usage.items() if u.spill_stores or u.spill_loads)


# --------------------------------------------------------------------------
# (d) signature contracts
# --------------------------------------------------------------------------

def _required_positional(fn) -> List[str]:
    sig = inspect.signature(fn)
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty]


def _fn_anchor(fn) -> Tuple[str, int]:
    code = getattr(fn, "__wrapped__", fn).__code__
    return norm_path(code.co_filename), code.co_firstlineno


def signature_findings(family: str) -> List[Finding]:
    from repro_torch.kernels import dispatch
    fam = dispatch.get_family(family)
    findings: List[Finding] = []
    entries = [(family, fam.kernel, fam.ref)]
    entries += [(f"{family}:{vname}", k, r)
                for vname, (k, r) in fam.variants]
    accepted: set = set()
    for consumer in fam.consumers:
        accepted |= set(inspect.signature(dispatch._load(consumer)).parameters)
    for label, kref, rref in entries:
        kfn, rfn = dispatch._load(kref), dispatch._load(rref)
        kpath, kline = _fn_anchor(kfn)
        ksig, rsig = inspect.signature(kfn), inspect.signature(rfn)
        accepted |= set(ksig.parameters) | set(rsig.parameters)
        kreq, rreq = _required_positional(kfn), _required_positional(rfn)
        if kreq != rreq:
            findings.append(Finding(
                kpath, kline, "kernel-signature",
                f"{label}: kernel required positionals {kreq} != ref "
                f"required positionals {rreq} — dispatch passes one "
                f"argument list to both"))
        kret, rret = ksig.return_annotation, rsig.return_annotation
        if (kret is not inspect.Signature.empty
                and rret is not inspect.Signature.empty and kret != rret):
            findings.append(Finding(
                kpath, kline, "kernel-signature",
                f"{label}: return annotation {kret} != ref's {rret}"))
    unused = [o.name for o in fam.launch_options if o.name not in accepted]
    if unused:
        path, line = _registration_anchor(family)
        findings.append(Finding(
            path, line, "kernel-option-unused",
            f"{family}: launch Option(s) {unused} are not parameters of any "
            f"kernel/ref implementation"))
    return findings


def _registration_anchor(family: str) -> Tuple[str, int]:
    from repro_torch.kernels import dispatch
    path = norm_path(dispatch.__file__)
    try:
        with open(path) as f:
            for i, text in enumerate(f, 1):
                if f'name="{family}"' in text:
                    return path, i
    except OSError:
        pass
    return path, 1


# --------------------------------------------------------------------------
# registry-driven entry points
# --------------------------------------------------------------------------

def option_configs(family: str) -> List[Dict[str, Any]]:
    """The full cartesian product of the family's registered Option
    domains — exactly the set ``dispatch.launch_space()`` can emit."""
    from repro_torch.kernels import dispatch
    fam = dispatch.get_family(family)
    names = [o.name for o in fam.launch_options]
    domains = [o.values for o in fam.launch_options]
    return [dict(zip(names, combo))
            for combo in itertools.product(*domains)] if names else [{}]


def launch_plan(family: str):
    """``(module, launch_shapes, launch_records)`` of a family's kernel
    module; the functions are None where it lacks them."""
    from repro_torch.kernels import dispatch
    module = importlib.import_module(
        dispatch.get_family(family).kernel.split(":")[0])
    return (module, getattr(module, "launch_shapes", None),
            getattr(module, "launch_records", None))


def model_configs() -> List[Any]:
    """The registry's archs' configs, in its order: where every shape set
    comes from."""
    from repro_torch.configs import registry
    return [registry.get_model_config(a) for a in registry.list_archs()]


def family_records(family: str
                   ) -> Tuple[str, int, List[Tuple[Dict[str, Any], List]],
                              List[Finding]]:
    """Every launch record of a family: ``(path, line, [(params, [(shape,
    dtype name, record), ...]) per config], findings)``, anchored at its
    ``launch_records``; a missing plan or a refused shape is a
    ``kernel-unanalyzable`` warning."""
    import torch

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    module, shapes_fn, records_fn = launch_plan(family)
    path = norm_path(module.__file__)
    if shapes_fn is None or records_fn is None:
        return path, 1, [], [Finding(
            path, 1, "kernel-unanalyzable",
            f"{family}: {module.__name__} has no launch_shapes / "
            f"launch_records, so its launches cannot be built from shapes",
            WARNING)]
    _, line = _fn_anchor(records_fn)
    findings: List[Finding] = []
    shapes = shapes_fn(model_configs())
    out = []
    for params in option_configs(family):
        recs = []
        for dt, shape in itertools.product(DTYPE_NAMES, shapes):
            try:
                recs += [(shape, dt, r) for r in
                         records_fn(shape, dtypes[dt], **params)]
            except ValueError as e:
                findings.append(Finding(
                    path, line, "kernel-unanalyzable",
                    f"{family}: the plan refuses {dt} {shape} at "
                    f"{dict(sorted(params.items()))}: {e}", WARNING))
        out.append((params, recs))
    return path, line, out, findings


def check_family(family: str, *,
                 usage: Optional[Dict[str, PtxasUsage]] = None
                 ) -> Tuple[List[Finding], int]:
    """Every check for one registered family; ``usage`` is the parsed
    ptxas report, if any."""
    path, line, configs, findings = family_records(family)
    distinct = {}
    for _, recs in configs:
        for shape, dt, rec in recs:
            distinct.setdefault((rec, repr(shape), dt), rec)
    for rec in distinct.values():
        findings.extend(race_findings(rec, path, line))
    sfindings, checked = smem_findings(family, configs, path, line)
    findings.extend(sfindings)
    if usage is not None:
        findings.extend(register_findings(
            set(distinct.values()), usage_by_instance(usage), path, line))
    findings.extend(signature_findings(family))
    return sorted(set(findings)), checked


def check_registered_families(ptxas: Optional[str] = None
                              ) -> Tuple[List[Finding], int]:
    """Every family in the dispatch registry; returns (findings, total
    launch configs checked).  With ``ptxas`` (a ``ptxas.log``) the register
    and spill checks join."""
    from repro_torch.kernels import cuda_lib, dispatch
    usage = None
    findings: List[Finding] = []
    if ptxas is not None:
        with open(ptxas) as f:
            usage = ptxas_usage(f.read())
        build_path, build_line = _fn_anchor(cuda_lib.build)
        findings += spill_findings(usage, build_path, build_line)
    checked = 0
    for family in dispatch.families():
        f, n = check_family(family, usage=usage)
        findings.extend(f)
        checked += n
    return findings, checked
