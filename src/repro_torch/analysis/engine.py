"""Finding/suppression/baseline machinery for ``repro_torch.analysis`` —
carried over from :mod:`repro.analysis.engine`; it behaves the same.

The engine owns everything rule-independent: the :class:`Finding` record,
inline suppression comments, the grandfathering baseline, and the
orchestration that runs the three check layers (AST contract lint, the
Hopper kernels' launch checks, registry audits) over a file set and
reduces their raw findings to the gated set.

Suppression syntax (the comment must sit on the finding's line or the line
directly above, and the justification after ``--`` is mandatory)::

    except BaseException as e:  # repro: ignore[broad-except] -- stored and re-raised on wait()

The syntax is the reference's, so one suppression counts under both gates
(``python -m repro.analysis --gate src/`` walks the port too).  A rule id
that only the port knows (:data:`PORT_ONLY_RULES`) is an unknown id to the
reference, whose gate then reports the comment as malformed: such ids are
never suppressed inline under ``src/``.

Baseline: ``analysis_baseline_torch.json`` grandfathers known findings by
exact (path, line, rule, message) key; it is not checked in, and a missing
file counts as empty (the reference's ``analysis_baseline.json`` is never
written here).  A baseline entry that no longer matches anything is itself
a gate failure (``stale-baseline``) — fixed findings must be removed by
regenerating with ``--write-baseline``, so the baseline can only shrink
deliberately.
"""

from __future__ import annotations

import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ERROR = "error"
WARNING = "warning"

#: rule id -> (default severity, one-line description).  Every Finding.rule
#: and every ``ignore[<rule>]`` target must be registered here.
RULES: Dict[str, Tuple[str, str]] = {
    # contract lint (repro_torch.analysis.contracts)
    "port-import-boundary": (
        ERROR, "jax, jaxlib or the reference package repro imported in the "
               "port"),
    "kernel-import-location": (
        ERROR, "triton / ctypes / torch.utils.cpp_extension imported outside "
               "kernels/*/kernel.py / kernels/cuda_lib.py"),
    "version-gate": (
        ERROR, "getattr/hasattr probing on torch or torch.* (the port "
               "targets one PyTorch)"),
    "unseeded-randomness": (
        ERROR, "np.random module call, argless default_rng(), or stdlib "
               "random use (breaks bit-exact replay parity)"),
    "wall-clock": (
        ERROR, "wall-clock read outside the allow-listed measurement/trace "
               "modules"),
    "broad-except": (
        ERROR, "bare except / except Exception / except BaseException"),
    "span-balance": (
        ERROR, "tracer span opened via non-contextmanager API without a "
               "matching end"),
    "parse-error": (ERROR, "file failed to parse/tokenize"),
    # Hopper kernel launch checks (repro_torch.analysis.kernels)
    "kernel-write-race": (
        ERROR, "two grid points on a parallel dimension map to the same "
               "output block"),
    "kernel-smem-budget": (
        ERROR, "a block's shared memory exceeds the sm_90 opt-in limit, or "
               "its threads the block limit, for a launch config the "
               "analytic feasibility gate admits"),
    "kernel-register-budget": (
        ERROR, "registers x block threads of a launch exceed an SM's "
               "register file (with --ptxas)"),
    "kernel-spill": (
        WARNING, "a kernel instance spills registers to local memory "
                 "(with --ptxas)"),
    "kernel-signature": (
        ERROR, "kernel/ref signature, dtype, or shape contract mismatch"),
    "kernel-option-unused": (
        ERROR, "registered launch Option not accepted by the kernel or ref "
               "implementation"),
    "kernel-unanalyzable": (
        WARNING, "a family's launch plan could not be built from shapes "
                 "alone"),
    # registry audits (repro_torch.analysis.audits)
    "audit-family-registration": (
        ERROR, "kernels/<family>/ directory not registered in dispatch.py "
               "or registered without launch Options"),
    "audit-option-space": (
        ERROR, "launch/serving ConfigSpace malformed (duplicate or "
               "ill-formed Option names, default outside domain)"),
    "audit-counters": (
        ERROR, "sim/fleet/replay counter emitted without a "
               "repro_torch.obs.metrics declaration (or declared but not "
               "emitted)"),
    "audit-registry-names": (
        ERROR, "SHIFT_KINDS / workload / backend registry name ill-formed"),
    # suppression / baseline hygiene (this module)
    "suppression-syntax": (
        ERROR, "malformed suppression comment (missing -- reason or unknown "
               "rule id)"),
    "unused-suppression": (
        ERROR, "suppression comment matches no finding"),
    "stale-baseline": (
        ERROR, "baseline entry no longer matches any finding; regenerate "
               "with --write-baseline"),
}

#: the ids the reference does not know: each replaces one of its TPU-only
#: rules (``pallas-tpu-outside-compat``, ``pallas-import-location``,
#: ``sharding-version-gate``, ``kernel-vmem-budget``) or reads the ptxas
#: report, which the TPU has no counterpart of
PORT_ONLY_RULES = ("port-import-boundary", "kernel-import-location",
                   "version-gate", "kernel-smem-budget",
                   "kernel-register-budget", "kernel-spill")


@dataclass(frozen=True, order=True)
class Finding:
    """One violation at one location."""

    path: str
    line: int
    rule: str
    message: str
    severity: str = ERROR

    @property
    def key(self) -> Tuple[str, int, str, str]:
        return (self.path, self.line, self.rule, self.message)

    def to_dict(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "message": self.message, "severity": self.severity}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "Finding":
        return cls(path=str(d["path"]), line=int(d["line"]),  # type: ignore[arg-type]
                   rule=str(d["rule"]), message=str(d["message"]),
                   severity=str(d.get("severity", ERROR)))


def norm_path(path: str) -> str:
    """Repo-relative forward-slash path (what findings/suppressions key on)."""
    rel = os.path.relpath(path) if os.path.isabs(path) else path
    if rel.startswith(".." + os.sep) or rel == "..":
        rel = path  # outside the tree: keep as given
    return rel.replace(os.sep, "/")


# --------------------------------------------------------------------------
# inline suppressions
# --------------------------------------------------------------------------

_SUPPRESS_RE = re.compile(
    r"repro:\s*ignore\[([^\]]*)\]\s*(?:--\s*(.*\S))?\s*$")


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    reason: str
    used: bool = False


def parse_suppressions(source: str, path: str
                       ) -> Tuple[Dict[int, Suppression], List[Finding]]:
    """Extract ``# repro: ignore[rule] -- reason`` comments via tokenize.

    Only real COMMENT tokens count (a suppression-shaped string literal is
    not a suppression).  Returns ``{line: Suppression}`` plus syntax
    findings for malformed comments.
    """
    out: Dict[int, Suppression] = {}
    findings: List[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return out, findings  # the lint layer reports the parse error
    for tok in tokens:
        if tok.type != tokenize.COMMENT or "repro:" not in tok.string:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        line = tok.start[0]
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = (m.group(2) or "").strip()
        bad = [r for r in rules if r not in RULES]
        if not rules or bad:
            findings.append(Finding(
                path, line, "suppression-syntax",
                f"unknown rule id(s) {bad or ['<empty>']} in suppression; "
                f"known rules: python -m repro_torch.analysis --list-rules"))
            continue
        if not reason:
            findings.append(Finding(
                path, line, "suppression-syntax",
                f"suppression for {list(rules)} is missing its justification "
                f"(`# repro: ignore[rule] -- <reason>`)"))
            continue
        out[line] = Suppression(line=line, rules=rules, reason=reason)
    return out, findings


# --------------------------------------------------------------------------
# baseline
# --------------------------------------------------------------------------

BASELINE_VERSION = 1
DEFAULT_BASELINE = "analysis_baseline_torch.json"


def load_baseline(path: Optional[str]) -> List[Finding]:
    if not path or not os.path.exists(path):
        return []
    with open(path) as f:
        doc = json.load(f)
    return [Finding.from_dict(d) for d in doc.get("findings", ())]


def write_baseline(findings: Sequence[Finding], path: str) -> None:
    doc = {"version": BASELINE_VERSION,
           "findings": [f.to_dict() for f in sorted(findings)]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


# --------------------------------------------------------------------------
# orchestration
# --------------------------------------------------------------------------

@dataclass
class Report:
    """Everything one analysis run produced, pre-sorted for rendering."""

    findings: List[Finding] = field(default_factory=list)   # active (gate)
    suppressed: List[Tuple[Finding, str]] = field(default_factory=list)
    grandfathered: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    configs_checked: int = 0  # kernel launch configs smem-validated

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def gate_ok(self) -> bool:
        return not self.errors


def discover_files(paths: Iterable[str]) -> List[str]:
    """All ``.py`` files under ``paths`` (files taken as-is), normalized."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(norm_path(p))
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__"
                                 and not d.startswith("."))
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(norm_path(os.path.join(dirpath, fn)))
    return sorted(set(out))


def _apply_suppressions(raw: List[Finding], files: Iterable[str],
                        report_unused: bool) -> Report:
    """Split raw findings into active vs inline-suppressed."""
    # parse suppressions for every file that is scanned OR carries a finding
    paths = set(files) | {f.path for f in raw}
    supp: Dict[str, Dict[int, Suppression]] = {}
    syntax: List[Finding] = []
    for path in sorted(paths):
        try:
            with open(path) as fh:
                source = fh.read()
        except OSError:
            continue
        supp[path], bad = parse_suppressions(source, path)
        syntax.extend(bad)

    rep = Report()
    for f in raw:
        smap = supp.get(f.path, {})
        hit = None
        for line in (f.line, f.line - 1):
            s = smap.get(line)
            if s is not None and f.rule in s.rules:
                hit = s
                break
        if hit is not None:
            hit.used = True
            rep.suppressed.append((f, hit.reason))
        else:
            rep.findings.append(f)
    rep.findings.extend(syntax)
    if report_unused:
        for path in sorted(supp):
            for s in supp[path].values():
                if not s.used:
                    rep.findings.append(Finding(
                        path, s.line, "unused-suppression",
                        f"suppression for {list(s.rules)} matches no "
                        f"finding — remove it"))
    return rep


def run_analysis(paths: Sequence[str] = ("src/repro_torch",), *,
                 lint: bool = True, kernels: bool = True, audits: bool = True,
                 baseline_path: Optional[str] = None,
                 ptxas: Optional[str] = None) -> Report:
    """Run the enabled check layers and reduce to a gate-ready report;
    ``ptxas`` is the path of the kernel build's ``ptxas.log``, which adds
    the register and spill checks to the kernel layer."""
    files = discover_files(paths)
    raw: List[Finding] = []
    configs_checked = 0
    if lint:
        from repro_torch.analysis import contracts
        for path in files:
            raw.extend(contracts.lint_file(path))
    if kernels:
        from repro_torch.analysis import kernels as kernel_checks
        kfindings, configs_checked = kernel_checks.check_registered_families(
            ptxas=ptxas)
        raw.extend(kfindings)
    if audits:
        from repro_torch.analysis import audits as audit_checks
        raw.extend(audit_checks.run_audits())

    # unused-suppression detection needs the full rule surface live —
    # a partial run (--no-kernels etc.) would misread layer-specific
    # suppressions as dead
    rep = _apply_suppressions(raw, files, report_unused=(lint and kernels
                                                         and audits))
    rep.files_scanned = len(files)
    rep.configs_checked = configs_checked

    baseline = load_baseline(baseline_path)
    if baseline:
        known = {f.key: False for f in baseline}
        active: List[Finding] = []
        for f in rep.findings:
            if f.key in known:
                known[f.key] = True
                rep.grandfathered.append(f)
            else:
                active.append(f)
        rep.findings = active
        for f in baseline:
            if not known[f.key]:
                rep.findings.append(Finding(
                    norm_path(baseline_path or DEFAULT_BASELINE), 1,
                    "stale-baseline",
                    f"baseline entry {f.path}:{f.line} [{f.rule}] no longer "
                    f"matches any finding; regenerate with --write-baseline"))
    rep.findings.sort()
    rep.suppressed.sort(key=lambda pair: pair[0])
    rep.grandfathered.sort()
    return rep
