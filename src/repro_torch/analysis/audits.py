"""Registry audits: the scattered pinning-test invariants as one pass —
carried over from :mod:`repro.analysis.audits` onto the port's own
registries; a fault gives the reference's message, module paths aside.

Everything here inspects live registries (imports the real modules), so the
audit catches exactly what a runtime user would hit:

- ``audit-family-registration`` — every ``kernels/<family>/`` directory with
  a ``kernel.py`` registers in ``dispatch.py`` and exposes launch
  ``Option``s (the ROADMAP contract: new kernel knobs join the tunable
  surface).
- ``audit-option-space`` — ``launch_space()`` joined with the full
  ``serving_space(fleet=True)`` (paged knobs ride in when
  ``paged_attention`` is registered) builds without duplicate names; every
  Option name is well-formed and its default lies in its domain.
- ``audit-counters`` — every counter the sim / fleet / replay reports emit
  is declared in :mod:`repro_torch.obs.metrics`, and every discovery name
  the causal layer consumes is actually emitted (column drift in either
  direction breaks discovery-matrix transfer).
- ``audit-registry-names`` — ``SHIFT_KINDS`` / workload kinds / measurement
  backend names are well-formed and collision-free.
"""

from __future__ import annotations

import dataclasses
import os
import re
import typing
from typing import Any, Dict, List, Set, Tuple

from repro_torch.analysis.engine import Finding, norm_path

NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
OPTION_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)?$")


def _anchor(module) -> Tuple[str, int]:
    return norm_path(getattr(module, "__file__", "<module>")), 1


def _zero_value(tp: Any) -> Any:
    origin = typing.get_origin(tp)
    if origin is not None:
        return ()
    return {int: 0, float: 0.0, str: "", bool: True}.get(tp, None)


def _zero_report(cls):
    """A dataclass report instance with every field zeroed (defaults kept),
    so ``.counters()`` can be keyed without running a workload."""
    kw: Dict[str, Any] = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            continue
        if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            continue
        kw[f.name] = _zero_value(hints.get(f.name, float))
    return cls(**kw)


# --------------------------------------------------------------------------
# family registration
# --------------------------------------------------------------------------

def audit_family_registration() -> List[Finding]:
    from repro_torch.kernels import dispatch
    findings: List[Finding] = []
    kernels_dir = os.path.dirname(dispatch.__file__)
    registered = set(dispatch.families())
    for entry in sorted(os.listdir(kernels_dir)):
        kernel_py = os.path.join(kernels_dir, entry, "kernel.py")
        if not os.path.isfile(kernel_py):
            continue
        path = norm_path(kernel_py)
        if entry not in registered:
            findings.append(Finding(
                path, 1, "audit-family-registration",
                f"kernels/{entry}/ has a kernel.py but no "
                f"register_family(name={entry!r}) in dispatch.py"))
            continue
        if not dispatch.get_family(entry).launch_options:
            findings.append(Finding(
                path, 1, "audit-family-registration",
                f"family {entry!r} registers no launch Options — its knobs "
                f"never join launch_space()"))
    return findings


# --------------------------------------------------------------------------
# option spaces
# --------------------------------------------------------------------------

def _audit_space(space, label: str, module) -> List[Finding]:
    findings: List[Finding] = []
    path, line = _anchor(module)
    seen: Set[str] = set()
    for o in space.options:
        if o.name in seen:
            findings.append(Finding(
                path, line, "audit-option-space",
                f"{label}: duplicate Option name {o.name!r}"))
        seen.add(o.name)
        if not OPTION_NAME_RE.match(o.name):
            findings.append(Finding(
                path, line, "audit-option-space",
                f"{label}: ill-formed Option name {o.name!r}"))
        if not o.values:
            findings.append(Finding(
                path, line, "audit-option-space",
                f"{label}: Option {o.name!r} has an empty domain"))
        elif o.default not in o.values:
            findings.append(Finding(
                path, line, "audit-option-space",
                f"{label}: Option {o.name!r} default {o.default!r} outside "
                f"its domain {list(o.values)!r}"))
    return findings


def audit_option_spaces() -> List[Finding]:
    from repro_torch.kernels import dispatch
    from repro_torch.workloads import sim
    findings: List[Finding] = []
    findings += _audit_space(dispatch.launch_space(), "launch_space()",
                             dispatch)
    try:
        # full serving surface: scheduler + fleet + pages (paged_attention
        # is registered) + every launch option
        space = sim.serving_space(fleet=True)
    except ValueError as e:
        path, line = _anchor(sim)
        return findings + [Finding(
            path, line, "audit-option-space",
            f"serving_space(fleet=True) failed to build: {e}")]
    findings += _audit_space(space, "serving_space(fleet=True)", sim)
    return findings


# --------------------------------------------------------------------------
# counters vs declarations
# --------------------------------------------------------------------------

def audit_counters() -> List[Finding]:
    from repro_torch.envs import replay_env
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serving import replay as serving_replay
    from repro_torch.workloads import sim
    findings: List[Finding] = []
    declared = set(obs_metrics.REGISTRY.names())

    sim_keys = set(_zero_report(sim.SimReport).counters())
    fleet_keys = set(_zero_report(sim.FleetReport).counters())
    replay_keys = set(_zero_report(serving_replay.ReplayReport).counters())

    surfaces = [
        (sim, "SimReport.counters()", sim_keys,
         set(sim.SIM_COUNTER_NAMES)),
        (sim, "FleetReport.counters()", fleet_keys,
         set(sim.FLEET_COUNTER_NAMES)),
        (serving_replay, "ReplayReport.counters()", replay_keys,
         set(replay_env.REPLAY_COUNTER_NAMES)),
    ]
    for module, label, emitted, discovery in surfaces:
        path, line = _anchor(module)
        undeclared = sorted(emitted - declared)
        if undeclared:
            findings.append(Finding(
                path, line, "audit-counters",
                f"{label} emits {undeclared} without a "
                f"repro_torch.obs.metrics declaration"))
        missing = sorted(discovery - emitted)
        if missing:
            findings.append(Finding(
                path, line, "audit-counters",
                f"{label} never emits declared discovery counter(s) "
                f"{missing} — the discovery matrix would carry dead "
                f"columns"))
    # the replay-fleet tuple composes replay + fleet groups; every name must
    # come from one of the two emitting surfaces
    path, line = _anchor(replay_env)
    extra = sorted(set(replay_env.REPLAY_FLEET_COUNTER_NAMES)
                   - (replay_keys | fleet_keys))
    if extra:
        findings.append(Finding(
            path, line, "audit-counters",
            f"REPLAY_FLEET_COUNTER_NAMES contains {extra} which neither "
            f"replay nor fleet reports emit"))
    return findings


# --------------------------------------------------------------------------
# registry names
# --------------------------------------------------------------------------

def audit_registry_names() -> List[Finding]:
    from repro_torch.envs import measure
    from repro_torch.workloads import traces
    findings: List[Finding] = []

    path, line = _anchor(measure)
    for kind, shifts in measure.SHIFT_KINDS.items():
        if not NAME_RE.match(kind):
            findings.append(Finding(
                path, line, "audit-registry-names",
                f"shift kind {kind!r} is ill-formed (want {NAME_RE.pattern})"))
        if not shifts:
            findings.append(Finding(
                path, line, "audit-registry-names",
                f"shift kind {kind!r} maps to no EnvShift"))
    for name in measure.BACKEND_FACTORIES:
        if not NAME_RE.match(name):
            findings.append(Finding(
                path, line, "audit-registry-names",
                f"backend name {name!r} is ill-formed"))
    names = measure.backend_names()
    if len(set(names)) != len(names):
        findings.append(Finding(
            path, line, "audit-registry-names",
            f"backend_names() has duplicates: {sorted(names)}"))
    for name in names:
        base = name.split(":", 1)
        if not all(NAME_RE.match(part) for part in base):
            findings.append(Finding(
                path, line, "audit-registry-names",
                f"backend name {name!r} is ill-formed"))

    path, line = _anchor(traces)
    kinds = traces.workload_kinds()
    if len(set(kinds)) != len(kinds):
        findings.append(Finding(
            path, line, "audit-registry-names",
            f"workload kinds have duplicates: {sorted(kinds)}"))
    for kind in kinds:
        if not NAME_RE.match(kind):
            findings.append(Finding(
                path, line, "audit-registry-names",
                f"workload kind {kind!r} is ill-formed"))
    return findings


def run_audits() -> List[Finding]:
    findings: List[Finding] = []
    findings += audit_family_registration()
    findings += audit_option_spaces()
    findings += audit_counters()
    findings += audit_registry_names()
    return sorted(set(findings))
