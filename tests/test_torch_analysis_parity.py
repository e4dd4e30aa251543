"""``repro_torch.analysis`` against the reference ``repro.analysis``: the
rules both packages share give the same findings on the reference's own
lint fixtures (``tests/test_analysis.py``), the engine's baseline behaves
the same in both, both gates agree on the port's tree, and the audits'
faults give the reference's messages, module paths aside.
"""

import os
import textwrap

import pytest

from repro.analysis import audits as ref_audits
from repro.analysis import contracts as ref_contracts
from repro.analysis import engine as ref_engine
from repro_torch.analysis import audits, contracts, engine

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the rule ids both packages register (what parity is about)
SHARED = sorted(set(ref_engine.RULES) & set(engine.RULES))


def _shared(findings):
    """Findings of the shared rules as dicts, with the one message that
    names the CLI module (the unknown-id hint) spelled the reference's
    way."""
    return [dict(f.to_dict(), message=f.message.replace(
        "python -m repro_torch.analysis", "python -m repro.analysis"))
        for f in findings if f.rule in SHARED]


# the reference's lint fixtures (tests/test_analysis.py), one case each
LINT_FIXTURES = {
    "unseeded-randomness": """\
        import numpy as np
        import random

        def f():
            a = np.random.rand(3)
            rng = np.random.default_rng()
            b = random.random()
            return a, rng, b
    """,
    "seeded-randomness": """\
        import numpy as np

        def f(seed):
            return np.random.default_rng(seed).normal(size=3)
    """,
    "wall-clock": """\
        import time
        from time import perf_counter

        def f():
            return time.time() + perf_counter()
    """,
    "broad-except": """\
        def f():
            try:
                return 1
            except Exception:
                pass
            try:
                return 2
            except:
                pass
    """,
    "span-balance-async": """\
        from repro.obs import trace as obs_trace

        def f(uid):
            obs_trace.active().async_begin("request", uid)

        def g(uid):
            tr = obs_trace.active()
            tr.async_begin("step", uid)
            tr.async_end("step", uid)
    """,
    "span-balance-unentered": """\
        from repro.obs import trace as obs_trace

        def bad():
            s = obs_trace.span("work")
            return 1

        def discarded():
            obs_trace.span("dropped")

        def good():
            s = obs_trace.span("work")
            with s:
                return 1

        def good_inline():
            with obs_trace.span("work"):
                return 1
    """,
    "parse-error": "def broken(:\n",
}

# the reference's suppression-hygiene fixtures
SUPPRESSION_FIXTURES = {
    "silences-with-reason": """\
        import time

        def f():
            # repro: ignore[wall-clock] -- boot banner only
            return time.time()
    """,
    "requires-reason": """\
        import time

        def f():
            return time.time()  # repro: ignore[wall-clock]
    """,
    "unknown-rule": "x = 1  # repro: ignore[no-such-rule] -- whatever\n",
    "unused": "x = 1  # repro: ignore[wall-clock] -- stale excuse\n",
    "string-literal": 'PATTERN = "# repro: ignore[wall-clock] -- nope"\n',
}


def _write(tmp_path, source):
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent(source))
    return str(path)


@pytest.mark.parametrize("case", sorted(LINT_FIXTURES))
def test_shared_rules_match_the_reference_on_its_fixtures(tmp_path, case):
    path = _write(tmp_path, LINT_FIXTURES[case])
    ref = _shared(ref_contracts.lint_file(path))
    port = _shared(contracts.lint_file(path))
    assert port == ref
    if case != "seeded-randomness":
        assert ref, case  # each fixture fires its rule


@pytest.mark.parametrize("case", sorted(SUPPRESSION_FIXTURES))
def test_suppression_hygiene_matches_the_reference(tmp_path, case):
    path = _write(tmp_path, SUPPRESSION_FIXTURES[case])
    reps = [eng._apply_suppressions(lint.lint_file(path), [path],
                                    report_unused=True)
            for eng, lint in ((ref_engine, ref_contracts),
                              (engine, contracts))]
    ref, port = reps
    assert _shared(port.findings) == _shared(ref.findings)
    assert [(f.to_dict(), why) for f, why in port.suppressed] == \
        [(f.to_dict(), why) for f, why in ref.suppressed]


@pytest.mark.parametrize("eng", [ref_engine, engine],
                         ids=["reference", "port"])
def test_baseline_grandfathers_then_goes_stale(tmp_path, eng):
    bad = tmp_path / "legacy.py"
    bad.write_text("import time\nT0 = time.time()\n")
    baseline = tmp_path / "baseline.json"

    rep = eng.run_analysis([str(bad)], kernels=False, audits=False,
                           baseline_path=None)
    assert [f.rule for f in rep.findings] == ["wall-clock"]
    eng.write_baseline(rep.findings, str(baseline))

    rep2 = eng.run_analysis([str(bad)], kernels=False, audits=False,
                            baseline_path=str(baseline))
    assert rep2.findings == [] and len(rep2.grandfathered) == 1
    assert rep2.gate_ok

    bad.write_text("T0 = 0.0\n")
    rep3 = eng.run_analysis([str(bad)], kernels=False, audits=False,
                            baseline_path=str(baseline))
    assert [f.rule for f in rep3.findings] == ["stale-baseline"]
    assert not rep3.gate_ok


def test_both_gates_agree_on_the_port(monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    port = engine.run_analysis(["src/repro_torch"], baseline_path=None)
    assert port.errors == [], [f"{f.path}:{f.line} [{f.rule}] {f.message}"
                               for f in port.errors]
    assert port.warnings == [] and port.configs_checked == 87
    ref = ref_engine.run_analysis(["src/repro_torch"], kernels=False,
                                  audits=False, baseline_path=None)
    assert ref.errors == []

    def keys(rep):
        return {(f.path, f.line, f.rule) for f, _ in rep.suppressed
                if f.rule in SHARED}

    assert keys(port) == keys(ref)
    assert len(keys(port)) == len(port.suppressed) >= 49
    # the port carries no suppression of a port-only id under src/
    assert not {f.rule for f, _ in port.suppressed} & \
        set(engine.PORT_ONLY_RULES)


def test_rule_tables_share_every_non_tpu_id():
    tpu_only = {"pallas-tpu-outside-compat", "pallas-import-location",
                "sharding-version-gate", "kernel-vmem-budget"}
    assert set(ref_engine.RULES) - set(engine.RULES) == tpu_only
    assert set(engine.RULES) - set(ref_engine.RULES) == \
        set(engine.PORT_ONLY_RULES)
    for rule in SHARED:
        assert engine.RULES[rule][0] == ref_engine.RULES[rule][0], rule


def _messages(findings):
    return [(f.rule, f.message) for f in findings]


def test_audit_default_outside_domain_matches_the_reference():
    from repro.core.spaces import ConfigSpace as RefSpace
    from repro.core.spaces import Option as RefOption
    from repro_torch.core.spaces import ConfigSpace, Option
    out = []
    for space_cls, opt_cls, mod in ((RefSpace, RefOption, ref_audits),
                                    (ConfigSpace, Option, audits)):
        space = space_cls([opt_cls("serving.bad", (1, 2), default=1)])
        object.__setattr__(space.options[0], "default", 99)
        out.append(_messages(mod._audit_space(space, "fixture", mod)))
    assert out[0] == out[1] == [(
        "audit-option-space",
        "fixture: Option 'serving.bad' default 99 outside its domain "
        "[1, 2]")]


def test_audit_registry_names_reject_malformed_as_the_reference():
    from repro.envs import measure as ref_measure
    from repro_torch.envs import measure
    out = []
    for meas, mod in ((ref_measure, ref_audits), (measure, audits)):
        meas.SHIFT_KINDS["Bad Kind!"] = ()
        try:
            out.append(_messages(mod.audit_registry_names()))
        finally:
            del meas.SHIFT_KINDS["Bad Kind!"]
        assert mod.audit_registry_names() == []
    assert out[0] == out[1] and len(out[0]) >= 2
