"""CLI for the port's static-analysis subsystem (the reference's flags, and
``--ptxas``).

Usage:
    PYTHONPATH=src python -m repro_torch.analysis [paths...]   # report
    PYTHONPATH=src python -m repro_torch.analysis --gate src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis --format github --gate
    PYTHONPATH=src python -m repro_torch.analysis --write-baseline
    PYTHONPATH=src python -m repro_torch.analysis --list-rules
    PYTHONPATH=src python -m repro_torch.analysis --gate \
        --ptxas build/cuda/<hash>/ptxas.log src/repro_torch

``--ptxas`` reads the ``ptxas.log`` that the kernel build
(``repro_torch.kernels.cuda_lib.build``) writes beside the library, which
adds the register and spill checks.

Exit code: 0 clean (or gating disabled), 1 when ``--gate`` and any
error-severity finding (including stale baseline entries) survives, 2 on a
usage error (as argparse gives).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis import engine


def format_text(rep: engine.Report) -> str:
    lines: List[str] = []
    for f in rep.findings:
        lines.append(f"{f.path}:{f.line}: [{f.rule}] {f.message}")
    lines.append(
        f"{len(rep.findings)} finding(s) ({len(rep.errors)} errors, "
        f"{len(rep.warnings)} warnings), {len(rep.suppressed)} suppressed "
        f"inline, {len(rep.grandfathered)} grandfathered; "
        f"{rep.files_scanned} files scanned, {rep.configs_checked} launch "
        f"configs smem-checked")
    return "\n".join(lines)


def format_github(rep: engine.Report) -> str:
    lines: List[str] = []
    for f in rep.findings:
        kind = "error" if f.severity == engine.ERROR else "warning"
        # GitHub annotation command escaping for the message payload
        msg = f.message.replace("%", "%25").replace("\r", "%0D") \
                       .replace("\n", "%0A")
        lines.append(f"::{kind} file={f.path},line={f.line},"
                     f"title={f.rule}::{msg}")
    lines.append(f"::notice::repro_torch.analysis: {len(rep.errors)} "
                 f"errors, {len(rep.warnings)} warnings over "
                 f"{rep.files_scanned} files; {rep.configs_checked} launch "
                 f"configs smem-checked")
    return "\n".join(lines)


def format_json(rep: engine.Report) -> str:
    return json.dumps({
        "version": engine.BASELINE_VERSION,
        "findings": [f.to_dict() for f in rep.findings],
        "suppressed": [{**f.to_dict(), "reason": reason}
                       for f, reason in rep.suppressed],
        "grandfathered": [f.to_dict() for f in rep.grandfathered],
        "summary": {
            "errors": len(rep.errors),
            "warnings": len(rep.warnings),
            "files_scanned": rep.files_scanned,
            "configs_checked": rep.configs_checked,
            "gate_ok": rep.gate_ok,
        },
    }, indent=1, sort_keys=True)


FORMATTERS = {"text": format_text, "github": format_github,
              "json": format_json}

#: the reference gate's baseline, which the port's CLI never writes
REFERENCE_BASELINE = "analysis_baseline.json"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract linter + Hopper kernel launch checker")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to analyze (default: "
                         "src/repro_torch)")
    ap.add_argument("--format", choices=sorted(FORMATTERS), default="text")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when any error-severity finding survives")
    ap.add_argument("--baseline", default=engine.DEFAULT_BASELINE,
                    help="grandfathered-findings file (missing = empty)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current unsuppressed findings to the "
                         "baseline file and exit 0")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST contract lint layer")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernel launch layer")
    ap.add_argument("--no-audits", action="store_true",
                    help="skip the registry audit layer")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--ptxas", metavar="PATH",
                    help="the kernel build's ptxas.log: adds the register "
                         "and spill checks")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(engine.RULES):
            severity, desc = engine.RULES[rule]
            print(f"{rule:28s} [{severity}] {desc}")
        return 0

    if args.write_baseline:
        if os.path.basename(args.baseline) == REFERENCE_BASELINE:
            ap.error(f"--write-baseline never writes the reference's "
                     f"{REFERENCE_BASELINE}")
        rep = engine.run_analysis(
            args.paths, lint=not args.no_lint, kernels=not args.no_kernels,
            audits=not args.no_audits, baseline_path=None, ptxas=args.ptxas)
        engine.write_baseline(rep.findings, args.baseline)
        print(f"wrote {len(rep.findings)} finding(s) to {args.baseline}")
        return 0

    rep = engine.run_analysis(
        args.paths, lint=not args.no_lint, kernels=not args.no_kernels,
        audits=not args.no_audits, baseline_path=args.baseline,
        ptxas=args.ptxas)
    print(FORMATTERS[args.format](rep))
    if args.gate and not rep.gate_ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
