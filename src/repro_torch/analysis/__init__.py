"""Static analysis subsystem of the port: contract linter + Hopper kernel
launch checker + registry audits — the counterpart of
:mod:`repro.analysis`.

``python -m repro_torch.analysis --gate src/repro_torch`` is the port's
gate; see :mod:`repro_torch.analysis.engine` for the
finding/suppression/baseline model, :mod:`repro_torch.analysis.contracts`
for the AST lint rules, :mod:`repro_torch.analysis.kernels` for the launch
checks, and :mod:`repro_torch.analysis.audits` for the registry audits.
Importing the package (and the lint layer) imports no torch.
"""

from repro_torch.analysis.engine import (  # noqa: F401
    ERROR, RULES, WARNING, Finding, Report, run_analysis)
