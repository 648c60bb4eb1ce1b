"""The port's invariant auditor: source lint and dispatch audits.

Ported from ``repro.analysis``:

  * ``repro_torch.analysis.lint`` — AST lint over ``src/repro_torch`` with
    named, individually suppressible rules (``repro_torch.analysis.rules``:
    the reference's rules that have a torch meaning); inline pragmas
    REQUIRE a reason: ``# repro-lint: disable=<rule> (<why>)``. Imports no
    torch.
  * ``repro_torch.analysis.audits`` — the reference's nine audits, read
    off what the executor's dispatches leave (storage identity, build and
    capture counts, bitwise replays, the sparse ranks' logged sends)
    instead of HLO text.

Run ``python -m repro_torch.analysis lint`` / ``... audit [--device
cpu]``, or let pytest collect the same checks via
``tests/test_torch_analysis_*.py``.
"""
from repro_torch.analysis.lint import (LintReport, Violation, lint_paths,
                                       lint_tree, load_baseline)
from repro_torch.analysis.rules import RULES

__all__ = [
    "RULES",
    "LintReport",
    "Violation",
    "lint_paths",
    "lint_tree",
    "load_baseline",
]
