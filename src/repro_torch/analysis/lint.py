"""The lint engine: file iteration, pragmas, baseline, reporting.

A copy of ``repro.analysis.lint`` (pure ``ast``, no torch), so that the
same source text gives the same findings in both engines. Rules live in
``repro_torch.analysis.rules``; this module applies them to a tree of
Python sources and handles the two escape hatches:

* **Inline pragma** — ``# repro-lint: disable=<rule>[,<rule>] (<reason>)``
  on the violating line or the immediately preceding comment-only line.
  The reason is MANDATORY: a pragma without one (or naming an unknown
  rule) does not suppress and raises a ``bad-pragma`` violation of its
  own, so the tree can never accumulate silent allowlisting.
* **Baseline** — ``lint_baseline.json`` holds fingerprints
  (``rule::path::line``) of violations that predate a rule, and a
  ``reasons`` map from each fingerprint to why it is there; an entry
  without a reason is refused when the baseline loads. It ships EMPTY:
  the port's findings were fixed or pragma'd with their reasons.

CLI: ``python -m repro_torch.analysis lint`` (exit 1 on any
non-baselined violation). Pytest: ``tests/test_torch_analysis_lint.py``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.rules import RULES, FileContext

__all__ = [
    "Violation",
    "Suppression",
    "LintReport",
    "lint_source",
    "lint_paths",
    "lint_tree",
    "load_baseline",
    "default_baseline_path",
    "source_root",
]

_PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([\w\-,]+)\s*(\(([^)]*)\))?")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}::{self.path}::{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Suppression:
    rule: str
    path: str
    line: int
    reason: str


@dataclasses.dataclass
class LintReport:
    new: List[Violation]
    baselined: List[Violation]
    suppressed: List[Suppression]
    files_scanned: int

    @property
    def ok(self) -> bool:
        return not self.new

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "new": [dataclasses.asdict(v) for v in self.new],
            "baselined": [dataclasses.asdict(v) for v in self.baselined],
            "suppressed": [dataclasses.asdict(s) for s in self.suppressed],
            "rules": sorted(RULES),
        }


def _parse_pragmas(lines: Sequence[str], path: str):
    """Pragma table {line -> (rules, reason)} plus bad-pragma violations."""
    pragmas: Dict[int, Tuple[set, str]] = {}
    bad: List[Violation] = []
    for i, text in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            if "repro-lint" in text and "disable" in text and (
                    text.lstrip().startswith("#")):
                bad.append(Violation(
                    "bad-pragma", path, i,
                    "unparseable repro-lint pragma (expected "
                    "`# repro-lint: disable=<rule> (<reason>)`)"))
            continue
        names = {n for n in m.group(1).split(",") if n}
        reason = (m.group(3) or "").strip()
        unknown = sorted(n for n in names if n not in RULES and n != "all")
        if unknown:
            bad.append(Violation(
                "bad-pragma", path, i,
                f"pragma names unknown rule(s) {unknown} "
                f"(known: {sorted(RULES)})"))
        if not reason:
            bad.append(Violation(
                "bad-pragma", path, i,
                "pragma has no (reason) — every suppression must say why"))
            continue  # a reasonless pragma never suppresses
        pragmas[i] = (names, reason)
    return pragmas, bad


def lint_source(source: str, path: str
                ) -> Tuple[List[Violation], List[Suppression]]:
    """Lint one file's text. ``path`` is the posix path the rules (and
    fingerprints) see. Returns (violations, suppressions) — violations
    include ``bad-pragma`` findings; pragma-suppressed ones are moved to
    the suppression list."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Violation("bad-pragma", path, e.lineno or 0,
                          f"file does not parse: {e.msg}")], []
    lines = source.splitlines()
    ctx = FileContext(path=path, tree=tree, lines=lines)
    pragmas, violations = _parse_pragmas(lines, path)

    def pragma_for(line: int, rule: str) -> Optional[str]:
        for cand in (line, line - 1):
            if cand in pragmas:
                names, reason = pragmas[cand]
                if cand == line - 1:
                    prev = lines[cand - 1].lstrip()
                    if not prev.startswith("#"):
                        continue  # only comment-only lines reach forward
                if rule in names or "all" in names:
                    return reason
        return None

    suppressed: List[Suppression] = []
    for rule in RULES.values():
        if rule.check is None:
            continue
        for line, message in rule.check(ctx):
            reason = pragma_for(line, rule.name)
            if reason is not None:
                suppressed.append(Suppression(rule.name, path, line, reason))
            else:
                violations.append(Violation(rule.name, path, line, message))
    violations.sort(key=lambda v: (v.path, v.line, v.rule))
    return violations, suppressed


def source_root() -> str:
    """The ``src/`` directory this package was imported from — linting
    anchors paths there so fingerprints are stable across checkouts."""
    here = os.path.dirname(os.path.abspath(__file__))  # .../src/repro_torch/analysis
    return os.path.dirname(os.path.dirname(here))      # .../src


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "lint_baseline.json")


def load_baseline(path: Optional[str] = None) -> set:
    """The baseline's fingerprints. Raises ``ValueError`` when one has no
    reason in the file's ``reasons`` map."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    fingerprints = set(data.get("fingerprints", []))
    reasons = data.get("reasons", {})
    unexplained = sorted(fp for fp in fingerprints
                         if not str(reasons.get(fp, "")).strip())
    if unexplained:
        raise ValueError(f"baseline {path}: entries without a reason "
                         f"{unexplained} — every entry must say why")
    return fingerprints


def iter_python_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__", ".git")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths: Sequence[str], *, rel_to: Optional[str] = None,
               baseline: Optional[set] = None) -> LintReport:
    rel_to = rel_to or source_root()
    baseline = baseline if baseline is not None else load_baseline()
    all_v: List[Violation] = []
    all_s: List[Suppression] = []
    count = 0
    for p in paths:
        files = iter_python_files(p) if os.path.isdir(p) else [p]
        for f in files:
            count += 1
            rel = os.path.relpath(os.path.abspath(f), rel_to)
            rel = rel.replace(os.sep, "/")
            with open(f, encoding="utf-8") as fh:
                v, s = lint_source(fh.read(), rel)
            all_v.extend(v)
            all_s.extend(s)
    new = [v for v in all_v if v.fingerprint not in baseline]
    old = [v for v in all_v if v.fingerprint in baseline]
    return LintReport(new=new, baselined=old, suppressed=all_s,
                      files_scanned=count)


def lint_tree(root: Optional[str] = None, *,
              baseline: Optional[set] = None) -> LintReport:
    """Lint the whole ``src/repro_torch`` package (or ``root``)."""
    src = source_root()
    root = root or os.path.join(src, "repro_torch")
    return lint_paths([root], rel_to=src, baseline=baseline)
