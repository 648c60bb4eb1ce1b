"""``python -m repro_torch.analysis`` — the port's invariant auditor CLI.

Subcommands:

* ``lint``  — AST lint over ``src/repro_torch`` (imports no torch and
  needs no card): exit 1 on violations not covered by a pragma or the
  shipped baseline.
* ``audit`` — the nine dispatch audits (``audits.run_production_audits``)
  on ``--device`` (``cuda`` by default, which raises without a card;
  ``cpu`` runs the plain versions), with ``--nodes`` sparse ranks. Exit 1
  on any failed audit.

Both accept ``--json OUT`` to write a machine-readable report.
"""
from __future__ import annotations

import argparse
import json
import sys


def _cmd_lint(args) -> int:
    # torch-free: the lint runs wherever the sources are
    from repro_torch.analysis.lint import lint_tree, load_baseline

    report = lint_tree(baseline=load_baseline())
    for v in report.new:
        print(v.render())
    for v in report.baselined:
        print(f"[baselined] {v.render()}")
    print(f"repro-lint: files: {report.files_scanned}  "
          f"new: {len(report.new)}  baselined: {len(report.baselined)}  "
          f"suppressed: {len(report.suppressed)}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
        print(f"report written to {args.json}")
    return 1 if report.new else 0


def _cmd_audit(args) -> int:
    from repro_torch.analysis.audits import run_production_audits

    results = run_production_audits(num_nodes=args.nodes, device=args.device)
    for r in results:
        print(f"[{'PASS' if r.ok else 'FAIL'}] {r.name}: {r.detail}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump([r.to_dict() for r in results], f, indent=2)
        print(f"report written to {args.json}")
    return 0 if all(r.ok for r in results) else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="invariant auditor: source lint + dispatch audits")
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("lint", help="AST lint over src/repro_torch")
    pl.add_argument("--json", default=None, metavar="OUT",
                    help="write JSON report to OUT")
    pl.set_defaults(fn=_cmd_lint)

    pa = sub.add_parser("audit", help="the nine dispatch audits")
    pa.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    pa.add_argument("--nodes", type=int, default=8,
                    help="ring size and sparse ranks (default 8)")
    pa.add_argument("--json", default=None, metavar="OUT",
                    help="write JSON report to OUT")
    pa.set_defaults(fn=_cmd_audit)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
