"""CLI for the port's static checker: ``python -m repro_torch.analysis``.

Runs the selected rules and prints findings one per line, or a JSON
report with ``--format json`` (every rule's stats — the explorations'
counters, ``smem-budget``'s limits and picks, the declarations read —
ride along in its ``stats`` block). ``--device cuda`` builds the plan
tier's suite at the card's shapes on the card and checks the plans
against the card's own limits.

Exit status: 0 clean, 1 findings, 2 usage error (unknown rule / bad
budget), 3 exploration budget exhausted with no other findings — an
unchecked state space is an unknown, never a silent pass.

``--list`` and usage errors import no torch: rule bodies import the
substrate lazily.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.base import registered_rules, run_rules


def main(argv=None) -> int:
    """Entry point; ``argv`` defaults to sys.argv. Returns the exit code."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="three-tier static checker of the port: AST lint over "
        "src/repro_torch, plan checks on the resolved substrate, and bounded "
        "model checking of the scheduler and the ring schedules",
    )
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule names (default: all)")
    ap.add_argument("--root", default=None,
                    help="source tree for AST rules (default: the src/repro_torch "
                    "package; plan/model rules always check the installed port)")
    ap.add_argument("--budget", default=None, metavar="STATES[,DEPTH]",
                    help="model-tier exploration ceiling: max distinct states and "
                    "optional max DFS depth per exploration (default: "
                    "explore.Budget(); exhaustion exits 3)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--device", default="cpu",
                    help="cpu (default: the reference's shapes, the H100's limits) or "
                    "cuda (the card's shapes on the card, its own limits)")
    ap.add_argument("--list", action="store_true",
                    help="list registered rules (name, tier, summary) and exit")
    args = ap.parse_args(argv)

    if args.list:
        for rule in registered_rules():
            print(f"{rule.name:32s} [{rule.tier:5s}]  {rule.doc}")
        return 0

    budget = None
    if args.budget is not None:
        from repro_torch.analysis.explore import Budget

        try:
            budget = Budget.parse(args.budget)
        except ValueError as e:
            print(e.args[0], file=sys.stderr)
            return 2

    names = args.rules.split(",") if args.rules else None
    stats: dict = {}
    try:
        findings = run_rules(names, root=args.root, budget=budget, stats=stats,
                             device=args.device)
    except KeyError as e:
        print(e.args[0], file=sys.stderr)
        return 2

    violations = [f for f in findings if f.kind == "violation"]
    exhausted = [f for f in findings if f.kind == "budget-exhausted"]
    explorations = [s for per_rule in stats.values() for s in per_rule.values()
                    if "states" in s]
    if args.format == "json":
        print(json.dumps({
            "rules": names or [r.name for r in registered_rules()],
            "device": args.device,
            "count": len(findings),
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "message": f.message, "kind": f.kind}
                for f in findings
            ],
            "stats": stats,
        }, indent=2, default=str))
    else:
        for f in findings:
            print(f.format())
        if explorations:
            print(f"explored {sum(s['states'] for s in explorations)} distinct states "
                  f"across {len(explorations)} model-tier exploration(s)", file=sys.stderr)
        if findings:
            print(f"{len(findings)} finding(s)"
                  + (f" ({len(exhausted)} budget-exhausted)" if exhausted else ""),
                  file=sys.stderr)
    if violations:
        return 1
    return 3 if exhausted else 0
