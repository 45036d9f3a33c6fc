"""Rule registry and source-tree model for the port's static checker.

A copy of the reference's ``analysis/base.py`` with three changes: the
default root is the port package (``src/repro_torch/``), so the port's
rules judge the port and never the reference; ``_build/`` (the kernels'
compiled libraries) is never scanned; and a ``Context`` carries the
``device`` the card tier reads (default the CPU).

Rules register themselves into a module-level table via a decorator,
callers select by name, and unknown names fail loudly with the
known-name list. Three tiers share the table:

  - ``ast`` rules parse the source tree (no port imports, no torch) and
    check syntactic invariants of the kernel layer and its seams.
  - ``plan`` rules import the live substrate and check *resolved
    artifacts*: ring schedules, the kernels' run-time plans and stream
    declarations, partition plans on device-free ``MeshSpec``s. The
    ``smem-budget`` rule reads the card's limits when ``device`` is
    ``cuda`` and the H100's constants otherwise.
  - ``model`` rules exhaustively explore bounded *state spaces*
    (``analysis.explore``): scheduler action interleavings, DMA landing
    orders, dtype dataflow. They honour ``Context.budget`` and report
    exploration counters through ``Context.record_stats``.

Every rule takes a ``Context`` and returns ``Finding`` records; an empty
run is the clean state.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Callable

# directories never scanned by AST rules: generated/vcs trees, the compiled
# kernels, and tests (which hold deliberately-seeded violations)
EXCLUDED_DIRS = frozenset(
    {".git", ".github", "__pycache__", "tests", ".pytest_cache", "docs", "_build"}
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation. Fields: ``rule`` — the reporting rule's registered
    name; ``path`` — offending file, relative to the scanned root (plan
    rules, which check resolved objects rather than files, use a module
    path like ``repro_torch.hopper.partition``); ``line`` — 1-based source
    line (0 when no source location applies); ``message`` — what is wrong
    and why it matters; ``kind`` — ``"violation"`` for real findings, or
    ``"budget-exhausted"`` when a model-tier exploration was truncated."""

    rule: str
    path: str
    line: int
    message: str
    kind: str = "violation"

    def format(self) -> str:
        """Render as the one-line ``rule: path:line: message`` CLI form."""
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{self.rule}: {loc}: {self.message}"


@dataclasses.dataclass(frozen=True)
class SourceFile:
    """One parsed file of the scanned tree. Fields: ``path`` — absolute
    path; ``rel`` — posix-style path relative to the scanned root (what
    rule heuristics match on); ``text`` — the source; ``tree`` — the
    parsed ``ast.Module``."""

    path: pathlib.Path
    rel: str
    text: str
    tree: ast.Module


class Context:
    """What a rule run sees: the scanned ``root`` and its parsed files.

    Files are loaded lazily on first access and cached; files that fail to
    parse become ``parse_errors`` findings instead of aborting the sweep.
    Model-tier rules read ``budget`` (an ``explore.Budget`` or None for
    the default); plan rules that build tensors read ``device`` (a
    ``torch.device`` or its name; the CPU by default). ``record_stats``
    keeps each exploration's counters, and any rule's account of what it
    checked, under ``stats`` (``rule -> tag -> dict``); ``cache`` holds
    what several rules of one run share (the suite's cases).
    """

    def __init__(self, root: pathlib.Path, *, budget=None, device="cpu"):
        self.root = pathlib.Path(root)
        self._files: list[SourceFile] | None = None
        self.parse_errors: list[Finding] = []
        self.budget = budget
        self.device = device
        self.stats: dict[str, dict] = {}
        self.cache: dict = {}

    def record_stats(self, rule: str, tag: str, stats) -> None:
        """Record one exploration's counters (an ``explore.Stats``) or a
        rule's account of what it checked (a dict)."""
        self.stats.setdefault(rule, {})[tag] = (
            stats if isinstance(stats, dict) else stats.as_dict())

    @property
    def files(self) -> list[SourceFile]:
        """The tree's parsed ``SourceFile`` records, sorted by ``rel``."""
        if self._files is None:
            self._files = []
            for path in sorted(self.root.rglob("*.py")):
                parts = path.relative_to(self.root).parts
                if any(p in EXCLUDED_DIRS for p in parts[:-1]):
                    continue
                rel = "/".join(parts)
                text = path.read_text()
                try:
                    tree = ast.parse(text, filename=str(path))
                except SyntaxError as e:
                    self.parse_errors.append(Finding(
                        "parse-error", rel, e.lineno or 0,
                        f"not parseable: {e.msg}",
                    ))
                    continue
                self._files.append(SourceFile(path, rel, text, tree))
        return self._files

    def find(self, suffix: str) -> SourceFile | None:
        """The unique file whose ``rel`` ends with ``suffix``, or None."""
        hits = [f for f in self.files if f.rel.endswith(suffix)]
        return hits[0] if len(hits) == 1 else None


@dataclasses.dataclass(frozen=True)
class Rule:
    """A registered check. Fields: ``name`` — kebab-case id used on the
    CLI; ``tier`` — ``"ast"`` (source-tree lint), ``"plan"`` (resolved
    schedule/plan check) or ``"model"`` (exhaustive bounded exploration);
    ``fn`` — ``fn(ctx) -> list[Finding]``; ``doc`` — the one-line summary
    shown by ``--list``."""

    name: str
    tier: str
    fn: Callable
    doc: str


_RULES: dict[str, Rule] = {}
TIER_ORDER = ("ast", "plan", "model")

# each rule of the reference's checker: its counterpart here, or why it has
# none (the inventory test holds this table to both registries)
REFERENCE_COUNTERPARTS = {
    "single-pallas-site": "single-launch-site",
    "block-geometry-registry-only": "block-geometry-registry-only",
    "no-environ-in-kernels": "no-environ-in-kernels",
    "xla-flags-append-only": "no counterpart: the port writes no XLA_FLAGS and has no "
                             "launcher that bootstraps host devices",
    "axis-name-vocabulary": "axis-name-vocabulary",
    "docstring-contract": "docstring-contract",
    "warn-category": "warn-category",
    "overlap-schedule": "overlap-schedule",
    "vmem-budget": "smem-budget",
    "mesh-divisibility": "mesh-divisibility",
    "plan-collective-axes": "plan-collective-axes",
    "accum-dtype-widening": "accum-dtype-widening",
    "paged-gather-coverage": "paged-gather-coverage",
    "scheduler-model": "scheduler-model",
    "overlap-interleavings": "overlap-interleavings",
    "dtype-dataflow": "dtype-dataflow",
}


def register_rule(name: str, *, tier: str) -> Callable:
    """Decorator: ``@register_rule("single-launch-site", tier="ast")``.

    Args: ``name`` — the rule's CLI id (must be unique); ``tier`` — one of
    ``"ast"`` / ``"plan"`` / ``"model"``. The decorated function's first
    docstring line becomes the rule's ``--list`` summary.
    """
    if tier not in TIER_ORDER:
        raise ValueError(f"unknown tier {tier!r}; one of {TIER_ORDER}")

    def deco(fn: Callable) -> Callable:
        if name in _RULES:
            raise ValueError(f"duplicate rule name {name!r}")
        doc = (fn.__doc__ or "").strip().splitlines()[0] if fn.__doc__ else ""
        _RULES[name] = Rule(name, tier, fn, doc)
        return fn

    return deco


def _ensure_rule_modules() -> None:
    # rules live in sibling modules and register on import; importing them
    # here (not in __init__) keeps `from repro_torch.analysis import
    # Finding` cheap while making registered_rules()/run_rules()
    # self-sufficient. None of the three imports torch at module level.
    from repro_torch.analysis import ast_rules, model_rules, plan_rules  # noqa: F401


def registered_rules() -> list[Rule]:
    """Every registered rule, ast tier first, then plan, then model."""
    _ensure_rule_modules()
    return sorted(_RULES.values(),
                  key=lambda r: (TIER_ORDER.index(r.tier), r.name))


def default_root() -> pathlib.Path:
    """The port package this module is installed in (``src/repro_torch``):
    the tree a bare ``python -m repro_torch.analysis`` scans."""
    return pathlib.Path(__file__).resolve().parents[1]


def run_rules(rules=None, root=None, *, budget=None, stats=None,
              device="cpu") -> list[Finding]:
    """Run the selected rules and return every finding.

    Args: ``rules`` — iterable of rule names (None = all registered;
    unknown names raise KeyError listing the known ones); ``root`` — the
    source tree AST rules scan (None = ``default_root()``; plan and model
    rules check the installed port regardless); ``budget`` — an
    ``explore.Budget`` for model-tier explorations (None = each rule's
    default); ``stats`` — optional dict the per-rule counters are merged
    into (``rule -> tag -> counters``); ``device`` — where the plan tier
    builds the suite's operands and whose limits ``smem-budget`` reads
    (``"cpu"``: the reference's shapes and the H100's constants;
    ``"cuda"``: the card's shapes and its own limits). Parse failures in
    the tree are returned as ``parse-error`` findings.
    """
    table = {r.name: r for r in registered_rules()}
    if rules is None:
        selected = list(table.values())
    else:
        unknown = [n for n in rules if n not in table]
        if unknown:
            raise KeyError(
                f"unknown rules {unknown}; known: {sorted(table)}"
            )
        selected = [table[n] for n in rules]
    ctx = Context(pathlib.Path(root) if root else default_root(),
                  budget=budget, device=device)
    findings: list[Finding] = []
    for rule in selected:
        findings.extend(rule.fn(ctx))
    if stats is not None:
        stats.update(ctx.stats)
    return list(ctx.parse_errors) + findings
