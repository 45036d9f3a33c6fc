"""Tier-A rules: AST lint over the port's source tree (no port or torch
imports).

The reference's seven AST rules, each held to the port's layout: the
kernel layer is ``hopper/`` (its registry ``hopper/dispatch.py``, its op
entry points ``hopper/ops.py``, its partition rules
``hopper/partition.py``), the documented surfaces are
``hopper/partition.py`` and ``launch/block_search.py``.

  single-launch-site            hopper/build.py alone opens a library; each
                                library is loaded by its own kernel module
  block-geometry-registry-only  block sizes come from dispatch, nowhere else;
                                every planner asks dispatch.lookup_plan first
  no-environ-in-kernels         kernel modules never read the environment
  axis-name-vocabulary          collective axis literals ∈ partition.AXIS_VOCAB
  docstring-contract            the documented public surfaces stay documented
  warn-category                 every warnings.warn passes an explicit category

The reference's ``xla-flags-append-only`` has no counterpart: the port
writes no ``XLA_FLAGS`` and has no launcher that bootstraps host devices.

Rules match files by path heuristics relative to the scanned root (``rel``
suffix / directory-segment checks), so the same rule runs identically over
the real tree and over the seeded-violation fixture trees in
``tests/torch_analysis_fixtures``.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.base import Context, Finding, SourceFile, register_rule

# fallback vocabulary when the scanned tree carries no hopper/partition.py
# (fixture trees); the real tree's AXIS_VOCAB assignment wins when present
DEFAULT_AXIS_VOCAB = ("pod", "data", "model")

BLOCK_PARAMS = frozenset(
    {"block_k", "bq", "bk", "bm", "bn", "bf", "bx", "bs", "chunk"}
)

# the port's collectives (parallel/collectives.py) that name a mesh axis:
# name -> positional index of the axis argument. They take the per-rank
# parts and the mesh first (``ppermute(parts, mesh, axis, perm)``), so the
# indices are not the reference's jax.lax ones
COLLECTIVES = {
    "ppermute": 2, "ppermute_start": 2, "all_to_all": 2, "ring_scan_carry": 4,
    "ep_expert_ffn": None,
}
AXIS_KEYWORDS = ("axis", "axis_name", "ep_axis")

MIN_DOC_LEN = 30
# rel-path suffixes carrying the documentation contract: the counterparts
# of the reference's kernels/partition.py and launch/autotune.py
DOC_CONTRACT_SUFFIXES = ("hopper/partition.py", "launch/block_search.py")

# the one environment read the kernel layer may make: hopper/build.py
# locating the CUDA toolchain
TOOLCHAIN_ENV = ("build.py", "CUDA_HOME")


def _chain(node: ast.AST) -> str:
    """Dotted-name form of an attribute chain (``ctypes.cdll.X``), or ""."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _in_dir(src: SourceFile, name: str) -> bool:
    return name in src.rel.split("/")[:-1]


def _basename(src: SourceFile) -> str:
    return src.rel.rsplit("/", 1)[-1]


def _module_constant(src: SourceFile | None, name: str):
    """The literal value assigned to top-level ``name`` in ``src`` (an
    ``Assign`` or ``AnnAssign``), or None."""
    if src is None:
        return None
    for node in src.tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == name for t in targets) and node.value:
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
    return None


def _load_calls(src: SourceFile):
    """``(node, library name or None)`` for every call of hopper/build.py's
    ``load``: ``build.load(...)``, or a bare ``load(...)`` imported from
    ``repro_torch.hopper.build``."""
    bare = any(
        isinstance(n, ast.ImportFrom) and (n.module or "").endswith("hopper.build")
        and any(a.name == "load" for a in n.names)
        for n in ast.walk(src.tree)
    )
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _chain(node.func)
        if chain.endswith("build.load") or (bare and chain == "load"):
            arg = node.args[0] if node.args else None
            name = arg.value if isinstance(arg, ast.Constant) and isinstance(arg.value, str) else None
            yield node, name


@register_rule("single-launch-site", tier="ast")
def single_launch_site(ctx: Context) -> list[Finding]:
    """hopper/build.py alone opens a kernel library; each kernel module loads its own.

    The counterpart of the reference's single-pallas-site: the backend
    concerns of a launch (building with nvcc, binding with ctypes, the
    library's lifetime) live in one module, ``hopper/build.py``, the only
    one that may touch ``ctypes.CDLL`` / ``ctypes.cdll``; ``build.load``
    is called only from ``hopper/`` kernel modules, each library by
    exactly one module; and every name of ``build.SOURCES`` is loaded by
    one. A harness that wants the libraries ready calls ``build.build``,
    which compiles without opening them.
    """
    out = []
    loaders: dict[str, list[str]] = {}
    for src in ctx.files:
        is_build = src.rel.endswith("hopper/build.py")
        if not is_build:
            seen = set()
            for node in ast.walk(src.tree):
                line = None
                if isinstance(node, ast.Attribute) and _chain(node).startswith(
                        ("ctypes.CDLL", "ctypes.cdll")):
                    line = node.lineno
                elif isinstance(node, ast.ImportFrom) and node.module == "ctypes" and any(
                        a.name in ("CDLL", "cdll") for a in node.names):
                    line = node.lineno
                if line is not None and line not in seen:
                    seen.add(line)
                    out.append(Finding(
                        "single-launch-site", src.rel, line,
                        "opens a shared library outside hopper/build.py — the port's "
                        "single launch site",
                    ))
        for node, name in _load_calls(src):
            if not _in_dir(src, "hopper") or is_build:
                out.append(Finding(
                    "single-launch-site", src.rel, node.lineno,
                    "build.load outside a hopper/ kernel module; a kernel's library is "
                    "loaded by its own module (build.build compiles without loading)",
                ))
                continue
            if name is None:
                out.append(Finding(
                    "single-launch-site", src.rel, node.lineno,
                    "build.load of a library that is not named by a literal",
                ))
                continue
            if src.rel not in loaders.setdefault(name, []):
                loaders[name].append(src.rel)
    for name, mods in sorted(loaders.items()):
        if len(mods) > 1:
            out.append(Finding(
                "single-launch-site", mods[1], 0,
                f"library {name!r} loaded by {len(mods)} modules {mods}; one kernel "
                f"module owns each library",
            ))
    build = ctx.find("hopper/build.py")
    for name in _module_constant(build, "SOURCES") or ():
        if name not in loaders:
            out.append(Finding(
                "single-launch-site", build.rel, 0,
                f"build.SOURCES names {name!r} but no hopper/ kernel module loads it",
            ))
    return out


def _calls_in(fn: ast.AST, names) -> list[int]:
    """Line numbers of calls in ``fn`` to a function whose name (or last
    attribute) satisfies ``names``."""
    lines = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = _chain(node.func).rsplit(".", 1)[-1]
            if names(name):
                lines.append(node.lineno)
    return sorted(lines)


@register_rule("block-geometry-registry-only", tier="ast")
def block_geometry_registry_only(ctx: Context) -> list[Finding]:
    """Block geometry has one source of truth: dispatch.resolve_blocks and the planners.

    In kernel-layer modules (``hopper/``, minus ``dispatch.py`` and
    ``partition.py``): no block-size keyword gets an integer literal and
    no module keeps private ``block_defaults`` plumbing. Every op of
    ``dispatch._BLOCK_DEFAULTS`` must resolve through
    ``resolve_blocks("<op>"`` in ``hopper/ops.py`` (the single-path
    check). And every module that defines ``candidates(...)`` (a kernel's
    run-time plans) has a planner that asks ``dispatch.lookup_plan``
    before its model, so a tuned plan always reaches the kernel.
    """
    out = []
    for src in ctx.files:
        if not _in_dir(src, "hopper") or _basename(src) in ("dispatch.py", "partition.py"):
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if (kw.arg in BLOCK_PARAMS and isinstance(kw.value, ast.Constant)
                            and isinstance(kw.value.value, int)):
                        out.append(Finding(
                            "block-geometry-registry-only", src.rel, kw.value.lineno,
                            f"block-size literal {kw.arg}={kw.value.value} bypasses "
                            f"dispatch.resolve_blocks",
                        ))
            elif (isinstance(node, (ast.Attribute, ast.Name))
                  and getattr(node, "attr", getattr(node, "id", None)) == "block_defaults"):
                out.append(Finding(
                    "block-geometry-registry-only", src.rel, node.lineno,
                    "private block_defaults plumbing in a kernel module; geometry "
                    "flows through resolve_blocks only",
                ))
        fns = [n for n in src.tree.body if isinstance(n, ast.FunctionDef)]
        if not any(f.name == "candidates" for f in fns):
            continue
        planners = [f for f in fns if _calls_in(f, lambda n: n == "lookup_plan")]
        if not planners:
            out.append(Finding(
                "block-geometry-registry-only", src.rel, 0,
                "defines candidates(...) but no planner asks dispatch.lookup_plan: a "
                "tuned plan would never reach the kernel",
            ))
        for f in planners:
            model = _calls_in(f, lambda n: n == "model_pick" or n.startswith("_model"))
            if model and model[0] < _calls_in(f, lambda n: n == "lookup_plan")[0]:
                out.append(Finding(
                    "block-geometry-registry-only", src.rel, f.lineno,
                    f"{f.name}: asks its model before dispatch.lookup_plan, so an "
                    f"override can be masked",
                ))
    table = _module_constant(ctx.find("hopper/dispatch.py"), "_BLOCK_DEFAULTS") or {}
    ops_src = ctx.find("hopper/ops.py")
    if ops_src is not None:
        for op in table:
            if f'resolve_blocks("{op}"' not in ops_src.text:
                out.append(Finding(
                    "block-geometry-registry-only", ops_src.rel, 0,
                    f"op {op!r} has a block table but ops.py never calls "
                    f'resolve_blocks("{op}", ...) — split-brain geometry',
                ))
    return out


def _environ_reads(src: SourceFile):
    """``(line, spelling, key or None)`` of every ``os.environ`` /
    ``os.getenv`` use in ``src``; ``key`` is the variable's literal name
    where the read is ``os.environ.get("K", ...)``, ``os.environ["K"]``
    or ``os.getenv("K", ...)``."""
    parent = {c: n for n in ast.walk(src.tree) for c in ast.iter_child_nodes(n)}

    def lit(node):
        return node.value if isinstance(node, ast.Constant) and isinstance(node.value, str) else None

    for node in ast.walk(src.tree):
        if isinstance(node, ast.Attribute) and _chain(node) == "os.environ":
            up, key = parent.get(node), None
            if isinstance(up, ast.Subscript):
                key = lit(up.slice)
            elif (isinstance(up, ast.Attribute) and up.attr == "get"
                  and isinstance(parent.get(up), ast.Call) and parent[up].args):
                key = lit(parent[up].args[0])
            yield node.lineno, "os.environ", key
        elif isinstance(node, ast.Call) and _chain(node.func) == "os.getenv":
            yield node.lineno, "os.getenv", lit(node.args[0]) if node.args else None


@register_rule("no-environ-in-kernels", tier="ast")
def no_environ_in_kernels(ctx: Context) -> list[Finding]:
    """Kernel modules never read the process environment (one named exemption).

    Any ``os.environ`` / ``os.getenv`` in ``hopper/`` (minus
    ``dispatch.py``, the counterpart of the reference's registry) is
    configuration smuggled past the dispatch layer. The one exemption:
    ``hopper/build.py`` reads ``CUDA_HOME`` to find ``nvcc`` when it is not
    on the PATH. That read locates the toolchain and configures no kernel;
    any other read in ``build.py`` is still a finding.
    """
    out = []
    base_ok, key_ok = TOOLCHAIN_ENV
    for src in ctx.files:
        if not _in_dir(src, "hopper") or _basename(src) == "dispatch.py":
            continue
        for line, spelling, key in _environ_reads(src):
            if _basename(src) == base_ok and key == key_ok:
                continue
            out.append(Finding(
                "no-environ-in-kernels", src.rel, line,
                f"{spelling} in a kernel module; only hopper/build.py's {key_ok} read "
                f"(locating nvcc) is allowed",
            ))
    return out


def _axis_vocab(ctx: Context) -> tuple:
    """The tree's ``AXIS_VOCAB`` (hopper/partition.py), else the fallback
    ``DEFAULT_AXIS_VOCAB``."""
    vocab = _module_constant(ctx.find("hopper/partition.py"), "AXIS_VOCAB")
    return tuple(vocab) if vocab else DEFAULT_AXIS_VOCAB


@register_rule("axis-name-vocabulary", tier="ast")
def axis_name_vocabulary(ctx: Context) -> list[Finding]:
    """Collective axis-name literals come from partition's vocabulary.

    Every string literal passed as the axis of the port's collectives
    (``ppermute``, ``ppermute_start``, ``all_to_all``,
    ``ring_scan_carry``, ``ep_expert_ffn(ep_axis=)``: the axis follows the
    parts and the mesh, ``COLLECTIVES`` holds its index) must be an axis
    name the partition layer produces (``hopper/partition.py``
    ``AXIS_VOCAB``). A typo'd axis fails only on a mesh that has the
    other names; this catches it statically.
    """
    vocab = _axis_vocab(ctx)
    out = []
    for src in ctx.files:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _chain(node.func).rsplit(".", 1)[-1]
            if name not in COLLECTIVES:
                continue
            idx = COLLECTIVES[name]
            axis_arg = None
            if idx is not None and len(node.args) > idx:
                axis_arg = node.args[idx]
            else:
                for kw in node.keywords:
                    if kw.arg in AXIS_KEYWORDS:
                        axis_arg = kw.value
            literals = []
            if isinstance(axis_arg, ast.Constant) and isinstance(axis_arg.value, str):
                literals = [axis_arg]
            elif isinstance(axis_arg, ast.Tuple):
                literals = [e for e in axis_arg.elts
                            if isinstance(e, ast.Constant) and isinstance(e.value, str)]
            for lit in literals:
                if lit.value not in vocab:
                    out.append(Finding(
                        "axis-name-vocabulary", src.rel, lit.lineno,
                        f"{name} over axis {lit.value!r}: not in the partition "
                        f"vocabulary {vocab}",
                    ))
    return out


def _mentions(doc: str, name: str) -> bool:
    return re.search(rf"\b{re.escape(name)}\b", doc) is not None


def _fn_params(node: ast.FunctionDef) -> list[str]:
    a = node.args
    names = [p.arg for p in (*a.posonlyargs, *a.args)]
    if a.vararg:
        names.append(a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append(a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


def _is_dataclass(node: ast.ClassDef) -> bool:
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _chain(target).rsplit(".", 1)[-1] == "dataclass":
            return True
    return False


@register_rule("docstring-contract", tier="ast")
def docstring_contract(ctx: Context) -> list[Finding]:
    """The documented public surfaces keep their documentation contract.

    For the port's user-facing partition and tuning modules
    (``hopper/partition.py``, ``launch/block_search.py``): a real module
    docstring, a ≥30-char docstring on every public top-level function and
    class, every parameter mentioned by name, and every dataclass field
    described — the reference's contract, over the AST.
    """
    out = []

    def bad(src, line, msg):
        out.append(Finding("docstring-contract", src.rel, line, msg))

    for src in ctx.files:
        if not src.rel.endswith(DOC_CONTRACT_SUFFIXES):
            continue
        mod_doc = ast.get_docstring(src.tree) or ""
        if len(mod_doc.strip()) < MIN_DOC_LEN:
            bad(src, 1, "missing or trivial module docstring")
        for node in src.tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                    or node.name.startswith("_"):
                continue
            doc = ast.get_docstring(node) or ""
            if len(doc) < MIN_DOC_LEN:
                bad(src, node.lineno, f"{node.name}: missing or trivial docstring")
                continue
            if isinstance(node, ast.ClassDef):
                if _is_dataclass(node):
                    for stmt in node.body:
                        if isinstance(stmt, ast.AnnAssign) and isinstance(
                                stmt.target, ast.Name) and not _mentions(doc, stmt.target.id):
                            bad(src, stmt.lineno,
                                f"{node.name}: dataclass field {stmt.target.id!r} undocumented")
            else:
                for param in _fn_params(node):
                    if not _mentions(doc, param):
                        bad(src, node.lineno,
                            f"{node.name}: parameter {param!r} not mentioned in docstring")
    return out


@register_rule("warn-category", tier="ast")
def warn_category(ctx: Context) -> list[Finding]:
    """Every warnings.warn call passes an explicit warning category.

    Degrade paths speak through ``repro_torch.diagnostics.warn_degrade``
    (the ``ReproDegradeWarning`` channel); any other ``warnings.warn``
    must at least name its category so callers can filter on it.
    """
    out = []
    for src in ctx.files:
        bare_warn_imported = any(
            isinstance(node, ast.ImportFrom) and node.module == "warnings"
            and any(a.name == "warn" for a in node.names)
            for node in ast.walk(src.tree)
        )
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _chain(node.func)
            is_warn = chain == "warnings.warn" or (
                bare_warn_imported and isinstance(node.func, ast.Name) and node.func.id == "warn")
            if not is_warn:
                continue
            if not (len(node.args) >= 2 or any(kw.arg == "category" for kw in node.keywords)):
                out.append(Finding(
                    "warn-category", src.rel, node.lineno,
                    "warnings.warn without an explicit category; use "
                    "diagnostics.warn_degrade (degrade paths) or pass a "
                    "category callers can filter on",
                ))
    return out
