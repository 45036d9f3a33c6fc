"""Implementation resolver for the port's ops, and the kernels' launch counts.

Each op registers up to three implementations:

  - ``cuda``:  the op's hand-written Hopper kernel wrapper. It launches the
               kernel for CUDA tensors and raises if the kernel does not
               build or launch; for CPU tensors, and only for them, it runs
               the op's plain version instead.
  - ``torch``: the plain form (the counterpart of the reference's ``xla``
               impl): the kernel's algorithm in plain tensor code, on
               any device.
  - ``ref``:   the naive oracle.

Selection: explicit ``impl=`` > ``set_default_impl()`` / ``default_impl()``
> ``auto``, which is ``cuda`` where the op has a kernel and ``torch``
otherwise. Nothing here retreats from one implementation to another.

Block sizes (``resolve_blocks``: explicit > ``set_block_override`` > the
static table) are the **plain** forms' tiles. A CUDA kernel's tiles are
compile-time constants of its source, with one exception: the linear
attention kernel takes ``chunk`` at run time, since the chunk bounds the
span one fp32 ``exp`` covers (``ops.linear_attention``'s overflow guard).

The kernels' other run-time geometry comes from their planners
(``gemm.plan_f32``, ``gemm_scaled.plan``, ``spmm.plan``, ``spmspm.plan``,
``stencil.plan``, ``flash_attention.plan``). Each planner asks
``lookup_plan(op, args)`` first: a plan set with ``set_plan_override`` /
``plan_override`` for exactly those planner arguments (shapes, dtype,
alignment, SMs), else its cost model's pick. Block overrides are op-wide;
a plan override holds at one shape only, since a plan that fits one shape
says nothing of another. ``PLAN_HITS`` counts the planner calls an
override answered, by op. ``PlanCandidate`` is one entry of a planner's
``candidates(...)``: every plan its model weighs, with the model's cost,
its shared memory, threads and registers, and whether it fits the card.

``KernelStreams`` is a kernel's dataflow declaration: the operands it
reads (values, scales with their block, indices), the dtype it sums in
and the outputs it writes. Each kernel module registers one declaration
function for its op (``register_streams``); ``kernel_streams`` finds the
one that takes a call. The static checker's widening and dataflow rules
read them, the CPU tests hold them to the plain forms' tensors, and the
smoke run probes the accumulator on the card.

``LAUNCHES`` counts kernel launches per kernel: a wrapper adds one where it
launches its kernel, and nowhere else. The scaled kernels count under
their own keys (``gemm_scaled``, ``flash_attention_scaled``), apart from
the unscaled ``gemm`` and ``flash_attention``; the chunked scan counts
under ``linear_attention`` (its single-token step has no kernel); the ring
hop (``hopper/ring_hop.py``, no op of its own) under ``ring_hop``, once per
leaf pushed.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Any, Callable, NamedTuple

VALID_IMPLS = ("auto", "cuda", "torch", "ref")

_REGISTRY: dict[str, dict[str, Callable]] = {}
_default_impl: str | None = None
_counter: Callable | None = None
LAUNCHES: collections.Counter = collections.Counter()


def register_kernel(op: str, *, impl: str) -> Callable:
    """Decorator: ``@register_kernel("flash_attention", impl="torch")``."""
    if impl not in VALID_IMPLS or impl == "auto":
        raise ValueError(f"cannot register impl {impl!r}; one of {VALID_IMPLS[1:]}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(op, {})[impl] = fn
        return fn

    return deco


def registered_ops() -> list[str]:
    return sorted(_REGISTRY)


def implementations(op: str) -> list[str]:
    if op not in _REGISTRY:
        raise KeyError(f"unknown op {op!r}; registered: {sorted(_REGISTRY)}")
    return sorted(_REGISTRY[op])


def set_default_impl(impl: str | None) -> None:
    global _default_impl
    if impl is not None and impl not in VALID_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {VALID_IMPLS}")
    _default_impl = impl


@contextlib.contextmanager
def default_impl(impl: str | None):
    """Scoped ``set_default_impl``: restores the previous default on exit."""
    old = _default_impl
    set_default_impl(impl)
    try:
        yield
    finally:
        set_default_impl(old)


def current_default_impl() -> str | None:
    """The impl ``set_default_impl`` set, or None."""
    return _default_impl


def resolve_impl(op: str, impl: str | None = None) -> str:
    impl = impl or _default_impl or "auto"
    if impl not in VALID_IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {VALID_IMPLS}")
    if impl == "auto":
        return "cuda" if "cuda" in implementations(op) else "torch"
    return impl


def kernel_call(op: str, *args, impl: str | None = None, **kwargs):
    """Run ``op`` through its resolved implementation (or, inside
    ``counting``, hand it to the counter)."""
    if _counter is not None:
        return _counter(op, *args, impl=impl, **kwargs)
    impl = resolve_impl(op, impl)
    fn = _REGISTRY[op].get(impl)
    if fn is None:
        raise NotImplementedError(
            f"op {op!r} has no {impl!r} implementation; "
            f"available: {implementations(op)}"
        )
    return fn(*args, **kwargs)


def reset_launches() -> None:
    LAUNCHES.clear()


@contextlib.contextmanager
def counting(counter: Callable):
    """Inside, every ``kernel_call`` goes to ``counter(op, *args, impl=,
    **kwargs)`` instead of an implementation: the dry run's count
    (``launch.step_count``) prices each kernel op by formula there."""
    global _counter
    old, _counter = _counter, counter
    try:
        yield
    finally:
        _counter = old


# ---------------------------------------------------------------------------
# Block sizes of the plain forms
# ---------------------------------------------------------------------------

_BLOCK_DEFAULTS: dict[str, dict[str, int]] = {
    "gemm": {"bm": 256, "bk": 256, "bn": 256},
    "flash_attention": {"bq": 128, "bk": 128},
    "linear_attention": {"chunk": 32},
    "spmm": {"bm": 128},
    "bsr_spmm": {"bf": 512},
    "spmspm": {"bm": 8, "bn": 128},
    "stencil": {"bx": 8},
    "decode_attention": {"bs": 512},
}
_block_overrides: dict[str, dict[str, int]] = {}


def _known_blocks(op: str, names) -> dict[str, int]:
    known = _BLOCK_DEFAULTS.get(op)
    if known is None:
        raise KeyError(f"op {op!r} has no block-size table; known: {sorted(_BLOCK_DEFAULTS)}")
    bad = set(names) - set(known)
    if bad:
        raise ValueError(f"{op!r} has no block parameters {sorted(bad)}")
    return known


def block_defaults(op: str, *, overrides: bool = True) -> dict[str, int]:
    """``op``'s plain-form block sizes: the static table, merged with any
    override unless ``overrides=False``."""
    if not overrides:
        return dict(_BLOCK_DEFAULTS.get(op, {}))
    return {**_BLOCK_DEFAULTS.get(op, {}), **_block_overrides.get(op, {})}


def clear_block_overrides(op: str | None = None) -> None:
    """Drop ``op``'s block overrides, or every op's."""
    if op is None:
        _block_overrides.clear()
    else:
        _block_overrides.pop(op, None)


def set_block_override(op: str, **sizes: int) -> None:
    """Override the plain form's default block sizes for ``op``."""
    _known_blocks(op, sizes)
    _block_overrides.setdefault(op, {}).update(sizes)


def resolve_blocks(op: str, **explicit: int | None) -> dict[str, int]:
    """explicit kwarg > ``set_block_override`` > static default; ``None``
    entries fall through. Unknown parameter names raise."""
    known = _known_blocks(op, explicit)
    resolved = {**known, **_block_overrides.get(op, {})}
    resolved.update({k: v for k, v in explicit.items() if v is not None})
    return resolved


@contextlib.contextmanager
def block_override(op: str, **sizes: int):
    """Scoped ``set_block_override``."""
    had = op in _block_overrides
    old = dict(_block_overrides.get(op, {}))
    set_block_override(op, **sizes)
    try:
        yield
    finally:
        if had:
            _block_overrides[op] = old
        else:
            _block_overrides.pop(op, None)


# ---------------------------------------------------------------------------
# Run-time plans of the kernels
# ---------------------------------------------------------------------------

_plan_overrides: dict[tuple, Any] = {}
PLAN_HITS: collections.Counter = collections.Counter()


class PlanCandidate(NamedTuple):
    """One plan a planner's model weighs: ``knobs`` are its tunable fields
    (ints), ``cost`` the model's cost (lower is better; ``key`` orders
    ties), ``smem``/``threads``/``regs`` what a CTA of it takes, and
    ``why`` is empty where it fits the card, else the limit it passes."""

    plan: Any
    knobs: dict
    cost: float
    key: tuple
    smem: int
    threads: int
    regs: int
    why: str = ""

    @property
    def feasible(self) -> bool:
        return not self.why


def model_pick(candidates) -> PlanCandidate:
    """The least-``key`` feasible candidate (the first of equal keys)."""
    return min((c for c in candidates if c.feasible), key=lambda c: c.key)


def _plan_key(op: str, args) -> tuple:
    return (op, tuple(args))


def set_plan_override(op: str, args, plan) -> None:
    """Make ``op``'s planner return ``plan`` when called with exactly
    ``args`` (its positional arguments, in order)."""
    _plan_overrides[_plan_key(op, args)] = plan


def clear_plan_overrides(op: str | None = None) -> None:
    """Drop ``op``'s plan overrides, or every op's."""
    for key in [k for k in _plan_overrides if op is None or k[0] == op]:
        del _plan_overrides[key]


@contextlib.contextmanager
def plan_override(op: str, args, plan):
    """Scoped ``set_plan_override``: the previous entry (or none) returns
    on exit."""
    key = _plan_key(op, args)
    had, old = key in _plan_overrides, _plan_overrides.get(key)
    _plan_overrides[key] = plan
    try:
        yield
    finally:
        if had:
            _plan_overrides[key] = old
        else:
            _plan_overrides.pop(key, None)


def lookup_plan(op: str, args):
    """The plan overriding ``op``'s planner at ``args``, or None. A hit
    adds one to ``PLAN_HITS[op]``."""
    if not _plan_overrides:
        return None
    plan = _plan_overrides.get(_plan_key(op, args))
    if plan is not None:
        PLAN_HITS[op] += 1
    return plan


# ---------------------------------------------------------------------------
# The kernels' dataflow declarations
# ---------------------------------------------------------------------------


class StreamOperand(NamedTuple):
    """One tensor a kernel reads or writes: ``role`` is ``"value"``,
    ``"scale"`` (fp32 factors, each covering ``block`` elements of its
    values along one axis) or ``"index"``; ``shape`` and ``dtype`` are the
    tensor's as the kernel takes it."""

    role: str
    shape: tuple
    dtype: Any
    block: int = 0


class KernelStreams(NamedTuple):
    """What one kernel route reads, sums in and writes, for one call:
    ``name`` (the kernel and its route), ``operands`` (``StreamOperand``s
    in the kernel's argument order), ``accum`` (the dtype its running sums
    are carried in; None for a copy or gather that sums nothing) and
    ``outs`` (``StreamOperand``s of its outputs). The counterpart of the
    reference's ``StreamProgram`` stream declarations, which its
    widening and dataflow rules read."""

    name: str
    operands: tuple
    accum: Any
    outs: tuple


_STREAMS: dict[str, list[tuple[str, Callable]]] = {}


def register_streams(op: str, *, kernel: str) -> Callable:
    """Decorator: ``@register_streams("gemm", kernel="gemm")`` registers
    ``fn(structs, policy=None, **kwargs) -> KernelStreams | None``, the
    declaration of ``kernel``'s routes for ``op``. ``structs`` are the
    call's operands as ``(shape, dtype)`` pairs in the op's positional
    order (None for an absent optional operand), ``policy`` its resolved
    ``core.precision`` policy or None; the function returns None for a
    call its kernel does not take (another kernel of the op declares it)."""

    def deco(fn: Callable) -> Callable:
        _STREAMS.setdefault(op, []).append((kernel, fn))
        return fn

    return deco


def kernel_streams(op: str, structs, policy=None, **kwargs) -> KernelStreams:
    """The one declaration of ``op``'s kernels that takes this call.
    Raises ``LookupError`` where none does (or ``op`` has none) and
    ``RuntimeError`` where two do."""
    found = [s for _, fn in _STREAMS.get(op, ())
             if (s := fn(tuple(structs), policy, **kwargs)) is not None]
    if not found:
        raise LookupError(f"no kernel of op {op!r} declares its streams for {structs} "
                          f"under policy {getattr(policy, 'name', policy)!r}")
    if len(found) > 1:
        raise RuntimeError(f"op {op!r}: {len(found)} kernels declare one call: "
                           f"{[s.name for s in found]}")
    return found[0]


@contextlib.contextmanager
def saved_overrides():
    """Inside, block and plan overrides may be set freely: both tables
    return to what they held on exit."""
    blocks = {op: dict(sizes) for op, sizes in _block_overrides.items()}
    plans = dict(_plan_overrides)
    try:
        yield
    finally:
        _block_overrides.clear()
        _block_overrides.update(blocks)
        _plan_overrides.clear()
        _plan_overrides.update(plans)
