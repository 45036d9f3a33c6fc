"""Tier-C rules: exhaustive bounded model checking over the port's substrate.

Where the plan tier checks one resolved artifact or replays one trace,
these rules enumerate *state spaces* with ``analysis.explore`` and check
every reached state:

  scheduler-model        explore ALL submit/admit/decode interleavings of
                         the continuous-batching scheduler's abstract twin
                         on small bounded configs; block-ledger safety +
                         bounded-liveness (starvation) in every state
  overlap-interleavings  explore ALL legal landing timings of every ring
                         hop schedule (hops 1-8 x overlap x remote_copy,
                         plus the hop counts of the production
                         flash-attention ring plans, zigzag on and off)
  dtype-dataflow         the (dtype, scale) dataflow of every suite
                         kernel's ``KernelStreams`` and of the paged KV
                         pools under every block-scaled policy

The ``check_*`` helpers and ``explore.*Model`` classes are the public
seam: rules sweep the live substrate, tests feed the same helpers
seeded-bad inputs (``tests/torch_analysis_fixtures/``). Rule functions
import torch lazily; the scheduler-model rule needs none.
"""
from __future__ import annotations

from repro_torch.analysis import explore
from repro_torch.analysis.base import Context, Finding, register_rule


def _explored_findings(rule: str, path: str, tag: str, problems, stats,
                       ctx: Context) -> list:
    """Wrap one exploration's problems as findings, record its stats, and
    surface budget exhaustion as a distinct ``budget-exhausted`` finding
    (never a silent pass — the CLI maps it to exit code 3)."""
    ctx.record_stats(rule, tag, stats)
    out = [Finding(rule, path, 0, f"{tag}: {p}") for p in problems]
    if stats.truncated:
        out.append(Finding(
            rule, path, 0,
            f"{tag}: exploration truncated at {stats.states} states / "
            f"depth {stats.max_depth} — budget exhausted, the remaining "
            f"state space is UNCHECKED (raise --budget)",
            kind="budget-exhausted",
        ))
    return out


@register_rule("scheduler-model", tier="model")
def scheduler_model(ctx: Context) -> list[Finding]:
    """Exhaustively model-check the continuous-batching scheduler.

    Explores every submit/admit/decode interleaving of
    ``explore.SchedulerModel`` (the abstract twin the bisimulation test
    locks to ``serving/scheduler.py``) over the bounded
    ``explore.SCHEDULER_CONFIGS``, checking the block-ledger safety
    invariants in every reached state plus starvation bounds and clean
    drains at every leaf. Pure Python: no torch on this path.
    """
    out = []
    for tag, config in explore.SCHEDULER_CONFIGS:
        problems, stats = explore.explore(explore.SchedulerModel(config), ctx.budget)
        out.extend(_explored_findings(
            "scheduler-model", "repro_torch.serving.scheduler", tag, problems, stats, ctx))
    return out


FLASH_RING_MESH = {"data": 16, "model": 16}


@register_rule("overlap-interleavings", tier="model")
def overlap_interleavings(ctx: Context) -> list[Finding]:
    """Race-check ring schedules under ALL legal transfer timings.

    The plan tier's ``overlap-schedule`` replays each ``ring_schedule``
    once, in program order. This rule explores every interleaving the
    schedule permits — a hop's transfer lands whenever the link delivers
    it — and flags any ordering where a fold (or a later transfer) touches
    a buffer whose copy has not landed. Sweeps hops 1..8 x {overlap, sync}
    x {copy_, ring-hop kernel}, plus the hop counts of the production
    flash-attention ring plans (``plan_for("flash_attention",
    MeshSpec({"data": 16, "model": 16}), ...)``, zigzag on and off).
    """
    import warnings

    from repro_torch.hopper import ops as _ops  # noqa: F401  (registers rules)
    from repro_torch.hopper import partition
    from repro_torch.launch.op_cases import op_roofline_cases
    from repro_torch.parallel.collectives import ring_schedule

    out = []
    sweeps = {(hops, overlap, remote): "ring_schedule"
              for hops in range(1, 9)
              for overlap in (False, True)
              for remote in (False, True)}

    case = next(c for c in op_roofline_cases() if c[0] == "flash_attention")
    args, kwargs = case[1], case[2]
    mesh = partition.MeshSpec(dict(FLASH_RING_MESH))
    for zig in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            plan = partition.plan_for("flash_attention", mesh, *args, **kwargs, zigzag=zig)
        if plan is None or plan.hops < 2:
            out.append(Finding(
                "overlap-interleavings", "repro_torch.hopper.partition", 0,
                f"flash_attention ring plan (zigzag={zig}) did not resolve "
                f"with >= 2 hops — its schedule cannot be race-checked"))
            continue
        for overlap in (False, True):
            for remote in (False, True):
                sweeps.setdefault((plan.hops, overlap, remote), f"ring plan zigzag={zig}")

    for (hops, overlap, remote), origin in sorted(sweeps.items(), key=lambda kv: kv[0]):
        events = ring_schedule(hops, overlap=overlap, remote_copy=remote)
        problems, stats = explore.explore_hop_interleavings(events, hops, ctx.budget)
        tag = f"{origin}(hops={hops}, overlap={overlap}, remote_copy={remote})"
        out.extend(_explored_findings(
            "overlap-interleavings", "repro_torch.parallel.collectives", tag,
            problems, stats, ctx))
    return out


# -- dtype dataflow -----------------------------------------------------------


def check_dtype_dataflow(streams, policy=None):
    """The dtype/scale dataflow of one ``KernelStreams``.

    Each operand carries a lattice value (integer or floating, its width,
    its role). Flagged, per the paper's widening sum-dot-product contract
    and the block-scaling scheme:

    - sub-fp32 floating values folding into an accumulator narrower than
      fp32, or into none at all (saturation: the expanding accumulation has
      nowhere to live), with the accumulator's width named; a copy
      (``accum`` None, nothing summed) folds nothing
    - narrowing without a scale: fp8 values (in or out) with no fp32
      ``scale`` operand beside them — the narrow format's dynamic range is
      unusable without the per-block scale factors
    - a block-scaled ``policy`` (``scale_block > 0``) whose kernel takes
      no scales at all

    ``policy`` is a resolved ``core.precision.Precision`` or None.
    Returns problem strings.
    """
    import torch

    def floating(dt):
        return dt is not None and dt.is_floating_point

    def width(dt):
        return torch.empty((), dtype=dt).element_size()

    values = [o for o in streams.operands if o.role == "value" and floating(o.dtype)]
    scales = [o for o in streams.operands
              if o.role == "scale" and o.dtype == torch.float32 and o.block > 0]
    narrow = [o for o in values if width(o.dtype) < 4]
    fp8_in = [o for o in values if width(o.dtype) == 1]
    fp8_out = [o for o in streams.outs if floating(o.dtype) and width(o.dtype) == 1]

    problems = []
    if narrow and streams.accum is not None:
        n = len(narrow)
        if not floating(streams.accum):
            problems.append(
                f"{streams.name}: {n} sub-fp32 value stream(s) but no floating "
                f"accumulator at all ({streams.accum})")
        elif width(streams.accum) < 4:
            problems.append(
                f"{streams.name}: {n} sub-fp32 value stream(s) fold into a "
                f"{width(streams.accum)}-byte accumulator — the expanding "
                f"accumulation needs an fp32+ accumulator")
    if (fp8_in or fp8_out) and not scales:
        where = "in" if fp8_in else "out"
        problems.append(
            f"{streams.name}: fp8 {where}-stream(s) carry no fp32 scale "
            f"stream — narrowing without a scale loses the dynamic range "
            f"block scaling exists to keep")
    if (policy is not None and policy.scale_block > 0
            and width(policy.compute_dtype) < 2 and not scales):
        problems.append(
            f"{streams.name}: policy {policy.name!r} block-scales every "
            f"{policy.scale_block} elements but the kernel takes no scales")
    return problems


def check_quantized_pool(cache):
    """Scale-coverage problems of one ``serving/paged_cache.py``
    ``PagedKVCache`` (the reference's check).

    A pool holding sub-fp16 floating values is only readable through its
    per-row scales: ``decode_attention``'s gather dequantizes each cached
    row as ``value * scale``. Flags pools whose values are narrow but
    whose ``k_scale``/``v_scale`` is missing, mis-shaped (must be the pool
    shape with a trailing extent-1 scale-per-row dim), or non-fp32.
    Returns problem strings.
    """
    import torch

    problems = []
    for side in ("k", "v"):
        pool = getattr(cache, f"{side}_pool")
        scale = getattr(cache, f"{side}_scale")
        d = pool.dtype
        if not (d.is_floating_point and pool.element_size() < 2):
            continue
        name = str(d).replace("torch.", "")
        if scale is None:
            problems.append(
                f"{side}_pool holds {name} values but {side}_scale is "
                f"None — quantized reads bypass the per-row scales")
            continue
        want = tuple(pool.shape[:-1]) + (1,)
        if tuple(scale.shape) != want:
            problems.append(
                f"{side}_scale shape {tuple(scale.shape)} is not per-row "
                f"{want} — gathered rows dequantize with the wrong scale")
        if scale.dtype != torch.float32:
            problems.append(
                f"{side}_scale dtype {str(scale.dtype).replace('torch.', '')} is not "
                f"float32")
    return problems


class _PoolCfg:
    """The smallest config ``init_paged_cache`` sizes a pool from."""

    num_layers, num_kv_heads, dtype = 1, 2, "float32"

    def resolved_head_dim(self):
        return 8


@register_rule("dtype-dataflow", tier="model")
def dtype_dataflow(ctx: Context) -> list[Finding]:
    """Dtype/scale dataflow holds across every suite kernel and KV pool.

    Runs ``check_dtype_dataflow`` over every ``block_search.full_suite()``
    case's ``KernelStreams`` under its case's resolved precision policy,
    and ``check_quantized_pool`` over paged KV pools initialized under
    each block-scaled policy — so an fp8 path that drops its scales or
    narrows its accumulator is a finding, not a silent numerics
    regression. Ops with no kernel are listed in the stats.
    """
    from repro_torch.analysis import plan_rules
    from repro_torch.core import precision as prec
    from repro_torch.serving import paged_cache

    out = []
    for name, streams, policy in plan_rules.suite_streams(ctx):
        path = f"repro_torch.launch.block_search:{name}"
        if streams is None:
            out.append(Finding("dtype-dataflow", path, 0,
                               f"{name}: the op's kernels declare no KernelStreams for this "
                               f"case, so its dataflow is unchecked"))
            continue
        ctx.record_stats("dtype-dataflow", name, plan_rules.streams_account(streams, policy))
        for p in check_dtype_dataflow(streams, policy):
            out.append(Finding("dtype-dataflow", path, 0, p))
    ctx.record_stats("dtype-dataflow", "kernelless", plan_rules.kernelless(ctx))

    for pol in [None] + [n for n, p in sorted(prec.POLICIES.items()) if p.scale_block > 0]:
        cache = paged_cache.init_paged_cache(
            _PoolCfg(), num_blocks=3, block_size=2, policy=pol, device="cpu")
        for p in check_quantized_pool(cache):
            out.append(Finding("dtype-dataflow",
                               f"repro_torch.serving.paged_cache:policy={pol}", 0, p))
    return out
