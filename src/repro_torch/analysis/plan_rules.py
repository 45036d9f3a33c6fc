"""Tier-B rules: checks on the port's resolved plans, declarations and
schedules.

Everything here checks the *exact executed artifact*: ``ring_scan``
replays the very ``collectives.ring_schedule`` the overlap-schedule rule
verifies, ``smem-budget`` prices the very plans the kernels' planners hand
their launches (``launch/block_search.full_suite()``'s cases, through each
case's ``planner``), the widening rule reads the ``KernelStreams`` each
kernel module declares, and the partition rules resolve
``hopper/partition.py``'s ``plan_for`` on device-free ``MeshSpec``s.

  overlap-schedule     ring schedules are hazard-free (buffer aliasing,
                       DMA-wait ordering, fold coverage/order)
  smem-budget          every planned suite case's model pick exists and
                       fits a CTA's shared memory, threads and registers
                       (the counterpart of the reference's vmem-budget)
  mesh-divisibility    every partitioned op resolves a plan on both
                       production meshes (no silent-replication dead end)
  plan-collective-axes plan levels and collective costs stay inside the
                       mesh/vocabulary/kind vocabularies
  accum-dtype-widening every suite kernel taking sub-fp32 floating values
                       declares an fp32+ accumulator
  paged-gather-coverage the serving scheduler's block ledger upholds the
                       paged gather's contract

The ``check_*`` helpers are the public seam: rules call them over the
live substrate, tests call them over seeded-bad inputs. Torch and the
substrate are imported inside the rules, never at module level.
"""
from __future__ import annotations

import dataclasses
import warnings

from repro_torch.analysis.base import Context, Finding, register_rule

# the production meshes every partitioned op must resolve on: single-pod
# 16x16 and the two-pod hierarchy
PRODUCTION_MESH_SHAPES = (
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
)

# CollectiveCost.kind vocabulary: the kinds core/topology.py
# collective_seconds prices, which launch/roofline.py charges every plan by
COLLECTIVE_KINDS = frozenset(
    {"all_reduce", "all_gather", "reduce_scatter", "all_to_all", "permute"}
)

# the H100's limits a CTA must fit when the check runs off the card: its
# SMs and shared memory (launch/block_search.py), 1024 threads and 65,536
# registers a block
H100_THREADS_PER_BLOCK = 1024
H100_REGS_PER_BLOCK = 65536


def check_hop_schedule(events, hops: int, *, remote_copy: bool = False):
    """Verify one ring schedule against the double-buffer discipline.

    Args: ``events`` — ``collectives.HopEvent`` sequence (the schedule
    ``ring_scan`` replays); ``hops`` — the ring length the schedule must
    cover; ``remote_copy`` — whether the transport is the ring-hop kernel
    (``dma_start``/``dma_wait``) rather than a synchronous ``send``.

    Returns problem strings (empty = hazard-free), the reference's: every
    transfer of hop t reads the buffer holding hop t-1 and must not land in
    a buffer whose hop has not been folded yet (the overlap alias hazard);
    every fold of hop t reads the buffer holding exactly hop t, after its
    wait when the transport is the kernel; folds cover 0..hops-1 in order;
    no dma_start is left without its dma_wait.
    """
    problems: list[str] = []
    versions = {0: 0}   # buffer -> the hop whose block it holds
    arrived = {0}       # hops whose data is visible (copy complete / sync)
    pending: dict = {}  # buffer -> hop of an un-waited dma_start
    folded: list[int] = []
    for ev in events:
        if ev.kind in ("send", "dma_start"):
            t = ev.hop
            if versions.get(ev.src) != t - 1:
                problems.append(
                    f"hop {t} {ev.kind} reads buffer {ev.src} holding hop "
                    f"{versions.get(ev.src)}, expected hop {t - 1}"
                )
            dst_hop = versions.get(ev.dst)
            if dst_hop is not None and dst_hop < hops and dst_hop not in folded:
                problems.append(
                    f"hop {t} {ev.kind} lands in buffer {ev.dst} still "
                    f"holding unfolded hop {dst_hop} (overlap alias hazard)"
                )
            versions[ev.dst] = t
            if ev.kind == "dma_start":
                pending[ev.dst] = t
            else:
                arrived.add(t)
        elif ev.kind == "dma_wait":
            started = pending.pop(ev.dst, None)
            if started != ev.hop:
                problems.append(
                    f"dma_wait for hop {ev.hop} on buffer {ev.dst} without "
                    f"a matching dma_start"
                )
            else:
                arrived.add(ev.hop)
        elif ev.kind == "fold":
            t = ev.hop
            held = versions.get(ev.src)
            if held != t:
                problems.append(
                    f"fold of hop {t} reads buffer {ev.src} holding hop "
                    f"{held}"
                )
            elif t not in arrived:
                problems.append(
                    f"fold of hop {t} consumes buffer {ev.src} before its "
                    f"DMA semaphore wait — unordered RDMA read"
                )
            expected = folded[-1] + 1 if folded else 0
            if t != expected:
                problems.append(
                    f"fold order broken: hop {t} folded after {folded}"
                )
            folded.append(t)
        else:
            problems.append(f"unknown event kind {ev.kind!r}")
    if sorted(set(folded)) != list(range(hops)):
        problems.append(
            f"folds {sorted(set(folded))} do not cover hops 0..{hops - 1}"
        )
    if pending:
        problems.append(
            f"dma_start without dma_wait on buffers {sorted(pending)}"
        )
    return problems


@register_rule("overlap-schedule", tier="plan")
def overlap_schedule(ctx: Context) -> list[Finding]:
    """Every schedule ring_scan can replay is hazard-free.

    Sweeps ``parallel/collectives.py``'s ``ring_schedule`` over hop counts
    1..8 x {overlap, sync} x {copy_, ring-hop kernel} and runs
    ``check_hop_schedule`` on each — the schedule checked is the schedule
    executed, by construction.
    """
    from repro_torch.parallel.collectives import ring_schedule

    out = []
    for hops in range(1, 9):
        for overlap in (False, True):
            for remote in (False, True):
                events = ring_schedule(hops, overlap=overlap, remote_copy=remote)
                for p in check_hop_schedule(events, hops, remote_copy=remote):
                    out.append(Finding(
                        "overlap-schedule", "repro_torch.parallel.collectives", 0,
                        f"ring_schedule(hops={hops}, overlap={overlap}, "
                        f"remote_copy={remote}): {p}",
                    ))
    return out


# -- the kernels' run-time plans ----------------------------------------------


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What one CTA of a kernel may take. Fields: ``sms`` — the card's SMs
    (the planners size grids by it); ``smem_per_block`` — shared memory a
    block may opt into, bytes; ``threads_per_block``; ``regs_per_block`` —
    32-bit registers a block's threads hold together; ``source`` — where
    the numbers come from (the H100's constants, or the card as read)."""

    sms: int
    smem_per_block: int
    threads_per_block: int = H100_THREADS_PER_BLOCK
    regs_per_block: int = H100_REGS_PER_BLOCK
    source: str = "H100 constants"


def card_limits(device="cpu") -> CardLimits:
    """The limits a CTA must fit on ``device``: a CUDA device's own (its SM
    count, opt-in shared memory a block, threads a block and registers an
    SM, which on Hopper a single block may fill), else the H100's
    (``block_search.H100_SMS`` / ``SMEM_BUDGET_BYTES``)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        from repro_torch.launch.block_search import H100_SMS, SMEM_BUDGET_BYTES

        return CardLimits(H100_SMS, SMEM_BUDGET_BYTES,
                          source="H100 constants (launch/block_search.py)")
    index = torch.cuda.current_device() if device.index is None else device.index
    p = torch.cuda.get_device_properties(index)
    return CardLimits(p.multi_processor_count, p.shared_memory_per_block_optin,
                      p.max_threads_per_block, p.regs_per_multiprocessor,
                      f"{p.name} (cuda:{index}) as read")


def check_candidates(cands, limits: CardLimits, *, name: str = "plan"):
    """Problems of one planner's candidate list against ``limits``.

    Args: ``cands`` — the ``dispatch.PlanCandidate`` list a kernel's
    ``candidates(...)`` returns; ``limits`` — a ``CardLimits``; ``name`` —
    the case the messages name. The list must be non-empty and hold a
    feasible plan, and the model's pick (``dispatch.model_pick``) must fit
    the card: its shared memory, threads and registers (threads times
    ``regs``) a CTA. Returns problem strings.
    """
    from repro_torch.hopper.dispatch import model_pick

    if not cands:
        return [f"{name}: the planner lists no candidates"]
    if not any(c.feasible for c in cands):
        whys = sorted({c.why for c in cands})
        return [f"{name}: no feasible plan among {len(cands)} candidates "
                f"(pruned by {', '.join(whys)})"]
    pick = model_pick(cands)
    problems = []
    if pick.smem > limits.smem_per_block:
        problems.append(
            f"{name}: the model's pick {pick.knobs} takes {pick.smem} bytes of shared "
            f"memory a CTA, past the {limits.smem_per_block} a block may use")
    if pick.threads > limits.threads_per_block:
        problems.append(
            f"{name}: the model's pick {pick.knobs} takes {pick.threads} threads a CTA, "
            f"past the {limits.threads_per_block} a block may have")
    if pick.threads * pick.regs > limits.regs_per_block:
        problems.append(
            f"{name}: the model's pick {pick.knobs} takes {pick.threads} x {pick.regs} "
            f"registers a CTA, past the {limits.regs_per_block} a block may hold")
    return problems


def suite_cases(ctx: Context) -> list:
    """``(name, case)`` for every ``block_search.full_suite()`` entry,
    built once per run on ``ctx.device`` from seed 0: at the card's
    shapes on a CUDA device, at the reference's elsewhere."""
    if "suite" not in ctx.cache:
        import numpy as np
        import torch

        from repro_torch.launch import block_search

        device = torch.device(ctx.device)
        rng = np.random.default_rng(0)
        ctx.cache["suite"] = [
            (name, factory(rng, device=device, card=device.type == "cuda"))
            for name, factory in sorted(block_search.full_suite().items())]
    return ctx.cache["suite"]


def suite_plans(ctx: Context, limits: CardLimits):
    """``(name, case, plan_op, plan_args, candidates)`` for every suite
    case with a ``planner``, at the planner's arguments on a card of
    ``limits.sms`` SMs, pruned at ``limits.smem_per_block``. The cases
    with nothing to plan are in ``unplanned``."""
    from repro_torch.launch.block_search import local_case_shapes

    for name, case in suite_cases(ctx):
        if case.planner is None or case.fixed:
            continue
        plan_op, plan_args, cands = case.planner(
            case, local_case_shapes(case), limits.sms, limits.smem_per_block)
        yield name, case, plan_op, plan_args, cands


def unplanned(ctx: Context) -> dict[str, str]:
    """Suite cases with no run-time plan, and why: ``fixed`` (the kernel's
    geometry is its source's constants) or a plain form's block table."""
    out = {}
    for name, case in suite_cases(ctx):
        if case.fixed:
            out[name] = f"fixed: {case.fixed}"
        elif case.planner is None:
            out[name] = f"no plan: the card tunes {sorted(case.candidates[0])} of the block table"
    return out


@register_rule("smem-budget", tier="plan")
def smem_budget(ctx: Context) -> list[Finding]:
    """Every planned suite case's model pick exists and fits a CTA on the card.

    The counterpart of the reference's vmem-budget: for every
    ``block_search.full_suite()`` case with a ``planner``, at the
    planner's arguments, ``check_candidates`` against the card's limits —
    on the CPU the H100's constants at the reference's shapes, with
    ``device="cuda"`` the card's own SMs and opt-in shared memory at the
    card's shapes. A kernel whose pick overflowed would fail its launch.
    Cases with nothing to plan are listed in the rule's stats.
    """
    from repro_torch.hopper.dispatch import model_pick
    from repro_torch.launch.block_search import encode_args

    limits = card_limits(ctx.device)
    ctx.record_stats("smem-budget", "limits", dataclasses.asdict(limits))
    out = []
    for name, _case, plan_op, plan_args, cands in suite_plans(ctx, limits):
        problems = check_candidates(cands, limits, name=name)
        for p in problems:
            out.append(Finding("smem-budget", f"repro_torch.launch.block_search:{name}", 0, p))
        entry = {"plan_op": plan_op, "plan_args": encode_args(plan_args),
                 "candidates": len(cands), "feasible": sum(c.feasible for c in cands)}
        if any(c.feasible for c in cands):
            pick = model_pick(cands)
            entry.update(pick=pick.knobs, smem=pick.smem, threads=pick.threads, regs=pick.regs)
        ctx.record_stats("smem-budget", name, entry)
    ctx.record_stats("smem-budget", "unplanned", unplanned(ctx))
    return out


# -- the kernels' dataflow declarations ---------------------------------------


def _floating(dt) -> bool:
    return dt is not None and dt.is_floating_point


def _width(dt) -> int:
    import torch

    return torch.empty((), dtype=dt).element_size()


def suite_streams(ctx: Context):
    """``(name, streams, policy)`` for every suite case whose op has a
    kernel: its ``dispatch.kernel_streams`` at the case's operands, policy
    and keywords. A kernel op that declares nothing for its case is
    yielded with ``streams`` None; ops with no kernel (no ``cuda`` impl)
    are in ``kernelless``."""
    from repro_torch.core import precision as prec
    from repro_torch.hopper import dispatch
    from repro_torch.hopper import ops as _ops  # noqa: F401  (registers the kernels)

    for name, case in suite_cases(ctx):
        if "cuda" not in dispatch.implementations(case.op):
            continue
        structs = tuple(None if a is None else (tuple(a.shape), a.dtype) for a in case.args)
        policy = prec.resolve(case.precision)
        kwargs = {k: v for k, v in case.plan_kwargs.items() if k != "precision"}
        try:
            streams = dispatch.kernel_streams(case.op, structs, policy, **kwargs)
        except LookupError:
            streams = None
        yield name, streams, policy


def kernelless(ctx: Context) -> dict[str, str]:
    """Suite cases whose op has no kernel, so nothing to declare."""
    from repro_torch.hopper import dispatch
    from repro_torch.hopper import ops as _ops  # noqa: F401

    return {name: f"{case.op} has no kernel: its cuda form is the blocked plain form"
            for name, case in suite_cases(ctx)
            if "cuda" not in dispatch.implementations(case.op)}


def streams_account(streams, policy) -> dict:
    """What a rule's stats say of one declaration."""
    return {"kernel": streams.name, "policy": getattr(policy, "name", None),
            "accum": str(streams.accum).replace("torch.", ""),
            "operands": [f"{o.role}:{str(o.dtype).replace('torch.', '')}"
                         for o in streams.operands]}


def check_accum_widening(streams):
    """Expanding-accumulation problems of one ``KernelStreams``.

    A kernel taking sub-fp32 *floating* values (bf16, fp8) must carry its
    running sums at fp32 or wider — the paper's widening sum-dot-product
    contract: narrow-format throughput is only usable when the
    accumulator does not saturate. Integer (index) operands, full-width
    kernels and copies (``accum`` None: nothing is summed) are exempt.
    Returns problem strings.
    """
    narrow = [o for o in streams.operands
              if o.role == "value" and _floating(o.dtype) and _width(o.dtype) < 4]
    if not narrow or streams.accum is None:
        return []
    if _floating(streams.accum) and _width(streams.accum) >= 4:
        return []
    widths = sorted({str(o.dtype).replace("torch.", "") for o in narrow})
    return [
        f"{streams.name}: streams sub-fp32 floating operands ({', '.join(widths)}) "
        f"but declares no fp32+ accumulator — it sums in "
        f"{str(streams.accum).replace('torch.', '')}, so the expanding accumulation "
        f"the narrow format requires has nowhere to live"
    ]


@register_rule("accum-dtype-widening", tier="plan")
def accum_dtype_widening(ctx: Context) -> list[Finding]:
    """Sub-fp32 suite kernels declare a full-width accumulator.

    Runs ``check_accum_widening`` over the ``KernelStreams`` of every
    ``block_search.full_suite()`` case (the policy-scoped scaled GEMM
    included): a low-precision kernel summing in its narrow format would
    saturate — the failure the precision ladder's expanding accumulation
    exists to prevent. A kernel op that declares nothing for its case is
    a finding; ops with no kernel are listed in the stats.
    """
    out = []
    for name, streams, policy in suite_streams(ctx):
        path = f"repro_torch.launch.block_search:{name}"
        if streams is None:
            out.append(Finding("accum-dtype-widening", path, 0,
                               f"{name}: the op's kernels declare no KernelStreams for this "
                               f"case, so its accumulator is unchecked"))
            continue
        ctx.record_stats("accum-dtype-widening", name, streams_account(streams, policy))
        for p in check_accum_widening(streams):
            out.append(Finding("accum-dtype-widening", path, 0, p))
    ctx.record_stats("accum-dtype-widening", "kernelless", kernelless(ctx))
    return out


# -- partition plans on the production meshes --------------------------------


def check_mesh_cases(cases, mesh_shape: dict):
    """Resolve every case's plan on one mesh; return problem strings.

    Args: ``cases`` — ``(op, args, kwargs, ...)`` tuples in the
    ``launch/op_cases.op_roofline_cases`` format; ``mesh_shape`` — the
    ``{axis: size}`` ``MeshSpec`` shape to resolve against. A case whose
    ladder exhausts (plan None — silent replication) is a problem, as is a
    resolved plan whose level sizes disagree with the mesh.
    """
    from repro_torch.hopper import partition

    mesh = partition.MeshSpec(dict(mesh_shape))
    tag = "x".join(f"{a}={s}" for a, s in mesh_shape.items())
    problems = []
    for op, args, kwargs, *_ in cases:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            plan = partition.plan_for(op, mesh, *args, **kwargs)
        if plan is None:
            problems.append(
                f"{op}: partition ladder dead-ends on mesh ({tag}) — every "
                f"rung declined, the call silently replicates"
            )
            continue
        for axis, size in plan.levels:
            if axis not in mesh.shape:
                problems.append(
                    f"{op}: plan level axis {axis!r} not in mesh ({tag})"
                )
            elif int(mesh.shape[axis]) % size != 0:
                problems.append(
                    f"{op}: plan level {axis}={size} does not divide the "
                    f"mesh axis ({tag})"
                )
    return problems


@register_rule("mesh-divisibility", tier="plan")
def mesh_divisibility(ctx: Context) -> list[Finding]:
    """Every partitioned op plans cleanly on both production meshes.

    Resolves ``launch/op_cases.op_roofline_cases()`` against the
    single-pod 16x16 and two-pod 2x16x16 ``MeshSpec``s and flags ladder
    dead-ends (silent replication) and level/mesh size mismatches. Also a
    coverage gate: every op with a PartitionRule (``partitioned_ops()``)
    must appear in the case table.
    """
    from repro_torch.hopper import ops as _ops  # noqa: F401  (registers rules)
    from repro_torch.hopper import partition
    from repro_torch.launch.op_cases import op_roofline_cases

    out = []
    cases = op_roofline_cases()
    covered = {c[0] for c in cases}
    for op in partition.partitioned_ops():
        if op not in covered:
            out.append(Finding(
                "mesh-divisibility", "repro_torch.launch.op_cases", 0,
                f"partitioned op {op!r} has no op_roofline_cases entry — "
                f"its production-mesh plans are unchecked",
            ))
    for shape in PRODUCTION_MESH_SHAPES:
        for p in check_mesh_cases(cases, shape):
            out.append(Finding("mesh-divisibility", "repro_torch.hopper.partition", 0, p))
    return out


def check_plan(plan, mesh_shape: dict):
    """Vocabulary problems of one resolved ``PartitionPlan``.

    Args: ``plan`` — the plan; ``mesh_shape`` — the ``{axis: size}`` shape
    it resolved against. Level axes and every ``CollectiveCost`` axis must
    be mesh axes in ``AXIS_VOCAB``, kinds must be priceable
    (``COLLECTIVE_KINDS``), payloads non-negative, and an overlappable
    plan must declare the hop count its pipeline amortises.
    """
    from repro_torch.hopper.partition import AXIS_VOCAB

    problems = []
    name = plan.op
    for axis, _size in plan.levels:
        if axis not in AXIS_VOCAB:
            problems.append(
                f"{name}: level axis {axis!r} outside AXIS_VOCAB {AXIS_VOCAB}"
            )
        if axis not in mesh_shape:
            problems.append(
                f"{name}: level axis {axis!r} not an axis of the mesh"
            )
    for c in plan.collectives:
        if c.kind not in COLLECTIVE_KINDS:
            problems.append(
                f"{name}: collective kind {c.kind!r} not priceable "
                f"(known: {sorted(COLLECTIVE_KINDS)})"
            )
        if c.axis not in AXIS_VOCAB or c.axis not in mesh_shape:
            problems.append(
                f"{name}: collective over axis {c.axis!r} outside the "
                f"mesh/vocabulary"
            )
        if c.nbytes < 0 or c.n < 0:
            problems.append(
                f"{name}: collective {c.kind} has negative nbytes/n"
            )
    if plan.overlappable and plan.hops < 2:
        problems.append(
            f"{name}: overlappable plan declares hops={plan.hops}; the "
            f"overlap model needs >= 2 pipeline stages to hide anything"
        )
    return problems


@register_rule("plan-collective-axes", tier="plan")
def plan_collective_axes(ctx: Context) -> list[Finding]:
    """Resolved plans only speak the partition vocabulary.

    Runs ``check_plan`` on every op_cases plan over both production
    meshes: level axes and collective-cost axes must be mesh axes from
    ``AXIS_VOCAB``, collective kinds must be ones ``launch/roofline.py``
    prices, and overlap metadata must be self-consistent.
    """
    from repro_torch.hopper import ops as _ops  # noqa: F401  (registers rules)
    from repro_torch.hopper import partition
    from repro_torch.launch.op_cases import op_roofline_cases

    out = []
    for shape in PRODUCTION_MESH_SHAPES:
        mesh = partition.MeshSpec(dict(shape))
        for op, args, kwargs, *_ in op_roofline_cases():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                plan = partition.plan_for(op, mesh, *args, **kwargs)
            if plan is None:
                continue  # mesh-divisibility owns the dead-end finding
            for p in check_plan(plan, shape):
                out.append(Finding("plan-collective-axes", "repro_torch.hopper.partition", 0, p))
    return out


# -- the serving scheduler's block ledger ------------------------------------


def check_paged_coverage(scheduler, token_for, *, steps: int = 2000):
    """Drive one continuous-batching ``scheduler`` to drain and audit the
    paged-cache ledger invariants every step (the reference's audit).

    Args: ``scheduler`` — a ``serving/scheduler.py``
    ``ContinuousBatchingScheduler`` with requests already submitted;
    ``token_for(seq, step)`` — the synthetic next-token function;
    ``steps`` — drain bound (a scheduler that cannot drain is itself a
    finding).

    Checked at every step: live block ownership disjoint across running
    sequences and equal to the allocator's ledger; every running
    sequence's block list covering its cached positions; ``NULL_BLOCK``
    never in a live block list; the allocator's own ``check``. At drain:
    every submitted request finished, zero leaked blocks. Returns problem
    strings (empty = invariants hold).
    """
    from repro_torch.serving.scheduler import NULL_BLOCK

    problems: list[str] = []
    bs = scheduler.block_size
    step = 0
    while not scheduler.idle() and step < steps and not problems:
        for seq in scheduler.admit(step):
            scheduler.record_token(seq, token_for(seq, step))
            if scheduler.should_retire(seq, None):
                scheduler.retire(seq, step)
        for slot in sorted(scheduler.running):
            seq = scheduler.running.get(slot)
            if seq is None or not scheduler.ensure_block(seq, step):
                continue
            scheduler.record_token(seq, token_for(seq, step))
            if scheduler.should_retire(seq, None):
                scheduler.retire(seq, step)

        owned_all: dict[int, int] = {}
        for seq in scheduler.running.values():
            if NULL_BLOCK in seq.blocks:
                problems.append(
                    f"step {step}: rid {seq.rid} holds NULL_BLOCK in a "
                    f"live block list"
                )
            need = seq.tokens_cached()
            have = len(seq.blocks) * bs
            if have < need:
                problems.append(
                    f"step {step}: rid {seq.rid} caches {need} positions "
                    f"but its table covers only {have}"
                )
            if sorted(seq.blocks) != scheduler.allocator.owned_by(seq.rid):
                problems.append(
                    f"step {step}: rid {seq.rid} block list "
                    f"{sorted(seq.blocks)} != allocator ledger "
                    f"{scheduler.allocator.owned_by(seq.rid)}"
                )
            for b in seq.blocks:
                if b in owned_all:
                    problems.append(
                        f"step {step}: block {b} owned by both rid "
                        f"{owned_all[b]} and rid {seq.rid}"
                    )
                owned_all[b] = seq.rid
        problems.extend(
            f"step {step}: {p}" for p in scheduler.allocator.check()
        )
        step += 1

    if not scheduler.idle() and not problems:
        problems.append(
            f"scheduler did not drain in {steps} steps "
            f"(running={sorted(s.rid for s in scheduler.running.values())})"
        )
    if scheduler.idle():
        leaked = scheduler.leaked_blocks()
        if leaked:
            problems.append(f"drained with {leaked} leaked blocks")
        unfinished = scheduler._seen_rids - set(scheduler.finished)
        if unfinished:
            problems.append(
                f"drained but requests never finished: {sorted(unfinished)}"
            )
    return problems


# the reference's two scenarios: a pool tight enough to preempt, and a
# roomy one; each seeds its workload with random.Random(name)
PAGED_SCENARIOS = {
    "tight-pool": dict(num_blocks=7, block_size=4, max_slots=3, max_blocks_per_seq=5),
    "roomy-pool": dict(num_blocks=64, block_size=8, max_slots=8, max_blocks_per_seq=None),
}


@register_rule("paged-gather-coverage", tier="plan")
def paged_gather_coverage(ctx: Context) -> list[Finding]:
    """The serving scheduler's block ledger upholds the gather contract.

    Replays the reference's seeded synthetic workloads (a pool tight
    enough to force preemption, a roomy one; mixed priorities) through the
    port's ``ContinuousBatchingScheduler`` (pure Python, device-free) and
    runs ``check_paged_coverage`` on each: paged ``decode_attention``'s
    block-table gather is only correct if ownership stays disjoint, tables
    cover the cached positions, and NULL_BLOCK stays out of live prefixes.
    """
    import random

    from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request

    def token_for(seq, step):
        return (seq.generated[-1] * 31 + 7) % 97 if seq.generated else 1

    out = []
    for name, kw in PAGED_SCENARIOS.items():
        rng = random.Random(name)
        sched = ContinuousBatchingScheduler(**kw)
        for rid in range(24):
            sched.submit(Request(
                rid=rid,
                prompt=tuple(rng.randrange(1, 97) for _ in range(rng.randrange(1, 9))),
                max_new_tokens=rng.randrange(1, 10),
                priority=rng.randrange(0, 3),
                arrival=rng.randrange(0, 12),
            ))
        for p in check_paged_coverage(sched, token_for):
            out.append(Finding("paged-gather-coverage", "repro_torch.serving.scheduler", 0,
                               f"[{name}] {p}"))
    return out
