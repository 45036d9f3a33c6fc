"""Tier-C bounded model checking: exhaustive, device-free exploration.

A copy of the reference's ``analysis/explore.py`` (the engine and both
models unchanged, so their state counts are the reference's), held
against the port's own substrate: ``serving/scheduler.py`` and
``parallel/collectives.py``.

The AST tier reads source text and the plan tier checks one resolved
artifact; this tier closes the remaining gap — *concurrent* artifacts whose
bugs live in interleavings a single trace never exercises. Two systems are
modeled, both pure Python (no torch import anywhere in this module):

- :class:`SchedulerModel` — an abstract twin of
  ``serving.scheduler.ContinuousBatchingScheduler``. Every transition
  (submit / admit / decode-with-preemption) is a hashable
  ``(state, action) -> state`` step; the explorer enumerates *all* action
  interleavings for small bounded configs and checks the block-ledger
  safety invariants (no double alloc/free, no NULL_BLOCK ownership, slot
  cap, coverage) in every reached state plus a bounded-liveness starvation
  detector. The model is kept honest by a bisimulation test that drives it
  and the real scheduler through identical workloads via
  ``scheduler.apply_action`` / ``scheduler.canonical_state``.

- :func:`explore_hop_interleavings` — a race detector over
  ``collectives.ring_schedule``. The published ``HopEvent`` list fixes
  *program order*, but an RDMA copy (``dma_start`` … ``dma_wait``) lands
  asynchronously: its completion is a separate nondeterministic event the
  explorer may schedule anywhere after issue. A fold that reads a buffer
  whose copy has not landed in *some* legal reordering is a race, even if
  the single replayed trace (plan tier's ``check_hop_schedule``) is clean.

Both sit on one engine: :func:`explore` — depth-bounded DFS with memoized
canonical state hashing and an explicit :class:`Budget`, so CI runs are
deterministic and budget exhaustion is a reported outcome, never a silent
pass.
"""
from __future__ import annotations

import dataclasses

# mirrors serving/scheduler.py's NULL_BLOCK — NOT imported, so this module
# stays free of the port's package imports; tests pin the two together
NULL_BLOCK = 0


# -- budget + stats -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Budget:
    """Exploration ceiling: distinct canonical states and DFS depth.

    CI passes an explicit budget so the gate is deterministic; when either
    ceiling truncates the search the caller gets ``stats.truncated`` and
    must surface it (the CLI maps it to exit code 3 and a distinct
    ``budget-exhausted`` finding — an unexplored state space is an unknown,
    not a pass).
    """

    max_states: int = 200_000
    max_depth: int = 64

    @classmethod
    def parse(cls, text: str) -> "Budget":
        """Parse the CLI form ``STATES`` or ``STATES,DEPTH``."""
        parts = [p.strip() for p in str(text).split(",")]
        if len(parts) not in (1, 2) or not all(p.isdigit() for p in parts):
            raise ValueError(
                f"budget must be STATES or STATES,DEPTH, got {text!r}")
        states = int(parts[0])
        depth = int(parts[1]) if len(parts) == 2 else cls.max_depth
        if states < 1 or depth < 1:
            raise ValueError(f"budget values must be >= 1, got {text!r}")
        return cls(max_states=states, max_depth=depth)


@dataclasses.dataclass
class Stats:
    """Counters from one :func:`explore` run (surfaced in ``--format json``
    and the text summary — the >10^3-states acceptance evidence)."""

    states: int = 0  # distinct canonical states visited
    transitions: int = 0
    max_depth: int = 0
    truncated: bool = False
    violations: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def merge(self, other: "Stats") -> None:
        self.states += other.states
        self.transitions += other.transitions
        self.max_depth = max(self.max_depth, other.max_depth)
        self.truncated = self.truncated or other.truncated
        self.violations += other.violations


def _fmt_action(action) -> str:
    if isinstance(action, tuple):
        return (action[0] if len(action) == 1 else
                f"{action[0]}({','.join(str(a) for a in action[1:])})")
    return str(action)


def format_trace(trace) -> str:
    """Render a counterexample action sequence for a finding message."""
    return " ; ".join(_fmt_action(a) for a in trace)


# -- generic bounded explorer -------------------------------------------------


def explore(system, budget: Budget | None = None):
    """Exhaustively explore ``system``'s action graph within ``budget``.

    ``system`` protocol (all states hashable):

    - ``initial()`` -> state
    - ``actions(state)`` -> iterable of enabled actions
    - ``step(state, action)`` -> ``(state', problems)`` where ``problems``
      is a list of violation strings raised *by the transition itself*
    - ``check(state)`` -> list of invariant-violation strings
    - ``at_leaf(state)`` -> violations checked only where no action is
      enabled (drain/terminal conditions)

    Depth-bounded DFS with memoized canonical hashing: a state re-reached
    at a depth no smaller than before is not re-expanded. Each distinct
    problem string is reported once, annotated with the first
    counterexample action trace that produced it; a state that violates an
    invariant is not expanded further (one bug, one report — not a cascade
    of corrupted descendants). Returns ``(problems, stats)`` where
    ``problems`` is a sorted list of annotated violation strings.
    """
    budget = budget or Budget()
    stats = Stats()
    problems: dict[str, str] = {}  # key -> key + counterexample trace

    def note(key: str, trace) -> None:
        if key not in problems:
            problems[key] = (f"{key} [after: {format_trace(trace)}]"
                             if trace else key)

    init = system.initial()
    seen = {init: 0}  # state -> min depth reached at
    stats.states = 1
    init_bad = list(system.check(init))
    for p in init_bad:
        note(p, ())
    if not init_bad:
        if not list(system.actions(init)):
            for p in system.at_leaf(init):
                note(p, ())
        # frame: (state, enabled-actions list, next-action index)
        stack = [(init, list(system.actions(init)), 0)]
        trace: list = []
        while stack:
            state, acts, idx = stack[-1]
            if idx >= len(acts):
                stack.pop()
                if trace:
                    trace.pop()
                continue
            stack[-1] = (state, acts, idx + 1)
            action = acts[idx]
            nxt, step_bad = system.step(state, action)
            stats.transitions += 1
            bad = list(step_bad) + list(system.check(nxt))
            for p in bad:
                note(p, trace + [action])
            if bad:
                continue  # don't explore past a corrupted state
            depth = len(stack)
            prev = seen.get(nxt)
            if prev is not None and prev <= depth:
                continue
            if prev is None:
                if len(seen) >= budget.max_states:
                    stats.truncated = True
                    break
                stats.states += 1
            seen[nxt] = depth
            stats.max_depth = max(stats.max_depth, depth)
            nxt_acts = list(system.actions(nxt))
            if not nxt_acts:
                for p in system.at_leaf(nxt):
                    note(p, trace + [action])
                continue
            if depth >= budget.max_depth:
                stats.truncated = True
                continue
            stack.append((nxt, nxt_acts, 0))
            trace.append(action)
    stats.violations = len(problems)
    return sorted(problems.values()), stats


class System:
    """Optional base for explorable systems: no-op hooks."""

    def check(self, state):
        return []

    def at_leaf(self, state):
        return []


# -- scheduler model ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """Bounded-model request: like ``scheduler.Request`` but arrival-free
    (the *submit action's* position in the interleaving is the arrival)."""

    rid: int
    prompt_len: int
    max_new_tokens: int
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """One bounded configuration the model checker explores exhaustively."""

    num_blocks: int
    block_size: int
    max_slots: int
    requests: tuple  # of RequestSpec
    starvation_bound: int = 8  # max admit-pass bypasses while queued


# seq tuple layout inside a model state (see SchedulerModel docstring)
_RID, _GEN, _PRE, _RANK, _BLOCKS, _WAITED = range(6)


class SchedulerModel(System):
    """Abstract twin of ``ContinuousBatchingScheduler`` over immutable
    tuple states.

    State shape (everything hashable, absolute time abstracted away)::

        state   = (queues, running, pending, free, finished)
        queues  = ((priority, (seq, …)), …)   nonempty, ascending priority
        running = ((slot, seq), …)            ascending slot
        pending = (rid, …)                    submitted, not yet queued
        free    = (block, …)                  allocator FIFO order
        finished= (rid, …)                    sorted
        seq     = (rid, n_generated, preemptions, adm_rank, blocks, waited)

    ``adm_rank`` is the dense rank of the admission step over the running
    set (re-normalized after every transition), which preserves the
    most-recently-admitted victim ordering while merging states reached at
    different wall-steps. ``waited`` counts admit passes that admitted
    *someone else* while this sequence stayed queued — the bounded-liveness
    starvation detector (model-only; ``ledger_view`` strips it for
    comparison against ``scheduler.canonical_state``).

    Semantics mirror the real class exactly — FCFS within class, highest
    class first, head-of-line no-skip admission, FIFO block pool,
    lowest-priority most-recently-admitted victim, preempted sequences
    re-queued at the class *front* — and the bisimulation test in
    ``tests/test_explore.py`` holds the two in lock-step.
    """

    def __init__(self, config: SchedulerConfig):
        self.config = config
        self.specs = {r.rid: r for r in config.requests}
        if len(self.specs) != len(config.requests):
            raise ValueError("duplicate rids in config")
        limit = config.num_blocks - 1
        for r in config.requests:
            total = -(-(r.prompt_len + r.max_new_tokens) // config.block_size)
            if total > limit:
                raise ValueError(
                    f"request {r.rid} can never fit: needs {total} blocks, "
                    f"pool has {limit}")

    # -- state helpers --------------------------------------------------

    def initial(self):
        free = tuple(b for b in range(self.config.num_blocks)
                     if b != NULL_BLOCK)
        return ((), (), (), free, ())

    def _submitted_rids(self, state):
        queues, running, pending, _free, finished = state
        rids = set(pending) | set(finished)
        rids.update(s[_RID] for _p, seqs in queues for s in seqs)
        rids.update(s[_RID] for _slot, s in running)
        return rids

    def _needed_now(self, seq) -> int:
        """Blocks covering the cached prefix plus the next decode write
        (``Sequence.blocks_needed_now``); admission allocates at least 1."""
        spec = self.specs[seq[_RID]]
        pos = spec.prompt_len + seq[_GEN] - 1
        return max(1, pos // self.config.block_size + 1)

    def _normalize(self, queues, running, pending, free, finished):
        """Rebuild the canonical tuple state: drop empty classes, sort by
        slot, and re-compress adm_rank to dense ranks (rank order is
        preserved; same-rank ties stay tied)."""
        ranks = {r: i for i, r in enumerate(
            sorted({s[_RANK] for s in running.values()}))}
        run = tuple(
            (slot, s[:_RANK] + (ranks[s[_RANK]],) + s[_RANK + 1:])
            for slot, s in sorted(running.items()))
        q = tuple((prio, tuple(seqs)) for prio, seqs in sorted(queues.items())
                  if seqs)
        return (q, run, tuple(pending), tuple(free), tuple(sorted(finished)))

    # -- actions --------------------------------------------------------

    def actions(self, state):
        queues, running, pending, _free, _finished = state
        acts = [("submit", rid) for rid in sorted(
            set(self.specs) - self._submitted_rids(state))]
        if pending or queues:
            acts.append(("admit",))
        acts.extend(("decode", slot) for slot, _s in running)
        return acts

    def step(self, state, action):
        nxt, problems, _admits = self.apply(state, action)
        return nxt, problems

    def apply(self, state, action):
        """Like :meth:`step` but also returns the ``(rid, slot)`` pairs an
        admit pass admitted — the bisimulation test compares them against
        ``scheduler.apply_action``'s return value."""
        kind = action[0]
        if kind == "submit":
            return self._submit(state, action[1])
        if kind == "admit":
            return self._admit(state)
        if kind == "decode":
            return self._decode(state, action[1])
        raise ValueError(f"unknown action {action!r}")

    # -- transitions ----------------------------------------------------

    def _submit(self, state, rid):
        queues, running, pending, free, finished = state
        nxt = (queues, running, pending + (rid,), free, finished)
        return nxt, [], []

    def _fresh_seq(self, rid):
        return (rid, 0, 0, -1, (), 0)

    def _admit(self, state):
        queues_t, running_t, pending, free_t, finished = state
        queues = {prio: list(seqs) for prio, seqs in queues_t}
        for rid in pending:  # all pending arrive: submit stamped arrival=now
            prio = self.specs[rid].priority
            queues.setdefault(prio, []).append(self._fresh_seq(rid))
        running = dict(running_t)
        free = list(free_t)
        new_rank = 1 + max((s[_RANK] for s in running.values()), default=-1)
        admitted = []
        problems = []
        while True:
            if len(running) >= self.config.max_slots:
                break
            prios = [p for p in sorted(queues, reverse=True) if queues[p]]
            if not prios:
                break
            head = queues[prios[0]][0]
            n = self._needed_now(head)
            if len(free) < n:
                break  # head-of-line short on blocks: FCFS, no skip
            queues[prios[0]].pop(0)
            blocks, free = tuple(free[:n]), free[n:]
            slot = min(s for s in range(self.config.max_slots)
                       if s not in running)
            running[slot] = (head[_RID], head[_GEN], head[_PRE], new_rank,
                             blocks, 0)
            admitted.append((head[_RID], slot))
        if admitted:  # bounded liveness: queued seqs were bypassed
            bound = self.config.starvation_bound
            for prio, seqs in queues.items():
                for i, s in enumerate(seqs):
                    waited = min(s[_WAITED] + 1, bound + 1)
                    if waited > bound:
                        problems.append(
                            f"starvation: rid {s[_RID]} bypassed by "
                            f"{bound + 1} admit passes while queued")
                    seqs[i] = s[:_WAITED] + (waited,)
        else:
            # admission progress: if the policy's next pick has a slot and
            # blocks, the pass must not leave it queued
            prios = [p for p in sorted(queues, reverse=True) if queues[p]]
            if (prios and len(running) < self.config.max_slots
                    and len(free) >= self._needed_now(queues[prios[0]][0])):
                problems.append(
                    f"admit pass left admissible head rid "
                    f"{queues[prios[0]][0][_RID]} queued")
        nxt = self._normalize(queues, running, pending=(), free=free,
                              finished=finished)
        return nxt, problems, admitted

    def _pick_victim(self, running):
        """Slot of the lowest-priority most-recently-admitted sequence
        (``adm_rank`` orders exactly like ``admitted_at``; rank ties — same
        admit pass — break by rid, as in the real scheduler)."""
        return max(running, key=lambda slot: (
            -self.specs[running[slot][_RID]].priority,
            running[slot][_RANK], running[slot][_RID]))

    def _requeue_front(self, queues, seq):
        """Preemption re-entry: the FRONT of the class queue — combined
        with FCFS admission this is what bounds bypasses (a model that
        appends instead drifts from the real scheduler and is caught by
        the bisimulation test)."""
        prio = self.specs[seq[_RID]].priority
        queues.setdefault(prio, []).insert(0, seq)

    def _preempt(self, queues, running, free, vslot, vblocks):
        """Evict the victim in ``vslot``: release ``vblocks`` to the pool
        and re-queue it at its class front with the generated prefix kept.
        A method (not inlined in ``_decode``) so seeded-bad fixtures can
        break exactly this transition — the double-free fixture overrides
        it to release the blocks twice."""
        victim = running.pop(vslot)
        free.extend(vblocks)
        self._requeue_front(queues, (
            victim[_RID], victim[_GEN], victim[_PRE] + 1, -1, (),
            victim[_WAITED]))

    def _decode(self, state, slot):
        queues_t, running_t, pending, free_t, finished = state
        queues = {prio: list(seqs) for prio, seqs in queues_t}
        running = dict(running_t)
        free = list(free_t)
        problems: list = []
        seq = running[slot]
        spec = self.specs[seq[_RID]]
        pos = spec.prompt_len + seq[_GEN] - 1
        blocks = list(seq[_BLOCKS])
        preempted_self = False
        while pos // self.config.block_size >= len(blocks):
            if free:
                blocks.append(free.pop(0))
                continue
            vslot = self._pick_victim(running)
            # a self-victim releases its *grown* table, not the stale one
            vblocks = (tuple(blocks) if vslot == slot
                       else running[vslot][_BLOCKS])
            self._preempt(queues, running, free, vslot, vblocks)
            if vslot == slot:
                preempted_self = True
                break
        if not preempted_self:
            gen = seq[_GEN] + 1
            if gen >= spec.max_new_tokens:  # retire
                free.extend(blocks)
                finished = finished + (seq[_RID],)
                del running[slot]
            else:
                running[slot] = (seq[_RID], gen, seq[_PRE], seq[_RANK],
                                 tuple(blocks), seq[_WAITED])
        nxt = self._normalize(queues, running, pending, free, finished)
        return nxt, problems, []

    # -- invariants -----------------------------------------------------

    def check(self, state):
        queues, running, pending, free, finished = state
        problems = []
        cfg = self.config
        pool = set(range(cfg.num_blocks)) - {NULL_BLOCK}
        if len(set(free)) != len(free):
            problems.append("double-free: duplicate blocks on the free list")
        live: list = []
        for _slot, s in running:
            live.extend(s[_BLOCKS])
            if len(set(s[_BLOCKS])) != len(s[_BLOCKS]):
                problems.append(
                    f"double-alloc: rid {s[_RID]} holds a block twice")
        if len(set(live)) != len(live):
            problems.append("double-alloc: block owned by two sequences")
        if NULL_BLOCK in set(free) | set(live):
            problems.append("NULL_BLOCK entered the pool or a block table")
        stray = (set(free) | set(live)) - pool
        if stray - {NULL_BLOCK}:
            problems.append(f"blocks outside the pool: {sorted(stray)}")
        if set(free) & set(live):
            problems.append(
                f"double-free: blocks both free and owned: "
                f"{sorted(set(free) & set(live))}")
        if len(free) + len(set(live)) != len(pool):
            n = len(free) + len(set(live))
            word = "leak" if n < len(pool) else "double-entry"
            problems.append(
                f"ledger {word}: free+owned covers {n} block slots, the "
                f"pool has {len(pool)}")
        if len(running) > cfg.max_slots:
            problems.append(
                f"slot overflow: {len(running)} running > "
                f"max_slots={cfg.max_slots}")
        if len({slot for slot, _s in running}) != len(running):
            problems.append("two sequences share a decode slot")
        for _slot, s in running:
            spec = self.specs[s[_RID]]
            cached = spec.prompt_len + max(0, s[_GEN] - 1)
            if len(s[_BLOCKS]) * cfg.block_size < cached:
                problems.append(
                    f"coverage: rid {s[_RID]} cached {cached} tokens in "
                    f"{len(s[_BLOCKS])} block(s)")
        for _prio, seqs in queues:
            for s in seqs:
                if s[_BLOCKS]:
                    problems.append(
                        f"queued rid {s[_RID]} still owns blocks")
        rids = list(pending) + list(finished)
        rids += [s[_RID] for _p, seqs in queues for s in seqs]
        rids += [s[_RID] for _slot, s in running]
        if len(set(rids)) != len(rids):
            problems.append("rid present in two lifecycle stages at once")
        return problems

    def at_leaf(self, state):
        _queues, _running, _pending, free, finished = state
        problems = []
        if set(finished) != set(self.specs):
            problems.append(
                f"drained without finishing rids "
                f"{sorted(set(self.specs) - set(finished))}")
        if set(free) != set(range(self.config.num_blocks)) - {NULL_BLOCK}:
            problems.append("drained with blocks missing from the pool")
        return problems

    # -- bisimulation seam ----------------------------------------------

    @staticmethod
    def ledger_view(state):
        """State minus the model-only ``waited`` counters — directly
        comparable with ``scheduler.canonical_state(sched)``."""
        queues, running, pending, free, finished = state
        strip = lambda s: s[:_WAITED]  # noqa: E731 - local tuple slicer
        q = tuple((prio, tuple(strip(s) for s in seqs))
                  for prio, seqs in queues)
        run = tuple((slot, strip(s)) for slot, s in running)
        return (q, run, pending, free, finished)


# the bounded configs the `scheduler-model` rule explores exhaustively:
# small enough to finish inside the CI budget, rich enough to reach
# admission-blocking, preemption chains, self-preemption and drains
# (together >10^3 distinct canonical states — asserted by the tests)
SCHEDULER_CONFIGS = (
    ("tight-pool", SchedulerConfig(
        num_blocks=5, block_size=1, max_slots=2, requests=(
            RequestSpec(rid=0, prompt_len=1, max_new_tokens=3, priority=0),
            RequestSpec(rid=1, prompt_len=2, max_new_tokens=2, priority=0),
            RequestSpec(rid=2, prompt_len=1, max_new_tokens=2, priority=1),
        ))),
    ("mixed-priority", SchedulerConfig(
        num_blocks=6, block_size=2, max_slots=3, requests=(
            RequestSpec(rid=0, prompt_len=2, max_new_tokens=4, priority=0),
            RequestSpec(rid=1, prompt_len=1, max_new_tokens=2, priority=2),
            RequestSpec(rid=2, prompt_len=3, max_new_tokens=3, priority=1),
            RequestSpec(rid=3, prompt_len=1, max_new_tokens=1, priority=0),
        ))),
)


# -- overlap hop-schedule interleavings ---------------------------------------


class HopInterleavings(System):
    """All legal reorderings of one ``ring_schedule`` event list.

    Core events (send / fold / dma_start / dma_wait) execute in program
    order — that part the schedule fixes. What it does NOT fix is when an
    RDMA copy *lands*: ``dma_start`` only issues the descriptor, so the
    landing is modeled as a separate ``("land", hop)`` action the explorer
    may interleave anywhere after issue. ``dma_wait`` is the only ordering
    edge — it blocks until its hop has landed. A fold whose buffer version
    is wrong in any reachable interleaving is a race: with the events as
    published, some legal DMA timing lets the fold read hop t's buffer
    before the copy completed (or after a later copy clobbered it).

    State: ``(pc, versions, landed, inflight)`` with ``versions`` the
    (buffer -> hop) map as a sorted tuple. Synchronous sends update the
    version at execution; DMA copies update it at *landing*.
    """

    def __init__(self, events, hops: int):
        self.events = tuple(events)
        self.hops = hops
        # folds completed before each pc (length len+1: landings can be
        # scheduled after the last core event), in program order —
        # pc-derived, so it stays out of the hashed state
        folded = set()
        self._folded_before = [frozenset(folded)]
        for ev in self.events:
            if ev.kind == "fold":
                folded.add(ev.hop)
            self._folded_before.append(frozenset(folded))

    def initial(self):
        # buffer 0 starts holding the local shard: hop 0, already arrived
        return (0, ((0, 0),), (), ())

    def actions(self, state):
        pc, _versions, landed, inflight = state
        acts = [("land", hop, dst) for dst, hop in inflight]
        if pc < len(self.events):
            ev = self.events[pc]
            if ev.kind == "dma_wait":
                # enabled only once the copy landed; a wait with no issued
                # copy at all is a structural bug -> let it execute and flag
                if ev.hop in landed or not any(
                        h == ev.hop for _d, h in inflight):
                    acts.append(("exec",))
            else:
                acts.append(("exec",))
        return acts

    def step(self, state, action):
        pc, versions_t, landed, inflight = state
        versions = dict(versions_t)
        problems = []
        folded = self._folded_before[pc]
        if action[0] == "land":
            hop, dst = action[1], action[2]
            old = versions.get(dst)
            if old is not None and old not in folded and old != hop:
                problems.append(
                    f"hop {hop} copy lands over buffer {dst} while hop "
                    f"{old} is still unfolded (fold races the DMA)")
            versions[dst] = hop
            landed = tuple(sorted(set(landed) | {hop}))
            inflight = tuple(p for p in inflight if p != (dst, hop))
            return self._pack(pc, versions, landed, inflight), problems
        ev = self.events[pc]
        if ev.kind == "send":
            if versions.get(ev.src) != ev.hop - 1:
                problems.append(
                    f"send of hop {ev.hop} reads buffer {ev.src} holding "
                    f"hop {versions.get(ev.src)}")
            old = versions.get(ev.dst)
            if old is not None and old not in folded:
                problems.append(
                    f"send of hop {ev.hop} overwrites buffer {ev.dst} "
                    f"while hop {old} is still unfolded")
            versions[ev.dst] = ev.hop  # synchronous: arrives at execution
        elif ev.kind == "dma_start":
            if versions.get(ev.src) != ev.hop - 1:
                problems.append(
                    f"dma_start of hop {ev.hop} reads buffer {ev.src} "
                    f"holding hop {versions.get(ev.src)}")
            inflight = inflight + ((ev.dst, ev.hop),)
        elif ev.kind == "dma_wait":
            if ev.hop not in landed:
                # only reachable when no matching dma_start was issued
                problems.append(
                    f"dma_wait for hop {ev.hop} has no matching dma_start")
        elif ev.kind == "fold":
            got = versions.get(ev.src)
            if got != ev.hop:
                inflt = any(h == ev.hop for _d, h in inflight)
                why = ("its copy has not landed" if inflt else
                       f"the buffer holds hop {got}")
                problems.append(
                    f"fold of hop {ev.hop} races buffer {ev.src}: {why} "
                    f"in a legal interleaving")
        return self._pack(pc + 1, versions, landed, inflight), problems

    @staticmethod
    def _pack(pc, versions, landed, inflight):
        return (pc, tuple(sorted(versions.items())), tuple(sorted(landed)),
                tuple(sorted(inflight)))

def explore_hop_interleavings(events, hops: int,
                              budget: Budget | None = None):
    """Race-check one hop schedule under all legal DMA timings.

    Static shape checks run first — every hop folded exactly once, every
    issued copy eventually waited on (an un-waited DMA can land after the
    schedule "completes") — then :func:`explore` enumerates the
    interleavings. Returns ``(problems, stats)`` like :func:`explore`.
    """
    problems = []
    fold_counts: dict[int, int] = {}
    started: list[int] = []
    waited: list[int] = []
    for ev in events:
        if ev.kind == "fold":
            fold_counts[ev.hop] = fold_counts.get(ev.hop, 0) + 1
        elif ev.kind == "dma_start":
            started.append(ev.hop)
        elif ev.kind == "dma_wait":
            waited.append(ev.hop)
    for hop in range(hops):
        n = fold_counts.pop(hop, 0)
        if n != 1:
            problems.append(f"hop {hop} folded {n} times (expected once)")
    for hop, n in sorted(fold_counts.items()):
        problems.append(f"fold of out-of-range hop {hop} (x{n})")
    for hop in sorted(set(started) - set(waited)):
        problems.append(
            f"dma_start of hop {hop} has no dma_wait — the copy can land "
            f"at any point after the schedule ends")
    explored, stats = explore(HopInterleavings(events, hops), budget)
    stats.violations += len(problems)
    return problems + explored, stats
