"""Continuous-batching request scheduler (host side, deterministic).

Pure Python on purpose: no jax import, no device state. The scheduler owns
*bookkeeping only* — request queues, decode slots, and the physical cache
block ledger — and emits an ordered event trace; the engine owns the
tensors. That split is what makes the continuous-batching invariants
checkable device-free: the test battery and the ``paged-gather-coverage``
analysis rule replay synthetic workloads through this exact class and
audit the trace (ownership disjointness, FCFS admission, zero leaks)
without compiling anything.

Lifecycle of a request::

    WAITING --admit--> RUNNING --retire--> FINISHED
       ^                  |
       +----preempt-------+   (block exhaustion: blocks freed, request
                               re-queued at the FRONT of its priority
                               class with its generated prefix kept)

Scheduling policy, all deterministic:

  - admission is FCFS *within* a priority class; classes are served
    highest priority first (ties broken by arrival step, then request id)
  - a request is admitted only when a decode slot is free AND the
    allocator can cover its prompt plus one decode block
  - on block exhaustion the victim is the lowest-priority
    most-recently-admitted running sequence (LIFO within class), so the
    oldest work is never starved by the newest
  - preempted requests re-enter at the front of their class queue:
    combined with FCFS admission this bounds bypasses, so every admitted
    request eventually finishes (the no-starvation test's invariant)
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

# physical block 0 is the shared scratch page: inactive decode-slot rows and
# unwritten block-table tail entries point at it, live prefixes never do
NULL_BLOCK = 0

WAITING, RUNNING, FINISHED = "WAITING", "RUNNING", "FINISHED"


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is the open-loop arrival time in
    engine *steps* (virtual time, so admission traces are seed-reproducible
    across machines); ``priority`` is higher-wins."""

    rid: int
    prompt: tuple
    max_new_tokens: int
    priority: int = 0
    arrival: int = 0

    def __post_init__(self):
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")


@dataclasses.dataclass
class Sequence:
    """Scheduler-side state of one admitted (or re-queued) request."""

    req: Request
    slot: int | None = None
    blocks: list = dataclasses.field(default_factory=list)
    generated: list = dataclasses.field(default_factory=list)
    admitted_at: int = -1  # step of the most recent admission (LIFO victim key)
    preemptions: int = 0
    saved_payload: object = None  # engine's host copy of the KV blocks

    @property
    def rid(self):
        return self.req.rid

    def tokens_cached(self) -> int:
        """Tokens whose KV lives in cache blocks: the prompt plus every
        generated token except the newest (written by the NEXT decode)."""
        return len(self.req.prompt) + max(0, len(self.generated) - 1)

    def next_position(self) -> int:
        """Absolute position of the token the next decode step processes."""
        return len(self.req.prompt) + len(self.generated) - 1

    def blocks_needed_now(self, block_size: int):
        """Logical block indices covering the cached prefix plus the token
        the next decode writes."""
        return list(range(self.next_position() // block_size + 1))


class BlockAllocator:
    """Fixed-pool physical block ledger. FIFO free list (deterministic),
    with ``NULL_BLOCK`` permanently reserved as the scratch page."""

    def __init__(self, num_blocks: int, *, reserved=(NULL_BLOCK,)):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (one is the null page)")
        self.num_blocks = num_blocks
        self.reserved = tuple(sorted(set(reserved)))
        self.free = deque(
            b for b in range(num_blocks) if b not in self.reserved
        )
        self.owner: dict[int, int] = {}  # block -> rid

    def available(self) -> int:
        return len(self.free)

    def alloc(self, rid: int, n: int):
        """Pop ``n`` blocks for ``rid``; None (nothing popped) if short."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if len(self.free) < n:
            return None
        got = [self.free.popleft() for _ in range(n)]
        for b in got:
            self.owner[b] = rid
        return got

    def release(self, rid: int, blocks) -> None:
        for b in blocks:
            if self.owner.get(b) != rid:
                raise RuntimeError(
                    f"release: block {b} not owned by rid {rid} "
                    f"(owner={self.owner.get(b)})"
                )
            del self.owner[b]
            self.free.append(b)

    def owned_by(self, rid: int):
        return sorted(b for b, r in self.owner.items() if r == rid)

    def check(self):
        """Ledger self-audit: free + owned partitions the non-reserved pool."""
        problems = []
        free = list(self.free)
        owned = set(self.owner)
        if len(set(free)) != len(free):
            problems.append("duplicate blocks on the free list")
        if owned & set(free):
            problems.append(f"blocks both free and owned: {owned & set(free)}")
        if set(self.reserved) & (owned | set(free)):
            problems.append("reserved block leaked into the pool")
        pool = set(range(self.num_blocks)) - set(self.reserved)
        if (set(free) | owned) != pool:
            problems.append(
                f"pool not partitioned: missing {pool - set(free) - owned}"
            )
        return problems


class ContinuousBatchingScheduler:
    """Queues + slots + block ledger for the continuous-batching engine.

    The engine drives it step by step: ``submit`` requests (any time),
    ``admit(step)`` to fill free slots from the queues, ``ensure_block``
    before each sequence's decode (triggering preemption on exhaustion),
    ``record_token`` after, ``retire`` on EOS/max-len. Every transition
    appends to ``events`` — the reproducible admission trace the bench
    hashes and the analysis rule audits.
    """

    def __init__(self, *, num_blocks: int, block_size: int, max_slots: int,
                 max_blocks_per_seq: int | None = None):
        if block_size < 1 or max_slots < 1:
            raise ValueError("block_size and max_slots must be >= 1")
        self.block_size = block_size
        self.max_slots = max_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.allocator = BlockAllocator(num_blocks)
        self.pending: list[Request] = []  # submitted, arrival in the future
        self.queues: dict[int, deque] = {}  # priority -> deque[Sequence]
        self.running: dict[int, Sequence] = {}  # slot -> Sequence
        self.finished: dict[int, Sequence] = {}
        self.events: list[tuple] = []
        self._seen_rids: set[int] = set()

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.rid in self._seen_rids:
            raise ValueError(f"duplicate rid {req.rid}")
        self._seen_rids.add(req.rid)
        total = math.ceil(
            (len(req.prompt) + req.max_new_tokens) / self.block_size
        )
        cap = self.max_blocks_per_seq or (self.allocator.num_blocks - 1)
        limit = min(cap, self.allocator.num_blocks - 1)
        if total > limit:
            raise ValueError(
                f"request {req.rid} can never fit: needs {total} blocks, "
                f"per-sequence limit is {limit}"
            )
        self.pending.append(req)
        self.events.append(("submit", req.arrival, req.rid))

    def blocks_for_prompt(self, prompt_len: int) -> int:
        return math.ceil(prompt_len / self.block_size)

    # -- admission ----------------------------------------------------------

    def _queue_for(self, priority: int) -> deque:
        return self.queues.setdefault(priority, deque())

    def _free_slot(self):
        for s in range(self.max_slots):
            if s not in self.running:
                return s
        return None

    def admit(self, step: int):
        """Move arrived requests into the queues, then admit queue heads
        while a slot and enough blocks exist. Returns the admitted
        ``Sequence`` list in admission order (FCFS within class, highest
        class first); resumed sequences carry their generated prefix and
        ``saved_payload`` for the engine to restore."""
        still_pending = []
        arrivals = []
        for req in self.pending:
            (arrivals if req.arrival <= step else still_pending).append(req)
        self.pending = still_pending
        arrivals.sort(key=lambda r: (r.arrival, r.rid))
        for req in arrivals:
            self._queue_for(req.priority).append(Sequence(req))

        admitted = []
        while True:
            seq = self._next_admittable()
            if seq is None:
                break
            slot = self._free_slot()
            n = max(1, len(seq.blocks_needed_now(self.block_size)))
            got = self.allocator.alloc(seq.rid, n)
            if got is None:  # head-of-line blocks short: stop (FCFS, no skip)
                self._queue_for(seq.req.priority).appendleft(seq)
                break
            seq.slot = slot
            seq.blocks = got
            seq.admitted_at = step
            self.running[slot] = seq
            admitted.append(seq)
            self.events.append(
                ("admit", step, seq.rid, slot, tuple(got), seq.preemptions)
            )
        return admitted

    def _next_admittable(self):
        if self._free_slot() is None:
            return None
        for prio in sorted(self.queues, reverse=True):
            q = self.queues[prio]
            if q:
                return q.popleft()
        return None

    # -- block growth + preemption ------------------------------------------

    def ensure_block(self, seq: Sequence, step: int) -> bool:
        """Guarantee a cache block exists for the position ``seq``'s next
        decode writes. On exhaustion, preempt victims (lowest priority,
        most recently admitted) until space frees — possibly ``seq``
        itself, in which case False is returned and the engine must skip
        its decode this step."""
        pos = seq.next_position()
        if self.max_blocks_per_seq and (
            pos // self.block_size >= self.max_blocks_per_seq
        ):
            raise RuntimeError(
                f"rid {seq.rid}: position {pos} exceeds max_blocks_per_seq"
            )
        while pos // self.block_size >= len(seq.blocks):
            got = self.allocator.alloc(seq.rid, 1)
            if got is not None:
                seq.blocks.extend(got)
                self.events.append(("grow", step, seq.rid, got[0]))
                continue
            victim = self._pick_victim()
            self.preempt(victim, step)
            if victim is seq:
                return False
        return True

    def _pick_victim(self) -> Sequence:
        # lowest priority first, then most recently admitted, then rid
        return max(
            self.running.values(),
            key=lambda s: (-s.req.priority, s.admitted_at, s.rid),
        )

    def preempt(self, seq: Sequence, step: int) -> None:
        """Release ``seq``'s slot and blocks and re-queue it at the FRONT
        of its class. The engine saves/restores the KV payload around this
        (``Sequence.saved_payload``)."""
        del self.running[seq.slot]
        freed = tuple(seq.blocks)
        self.allocator.release(seq.rid, seq.blocks)
        self.events.append(("preempt", step, seq.rid, seq.slot, freed))
        seq.blocks = []
        seq.slot = None
        seq.preemptions += 1
        self._queue_for(seq.req.priority).appendleft(seq)

    # -- completion ---------------------------------------------------------

    def record_token(self, seq: Sequence, token: int) -> None:
        seq.generated.append(int(token))

    def should_retire(self, seq: Sequence, eos_id: int | None) -> bool:
        if len(seq.generated) >= seq.req.max_new_tokens:
            return True
        return eos_id is not None and bool(seq.generated) and (
            seq.generated[-1] == eos_id
        )

    def retire(self, seq: Sequence, step: int) -> None:
        del self.running[seq.slot]
        freed = tuple(seq.blocks)
        self.allocator.release(seq.rid, seq.blocks)
        self.events.append(("retire", step, seq.rid, seq.slot, freed))
        seq.blocks = []
        self.finished[seq.rid] = seq

    # -- introspection ------------------------------------------------------

    def idle(self) -> bool:
        return not (self.pending or self.running
                    or any(self.queues.values()))

    def leaked_blocks(self) -> int:
        """Blocks neither free nor owned by a live sequence (must be 0)."""
        live = {b for s in self.running.values() for b in s.blocks}
        return (self.allocator.num_blocks - len(self.allocator.reserved)
                - self.allocator.available() - len(live))

    def admission_trace(self):
        """The (step, rid, slot) admission order — the seed-reproducible
        artifact the bench hashes and CI pins."""
        return tuple(
            (e[1], e[2], e[3]) for e in self.events if e[0] == "admit"
        )


# -- first-class transitions (tier-C model-checking seam) ---------------------
#
# The engine drives the scheduler through fine-grained method calls
# (submit / admit / ensure_block / record_token / retire). For exhaustive
# exploration those calls are regrouped into three *atomic actions* — the
# smallest steps whose interleavings are externally schedulable:
#
#   ("submit", rid)   submit request ``rid`` with arrival = current step
#   ("admit",)        one admission pass (arrivals -> queues -> slots)
#   ("decode", slot)  one decode step for the sequence in ``slot``:
#                     ensure_block (may preempt, possibly itself) then
#                     record_token and retire when max_new_tokens is hit
#
# ``apply_action`` applies one action to a live scheduler; ``canonical_state``
# hashes the resulting ledger into the same tuple shape the abstract model in
# ``analysis.explore`` uses, so the bisimulation test can assert, transition
# by transition, that the checked model never drifts from this class.

ACTIONS = ("submit", "admit", "decode")


def default_token(seq: Sequence) -> int:
    """Deterministic token stream for model checking: 1, 2, 3, … per
    sequence. Token *values* never influence scheduling (eos is disabled),
    so any fixed stream explores the full reachable ledger space."""
    return len(seq.generated) + 1


def apply_action(sched: ContinuousBatchingScheduler, action: tuple,
                 step: int, *, requests, token_for=default_token):
    """Apply one atomic ``(state, action) -> state`` transition.

    ``requests`` maps rid -> :class:`Request` template; submits stamp the
    template's arrival to ``step`` so the request is immediately
    admissible. Returns the admitted ``(rid, slot)`` pairs for an admit
    action (the bisimulation test compares these against the abstract
    model's), else an empty list.
    """
    kind = action[0]
    if kind == "submit":
        req = requests[action[1]]
        sched.submit(dataclasses.replace(req, arrival=step))
        return []
    if kind == "admit":
        return [(seq.rid, seq.slot) for seq in sched.admit(step)]
    if kind == "decode":
        seq = sched.running[action[1]]
        if not sched.ensure_block(seq, step):
            return []  # preempted itself: the engine skips its decode
        sched.record_token(seq, token_for(seq))
        if sched.should_retire(seq, None):
            sched.retire(seq, step)
        return []
    raise ValueError(f"unknown action {action!r}")


def canonical_state(sched: ContinuousBatchingScheduler):
    """Hashable canonical ledger state, absolute time abstracted away.

    ``admitted_at`` steps are compressed to dense ranks over the running
    set (ties — same admit call — share a rank), which preserves the
    ``_pick_victim`` ordering while letting states reached at different
    wall-steps merge. Shape matches ``analysis.explore.SchedulerModel``'s
    ``ledger_view`` exactly::

        (queues, running, pending, free, finished)
        queues  = ((priority, (seq, …)), …)    nonempty, ascending priority
        running = ((slot, seq), …)             ascending slot
        seq     = (rid, n_generated, preemptions, adm_rank, blocks)
    """
    ranks = {at: i for i, at in enumerate(
        sorted({s.admitted_at for s in sched.running.values()}))}

    def seq_t(s: Sequence, rank: int):
        return (s.rid, len(s.generated), s.preemptions, rank,
                tuple(s.blocks))

    queues = tuple(
        (prio, tuple(seq_t(s, -1) for s in sched.queues[prio]))
        for prio in sorted(sched.queues) if sched.queues[prio]
    )
    running = tuple(
        (slot, seq_t(s, ranks[s.admitted_at]))
        for slot, s in sorted(sched.running.items())
    )
    pending = tuple(r.rid for r in
                    sorted(sched.pending, key=lambda r: (r.arrival, r.rid)))
    return (queues, running, pending, tuple(sched.allocator.free),
            tuple(sorted(sched.finished)))
