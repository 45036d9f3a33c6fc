"""Seeded-bad scheduler model: double-free on preempt.

``BadPreemptModel`` overrides ``SchedulerModel._preempt`` to release the
victim's blocks to the free list TWICE — the classic paged-cache ledger
bug where the eviction path both pushes the blocks and forgets they were
already pushed. Only an interleaving that actually *preempts* exposes it,
which is exactly what the exhaustive explorer finds and a happy-path
trace never does.

Imported (not just parsed) by ``tests/test_torch_explore.py``: the
``scheduler-model`` rule's engine must report the double-free with an
exact finding count on ``CONFIG`` and stay silent on the pristine model.
"""
from repro_torch.analysis.explore import RequestSpec, SchedulerConfig, SchedulerModel

# tight pool + two slots so decode growth must evict: rid 0 holds two
# blocks across steps (max_new 3 keeps it non-terminal) while rid 1's two
# admission blocks drain the pool, so rid 0's third-block growth preempts
# — and every preemption goes through the seeded-bad release path
CONFIG = SchedulerConfig(
    num_blocks=5, block_size=1, max_slots=2, requests=(
        RequestSpec(rid=0, prompt_len=1, max_new_tokens=3, priority=0),
        RequestSpec(rid=1, prompt_len=2, max_new_tokens=2, priority=0),
    ))


class BadPreemptModel(SchedulerModel):
    """SchedulerModel whose preempt path frees the victim's blocks twice."""

    def _preempt(self, queues, running, free, vslot, vblocks):
        super()._preempt(queues, running, free, vslot, vblocks)
        free.extend(vblocks)  # the bug: released again
