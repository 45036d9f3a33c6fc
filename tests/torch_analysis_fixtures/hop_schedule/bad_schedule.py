"""Seeded-bad hop schedule: semaphore wait deferred past the fold.

``EVENTS`` issues hop 1's RDMA copy, folds hop 0, then folds hop 1
*before* waiting on the copy's semaphore. Replayed in program order the
fold happens to read the right buffer — but the landing is asynchronous:
in the interleaving where the fabric delivers late, the fold reads a
buffer whose copy has not landed. The plan tier's single-trace replay
flags the missing wait-before-fold ordering; the model tier's
``explore_hop_interleavings`` proves the *race* — it exhibits the legal
reordering in the finding's counterexample trace.

Imported by ``tests/test_torch_explore.py``; the ``overlap-interleavings``
engine must report exactly one race here and none on any published
``ring_schedule``.
"""
from repro_torch.parallel.collectives import HopEvent

HOPS = 2

EVENTS = (
    HopEvent("dma_start", 1, 0, 1),  # issue hop 1's copy into buffer 1
    HopEvent("fold", 0, 0),          # fold hop 0 from buffer 0
    HopEvent("fold", 1, 1),          # BUG: consumes buffer 1 pre-wait
    HopEvent("dma_wait", 1, None, 1),
)
