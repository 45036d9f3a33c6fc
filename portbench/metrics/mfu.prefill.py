"""mfu.prefill: the model FLOPs of every forward the window completed
(projections, head and causal attention, ``lib/counts.prefill_flops``)
over the window at the card's bf16 peak, in percent."""
from portbench.lib.readers import mfu


def read(run):
    return mfu(run)
