"""mfu.serve: the model FLOPs of every prompt token prefilled and every
token decoded in the window (projections, head, and attention over each
token's context) over the window at the card's bf16 peak, in percent."""
from portbench.lib.readers import mfu


def read(run):
    return mfu(run)
