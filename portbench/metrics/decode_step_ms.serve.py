"""decode_step_ms.serve: the mean wall time of ``PagedModel.decode`` in the
window (one decode over every slot, ended by the logits' argmax copied to
the host), in ms."""
from portbench.lib.readers import window_spans


def read(run):
    d = window_spans(run, "decode")
    return 1e3 * sum(d) / len(d) if d else None
