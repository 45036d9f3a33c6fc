"""pages_host_ms.serve: per decode step of the traced slice, the host time
inside the program's ``decode.pages`` spans (each layer's paged decode
attention, ``transformer.attention_decode_paged``), in ms."""
from portbench.lib import program_spans as ps


def read(run):
    steps = ps.named(run, "engine.decode")
    if not steps:
        return None
    return 1e3 * ps.seconds(ps.named(run, "decode.pages")) / len(steps)
