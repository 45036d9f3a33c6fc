"""mamba_step_ms.granite: per decode step of the traced slice, the host
time inside the program's ``mamba.step`` spans (each Mamba layer's decode
update: its projection, conv, scan step and gated norm), in ms."""
from portbench.lib import program_spans as ps


def read(run):
    steps = ps.named(run, "engine.decode")
    mamba = ps.named(run, "mamba.step")
    if not steps or not mamba:
        return None
    return 1e3 * ps.seconds(mamba) / len(steps)
