"""idle_mamba.granite: percent of the traced slice in which no operation
ran on the card while the host was inside the program's ``mamba.step``
spans, placed on the trace's clock (``lib/program_spans.on_trace``)."""
from portbench.lib import program_spans as ps


def read(run):
    t = run.trace
    mamba = ps.named(run, "mamba.step")
    if t is None or not t.ops or not mamba:
        return None
    spans = [(max(s, t.start_ns), min(e, t.end_ns)) for s, e in ps.on_trace(run, mamba)]
    spans = [(s, e) for s, e in spans if e > s]
    idle_ns = sum(e - s for s, e in spans) - 1e9 * t.busy_s(within=spans)
    return 100.0 * idle_ns / 1e9 / t.window_s
