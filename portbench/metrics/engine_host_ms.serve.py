"""engine_host_ms.serve: per engine step of the window, the host time of
``ServingEngine.step`` outside ``PagedModel.prefill`` and
``PagedModel.decode`` (the scheduler, the tables, the bookkeeping), in ms;
from the benchmark's spans around those calls."""
from portbench.lib.readers import window_spans


def read(run):
    steps = window_spans(run, "step")
    if not steps:
        return None
    inner = sum(window_spans(run, "prefill")) + sum(window_spans(run, "decode"))
    return 1e3 * (sum(steps) - inner) / len(steps)
