"""first_token_hold_ms.serve: the mean, over the requests prefilled in the
traced slice, of the time from the end of a request's ``engine.prefill``
span, when its first token exists, to the end of the ``engine.step`` span
that holds it, when the engine hands it out, in ms."""
from portbench.lib import program_spans as ps


def read(run):
    steps = {r.id: r for r in ps.named(run, "engine.step")}
    holds = [steps[r.parent].end - r.end for r in ps.named(run, "engine.prefill")
             if r.parent in steps]
    return sum(holds) / len(holds) / 1e6 if holds else None
