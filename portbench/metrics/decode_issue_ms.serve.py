"""decode_issue_ms.serve: per decode step of the traced slice, the host
time of the program's ``engine.decode`` span less its ``decode.fetch``
(the argmax copied to the host, where the host waits on the card): the
host issuing the step's work, in ms."""
from portbench.lib import program_spans as ps


def read(run):
    steps = ps.named(run, "engine.decode")
    if not steps:
        return None
    ids = {r.id for r in steps}
    fetch = [r for r in ps.named(run, "decode.fetch") if r.parent in ids]
    return 1e3 * (ps.seconds(steps) - ps.seconds(fetch)) / len(steps)
