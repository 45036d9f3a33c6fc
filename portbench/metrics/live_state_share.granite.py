"""live_state_share.granite: the slot states the traced slice's decodes
needed (the active slots') over those they read and wrote (every slot's),
from the program's ``state_live`` and ``state_rows`` counters on its
``engine.decode`` spans, in percent."""
from portbench.lib import program_spans as ps


def read(run):
    steps = ps.named(run, "engine.decode")
    rows = sum(r.attrs.get("state_rows", 0) for r in steps)
    if not rows:
        return None
    return 100.0 * sum(r.attrs["state_live"] for r in steps) / rows
