"""decode_step_roofline.serve: the bytes the traced slice's decode steps
need (every weight once a step, each sequence's cached keys and values read
once and its new row written once, ``lib/counts.decode_bytes``) at the
card's HBM rate, over the device's busy time inside the decode spans, in
percent."""
from portbench.lib import peaks


def read(run):
    if run.trace is None or not run.traced.get("decodes"):
        return None
    busy = run.trace.busy_s(within=run.trace.ranges_named("decode"))
    if not busy:
        return None
    return 100.0 * run.traced["decode_bytes"] / peaks.HBM_BYTES_PER_S / busy
