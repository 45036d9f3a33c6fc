"""kernels_per_step.serve: the device kernels (copies and fills left out)
that start inside a ``PagedModel.decode`` span of the traced slice, per
decode step."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.ranges_named("decode")
    if not spans:
        return None
    n = len(run.trace.ops_within(spans))
    return n / len(spans) if n else None
