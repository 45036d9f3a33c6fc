"""Training loop, checkpoints and fault tolerance of the port (counterpart
of ``repro.runtime``)."""
