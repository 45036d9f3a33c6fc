"""Single-controller parallelism: the ring mesh and the ring collectives."""
