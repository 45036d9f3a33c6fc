"""Core data formats of the port (counterparts of ``repro.core``)."""
