"""The port's model configs (copies of ``repro.configs``)."""
