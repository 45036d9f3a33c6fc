"""Optimizer and gradient compression of the port (counterpart of ``repro.optim``)."""
