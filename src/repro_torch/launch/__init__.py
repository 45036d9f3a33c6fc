"""Entry points of the port's paths."""
