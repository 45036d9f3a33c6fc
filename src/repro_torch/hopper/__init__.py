"""Hopper kernels, their plain versions and oracles, and the op dispatch."""
