"""Percent of the traced slice in which no operation ran on the card: 1 −
the union of the device operations' intervals over the slice."""
from portbench.lib.readers import idle_pct


def read(run):
    return idle_pct(run)
