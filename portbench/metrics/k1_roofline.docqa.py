"""K1's least time for the traced page moves' bytes over its device time."""

from portbench.harness import readers


def read(run):
    return readers.k1_roofline_pct(run)
