"""95th percentile, over every request offered in the window, of due time to completion."""

from portbench.harness import readers


def read(run):
    return readers.latency_ms(run, 0.95)
