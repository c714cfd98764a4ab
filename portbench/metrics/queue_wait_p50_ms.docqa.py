"""Median of the admission front end's submit stamp less its arrival stamp."""

from portbench.harness import readers


def read(run):
    return readers.queue_wait_ms(run, 0.5)
