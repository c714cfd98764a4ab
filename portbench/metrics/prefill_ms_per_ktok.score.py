"""Time in prefills (with the first token's host copy) per 1000 prompt tokens."""

from portbench.harness import readers


def read(run):
    return readers.prefill_ms_per_ktok(run)
