"""95th percentile of due time to the end of the step that produced each request's first token."""

from portbench.harness import readers


def read(run):
    return readers.ttft_ms(run, 0.95)
