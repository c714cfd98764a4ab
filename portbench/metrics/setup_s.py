"""Process start to the first timed request: imports, the kernel library, weights, caches, warm-up and any slots filled."""

from portbench.harness import readers


def read(run):
    return readers.setup_seconds(run)
