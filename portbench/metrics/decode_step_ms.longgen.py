"""Mean time of a batched decode, the host copy of its tokens included."""

from portbench.harness import readers


def read(run):
    return readers.decode_step_ms(run)
