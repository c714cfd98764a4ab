"""Output tokens the window's steps emitted over the window."""

from portbench.harness import readers


def read(run):
    return readers.output_tokens_per_s(run)
