"""Model FLOPs of the window's prefills and decodes over the window at the bf16 peak."""

from portbench.harness import readers


def read(run):
    return readers.mfu_pct(run)
