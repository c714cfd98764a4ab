"""Share of the traced window with no device operation running."""

from portbench.harness import readers


def read(run):
    return readers.idle_share_pct(run)
