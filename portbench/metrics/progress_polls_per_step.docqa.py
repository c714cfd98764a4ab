"""The progress engine's polls (ProgressEngine.stats) over the window's engine steps."""

from portbench.harness import readers


def read(run):
    return readers.progress_polls_per_step(run)
