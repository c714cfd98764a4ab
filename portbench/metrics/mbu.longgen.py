"""Bytes the window's decode steps need over the window at the memory's peak."""

from portbench.harness import readers


def read(run):
    return readers.mbu_pct(run)
