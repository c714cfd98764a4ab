"""Prompt tokens the window's steps prefilled over the window."""

from portbench.harness import readers


def read(run):
    return readers.prompt_tokens_per_s(run)
