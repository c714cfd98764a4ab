"""95th percentile of due time to the program's own first-token stamp (``Request.t_first``)."""

from portbench.harness import spans


def read(run):
    return spans.first_token_ms(run, 0.95)
