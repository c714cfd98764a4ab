"""K4's least time for the traced decode steps' K/V reads over its device time.

The least time: every cache position in use (each decoded slot's length
after the step) read once, K and V of every layer, at the memory's peak.
K4's device time: every traced kernel whose name holds ``decode_attention``,
the chunk merge included. None without a trace or without K4 launches (a
program without the kernel reads nothing)."""

from portbench.harness import readers

K4_NAME = "decode_attention"


def read(run):
    if run.trace is None:
        return None
    launches, seconds = readers._kernel_seconds(run, K4_NAME)
    positions = sum(sum(s.decode_positions) for s in run.trace_steps)
    if not launches or not seconds or not positions:
        return None
    nbytes = positions * run.model.kv_bytes_per_position
    return 100.0 * nbytes / readers.PEAK["hbm_bytes_per_s"] / seconds
