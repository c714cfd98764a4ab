"""What the metric files read: one function per kind of quantity.

Each ``portbench/metrics/<name>.py`` calls one of these on the run record
that :func:`portbench.harness.cell.run_cell` returns under ``"run"``. A reader returns a number,
or None when the run holds nothing for it to read (no request of the kind,
no trace, no kernel of that name): the harness then leaves the metric out.
Rates and shares are taken over all the work and all the time of the
window; a percentile is taken over every request.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from portbench.harness.counts import PEAK, attention_cost, roofline_s

K2_NAME = "flash_fwd"  # the attention kernel's device name (flash_fwd_kernel, flash_fwd_bf16_kernel)
K1_NAME = "pack_kernel"  # the datatype kernels' device names (pack_kernel, unpack_kernel)


def quantile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q`` quantile of all ``values``, linear between order
    statistics (NumPy's default); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_s(run) -> Optional[float]:
    if not run.steps:
        return None
    return run.t_end - run.t_start


# -- end to end -------------------------------------------------------------
def setup_seconds(run) -> float:
    return run.setup_s


def output_tokens_per_s(run) -> Optional[float]:
    """Tokens the window's steps emitted (each prefill's first token and
    each decoded token) over the window."""
    w = window_s(run)
    n = sum(len(s.prefills) + s.decoded for s in run.steps)
    return n / w if w and n else None


def prompt_tokens_per_s(run) -> Optional[float]:
    w = window_s(run)
    n = sum(sum(s.prefills) for s in run.steps)
    return n / w if w and n else None


def latency_ms(run, q: float) -> Optional[float]:
    """Due time to completion, over every request offered in the window."""
    lats = [r.t_done - r.due for r in run.offered if r.t_done is not None and not r.cut]
    v = quantile(lats, q)
    return None if v is None else v * 1e3


# -- admission ----------------------------------------------------------------
def ttft_ms(run, q: float) -> Optional[float]:
    """Due time to the end of the step that produced the first token."""
    v = quantile([r.t_first - r.due for r in run.offered if r.t_first is not None], q)
    return None if v is None else v * 1e3


def queue_wait_ms(run, q: float) -> Optional[float]:
    """The front end's own stamps: submitted into the engine less pulled
    off the offer stream."""
    v = quantile([c.t_submit - c.t_arrival for c in run.completions], q)
    return None if v is None else v * 1e3


# -- scheduler and runtime core -------------------------------------------------
def progress_polls_per_step(run) -> Optional[float]:
    if not run.steps or run.progress is None:
        return None
    return run.progress["polls"] / len(run.steps)


def kernel_launches_per_step(run, name: str) -> Optional[float]:
    if run.trace is None or not run.trace_steps:
        return None
    return sum(c for k, (c, _) in run.trace["kernels"].items() if name in k) / len(run.trace_steps)


# -- model step -----------------------------------------------------------------
def decode_step_ms(run) -> Optional[float]:
    spans = [s for s in run.decode_spans if run.t_start <= s[0] < run.t_close]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b, _, _ in spans) / len(spans)


def prefill_ms_per_ktok(run) -> Optional[float]:
    spans = [s for s in run.prefill_spans if run.t_start <= s[0] < run.t_close]
    tokens = sum(S for _, _, S in spans)
    if not tokens:
        return None
    return 1e3 * sum(b - a for a, b, _ in spans) / (tokens / 1000.0)


# -- kernels ------------------------------------------------------------------------
def _kernel_seconds(run, name: str) -> List[float]:
    rows = [(c, s) for k, (c, s) in run.trace["kernels"].items() if name in k]
    return [sum(c for c, _ in rows), sum(s for _, s in rows)]


def k2_roofline_pct(run) -> Optional[float]:
    """K2's least time for the traced prefills' attention (each layer one
    call over the prompt) over K2's device time. None without a trace, or
    when the launches traced are not one a layer of each traced prefill."""
    if run.trace is None:
        return None
    m = run.model
    prefills = [S for s in run.trace_steps for S in s.prefills]
    launches, seconds = _kernel_seconds(run, K2_NAME)
    if not prefills or not seconds or launches != m.L * len(prefills):
        return None
    costs = [attention_cost(S, m.nq, m.nkv, m.hd, m.elem) for S in prefills]
    bound = sum(m.L * roofline_s(c["flops"], c["bytes"]) for c in costs)
    return 100.0 * bound / seconds


def k1_roofline_pct(run) -> Optional[float]:
    """K1's least time for the traced page moves (their bytes at the
    memory's peak) over K1's device time."""
    if run.trace is None:
        return None
    tokens = sum(s.page_tokens for s in run.trace_steps)
    launches, seconds = _kernel_seconds(run, K1_NAME)
    if not tokens or not seconds:
        return None
    return 100.0 * run.model.page_move_bytes(tokens) / PEAK["hbm_bytes_per_s"] / seconds


# -- whole step and device ---------------------------------------------------------------
def mfu_pct(run) -> Optional[float]:
    """Model FLOPs of the window's prefills and decodes over the window at
    the chip's bf16 peak."""
    w = window_s(run)
    if not w:
        return None
    m = run.model
    flops = sum(sum(m.prefill_flops(S) for S in s.prefills) + m.decode_flops(s.decode_positions) for s in run.steps)
    return 100.0 * flops / (w * PEAK["bf16_flops"]) if flops else None


def mbu_pct(run) -> Optional[float]:
    """Bytes the window's decode steps need over the window at the
    memory's peak."""
    w = window_s(run)
    if not w:
        return None
    nbytes = sum(run.model.decode_bytes(s.decode_positions) for s in run.steps)
    return 100.0 * nbytes / (w * PEAK["hbm_bytes_per_s"]) if nbytes else None


def idle_share_pct(run) -> Optional[float]:
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
