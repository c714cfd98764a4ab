"""The program's own spans and stamps, read beside the device trace.

The port stamps each request (``Request.t_first``, ``t_done``) on the clock
of the front end that drives it, ``time.perf_counter`` here, the clock of the
benchmark's due times, and, inside
a ``repro_torch.tracing.collect()`` block, records spans at its layer
boundaries on ``time.time_ns()``, the clock the profiler stamps host events
with. A program without them (an older commit) has neither: every reader
here then returns None.

:func:`idle_by_program_span` divides the device's idle time in the traced
window among the program's spans, as :func:`portbench.harness.trace.reduce_trace`
divides it among the benchmark's own. The readers take a run record that
carries ``program_spans`` (the collected spans, or None) and
``program_idle`` (that division, seconds by span name), as
``portbench/trace_spans.py`` builds it.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from portbench.harness.readers import quantile
from portbench.harness.trace import _union

__all__ = ["idle_by_program_span", "front_thread", "first_token_ms", "kv_host_us_per_k1", "idle_in_pct",
           "decode_issue_ms"]

NO_SPAN = "none"


def idle_by_program_span(events: List[tuple], spans, thread: int,
                         launch_of: Optional[Dict[int, int]] = None) -> Optional[Dict[str, float]]:
    """Seconds of device idle inside the ``pb.window`` annotation, by the
    name of the innermost program span open on ``thread`` when each idle
    interval began (``none`` outside every span). The busy time is the union
    of every device operation clipped to the window, as ``reduce_trace``
    takes it, so the idle sums to its idle. None without a window or a
    device operation.

    The trace's device stamps drift against its host stamps between the
    profiler's re-calibrations (on an H100 by 1-2%, up to several ms), while
    program spans are on the host clock. ``launch_of`` maps a device
    operation's start to the host stamp of the call that launched it: an
    interval then moves onto the host clock by the launch of the operation
    that ended it (which started at once, the device being idle), and the
    next keeps that shift until another launch gives one. Only the labels
    move; the seconds are the trace's."""
    windows = [(a, b) for name, dev, a, b in events if name == "pb.window" and not dev]
    if not windows:
        return None
    w0, w1 = windows[0]
    device = [(a, b) for n, dev, a, b in events if dev and not n.startswith("pb.") and b > w0 and a < w1]
    if not device:
        return None
    busy = _union([(max(a, w0), min(b, w1)) for a, b in device])
    label_at = labeller(spans, thread)
    idle: Dict[str, float] = {}
    shift = 0  # device clock less host clock
    cursor = w0
    for a, b in busy + [(w1, w1)]:
        if a > cursor:
            if launch_of is not None and a in launch_of:
                shift = a - launch_of[a]
            # the window's start is a host stamp; a device operation's end is not
            label = label_at(cursor - shift if cursor > w0 else cursor)
            idle[label] = idle.get(label, 0.0) + (a - cursor) * 1e-9
        cursor = max(cursor, b)
    return idle


def labeller(spans, thread: int):
    """``label_at(t_ns)``: the name of the innermost program span open on
    ``thread`` at ``t_ns``; ``none`` outside every span."""
    times, labels, stack = [], [], []

    def close(t):
        while stack and stack[-1].t1_ns <= t:
            times.append(stack.pop().t1_ns)
            labels.append(stack[-1].name if stack else NO_SPAN)

    for s in sorted((s for s in spans if s.thread == thread and s.t1_ns is not None), key=lambda s: (s.t0_ns, -s.t1_ns)):
        close(s.t0_ns)
        stack.append(s)
        times.append(s.t0_ns)
        labels.append(s.name)
    close(float("inf"))

    def label_at(t: int) -> str:
        i = bisect.bisect_right(times, t) - 1
        return labels[i] if i >= 0 else NO_SPAN

    return label_at


def front_thread(spans) -> Optional[int]:
    """The thread that ticks the engine (``AdmissionFrontEnd.serve``'s): the
    one its ``serve.step`` spans ran on."""
    return next((s.thread for s in spans if s.name == "serve.step"), None)


def _spans(run, *names) -> list:
    spans = getattr(run, "program_spans", None) or []
    return [s for s in spans if s.name in names and s.t1_ns is not None]


def first_token_ms(run, q: float) -> Optional[float]:
    """Due time to the program's first-token stamp (``Request.t_first``),
    over every request offered; None where the program has no such stamp."""
    firsts = [(getattr(r.req, "t_first", None), r.due) for r in run.offered]
    v = quantile([t - due for t, due in firsts if t is not None], q)
    return None if v is None else v * 1e3


def kv_host_us_per_k1(run) -> Optional[float]:
    """Host time in page moves (``kv.append`` and ``kv.gather`` spans) over
    the K1 launches they made."""
    spans = _spans(run, "kv.append", "kv.gather")
    launches = sum(s.counts.get("k1", 0) for s in spans)
    if not launches:
        return None
    return sum(s.t1_ns - s.t0_ns for s in spans) * 1e-3 / launches


def idle_in_pct(run, *prefixes: str) -> Optional[float]:
    """Device idle given to program spans whose names start with one of
    ``prefixes``, over the traced window."""
    idle = getattr(run, "program_idle", None)
    if not idle or run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * sum(v for k, v in idle.items() if k.startswith(prefixes)) / run.trace["window_s"]


def decode_issue_ms(run) -> Optional[float]:
    """Mean duration of the ``model.decode`` spans: the host's time to
    issue one batched decode."""
    spans = _spans(run, "model.decode")
    if not spans:
        return None
    return sum(s.t1_ns - s.t0_ns for s in spans) * 1e-6 / len(spans)
