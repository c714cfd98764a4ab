"""The device trace of a part of the window, and its reduction.

With ``--trace 1`` the profiler (``torch.profiler``, CUPTI on the card) is
switched on at the first engine step that starts in the window's last
``seconds``, and stopped at the end of the first step that ends
``seconds`` later, past the close; the device is synchronised at both ends,
so every step inside is whole and every kernel it launched is inside.
Gathering the events at the stop takes seconds, and so falls after the
window's last step. The window is marked by a
``pb.window`` annotation and the benchmark's spans by ``pb.*`` annotations
(``record_function``), on the profiler's own clock.

:func:`reduce_trace` turns the events into the device's busy time (the
union of every kernel, copy and set), the traced window's length, the time
and launches by kernel name, and the idle time between device operations
labelled by the innermost benchmark span the host was in when the device
went idle.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceWindow", "reduce_trace", "breakdown"]

_HOST_LABELS = ("pb.page_move", "pb.prefill", "pb.decode", "pb.admit", "pb.step")


class TraceWindow:
    """Switches the profiler on and off at step boundaries (module doc)."""

    def __init__(self, torch, recorder, t_from: float, seconds: float):
        self.torch, self.rec = torch, recorder
        self.t_from, self.seconds = t_from, seconds
        self.prof = None
        self._ann = None
        self.t_on: Optional[float] = None
        self.t_off: Optional[float] = None
        self.step_range: Tuple[int, int] = (0, 0)  # recorder.steps[a:b] ran inside

    def before_step(self, now: float) -> None:
        if self.prof is None and self.t_on is None and now >= self.t_from:
            torch = self.torch
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self._ann = torch.profiler.record_function("pb.window")
            self._ann.__enter__()
            self.rec.annotate = torch.profiler.record_function
            self.t_on = self.rec.clock()
            self.step_range = (len(self.rec.steps), len(self.rec.steps))

    def after_step(self, now: float) -> None:
        if self.prof is not None and self.t_off is None:
            self.step_range = (self.step_range[0], len(self.rec.steps))
            if now >= self.t_on + self.seconds:
                self.stop()

    def stop(self) -> None:
        """End the traced part at a step boundary and stop the profiler,
        which gathers every event (seconds of work): the part ends at the
        window's close, so that lands after it."""
        if self.prof is None or self.t_off is not None:
            return
        self.torch.cuda.synchronize()
        self.rec.annotate = None
        self._ann.__exit__(None, None, None)
        self.t_off = self.rec.clock()
        self.prof.stop()

    def events(self) -> List[tuple]:
        """``(name, on_device, start_ns, end_ns)`` of every event traced."""
        if self.prof is None:
            return []
        out = []
        results = getattr(self.prof.profiler, "kineto_results", None)
        if results is not None:
            for ev in results.events():
                dev = str(ev.device_type()).upper().endswith("CUDA")
                out.append((ev.name(), dev, int(ev.start_ns()), int(ev.start_ns() + ev.duration_ns())))
            return out
        for ev in self.prof.events():
            dev = str(ev.device_type).upper().endswith("CUDA")
            out.append((ev.name, dev, int(ev.time_range.start * 1000), int(ev.time_range.end * 1000)))
        return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_trace(events: List[tuple]) -> Optional[dict]:
    """Busy and idle time of the device inside the ``pb.window`` annotation,
    device time and launches by name, idle time by host span. None when the
    trace holds no window or no device operation."""
    windows = [(a, b) for name, dev, a, b in events if name == "pb.window" and not dev]
    if not windows:
        return None
    w0, w1 = windows[0]
    device = [(n, a, b) for n, dev, a, b in events if dev and not n.startswith("pb.") and b > w0 and a < w1]
    if not device:
        return None
    kernels: Dict[str, list] = {}
    for n, a, b in device:
        row = kernels.setdefault(n, [0, 0.0])
        row[0] += 1
        row[1] += (b - a) * 1e-9
    busy = _union([(max(a, w0), min(b, w1)) for _, a, b in device])
    busy_ns = sum(b - a for a, b in busy)
    spans = sorted((a, b, n) for n, dev, a, b in events if not dev and n in _HOST_LABELS)
    starts = [a for a, _, _ in spans]
    idle: Dict[str, float] = {}
    cursor = w0
    for a, b in busy + [(w1, w1)]:
        if a > cursor:
            label = _label_at(spans, starts, cursor)
            idle[label] = idle.get(label, 0.0) + (a - cursor) * 1e-9
        cursor = max(cursor, b)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9, "kernels": kernels, "idle_by_host": idle}


def _label_at(spans, starts, t: int) -> str:
    """The innermost (latest-starting) benchmark span around ``t``, else
    ``front_end`` (the admission loop between engine steps)."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        a, b, n = spans[i]
        if b >= t:
            return n[3:]
        i -= 1
    return "front_end"


def breakdown(summary: dict, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the idle time by what the host was doing, each at most
    ``top`` entries of ``[name, seconds]``."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, (_, s) in ops], "idle_gaps": [[n, s] for n, s in gaps]}
