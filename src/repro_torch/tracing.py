"""Program spans: named host intervals at the layer boundaries of the
serving path, read beside a device trace.

``with span("kv.append", rid=rid, k1=ops.k1_launches):`` marks one boundary.
Spans are off unless a :func:`collect` block is open. Off, :func:`span`
returns one shared object after a single check of a module global: it reads
no clock and records nothing. On, each span records its name, its start and
end on ``time.time_ns()``, the innermost span open on the same thread
(``parent``, an index into :attr:`Trace.spans`), the thread, the request it
serves (``rid``) and small integer ``counts``. A count given as a callable
is read at entry and at exit and records the difference, e.g. a kernel's
launch counter over the span.

``time.time_ns()`` is the clock ``torch.profiler`` stamps host events with,
so spans lay over a device trace without conversion. Spans never call
``torch.profiler.record_function``: the profiler mirrors its annotations
onto the device timeline, where a trace reader would count them as work.

    with tracing.collect() as trace:
        engine.step()
    for i, s in enumerate(trace.spans):
        print(s.name, s.parent, (s.t1_ns - s.t0_ns) / 1e3, trace.self_ns(i) / 1e3)
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

__all__ = ["Span", "Trace", "collect", "span"]

_trace: Optional["Trace"] = None  # the open collection, else None (spans off)
_collect_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans, innermost last


class _Off:
    """What :func:`span` returns while nothing collects."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Span:
    """One recorded span; ``t1_ns`` is None while it is open."""

    __slots__ = ("name", "rid", "counts", "t0_ns", "t1_ns", "parent", "thread", "_trace", "_i", "_from")

    def __init__(self, trace: "Trace", name: str, rid: Optional[int], counts: dict):
        self.name, self.rid, self.counts, self._trace = name, rid, counts, trace
        self.t0_ns = self.t1_ns = self.parent = None
        self.thread = threading.get_ident()

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.parent = top._i if top is not None and top._trace is self._trace else None
        self._from = {k: f() for k, f in self.counts.items() if callable(f)}
        self._trace._append(self)
        stack.append(self)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1_ns = time.time_ns()
        _local.stack.pop()
        for k, v in self._from.items():
            self.counts[k] = self.counts[k]() - v
        return False


class Trace:
    """The spans of one :func:`collect` block, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def _append(self, s: Span) -> None:
        with self._lock:
            s._i = len(self.spans)
            self.spans.append(s)

    def children(self, i: int) -> List[int]:
        return [j for j in range(i + 1, len(self.spans)) if self.spans[j].parent == i]

    def self_ns(self, i: int) -> Optional[int]:
        """Span ``i``'s duration less the parts its children cover (they
        nest on one thread, so they do not overlap); None while open."""
        s = self.spans[i]
        if s.t1_ns is None:
            return None
        covered = sum(c.t1_ns - c.t0_ns for c in (self.spans[j] for j in self.children(i)) if c.t1_ns is not None)
        return s.t1_ns - s.t0_ns - covered

    def totals(self) -> Dict[str, dict]:
        """By span name: ``n`` closed spans, ``total_ns`` and ``self_ns``."""
        child_ns = [0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None and s.t1_ns is not None:
                child_ns[s.parent] += s.t1_ns - s.t0_ns
        out: Dict[str, dict] = {}
        for s, covered in zip(self.spans, child_ns):
            if s.t1_ns is None:
                continue
            row = out.setdefault(s.name, {"n": 0, "total_ns": 0, "self_ns": 0})
            row["n"] += 1
            row["total_ns"] += s.t1_ns - s.t0_ns
            row["self_ns"] += s.t1_ns - s.t0_ns - covered
        return out


def span(name: str, rid: Optional[int] = None, **counts):
    """A span named ``name`` (module doc): a context manager; the shared
    no-op object while nothing collects."""
    trace = _trace
    if trace is None:
        return _OFF
    return Span(trace, name, rid, counts)


@contextmanager
def collect() -> Iterator[Trace]:
    """Switch spans on for the body; yields the :class:`Trace` that holds
    them. Collections do not nest."""
    global _trace
    with _collect_lock:
        if _trace is not None:
            raise RuntimeError("tracing.collect() is already open: collections do not nest")
        _trace = trace = Trace()
    try:
        yield trace
    finally:
        _trace = None
