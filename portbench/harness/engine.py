"""Spans and stamps around the serving engine, from the benchmark's side.

:func:`bench_engine_class` subclasses the cell's engine class and wraps the
calls the window drives: ``submit`` (the request's due time), ``step`` (one
continuous-batching tick), ``_prefill_request`` (one prompt's prefill and
the host copy of its first token, which waits for the device), and
``_decode_active`` (one batched decode and the host copy of its tokens, which
waits too). Each records a host-clock span; nothing in the program changes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = ["ReqRecord", "StepRecord", "Recorder", "bench_engine_class"]


@dataclass
class ReqRecord:
    rid: int
    prompt_len: int
    max_new: int
    due: float
    t_submit: float
    prompt: object = None  # the token array, kept for the correctness check
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    cut: bool = False  # still in flight when a closed-loop window closed
    req: object = None


@dataclass
class StepRecord:
    t0: float
    t1: float
    prefills: List[int] = field(default_factory=list)  # prompt lengths prefilled in the step
    decoded: int = 0  # tokens of the batched decode (active slots)
    decode_positions: List[int] = field(default_factory=list)  # each decoded slot's cache length after
    page_tokens: int = 0  # token positions moved through K1 (appends and gathers)


class Recorder:
    """What the wrappers record, in one place."""

    def __init__(self, clock: Callable[[], float]):
        self.clock = clock
        self.requests: Dict[int, ReqRecord] = {}
        self.steps: List[StepRecord] = []
        self.prefill_spans: List[tuple] = []  # (t0, t1, prompt_len)
        self.decode_spans: List[tuple] = []  # (t0, t1, active, max_batch)
        self.page_spans: List[tuple] = []  # (t0, t1, tokens)
        self.live: List[ReqRecord] = []
        self.due_of: Callable[[object], Optional[float]] = lambda prompt: None
        self.on_done: Callable[[ReqRecord], None] = lambda rec: None
        self.annotate = None  # torch.profiler.record_function while tracing, else None
        self.hooks: List = []  # objects with before_step(t) and after_step(t) (the trace window)
        self._cur: Optional[StepRecord] = None

    def span(self, name: str):
        return self.annotate(name) if self.annotate is not None else contextlib.nullcontext()


def bench_engine_class(base):
    """The cell's engine class with the benchmark's spans (module doc)."""

    class BenchEngine(base):
        def __init__(self, *args, recorder: Recorder, close_at: Optional[float] = None, **kw):
            super().__init__(*args, **kw)
            self.rec = recorder
            self.close_at = close_at  # a closed-loop window cuts what is in flight here
            kv = getattr(self, "kv", None)
            if kv is not None:
                self._wrap_pages(kv)

        # -- page moves (paged engine) ---------------------------------------
        def _wrap_pages(self, kv):
            rec = self.rec
            append, gather = kv.append, kv.gather

            def counted_append(rid, cache, slot, pos0, ntok):
                t0 = rec.clock()
                with rec.span("pb.page_move"):
                    append(rid, cache, slot, pos0, ntok)
                rec.page_spans.append((t0, rec.clock(), ntok))
                if rec._cur is not None:
                    rec._cur.page_tokens += ntok

            def counted_gather(rid):
                n = kv.length(rid)
                t0 = rec.clock()
                with rec.span("pb.page_move"):
                    out = gather(rid)
                rec.page_spans.append((t0, rec.clock(), n))
                if rec._cur is not None:
                    rec._cur.page_tokens += n
                return out

            kv.append, kv.gather = counted_append, counted_gather

        # -- admission ---------------------------------------------------------
        def submit(self, prompt, max_new_tokens=16, eos_id=-1):
            t = self.rec.clock()
            req = super().submit(prompt, max_new_tokens, eos_id)
            due = self.rec.due_of(prompt)
            r = ReqRecord(req.rid, int(req.prompt.shape[0]), int(max_new_tokens), t if due is None else due, t,
                          prompt=req.prompt, req=req)
            self.rec.requests[req.rid] = r
            self.rec.live.append(r)
            return req

        def _admit(self):
            with self.rec.span("pb.admit"):
                super()._admit()

        def _prefill_request(self, req):
            t0 = self.rec.clock()
            with self.rec.span("pb.prefill"):
                out = super()._prefill_request(req)  # ends in the host copy of the first token
            t1 = self.rec.clock()
            S = int(req.prompt.shape[0])
            self.rec.prefill_spans.append((t0, t1, S))
            if self.rec._cur is not None:
                self.rec._cur.prefills.append(S)
            return out

        def _decode_active(self):
            t0 = self.rec.clock()
            with self.rec.span("pb.decode"):
                active, nxt = super()._decode_active()  # ends in the host copy of the tokens
            t1 = self.rec.clock()
            if active:
                self.rec.decode_spans.append((t0, t1, len(active), self.max_batch))
                if self.rec._cur is not None:
                    self.rec._cur.decoded += len(active)
                    self.rec._cur.decode_positions.extend(int(self.pos[i]) + 1 for i in active)
            return active, nxt

        # -- the tick ------------------------------------------------------------
        def _cut(self) -> None:
            """Close a closed-loop window: every request still queued, parked
            or in a slot completes now as cut (its tokens so far kept)."""
            waiting = list(self.queue) + list(getattr(self, "parked", ()))
            self.queue.clear()
            if hasattr(self, "parked"):
                self.parked.clear()
            for i, r in enumerate(self.slot_req):
                if r is not None:
                    waiting.append(r)
                    self.slot_req[i] = None
            for r in waiting:
                rec = self.rec.requests.get(r.rid)
                if rec is not None:
                    rec.cut = True
                r.done = True
                if r.grequest is not None:
                    r.grequest.complete()

        def step(self):
            rec = self.rec
            t0 = rec.clock()
            for h in rec.hooks:
                h.before_step(t0)
            if self.close_at is not None and t0 >= self.close_at:
                self._cut()
                n = 0
            else:
                rec._cur = StepRecord(t0, t0)
                try:
                    with rec.span("pb.step"):
                        n = super().step()
                finally:
                    cur, rec._cur = rec._cur, None
                cur.t1 = rec.clock()
                rec.steps.append(cur)
            t1 = rec.clock()
            still = []
            for r in rec.live:
                if r.t_first is None and r.req.out_tokens:
                    r.t_first = t1
                if r.req.done:
                    r.t_done = t1
                    rec.on_done(r)
                else:
                    still.append(r)
            rec.live = still
            for h in rec.hooks:
                h.after_step(t1)
            return n

    BenchEngine.__name__ = f"Bench{base.__name__}"
    return BenchEngine

