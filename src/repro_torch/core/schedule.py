"""Recorded communication schedules: record once, replay many.

"Extending the Message Passing Interface (MPI) with User-Level
Schedules" (PAPERS.md) observes that a steady-state step — a pipeline
tick, a gradient bucket round-robin, a serving decode — re-issues the
*same* communication graph every iteration, paying per-op validation,
descriptor derivation, tag-sequence allocation, and per-request
progress-engine registration each time. A schedule amortizes all of it:

* :meth:`Schedule.record` opens a recording; the op layers
  (``enqueue.isend_enqueue_scheduled``, ``ThreadRank.send_scheduled`` /
  ``recv_scheduled``, ``threadcoll.record_barrier``, the pipeline /
  grad-overlap / serving loops) execute their record pass **eagerly** —
  recording IS an execution — while appending pre-resolved issue
  closures: channel bindings, window slots, datatype ``pack_info``
  proofs (via :func:`~repro_torch.core.datatype.make_packer`), and collective
  tag sequence numbers are all resolved *now*, at record time.
* :meth:`Schedule.seal` freezes the op graph. The
  ``with sched.record(): ...`` form seals on success and aborts on
  error; the explicit form is ``rec = sched.record()`` + ``try: ...;
  rec.seal()`` + ``finally: rec.abort()`` (``abort`` is a no-op once
  sealed) — mpixlint's MPIX007 checks exactly this bracket.
* :meth:`Schedule.replay` re-issues the whole graph as ONE
  :class:`~repro_torch.core.progress.FusedRequestSet`: each op mints
  unregistered *parts* instead of engine-queued requests, and the
  engine waits/notifies on the single parent — the batched-grequest
  fast path, skipping per-op validation and per-request wait-queue
  registration. Replayed graphs are byte-identical to the eager paths
  they replace (asserted in ``tests/test_schedule.py``).

**Invalidation contract**: a replay against changed structure must
raise, never silently corrupt. Consumers stamp the recorded structure
with :meth:`fingerprint` and re-check it with :meth:`check` on every
replay — a shape / depth / membership mismatch raises
:class:`ScheduleStale` and marks the schedule invalid; :meth:`record`
may then be called again to re-record (replay epochs keep counting up,
so scheduled tag namespaces never collide across re-records).

Scheduled point-to-point tags live in a per-comm ``("__sched__", tag,
epoch)`` namespace: the record pass is epoch 0 and each replay bumps the
epoch, so back-to-back replays of the same graph can never cross-match.
Two *different* schedules exchanging on the same comm must use distinct
user tags — the same contract eager MPI tags already carry.
"""

from __future__ import annotations

import itertools
import threading
from enum import Enum
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.progress import FusedRequestSet, ProgressEngine, default_engine
from repro_torch.core.streams import MPIXStream, STREAM_NULL

__all__ = [
    "Schedule",
    "ReplayContext",
    "ScheduleError",
    "ScheduleStateError",
    "ScheduleStale",
]


class ScheduleError(RuntimeError):
    """Base class for schedule misuse."""


class ScheduleStateError(ScheduleError):
    """A lifecycle call out of order (record while sealed, replay while
    recording, op added outside a recording, ...)."""


class ScheduleStale(ScheduleError):
    """The structure a replay depends on changed since record() — shape,
    window depth, comm membership/epoch, parameter identity. The
    schedule is marked invalid; re-record it."""


class _State(Enum):
    IDLE = 0
    RECORDING = 1
    SEALED = 2
    INVALID = 3


_schedule_ids = itertools.count()


class _RecordedOp:
    """One node of the op graph: a pre-resolved issue closure plus the
    number of fused parts it mints at replay (pre-counted so the parent
    request knows its exact completion target up front)."""

    __slots__ = ("kind", "issue", "n_parts", "label")

    def __init__(self, kind: str, issue: Callable, n_parts: int, label: str):
        self.kind = kind
        self.issue = issue
        self.n_parts = n_parts
        self.label = label


class ReplayContext:
    """Per-replay state threaded through the issue closures.

    ``binding`` carries the caller's per-replay inputs (this step's
    grads / microbatches / token buffers); ``outputs`` collects op
    results keyed by the recorder; ``scratch`` is op-private carry state
    (the pipeline's stage buffer); ``prewaits`` are completion assists —
    an op that knows a *blocking* way to reach completion
    (waiting on the CUDA event recorded after its dispatched work) registers one;
    :meth:`wait` mounts them as the fused parent's batched ``wait_fn``
    so the engine retires the whole set in its fast blocking-batch
    phase instead of poll-detecting it; ``finalizers`` run
    once after the fused wait (payload extraction, window reaping).
    ``epoch`` is the replay's tag epoch (record pass = 0, first replay
    = 1, ...)."""

    __slots__ = (
        "schedule",
        "engine",
        "fused",
        "binding",
        "outputs",
        "scratch",
        "prewaits",
        "finalizers",
        "epoch",
        "_finalized",
    )

    def __init__(self, schedule: "Schedule", fused: FusedRequestSet, binding, scratch, epoch: int):
        self.schedule = schedule
        self.engine = schedule.engine
        self.fused = fused
        self.binding: Dict[str, Any] = binding or {}
        self.outputs: Dict[str, Any] = {}
        self.scratch: Dict[str, Any] = dict(scratch or {})
        self.prewaits: List[Callable] = []
        self.finalizers: List[Callable] = []
        self.epoch = epoch
        self._finalized = False

    def bound(self, key: str):
        """The caller-bound input ``key`` — missing bindings are a replay
        contract violation, reported as such."""
        try:
            return self.binding[key]
        except KeyError:
            raise ScheduleError(
                f"replay of {self.schedule.name!r} needs binding {key!r} "
                f"(got {sorted(self.binding)})"
            ) from None

    def wait(self, timeout: Optional[float] = None) -> "ReplayContext":
        """Block until the whole fused set completes, then run the
        finalizers (op-level first, then the schedule's per-replay
        finalizers such as window reaping). Idempotent."""
        if not self._finalized and self.prewaits and self.fused.request.wait_fn is None:
            # Mount the completion assists as the parent's batched wait_fn:
            # the engine's wait then retires the fused set in its fast
            # blocking-batch phase (one assist call + one poll) — the same
            # path eager dispatch requests take — instead of falling into
            # the spin/park/progress-sweep loop.
            assists = tuple(self.prewaits)

            def _assist(_states, _timeout):
                for fn in assists:
                    fn()

            self.fused.request.wait_fn = _assist
        if not self.engine.wait(self.fused.request, timeout):
            raise TimeoutError(
                f"replay of {self.schedule.name!r} (epoch {self.epoch}): "
                f"{self.fused.done_count}/{self.fused.expected} parts done "
                f"after {timeout}s"
            )
        if not self._finalized:
            self._finalized = True
            for fn in self.finalizers:
                fn()
            for fn in self.schedule._finalizers:
                fn()
        return self

    @property
    def done(self) -> bool:
        return self.fused.done


class Schedule:
    """A record-once / replay-many communication graph (module doc)."""

    def __init__(
        self,
        engine: Optional[ProgressEngine] = None,
        stream: MPIXStream = STREAM_NULL,
        name: str = "schedule",
    ):
        self.engine = engine if engine is not None else default_engine()
        self.stream = stream
        self.name = name
        self.sid = next(_schedule_ids)
        #: consumer-owned metadata (the recording loop stashes its window,
        #: tick geometry, ... here for its replay wrapper)
        self.meta: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._state = _State.IDLE
        self._ops: List[_RecordedOp] = []
        self._finalizers: List[Callable] = []
        self._fingerprint: Dict[str, Any] = {}
        self._n_parts = 0
        self._replays = 0  # monotone across re-records (tag epochs)
        self._invalid_reason: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    def record(self) -> "Schedule":
        """Open a recording (returns ``self`` so both ``with
        sched.record():`` and ``rec = sched.record()`` work). Allowed
        from IDLE or INVALID — re-recording an invalidated schedule
        clears the stale op graph; replay epochs keep counting up."""
        with self._lock:
            if self._state not in (_State.IDLE, _State.INVALID):
                raise ScheduleStateError(
                    f"record() on {self.name!r} in state {self._state.name}; "
                    f"a schedule records once and replays many"
                )
            self._state = _State.RECORDING
            self._ops = []
            self._finalizers = []
            self._fingerprint = {}
            self.meta.clear()
            self._n_parts = 0
            self._invalid_reason = None
        return self

    def seal(self) -> "Schedule":
        """Freeze the op graph; the schedule becomes replayable."""
        with self._lock:
            if self._state is not _State.RECORDING:
                raise ScheduleStateError(
                    f"seal() on {self.name!r} in state {self._state.name}"
                )
            self._state = _State.SEALED
        return self

    def abort(self) -> None:
        """Discard an open recording. A no-op when the schedule is
        already sealed (or idle/invalid), so the canonical bracket is::

            rec = sched.record()
            try:
                ...ops...
                rec.seal()
            finally:
                rec.abort()   # discards only if seal() was never reached
        """
        with self._lock:
            if self._state is _State.RECORDING:
                self._state = _State.IDLE
                self._ops = []
                self._finalizers = []
                self._fingerprint = {}
                self.meta.clear()
                self._n_parts = 0

    def invalidate(self, reason: str = "invalidated by caller") -> None:
        """Mark the schedule unusable: every subsequent :meth:`replay`
        raises :class:`ScheduleStale` until it is re-recorded."""
        with self._lock:
            self._state = _State.INVALID
            self._invalid_reason = reason

    def __enter__(self) -> "Schedule":
        if not self.recording:
            raise ScheduleStateError(
                f"use 'with sched.record():' — {self.name!r} is not recording"
            )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.seal()
        else:
            self.abort()

    @property
    def recording(self) -> bool:
        return self._state is _State.RECORDING

    @property
    def sealed(self) -> bool:
        return self._state is _State.SEALED

    @property
    def state(self) -> str:
        return self._state.name

    # -- record side -------------------------------------------------------
    def add_op(
        self,
        kind: str,
        issue: Callable,
        *,
        parts: int = 0,
        label: Optional[str] = None,
    ) -> None:
        """Append a pre-resolved op. ``issue(ctx)`` re-executes it at
        replay; ``parts`` is the exact number of fused parts it mints
        (the parent's completion target is the sum over the graph)."""
        with self._lock:
            if self._state is not _State.RECORDING:
                raise ScheduleStateError(
                    f"add_op({kind!r}) on {self.name!r} outside a recording"
                )
            if parts < 0:
                raise ValueError("add_op: parts must be >= 0")
            self._ops.append(_RecordedOp(kind, issue, parts, label or kind))
            self._n_parts += parts

    def add_finalizer(self, fn: Callable) -> None:
        """Run ``fn()`` after every replay's fused wait (e.g. reap the
        offload window so completed slots never accumulate)."""
        with self._lock:
            if self._state is not _State.RECORDING:
                raise ScheduleStateError(
                    f"add_finalizer() on {self.name!r} outside a recording"
                )
            self._finalizers.append(fn)

    def fingerprint(self, **kv) -> None:
        """Stamp recorded structure (shapes, depths, memberships). Keys
        may be stamped once per recording; values must be ``==``-able."""
        with self._lock:
            if self._state is not _State.RECORDING:
                raise ScheduleStateError(
                    f"fingerprint() on {self.name!r} outside a recording"
                )
            for k, v in kv.items():
                if k in self._fingerprint and self._fingerprint[k] != v:
                    raise ScheduleError(
                        f"fingerprint key {k!r} re-stamped with a different "
                        f"value during one recording"
                    )
                self._fingerprint[k] = v

    # -- replay side -------------------------------------------------------
    def check(self, **kv) -> None:
        """Compare live structure against the recorded fingerprint; any
        mismatch (or unknown key) invalidates the schedule and raises
        :class:`ScheduleStale` — the re-record signal, never a silently
        wrong replay."""
        for k, v in kv.items():
            if k not in self._fingerprint:
                self._stale(f"fingerprint key {k!r} was never recorded")
            if self._fingerprint[k] != v:
                self._stale(
                    f"{k!r} changed since record(): "
                    f"recorded {self._fingerprint[k]!r}, now {v!r}"
                )

    def _stale(self, why: str) -> "None":
        self.invalidate(why)
        raise ScheduleStale(f"schedule {self.name!r}: {why} — re-record")

    def replay(
        self,
        binding: Optional[Dict[str, Any]] = None,
        *,
        scratch: Optional[Dict[str, Any]] = None,
        timeout: Optional[float] = None,
        wait: bool = True,
    ) -> ReplayContext:
        """Re-issue the whole recorded graph as one fused request set.

        ``binding`` supplies this step's inputs to the issue closures;
        ``wait=False`` returns right after issue (call ``ctx.wait()``) —
        the benchmark uses it to time pure issue overhead. Raises
        :class:`ScheduleStale` if the schedule was invalidated or an op
        detects changed structure mid-issue (the fused set is cancelled
        so nothing leaks)."""
        with self._lock:
            if self._state is _State.INVALID:
                raise ScheduleStale(
                    f"schedule {self.name!r} is invalid "
                    f"({self._invalid_reason}) — re-record"
                )
            if self._state is not _State.SEALED:
                raise ScheduleStateError(
                    f"replay() on {self.name!r} in state {self._state.name}; "
                    f"record() + seal() first"
                )
            self._replays += 1
            epoch = self._replays
            ops = self._ops
            n_parts = self._n_parts
        fused = self.engine.fused_start(
            n_parts, stream=self.stream, name=f"{self.name}@{epoch}"
        )
        ctx = ReplayContext(self, fused, binding, scratch, epoch)
        try:
            for op in ops:
                op.issue(ctx)
        except BaseException:
            # an op raised (ScheduleStale or otherwise): cancel parent +
            # parts so the engine queue drains instead of leaking a
            # never-completing fused parent
            fused.cancel()
            raise
        if wait:
            ctx.wait(timeout)
        return ctx

    # -- introspection -----------------------------------------------------
    def ops(self) -> List[Dict[str, Any]]:
        """The recorded graph, for diagnostics/tests: one row per op."""
        with self._lock:
            return [
                {"kind": o.kind, "label": o.label, "parts": o.n_parts}
                for o in self._ops
            ]

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state.name,
                "ops": len(self._ops),
                "parts": self._n_parts,
                "replays": self._replays,
                "fingerprint_keys": sorted(self._fingerprint),
                "invalid_reason": self._invalid_reason,
            }
