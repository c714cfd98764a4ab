"""Seeded, deterministic fault injection for the fault-tolerance stack.

The recovery path (heartbeat detect → remesh plan → windowed reshard →
resume) is only trustworthy if it survives faults *injected at the
runtime's own seams*, not faults simulated beside them. This module
defines a :class:`FaultPlan` — a seeded list of timed :class:`FaultEvent`
s — and a :class:`FaultInjector` that arms the plan against the seams the
rest of the runtime already exposes:

* ``HostThreadComm`` mailbox ops (``_send`` / ``_recv``): a killed rank's
  ops raise :class:`RankKilled`, a timed-out send raises
  :class:`SendTimeout`, delayed/stalled ranks sleep inside the op;
* ``OffloadWindow.reserve`` / ``issue``: stall/delay faults land on the
  issuer right where backpressure parks do, so the adaptive-depth logic
  is exercised under injection;
* ``ProgressEngine.park_on_channel`` / ``notify_channel``: jitter faults
  widen the park/notify race windows the per-channel wait queues close;
* ``HeartbeatMonitor``: the injector owns a :class:`VirtualClock` handed
  to the monitor as ``clock=`` (no test sleeps real heartbeat timeouts),
  and drop-heartbeat / kill faults suppress ``record()`` so the detector
  times the rank out when the clock advances.

Determinism contract: given the same seed, :meth:`FaultPlan.random`
yields the same events, and the injector's decisions depend only on the
virtual clock and the op sequence — never on wall time or ids.

Injected requests (``stall_request``) are created with ``fault=self`` so
the injector owns their lifetime: anything still live at ``uninstall``
is cancelled. mpixlint's MPIX004 recognizes the ``fault=`` keyword the
same way it recognizes ``schedule=`` — a dropped injected handle is the
injector's to retire, not a leak.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "KINDS",
    "FaultEvent",
    "FaultPlan",
    "FaultInjector",
    "RankKilled",
    "SendTimeout",
    "VirtualClock",
]

KINDS = (
    "kill_rank",      # ops by/to the rank raise RankKilled; heartbeats dropped
    "stall_rank",     # ops by the rank block for `duration` (real seconds)
    "delay_rank",     # ops by the rank sleep `duration` each (real seconds)
    "timeout_send",   # sends to the rank raise SendTimeout while armed
    "drop_heartbeat", # record(rank) suppressed while armed (detector fires)
    "straggle_stage", # stage_delay(rank) reports +`duration` step seconds
)


class RankKilled(RuntimeError):
    """Raised inside a victim rank's mailbox op once its kill event arms."""

    def __init__(self, rank: int):
        super().__init__(f"rank {rank} killed by fault injection")
        self.rank = rank


class SendTimeout(TimeoutError):
    """Raised for a send whose timeout_send event is armed."""


class VirtualClock:
    """Thread-safe monotonic virtual clock.

    Pass the instance itself as ``clock=`` (it is callable); tests drive
    time with :meth:`advance` instead of sleeping — a heartbeat timeout
    of hours costs nothing in wall time.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def __call__(self) -> float:
        return self.now()

    def now(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("virtual clocks are monotonic")
        with self._lock:
            self._t += dt
            return self._t


@dataclass(frozen=True)
class FaultEvent:
    """One timed fault. ``at`` is virtual seconds; ``duration`` is the
    armed window (virtual) for drop/timeout faults, the *real* sleep for
    stall/delay faults, and the reported extra step seconds for
    straggles. ``duration=0`` on drop/timeout/kill means armed forever."""

    at: float
    kind: str
    rank: int
    duration: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {KINDS})")


class FaultPlan:
    """An ordered, seeded set of fault events.

    ``FaultPlan(events)`` for hand-written scenarios;
    ``FaultPlan.random(seed, ranks=...)`` for matrix tests — the same
    seed always yields the same plan.
    """

    def __init__(self, events: Sequence[FaultEvent], seed: int = 0):
        self.events: Tuple[FaultEvent, ...] = tuple(sorted(events, key=lambda e: e.at))
        self.seed = seed

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    @classmethod
    def random(
        cls,
        seed: int,
        ranks: Sequence[int],
        n_events: int = 3,
        horizon: float = 10.0,
        kinds: Sequence[str] = KINDS,
        max_duration: float = 0.02,
    ) -> "FaultPlan":
        """Deterministic plan: ``n_events`` faults over ``[0, horizon)``
        virtual seconds against ``ranks``. Real-sleep durations
        (stall/delay) are capped at ``max_duration`` so soak matrices
        stay fast."""
        rng = random.Random(seed)
        events = []
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            dur = rng.uniform(0.0, max_duration) if kind in ("stall_rank", "delay_rank") else rng.uniform(0.5, horizon / 2)
            events.append(
                FaultEvent(
                    at=rng.uniform(0.0, horizon),
                    kind=kind,
                    rank=rng.choice(list(ranks)),
                    duration=dur,
                )
            )
        return cls(events, seed=seed)


class FaultInjector:
    """Arms a :class:`FaultPlan` against live runtime objects.

    Use as a context manager::

        clock = VirtualClock()
        with FaultInjector(plan, clock=clock) as inject:
            inject.attach_comm(tc)
            inject.attach_window(win)
            inject.attach_engine(engine)
            mon = HeartbeatMonitor(..., clock=clock)
            inject.attach_heartbeat(mon)
            ... run workload, clock.advance(...) between phases ...

    All wrapping is per-instance (bound-method patching); ``uninstall``
    restores every seam and cancels any still-live injected request.
    """

    def __init__(self, plan: FaultPlan, clock: Optional[VirtualClock] = None):
        self.plan = plan
        self.clock = clock or VirtualClock()
        self.fired: List[Tuple[float, FaultEvent, str]] = []  # (vtime, event, site)
        self._lock = threading.Lock()
        self._restores: List[Callable[[], None]] = []
        self._adopted: List[object] = []
        self._installed = False

    # -- lifecycle ---------------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def uninstall(self) -> None:
        """Restore every patched seam; cancel live injected requests."""
        with self._lock:
            restores, self._restores = self._restores, []
            adopted, self._adopted = self._adopted, []
        for undo in reversed(restores):
            undo()
        for req in adopted:
            if not getattr(req, "done", True):
                req.cancel()
        self._installed = False

    def adopt(self, req) -> None:
        """Take ownership of an injected request handle (``fault=`` path):
        the injector retires whatever the test drops."""
        with self._lock:
            self._adopted.append(req)

    # -- event queries -----------------------------------------------------
    def _armed(self, kind: str, rank: Optional[int] = None) -> Optional[FaultEvent]:
        now = self.clock.now()
        for ev in self.plan:
            if ev.kind != kind or ev.at > now:
                continue
            if rank is not None and ev.rank != rank:
                continue
            # drop/timeout faults expire after their (virtual) duration
            if kind in ("timeout_send", "drop_heartbeat", "straggle_stage") and ev.duration > 0:
                if now > ev.at + ev.duration:
                    continue
            return ev
        return None

    def _record(self, ev: FaultEvent, site: str) -> None:
        with self._lock:
            self.fired.append((self.clock.now(), ev, site))

    def killed(self, rank: int) -> bool:
        return self._armed("kill_rank", rank) is not None

    def stage_delay(self, rank: int) -> float:
        """Extra (reported) step seconds for a straggled rank — feeds
        ``StragglerMonitor.record_step`` without sleeping."""
        ev = self._armed("straggle_stage", rank)
        if ev is None:
            return 0.0
        self._record(ev, "stage")
        return ev.duration

    # -- the seam hook -----------------------------------------------------
    def check(self, site: str, rank: Optional[int] = None, dst: Optional[int] = None) -> None:
        """Called at an instrumented seam. May raise (kill/timeout) or
        sleep (stall/delay); otherwise a no-op. ``rank`` is the acting
        rank, ``dst`` the destination for sends."""
        if rank is not None:
            ev = self._armed("kill_rank", rank)
            if ev is not None:
                self._record(ev, site)
                raise RankKilled(rank)
            ev = self._armed("stall_rank", rank)
            if ev is not None:
                self._record(ev, site)
                time.sleep(ev.duration)
            ev = self._armed("delay_rank", rank)
            if ev is not None:
                self._record(ev, site)
                time.sleep(ev.duration)
        if dst is not None:
            ev = self._armed("kill_rank", dst)
            if ev is not None and site == "tc.send":
                self._record(ev, site)
                raise RankKilled(dst)
            ev = self._armed("timeout_send", dst)
            if ev is not None:
                self._record(ev, site)
                raise SendTimeout(f"send to rank {dst} timed out (injected)")

    # -- seam installation -------------------------------------------------
    def _patch(self, obj, attr: str, wrapper_factory) -> None:
        orig = getattr(obj, attr)
        setattr(obj, attr, wrapper_factory(orig))
        with self._lock:
            self._restores.append(lambda: setattr(obj, attr, orig))

    def attach_comm(self, tc) -> None:
        """Instrument a ``HostThreadComm``'s mailbox ops. The comm's own
        ``fault_hook`` seam is preferred when present (newer comms call
        it on every op); older instances get bound-method wrapping."""
        if hasattr(tc, "fault_hook"):
            prev = tc.fault_hook
            tc.fault_hook = self.check
            with self._lock:
                self._restores.append(lambda: setattr(tc, "fault_hook", prev))
            return

        def wrap_send(orig):
            def _send(src, dst, *a, **kw):
                self.check("tc.send", rank=src, dst=dst)
                return orig(src, dst, *a, **kw)

            return _send

        def wrap_recv(orig):
            def _recv(rank, *a, **kw):
                self.check("tc.recv", rank=rank)
                return orig(rank, *a, **kw)

            return _recv

        self._patch(tc, "_send", wrap_send)
        self._patch(tc, "_recv", wrap_recv)

    def attach_window(self, win) -> None:
        """Instrument an ``OffloadWindow``: stall/delay faults (rank -1
        matches any) land in ``reserve``, right where real backpressure
        parks do."""

        def wrap_reserve(orig):
            def reserve(*a, **kw):
                ev = self._armed("stall_rank", -1) or self._armed("delay_rank", -1)
                if ev is not None:
                    self._record(ev, "win.reserve")
                    time.sleep(ev.duration)
                return orig(*a, **kw)

            return reserve

        self._patch(win, "reserve", wrap_reserve)

    def attach_engine(self, engine) -> None:
        """Instrument ``notify_channel``: an armed delay jitters the
        notifier before it takes the stripe lock, widening the
        park/notify race the wait queues must win regardless."""

        def wrap_notify(orig):
            def notify_channel(*a, **kw):
                ev = self._armed("delay_rank", -1)
                if ev is not None:
                    self._record(ev, "engine.notify")
                    time.sleep(ev.duration)
                return orig(*a, **kw)

            return notify_channel

        self._patch(engine, "notify_channel", wrap_notify)

    def attach_heartbeat(self, mon) -> None:
        """Suppress ``record(rank)`` for killed / drop-heartbeat ranks so
        the detector (driven by the shared virtual clock) times them out."""

        def wrap_record(orig):
            def record(rank):
                ev = self._armed("kill_rank", rank) or self._armed("drop_heartbeat", rank)
                if ev is not None:
                    self._record(ev, "hb.record")
                    return
                return orig(rank)

            return record

        self._patch(mon, "record", wrap_record)

    # -- injected requests -------------------------------------------------
    def stall_request(self, engine, stream, until: float, name: str = "fault-stall"):
        """A generalized request that completes only once the virtual
        clock passes ``until`` — models a stalled peer the progress
        engine must keep polling past. The injector owns the handle
        (``fault=self``): dropping the return value is fine."""
        return engine.grequest_start(
            poll_fn=lambda _s: self.clock.now() >= until,
            stream=stream,
            name=name,
            fault=self,
        )
