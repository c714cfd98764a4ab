"""Generalized requests + the general-progress extension (paper ext. 1 & 6).

``MPIX_Grequest_start`` adds a ``poll_fn`` (and optional batch ``wait_fn``)
to MPI-2 generalized requests so the runtime's own progress engine can
complete externally-managed asynchronous tasks — no dedicated completion
thread per subsystem. ``MPIX_Stream_progress`` decouples progress
invocation from any particular request and scopes it to one stream, so
applications can spawn *custom* progress threads and spin them up/down
(the paper's fix for the two drawbacks of ``MPIR_CVAR_ASYNC_PROGRESS``:
a stolen core from busy polling, and global lock contention).

This module is the host-side runtime of the framework. Consumers:

* ``checkpoint.manager`` — async d2h + file writes as generalized requests,
* ``data.pipeline``     — prefetch batches,
* ``ft.heartbeat``      — failure-detector pings,
* ``serving.engine``    — request-completion handles,
* metric/trace flushing in ``launch.train``.

All of them are completed by ONE engine: a single :func:`wait_all` over a
mixed set of requests is the paper's "one MPI_Waitall for MPI and non-MPI
work".

Locking is a sharded VCI runtime, the MPICH 4.x story:

* a **fixed-size lock-striped channel table** built at engine creation —
  channel → stripe is pure arithmetic, so the hot path (post, poll,
  complete) never touches a registry lock;
* each stripe carries **per-channel wait queues**: a blocked caller
  (:meth:`ProgressEngine.park_on_channel`) registers a *predicate* on its
  channel and parks on its own per-waiter CV; ``notify_channel``
  evaluates the predicates of that channel's queue under the stripe lock
  and wakes **only the matching waiters** — no thundering herd when many
  ranks share a stripe (the pre-queue behaviour, every notify waking
  every parked thread on the stripe, is kept as
  ``ProgressEngine(wait_queues=False)`` for the benchmark baseline).
  ``wait``/``wait_all``/``wait_any`` and progress threads park the same
  way and are woken by ``grequest_start`` (new work) and request
  completion; the queues also serve issue-path backpressure — a full
  :class:`~repro_torch.core.enqueue.OffloadWindow` parks its issuer here, and a
  host-threadcomm rank (``core.threadcomm``, a later slice) blocks its recv the
  same way;
* engine-level **wait-any** (:meth:`ProgressEngine.wait_any`): block on a
  mixed request set until the *first* completion and return that request
  — ``MPI_Waitany`` for MPI and non-MPI work alike (a full enqueue
  window blocks on "first completion" instead of CV slices when it is
  its own poller, and threadcomm ANY_SOURCE recvs ride it);
* a **stats()-driven autotuner** (:meth:`ProgressEngine.autotune`): a
  :class:`Autotuner` samples per-channel activity deltas (enqueues,
  polls, parks, pending work) each tick and *promotes* hot channels onto
  dedicated progress threads / *demotes* idle ones, with a hysteresis
  band (promote/demote thresholds + consecutive-tick streaks) so
  placement never flaps — the runtime version of the paper's "the user
  spins progress threads up and down";
* an **adaptive spin-then-park** admission to every park: the caller
  first spins for a short per-stripe budget (``spin_s``, tunable at
  engine construction or via :meth:`ProgressEngine.configure`) before
  paying the CV round-trip.  The budget adapts — a spin that observes
  the wake condition (a *spin hit*) grows it, a spin that falls through
  to a real park shrinks it — so hot ping-pong channels stay in the
  cheap spin regime while idle channels decay to near-immediate parking.
  ``stats()`` separates ``spin_hits`` from ``parks``;
* a **per-thread channel affinity** registry
  (:meth:`ProgressEngine.bind_thread_to_channel`): an OS thread that
  joined a communicator as a rank declares the VCI channel it drives, so
  blocking paths can default to *its* stripe CV and debugging/stats can
  attribute contention to the owning rank;
* a **batched completion path**: requests sharing a ``wait_fn`` are waited
  as whole per-stream batches in one call (``MPI_Waitall`` semantics);
* engine-level **counters** (polls, completions, lock waits, park/wake
  events) exposed via :meth:`ProgressEngine.stats` — the benchmarks print
  their scaling numbers straight from these.

A global-critical-section mode is kept for the message-rate benchmark
(paper Fig. 4's red curve): every channel maps to stripe 0.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.streams import DEFAULT_NUM_CHANNELS, MPIXStream, STREAM_NULL

__all__ = [
    "RequestState",
    "GeneralizedRequest",
    "FusedRequestSet",
    "ProgressEngine",
    "AutotunePolicy",
    "Autotuner",
    "default_engine",
    "grequest_start",
    "grequest_complete",
    "stream_progress",
    "start_progress_thread",
    "stop_progress_thread",
    "join_thread_states",
    "DEFAULT_NUM_STRIPES",
]


def join_thread_states(states, timeout) -> None:
    """Deadline-aware batched ``wait_fn`` for worker-thread-backed requests
    (``extra_state['thread']`` holding a ``threading.Thread``): joins the
    whole per-stream batch in one call — the waiter parks in the OS join,
    no host polling. Shared by checkpoint writers and data prefetchers."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for st in states:
        t = st["thread"]
        if deadline is None:
            t.join()
        else:
            t.join(max(0.0, deadline - time.monotonic()))

#: Stripe-table width. Matches the stream pool's channel space so each
#: compute stream lands on its own stripe (see ``streams.StreamPool``).
DEFAULT_NUM_STRIPES = DEFAULT_NUM_CHANNELS

# How long a parked thread sleeps before re-validating its park condition.
# Wake-ups normally arrive via notify; this only bounds lost-wakeup risk.
_PARK_RECHECK_S = 0.25

# Adaptive spin-budget bounds, as multiples of the engine's base spin_s:
# a stripe whose spins keep hitting may grow to spin_s * _SPIN_GROW_MAX;
# one whose spins keep falling through to parks shrinks toward
# spin_s / _SPIN_SHRINK_MAX (never fully to 0, so it can recover).
_SPIN_GROW_MAX = 8.0
_SPIN_SHRINK_MAX = 8.0


class RequestState(Enum):
    ACTIVE = 0
    COMPLETE = 1
    CANCELLED = 2
    FREED = 3


@dataclass
class GeneralizedRequest:
    """MPI(X) generalized request.

    ``poll_fn(extra_state) -> bool`` should *query* the underlying task and
    call :meth:`complete` (or return True) when it finished — mirroring the
    paper's CUDA example (``cudaEventQuery`` + ``MPI_Grequest_complete``).
    ``wait_fn(states, timeout) -> None`` may block on a whole batch.
    """

    poll_fn: Optional[Callable] = None
    wait_fn: Optional[Callable] = None
    query_fn: Optional[Callable] = None
    free_fn: Optional[Callable] = None
    cancel_fn: Optional[Callable] = None
    extra_state: object = None
    stream: MPIXStream = STREAM_NULL
    name: str = "grequest"

    _state: RequestState = field(default=RequestState.ACTIVE, init=False)
    _cv: threading.Condition = field(default_factory=threading.Condition, init=False)
    _callbacks: List[Callable] = field(default_factory=list, init=False)
    # retired = counted + free_fn run, exactly once (guarded by the stripe
    # lock: both the progress sweep and the batched wait path may observe
    # the completion first)
    _retired: bool = field(default=False, init=False)
    n_polls: int = field(default=0, init=False)

    # -- completion ----------------------------------------------------
    def complete(self) -> None:
        """``MPI_Grequest_complete`` — may be called from any thread."""
        self._finish(RequestState.COMPLETE)

    def cancel(self) -> None:
        if self.cancel_fn is not None:
            self.cancel_fn(self.extra_state, self.done)
        self._finish(RequestState.CANCELLED)

    def _finish(self, state: RequestState) -> None:
        with self._cv:
            if self._state is not RequestState.ACTIVE:
                return
            self._state = state
            self._cv.notify_all()
            callbacks = list(self._callbacks)
            self._callbacks.clear()
        for cb in callbacks:
            cb(self)

    def add_done_callback(self, cb: Callable) -> None:
        """Run ``cb(request)`` on completion/cancellation; immediately if
        already done. The engine uses this to wake parked waiters without
        any polling."""
        with self._cv:
            if self._state is RequestState.ACTIVE:
                self._callbacks.append(cb)
                return
        cb(self)

    def remove_done_callback(self, cb: Callable) -> None:
        """Detach a callback (no-op if absent/fired): a timed-out waiter
        must not leave its wake closure on a long-lived request."""
        with self._cv:
            try:
                self._callbacks.remove(cb)
            except ValueError:
                pass

    @property
    def done(self) -> bool:
        return self._state in (RequestState.COMPLETE, RequestState.CANCELLED)

    def status(self):
        return self.query_fn(self.extra_state) if self.query_fn else None

    def _poll(self) -> bool:
        """One progress visit. Returns True if the request completed."""
        if self.done:
            return True
        self.n_polls += 1
        if self.poll_fn is not None:
            if self.poll_fn(self.extra_state):
                self.complete()
        return self.done


class _Waiter:
    """One parked thread on a channel's wait queue. ``predicate`` is the
    wake condition evaluated under the stripe lock — by the waiter itself
    and by :meth:`ProgressEngine.notify_channel` (so a notify wakes only
    the waiters it actually satisfies); it is ``None`` for *kick* waiters
    (progress threads), which re-scan their queues on their own after any
    wake. ``satisfied`` flips exactly once, under the stripe lock: a
    predicate with side effects (a mailbox match-and-pop) runs to a True
    result at most once per park."""

    __slots__ = ("cv", "predicate", "satisfied")

    def __init__(self, lock, predicate):
        self.cv = threading.Condition(lock)
        self.predicate = predicate
        self.satisfied = False


class _Stripe:
    """One slot of the lock-striped channel table: a lock, a CV, the
    per-channel request queues + wait queues homed here, and hot-path
    counters (all mutated under the stripe lock)."""

    __slots__ = (
        "index",
        "lock",
        "cv",
        "sanitizer",
        "queues",
        "wait_queues",
        "polls",
        "completions",
        "lock_waits",
        "parks",
        "wakes",
        "visits",
        "enqueued",
        "progress_calls",
        "spin_hits",
        "spin_budget",
        "notifies",
        "notify_wakeups",
        "notify_skips",
        "parked_now",
        "chan_enqueued",
        "chan_polls",
        "chan_parks",
    )

    def __init__(self, index: int):
        self.index = index
        # RLock: poll_fn → complete() → wake callbacks re-enter the stripe.
        self.lock = threading.RLock()
        self.cv = threading.Condition(self.lock)
        # acquisition recorder when the engine runs with sanitize=True
        self.sanitizer = None
        self.queues: Dict[int, List[GeneralizedRequest]] = {}
        # channel → parked _Waiters (predicate and kick waiters alike)
        self.wait_queues: Dict[int, List[_Waiter]] = {}
        self.polls = 0
        self.completions = 0
        self.lock_waits = 0
        self.parks = 0
        self.wakes = 0
        self.visits = 0
        self.enqueued = 0
        self.progress_calls = 0
        self.spin_hits = 0
        self.spin_budget = 0.0  # current adaptive spin-before-park budget (s)
        self.notifies = 0  # notify_channel calls landing on this stripe
        self.notify_wakeups = 0  # waiters those notifies actually woke
        self.notify_skips = 0  # parked waiters left asleep (predicate miss)
        self.parked_now = 0  # currently-parked waiters (legacy herd count)
        # per-channel activity (the autotuner's sampling surface)
        self.chan_enqueued: Dict[int, int] = {}
        self.chan_polls: Dict[int, int] = {}
        self.chan_parks: Dict[int, int] = {}

    @contextmanager
    def held(self):
        """Acquire the stripe lock, counting contended acquisitions."""
        if self.lock.acquire(blocking=False):
            contended = False
        else:
            self.lock.acquire()
            contended = True
        san = self.sanitizer
        if san is not None:
            san.on_acquire(self.index)
        try:
            if contended:
                self.lock_waits += 1
            yield self
        finally:
            if san is not None:
                san.on_release(self.index)
            self.lock.release()

    def needs_polling(self, channel: Optional[int]) -> bool:
        """True if any queued (active) request here must be *polled* (has a
        poll_fn) rather than being completed externally. Caller holds the
        lock."""
        queues = self.queues.values() if channel is None else [self.queues.get(channel, ())]
        return any(r.poll_fn is not None and not r.done for q in queues for r in q)


class FusedRequestSet:
    """A recorded-schedule replay batch: many *parts* behind ONE queued
    generalized request — the batched-grequest fast path that
    ``core.schedule`` replays issue through.

    :meth:`part` mints a :class:`GeneralizedRequest` that is **not**
    enqueued on any channel queue and never registers with a wait queue
    on its own — replaying a recorded step skips the per-request
    ``grequest_start`` bookkeeping (queue append, sweep, notify) that the
    eager path pays per op. The single *parent* request (:attr:`request`)
    is the engine-visible unit: its ``poll_fn`` sweeps the pollable
    parts, every part completion (swept or external) counts toward
    ``expected``, and when the last part lands the parent completes —
    one notify for the whole batch. Parts are ordinary requests in every
    other respect: consumers may attach done-callbacks (an
    :class:`~repro_torch.core.enqueue.OffloadWindow` releasing a slot) or hand
    them to ``window.register``.

    ``part()`` raises once more parts are minted than were recorded —
    a replay that grew is a stale schedule, caught here rather than
    silently miscounted.
    """

    def __init__(
        self,
        engine: "ProgressEngine",
        expected: int,
        stream: MPIXStream = STREAM_NULL,
        name: str = "fused",
    ):
        if expected < 0:
            raise ValueError("FusedRequestSet: expected part count must be >= 0")
        self.engine = engine
        self.expected = int(expected)
        self.stream = stream
        self.name = name
        self._lock = threading.Lock()
        self.parts: List[GeneralizedRequest] = []
        self._pollable: List[GeneralizedRequest] = []
        self._done = 0
        # the one engine-registered request for the whole batch
        self.request = engine.grequest_start(
            poll_fn=self._sweep, stream=stream, name=name
        )

    def part(
        self,
        poll_fn: Optional[Callable] = None,
        *,
        extra_state: object = None,
        name: Optional[str] = None,
    ) -> GeneralizedRequest:
        """Mint the next part (unregistered request). ``poll_fn`` parts
        are completed by the parent's sweep; parts without one must be
        completed externally (``part.complete()``)."""
        with self._lock:
            if len(self.parts) >= self.expected:
                raise ValueError(
                    f"fused set {self.name!r}: part #{len(self.parts) + 1} "
                    f"exceeds the recorded count ({self.expected}) — the op "
                    f"graph changed since record(); re-record the schedule"
                )
            p = GeneralizedRequest(
                poll_fn=poll_fn,
                extra_state=extra_state,
                stream=self.stream,
                name=name or f"{self.name}-part{len(self.parts)}",
            )
            self.parts.append(p)
            if poll_fn is not None:
                self._pollable.append(p)
        p.add_done_callback(self._part_done)
        self.engine._count_fused_part()
        return p

    def _part_done(self, _part) -> None:
        with self._lock:
            self._done += 1
            finished = self._done >= self.expected
        if finished:
            self.request.complete()

    def _sweep(self, _state) -> bool:
        """Parent poll_fn: one progress visit polls every still-pending
        pollable part. Completions fire ``_part_done`` (outside our
        lock); the parent reports done once all ``expected`` parts are."""
        with self._lock:
            pending = [p for p in self._pollable if not p.done]
            self._pollable = pending
        for p in pending:
            p._poll()
        with self._lock:
            return self._done >= self.expected

    def cancel(self) -> None:
        """Abandon a replay mid-issue (stale schedule): cancel every part
        and the parent so the engine queue drains at the next sweep."""
        with self._lock:
            parts = list(self.parts)
        for p in parts:
            p.cancel()
        self.request.cancel()

    @property
    def done(self) -> bool:
        return self.request.done

    @property
    def done_count(self) -> int:
        with self._lock:
            return self._done


class ProgressEngine:
    """Sharded VCI runtime: lock-striped channel table + parkable waits
    and progress threads."""

    def __init__(
        self,
        global_lock: bool = False,
        n_stripes: int = DEFAULT_NUM_STRIPES,
        spin_s: float = 1e-4,
        adaptive_spin: bool = True,
        wait_queues: bool = True,
        sanitize: bool = False,
    ):
        # global_lock=True emulates the pre-4.0 MPICH global critical
        # section (benchmark baseline); False = per-VCI critical sections.
        self.global_lock_mode = global_lock
        self.n_stripes = 1 if global_lock else max(1, int(n_stripes))
        # wait_queues=True (default): per-channel wait queues — a notify
        # evaluates the parked predicates and wakes only the matching
        # waiters. False keeps the pre-queue stripe-CV broadcast (every
        # notify wakes every parked thread on the stripe) as the herd
        # baseline the progress_autotune benchmark measures against.
        self.wait_queues = bool(wait_queues)
        # spin-then-park: a parker spins up to this long before the CV wait.
        # adaptive_spin lets each stripe's budget grow on spin hits (to
        # spin_s * _SPIN_GROW_MAX) and shrink on real parks (to
        # spin_s / _SPIN_SHRINK_MAX) — spin_s=0 disables spinning entirely.
        self.spin_s = max(0.0, float(spin_s))
        self.adaptive_spin = bool(adaptive_spin)
        # sanitize=True threads a repro_torch.analysis.sanitizer.Sanitizer
        # through the stripe locks, blocking entries, and the request
        # lifecycle; engine.sanitizer_report() returns its findings.
        # (Deferred import: analysis is optional tooling layered on core.)
        self.sanitize = bool(sanitize)
        self._sanitizer = None
        if self.sanitize:
            from repro_torch.analysis.sanitizer import Sanitizer

            self._sanitizer = Sanitizer(self)
        # +1: the last stripe homes the implicit channel (STREAM_NULL, -1).
        self._stripes: Tuple[_Stripe, ...] = tuple(
            _Stripe(i) for i in range(self.n_stripes + 1)
        )
        for s in self._stripes:
            s.spin_budget = self.spin_s
            s.sanitizer = self._sanitizer
        self._threads: Dict[int, "_ProgressThread"] = {}
        self._threads_lock = threading.Lock()
        # single-attribute mirror of "a NULL-stream thread is registered":
        # read without _threads_lock on the enqueue hot path (benign
        # staleness, bounded by the thread's _PARK_RECHECK_S fallback)
        self._null_thread_active = False
        # Waiter-side counters (cold path), guarded by _meta_lock; hot-path
        # counters live on the stripes under their own locks.
        self._meta_lock = threading.Lock()
        self._waiter_parks = 0
        self._waiter_wakes = 0
        self._waiter_spin_hits = 0
        # fused replay batches (core.schedule): sets opened / parts minted
        self._fused_sets = 0
        self._fused_parts = 0
        # per-thread channel affinity (bind/unbind is a stack so a thread
        # attached to several communicators keeps nested bindings straight)
        self._tls = threading.local()

    def configure(self, spin_s: Optional[float] = None, adaptive_spin: Optional[bool] = None) -> None:
        """Retune the spin-then-park knobs on a live engine. ``spin_s`` is
        the base spin budget (0 disables spinning → every blocked caller
        parks immediately); per-stripe adaptive budgets are re-seeded."""
        if spin_s is not None:
            self.spin_s = max(0.0, float(spin_s))
            for s in self._stripes:
                with s.held():
                    s.spin_budget = self.spin_s
        if adaptive_spin is not None:
            self.adaptive_spin = bool(adaptive_spin)

    # -- per-thread channel affinity --------------------------------------
    def bind_thread_to_channel(self, channel: int) -> None:
        """Declare that the calling OS thread drives ``channel`` (its VCI):
        a host-threadcomm rank binds its stream's channel on attach so
        blocking paths and diagnostics know which stripe is *its* home.
        Bindings nest (stack) for threads attached to several comms."""
        stack = getattr(self._tls, "channels", None)
        if stack is None:
            stack = self._tls.channels = []
        stack.append(channel)

    def unbind_thread_channel(self, channel: Optional[int] = None) -> Optional[int]:
        """Remove a channel binding from the calling thread's stack: the
        most recent one, or — when ``channel`` is given — the most recent
        binding OF that channel (memberships need not end in LIFO order).
        Returns the removed channel, or None if nothing matched."""
        stack = getattr(self._tls, "channels", None)
        if not stack:
            return None
        if channel is None:
            return stack.pop()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == channel:
                return stack.pop(i)
        return None

    def thread_channel(self) -> Optional[int]:
        """The calling thread's current channel affinity (or None)."""
        stack = getattr(self._tls, "channels", None)
        return stack[-1] if stack else None

    # -- stripe table ----------------------------------------------------
    def _stripe(self, channel: int) -> _Stripe:
        if self.global_lock_mode:
            return self._stripes[0]
        if channel < 0:
            return self._stripes[self.n_stripes]
        return self._stripes[channel % self.n_stripes]

    def lock_for(self, channel: int) -> threading.RLock:
        """The critical-section lock guarding ``channel`` — what an issue
        path (NIC doorbell analogue) must hold. Pure arithmetic, no
        registry lock."""
        return self._stripe(channel).lock

    # kept for callers of the pre-stripe API
    _lock_for = lock_for

    @contextmanager
    def channel_section(self, channel: int):
        """Enter ``channel``'s per-VCI critical section (stripe lock),
        counting contended acquisitions in ``stats()['lock_waits']``. This
        is the public doorbell bracket: threadcomm mailboxes mutate their
        receiver's queue inside it so :meth:`park_on_channel` predicates
        observe a coherent state."""
        with self._stripe(channel).held():
            yield

    # -- the MPIX API ------------------------------------------------------
    def grequest_start(
        self,
        poll_fn: Optional[Callable] = None,
        wait_fn: Optional[Callable] = None,
        *,
        query_fn: Optional[Callable] = None,
        free_fn: Optional[Callable] = None,
        cancel_fn: Optional[Callable] = None,
        extra_state: object = None,
        stream: MPIXStream = STREAM_NULL,
        name: str = "grequest",
        fault: object = None,
    ) -> GeneralizedRequest:
        """``MPIX_Grequest_start``: create + enqueue on the stream's queue,
        then wake anything parked on the stripe (progress threads).

        ``fault=`` hands the handle's lifetime to a fault injector
        (``ft.faultinject``): the injector cancels whatever is still live
        at uninstall, so callers may drop injected handles (mpixlint's
        MPIX004 treats ``fault=`` like ``schedule=``)."""
        req = GeneralizedRequest(
            poll_fn=poll_fn,
            wait_fn=wait_fn,
            query_fn=query_fn,
            free_fn=free_fn,
            cancel_fn=cancel_fn,
            extra_state=extra_state,
            stream=stream,
            name=name,
        )
        ch = stream.channel
        stripe = self._stripe(ch)
        if fault is not None:
            fault.adopt(req)
        if self._sanitizer is not None:
            self._sanitizer.on_request_start(req)
        # completion from any thread wakes exactly the waiters it satisfies
        # on the request's own channel (notify_channel evaluates their
        # predicates; the legacy mode broadcasts to the whole stripe)
        req.add_done_callback(lambda _r, _c=ch: self.notify_channel(_c))
        with stripe.held():
            # opportunistic sweep: retire + drop requests that completed
            # externally (no poll_fn → no progress visit ever dequeues
            # them), so a long-lived channel queue can't grow unboundedly
            q = stripe.queues.setdefault(ch, [])
            if q:
                kept = []
                for old in q:
                    if old.done:
                        self._retire_locked(stripe, old)
                    else:
                        kept.append(old)
                q[:] = kept
            q.append(req)
            stripe.enqueued += 1
            stripe.chan_enqueued[ch] = stripe.chan_enqueued.get(ch, 0) + 1
            self._notify_work_locked(stripe, ch)
        if ch >= 0 and self._null_thread_active:
            # a parked NULL-stream progress thread covers every channel but
            # parks on the implicit stripe — wake it for the new work
            self._notify_stripe(self._stripes[self.n_stripes])
        return req

    def fused_start(
        self,
        n_parts: int,
        stream: MPIXStream = STREAM_NULL,
        name: str = "fused",
    ) -> FusedRequestSet:
        """Open a :class:`FusedRequestSet` expecting exactly ``n_parts``
        parts: ONE queued request (one wait/notify unit) standing for a
        whole replayed op graph. This is the batched-grequest fast path
        ``core.schedule`` replays through — per-op requests skip the
        channel-queue append, sweep, and per-request notify that
        :meth:`grequest_start` pays."""
        fused = FusedRequestSet(self, n_parts, stream=stream, name=name)
        with self._meta_lock:
            self._fused_sets += 1
        return fused

    def _count_fused_part(self) -> None:
        with self._meta_lock:
            self._fused_parts += 1

    def _notify_stripe(self, stripe: _Stripe) -> None:
        """Broad kick: wake EVERY waiter on the stripe for an unconditional
        re-check (progress-thread state changes, shutdown). Not the hot
        notify path — that is :meth:`notify_channel`."""
        with stripe.held():
            if not self.wait_queues:
                stripe.cv.notify_all()
                return
            for q in stripe.wait_queues.values():
                for w in q:
                    w.cv.notify()  # every waiter re-checks its condition

    def notify_channel(self, channel: int) -> None:
        """Wake the waiters parked on ``channel`` whose predicate now
        holds. With per-channel wait queues (the default) each parked
        waiter's predicate is evaluated under the stripe lock and only
        matching waiters are woken — a notify for one rank's mailbox or
        one window's free slot no longer wakes every thread sharing the
        stripe. With ``wait_queues=False`` this degrades to the legacy
        stripe-CV broadcast. External completion paths — e.g. an
        :class:`~repro_torch.core.enqueue.OffloadWindow` freeing a slot — call
        this so backpressured issuers resume immediately instead of
        riding out the park-recheck timeout."""
        stripe = self._stripe(channel)
        with stripe.held():
            stripe.notifies += 1
            if not self.wait_queues:
                # legacy broadcast: every parked thread on the stripe wakes
                stripe.notify_wakeups += stripe.parked_now
                stripe.cv.notify_all()
                return
            self._notify_matching_locked(stripe, channel)

    def _notify_matching_locked(self, stripe: _Stripe, channel: int) -> None:
        """Evaluate the predicates of ``channel``'s parked waiters and wake
        exactly the satisfied ones. Caller holds the stripe lock. The
        predicate may run on the *notifier's* thread — park predicates
        must not depend on thread identity."""
        q = stripe.wait_queues.get(channel)
        if not q:
            return
        true_predicates = woken = 0
        for w in list(q):
            if w.satisfied or w.predicate is None:
                continue  # already woken / kick waiter (re-scans on its own)
            if w.predicate():
                true_predicates += 1
                w.satisfied = True
                w.cv.notify()
                woken += 1
                stripe.notify_wakeups += 1
            else:
                stripe.notify_skips += 1
        if self._sanitizer is not None:
            # no-lost-wakeup invariant: a true predicate always wakes its
            # waiter (a tripwire for future refactors of this path)
            self._sanitizer.on_notify(channel, true_predicates, woken)

    def _notify_work_locked(self, stripe: _Stripe, channel: int) -> None:
        """New pollable work arrived on ``channel``: wake the progress
        thread (kick waiter) parked for it. Predicate waiters are left
        asleep — every state change they wait on has its own targeted
        notify. Caller holds the stripe lock."""
        if not self.wait_queues:
            stripe.cv.notify_all()
            return
        for w in stripe.wait_queues.get(channel, ()):
            if w.predicate is None and not w.satisfied:
                w.cv.notify()

    @staticmethod
    def _register_waiter(stripe: _Stripe, channel: int, w: _Waiter) -> None:
        stripe.wait_queues.setdefault(channel, []).append(w)

    @staticmethod
    def _deregister_waiter(stripe: _Stripe, channel: int, w: _Waiter) -> None:
        q = stripe.wait_queues.get(channel)
        if q is not None:
            try:
                q.remove(w)
            except ValueError:
                pass
            if not q:
                del stripe.wait_queues[channel]

    def park_on_channel(
        self,
        channel: int,
        predicate: Callable[[], bool],
        timeout: Optional[float] = None,
        spin_s: Optional[float] = None,
    ) -> bool:
        """Block the calling thread until ``predicate()`` holds (checked
        with the stripe lock held), spin-then-park style: first spin for
        the stripe's adaptive budget (``spin_s`` overrides it per call),
        then register on ``channel``'s wait queue and park on a per-waiter
        CV, re-checked on every wake and at least every
        ``_PARK_RECHECK_S``. Returns the final predicate value; ``False``
        only on timeout.

        This is the engine-side half of issue-path backpressure and of
        threadcomm blocking recvs: a full enqueue window parks here
        instead of busy-spinning, a thread-rank parks here for a message,
        and both are woken by :meth:`notify_channel` (request completion
        notifies the request's channel the same way). The predicate may
        be evaluated by the *notifying* thread — it must depend only on
        shared state (never thread identity), and a side-effecting
        predicate (mailbox match-and-pop) runs to a True result exactly
        once per park. It must not touch this stripe's lock-ordered
        resources beyond its own state."""
        stripe = self._stripe(channel)
        if self._sanitizer is not None:
            # entering a park while holding any stripe lock pins that
            # stripe for the whole sleep (dynamic MPIX001)
            self._sanitizer.on_block("park_on_channel", stripe.index)
        deadline = None if timeout is None else time.monotonic() + timeout

        # -- spin phase: optimistically re-check before paying a CV park --
        budget = spin_s
        if budget is None:
            budget = stripe.spin_budget if self.adaptive_spin else self.spin_s
        if budget > 0.0:
            spin_deadline = time.monotonic() + budget
            if deadline is not None:
                spin_deadline = min(spin_deadline, deadline)
            while time.monotonic() < spin_deadline:
                with stripe.held():
                    if predicate():
                        stripe.spin_hits += 1
                        if self.adaptive_spin and spin_s is None:
                            stripe.spin_budget = min(
                                self.spin_s * _SPIN_GROW_MAX,
                                max(stripe.spin_budget, self.spin_s / _SPIN_SHRINK_MAX) * 2.0,
                            )
                        return True
                time.sleep(0)  # yield the GIL between probes

        if not self.wait_queues:
            return self._park_legacy(stripe, channel, predicate, deadline, budget, spin_s)

        # -- park phase: per-channel wait queue -----------------------------
        first = True
        with stripe.held():
            w = _Waiter(stripe.lock, predicate)
            self._register_waiter(stripe, channel, w)
            try:
                while True:
                    if w.satisfied:
                        # a notify evaluated our predicate to True (and, for
                        # consuming predicates, already popped our match)
                        return True
                    if predicate():
                        w.satisfied = True
                        return True
                    if deadline is not None and time.monotonic() >= deadline:
                        return False
                    if first and budget > 0.0 and self.adaptive_spin and spin_s is None:
                        # the spin missed: shrink this stripe's budget
                        stripe.spin_budget = max(
                            self.spin_s / _SPIN_SHRINK_MAX, stripe.spin_budget / 2.0
                        )
                    first = False
                    slice_s = _PARK_RECHECK_S
                    if deadline is not None:
                        slice_s = min(slice_s, max(0.0, deadline - time.monotonic()))
                    stripe.parks += 1
                    stripe.chan_parks[channel] = stripe.chan_parks.get(channel, 0) + 1
                    stripe.parked_now += 1
                    try:
                        w.cv.wait(timeout=slice_s)
                    finally:
                        stripe.parked_now -= 1
                    stripe.wakes += 1
            finally:
                self._deregister_waiter(stripe, channel, w)

    def _park_legacy(self, stripe, channel, predicate, deadline, budget, spin_s) -> bool:
        """Pre-wait-queue park: wait on the shared stripe CV; every notify
        on the stripe wakes every parked thread (the herd baseline)."""
        first = True
        while True:
            with stripe.held():
                if predicate():
                    return True
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                if first and budget > 0.0 and self.adaptive_spin and spin_s is None:
                    # the spin missed: shrink this stripe's budget
                    stripe.spin_budget = max(
                        self.spin_s / _SPIN_SHRINK_MAX, stripe.spin_budget / 2.0
                    )
                first = False
                slice_s = _PARK_RECHECK_S
                if deadline is not None:
                    slice_s = min(slice_s, max(0.0, deadline - time.monotonic()))
                stripe.parks += 1
                stripe.chan_parks[channel] = stripe.chan_parks.get(channel, 0) + 1
                stripe.parked_now += 1
                try:
                    stripe.cv.wait(timeout=slice_s)
                finally:
                    stripe.parked_now -= 1
                stripe.wakes += 1

    def has_poller(self, channel: int) -> bool:
        """True iff a live, spun-up progress thread covers ``channel``
        (directly or via a NULL-stream thread). Waiters use this to choose
        between parking (someone else polls) and actively progressing."""
        return self._has_poller(channel)

    def _retire_locked(self, stripe: _Stripe, r: GeneralizedRequest) -> bool:
        """Count the completion + run free_fn exactly once. Caller holds the
        stripe lock. Returns True only for the first retirement."""
        if r._retired:
            return False
        r._retired = True
        stripe.completions += 1
        if self._sanitizer is not None:
            self._sanitizer.on_request_retired(r)
        if r.free_fn is not None:
            r.free_fn(r.extra_state)
        return True

    def progress(self, stream: Optional[MPIXStream] = None) -> int:
        """``MPIX_Stream_progress``: poll the queue of ``stream`` only, or
        every queue for ``None``/STREAM_NULL ("invoke general progress on
        all implicit streams"). Returns #requests completed this call."""
        if stream is None or stream.is_null:
            # the call itself is accounted to the implicit stripe
            return sum(
                self._progress_stripe(s, None, count_call=(s.index == self.n_stripes))
                for s in self._stripes
            )
        return self._progress_stripe(self._stripe(stream.channel), stream.channel, count_call=True)

    def _progress_stripe(
        self, stripe: _Stripe, channel: Optional[int], count_call: bool = False
    ) -> int:
        completed = 0
        with stripe.held():
            stripe.visits += 1
            if count_call:
                stripe.progress_calls += 1
            channels = list(stripe.queues) if channel is None else [channel]
            for ch in channels:
                q = stripe.queues.get(ch)
                if not q:
                    continue
                still = []
                for r in q:
                    stripe.polls += 1
                    stripe.chan_polls[ch] = stripe.chan_polls.get(ch, 0) + 1
                    if r._poll():
                        if self._retire_locked(stripe, r):
                            completed += 1
                    else:
                        still.append(r)
                if still:
                    q[:] = still
                else:
                    del stripe.queues[ch]
            if completed and not self.wait_queues:
                # legacy broadcast; with wait queues each completion already
                # ran its targeted notify_channel done-callback
                stripe.cv.notify_all()
        return completed

    def test(self, req: GeneralizedRequest) -> bool:
        """MPI_Test: one progress visit on the request's stream."""
        self.progress(req.stream)
        return req.done

    def wait(self, req: GeneralizedRequest, timeout: Optional[float] = None) -> bool:
        return self.wait_all([req], timeout)

    # -- waiting: batch wait_fn, then park or actively progress ------------
    def wait_all(
        self, reqs: Sequence[GeneralizedRequest], timeout: Optional[float] = None
    ) -> bool:
        """MPI_Waitall over a *mixed* set of requests — the paper's selling
        point. Batched ``wait_fn`` groups go first (whole per-stream batch,
        one call); the remainder parks on a CV when nothing needs host
        polling, else actively progresses the pending streams."""
        reqs = list(reqs)
        if self._sanitizer is not None:
            self._sanitizer.on_block("wait_all")
        deadline = None if timeout is None else time.monotonic() + timeout

        # batch wait_fn hook: one call per (wait_fn, stream-channel) batch
        by_key: Dict[Tuple[int, int], List[GeneralizedRequest]] = {}
        for r in reqs:
            if r.wait_fn is not None and not r.done:
                by_key.setdefault((id(r.wait_fn), r.stream.channel), []).append(r)
        for group in by_key.values():
            remain = None if deadline is None else max(0.0, deadline - time.monotonic())
            group[0].wait_fn([g.extra_state for g in group], remain)
            ch = group[0].stream.channel
            stripe = self._stripe(ch)
            with stripe.held():
                retired = []
                for g in group:
                    stripe.polls += 1
                    stripe.chan_polls[ch] = stripe.chan_polls.get(ch, 0) + 1
                    if g._poll():
                        self._retire_locked(stripe, g)
                        retired.append(g)
                if retired:
                    # dequeue like a progress sweep would, so pending()
                    # doesn't report already-done requests
                    q = stripe.queues.get(ch)
                    if q:
                        done_ids = set(map(id, retired))
                        q[:] = [r0 for r0 in q if id(r0) not in done_ids]
                        if not q:
                            del stripe.queues[ch]

        if all(r.done for r in reqs):
            return True

        # park/poll loop: a per-wait CV is pinged by request completion
        waiter_cv = threading.Condition()
        woke = [False]

        def _wake(_r):
            with waiter_cv:
                woke[0] = True
                waiter_cv.notify_all()
            with self._meta_lock:
                self._waiter_wakes += 1

        for r in reqs:
            r.add_done_callback(_wake)

        try:
            # spin-then-park (waiter side): a short optimistic spin catches
            # completions landing just behind the batched wait without a CV
            # round-trip; counted separately from real parks in stats().
            if self.spin_s > 0.0:
                spin_deadline = time.monotonic() + self.spin_s
                if deadline is not None:
                    spin_deadline = min(spin_deadline, deadline)
                while time.monotonic() < spin_deadline:
                    if all(r.done for r in reqs):
                        with self._meta_lock:
                            self._waiter_spin_hits += 1
                        return True
                    time.sleep(0)
            while True:
                pending = [r for r in reqs if not r.done]
                if not pending:
                    return True
                if deadline is not None and time.monotonic() >= deadline:
                    return False
                if self._can_park(pending):
                    slice_s = _PARK_RECHECK_S
                    if deadline is not None:
                        slice_s = min(slice_s, max(0.0, deadline - time.monotonic()))
                    with waiter_cv:
                        if not woke[0]:
                            with self._meta_lock:
                                self._waiter_parks += 1
                            waiter_cv.wait(timeout=slice_s)
                        woke[0] = False
                else:
                    seen = set()
                    for r in pending:
                        if r.stream.channel not in seen:
                            seen.add(r.stream.channel)
                            self.progress(r.stream)
                    time.sleep(0)  # yield between active rounds
        finally:
            # a timed-out wait must not leave wake closures on requests
            # that outlive it (e.g. a heartbeat polled with short timeouts)
            for r in reqs:
                r.remove_done_callback(_wake)

    def wait_any(
        self, reqs: Sequence[GeneralizedRequest], timeout: Optional[float] = None
    ) -> Optional[GeneralizedRequest]:
        """``MPI_Waitany`` over a mixed request set: block until the
        *first* request completes (or is cancelled) and return it.
        Returns ``None`` on timeout and for an empty sequence (the
        ``MPI_UNDEFINED`` cases). Already-done requests short-circuit —
        the lowest-indexed done request wins; among live requests the one
        whose completion lands first wins (simultaneous completions
        resolve in completion-callback order).

        The waiting discipline mirrors :meth:`wait_all`: spin briefly,
        then park on a per-wait CV pinged by request completion when
        every pending request is covered (externally completed or polled
        by a progress thread), else actively progress the pending
        streams. Batched ``wait_fn`` hooks are NOT invoked — they block
        on whole batches, the opposite of first-completion. A completion
        racing the deadline is never lost: the final timeout check
        re-reads the completion slot."""
        reqs = list(reqs)
        if not reqs:
            return None
        if self._sanitizer is not None:
            self._sanitizer.on_block("wait_any")
        for r in reqs:
            if r.done:
                return r
        deadline = None if timeout is None else time.monotonic() + timeout

        waiter_cv = threading.Condition()
        first: List[GeneralizedRequest] = []

        def _wake(r):
            with waiter_cv:
                first.append(r)
                waiter_cv.notify_all()
            with self._meta_lock:
                self._waiter_wakes += 1

        for r in reqs:
            r.add_done_callback(_wake)
        try:
            # spin phase (waiter side), as in wait_all
            if self.spin_s > 0.0:
                spin_deadline = time.monotonic() + self.spin_s
                if deadline is not None:
                    spin_deadline = min(spin_deadline, deadline)
                while time.monotonic() < spin_deadline:
                    with waiter_cv:
                        if first:
                            with self._meta_lock:
                                self._waiter_spin_hits += 1
                            return first[0]
                    time.sleep(0)
            while True:
                with waiter_cv:
                    if first:
                        return first[0]
                if deadline is not None and time.monotonic() >= deadline:
                    with waiter_cv:  # completion-vs-timeout race: re-read
                        return first[0] if first else None
                pending = [r for r in reqs if not r.done]
                if not pending:
                    # every request done yet no callback recorded (detached
                    # by a concurrent waiter): fall back to done order
                    return next(r for r in reqs if r.done)
                if self._can_park(pending):
                    slice_s = _PARK_RECHECK_S
                    if deadline is not None:
                        slice_s = min(slice_s, max(0.0, deadline - time.monotonic()))
                    with waiter_cv:
                        if not first:
                            with self._meta_lock:
                                self._waiter_parks += 1
                            waiter_cv.wait(timeout=slice_s)
                else:
                    seen = set()
                    for r in pending:
                        if r.stream.channel not in seen:
                            seen.add(r.stream.channel)
                            self.progress(r.stream)
                    time.sleep(0)  # yield between active rounds
        finally:
            for r in reqs:
                r.remove_done_callback(_wake)

    def _can_park(self, pending: Sequence[GeneralizedRequest]) -> bool:
        """A waiter may park iff no pending request depends on *us* to poll:
        either it completes externally (no poll_fn) or a running progress
        thread covers its stream."""
        for r in pending:
            if r.poll_fn is None:
                continue
            if not self._has_poller(r.stream.channel):
                return False
        return True

    def _has_poller(self, channel: int) -> bool:
        with self._threads_lock:
            for key in (channel, STREAM_NULL.channel):
                t = self._threads.get(key)
                if t is not None and t.is_alive() and t.state == _ProgressThread.BUSY:
                    return True
        return False

    # -- progress threads (spin-up / spin-down) ---------------------------
    def start_progress_thread(
        self, stream: MPIXStream = STREAM_NULL, interval: float = 0.0, park: bool = True
    ) -> bool:
        """``MPIX_Start_progress_thread``: background poller for one stream.
        ``interval`` throttles polling; ``park=True`` (default) parks the
        thread on the stripe CV whenever its queue needs no host polling —
        the user-controlled knob the paper argues for. ``park=False`` with
        ``interval=0`` reproduces the busy-spin ``MPIR_CVAR_ASYNC_PROGRESS``
        baseline the benchmarks compare against. Returns True iff a new
        thread was started (False: the channel already has one — callers
        that manage thread lifetimes, like the autotuner, must not adopt
        somebody else's thread)."""
        key = stream.channel
        with self._threads_lock:
            if key in self._threads:
                return False
            t = _ProgressThread(self, stream, interval, park)
            self._threads[key] = t
            if stream.is_null:
                self._null_thread_active = True
        t.start()
        return True

    def stop_progress_thread(self, stream: MPIXStream = STREAM_NULL) -> None:
        """``MPIX_Stop_progress_thread``."""
        with self._threads_lock:
            t = self._threads.pop(stream.channel, None)
            if stream.is_null:
                self._null_thread_active = False
        if t is not None:
            t.stop()
            t.join(timeout=5.0)

    def stop_all(self) -> None:
        with self._threads_lock:
            threads = list(self._threads.values())
            self._threads.clear()
            self._null_thread_active = False
        for t in threads:
            t.stop()
        for t in threads:
            t.join(timeout=5.0)
        if self._sanitizer is not None:
            # engine shutdown: anything started but never completed or
            # cancelled is reported as a request leak (dynamic MPIX004)
            self._sanitizer.on_stop_all()

    def sanitizer_report(self) -> dict:
        """Findings from the runtime sanitizer (lock-order cycles,
        parks-while-locked, request leaks, lost wakeups). With
        ``sanitize=False`` returns ``{"enabled": False, "findings": []}``
        so callers can assert on the findings list unconditionally."""
        if self._sanitizer is None:
            return {"enabled": False, "findings": [], "counts": {}}
        return self._sanitizer.report()

    def autotune(self, policy: Optional["AutotunePolicy"] = None) -> "Autotuner":
        """Build a stats()-driven :class:`Autotuner` for this engine: it
        samples per-channel activity (``stats(per_channel=True)``) and
        promotes hot channels onto dedicated progress threads / demotes
        idle ones, with hysteresis so placement never flaps. Drive it
        deterministically with :meth:`Autotuner.tick` (e.g. once per
        training step) or run it on a cadence with
        :meth:`Autotuner.start`. Replaces hand-placed
        ``start_progress_thread`` calls in the consumers; hand-placed
        threads are respected (never demoted, their channels never
        double-covered)."""
        return Autotuner(self, policy or AutotunePolicy())

    def pending(self, stream: Optional[MPIXStream] = None) -> int:
        if stream is None or stream.is_null:
            n = 0
            for s in self._stripes:
                with s.held():
                    n += sum(len(q) for q in s.queues.values())
            return n
        stripe = self._stripe(stream.channel)
        with stripe.held():
            return len(stripe.queues.get(stream.channel, ()))

    # -- instrumentation ---------------------------------------------------
    def stats(self, per_stripe: bool = False, per_channel: bool = False) -> dict:
        """Engine counters. ``polls`` = request poll visits, ``visits`` =
        stripe scans, ``lock_waits`` = contended stripe-lock acquisitions,
        ``parks``/``wakes`` = CV park/wake events (waiter- and
        progress-thread-side combined), ``spin_hits`` = blocked callers
        satisfied during the spin phase (no CV park paid), ``notifies`` =
        :meth:`notify_channel` calls, ``notify_wakeups`` = waiters those
        notifies actually woke (wakeups/notify is the herd factor),
        ``notify_skips`` = parked waiters a notify left asleep (predicate
        miss — always 0 in legacy broadcast mode), ``thread_loops`` =
        progress-thread loop iterations (the idle-CPU proxy).
        ``per_channel=True`` adds ``channels``: per-VCI activity
        (enqueued/polls/parks deltas + pending queue depth) — the
        autotuner's sampling surface."""
        out = {
            "polls": 0,
            "completions": 0,
            "visits": 0,
            "lock_waits": 0,
            "parks": 0,
            "wakes": 0,
            "spin_hits": 0,
            "enqueued": 0,
            "progress_calls": 0,
            "notifies": 0,
            "notify_wakeups": 0,
            "notify_skips": 0,
        }
        stripes = []
        channels: Dict[int, Dict[str, int]] = {}
        for s in self._stripes:
            with s.held():
                row = {
                    "stripe": s.index,
                    "polls": s.polls,
                    "completions": s.completions,
                    "visits": s.visits,
                    "lock_waits": s.lock_waits,
                    "parks": s.parks,
                    "wakes": s.wakes,
                    "spin_hits": s.spin_hits,
                    "spin_budget_s": s.spin_budget,
                    "enqueued": s.enqueued,
                    "progress_calls": s.progress_calls,
                    "notifies": s.notifies,
                    "notify_wakeups": s.notify_wakeups,
                    "notify_skips": s.notify_skips,
                    "pending": sum(len(q) for q in s.queues.values()),
                }
                if per_channel:
                    keys = (
                        set(s.chan_enqueued) | set(s.chan_polls)
                        | set(s.chan_parks) | set(s.queues)
                    )
                    for c in keys:
                        crow = channels.setdefault(
                            c, {"enqueued": 0, "polls": 0, "parks": 0, "pending": 0}
                        )
                        crow["enqueued"] += s.chan_enqueued.get(c, 0)
                        crow["polls"] += s.chan_polls.get(c, 0)
                        crow["parks"] += s.chan_parks.get(c, 0)
                        crow["pending"] += len(s.queues.get(c, ()))
            stripes.append(row)
            for k in (
                "polls",
                "completions",
                "visits",
                "lock_waits",
                "parks",
                "wakes",
                "spin_hits",
                "enqueued",
                "progress_calls",
                "notifies",
                "notify_wakeups",
                "notify_skips",
            ):
                out[k] += row[k]
        with self._meta_lock:
            out["parks"] += self._waiter_parks
            out["wakes"] += self._waiter_wakes
            out["spin_hits"] += self._waiter_spin_hits
            out["waiter_parks"] = self._waiter_parks
            out["waiter_wakes"] = self._waiter_wakes
            out["waiter_spin_hits"] = self._waiter_spin_hits
            out["fused_sets"] = self._fused_sets
            out["fused_parts"] = self._fused_parts
        with self._threads_lock:
            out["thread_loops"] = sum(t.loops for t in self._threads.values())
            out["n_progress_threads"] = len(self._threads)
        if per_stripe:
            out["stripes"] = stripes
        if per_channel:
            out["channels"] = channels
        return out

    def reset_stats(self) -> None:
        for s in self._stripes:
            with s.held():
                s.polls = s.completions = s.visits = 0
                s.lock_waits = s.parks = s.wakes = s.spin_hits = 0
                s.enqueued = s.progress_calls = 0
                s.notifies = s.notify_wakeups = s.notify_skips = 0
                s.chan_enqueued.clear()
                s.chan_polls.clear()
                s.chan_parks.clear()
        with self._meta_lock:
            self._waiter_parks = self._waiter_wakes = self._waiter_spin_hits = 0
            self._fused_sets = self._fused_parts = 0

    @property
    def poll_visits(self) -> int:
        """Pre-stripe name for the request-poll counter (benchmarks)."""
        return self.stats()["polls"]


class _ProgressThread(threading.Thread):
    """PROGRESS_IDLE/BUSY/EXIT state machine from the paper's example,
    extended with stripe-CV parking: when the covered queue has no
    pollable work the thread sleeps on the CV and is woken by
    ``grequest_start``/completion — near-zero idle CPU."""

    IDLE, BUSY, EXIT = 0, 1, 2

    def __init__(
        self, engine: ProgressEngine, stream: MPIXStream, interval: float, park: bool = True
    ):
        super().__init__(name=f"progress-{stream.name}", daemon=True)
        self.engine = engine
        self.stream = stream
        self.interval = interval
        self.park = park
        self.state = self.BUSY
        self.loops = 0

    def spin_down(self):
        self.state = self.IDLE
        self._kick()

    def spin_up(self):
        self.state = self.BUSY
        self._kick()

    def stop(self):
        self.state = self.EXIT
        self._kick()

    def _kick(self):
        """Wake the thread out of a CV park so state changes apply fast."""
        if self.stream.is_null:
            for s in self.engine._stripes:
                self.engine._notify_stripe(s)
        else:
            self.engine._notify_stripe(self.engine._stripe(self.stream.channel))

    def run(self):
        eng, stream = self.engine, self.stream
        # a NULL-stream thread covers every stripe; park on the implicit one
        # but re-check all (its _kick notifies every stripe).
        stripe = eng._stripe(stream.channel)
        channel = None if stream.is_null else stream.channel
        while True:
            if self.state == self.EXIT:
                break
            if self.state == self.IDLE:
                time.sleep(0.001)
                continue
            self.loops += 1
            eng.progress(stream)
            if self.park:
                parked = False
                with stripe.held():
                    if self.state == self.BUSY and not self._work_ready(channel):
                        stripe.parks += 1
                        if eng.wait_queues:
                            # kick waiter: woken by new work on this channel
                            # (grequest_start) or a broad stripe kick
                            w = _Waiter(stripe.lock, None)
                            eng._register_waiter(stripe, stream.channel, w)
                            try:
                                w.cv.wait(timeout=_PARK_RECHECK_S)
                            finally:
                                eng._deregister_waiter(stripe, stream.channel, w)
                        else:
                            stripe.cv.wait(timeout=_PARK_RECHECK_S)
                        stripe.wakes += 1
                        parked = True
                if not parked:
                    # pollable work in flight: throttle like a normal poller
                    time.sleep(self.interval if self.interval > 0 else 0)
                continue
            if self.interval > 0:
                time.sleep(self.interval)
            else:
                time.sleep(0)  # busy-poll, but yield the GIL

    def _work_ready(self, channel: Optional[int]) -> bool:
        """Pollable work present? (Caller holds the park stripe's lock for
        the single-stripe case; the NULL case takes each stripe's lock.)"""
        eng = self.engine
        if channel is not None:
            return eng._stripe(channel).needs_polling(channel)
        for s in eng._stripes:
            with s.held():
                if s.needs_polling(None):
                    return True
        return False


# ----------------------------------------------------------------------
# The stats()-driven progress autotuner
# ----------------------------------------------------------------------


@dataclass
class AutotunePolicy:
    """Knobs for the stats()-driven autotuner.

    Each :meth:`Autotuner.tick` scores every channel from the engine's
    per-channel counters: ``score = Δenqueued + Δpolls + Δparks +
    pending`` (deltas since the previous tick; ``pending`` counts queued
    requests, so demand on an *uncovered* channel scores hot even before
    anyone polls it). A channel scoring ``>= promote_score`` for
    ``hysteresis_up`` consecutive ticks is promoted onto a dedicated
    progress thread (up to ``max_threads``); a *promoted* channel scoring
    ``<= demote_score`` for ``hysteresis_down`` consecutive ticks is
    demoted. The open band between the two thresholds holds the current
    placement — together with the streak requirements this is the
    hysteresis that keeps the tuner from flapping on bursty load.

    ``tune_spin=True`` additionally feeds the engine's ``spin_hits`` /
    ``parks`` counters back into its spin budget each tick: with at least
    ``spin_samples`` blocked-caller outcomes since the last tick, a hit
    ratio ``>= spin_hi`` (spinning keeps winning) multiplies ``spin_s``
    by ``spin_grow``, and a ratio ``<= spin_lo`` (callers spin the full
    budget and park anyway — pure burned CPU) multiplies it by
    ``spin_shrink``, clamped to ``[spin_min, spin_max]`` and applied via
    :meth:`ProgressEngine.configure` (which re-seeds the per-stripe
    adaptive budgets). An engine running with ``spin_s == 0`` — spinning
    explicitly disabled — is never touched."""

    interval: float = 0.05  # background tick period (Autotuner.start)
    promote_score: float = 4.0  # per-tick activity that counts as hot
    demote_score: float = 0.0  # per-tick activity that counts as idle
    hysteresis_up: int = 2  # consecutive hot ticks before promoting
    hysteresis_down: int = 4  # consecutive idle ticks before demoting
    max_threads: int = 4  # cap on autotuner-managed progress threads
    thread_interval: float = 0.0  # interval= for promoted threads
    park: bool = True  # park= for promoted threads
    # -- autotuner-driven spin budget (ROADMAP item 4) -------------------
    tune_spin: bool = False  # feed spin_hits/parks back into configure()
    spin_hi: float = 0.6  # hit ratio at/above which the budget grows
    spin_lo: float = 0.2  # hit ratio at/below which it shrinks
    spin_grow: float = 2.0  # multiplicative grow step
    spin_shrink: float = 0.5  # multiplicative shrink step
    spin_min: float = 1e-6  # floor (a tuned budget never reaches 0)
    spin_max: float = 1e-3  # ceiling
    spin_samples: int = 4  # min (Δhits + Δparks) per tick to act on

    def __post_init__(self):
        if self.demote_score >= self.promote_score:
            raise ValueError(
                "AutotunePolicy: demote_score must sit strictly below "
                "promote_score (the gap is the hysteresis band)"
            )
        if self.hysteresis_up < 1 or self.hysteresis_down < 1:
            raise ValueError("AutotunePolicy: hysteresis streaks must be >= 1")
        if self.max_threads < 1:
            raise ValueError("AutotunePolicy: max_threads must be >= 1")
        if not (0.0 <= self.spin_lo < self.spin_hi <= 1.0):
            raise ValueError(
                "AutotunePolicy: need 0 <= spin_lo < spin_hi <= 1 (the gap "
                "is the spin-tuning hysteresis band)"
            )
        if self.spin_grow <= 1.0 or not (0.0 < self.spin_shrink < 1.0):
            raise ValueError(
                "AutotunePolicy: spin_grow must be > 1 and spin_shrink in (0, 1)"
            )
        if not (0.0 < self.spin_min <= self.spin_max):
            raise ValueError("AutotunePolicy: need 0 < spin_min <= spin_max")
        if self.spin_samples < 1:
            raise ValueError("AutotunePolicy: spin_samples must be >= 1")


class Autotuner:
    """Moves hot streams onto dedicated progress threads, off ``stats()``.

    Created via :meth:`ProgressEngine.autotune`. ``tick()`` is one
    sampling + decision step — deterministic given the counter deltas, so
    tests and training loops drive it directly; ``start()`` runs it on
    ``policy.interval`` in a daemon thread. The tuner only ever stops
    threads it started itself (``placements()``); channels already
    covered by a hand-placed or NULL-stream progress thread are skipped.
    """

    def __init__(self, engine: ProgressEngine, policy: AutotunePolicy):
        self.engine = engine
        self.policy = policy
        self._lock = threading.Lock()
        self._managed: Dict[int, MPIXStream] = {}
        self._last: Dict[int, Tuple[int, int, int]] = {}
        self._hot: Dict[int, int] = {}  # consecutive hot-tick streaks
        self._idle: Dict[int, int] = {}  # consecutive idle-tick streaks
        self._scores: Dict[int, float] = {}
        self._ticks = 0
        self._promotions = 0
        self._demotions = 0
        # spin-budget feedback baseline + move counters (tune_spin)
        self._spin_last: Tuple[int, int] = (0, 0)
        self._spin_grows = 0
        self._spin_shrinks = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -- one decision step -------------------------------------------------
    def tick(self) -> dict:
        """Sample per-channel activity and apply the policy once. Returns
        ``{"promoted": [...], "demoted": [...], "scores": {...}}``."""
        pol = self.policy
        st = self.engine.stats(per_channel=True)
        chans = st["channels"]
        with self._lock:
            self._ticks += 1
            promoted: List[int] = []
            demoted: List[int] = []
            scores: Dict[int, float] = {}
            for c, row in sorted(chans.items()):
                if c < 0:
                    continue  # the implicit channel belongs to NULL threads
                prev = self._last.get(c, (0, 0, 0))
                cur = (row["enqueued"], row["polls"], row["parks"])
                self._last[c] = cur
                # clamp: a reset_stats() mid-flight re-baselines, not demotes
                delta = sum(max(0, a - b) for a, b in zip(cur, prev))
                score = delta + row["pending"]
                scores[c] = score
                if score >= pol.promote_score:
                    self._hot[c] = self._hot.get(c, 0) + 1
                    self._idle.pop(c, None)
                elif score <= pol.demote_score:
                    self._idle[c] = self._idle.get(c, 0) + 1
                    self._hot.pop(c, None)
                else:
                    # the hysteresis band: hold the current placement
                    self._hot.pop(c, None)
                    self._idle.pop(c, None)
                if (
                    c not in self._managed
                    and self._hot.get(c, 0) >= pol.hysteresis_up
                    and len(self._managed) < pol.max_threads
                    and not self.engine.has_poller(c)
                ):
                    stream = MPIXStream(
                        sid=-2, name=f"autotune-ch{c}", kind="compute", channel=c
                    )
                    if self.engine.start_progress_thread(
                        stream, interval=pol.thread_interval, park=pol.park
                    ):
                        self._managed[c] = stream
                        self._promotions += 1
                        promoted.append(c)
                    # else: a thread appeared on this channel between the
                    # has_poller check and here (e.g. a spun-down hand-placed
                    # one) — never adopt it; demoting it later would stop a
                    # thread the user owns
                    self._hot.pop(c, None)
                elif c in self._managed and self._idle.get(c, 0) >= pol.hysteresis_down:
                    self.engine.stop_progress_thread(self._managed.pop(c))
                    self._demotions += 1
                    self._idle.pop(c, None)
                    demoted.append(c)
            if pol.tune_spin:
                self._tune_spin_locked(st)
            self._scores = scores
            return {
                "promoted": promoted,
                "demoted": demoted,
                "scores": scores,
                "spin_s": self.engine.spin_s,
            }

    def _tune_spin_locked(self, st: dict) -> None:
        """Feed the blocked-caller spin/park outcome ratio back into the
        engine's spin budget (see :class:`AutotunePolicy`). Caller holds
        ``self._lock``; ``configure`` takes only stripe locks."""
        pol = self.policy
        cur = (st["spin_hits"], st["parks"])
        prev, self._spin_last = self._spin_last, cur
        # clamp: a reset_stats() mid-flight re-baselines, not shrinks
        hits = max(0, cur[0] - prev[0])
        parks = max(0, cur[1] - prev[1])
        total = hits + parks
        spin = self.engine.spin_s
        # spin_s == 0 is an explicit "never spin" — do not re-enable it;
        # and under spin_samples outcomes the ratio is noise.
        if spin <= 0.0 or total < pol.spin_samples:
            return
        ratio = hits / total
        if ratio >= pol.spin_hi and spin < pol.spin_max:
            self.engine.configure(spin_s=min(pol.spin_max, spin * pol.spin_grow))
            self._spin_grows += 1
        elif ratio <= pol.spin_lo and spin > pol.spin_min:
            self.engine.configure(spin_s=max(pol.spin_min, spin * pol.spin_shrink))
            self._spin_shrinks += 1

    # -- background mode ---------------------------------------------------
    def start(self) -> "Autotuner":
        """Tick on ``policy.interval`` in a daemon thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="progress-autotune", daemon=True
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.policy.interval):
            self.tick()

    def stop(self, demote: bool = True) -> None:
        """Stop the background thread; ``demote=True`` (default) also
        spins down every thread the tuner started."""
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            self._stop_evt.set()
            t.join(timeout=5.0)
        if demote:
            with self._lock:
                managed = dict(self._managed)
                self._managed.clear()
            for stream in managed.values():
                self.engine.stop_progress_thread(stream)
                with self._lock:
                    self._demotions += 1

    # -- introspection -----------------------------------------------------
    def placements(self) -> List[int]:
        """Channels currently covered by autotuner-managed threads."""
        with self._lock:
            return sorted(self._managed)

    def stats(self) -> dict:
        with self._lock:
            return {
                "ticks": self._ticks,
                "promotions": self._promotions,
                "demotions": self._demotions,
                "active": sorted(self._managed),
                "scores": dict(self._scores),
                "spin_s": self.engine.spin_s,
                "spin_grows": self._spin_grows,
                "spin_shrinks": self._spin_shrinks,
            }


# ----------------------------------------------------------------------
# Module-level default engine + functional API (mirrors the C names)
# ----------------------------------------------------------------------

_default_engine = ProgressEngine()


def default_engine() -> ProgressEngine:
    return _default_engine


def grequest_start(*args, engine: Optional[ProgressEngine] = None, **kw) -> GeneralizedRequest:
    return (engine or _default_engine).grequest_start(*args, **kw)


def grequest_complete(req: GeneralizedRequest) -> None:
    req.complete()


def stream_progress(stream: MPIXStream = STREAM_NULL, engine: Optional[ProgressEngine] = None) -> int:
    return (engine or _default_engine).progress(stream)


def start_progress_thread(
    stream: MPIXStream = STREAM_NULL,
    interval: float = 0.0,
    engine: Optional[ProgressEngine] = None,
    park: bool = True,
) -> bool:
    return (engine or _default_engine).start_progress_thread(stream, interval, park)


def stop_progress_thread(stream: MPIXStream = STREAM_NULL, engine: Optional[ProgressEngine] = None) -> None:
    (engine or _default_engine).stop_progress_thread(stream)
