"""Thread communicators (paper ext. 5), host mode: real threads as ranks.

The paper's ``MPIX_Threadcomm`` builds ONE communicator of size N·M from N
processes × M threads, so code written against MPI ranks runs unchanged
over the whole hierarchy. This module is its in-process level, on the
port's progress engine: :class:`HostThreadComm` admits real
``threading.Thread`` workers as first-class ranks.

* ``host_threadcomm_init(n)`` ≈ ``MPIX_Threadcomm_init(comm, n)``;
* :meth:`HostThreadComm.start` activates the comm (allocates one VCI
  channel — an :class:`~repro_torch.core.streams.MPIXStream` — per rank
  from the finite pool, so each thread drives *its own* stripe of the
  progress engine);
* each spawned thread calls :meth:`HostThreadComm.attach` (the paper's
  per-thread ``MPIX_Threadcomm_start``) and gets a :class:`ThreadRank`
  handle: its rank, its stream identity, pt2pt (:meth:`ThreadRank.send`
  / :meth:`ThreadRank.recv` — zero-copy mailbox handoff, the paper's
  small-message shortcut), and host collectives
  (:mod:`repro_torch.core.threadcoll`);
* :meth:`ThreadRank.detach` ≈ per-thread ``MPIX_Threadcomm_finish``;
  the owner's :meth:`HostThreadComm.finish` waits for every rank to
  leave, verifies no message was left undelivered, and returns the
  channels to the pool.

Blocked ranks **park** on their channel's stripe CV via
``ProgressEngine.park_on_channel`` (spin-then-park): a recv with no
matching message costs zero host polling, and the sender's
``notify_channel`` wakes exactly the stripe that owns the destination.

**Mesh-axis level — mesh positions as "threads".** A :class:`ThreadComm`
*flattens* an ordered axis tuple (``pod`` × intra-pod ranks) into one
communicator activated inside a :func:`shard_map` region, where every mesh
position is a thread-rank with its own CUDA stream
(:mod:`repro_torch.core.mesh`). The same algebra (flatten / split / sub)
powers the *hierarchical* collectives in
:mod:`repro_torch.core.hierarchical`.

**Hybrid.** :meth:`ThreadComm.with_host_threads` composes the two into a
:class:`HybridThreadComm` presenting one flat rank space of
``mesh_size × nthreads`` — rank = mesh-flat-rank · nthreads + thread
rank, exactly the paper's "ranks 0..M-1 live in process 0" numbering.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import threadcoll
from repro_torch.core.mesh import P, axis_index, shard_map
from repro_torch.core.progress import GeneralizedRequest, ProgressEngine, default_engine
from repro_torch.core.streams import (
    STREAM_NULL,
    MPIXStream,
    StreamComm,
    StreamPool,
    axis_size,
    default_pool,
)

__all__ = [
    "shard_map",
    "ThreadComm",
    "threadcomm_init",
    "threadcomm_free",
    "comm_test_threadcomm",
    "flatten_comm",
    "split_comm",
    "ANY_SOURCE",
    "ANY_TAG",
    "ThreadRank",
    "RecvFuture",
    "HostThreadComm",
    "HybridThreadComm",
    "host_threadcomm_init",
    "tc_send",
    "tc_recv",
]

#: Wildcard source rank for :meth:`ThreadRank.recv` (MPI_ANY_SOURCE).
ANY_SOURCE = -1


class _AnyTag:
    """Singleton wildcard tag (MPI_ANY_TAG). Matches any *user* tag;
    collective-internal traffic (tags namespaced by
    :mod:`repro_torch.core.threadcoll`) is never matched, so a wildcard recv
    can't steal a barrier/bcast hop racing through the same mailbox."""

    __slots__ = ()

    def __repr__(self) -> str:
        return "ANY_TAG"


ANY_TAG = _AnyTag()


def _tag_matches(want, t) -> bool:
    """Does a recv/probe asking for ``want`` match a message tagged ``t``?"""
    if want is ANY_TAG:
        return not (isinstance(t, tuple) and t and t[0] == threadcoll._COLL)
    return t == want


# ----------------------------------------------------------------------
# Host-thread level: real threads join the communicator
# ----------------------------------------------------------------------


class _Mailbox:
    """One rank's inbound queue: (src, tag, payload) triples, FIFO per
    (src, tag) pair, plus the rank's *posted receives* (irecv futures
    matched at send time). All access happens inside the receiver's VCI
    channel critical section (``engine.channel_section``), which is the
    same stripe lock its blocked recv parks on — append + notify is
    therefore race-free against the park predicate."""

    __slots__ = ("messages", "pending", "delivered")

    def __init__(self):
        self.messages: deque = deque()
        # posted receives, FIFO by post order: (src, tag, state) with
        # ``state`` the irecv grequest's extra_state dict
        self.pending: deque = deque()
        self.delivered = 0

    def match_pop(self, src: int, tag):
        """Pop the first message matching (src, tag); ANY_SOURCE matches
        any sender, ANY_TAG any non-collective tag. Returns the
        (src, tag, payload) triple or None."""
        for i, (s, t, _p) in enumerate(self.messages):
            if (src == ANY_SOURCE or s == src) and _tag_matches(tag, t):
                m = self.messages[i]
                del self.messages[i]
                self.delivered += 1
                return m
        return None

    def match_peek(self, src: int, tag):
        """First message matching (src, tag) WITHOUT removing it — the
        probe/iprobe primitive (the no-steal guarantee is exactly this:
        a probe never dequeues)."""
        for (s, t, _p) in self.messages:
            if (src == ANY_SOURCE or s == src) and _tag_matches(tag, t):
                return (s, t, _p)
        return None

    def match_pending(self, sender: int, tag):
        """First *posted receive* this incoming (sender, tag) message can
        fulfill, removed from the post queue; None if none matches.
        Posted receives beat mailbox parking: a message is handed to the
        earliest-posted matching irecv before it ever hits the queue."""
        for i, (want_src, want_tag, state) in enumerate(self.pending):
            if (want_src == ANY_SOURCE or want_src == sender) and _tag_matches(want_tag, tag):
                entry = self.pending[i]
                del self.pending[i]
                self.delivered += 1
                return entry
        return None


@dataclass
class RecvFuture:
    """Handle for a posted receive (:meth:`ThreadRank.irecv`): completes
    when a matching send lands (the sender fulfills it inside the
    destination channel's critical section — the message never touches
    the mailbox queue). ``payload``/``source``/``tag`` are valid once
    matched; :meth:`wait` blocks through the engine's parking wait, and
    the underlying ``grequest`` composes with
    :meth:`~repro_torch.core.progress.ProgressEngine.wait_any` — block on the
    first of several posted receives. A post you no longer want must be
    :meth:`cancel`-ed — an abandoned live post would swallow a later
    matching send and leak its request in the engine queue."""

    grequest: GeneralizedRequest
    engine: ProgressEngine
    _withdraw: Optional[Callable[[], bool]] = None

    @property
    def matched(self) -> bool:
        return self.grequest.extra_state["matched"]

    @property
    def done(self) -> bool:
        return self.grequest.done

    def _state(self, field_name: str):
        st = self.grequest.extra_state
        if not st["matched"]:
            raise RuntimeError("RecvFuture: receive not matched yet")
        return st[field_name]

    @property
    def payload(self):
        return self._state("payload")

    @property
    def source(self) -> int:
        return self._state("src")

    @property
    def tag(self):
        return self._state("tag")

    def wait(self, timeout: Optional[float] = None):
        """Block until matched; returns the payload. Raises TimeoutError
        on timeout — the post stays live (a later send still fulfills
        it); call :meth:`cancel` to withdraw it instead."""
        if not self.engine.wait(self.grequest, timeout):
            raise TimeoutError("RecvFuture: wait timed out")
        if not self.matched:
            raise RuntimeError("RecvFuture: receive cancelled (epoch finished?)")
        return self.payload

    def cancel(self) -> bool:
        """Withdraw the post. Returns True if it was still unmatched (the
        post is removed and the request cancelled so the engine can sweep
        it); False if a send already fulfilled it — the payload is yours
        and must be consumed."""
        if self._withdraw is not None and self._withdraw():
            self.grequest.cancel()
            return True
        return False


@dataclass
class ThreadRank:
    """A thread's identity inside a :class:`HostThreadComm`: the handle
    returned by :meth:`HostThreadComm.attach`, valid until
    :meth:`detach`. Carries the rank number and the thread's execution
    context — its :class:`~repro_torch.core.streams.MPIXStream`, whose channel
    is the VCI this thread drives."""

    comm: "HostThreadComm"
    rank: int
    stream: MPIXStream
    thread_ident: int = field(default_factory=threading.get_ident)
    _detached: bool = field(default=False, init=False)
    _coll_seq: "itertools.count" = field(default_factory=itertools.count, init=False)
    sends: int = field(default=0, init=False)
    recvs: int = field(default=0, init=False)

    # -- pt2pt ----------------------------------------------------------
    def send(self, dst: int, obj, tag=0) -> None:
        self.comm._send(self, dst, obj, tag)

    def recv(self, src: int = ANY_SOURCE, tag=0, timeout: Optional[float] = None):
        """Blocking receive. ``src=ANY_SOURCE`` / ``tag=ANY_TAG`` wildcard
        over senders / user tags (earliest-delivered message wins)."""
        return self.comm._recv(self, src, tag, timeout)

    def irecv(self, src: int = ANY_SOURCE, tag=0) -> RecvFuture:
        """Post a receive (``MPI_Irecv``): returns a :class:`RecvFuture`
        the matching send completes. Posted receives are matched FIFO by
        post order, ahead of any mailbox-parked blocking recv."""
        return self.comm._irecv(self, src, tag)

    def probe(self, src: int = ANY_SOURCE, tag=0, timeout: Optional[float] = None):
        """Block until a matching message is *available* without
        receiving it (``MPI_Probe``): returns its (src, tag) envelope.
        The message stays queued — a following recv gets it."""
        return self.comm._probe(self, src, tag, timeout)

    def iprobe(self, src: int = ANY_SOURCE, tag=0):
        """Non-blocking probe (``MPI_Iprobe``): the (src, tag) envelope of
        the first matching queued message, or None. Never dequeues — the
        no-steal guarantee (repeated iprobes see the same message until
        someone recvs it)."""
        return self.comm._iprobe(self, src, tag)

    # -- collectives (threadcoll algorithms over the pt2pt layer) --------
    def barrier(self, timeout: Optional[float] = None) -> None:
        threadcoll.barrier(self, timeout=timeout)

    def bcast(self, obj=None, root: int = 0, timeout: Optional[float] = None):
        return threadcoll.bcast(self, obj, root=root, timeout=timeout)

    def reduce(self, value, op="sum", root: int = 0, timeout: Optional[float] = None):
        return threadcoll.reduce(self, value, op=op, root=root, timeout=timeout)

    def allreduce(self, value, op="sum", timeout: Optional[float] = None,
                  large_threshold: Optional[int] = None):
        return threadcoll.allreduce(self, value, op=op, timeout=timeout,
                                    large_threshold=large_threshold)

    def reduce_scatter(self, value, op="sum", timeout: Optional[float] = None):
        return threadcoll.reduce_scatter(self, value, op=op, timeout=timeout)

    def allgather(self, value, timeout: Optional[float] = None):
        return threadcoll.allgather(self, value, timeout=timeout)

    def allreduce_large(self, value, op="sum", timeout: Optional[float] = None):
        return threadcoll.allreduce_large(self, value, op=op, timeout=timeout)

    def alltoall(self, items: Sequence, timeout: Optional[float] = None) -> List:
        return threadcoll.alltoall(self, items, timeout=timeout)

    def _next_coll_seq(self) -> int:
        return next(self._coll_seq)

    # -- recorded schedules (core.schedule) ------------------------------
    def send_scheduled(
        self,
        schedule,
        dst: int,
        obj=None,
        tag=0,
        *,
        bind: Optional[str] = None,
        payload_fn: Optional[Callable] = None,
    ) -> None:
        """Record a send to ``dst`` into ``schedule`` — validation,
        destination channel and mailbox resolve once, at record time; the
        record pass delivers eagerly. ``bind=`` names the replay binding
        that supplies the payload (omit to replay the constant ``obj``);
        ``payload_fn=`` computes it at issue time from the replay context
        (``payload_fn(ctx)``) — the data-dependent-hop form the ring
        collectives use, where round k+1 forwards a fold of round k's
        receive held in ``ctx.scratch``."""
        self.comm._record_send(schedule, self, dst, obj, tag, bind, payload_fn)

    def recv_scheduled(
        self,
        schedule,
        src: int,
        tag=0,
        *,
        out: Optional[str] = None,
        into: Optional[str] = None,
        timeout: Optional[float] = None,
    ):
        """Record the matching receive: each replay posts a fused *part*
        the sender's delivery completes (no per-recv engine request).
        ``out=`` stores each replay's payload in ``ctx.outputs[out]``.
        ``into=`` makes the replayed recv *blocking at issue time*: the
        issuing thread parks until the payload lands and stores it in
        ``ctx.scratch[into]`` — required when a later op in the same
        schedule consumes the payload (ring-collective folds). Blocks for
        and returns the record pass's payload."""
        return self.comm._record_recv(schedule, self, src, tag, out, timeout, into)

    # -- identity -------------------------------------------------------
    def as_stream_comm(self, mesh=None, axes: Sequence[str] = ()) -> StreamComm:
        """This thread's execution context as a stream communicator
        (``MPIX_Stream_comm_create`` with the rank's own stream): device
        collectives issued through it are attributed to — and serialized
        on — this thread's channel."""
        axes = tuple(axes) if axes else (("__host__",) if mesh is None else tuple(mesh.shape))
        return StreamComm(axes, (self.stream,), mesh)

    @property
    def channel(self) -> int:
        return self.stream.channel

    def detach(self) -> None:
        """Per-thread ``MPIX_Threadcomm_finish``: leave the communicator.
        The rank number becomes joinable again only after the owner's
        :meth:`HostThreadComm.finish` + a fresh :meth:`start`."""
        self.comm._detach(self)


class HostThreadComm:
    """A communicator whose ranks are real host threads (paper ext. 5).

    ``HostThreadComm(n)`` declares n thread-ranks; :meth:`start` activates
    it (one compute stream — one VCI channel — per rank, or a single
    shared channel with ``shared_channel=True``, the contended baseline
    the benchmark compares against); worker threads :meth:`attach` in any
    order, exchange messages and collectives through their handles, then
    :meth:`ThreadRank.detach`; the owner's :meth:`finish` completes the
    epoch. A comm is re-startable: ``start``/``finish`` brackets may
    repeat (fresh channels each epoch).

    ``heartbeat=`` wires rank liveness into a failure detector: any
    object with a heartbeat monitor's ``add_rank``/``record``/
    ``remove_rank`` methods. Attach registers the rank, every mailbox op
    pings it, detach deregisters — a stalled thread-rank trips the
    detector.
    """

    def __init__(
        self,
        nthreads: int,
        engine: Optional[ProgressEngine] = None,
        pool: Optional[StreamPool] = None,
        shared_channel: bool = False,
        heartbeat=None,
        mailbox_capacity: Optional[int] = None,
        fault_hook=None,
        name: str = "host-tc",
    ):
        if nthreads < 1:
            raise ValueError(f"HostThreadComm needs >= 1 thread, got {nthreads}")
        if mailbox_capacity is not None and mailbox_capacity < 1:
            raise ValueError(f"mailbox_capacity must be >= 1, got {mailbox_capacity}")
        self.nthreads = nthreads
        self.engine = engine or default_engine()
        self.pool = pool or default_pool()
        self.shared_channel = shared_channel
        self.heartbeat = heartbeat
        # bounded mailboxes: a send to a full queue parks the SENDER on the
        # destination's per-channel wait queue until a recv frees a slot —
        # flow control rides the same park/notify machinery as blocked
        # receives, so a fast producer can't grow a slow consumer's queue
        # without bound. None = unbounded.
        self.mailbox_capacity = mailbox_capacity
        # fault-injection seam (ft.faultinject): called as
        # fault_hook(site, rank=..., dst=...) at the top of every mailbox
        # op; may raise (kill/timeout faults) or sleep (stall/delay).
        self.fault_hook = fault_hook
        self._bp_parks = 0
        self.name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._active = False
        self._streams: List[MPIXStream] = []
        self._mailboxes: List[_Mailbox] = []
        self._attached: Dict[int, ThreadRank] = {}
        self._departed: set = set()
        self._next_rank = 0
        self._epoch = 0

    # -- geometry (communicator protocol) --------------------------------
    def size(self) -> int:
        return self.nthreads

    @property
    def is_threadcomm(self) -> bool:
        return self.nthreads > 1

    def rank_ids(self) -> List[int]:
        return list(range(self.nthreads))

    def attached_count(self) -> int:
        with self._lock:
            return len(self._attached)

    @property
    def active(self) -> bool:
        return self._active

    def channels(self) -> List[int]:
        """The VCI channel driven by each rank (distinct per rank unless
        ``shared_channel``)."""
        return [s.channel for s in self._streams]

    # -- the start/attach/finish bracket ---------------------------------
    def start(self) -> "HostThreadComm":
        """Activate the communicator: allocate the per-rank VCI channels
        and open the mailboxes. Idempotent start is an error (brackets
        must nest cleanly, like the paper's start/finish epochs)."""
        with self._lock:
            if self._active:
                raise RuntimeError(f"HostThreadComm({self.name}): start() while active")
            if self.shared_channel:
                s = self.pool.create(name=f"{self.name}-shared")
                self._streams = [s] * self.nthreads
            else:
                self._streams = [
                    self.pool.create(name=f"{self.name}-r{r}") for r in range(self.nthreads)
                ]
            self._mailboxes = [_Mailbox() for _ in range(self.nthreads)]
            self._attached = {}
            self._departed = set()
            self._next_rank = 0
            self._epoch += 1
            self._active = True
        return self

    def attach(self, rank: Optional[int] = None) -> ThreadRank:
        """Join the calling thread as a rank (out-of-order joins are fine:
        pass an explicit ``rank``, or take the next unclaimed one). Binds
        the thread's channel affinity in the progress engine.

        A rank that detached mid-epoch is NOT re-joinable until the
        owner's :meth:`finish` + a fresh :meth:`start` — its mailbox may
        still hold messages addressed to the departed thread, which a
        new occupant must never inherit."""
        with self._lock:
            if not self._active:
                raise RuntimeError(f"HostThreadComm({self.name}): attach() before start()")
            if rank is None:
                while self._next_rank in self._attached or self._next_rank in self._departed:
                    self._next_rank += 1
                rank = self._next_rank
            if not (0 <= rank < self.nthreads):
                raise ValueError(f"rank {rank} out of range [0, {self.nthreads})")
            if rank in self._attached:
                raise RuntimeError(f"rank {rank} already attached")
            if rank in self._departed:
                raise RuntimeError(
                    f"rank {rank} detached mid-epoch; finish() + start() a fresh "
                    "epoch before reusing it"
                )
            handle = ThreadRank(self, rank, self._streams[rank])
            self._attached[rank] = handle
        self.engine.bind_thread_to_channel(handle.channel)
        if self.heartbeat is not None:
            self.heartbeat.add_rank(rank)
            self.heartbeat.record(rank)
        return handle

    def _detach(self, handle: ThreadRank) -> None:
        with self._lock:
            if handle._detached:
                return
            handle._detached = True
            self._attached.pop(handle.rank, None)
            self._departed.add(handle.rank)
            self._cv.notify_all()
        # the affinity registry is per-thread state: only the thread that
        # attached can clear its own binding (a detach issued from another
        # thread — e.g. an owner tearing down a worker's handle — leaves
        # that worker's binding to expire with the thread), and the
        # channel-targeted unbind keeps non-LIFO membership ends straight
        if threading.get_ident() == handle.thread_ident:
            self.engine.unbind_thread_channel(handle.channel)
        if self.heartbeat is not None:
            self.heartbeat.remove_rank(handle.rank)

    def finish(self, timeout: Optional[float] = None, drain: bool = False) -> int:
        """Owner-side epoch close: wait until every attached rank has
        detached, then verify the mailboxes drained. Undelivered messages
        mean a send had no matching recv — ``finish`` raises (the comm
        stays active so the leak can be inspected) unless ``drain=True``,
        which discards them. Returns the number of discarded messages;
        frees the channels back to the stream pool."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            if not self._active:
                raise RuntimeError(f"HostThreadComm({self.name}): finish() while inactive")
            while self._attached:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"HostThreadComm({self.name}): ranks {sorted(self._attached)} "
                        "still attached at finish()"
                    )
                self._cv.wait(timeout=remaining if remaining is not None else 0.25)
            leftover = sum(len(mb.messages) for mb in self._mailboxes)
            if leftover and not drain:
                pending = {
                    r: [(s, t) for (s, t, _p) in mb.messages]
                    for r, mb in enumerate(self._mailboxes)
                    if mb.messages
                }
                raise RuntimeError(
                    f"HostThreadComm({self.name}): finish() with {leftover} undelivered "
                    f"message(s) in flight {pending}; recv them or pass drain=True"
                )
            for mb in self._mailboxes:
                mb.messages.clear()
                # dangling posted receives (irecv never matched): cancel so
                # any future wait on them wakes instead of hanging forever
                for (_s, _t, state) in mb.pending:
                    state["request"].cancel()
                mb.pending.clear()
            streams = self._streams if not self.shared_channel else self._streams[:1]
            for s in streams:
                self.pool.free(s)
            self._streams = []
            self._mailboxes = []
            self._active = False
        return leftover

    # -- pt2pt transport (the per-pair mailbox layer) ---------------------
    def _check_handle(self, handle: ThreadRank) -> None:
        if handle._detached or not self._active:
            raise RuntimeError(
                f"HostThreadComm({self.name}): operation on a detached/finished rank"
            )

    def _send(self, handle: ThreadRank, dst: int, obj, tag) -> None:
        """Zero-copy handoff: inside the destination channel's critical
        section the message first tries to fulfill the earliest-posted
        matching receive (irecv) — handed over without ever touching the
        queue — else the payload *reference* is appended to the
        destination's mailbox; then that channel is notified — the
        paper's single-queue-hop small-message shortcut (no request
        object on the mailbox path)."""
        self._check_handle(handle)
        if self.fault_hook is not None:
            self.fault_hook("tc.send", rank=handle.rank, dst=dst)
        if not (0 <= dst < self.nthreads):
            raise ValueError(f"send dst {dst} out of range [0, {self.nthreads})")
        dst_ch = self._streams[dst].channel
        mb = self._mailboxes[dst]
        cap = self.mailbox_capacity
        src_rank = handle.rank
        matched_box: List = []

        def deliver() -> bool:
            # runs under the destination channel's stripe lock (either the
            # channel_section fast path or the park predicate): fulfill
            # the earliest posted receive, else append if a slot is free.
            entry = mb.match_pending(src_rank, tag)
            if entry is not None:
                _ws, _wt, state = entry
                state["payload"] = obj
                state["src"] = src_rank
                state["tag"] = tag
                state["matched"] = True
                matched_box.append(state)
                return True
            if cap is None or len(mb.messages) < cap:
                mb.messages.append((src_rank, tag, obj))
                return True
            return False

        delivered = False
        with self.engine.channel_section(dst_ch):
            delivered = deliver()
        if not delivered:
            # mailbox full: backpressure — park on the destination channel's
            # wait queue until a recv pops a slot free (it notifies the
            # channel). Bounded park slices so a receiver that detached
            # under us turns into an error, not a hang.
            while not delivered:
                delivered = self.engine.park_on_channel(dst_ch, deliver, timeout=1.0)
                if delivered:
                    break
                with self._lock:
                    dead = not self._active or dst in self._departed
                if dead:
                    raise RuntimeError(
                        f"HostThreadComm({self.name}): send to rank {dst} backpressured "
                        "on a full mailbox whose receiver departed"
                    )
                if self.fault_hook is not None:
                    # a receiver that dies while we are parked must break the
                    # backpressure wait (RankKilled/SendTimeout), not leave
                    # the sender parked on a mailbox no one will ever drain
                    self.fault_hook("tc.send", rank=handle.rank, dst=dst)
            with self._lock:
                self._bp_parks += 1
        matched = matched_box[0] if matched_box else None
        handle.sends += 1
        if self.heartbeat is not None:
            self.heartbeat.record(handle.rank)
        if matched is not None:
            # outside the critical section: completion callbacks (wait/
            # wait_any wakeups) must not run under the stripe lock
            matched["request"].complete()
        else:
            self.engine.notify_channel(dst_ch)

    def _irecv(self, handle: ThreadRank, src: int, tag) -> RecvFuture:
        """Post a receive on the handle's mailbox: matched immediately if
        a queued message fits, else parked in the post queue for
        :meth:`_send` to fulfill. All under the channel's critical
        section, so post vs. deliver cannot race."""
        self._check_handle(handle)
        if src != ANY_SOURCE and not (0 <= src < self.nthreads):
            raise ValueError(f"irecv src {src} out of range [0, {self.nthreads})")
        mb = self._mailboxes[handle.rank]
        state = {"payload": None, "src": None, "tag": None, "matched": False, "request": None}
        req = self.engine.grequest_start(
            extra_state=state, stream=handle.stream, name=f"tc-irecv-r{handle.rank}"
        )
        state["request"] = req
        complete_now = False
        with self.engine.channel_section(handle.channel):
            m = mb.match_pop(src, tag)
            if m is not None:
                state["payload"] = m[2]
                state["src"] = m[0]
                state["tag"] = m[1]
                state["matched"] = True
                complete_now = True
            else:
                mb.pending.append((src, tag, state))
        if complete_now:
            req.complete()
        return RecvFuture(req, self.engine, lambda: self._cancel_post(handle, state))

    def _cancel_post(self, handle: ThreadRank, state: dict) -> bool:
        """Withdraw a posted receive (recv-timeout path). Returns True if
        the post was still unmatched and is now removed; False if a send
        fulfilled it concurrently (the caller owns the payload)."""
        mb = self._mailboxes[handle.rank]
        with self.engine.channel_section(handle.channel):
            for i, (_s, _t, st) in enumerate(mb.pending):
                if st is state:
                    del mb.pending[i]
                    return True
        return False

    def _recv(self, handle: ThreadRank, src: int, tag, timeout: Optional[float]):
        """Blocking receive on the handle's own mailbox.

        Directed (``src`` given): the match-and-pop runs inside the park
        predicate — i.e. under the rank's stripe lock — so a wake and a
        steal cannot race; a blocked recv parks (spin-then-park) on the
        rank's own per-channel wait queue instead of polling, and the
        sender's notify wakes only the matching waiter.

        ``ANY_SOURCE``: the recv posts itself (irecv) and blocks in
        ``engine.wait_any`` — the sender fulfills the post directly and
        completes the request, waking the waiter with zero polling. A
        timeout withdraws the post, so a later send can never vanish
        into a dead receive."""
        self._check_handle(handle)
        if self.fault_hook is not None:
            self.fault_hook("tc.recv", rank=handle.rank)
        if src != ANY_SOURCE and not (0 <= src < self.nthreads):
            raise ValueError(f"recv src {src} out of range [0, {self.nthreads})")
        if src == ANY_SOURCE:
            fut = self._irecv(handle, src, tag)
            got = self.engine.wait_any([fut.grequest], timeout)
            state = fut.grequest.extra_state
            if got is None and fut.cancel():
                # withdrawn AND its request cancelled: nothing leaks into
                # the engine queue, and a later send lands in the mailbox
                raise TimeoutError(
                    f"HostThreadComm({self.name}): rank {handle.rank} recv(src=ANY_SOURCE, "
                    f"tag={tag!r}) timed out after {timeout}s"
                )
            if not state["matched"]:
                # completed without a payload: the post was cancelled out
                # from under us (epoch finish) — never fabricate a message
                raise RuntimeError(
                    f"HostThreadComm({self.name}): rank {handle.rank} recv(src=ANY_SOURCE) "
                    "cancelled before a message arrived"
                )
            # matched (possibly racing the timeout: the cancel lost — the
            # message is ours and must not be dropped)
            handle.recvs += 1
            if self.heartbeat is not None:
                self.heartbeat.record(handle.rank)
            return state["payload"]
        mb = self._mailboxes[handle.rank]
        found: List = []

        def pred() -> bool:
            m = mb.match_pop(src, tag)
            if m is not None:
                found.append(m)
                return True
            return False

        ok = self.engine.park_on_channel(handle.channel, pred, timeout)
        if not ok:
            raise TimeoutError(
                f"HostThreadComm({self.name}): rank {handle.rank} recv(src={src}, "
                f"tag={tag!r}) timed out after {timeout}s"
            )
        if self.mailbox_capacity is not None:
            # bounded mailboxes: the pop freed a slot — wake any sender
            # parked on this channel waiting for space (the irecv path
            # notifies via the request's done callback already)
            self.engine.notify_channel(handle.channel)
        handle.recvs += 1
        if self.heartbeat is not None:
            self.heartbeat.record(handle.rank)
        return found[0][2]

    # -- recorded schedules (pt2pt over pre-resolved bindings) ------------
    def _record_send(self, schedule, handle: ThreadRank, dst: int, obj, tag, bind,
                     payload_fn: Optional[Callable] = None) -> None:
        """Record a mailbox send (paper ext. 5 meets user-level
        schedules): handle/range validation and the destination channel +
        mailbox resolution happen once, HERE, and the record pass
        delivers eagerly on the epoch-0 scheduled tag — recording IS an
        execution. The recorded op is the pre-resolved single-critical-
        section handoff guarded by two integer staleness checks (comm
        epoch, handle liveness) in place of the eager path's full
        validation. Scheduled tags live in the ``("__sched__", tag,
        replay_epoch)`` namespace (see the ``core.schedule`` module doc),
        so back-to-back replays never cross-match."""
        from repro_torch.core.schedule import ScheduleError

        if not schedule.recording:
            raise ScheduleError("send_scheduled: schedule is not recording")
        self._check_handle(handle)
        if not (0 <= dst < self.nthreads):
            raise ValueError(f"send dst {dst} out of range [0, {self.nthreads})")
        mb = self._mailboxes[dst]
        dst_ch = self._streams[dst].channel
        comm_epoch = self._epoch
        src_rank = handle.rank

        def deliver(payload, stamped_tag):
            matched = None
            with self.engine.channel_section(dst_ch):
                entry = mb.match_pending(src_rank, stamped_tag)
                if entry is not None:
                    _ws, _wt, state = entry
                    state["payload"] = payload
                    state["src"] = src_rank
                    state["tag"] = stamped_tag
                    state["matched"] = True
                    matched = state
                else:
                    mb.messages.append((src_rank, stamped_tag, payload))
            handle.sends += 1
            if self.heartbeat is not None:
                self.heartbeat.record(src_rank)
            if matched is not None:
                # outside the critical section, exactly as _send
                matched["request"].complete()
                # a blocking (``into=``) scheduled recv parks on its own
                # channel for this payload — wake it now rather than ride
                # out the park-recheck interval
                self.engine.notify_channel(dst_ch)
            else:
                self.engine.notify_channel(dst_ch)

        def issue(ctx):
            if self._epoch != comm_epoch or not self._active:
                ctx.schedule._stale(
                    f"threadcomm {self.name!r} epoch changed under the schedule"
                )
            if handle._detached:
                ctx.schedule._stale(f"rank {src_rank} detached since record()")
            if payload_fn is not None:
                payload = payload_fn(ctx)
            else:
                payload = ctx.bound(bind) if bind is not None else obj
            deliver(payload, ("__sched__", tag, ctx.epoch))

        schedule.add_op("tc-send", issue, label=f"send r{src_rank}->r{dst}")
        deliver(obj, ("__sched__", tag, 0))

    def _record_recv(self, schedule, handle: ThreadRank, src: int, tag, out, timeout,
                     into: Optional[str] = None):
        """Record the matching receive. Each replay posts a fused *part*
        as the pending entry — the sender's (eager or replayed) delivery
        fulfills and completes it through the existing ``match_pending``
        machinery — so a replayed recv skips both ``grequest_start``
        registration and the per-recv wait: the schedule's single fused
        wait covers every recv in the graph. With ``into=`` the replayed
        issue additionally *parks* until the payload lands and stores it
        in ``ctx.scratch[into]`` — the blocking form the ring collectives
        need, where the next recorded op folds this payload before the
        next hop. ``ANY_SOURCE`` is not schedulable (channel bindings
        must resolve at record time). The record pass blocks for and
        returns the epoch-0 payload."""
        from repro_torch.core.schedule import ScheduleError

        if not schedule.recording:
            raise ScheduleError("recv_scheduled: schedule is not recording")
        if src == ANY_SOURCE:
            raise ScheduleError(
                "recv_scheduled: ANY_SOURCE cannot be recorded — a schedule "
                "resolves its source/channel bindings at record time"
            )
        self._check_handle(handle)
        if not (0 <= src < self.nthreads):
            raise ValueError(f"recv src {src} out of range [0, {self.nthreads})")
        mb = self._mailboxes[handle.rank]
        ch = handle.channel
        comm_epoch = self._epoch
        rank = handle.rank

        def issue(ctx):
            if self._epoch != comm_epoch or not self._active:
                ctx.schedule._stale(
                    f"threadcomm {self.name!r} epoch changed under the schedule"
                )
            if handle._detached:
                ctx.schedule._stale(f"rank {rank} detached since record()")
            part = ctx.fused.part(name=f"sched-recv-r{rank}")
            state = {
                "payload": None,
                "src": None,
                "tag": None,
                "matched": False,
                "request": part,
            }
            stamped = ("__sched__", tag, ctx.epoch)
            complete_now = False
            with self.engine.channel_section(ch):
                m = mb.match_pop(src, stamped)
                if m is not None:
                    state["payload"] = m[2]
                    state["src"] = m[0]
                    state["tag"] = m[1]
                    state["matched"] = True
                    complete_now = True
                else:
                    mb.pending.append((src, stamped, state))
            if complete_now:
                part.complete()
            handle.recvs += 1
            if into is not None:
                # blocking issue: a later op in this schedule consumes the
                # payload, so park here (spin-then-park on our own channel;
                # the sender's delivery notifies it) instead of deferring
                # to the fused wait
                ok = self.engine.park_on_channel(
                    ch, lambda: state["matched"], timeout
                )
                if not ok:
                    ctx.schedule._stale(
                        f"scheduled recv r{rank}<-r{src}: peer replay did not "
                        f"deliver within {timeout}s"
                    )
                ctx.scratch[into] = state["payload"]
            if out is not None:

                def extract(st=state):
                    if not st["matched"]:
                        raise RuntimeError(
                            "scheduled recv completed without a payload "
                            "(post cancelled by an epoch finish?)"
                        )
                    ctx.outputs[out] = st["payload"]

                ctx.finalizers.append(extract)

        schedule.add_op("tc-recv", issue, parts=1, label=f"recv r{rank}<-r{src}")
        return self._recv(handle, src, ("__sched__", tag, 0), timeout)

    def _probe(self, handle: ThreadRank, src: int, tag, timeout: Optional[float]):
        """Blocking probe: park until a matching message is queued; return
        its (src, tag) envelope WITHOUT dequeuing."""
        self._check_handle(handle)
        if src != ANY_SOURCE and not (0 <= src < self.nthreads):
            raise ValueError(f"probe src {src} out of range [0, {self.nthreads})")
        mb = self._mailboxes[handle.rank]
        seen: List = []

        def pred() -> bool:
            m = mb.match_peek(src, tag)
            if m is not None:
                seen.append(m)
                return True
            return False

        if not self.engine.park_on_channel(handle.channel, pred, timeout):
            raise TimeoutError(
                f"HostThreadComm({self.name}): rank {handle.rank} probe(src={src}, "
                f"tag={tag!r}) timed out after {timeout}s"
            )
        if self.heartbeat is not None:
            self.heartbeat.record(handle.rank)
        return (seen[-1][0], seen[-1][1])

    def _iprobe(self, handle: ThreadRank, src: int, tag):
        """Non-blocking probe under the channel's critical section."""
        self._check_handle(handle)
        if src != ANY_SOURCE and not (0 <= src < self.nthreads):
            raise ValueError(f"iprobe src {src} out of range [0, {self.nthreads})")
        mb = self._mailboxes[handle.rank]
        with self.engine.channel_section(handle.channel):
            m = mb.match_peek(src, tag)
        if self.heartbeat is not None:
            self.heartbeat.record(handle.rank)
        return None if m is None else (m[0], m[1])

    # -- instrumentation --------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "nthreads": self.nthreads,
                "attached": len(self._attached),
                "active": self._active,
                "epoch": self._epoch,
                "shared_channel": self.shared_channel,
                "channels": [s.channel for s in self._streams],
                "pending_messages": [len(mb.messages) for mb in self._mailboxes],
                "posted_recvs": [len(mb.pending) for mb in self._mailboxes],
                "delivered": [mb.delivered for mb in self._mailboxes],
                "mailbox_capacity": self.mailbox_capacity,
                "backpressure_parks": self._bp_parks,
            }


def host_threadcomm_init(
    nthreads: int,
    engine: Optional[ProgressEngine] = None,
    pool: Optional[StreamPool] = None,
    shared_channel: bool = False,
    heartbeat=None,
    mailbox_capacity: Optional[int] = None,
    fault_hook=None,
    name: str = "host-tc",
) -> HostThreadComm:
    """``MPIX_Threadcomm_init(comm, num_threads)`` for the in-process
    level: declare (not yet activate) an n-thread communicator."""
    return HostThreadComm(
        nthreads,
        engine=engine,
        pool=pool,
        shared_channel=shared_channel,
        heartbeat=heartbeat,
        mailbox_capacity=mailbox_capacity,
        fault_hook=fault_hook,
        name=name,
    )


def tc_send(handle: ThreadRank, dst: int, obj, tag=0) -> None:
    """Functional spelling of :meth:`ThreadRank.send` (paper C-API style)."""
    handle.send(dst, obj, tag)


def tc_recv(handle: ThreadRank, src: int = ANY_SOURCE, tag=0, timeout: Optional[float] = None):
    """Functional spelling of :meth:`ThreadRank.recv`."""
    return handle.recv(src=src, tag=tag, timeout=timeout)


# ----------------------------------------------------------------------
# Mesh-axis level: mesh positions as thread-ranks
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class ThreadComm:
    """A communicator spanning a flattened tuple of mesh axes.

    ``axes`` is ordered major→minor: rank = axis0_idx · (Π inner sizes) +
    … + axisK_idx, matching the paper's output where ranks 0..M-1 live in
    process 0, M..2M-1 in process 1, etc.
    """

    mesh: object
    axes: Tuple[str, ...]
    stream: MPIXStream = STREAM_NULL

    # -- geometry --------------------------------------------------------
    def size(self) -> int:
        return int(np.prod([self.mesh.shape[a] for a in self.axes]))

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.mesh.shape[a] for a in self.axes)

    def rank(self) -> int:
        """The calling thread-rank's flattened rank; valid inside an active
        region only."""
        r = axis_index(self.axes[0])
        for a in self.axes[1:]:
            r = r * axis_size(a) + axis_index(a)
        return r

    @property
    def is_threadcomm(self) -> bool:
        return len(self.axes) > 1

    # -- activation: the parallel region ----------------------------------
    def run(self, fn: Callable, *args, in_specs, out_specs):
        """``MPIX_Threadcomm_start``/``finish`` bracket: execute ``fn`` as
        per-rank SPMD code over the flattened communicator, one thread-rank
        per mesh position. ``fn`` may call any
        :mod:`repro_torch.core.collectives` op on comms derived from self."""
        return shard_map(fn, mesh=self.mesh, in_specs=in_specs, out_specs=out_specs)(*args)

    # -- algebra ---------------------------------------------------------
    def as_stream_comm(self, stream: MPIXStream = STREAM_NULL) -> StreamComm:
        return StreamComm(self.axes, (stream,), self.mesh)

    def sub(self, axes: Sequence[str]) -> "ThreadComm":
        """Sub-communicator over a subset of the axes (must stay ordered)."""
        axes = tuple(axes)
        if any(a not in self.axes for a in axes):
            raise ValueError(f"axes {axes} not in comm axes {self.axes}")
        return ThreadComm(self.mesh, axes, self.stream)

    def outer(self) -> "ThreadComm":
        """The 'process-level' communicator (major axis)."""
        return self.sub(self.axes[:1])

    def inner(self) -> "ThreadComm":
        """The 'thread-level' communicator (all minor axes)."""
        return self.sub(self.axes[1:])

    def with_host_threads(self, host: Union[int, HostThreadComm]) -> "HybridThreadComm":
        """Compose with a real host-thread level: returns the hybrid
        (pod × device × host-thread) communicator with one flat rank
        space. Pass an existing :class:`HostThreadComm` or a thread
        count (a fresh, not-yet-started comm is created)."""
        if isinstance(host, int):
            host = HostThreadComm(host, name=f"tc-{'x'.join(self.axes)}-host")
        return HybridThreadComm(self, host)


def threadcomm_init(mesh, axes: Sequence[str], stream: MPIXStream = STREAM_NULL) -> ThreadComm:
    """``MPIX_Threadcomm_init``: declare the flattened communicator.

    ``axes=("pod","data")`` → N_pod × N_data ranks; inactive until
    :meth:`ThreadComm.run` enters a parallel region (shard_map)."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(axes)
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} not in mesh {dict(mesh.shape)}")
    return ThreadComm(mesh, axes, stream)


def threadcomm_free(comm: ThreadComm) -> None:
    """``MPIX_Threadcomm_free`` — no device state to release; host handle
    only (kept for API parity + symmetry checks in tests)."""
    return None


def comm_test_threadcomm(comm) -> bool:
    """``MPIX_Comm_test_threadcomm``: does this communicator span more than
    one hierarchy level (mesh-axis flattening, real host threads, or the
    hybrid of both)?"""
    if isinstance(comm, (HostThreadComm, HybridThreadComm)):
        return comm.is_threadcomm
    return isinstance(comm, ThreadComm) and comm.is_threadcomm


def flatten_comm(mesh, *axes: str) -> ThreadComm:
    return threadcomm_init(mesh, axes)


def split_comm(comm: ThreadComm, keep: Sequence[str]) -> ThreadComm:
    return comm.sub(keep)


# ----------------------------------------------------------------------
# Hybrid: mesh axes × host threads, one flat rank space
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class HybridThreadComm:
    """(pod × device) mesh levels composed with the host-thread level:
    one communicator of ``mesh_comm.size() × host.nthreads`` ranks,
    numbered mesh-major (all thread-ranks of mesh position 0 first) —
    the paper's N·M layout with M = host threads."""

    mesh_comm: ThreadComm
    host: HostThreadComm

    def size(self) -> int:
        return self.mesh_comm.size() * self.host.nthreads

    def axis_sizes(self) -> Tuple[int, ...]:
        return self.mesh_comm.axis_sizes() + (self.host.nthreads,)

    @property
    def is_threadcomm(self) -> bool:
        return True

    def static_rank(self, coords: Sequence[int], thread_rank: int) -> int:
        """Flat rank from mesh-axis coordinates (major→minor, matching
        ``mesh_comm.axes``) and a host-thread rank — pure arithmetic, for
        layout planning and tests."""
        sizes = self.mesh_comm.axis_sizes()
        if len(coords) != len(sizes):
            raise ValueError(f"need {len(sizes)} coords for axes {self.mesh_comm.axes}")
        flat = 0
        for c, s in zip(coords, sizes):
            if not (0 <= c < s):
                raise ValueError(f"coordinate {c} out of range [0, {s})")
            flat = flat * s + c
        if not (0 <= thread_rank < self.host.nthreads):
            raise ValueError(f"thread rank {thread_rank} out of range")
        return flat * self.host.nthreads + thread_rank

    def rank(self, handle: ThreadRank) -> int:
        """Flat rank: valid inside an active mesh region, called by an
        attached thread — mesh flat rank · nthreads + thread rank."""
        return self.mesh_comm.rank() * self.host.nthreads + handle.rank

    def inner(self) -> HostThreadComm:
        """The thread-level communicator (the paper's per-process M)."""
        return self.host

    def outer(self) -> ThreadComm:
        """The mesh-level communicator."""
        return self.mesh_comm

    # -- hybrid collectives (host threadcoll × device mesh level) --------
    def allreduce_large(self, handle: ThreadRank, value, op: str = "sum",
                        timeout: Optional[float] = None) -> np.ndarray:
        """Bandwidth-optimal allreduce over every (mesh position, host
        thread) rank — the paper's motivating example with ext. 3 + 5
        composed. ``value`` is this thread's stacked per-mesh-position
        contribution, shape ``(mesh_size, *rest)`` (row m = what hybrid
        rank (m, thread) holds); returns the full sum shaped ``rest``,
        identical on every rank.

        Rabenseifner applied at both hierarchy levels: a host-level ring
        reduce-scatter over the *column* dimension (threadcoll ``axis=``
        chunking keeps mesh rows whole — each thread ends owning a 1/M
        column chunk summed over threads), then the mesh-level allreduce
        of just that chunk on the mesh's device, issued through this
        thread's stream (the :mod:`repro_torch.core.hierarchical` RS→AR→AG
        split when the mesh has more than one axis), then a host-level
        allgather. The mesh level moves only ``bytes/M`` per thread and
        each of its collectives is serialized on the issuing thread's own
        stream."""
        if op != "sum":
            raise ValueError(
                "hybrid allreduce_large reduces the mesh level with psum; "
                f"op={op!r} is host-level-only (use host collectives directly)"
            )
        arr = np.asarray(value)
        msize = self.mesh_comm.size()
        if arr.ndim < 1 or arr.shape[0] != msize:
            raise ValueError(
                f"hybrid allreduce_large input must stack the mesh dim first: "
                f"expected shape ({msize}, ...), got {arr.shape}"
            )
        rest = arr.shape[1:]
        flat2d = arr.reshape(msize, -1)
        chunk = threadcoll.reduce_scatter(
            handle, flat2d, op=op, timeout=timeout, axis=1
        )  # (msize, cols/M) — still per-mesh-position
        if msize > 1 and chunk.shape[1]:
            chunk = self._mesh_allreduce(handle, chunk)
        else:
            chunk = chunk.sum(axis=0)
        flat = threadcoll.allgather(handle, chunk.reshape(-1), timeout=timeout)
        return flat.reshape(rest)

    def _mesh_allreduce(self, handle: ThreadRank, chunk: np.ndarray) -> np.ndarray:
        """Sum a ``(mesh_size, c)`` host array over the mesh axes on the
        mesh's device: a shard_map region whose ranks run the hierarchical
        all-reduce (RS inner / AR outer / AG inner when the mesh has more
        than one axis) through a mesh comm bound to the calling thread's
        stream, so the device collectives serialize on that thread's
        channel. Returns the ``(c,)`` total."""
        # deferred: hierarchical imports this module at load time
        from repro_torch.core.hierarchical import hierarchical_all_reduce

        mc = ThreadComm(self.mesh_comm.mesh, self.mesh_comm.axes, handle.stream)

        def body(x):
            y, _ = hierarchical_all_reduce(x, mc, axis=1)
            return y

        spec = P(mc.axes if len(mc.axes) > 1 else mc.axes[0])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(mc.mesh.devices[0])
        y = shard_map(body, mesh=mc.mesh, in_specs=spec, out_specs=P())(x)
        return y[0].cpu().numpy()
