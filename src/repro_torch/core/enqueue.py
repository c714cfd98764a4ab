"""Enqueue semantics: device-ordered communication (paper ext. 4), on CUDA.

``MPIX_Send_enqueue`` places an MPI operation *into a device stream*: the
host never blocks, ordering comes from the stream. On the card this is the
paper's own setting: an offload stream (``info={'type': 'cudaStream_t'}``)
owns a :class:`torch.cuda.Stream`, work is issued on it, and completion is
a :class:`torch.cuda.Event` recorded after the work:

* :func:`pack_send` materializes a datatype-described send buffer *on
  stream*: when the exact ``pack_info`` proof says the layout is uniform
  and the kernel can express it, the pack is the ``dt_pack`` CUDA kernel
  (:func:`repro_torch.kernels.ops.pack_datatype`), issued on the stream;
  irregular layouts take the vectorized host engine;
* :func:`dispatch_enqueue` registers already-issued device work as a
  generalized request whose ``poll_fn`` is ``event.query()`` — the
  ``cudaEventQuery`` of the paper's grequest example — and whose batched
  ``wait_fn`` waits on the events, bounded by the caller's deadline;
* :class:`OffloadWindow` is the depth-N in-flight window transport: it
  admits up to ``depth`` outstanding transfers and *backpressures* the
  issue path when full by parking on the progress engine's per-channel
  wait queues (never busy-spinning — completion wakes the parked issuer).
  Completion is tracked in **completion order**, not issue order.

The sends over a mesh (:func:`send_enqueue`, :func:`isend_enqueue`,
:func:`shift_enqueue`, ...) come in two forms, as in the reference:

* per-rank code inside a :func:`~repro_torch.core.mesh.shard_map` region
  (a ``ppermute`` on the comm's offload stream, ordered by tokens);
* **windowed** sends (``window=``), which are host-side: the caller passes
  the stacked global buffer (leading dim = ring size), the payload is
  packed on the comm's stream — one ``dt_pack`` launch over all rows when
  ``pack_info`` proves the n-row layout uniform — each row moves to its
  destination row by a device copy on that stream, and completion is the
  :func:`dispatch_enqueue` event, admitted into an :class:`OffloadWindow`.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import collectives
from repro_torch.core import datatype as dtt
from repro_torch.core.mesh import current_region
from repro_torch.core.progress import GeneralizedRequest, ProgressEngine, default_engine
from repro_torch.core.streams import MPIXStream, STREAM_NULL, StreamComm, new_token

__all__ = [
    "send_enqueue",
    "recv_enqueue",
    "sendrecv_enqueue",
    "isend_enqueue",
    "isend_enqueue_scheduled",
    "wait_enqueue",
    "EnqueuedRequest",
    "shift_enqueue",
    "dispatch_enqueue",
    "dispatch_state",
    "pack_send",
    "OffloadWindow",
    "WindowSlot",
]

#: a dependency token: a CUDA event, a tuple of them, or None on the CPU
Token = object

# Park slice while the window itself must drive progress (no covering
# progress thread): matches _wait_dispatched's readiness-poll granularity.
_SELF_PROGRESS_PARK_S = 0.0005


def _require_offload(comm: StreamComm) -> None:
    if not comm.stream.is_offload and not comm.stream.is_null:
        raise ValueError(
            "enqueue ops need an offload stream (create with "
            "info={'type': 'cudaStream_t'}) or STREAM_NULL for implicit mode"
        )


# ----------------------------------------------------------------------
# Datatype-described send buffers
# ----------------------------------------------------------------------


def pack_send(x, datatype: dtt.Datatype, count: int = 1, *, stream: MPIXStream = STREAM_NULL):
    """Materialize the packed payload of a ``(buffer, Datatype)`` send.

    ``x`` is the flat(tenable) tensor the datatype addresses. When
    ``pack_info`` *proves* the layout uniform and the dense kernel can
    express it (non-negative displacement, non-overlapping stride,
    element-aligned bytes), the pack runs **on stream** through
    :func:`repro_torch.kernels.ops.pack_datatype`: for a CUDA tensor that
    is the ``dt_pack`` kernel, issued on ``stream``'s CUDA stream after the
    work already queued on the current stream (so the buffer's producers
    are ordered before the read). Otherwise — an irregular layout, or one
    the kernel's validation refuses — the vectorized host engine
    (:func:`repro_torch.core.datatype.pack`) gathers the bytes; the two
    paths are byte-identical for any layout both accept. A kernel build or
    launch failure raises: it never turns into the host path.
    """
    from repro_torch.kernels import ops

    if count != 1 and datatype.extent < 0:
        raise ValueError("pack_send: count>1 with negative extent is ambiguous")
    flat = x.reshape(-1)
    info = dtt.pack_info(datatype)
    if info is not None and count == 1:
        try:
            ops._kernel_info(datatype, info, flat.element_size())
        except ValueError:
            pass  # kernel-inexpressible uniform layout: the host engine packs it
        else:
            side = stream.torch_stream(flat.device)
            if side is None:
                return ops.pack_datatype(flat, datatype, info=info)
            side.wait_stream(torch.cuda.current_stream(flat.device))
            with torch.cuda.stream(side):
                out = ops.pack_datatype(flat, datatype, info=info)
            flat.record_stream(side)  # the caller may free x before the pack runs
            return out
    host = flat.cpu()
    packed = dtt.pack(host, datatype, count)  # uint8, count*size bytes
    out = torch.from_numpy(packed)
    if packed.size % host.element_size() == 0:
        out = out.view(host.dtype)
    return out.to(flat.device)


@contextmanager
def _issuing_on(stream: MPIXStream, x):
    """Run the body with ``stream``'s CUDA stream current, ordered after
    the caller's current stream, with ``x`` marked used on it (the caller
    may free ``x`` before the stream reads it). No-op on the CPU and for a
    stream that has no CUDA stream."""
    side = stream.torch_stream(x.device)
    if side is None:
        yield
        return
    side.wait_stream(torch.cuda.current_stream(x.device))
    x.record_stream(side)
    with torch.cuda.stream(side):
        yield


# ----------------------------------------------------------------------
# Stream-enqueued transfers (per-rank ppermute with token ordering)
# ----------------------------------------------------------------------


def sendrecv_enqueue(
    x,
    comm: StreamComm,
    perm: Sequence[Tuple[int, int]],
    token: Optional[Token] = None,
):
    """SPMD matched send+recv enqueued on the comm's offload stream, per
    rank inside a shard_map region.

    Every rank contributes its outgoing shard and receives per ``perm``.
    Returns ``(received, token')`` — the token (a CUDA event, None on the
    CPU) orders subsequent enqueued ops (CUDA-stream semantics)."""
    _require_offload(comm)
    token = token if token is not None else new_token(x.device, comm.stream)
    return collectives.ppermute(x, comm, perm, token)


def send_enqueue(
    x,
    comm: StreamComm,
    dest_offset: int,
    token: Optional[Token] = None,
    *,
    datatype: Optional[dtt.Datatype] = None,
    count: int = 1,
    window: Optional["OffloadWindow"] = None,
):
    """``MPIX_Send_enqueue`` to ``rank + dest_offset`` on a ring (SPMD: the
    matching recv is implied on the destination).

    ``datatype=`` describes a non-contiguous send buffer: ``x`` is the
    flat element buffer and the payload is packed on stream (the
    ``dt_pack`` kernel for proven-uniform layouts, host engine otherwise —
    see :func:`pack_send`) instead of the caller materializing a staging
    copy.

    ``window=`` routes the send through an :class:`OffloadWindow`: the
    call *backpressures* (parks on the engine's stripe CV) while the
    window holds ``depth`` incomplete transfers, then dispatches and
    registers the new one. Windowed sends are **host-side** (the window
    is host state): ``x`` must be the *global* buffer with leading dim =
    ring size (per-rank payloads stacked), the call is made outside any
    shard_map region, and tokens do not apply — passing one raises, and
    the returned token is None (ordering comes from the comm's stream +
    the window). Without a window the call is the per-rank
    fire-and-forget form used inside shard_map."""
    if window is None:
        if datatype is not None:
            x = pack_send(x, datatype, count, stream=comm.stream)
        return sendrecv_enqueue(x, comm, _ring_perm(comm, dest_offset), token)
    if token is not None:
        raise ValueError(
            "windowed sends issue host-side; an input token cannot be "
            "threaded through — order host-issued sends via the comm's "
            "stream (feed y into the next send) or drop the window"
        )
    y, _ = _windowed_isend(x, comm, dest_offset, datatype, count, window)
    return y, None


def _windowed_isend(x, comm, dest_offset, datatype, count, window):
    """Host-side windowed ring send shared by send_enqueue/isend_enqueue:
    pack and move the stacked rows on the comm's stream, then admit the
    completion into the window."""
    if current_region() is not None:
        raise ValueError(
            "windowed enqueue sends are host-side (window backpressure "
            "cannot run per rank); call outside shard_map with the global "
            "buffer, or drop the window inside a region"
        )
    _require_offload(comm)
    if window.stream.sid != comm.stream.sid:
        raise ValueError(
            f"window is bound to stream {window.stream.name!r} but the comm "
            f"sends on {comm.stream.name!r}: the window parks on and "
            "progresses its own stream's channel, so a mismatch would "
            "deadlock backpressure — build the window on the comm's stream"
        )
    n = comm.mesh.shape[comm.axes[0]]
    x = torch.as_tensor(x)
    if x.dim() == 0 or x.shape[0] != n:
        raise ValueError(
            f"windowed send: leading dim {tuple(x.shape)[:1]} != ring size {n} "
            "(stack each rank's payload)"
        )
    with _issuing_on(comm.stream, x):
        if datatype is not None:
            x = _pack_stacked(x, datatype, count, n)
        with window.issue() as submit:
            y = _mapped_ring_send(comm.mesh, comm.axes, dest_offset)(x)
            req = dispatch_enqueue(y, stream=comm.stream, engine=window.engine, name="isend_enqueue")
            submit(req, value=y)
    return y, req


def _rowed_type(x, datatype: dtt.Datatype, count: int, n: int):
    """The n stacked rows as ONE datatype — the type resized to the row
    stride, n copies — with its ``pack_info``, when the layout fits inside
    a row and ``pack_info`` proves the n-row layout uniform in a form the
    ``dt_pack`` kernel takes; else None. At the served KV span (24
    segments of 512 KiB, 4 MiB apart, in 96 MiB rows) the segments
    continue at the same stride from row to row, so all n rows are one
    uniform layout."""
    from repro_torch.kernels import ops

    row_bytes = 0 if x.dim() < 2 else x.element_size() * x[0].numel()
    if not (n > 1 and count == 1 and datatype.lb >= 0 and datatype.ub <= row_bytes):
        return None
    rowed = dtt.contiguous(n, dtt.resized(datatype, datatype.lb, row_bytes))
    info = dtt.pack_info(rowed)
    if info is None:
        return None
    try:
        ops._kernel_info(rowed, info, x.element_size())
    except ValueError:
        return None
    return rowed, info


def _pack_stacked(x, datatype: dtt.Datatype, count: int, n: int):
    """Pack each of the ``n`` stacked per-rank payloads on the current
    stream. Where the rows form one uniform layout (:func:`_rowed_type`)
    ONE ``dt_pack`` launch packs them all; otherwise each row is packed by
    :func:`pack_send` (one kernel launch per row for a uniform row layout,
    the host engine for an irregular one). The bytes equal the reference's
    host-engine pack of every row — a CUDA buffer never takes the host
    round trip for a uniform layout."""
    return _make_stacked_packer(x, datatype, count, n)(x)


def _mapped_ring_send(mesh, axes: Tuple[str, ...], dest_offset: int):
    """The ring send of host-issued (windowed) enqueues over ``axes[0]``:
    ``send(xs)`` moves row i of the stacked buffer to row
    ``(i + dest_offset) % n``, one device copy per row, on the current
    stream."""
    n = mesh.shape[axes[0]]
    perm = [(i, (i + dest_offset) % n) for i in range(n)]

    def send(xs):
        y = torch.empty_like(xs)
        for src, dst in perm:
            y[dst].copy_(xs[src])
        return y

    return send


def _ring_perm(comm: StreamComm, dest_offset: int) -> List[Tuple[int, int]]:
    n = comm.mesh.shape[comm.axes[0]]
    return [(i, (i + dest_offset) % n) for i in range(n)]


def recv_enqueue(x_buffer, comm: StreamComm, src_offset: int, token: Optional[Token] = None):
    """``MPIX_Recv_enqueue`` from ``rank - src_offset``; ``x_buffer`` is the
    value this rank forwards (SPMD symmetry)."""
    return send_enqueue(x_buffer, comm, src_offset, token)


def shift_enqueue(x, comm: StreamComm, shift: int = 1, token: Optional[Token] = None):
    """Pipeline-stage shift: stage s → stage s+shift (non-wrapping edges
    receive zeros). The workhorse of pipeline parallelism."""
    _require_offload(comm)
    n = comm.mesh.shape[comm.axes[0]]
    if shift >= 0:
        perm = [(i, i + shift) for i in range(n - shift)]
    else:
        perm = [(i, i + shift) for i in range(-shift, n)]
    token = token if token is not None else new_token(x.device, comm.stream)
    return collectives.ppermute(x, comm, perm, token)


# ----------------------------------------------------------------------
# Host-visible nonblocking wrappers (MPIX_Isend_enqueue / MPIX_Wait_enqueue)
# ----------------------------------------------------------------------


@dataclass
class EnqueuedRequest:
    """Host handle for an enqueued transfer: completion of the *dispatch*
    (host side), distinct from completion of the offload stream itself —
    the paper's separation of the three contexts.

    ``wait`` goes through the engine's parking path: when a progress
    thread covers the offload stream, the waiting host thread parks on the
    stream's CV instead of spinning on the event."""

    grequest: GeneralizedRequest
    token: Optional[Token] = None
    engine: Optional[ProgressEngine] = None

    @property
    def done(self) -> bool:
        return self.grequest.done

    def wait(self, timeout: Optional[float] = None) -> bool:
        return (self.engine or default_engine()).wait(self.grequest, timeout)


def _cuda_tensors(y) -> List[torch.Tensor]:
    if isinstance(y, torch.Tensor):
        return [y] if y.device.type == "cuda" else []
    if isinstance(y, (list, tuple)):
        return [t for item in y for t in _cuda_tensors(item)]
    if isinstance(y, dict):
        return [t for item in y.values() for t in _cuda_tensors(item)]
    return []


def dispatch_state(y, stream: MPIXStream = STREAM_NULL) -> dict:
    """The completion state of already-issued work ``y``: ``{"y": y,
    "event": ev}``. When ``y`` holds CUDA tensors, ``ev`` is a
    :class:`torch.cuda.Event` recorded on ``stream``'s CUDA stream after
    that stream has been ordered behind the current stream — so it
    completes only after everything issued so far on either stream, which
    covers ``y`` wherever it was issued. Host values (CPU tensors, numpy)
    are complete when they exist: ``ev`` is ``None``."""
    cuda = _cuda_tensors(y)
    if not cuda:
        return {"y": y, "event": None}
    dev = cuda[0].device
    cur = torch.cuda.current_stream(dev)
    side = stream.torch_stream(dev)
    if side is not None and side != cur:
        side.wait_stream(cur)
    ev = torch.cuda.Event()
    ev.record(side if side is not None else cur)
    return {"y": y, "event": ev}


def _event_of(state):
    ev = state.get("event")
    if ev is None and _cuda_tensors(state.get("y")):
        # a verbatim port would call such work complete at once; refuse
        raise RuntimeError(
            "dispatched CUDA work carries no completion event: build the "
            "state with dispatch_state()/dispatch_enqueue()"
        )
    return ev


def _wait_dispatched(states, timeout) -> None:
    """Batched ``wait_fn`` for enqueued transfers: wait on the completion
    event of every dispatched item in the per-stream group, honoring the
    engine's deadline budget. Module-level so the engine batches all
    enqueued requests of a stream into one call.

    Without a deadline each event is waited with ``synchronize()``; under a
    deadline the event is polled with ``query()`` so the caller's
    ``wait_all`` contract holds (``synchronize`` has no timeout). Host
    values have no event and are complete."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for st in states:
        ev = _event_of(st)
        if ev is None:
            continue  # plain host value: nothing to wait on
        if deadline is None:
            ev.synchronize()
            continue
        while not ev.query():
            if time.monotonic() >= deadline:
                return  # budget exhausted; the engine recomputes remaining time
            time.sleep(0.0005)


def _poll_dispatched(state) -> bool:
    """Shared ``poll_fn`` for dispatched device work: the block-free
    ``event.query()`` (``cudaEventQuery``); host values are done. Used by
    eager enqueued requests and by scheduled-replay fused parts alike."""
    ev = _event_of(state)
    return True if ev is None else bool(ev.query())


def dispatch_enqueue(
    y,
    stream: MPIXStream = STREAM_NULL,
    engine: Optional[ProgressEngine] = None,
    token: Optional[Token] = None,
    name: str = "enqueue",
) -> EnqueuedRequest:
    """Register already-dispatched device work ``y`` as an enqueued
    transfer: a generalized request whose ``poll_fn`` queries the
    completion event recorded on ``stream`` (see :func:`dispatch_state`)
    and whose batched ``wait_fn`` waits on the per-stream group. The
    building block under :class:`OffloadWindow`."""
    eng = engine or default_engine()
    state = dispatch_state(y, stream)
    req = eng.grequest_start(
        poll_fn=_poll_dispatched,
        wait_fn=_wait_dispatched,
        extra_state=state,
        stream=stream,
        name=name,
    )
    return EnqueuedRequest(req, token if token is not None else state["event"], eng)


def isend_enqueue(
    x,
    comm: StreamComm,
    dest_offset: int,
    token: Optional[Token] = None,
    engine: Optional[ProgressEngine] = None,
    *,
    datatype: Optional[dtt.Datatype] = None,
    count: int = 1,
    window: Optional["OffloadWindow"] = None,
) -> Tuple[torch.Tensor, EnqueuedRequest]:
    """Non-blocking enqueue: returns (result, request). The request
    completes when the dispatched device work is done (poll_fn queries the
    CUDA event, like cudaEventQuery in the paper's grequest example).
    ``datatype=``/``window=`` behave as in :func:`send_enqueue` — with a
    window, the call is host-side (global stacked buffer, no input token,
    see :func:`send_enqueue`), backpressures while ``depth`` transfers
    are in flight, and the request is tracked in the window."""
    if window is not None:
        if token is not None:
            raise ValueError(
                "windowed sends issue host-side; an input token cannot be "
                "threaded through — order host-issued sends via the comm's "
                "stream or drop the window"
            )
        if engine is not None and engine is not window.engine:
            raise ValueError(
                "isend_enqueue: the window carries its own engine; a "
                "different engine= alongside it would be silently ignored"
            )
        return _windowed_isend(x, comm, dest_offset, datatype, count, window)
    if datatype is not None:
        x = pack_send(x, datatype, count, stream=comm.stream)
    y, tok = sendrecv_enqueue(x, comm, _ring_perm(comm, dest_offset), token)
    req = dispatch_enqueue(y, stream=comm.stream, engine=engine or default_engine(), token=tok, name="isend_enqueue")
    return y, req


def _make_stacked_packer(x, datatype: dtt.Datatype, count: int, n: int):
    """The packer of :func:`_pack_stacked`, resolved for buffers shaped like
    ``x``: the branch (one launch over the rowed layout vs a pack per row),
    the rowed descriptor and its ``pack_info`` proof are resolved once —
    at record time for :func:`isend_enqueue_scheduled`'s replays. The
    returned closure packs on the current stream."""
    from repro_torch.kernels import ops

    rowed = _rowed_type(x, datatype, count, n)
    if rowed is not None:
        rowed, info = rowed
        return lambda xv: ops.pack_datatype(xv.reshape(-1), rowed, info=info).view(n, -1)
    return lambda xv: torch.stack([pack_send(xv[i], datatype, count) for i in range(n)])


def isend_enqueue_scheduled(
    x,
    comm: StreamComm,
    dest_offset: int,
    *,
    schedule,
    window: "OffloadWindow",
    bind: Optional[str] = None,
    out: Optional[str] = None,
    datatype: Optional[dtt.Datatype] = None,
    count: int = 1,
) -> Tuple[torch.Tensor, EnqueuedRequest]:
    """Record a windowed ring send into ``schedule``.

    The record pass IS an eager windowed :func:`isend_enqueue`: full
    validation (host-side check, window/stream match, ring-size check),
    the datatype pack branch, and the ring send resolve exactly once,
    here, and the dispatched result is returned as usual. The recorded op
    re-issues with none of that — one shape/dtype compare (mismatch raises
    ``ScheduleStale``), the pre-resolved packer, the ring send on the
    comm's stream, a window reserve, and a fused *part* completing at the
    send's CUDA event registered with the window in place of an
    engine-queued request.

    ``bind=`` names the replay binding supplying the buffer (omit to
    replay the recorded constant); ``out=`` stores each replay's
    dispatched tensor under ``ctx.outputs[out]``. Returns the record
    pass's ``(y, request)`` — the request is window-owned.
    """
    from repro_torch.core.schedule import ScheduleError

    if not schedule.recording:
        raise ScheduleError("isend_enqueue_scheduled: schedule is not recording")
    x = torch.as_tensor(x)
    y, req = _windowed_isend(x, comm, dest_offset, datatype, count, window)
    ring = _mapped_ring_send(comm.mesh, comm.axes, dest_offset)
    n = comm.mesh.shape[comm.axes[0]]
    pack_fn = None if datatype is None else _make_stacked_packer(x, datatype, count, n)
    shape0, dtype0, stream = tuple(x.shape), x.dtype, comm.stream

    def issue(ctx):
        xv = torch.as_tensor(ctx.bound(bind)) if bind is not None else x
        if tuple(xv.shape) != shape0 or xv.dtype != dtype0:
            ctx.schedule._stale(
                f"isend buffer changed: recorded {shape0}/{dtype0}, "
                f"now {tuple(xv.shape)}/{xv.dtype}"
            )
        with _issuing_on(stream, xv):
            if pack_fn is not None:
                xv = pack_fn(xv)
            window.reserve(timeout=None)
            try:
                yv = ring(xv)
                part = ctx.fused.part(
                    poll_fn=_poll_dispatched, extra_state=dispatch_state(yv, stream), name="sched-isend"
                )
                window.register(part, value=yv)
            except BaseException:
                window.unreserve()
                raise
        if out is not None:
            ctx.outputs[out] = yv

    schedule.add_op("isend_enqueue", issue, parts=1, label=f"isend+{dest_offset}")
    return y, req


def wait_enqueue(req: EnqueuedRequest, engine: Optional[ProgressEngine] = None) -> None:
    """``MPIX_Wait_enqueue``."""
    (engine or req.engine or default_engine()).wait(req.grequest)


# ----------------------------------------------------------------------
# Depth-N in-flight windows
# ----------------------------------------------------------------------


@dataclass
class WindowSlot:
    """One admitted transfer. ``completion_index`` is assigned the moment
    the request completes — the window's global completion order, which is
    NOT issue order: slot 3 may carry completion_index 0."""

    request: GeneralizedRequest
    issue_index: int
    value: object = None
    token: Optional[Token] = None
    completion_index: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.request.done


class OffloadWindow:
    """Bounded in-flight window over one stream's enqueued transfers.

    Admits up to ``depth`` *incomplete* transfers. ``reserve`` (the
    backpressure point, entered through :meth:`issue` or :meth:`admit`)
    blocks while the window is full by parking on the
    progress engine's per-channel wait queue for the stream's channel —
    request completion notifies exactly the waiters it satisfies, so a
    parked issuer wakes immediately and bystanders on the same stripe
    stay asleep; there is no busy-spin. If no progress thread covers the
    channel, the window is its own poller: it blocks in
    ``engine.wait_any`` over its in-flight requests, which actively
    progresses the stream and returns at the first completion.

    Completions are tracked in **completion order**: whichever transfer
    lands first is reapable first, regardless of issue order — a late
    arrival never holds up earlier ones. ``reap`` drains completed slots;
    ``wait_all`` drains the whole window (one batched ``MPI_Waitall``
    through the engine).

    The window is transport-agnostic: any
    :class:`~repro_torch.core.progress.GeneralizedRequest` can be
    admitted, so any host task can reuse the same backpressure.
    """

    def __init__(
        self,
        stream: Union[MPIXStream, StreamComm] = STREAM_NULL,
        depth: int = 2,
        engine: Optional[ProgressEngine] = None,
        adaptive: bool = False,
        min_depth: int = 1,
        max_depth: Optional[int] = None,
        adapt_every: int = 8,
        name: str = "window",
    ):
        if isinstance(stream, StreamComm):
            stream = stream.stream
        if depth < 1:
            raise ValueError(f"OffloadWindow depth must be >= 1, got {depth}")
        self.stream = stream
        self.depth = depth
        self.engine = engine or default_engine()
        self.name = name
        # adaptive depth: every ``adapt_every`` reserves, grow by one while
        # issuers are hitting backpressure parks (completions are flowing
        # but the window is the bottleneck), shrink by one when the window
        # sat idle — the high-water in-flight count since the last
        # adjustment never reached the current depth and nobody parked.
        # Bounds: [min_depth, max_depth]; max_depth defaults to 4× the
        # starting depth. Shrinking never cancels in-flight work — depth
        # only gates NEW admissions.
        self.adaptive = adaptive
        self.min_depth = max(1, min_depth)
        self.max_depth = max_depth if max_depth is not None else depth * 4
        self.adapt_every = max(1, adapt_every)
        self._lock = threading.Lock()
        self._issue_seq = itertools.count()
        self._completion_seq = itertools.count()
        self._in_flight: Dict[int, WindowSlot] = {}
        self._reserved = 0  # slots claimed by reserve() awaiting register()
        self._completed: deque = deque()  # completion order
        self._admitted = 0
        self._reaped = 0
        self._parks = 0
        self._max_depth_seen = 0
        self._reserves = 0
        self._parks_at_adjust = 0
        self._max_inflight_since = 0
        self._grows = 0
        self._shrinks = 0

    # -- admission (the backpressure point) -----------------------------
    def _free_slots(self) -> int:
        with self._lock:
            return self.depth - len(self._in_flight) - self._reserved

    def reserve(self, timeout: Optional[float] = None) -> bool:
        """Claim one window slot, blocking while ``depth`` transfers are
        incomplete. With a progress thread covering the stream the caller
        parks on the channel's wait queue (woken by any completion);
        without one the window is **its own poller** and blocks in
        ``engine.wait_any`` over its in-flight requests — the engine
        actively progresses the stream and returns at the *first*
        completion, instead of slicing short CV parks between sweeps.
        Never busy-spins; returns False only on timeout. Call before
        dispatching, then :meth:`register` the request — or use
        :meth:`admit` when the request already exists."""
        deadline = None if timeout is None else time.monotonic() + timeout
        ch = self.stream.channel
        grew = False
        if self.adaptive:
            with self._lock:
                self._reserves += 1
                if self._reserves % self.adapt_every == 0:
                    grew = self._adjust_depth_locked()
            if grew:
                # wider window → slots exist now; wake parked reservers
                self.engine.notify_channel(ch)
        while True:
            with self._lock:
                if self.depth - len(self._in_flight) - self._reserved > 0:
                    self._reserved += 1
                    return True
                inflight = [s.request for s in self._in_flight.values() if not s.request.done]
            if deadline is not None and time.monotonic() >= deadline:
                return False
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            with self._lock:
                self._parks += 1
            if self.engine.has_poller(ch):
                # a progress thread retires our requests: park until a
                # completion wakes us (bounded slices so a poller that
                # stops mid-park can't strand us — the loop re-checks)
                slice_s = 0.05
                if remaining is not None:
                    slice_s = min(slice_s, remaining)
                self.engine.park_on_channel(ch, lambda: self._free_slots() > 0, slice_s)
            else:
                # nobody else polls this stream: we are our own poller.
                # wait_any progresses the stream and returns on the FIRST
                # completion (bounded so a reserve()-only full window — no
                # registered requests yet — still re-checks the deadline)
                if inflight:
                    slice_s = 0.25
                    if remaining is not None:
                        slice_s = min(slice_s, remaining)
                    self.engine.wait_any(inflight, slice_s)
                if self._free_slots() > 0:
                    continue
                # a completion may be recorded (slot freed) a beat after the
                # request flips done: absorb the race with a short park
                slice_s = _SELF_PROGRESS_PARK_S
                if remaining is not None:
                    slice_s = min(slice_s, remaining)
                self.engine.park_on_channel(ch, lambda: self._free_slots() > 0, slice_s)

    def _adjust_depth_locked(self) -> bool:
        """One adaptive step (caller holds ``_lock``). Returns True on a
        grow (the caller must notify the channel outside the lock)."""
        parks_since = self._parks - self._parks_at_adjust
        grew = False
        if parks_since > 0 and self.depth < self.max_depth:
            self.depth += 1
            self._grows += 1
            grew = True
        elif (
            parks_since == 0
            and self._max_inflight_since < self.depth
            and self.depth > self.min_depth
        ):
            self.depth -= 1
            self._shrinks += 1
        self._parks_at_adjust = self._parks
        self._max_inflight_since = 0
        return grew

    def unreserve(self) -> None:
        """Release a slot claimed by :meth:`reserve` without registering a
        request — the cleanup path when dispatch fails between the two
        (otherwise the slot would leak and eventually deadlock reserve).
        Wakes parked reservers."""
        with self._lock:
            if self._reserved <= 0:
                raise RuntimeError("unreserve() without a matching reserve()")
            self._reserved -= 1
        self.engine.notify_channel(self.stream.channel)

    def register(
        self,
        request: Union[GeneralizedRequest, EnqueuedRequest],
        value: object = None,
        token: Optional[Token] = None,
    ) -> WindowSlot:
        """Attach a dispatched request to a slot claimed by
        :meth:`reserve`. Completion (from any thread) assigns the slot its
        completion index, frees the window slot, and wakes parked
        reservers via the stripe CV."""
        if isinstance(request, EnqueuedRequest):
            if token is None:
                token = request.token
            request = request.grequest
        with self._lock:
            if self._reserved <= 0:
                raise RuntimeError("register() without a matching reserve()")
            self._reserved -= 1
            slot = WindowSlot(
                request=request, issue_index=next(self._issue_seq), value=value, token=token
            )
            self._in_flight[slot.issue_index] = slot
            self._admitted += 1
            depth_now = len(self._in_flight) + self._reserved
            if depth_now > self._max_depth_seen:
                self._max_depth_seen = depth_now
            if depth_now > self._max_inflight_since:
                self._max_inflight_since = depth_now
        request.add_done_callback(lambda _r, _s=slot: self._on_done(_s))
        return slot

    def admit(
        self,
        request: Union[GeneralizedRequest, EnqueuedRequest],
        value: object = None,
        token: Optional[Token] = None,
        timeout: Optional[float] = None,
    ) -> Optional[WindowSlot]:
        """``reserve`` + ``register`` for an already-dispatched request.
        Returns None on reserve timeout."""
        if not self.reserve(timeout):
            return None
        return self.register(request, value=value, token=token)

    @contextmanager
    def issue(self, timeout: Optional[float] = None):
        """The safe issue bracket: reserve a slot, yield a
        ``submit(request, value=None, token=None)`` callable for the
        dispatched work, and give the slot back if the body exits —
        normally or exceptionally — without submitting. Use this instead
        of hand-rolling reserve/register so a failed dispatch can never
        leak the slot (a leaked slot eventually deadlocks ``reserve``).

            with window.issue() as submit:
                y = dispatch_device_work()
                submit(dispatch_enqueue(y, ...), value=y)
        """
        if not self.reserve(timeout):
            raise TimeoutError(f"OffloadWindow({self.name}): reserve timed out")
        submitted: List[WindowSlot] = []

        def submit(request, value=None, token=None) -> WindowSlot:
            slot = self.register(request, value=value, token=token)
            submitted.append(slot)
            return slot

        try:
            yield submit
        finally:
            if not submitted:
                self.unreserve()

    def _on_done(self, slot: WindowSlot) -> None:
        with self._lock:
            if slot.completion_index is not None:
                return
            slot.completion_index = next(self._completion_seq)
            self._in_flight.pop(slot.issue_index, None)
            self._completed.append(slot)
        # free slot → wake reservers parked on the stream's stripe
        self.engine.notify_channel(self.stream.channel)

    # -- the reap side ---------------------------------------------------
    def reap(self) -> List[WindowSlot]:
        """Drain every completed slot, in **completion order** (the order
        transfers actually landed, not the order they were issued)."""
        with self._lock:
            out = list(self._completed)
            self._completed.clear()
            self._reaped += len(out)
        return out

    def in_flight(self) -> int:
        with self._lock:
            return len(self._in_flight)

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Drain the window: one batched ``MPI_Waitall`` over every
        incomplete transfer (engine-side wait_fn batching + parking).
        Returns only after each of those transfers' completions has been
        *recorded* (completion index assigned, slot reapable) — a request
        flips done before its callbacks run, so waiting on doneness alone
        could let a reap race the recording thread."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            slots = list(self._in_flight.values())
        if not self.engine.wait_all([s.request for s in slots], timeout):
            return False
        remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
        return self.engine.park_on_channel(
            self.stream.channel,
            lambda: all(s.completion_index is not None for s in slots),
            remaining,
        )

    def drain(self, timeout: Optional[float] = None) -> List[WindowSlot]:
        """``wait_all`` then ``reap``: every remaining completion, in
        completion order. Raises on timeout (partial completions stay
        reapable)."""
        if not self.wait_all(timeout):
            raise TimeoutError(f"OffloadWindow({self.name}): drain timed out")
        return self.reap()

    # -- instrumentation -------------------------------------------------
    def stats(self, engine: bool = True) -> dict:
        """Window counters, with the engine's beside them (``engine=False``
        omits the engine block): ``admitted``/``reaped`` totals,
        ``backpressure_parks`` (reserve() park events), ``max_depth_seen``
        (high-water in-flight count), current ``in_flight`` and
        ``completed_unreaped``."""
        with self._lock:
            out = {
                "depth": self.depth,
                "admitted": self._admitted,
                "reaped": self._reaped,
                "backpressure_parks": self._parks,
                "max_depth_seen": self._max_depth_seen,
                "in_flight": len(self._in_flight),
                "completed_unreaped": len(self._completed),
                "adaptive": self.adaptive,
                "depth_grows": self._grows,
                "depth_shrinks": self._shrinks,
            }
        if engine:
            out["engine"] = self.engine.stats()
        return out
