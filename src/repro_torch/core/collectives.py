"""Stream-tagged collectives (the communication layer of the framework).

Every distributed operation goes through a :class:`StreamComm` — never a
raw axis name — mirroring the paper's design where stream communicators
are drop-in for conventional communicators. These helpers are *per-rank*
code: call them inside :func:`~repro_torch.core.mesh.shard_map` regions,
where every mesh position is a thread-rank.

Each op is a rendezvous among the ranks of the comm's group (the
positions that share their coordinates on every mesh axis outside the
comm's axes). On the card, a rank orders the op's issuing stream — the
comm stream's CUDA stream for this position, or the current stream for a
NULL stream — after its current stream and after ``token``, records an
event there and posts its tensor with the event. After the rendezvous it
makes its issuing stream wait on the peers' events, computes its own
result there from the posted tensors (folding in group-rank order, so
every rank's result is the same), and makes its current stream wait for
the result. Posted tensors are marked used on each reader's stream
(``record_stream``), so the caching allocator cannot hand their memory to
another op before every reader's copy has run. On the CPU the ops run at
once and tokens are ``None``.

Semantics:

* ops on the SAME stream are ordered on its CUDA stream, and an explicit
  ``token`` (a CUDA event) orders an op after another;
* ops on DIFFERENT streams run on different CUDA streams;
* ``multi_stream_*`` split one tensor across k streams: every chunk is
  issued before any is joined, so the k collectives run concurrently.

Autograd: a rank's result is computed from its peers' posted tensors with
ordinary tensor ops (``torch.cat``, ``clone``, ``+``, ``narrow``), so one
autograd graph spans the thread-ranks and a single ``backward`` (or
``torch.autograd.grad``), called by the caller after the region, routes
every cotangent as the reference's transposes do: ``ppermute``'s reverse
permutation, ``all_gather``'s reduce-scatter, ``all_reduce``'s sum of
cotangents, ``reduce_scatter``'s all-gather. Autograd runs each backward
op on its forward op's CUDA stream and orders the streams itself. A rank
thread must not run a backward through a collective itself: its peers
would accumulate into shared grads in a racy order, so the result's hook
raises when a backward reaches it inside a region.

Every op passes through :func:`_issue`, which tells the callbacks in
:data:`observers` (``launch.roofline.count_collectives``) of it: the op's
XLA name, the issuing rank's mesh position, its operand's bytes and the
comm's mesh axes; the
transpose that autograd runs for it in the caller's backward is told as
well, when the cotangent reaches the result.

**Recomputation.** A layer that ``torch.utils.checkpoint`` recomputes runs
again in the caller's backward, outside the region, where no op may be
issued. Its forward runs under :meth:`CollectiveLog.scope` and keeps
every result it gets; the recompute runs under the same scope and reads
them back in order instead of issuing. Non-reentrant checkpointing keeps
the forward's graph, so the cotangents still cross the ranks through the
forward's ops: the recompute only has to reproduce the saved values.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import mesh as _mesh
from repro_torch.core.streams import StreamComm, _events

__all__ = [
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "reduce",
    "all_to_all",
    "ppermute",
    "broadcast",
    "pshuffle",
    "multi_stream_all_reduce",
    "multi_stream_all_gather",
    "stream_send_recv",
    "CollectiveLog",
]

#: a dependency token: a CUDA event, a tuple of them, or None on the CPU
Token = object

#: callbacks ``fn(op, slot, nbytes, axes)`` told of every collective issued
#: (its XLA name, the issuing rank's mesh position, the operand's bytes, the
#: comm's axes) and of the transpose autograd runs for it; they must be
#: thread-safe
observers: List[Callable[[str, int, int, Tuple[str, ...]], None]] = []

#: the op autograd runs for each op's backward (the reference's transposes)
_TRANSPOSE = {"all-reduce": "all-reduce", "all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
              "all-to-all": "all-to-all", "collective-permute": "collective-permute",
              "collective-broadcast": "all-reduce", "reduce": "collective-broadcast"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _observe(op: str, slot: int, x, y, axes: Tuple[str, ...]) -> None:
    """Tell the observers of an op and, once its cotangent arrives, of its
    transpose (whose operand is the cotangent of ``y``)."""
    watching = tuple(observers)
    for fn in watching:
        fn(op, slot, _nbytes(x), axes)
    if watching and isinstance(y, torch.Tensor) and y.requires_grad:
        def transpose(grad):
            for fn in watching:
                fn(_TRANSPOSE[op], slot, _nbytes(grad), axes)
            return grad

        y.register_hook(transpose)


def _issue(comm: StreamComm, x, token, compute: Callable[[List[torch.Tensor], int], torch.Tensor], op: str):
    """Run one collective (``op``, its XLA name) for the calling rank
    without joining its current stream: post ``x``, gather the group's
    tensors, compute this rank's result on the issuing stream. Returns
    ``(y, done, side)``: ``done`` is the event after the result on ``side``
    (None on the CPU); the caller joins with :func:`_join`."""
    region = _mesh.current_region()
    if region is None:
        raise RuntimeError("collectives are per-rank code: call them inside a shard_map region")
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        vals, me = region.exchange(comm.axes, (x, None))
        y = compute([v for v, _ in vals], me)
        _observe(op, region.slot, x, y, tuple(comm.axes))
        return y, None, None
    cur = torch.cuda.current_stream(x.device)
    side = comm.stream.torch_stream(x.device) or cur
    if side is not cur:
        side.wait_stream(cur)
    for ev in _events(token):
        side.wait_event(ev)
    ready = torch.cuda.Event()
    ready.record(side)  # recorded before it is published: peers never wait on an unrecorded event
    vals, me = region.exchange(comm.axes, (x, ready))
    with torch.cuda.stream(side):
        for i, (v, ev) in enumerate(vals):
            if i != me:
                side.wait_event(ev)
            if v.is_cuda:
                v.record_stream(side)
        y = compute([v for v, _ in vals], me)
        done = torch.cuda.Event()
        done.record(side)
    _observe(op, region.slot, x, y, tuple(comm.axes))
    return y, done, side


def _outside_regions(grad):
    if _mesh.current_region() is not None:
        raise RuntimeError(
            "backward through a collective inside a shard_map region: call backward "
            "from the caller, after the region"
        )
    return grad


def _join(y, done, side, token):
    """Order the current stream after an issued op; returns ``(y, token')``."""
    if y.requires_grad:
        y.register_hook(_outside_regions)
    if done is None:
        return y, None
    cur = torch.cuda.current_stream(y.device)
    if side is not cur:
        cur.wait_event(done)
        y.record_stream(cur)  # allocated on ``side``, read on the current stream
    return y, (done if token is not None else None)


_logs = threading.local()


class CollectiveLog:
    """One rank's collective results inside one recomputed unit (the module
    docstring): inside a region :meth:`scope` records each result; outside
    one it replays them, in issue order, as leaves of the forward's
    ``requires_grad`` (autograd saves the same tensors for them)."""

    def __init__(self):
        self.results: List[torch.Tensor] = []
        self._next: Optional[int] = None

    @contextmanager
    def scope(self):
        replay = _mesh.current_region() is None
        outer, _logs.log = getattr(_logs, "log", None), self
        self._next = 0 if replay else None
        try:
            yield self
        finally:
            _logs.log, self._next = outer, None

    def take(self) -> torch.Tensor:
        if self._next >= len(self.results):
            raise RuntimeError(f"the recompute issues collective {self._next + 1}; its forward issued "
                               f"{len(self.results)}")
        y = self.results[self._next]
        self._next += 1
        return y.detach().requires_grad_(y.requires_grad)


def _collective(comm, x, token, compute, op: str):
    log = getattr(_logs, "log", None)
    if log is not None and log._next is not None:
        return log.take(), None
    y, token = _join(*_issue(comm, x, token, compute, op), token)
    if log is not None:
        log.results.append(y)
    return y, token


def _fold_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum in the given order (the group-rank order every rank shares)."""
    out = parts[0].clone() if len(parts) == 1 else parts[0] + parts[1]
    for p in parts[2:]:
        out.add_(p)
    return out


def _chunk(v: torch.Tensor, axis: int, i: int, n: int) -> torch.Tensor:
    if v.shape[axis] % n:
        raise ValueError(f"dim {axis} ({v.shape[axis]}) not divisible by {n} ranks")
    c = v.shape[axis] // n
    return v.narrow(axis, i * c, c)


# ----------------------------------------------------------------------
# Core collectives
# ----------------------------------------------------------------------


def all_reduce(x, comm: StreamComm, token: Optional[Token] = None):
    """psum over the (flattened) comm axes. Returns (y, token')."""
    return _collective(comm, x, token, lambda vals, me: _fold_sum(vals), "all-reduce")


def all_gather(x, comm: StreamComm, axis: int = 0, tiled: bool = True, token: Optional[Token] = None):
    """Every rank's ``x`` concatenated along ``axis`` (``tiled``) or stacked
    on a new ``axis``, in group-rank order."""
    join = torch.cat if tiled else torch.stack
    return _collective(comm, x, token, lambda vals, me: join(vals, dim=axis), "all-gather")


def reduce_scatter(x, comm: StreamComm, axis: int = 0, token: Optional[Token] = None):
    """psum_scatter (tiled): rank i gets chunk i along ``axis`` of the sum."""
    return _collective(
        comm, x, token, lambda vals, me: _fold_sum([_chunk(v, axis, me, len(vals)) for v in vals]), "reduce-scatter"
    )


def reduce(x, comm: StreamComm, root: int = 0, token: Optional[Token] = None):
    """The sum over the comm's ranks, on ``root`` only; the other ranks get
    an empty tensor (a layer of ZeRO-1's stacking-dim moments: its grad
    summed on the dp rank that owns it)."""
    return _collective(comm, x, token,
                       lambda vals, me: _fold_sum(vals) if me == root else vals[me].new_empty((0,)), "reduce")


def all_to_all(x, comm: StreamComm, split_axis: int, concat_axis: int, token: Optional[Token] = None):
    """Rank i gets chunk i (along ``split_axis``) of every rank's ``x``,
    concatenated along ``concat_axis`` in group-rank order."""
    return _collective(
        comm, x, token,
        lambda vals, me: torch.cat([_chunk(v, split_axis, me, len(vals)) for v in vals], dim=concat_axis),
        "all-to-all",
    )


def _permute(perm: Sequence[Tuple[int, int]]):
    src_of = {}
    for s, d in perm:
        if d in src_of:
            raise ValueError(f"ppermute: rank {d} receives from both {src_of[d]} and {s}")
        src_of[d] = s

    def compute(vals, me):
        src = src_of.get(me)
        return torch.zeros_like(vals[me]) if src is None else vals[src].clone()

    return compute


def ppermute(x, comm: StreamComm, perm: Sequence[Tuple[int, int]], token: Optional[Token] = None):
    """Point-to-point permutation along the comm's (single) axis; a rank no
    pair sends to receives zeros."""
    if len(comm.axes) != 1:
        raise ValueError("ppermute needs a single-axis comm; flatten first")
    return _collective(comm, x, token, _permute(perm), "collective-permute")


def broadcast(x, comm: StreamComm, root: int = 0, token: Optional[Token] = None):
    """Broadcast root's shard to all ranks of the comm."""
    return _collective(comm, x, token, lambda vals, me: vals[root].clone(), "collective-broadcast")


def pshuffle(x, comm: StreamComm, shift: int = 1, token: Optional[Token] = None):
    """Ring shift by ``shift`` along a single-axis comm."""
    n = comm.mesh.shape[comm.axes[0]] if comm.mesh is not None else None
    if n is None:
        raise ValueError("pshuffle needs a bound mesh to build the ring")
    perm = [(i, (i + shift) % n) for i in range(n)]
    return ppermute(x, comm, perm, token)


# ----------------------------------------------------------------------
# Multi-stream (chunked, concurrent) collectives — the Fig.4 insight
# ----------------------------------------------------------------------


def _split_chunks(x, k: int, axis: int = 0):
    if x.shape[axis] % k:
        raise ValueError(f"dim {axis} ({x.shape[axis]}) not divisible by {k} streams")
    return torch.chunk(x, k, dim=axis)


def _multi_stream(x, comms, tokens, axis, compute, op: str):
    """Issue one chunk of ``x`` per comm, every chunk before any join, so
    chunks on distinct streams run concurrently; then join them all."""
    k = len(comms)
    chunks = _split_chunks(x, k, axis)
    tokens = list(tokens) if tokens is not None else [None] * k
    issued = [_issue(comm, c, tokens[i], compute, op) for i, (c, comm) in enumerate(zip(chunks, comms))]
    outs = []
    for i, it in enumerate(issued):
        y, tokens[i] = _join(*it, tokens[i])
        outs.append(y)
    return torch.cat(outs, dim=axis), tokens


def multi_stream_all_reduce(
    x,
    comms: Sequence[StreamComm],
    tokens: Optional[Sequence[Token]] = None,
    axis: int = 0,
):
    """Split ``x`` into ``len(comms)`` chunks and all-reduce each on its own
    stream. With distinct streams the chunks run on distinct CUDA streams
    (parallel VCIs); with one shared stream they serialize on it (the
    paper's global-critical-section baseline).

    Returns (y, tokens')."""
    return _multi_stream(x, comms, tokens, axis, lambda vals, me: _fold_sum(vals), "all-reduce")


def multi_stream_all_gather(
    x,
    comms: Sequence[StreamComm],
    tokens: Optional[Sequence[Token]] = None,
    axis: int = 0,
    gather_axis: int = 0,
):
    return _multi_stream(x, comms, tokens, axis, lambda vals, me: torch.cat(vals, dim=gather_axis), "all-gather")


# ----------------------------------------------------------------------
# Multiplex-comm p2p (MPIX_Stream_send/recv with stream indices)
# ----------------------------------------------------------------------


def stream_send_recv(
    x,
    comm: StreamComm,
    perm: Sequence[Tuple[int, int]],
    source_stream_index: int = 0,
    dest_stream_index: int = 0,
    token: Optional[Token] = None,
):
    """``MPIX_Stream_send``/``recv`` on a multiplex comm: the (src,dst)
    stream indices select which attached stream carries the transfer.
    SPMD: every rank supplies its outgoing shard, receives the incoming
    one. ``dest_stream_index=-1`` = any-stream receive (maps to the first
    stream; ordering only vs that stream)."""
    if source_stream_index >= len(comm.streams):
        raise IndexError("source_stream_index out of range")
    if dest_stream_index >= len(comm.streams):
        raise IndexError("dest_stream_index out of range")
    use = comm.streams[max(dest_stream_index, 0)]
    sub = StreamComm(comm.axes, (use,), comm.mesh)
    return ppermute(x, sub, perm, token)
