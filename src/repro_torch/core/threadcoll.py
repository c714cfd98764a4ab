"""Host collectives over thread ranks (paper ext. 5, in-process level).

The paper's motivating example ends with every thread of every process
calling one ``MPI_Allreduce`` on the threadcomm — collectives must work
with *threads as ranks*. These are the in-process algorithms backing
that: classic O(log n) message patterns from the MPI literature, built
purely on the threadcomm pt2pt layer (:meth:`ThreadRank.send` /
:meth:`ThreadRank.recv`), so every hop rides the per-thread VCI channel
and a blocked rank parks on its stripe CV rather than spinning:

* :func:`barrier`   — dissemination (each round r: send to ``rank+2^r``,
  recv from ``rank-2^r``; ceil(log2 n) rounds, no root hotspot);
* :func:`bcast`     — binomial tree from ``root``;
* :func:`reduce`    — mirrored binomial tree to ``root`` (deterministic
  combine order: a parent folds its children lowest-offset first, so
  float reductions are reproducible run-to-run);
* :func:`allreduce` — reduce → bcast (two trees; matches the numpy
  oracle the tests compare against) for control-sized payloads, with an
  automatic switch to :func:`allreduce_large` at
  :data:`LARGE_THRESHOLD` bytes;
* :func:`alltoall`  — rotation send schedule (offset d: send to
  ``rank+d``), receives posted up front (irecv) and drained in
  *completion order* through the engine's ``wait_any`` — one slow peer
  never serializes the other deliveries; sends are non-blocking mailbox
  handoffs so the rotation cannot deadlock.

Large-array collectives (the bandwidth-optimal schedules — a multi-MB
gradient must not pay log(n) full-message hops):

* :func:`reduce_scatter` — chunked ring: the flattened payload is cut
  into n near-equal chunks (remainder spread over the first ``size %
  n`` ranks, so non-divisible sizes need no padding); n-1 rounds each
  send one chunk right and fold one chunk from the left, so every rank
  moves only ``(n-1)/n · bytes`` and ends owning the fully reduced
  chunk ``rank``. Fold order is deterministic: chunk c accumulates
  contributions in ring order ``c+1, c+2, …, c`` (left-fold), so float
  reductions are reproducible run-to-run.
* :func:`allgather` — ring for general n (each round forwards the
  newest chunk), recursive doubling (``log2 n`` rounds of pairwise
  chunk-dict exchange) when n is a power of two; chunk *references*
  travel through the mailboxes (zero-copy), only the final assembly
  materializes the concatenated array.
* :func:`allreduce_large` — Rabenseifner: reduce_scatter → allgather,
  ``2·(n-1)/n · bytes`` per rank instead of the tree's ``log(n) ·
  bytes``. :func:`allreduce` switches to it automatically when the
  payload reaches :data:`LARGE_THRESHOLD` bytes (knob: module constant
  or the ``large_threshold=`` argument).

The recordable variants (:func:`record_reduce_scatter`,
:func:`record_allgather`, :func:`record_allreduce_large`) capture the
same hop graph into a :class:`~repro_torch.core.schedule.Schedule` via
``send_scheduled``/``recv_scheduled``. Ring hops are data-dependent
(round k+1 forwards the fold of round k's receive), so the recorded
recvs use the blocking ``into=`` form and the sends compute their
payload at issue time (``payload_fn=``) from the replay's scratch
state — a replay re-runs the exact hop/fold graph on fresh bound input.

Every collective call consumes one *sequence number* from the calling
rank's handle, and every internal message is tagged
``(_COLL, op, seq, round)`` — user pt2pt tags (plain ints/strings) can
never collide with collective traffic, and two back-to-back collectives
of the same kind stay separated even when a fast rank races ahead a
whole operation. Ranks must call collectives in the same order (the MPI
contract); a mismatch shows up as a recv timeout, not corruption.

Payloads combine with numpy ufuncs (``sum``/``prod``/``max``/``min``),
so values may be scalars or arbitrary ndarray shapes as long as they
broadcast-match across ranks.
"""

from __future__ import annotations

import itertools
from time import monotonic as _monotonic
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "barrier",
    "bcast",
    "reduce",
    "allreduce",
    "allreduce_large",
    "reduce_scatter",
    "allgather",
    "alltoall",
    "record_barrier",
    "record_reduce_scatter",
    "record_allgather",
    "record_allreduce_large",
    "chunk_bounds",
    "LARGE_THRESHOLD",
    "REDUCE_OPS",
]

# namespace marker: first element of every collective-internal tag
_COLL = "__tc_coll__"

# distinct scratch-key suffix per recorded standalone allgather (the
# chained reduce_scatter/allgather pair keys off the collective seq)
_record_uid = itertools.count()

#: byte threshold at which :func:`allreduce` switches from the binomial
#: reduce+bcast trees to the Rabenseifner reduce_scatter+allgather
#: schedule. 64 KiB: below it the per-hop park/notify latency dominates
#: (trees win on round count); above it the per-byte work dominates
#: (the ring's 2·(n-1)/n byte schedule wins). Override per call with
#: ``allreduce(..., large_threshold=)``.
LARGE_THRESHOLD = 64 * 1024

REDUCE_OPS: Dict[str, Callable] = {
    "sum": np.add,
    "prod": np.multiply,
    "max": np.maximum,
    "min": np.minimum,
}


def _nrounds(n: int) -> int:
    """ceil(log2(n)) — rounds of a dissemination/binomial schedule."""
    r = 0
    while (1 << r) < n:
        r += 1
    return r


def _resolve_op(op: Union[str, Callable]) -> Callable:
    if callable(op):
        return op
    try:
        return REDUCE_OPS[op]
    except KeyError:
        raise ValueError(f"unknown reduce op {op!r}; known: {sorted(REDUCE_OPS)}") from None


def barrier(h, timeout: Optional[float] = None) -> None:
    """Dissemination barrier over all ranks of ``h.comm``."""
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    if n == 1:
        return
    r = h.rank
    for k in range(_nrounds(n)):
        dist = 1 << k
        h.send((r + dist) % n, None, tag=(_COLL, "bar", seq, k))
        h.recv(src=(r - dist) % n, tag=(_COLL, "bar", seq, k), timeout=timeout)


def record_barrier(h, schedule, timeout: Optional[float] = None) -> None:
    """Record one dissemination barrier into ``schedule``: the collective
    tag sequence number is consumed exactly once, HERE, and baked into
    every hop's recorded tag — replays re-issue the same hops (the
    scheduled-tag epoch keeps back-to-back replays apart) with no seq
    counter traffic and no per-hop validation or request registration.

    All ranks must record together (the record pass executes the barrier
    eagerly), mirroring the MPI same-order collective contract. A
    replayed barrier keeps the barrier property: a rank's fused wait
    completes only after it received every round's message, and each of
    those was sent by a peer that had itself entered replay."""
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    if n == 1:
        return
    r = h.rank
    for k in range(_nrounds(n)):
        dist = 1 << k
        h.send_scheduled(schedule, (r + dist) % n, None, tag=(_COLL, "bar", seq, k))
        h.recv_scheduled(schedule, (r - dist) % n, tag=(_COLL, "bar", seq, k), timeout=timeout)


def bcast(h, obj=None, root: int = 0, timeout: Optional[float] = None):
    """Binomial-tree broadcast; every rank returns ``root``'s object (the
    same reference in-process — zero-copy, the paper's shared-address-
    space advantage over MPI-everywhere)."""
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    if n == 1:
        return obj
    rel = (h.rank - root) % n
    val = obj
    rounds = _nrounds(n)
    for k in range(rounds):
        dist = 1 << k
        if rel < dist:
            peer = rel + dist
            if peer < n:
                h.send((peer + root) % n, val, tag=(_COLL, "bc", seq, k))
        elif rel < 2 * dist:
            val = h.recv(
                src=((rel - dist) + root) % n, tag=(_COLL, "bc", seq, k), timeout=timeout
            )
    return val


def reduce(h, value, op: Union[str, Callable] = "sum", root: int = 0,
           timeout: Optional[float] = None):
    """Binomial-tree reduction to ``root``; non-root ranks return None.
    Combine order is deterministic (children folded nearest-first)."""
    fn = _resolve_op(op)
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    rel = (h.rank - root) % n
    acc = np.asarray(value)
    for k in range(_nrounds(n)):
        dist = 1 << k
        if rel & dist:
            h.send(((rel - dist) + root) % n, acc, tag=(_COLL, "rd", seq, k))
            return None
        peer = rel + dist
        if peer < n:
            other = h.recv(
                src=(peer + root) % n, tag=(_COLL, "rd", seq, k), timeout=timeout
            )
            acc = fn(acc, other)
    return acc if h.rank == root else None


def allreduce(h, value, op: Union[str, Callable] = "sum",
              timeout: Optional[float] = None,
              large_threshold: Optional[int] = None):
    """Every rank returns the full reduction (``MPI_Allreduce`` over
    thread ranks). Algorithm switch on payload size: below the byte
    threshold the binomial reduce→bcast trees (latency-optimal, the
    control-traffic path); at/above it the Rabenseifner
    reduce_scatter→allgather schedule (bandwidth-optimal — see
    :func:`allreduce_large`). The switch is a pure function of the
    payload's shape/dtype, which the MPI contract requires to match
    across ranks — every rank takes the same branch."""
    thr = LARGE_THRESHOLD if large_threshold is None else large_threshold
    arr = np.asarray(value)
    if h.comm.nthreads > 1 and arr.size > 0 and arr.nbytes >= thr:
        return allreduce_large(h, arr, op=op, timeout=timeout)
    acc = reduce(h, value, op=op, root=0, timeout=timeout)
    return bcast(h, acc, root=0, timeout=timeout)


# ----------------------------------------------------------------------
# bandwidth-optimal large-array collectives (ring / recursive doubling)
# ----------------------------------------------------------------------


def chunk_bounds(total: int, n: int) -> List[tuple]:
    """(offset, size) of each rank's chunk of a ``total``-element flat
    array cut n ways: ``total // n`` each, the remainder spread one
    element at a time over the first ``total % n`` ranks — non-divisible
    sizes need no padding, trailing chunks may be empty."""
    base, rem = divmod(total, n)
    out, off = [], 0
    for r in range(n):
        sz = base + (1 if r < rem else 0)
        out.append((off, sz))
        off += sz
    return out


def _axslice(arr: np.ndarray, axis: Optional[int], off: int, sz: int) -> np.ndarray:
    """View of ``arr`` sliced ``[off:off+sz]`` along ``axis`` (flattened
    view when ``axis`` is None)."""
    if axis is None:
        return arr.reshape(-1)[off : off + sz]
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(off, off + sz)
    return arr[tuple(idx)]


def reduce_scatter(h, value, op: Union[str, Callable] = "sum",
                   timeout: Optional[float] = None,
                   axis: Optional[int] = None) -> np.ndarray:
    """Ring reduce-scatter over the flattened ``value``: returns this
    rank's fully reduced chunk (``chunk_bounds(size, n)[rank]``), a 1-D
    array of the input dtype. ``axis=`` chunks along one dimension
    instead of the flattened array (the hybrid device level scatters the
    column dim while keeping mesh rows whole); the chunk then keeps every
    other dimension.

    Round k (0..n-2): send the chunk accumulated so far — initially our
    own slice of chunk ``rank-1`` — to ``rank+1``, receive the partial
    for chunk ``rank-k-2`` from ``rank-1`` and fold our slice into it.
    After n-1 rounds the last fold lands on chunk ``rank``. Each hop
    carries a chunk *reference* (zero-copy mailbox handoff); the fold
    allocates the new partial, never mutating the sender's buffer or
    the caller's input. Deterministic combine order: chunk c is
    left-folded in ring order c+1, c+2, …, c."""
    fn = _resolve_op(op)
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    arr = np.asarray(value)
    extent = arr.size if axis is None else arr.shape[axis]
    bounds = chunk_bounds(extent, n)
    r = h.rank
    if n == 1:
        return _axslice(arr, axis, 0, extent).copy()
    right, left = (r + 1) % n, (r - 1) % n
    off, sz = bounds[(r - 1) % n]
    partial = _axslice(arr, axis, off, sz)  # our contribution to the first hop (view)
    for k in range(n - 1):
        h.send(right, partial, tag=(_COLL, "rs", seq, k))
        got = h.recv(src=left, tag=(_COLL, "rs", seq, k), timeout=timeout)
        off, sz = bounds[(r - k - 2) % n]
        partial = fn(got, _axslice(arr, axis, off, sz))
    return partial


def allgather(h, value, timeout: Optional[float] = None,
              axis: Optional[int] = None) -> np.ndarray:
    """All-gather of per-rank contributions: returns the concatenation
    ordered by rank (``MPI_Allgatherv`` — sizes may differ per rank,
    e.g. the remainder chunks of :func:`reduce_scatter`). Contributions
    are flattened 1-D unless ``axis=`` names the concatenation dimension
    (the inverse of an ``axis=`` reduce-scatter).

    Power-of-two n: recursive doubling — round k exchanges the full
    chunk dict with partner ``rank ^ 2^k`` (log2 n rounds). Other n:
    ring — round k forwards chunk ``rank-k`` right and receives chunk
    ``rank-k-1`` from the left (n-1 rounds). Either way only chunk
    *references* travel; the single copy is the final assembly."""
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    arr = np.asarray(value)
    if axis is None:
        arr = arr.reshape(-1)
    r = h.rank
    chunks = {r: arr}
    if n > 1 and (n & (n - 1)) == 0:
        for k in range(_nrounds(n)):
            partner = r ^ (1 << k)
            h.send(partner, dict(chunks), tag=(_COLL, "ag", seq, k))
            got = h.recv(src=partner, tag=(_COLL, "ag", seq, k), timeout=timeout)
            chunks.update(got)
    else:
        right, left = (r + 1) % n, (r - 1) % n
        for k in range(n - 1):
            h.send(right, chunks[(r - k) % n], tag=(_COLL, "ag", seq, k))
            chunks[(r - k - 1) % n] = h.recv(
                src=left, tag=(_COLL, "ag", seq, k), timeout=timeout
            )
    if axis is None:
        return np.concatenate([np.asarray(chunks[i]).reshape(-1) for i in range(n)])
    return np.concatenate([np.asarray(chunks[i]) for i in range(n)], axis=axis)


def allreduce_large(h, value, op: Union[str, Callable] = "sum",
                    timeout: Optional[float] = None) -> np.ndarray:
    """Rabenseifner allreduce: ring :func:`reduce_scatter` then
    :func:`allgather` — every rank moves ``2·(n-1)/n · bytes`` instead
    of the binomial trees' ``log(n) · bytes``, the standard
    bandwidth-optimal schedule for multi-MB payloads. Returns the full
    reduction shaped like the input. Works for any n and any size
    (remainder chunks; trailing chunks may be empty)."""
    arr = np.asarray(value)
    chunk = reduce_scatter(h, arr, op=op, timeout=timeout)
    flat = allgather(h, chunk, timeout=timeout)
    return flat.reshape(arr.shape)


# -- recordable large collectives (core.schedule graphs) ----------------
#
# The ring hops are data-dependent (round k+1 forwards the fold of round
# k's receive), so the recorded graph carries the hop *structure* and
# re-runs the folds per replay: sends compute their payload at issue time
# (``payload_fn`` reading ctx.scratch), recvs block at issue time
# (``into=``) so the next fold op sees the payload. The record pass
# executes the collective eagerly while recording — recording IS an
# execution — and returns the eager result.


def _record_rs(h, schedule, value, op, bind, timeout):
    """Record one ring reduce-scatter; returns ``(eager_chunk, key)``
    where ``ctx.scratch[key]`` holds each replay's reduced chunk."""
    fn = _resolve_op(op)
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    arr = np.asarray(value)
    flat = arr.reshape(-1)
    size, dtype = flat.size, flat.dtype
    bounds = chunk_bounds(size, n)
    r = h.rank
    key = f"__rs{seq}:r{r}"

    def setup(ctx):
        a = np.asarray(ctx.bound(bind)) if bind is not None else arr
        f = a.reshape(-1)
        if f.size != size or f.dtype != dtype:
            ctx.schedule._stale(
                f"reduce_scatter input changed since record(): recorded "
                f"{size}x{dtype}, bound {f.size}x{f.dtype}"
            )
        ctx.scratch[key + ":flat"] = f
        if n == 1:
            ctx.scratch[key] = f.copy()
        else:
            off, sz = bounds[(r - 1) % n]
            ctx.scratch[key] = f[off : off + sz]

    schedule.add_op("tc-coll", setup, label=f"rs{seq} setup r{r}")
    if n == 1:
        return flat.copy(), key

    right, left = (r + 1) % n, (r - 1) % n
    off, sz = bounds[(r - 1) % n]
    partial = flat[off : off + sz]
    for k in range(n - 1):
        h.send_scheduled(
            schedule, right, partial, tag=(_COLL, "rs", seq, k),
            payload_fn=lambda ctx, key=key: ctx.scratch[key],
        )
        got = h.recv_scheduled(
            schedule, left, tag=(_COLL, "rs", seq, k),
            into=key + ":got", timeout=timeout,
        )
        off, sz = bounds[(r - k - 2) % n]
        partial = fn(got, flat[off : off + sz])

        def fold(ctx, off=off, sz=sz, key=key):
            ctx.scratch[key] = fn(
                ctx.scratch[key + ":got"],
                ctx.scratch[key + ":flat"][off : off + sz],
            )

        schedule.add_op("tc-coll", fold, label=f"rs{seq} fold{k} r{r}")
    return partial, key


def _record_ag(h, schedule, value, input_key, timeout):
    """Record one allgather of per-rank chunks; ``input_key`` names the
    scratch slot holding this rank's replay contribution (chained from
    :func:`_record_rs`). Returns ``(eager_flat, key)`` with
    ``ctx.scratch[key]`` the concatenated replay result."""
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    arr = np.asarray(value).reshape(-1)
    r = h.rank
    key = f"__ag{seq}:r{r}"
    ck = key + ":chunks"

    def setup(ctx):
        ctx.scratch[ck] = {r: ctx.scratch[input_key]}

    schedule.add_op("tc-coll", setup, label=f"ag{seq} setup r{r}")
    chunks = {r: arr}
    if n > 1 and (n & (n - 1)) == 0:
        for k in range(_nrounds(n)):
            partner = r ^ (1 << k)
            h.send_scheduled(
                schedule, partner, dict(chunks), tag=(_COLL, "ag", seq, k),
                payload_fn=lambda ctx, ck=ck: dict(ctx.scratch[ck]),
            )
            got = h.recv_scheduled(
                schedule, partner, tag=(_COLL, "ag", seq, k),
                into=key + ":got", timeout=timeout,
            )
            chunks.update(got)

            def merge(ctx, ck=ck, key=key):
                ctx.scratch[ck].update(ctx.scratch[key + ":got"])

            schedule.add_op("tc-coll", merge, label=f"ag{seq} merge{k} r{r}")
    elif n > 1:
        right, left = (r + 1) % n, (r - 1) % n
        for k in range(n - 1):
            src_chunk = (r - k) % n
            dst_chunk = (r - k - 1) % n
            h.send_scheduled(
                schedule, right, chunks[src_chunk], tag=(_COLL, "ag", seq, k),
                payload_fn=lambda ctx, ck=ck, c=src_chunk: ctx.scratch[ck][c],
            )
            chunks[dst_chunk] = h.recv_scheduled(
                schedule, left, tag=(_COLL, "ag", seq, k),
                into=key + ":got", timeout=timeout,
            )

            def store(ctx, ck=ck, key=key, c=dst_chunk):
                ctx.scratch[ck][c] = ctx.scratch[key + ":got"]

            schedule.add_op("tc-coll", store, label=f"ag{seq} store{k} r{r}")

    def assemble(ctx):
        ctx.scratch[key] = np.concatenate(
            [np.asarray(ctx.scratch[ck][i]).reshape(-1) for i in range(n)]
        )

    schedule.add_op("tc-coll", assemble, label=f"ag{seq} assemble r{r}")
    eager = np.concatenate([np.asarray(chunks[i]).reshape(-1) for i in range(n)])
    return eager, key


def record_reduce_scatter(h, schedule, value, op: Union[str, Callable] = "sum",
                          *, bind: Optional[str] = None,
                          out: Optional[str] = None,
                          timeout: Optional[float] = None) -> np.ndarray:
    """Record a ring :func:`reduce_scatter` into ``schedule``. ``bind=``
    names the replay binding supplying each replay's input (omit to
    replay the record-time constant); ``out=`` stores each replay's
    reduced chunk in ``ctx.outputs[out]``. Executes eagerly and returns
    the record pass's chunk. Replay inputs must keep the record-time
    flat size and dtype (validated; mismatch invalidates the
    schedule)."""
    eager, key = _record_rs(h, schedule, value, op, bind, timeout)
    if out is not None:

        def emit(ctx):
            ctx.outputs[out] = ctx.scratch[key]

        schedule.add_op("tc-coll", emit, label=f"rs out r{h.rank}")
    return eager


def record_allgather(h, schedule, value, *, bind: Optional[str] = None,
                     out: Optional[str] = None,
                     timeout: Optional[float] = None) -> np.ndarray:
    """Record an :func:`allgather` of per-rank chunks into ``schedule``
    (sizes may differ per rank). Same ``bind=``/``out=`` contract as
    :func:`record_reduce_scatter`."""
    arr = np.asarray(value).reshape(-1)
    size, dtype = arr.size, arr.dtype
    ik = f"__agin:r{h.rank}:{next(_record_uid)}"

    def setup(ctx):
        a = np.asarray(ctx.bound(bind)).reshape(-1) if bind is not None else arr
        if a.size != size or a.dtype != dtype:
            ctx.schedule._stale(
                f"allgather input changed since record(): recorded "
                f"{size}x{dtype}, bound {a.size}x{a.dtype}"
            )
        ctx.scratch[ik] = a

    schedule.add_op("tc-coll", setup, label=f"ag in r{h.rank}")
    eager, key = _record_ag(h, schedule, arr, ik, timeout)
    if out is not None:

        def emit(ctx):
            ctx.outputs[out] = ctx.scratch[key]

        schedule.add_op("tc-coll", emit, label=f"ag out r{h.rank}")
    return eager


def record_allreduce_large(h, schedule, value, op: Union[str, Callable] = "sum",
                           *, bind: Optional[str] = None,
                           out: Optional[str] = None,
                           timeout: Optional[float] = None) -> np.ndarray:
    """Record a Rabenseifner :func:`allreduce_large` (reduce_scatter →
    allgather) into ``schedule``. Each replay re-runs the hop/fold graph
    on the freshly bound input and yields a result byte-identical to the
    eager collective on the same data. ``out=`` stores each replay's
    full reduction (record-time shape) in ``ctx.outputs[out]``."""
    arr = np.asarray(value)
    shape = arr.shape
    chunk, rs_key = _record_rs(h, schedule, arr, op, bind, timeout)
    flat, ag_key = _record_ag(h, schedule, chunk, rs_key, timeout)
    if out is not None:

        def emit(ctx):
            ctx.outputs[out] = ctx.scratch[ag_key].reshape(shape)

        schedule.add_op("tc-coll", emit, label=f"ar out r{h.rank}")
    return flat.reshape(shape)


def alltoall(h, items: Sequence, timeout: Optional[float] = None) -> List:
    """Personalized all-to-all: ``items[j]`` goes to rank ``j``; returns
    ``out`` with ``out[i]`` = the item rank ``i`` addressed to us.

    Rotation *send* schedule (offset d: send to ``rank+d``), but the
    receive side posts every expected message up front (irecv) and drains
    via the engine's ``wait_any`` — arrivals are handed over in whatever
    order they land, so one slow peer never serializes the other n-2
    deliveries behind a fixed recv order (the result is indexed by
    source, hence deterministic regardless of completion order)."""
    n = h.comm.nthreads
    seq = h._next_coll_seq()
    if len(items) != n:
        raise ValueError(f"alltoall needs exactly {n} items, got {len(items)}")
    r = h.rank
    out: List = [None] * n
    out[r] = items[r]
    if n == 1:
        return out
    posted = [h.irecv(src=(r - d) % n, tag=(_COLL, "a2a", seq, d)) for d in range(1, n)]
    for d in range(1, n):
        h.send((r + d) % n, items[(r + d) % n], tag=(_COLL, "a2a", seq, d))
    engine = h.comm.engine
    deadline = None if timeout is None else _monotonic() + timeout
    pending = {id(f.grequest): f for f in posted}
    while pending:
        remaining = None if deadline is None else max(0.0, deadline - _monotonic())
        got = engine.wait_any([f.grequest for f in pending.values()], remaining)
        if got is None:
            # withdraw the outstanding posts before raising: an abandoned
            # live post would silently swallow a late peer's send (which
            # should instead surface as undelivered at finish()) and leak
            # its request in the engine queue
            for f in pending.values():
                if not f.cancel():
                    out[f.source] = f.payload  # fulfilled while cancelling
            raise TimeoutError(
                f"alltoall: rank {r} timed out with {len(pending)} recv(s) outstanding"
            )
        f = pending.pop(id(got))
        out[f.source] = f.payload
    return out
