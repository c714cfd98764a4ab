"""Bucketed gradient synchronization with stream-level overlap.

The datatype layer (paper ext. 2) describes each flattened parameter
group as a ``struct`` datatype; buckets are cut at ``bucket_bytes``
boundaries with ``type_iov_len`` (whole segments within a byte budget —
exactly the paper's stated use of ``max_iov_bytes``). Each bucket's
all-reduce/reduce-scatter is issued on its own stream communicator
(ext. 3) in round-robin: on the card every comm stream is a CUDA stream
per mesh position, so bucket i's collective overlaps bucket i+1's.

The port of ``repro.optim.grad_overlap``. Where the reference jits one
``shard_map`` program per bucket, the port runs the bucket's collective in
a :func:`~repro_torch.core.mesh.shard_map` region over the comm's mesh,
whose positions are thread-ranks; completion is the CUDA event recorded
after the dispatched work (``dispatch_enqueue``), polled by the progress
engine. Gradient trees are mappings (a module's ``named_parameters()``
order) or sequences of tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Sequence, Tuple

import torch

from repro_torch.core import datatype as dt
from repro_torch.core import mesh as _mesh
from repro_torch.core.collectives import all_gather, all_reduce, reduce_scatter
from repro_torch.core.enqueue import _poll_dispatched, _wait_dispatched, dispatch_enqueue, dispatch_state
from repro_torch.core.mesh import P, shard_map
from repro_torch.core.progress import default_engine
from repro_torch.core.streams import StreamComm, new_token

__all__ = [
    "GradBuckets",
    "build_buckets",
    "bucketed_all_reduce",
    "bucketed_all_reduce_host",
    "flatten_grads",
    "unflatten_grads",
]

#: bound, in seconds, on every wait for a bucket's collectives; a wait that
#: runs out raises ``TimeoutError``
WAIT_TIMEOUT_S = 10.0


def _wait_requests(eng, reqs, what: str) -> None:
    if not eng.wait_all([r.grequest for r in reqs], WAIT_TIMEOUT_S):
        raise TimeoutError(f"bucketed_all_reduce_host: {what} not complete after {WAIT_TIMEOUT_S} s")


@dataclass(frozen=True)
class GradBuckets:
    """Host-side plan: which flat-leaf slices form each bucket."""

    leaf_sizes: Tuple[int, ...]  # element counts per leaf (flattened order)
    bucket_slices: Tuple[Tuple[int, int], ...]  # (start_elem, n_elem) per bucket
    dtype_descr: object  # the struct datatype describing the full layout
    itemsize: int

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_slices)

    @property
    def total_elems(self) -> int:
        return sum(self.leaf_sizes)


def _leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def build_buckets(params_shape, bucket_bytes: int = 4 << 20, itemsize: int = 4) -> GradBuckets:
    """Cut the flattened grad vector into ~bucket_bytes buckets using the
    datatype/iovec machinery on the struct-of-leaves layout. ``params_shape``
    is a mapping or sequence of anything with a ``shape``."""
    sizes = [int(math.prod(l.shape)) for l in _leaves(params_shape)]
    # struct datatype: one contiguous block per leaf, packed back to back
    displs, off = [], 0
    for s in sizes:
        displs.append(off * itemsize)
        off += s
    descr = dt.struct([1] * len(sizes), displs, [dt.contiguous(s, dt.predefined(itemsize)) for s in sizes])
    # bucket boundaries via type_iov_len: whole segments within byte budget
    slices = []
    seg_off = 0
    elem_off = 0
    n_segs = descr.num_segments
    while seg_off < n_segs:
        # bytes already consumed + budget → how many whole segments fit
        n_in, b_in = dt.type_iov_len(descr, elem_off * itemsize + bucket_bytes)
        n_take = max(1, n_in - seg_off)  # at least one segment per bucket
        take_elems = (descr.cum_bytes(seg_off + n_take) - elem_off * itemsize) // itemsize
        slices.append((elem_off, int(take_elems)))
        seg_off += n_take
        elem_off += int(take_elems)
    return GradBuckets(tuple(sizes), tuple(slices), descr, itemsize)


def flatten_grads(grads) -> torch.Tensor:
    return torch.cat([l.to(torch.float32).reshape(-1) for l in _leaves(grads)])


def unflatten_grads(flat: torch.Tensor, grads_template):
    """``flat`` cut back into the template's leaves, shapes and dtypes (a
    dict for a mapping template, a list otherwise)."""
    out, off = [], 0
    for l in _leaves(grads_template):
        n = int(math.prod(l.shape))
        out.append(flat[off : off + n].reshape(l.shape).to(l.dtype))
        off += n
    if isinstance(grads_template, Mapping):
        return dict(zip(grads_template.keys(), out))
    return out


def bucketed_all_reduce(
    flat_grads,
    plan: GradBuckets,
    comms: Sequence[StreamComm],
    scatter: bool = False,
):
    """All-reduce (or reduce-scatter) each bucket on a round-robin stream.
    Per-rank code: call it inside a shard_map region. Returns (flat, tokens).

    Independent streams ⇒ independent CUDA streams ⇒ the collectives
    overlap; one stream ⇒ a serialized chain (the implicit baseline)."""
    k = len(comms)
    tokens = [new_token(flat_grads.device) for _ in range(k)]
    outs = []
    for i, (start, n) in enumerate(plan.bucket_slices):
        comm_i = comms[i % k]
        chunk = flat_grads.narrow(0, start, n)
        if scatter:
            y, tokens[i % k] = reduce_scatter(chunk, comm_i, axis=0, token=tokens[i % k])
        else:
            y, tokens[i % k] = all_reduce(chunk, comm_i, token=tokens[i % k])
        outs.append(y)
    return torch.cat(outs), tokens


# ----------------------------------------------------------------------
# Host-driven bucket round-robin (record/replay capable)
# ----------------------------------------------------------------------


def _bucket_program(comm: StreamComm, start: int, n: int, scatter: bool):
    """One per-bucket collective region: slice (start, n) of the replicated
    flat vector, reduced over ``comm``'s axis on ``comm``'s stream. Shared by
    the eager host path and the recorded replay."""
    axis = comm.axes[0]

    def body(flat):
        chunk = flat.narrow(0, start, n)
        if scatter:
            y, _ = reduce_scatter(chunk, comm, axis=0)
        else:
            y, _ = all_reduce(chunk, comm)
        return y

    return shard_map(body, mesh=comm.mesh, in_specs=P(), out_specs=P(axis) if scatter else P())


def _bucket_ag_program(comm: StreamComm, n: int):
    """All-gather half: reassemble a scattered reduced bucket into the
    replicated result. ``RS ∘ AG`` on the same comm equals the bucket's
    all-reduce (the Rabenseifner identity)."""
    axis = comm.axes[0]

    def body(y):
        z, _ = all_gather(y, comm, axis=0)
        return z

    return shard_map(body, mesh=comm.mesh, in_specs=P(axis), out_specs=P())


def _grad_fingerprint(flat_grads, plan: GradBuckets, comms, scatter: bool,
                      windowed: bool = False) -> dict:
    return {
        "kind": "grad_buckets",
        "flat_shape": tuple(flat_grads.shape),
        "flat_dtype": str(flat_grads.dtype),
        "bucket_slices": tuple(plan.bucket_slices),
        "n_comms": len(comms),
        "comm_axes": tuple(c.axes[0] for c in comms),
        "scatter": bool(scatter),
        "windowed": bool(windowed),
    }


def bucketed_all_reduce_host(
    flat_grads,
    plan: GradBuckets,
    comms: Sequence[StreamComm],
    scatter: bool = False,
    engine=None,
    schedule=None,
    window=None,
    materialize=None,
):
    """Host-driven twin of :func:`bucketed_all_reduce`: each bucket is its
    own collective region dispatched from the host in stream round-robin,
    its completion a generalized request on the bucket's stream channel —
    the host overlaps bucket i's collective with bucket i+1's dispatch and
    blocks once, in one batched ``wait_all``.

    ``window=`` (an :class:`~repro_torch.core.enqueue.OffloadWindow`)
    switches to the backward-overlapped split schedule: each bucket's
    collective is cut into its reduce-scatter and allgather halves, the RS
    is admitted through the window the moment the bucket is ready, and the
    AG for a bucket is issued **in completion order**. ``materialize=``
    (``fn(i)``) is called right before bucket i's RS is issued (the
    backward-pass hook). ``RS ∘ AG`` on one comm is the bucket's
    all-reduce, so the result is the unsplit path's, byte for byte on a
    single-rank axis and numerically equal otherwise.

    ``schedule=`` makes the round-robin record-then-replay: the first call
    records (running the eager path while capturing one issue closure per
    bucket) and seals; later calls replay the whole round-robin as one
    fused request set with a single wait. A changed flat length/dtype,
    bucket plan, or comm set raises ``ScheduleStale``.

    Returns the reduced flat vector."""
    if _mesh.current_region() is not None:
        raise ValueError(
            "bucketed_all_reduce_host is host-side (it runs its own shard_map "
            "regions); use bucketed_all_reduce inside shard_map"
        )
    eng = engine or default_engine()
    k = len(comms)
    if schedule is not None and schedule.sealed:
        meta = schedule.meta.get("grad_buckets")
        if meta is None:
            raise ValueError(
                "bucketed_all_reduce_host: the sealed schedule was not "
                "recorded by this loop (no meta['grad_buckets'])"
            )
        ctx = schedule.replay(binding={"flat_grads": flat_grads}, timeout=WAIT_TIMEOUT_S)
        return ctx.outputs["flat"]

    windowed = window is not None
    if not windowed:
        progs = [
            _bucket_program(comms[i % k], start, n, scatter)
            for i, (start, n) in enumerate(plan.bucket_slices)
        ]
    else:
        # the reduce-scatter half: each shard keeps its 1/size piece
        rs_progs = [
            _bucket_program(comms[i % k], start, n, scatter=True)
            for i, (start, n) in enumerate(plan.bucket_slices)
        ]
        ag_progs = [
            None if scatter else _bucket_ag_program(comms[i % k], n)
            for i, (start, n) in enumerate(plan.bucket_slices)
        ]

    def run_eager():
        outs, reqs = [], []
        for i, prog in enumerate(progs):
            y = prog(flat_grads)
            reqs.append(
                dispatch_enqueue(y, stream=comms[i % k].stream, engine=eng, name="grad-bucket")
            )
            outs.append(y)
        _wait_requests(eng, reqs, "the bucket all-reduces")
        return torch.cat(outs)

    def run_windowed():
        outs: List = [None] * plan.n_buckets
        ag_reqs = []

        def issue_ag(slot):
            j, rs_j = slot.value
            if ag_progs[j] is None:  # scatter=True: the RS chunk IS the result
                outs[j] = rs_j
                return
            y = ag_progs[j](rs_j)
            ag_reqs.append(
                dispatch_enqueue(y, stream=comms[j % k].stream, engine=eng, name="grad-ag")
            )
            outs[j] = y

        for i in range(plan.n_buckets):
            if materialize is not None:
                materialize(i)  # backward produces bucket i; earlier RS/AG in flight
            rs = rs_progs[i](flat_grads)
            with window.issue(timeout=WAIT_TIMEOUT_S) as submit:
                submit(
                    dispatch_enqueue(
                        rs, stream=comms[i % k].stream, engine=eng, name="grad-rs"
                    ),
                    value=(i, rs),
                )
            for slot in window.reap():  # AGs chase completions, not issue order
                issue_ag(slot)
        for slot in window.drain(timeout=WAIT_TIMEOUT_S):
            issue_ag(slot)
        if ag_reqs:
            _wait_requests(eng, ag_reqs, "the all-gathers")
        return torch.cat(outs)

    if schedule is None:
        return run_windowed() if windowed else run_eager()

    fp = _grad_fingerprint(flat_grads, plan, comms, scatter, windowed)

    def check_and_reset(ctx):
        ctx.schedule.check(
            **_grad_fingerprint(ctx.bound("flat_grads"), plan, comms, scatter, windowed)
        )
        ctx.scratch["outs"] = []
        ctx.scratch["states"] = []

    def add_part(ctx, i, y):
        st = dispatch_state(y, comms[i % k].stream)
        ctx.fused.part(poll_fn=_poll_dispatched, extra_state=st, name="grad-bucket")
        ctx.scratch["states"].append(st)
        ctx.scratch["outs"].append(y)

    def make_bucket(i, prog):
        def issue(ctx):
            add_part(ctx, i, prog(ctx.bound("flat_grads")))

        return issue

    def make_bucket_split(i, rs_prog, ag_prog):
        def issue(ctx):
            rs = rs_prog(ctx.bound("flat_grads"))
            add_part(ctx, i, rs if ag_prog is None else ag_prog(rs))

        return issue

    def collect(ctx):
        # blocking completion assist (see ReplayContext.prewaits)
        ctx.prewaits.append(lambda: _wait_dispatched(ctx.scratch["states"], WAIT_TIMEOUT_S))
        ctx.finalizers.append(
            lambda: ctx.outputs.__setitem__("flat", torch.cat(ctx.scratch["outs"]))
        )

    rec = schedule.record()
    try:
        schedule.fingerprint(**fp)
        schedule.add_op("check", check_and_reset, parts=0, label="fingerprint")
        if windowed:
            for i in range(plan.n_buckets):
                schedule.add_op(
                    "grad_bucket",
                    make_bucket_split(i, rs_progs[i], ag_progs[i]),
                    parts=1,
                    label=f"bucket{i}",
                )
        else:
            for i, prog in enumerate(progs):
                schedule.add_op("grad_bucket", make_bucket(i, prog), parts=1, label=f"bucket{i}")
        schedule.add_op("collect", collect, parts=0, label="concat")
        out = run_windowed() if windowed else run_eager()
        schedule.meta["grad_buckets"] = {
            "n_buckets": plan.n_buckets, "n_comms": k, "windowed": windowed,
        }
        rec.seal()
    finally:
        rec.abort()
    return out
