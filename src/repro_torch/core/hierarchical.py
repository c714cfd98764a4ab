"""Hierarchical multi-pod collectives built on the threadcomm algebra.

A flat all-reduce over (pod × data) moves every byte across the pod
boundary; the hierarchical schedule

    intra-pod reduce-scatter  →  inter-pod all-reduce (1/N_inner bytes)
    →  intra-pod all-gather

sends only ``bytes / N_inner`` across the slow inter-pod links — the
standard topology-aware schedule MPI implementations hide inside
``MPI_Allreduce``, surfaced here because the threadcomm/stream extensions
give explicit communicators for each hierarchy level.

In the port every mesh position is a thread-rank (``core.mesh``), and each
rank computes its own result from the posted tensors: a flat all-reduce
makes every rank read all N inputs, the hierarchical one reads 1/N_inner of
them per level plus one gather, so it also moves fewer bytes on one card.
"""

from __future__ import annotations

from repro_torch.core.collectives import all_gather, all_reduce, reduce_scatter
from repro_torch.core.threadcomm import ThreadComm

__all__ = [
    "hierarchical_all_reduce",
    "flat_all_reduce",
    "hierarchical_collective_bytes",
]


def hierarchical_all_reduce(x, comm: ThreadComm, axis: int = 0, token=None):
    """All-reduce over the flattened comm via RS(inner) → AR(outer) → AG(inner).

    ``comm.axes = (outer, inner...)``: outer = pod axis (slow links),
    inner = intra-pod axes (fast links). Falls back to a flat all-reduce
    when the comm has a single level or the scatter dim doesn't divide.
    """
    if not comm.is_threadcomm:
        y, token = all_reduce(x, comm.as_stream_comm(), token)
        return y, token
    inner = comm.inner().as_stream_comm(comm.stream)
    outer = comm.outer().as_stream_comm(comm.stream)
    n_inner = comm.inner().size()
    if x.shape[axis] % n_inner:
        y, token = all_reduce(x, comm.as_stream_comm(comm.stream), token)
        return y, token
    y, token = reduce_scatter(x, inner, axis=axis, token=token)
    y, token = all_reduce(y, outer, token)
    y, token = all_gather(y, inner, axis=axis, token=token)
    return y, token


def flat_all_reduce(x, comm: ThreadComm, token=None):
    """Single all-reduce over the flattened axes (the baseline schedule)."""
    return all_reduce(x, comm.as_stream_comm(comm.stream), token)


def hierarchical_collective_bytes(nbytes: int, n_outer: int, n_inner: int):
    """Napkin model of bytes crossing each link class, for the roofline.

    Returns dict with per-chip bytes on inner (intra-pod) and outer
    (cross-pod) links for flat vs hierarchical ring schedules of an
    ``nbytes`` all-reduce.
    """
    n = n_outer * n_inner
    flat = {
        # ring all-reduce: 2·(n-1)/n · nbytes total per chip; a 1/n_outer
        # fraction of ring hops cross the pod boundary
        "inner_bytes": 2 * (n - 1) / n * nbytes * (1 - 1 / n_outer if n_outer > 1 else 1),
        "outer_bytes": 2 * (n - 1) / n * nbytes * (1 / n_outer if n_outer > 1 else 0),
    }
    hier = {
        # RS + AG intra-pod: 2·(n_inner-1)/n_inner · nbytes
        # AR inter-pod on 1/n_inner shard: 2·(n_outer-1)/n_outer · nbytes/n_inner
        "inner_bytes": 2 * (n_inner - 1) / n_inner * nbytes,
        "outer_bytes": (2 * (n_outer - 1) / n_outer * nbytes / n_inner) if n_outer > 1 else 0,
    }
    return {"flat": flat, "hierarchical": hier}
