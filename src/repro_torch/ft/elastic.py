"""Elastic re-meshing: survive pod/host loss by shrinking the mesh.

``plan_remesh`` maps a failed-device set to the largest viable mesh
(shrinking the data-parallel axes first — the model axes carry TP/EP
state that would need weight resharding). ``reshard_plan`` computes, per
NEW shard, the *coalesced* iovec runs to read from the iovec-store
checkpoint files (adjacent gap-free segments merged, so a shard with
dense inner dims is one pread) — because the store addresses the GLOBAL
array (see checkpoint/iovec_store.py), restarting on a different mesh is
just a different set of subarray queries. No shard-merging step, ever.

``execute_reshard`` turns a plan into bytes: every run becomes an
enqueued read request streamed through a depth-bounded
:class:`~repro_torch.core.enqueue.OffloadWindow` — at most ``depth`` reads in
flight, the issuer backpressured on the engine's stripe CV, completions
reaped in completion order. The restart shifts its shards through the
same windowed transport as the pipeline's microbatch sends.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.iovec_store import shard_subarray
from repro_torch.core import datatype as dt
from repro_torch.core.enqueue import OffloadWindow
from repro_torch.core.progress import ProgressEngine, default_engine, join_thread_states
from repro_torch.core.streams import MPIXStream, STREAM_NULL

__all__ = ["MeshPlan", "plan_remesh", "reshard_plan", "execute_reshard", "shard_slices"]

#: bound (seconds) on each wait of :func:`execute_reshard`: a free window
#: slot, and the final drain
WAIT_TIMEOUT_S = 10.0


@dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    n_devices: int
    dropped: Tuple[str, ...] = ()  # human-readable notes


def plan_remesh(
    shape: Sequence[int],
    axis_names: Sequence[str],
    n_failed: int,
    dp_axes: Sequence[str] = ("pod", "data"),
) -> MeshPlan:
    """Shrink DP axes (outermost first) until the healthy device count
    fits. TP ('model') is never shrunk — those shards hold disjoint model
    state; losing model capacity means reload-from-checkpoint anyway."""
    shape = list(shape)
    names = list(axis_names)
    healthy = int(np.prod(shape)) - n_failed
    notes = []
    for ax in dp_axes:
        if ax not in names:
            continue
        i = names.index(ax)
        while int(np.prod(shape)) > healthy and shape[i] > 1:
            shape[i] -= 1
            notes.append(f"shrunk {ax} to {shape[i]}")
    if int(np.prod(shape)) > healthy:
        raise RuntimeError(
            f"cannot re-mesh: need {int(np.prod(shape))} devices, {healthy} healthy "
            f"(model axes are not shrinkable)"
        )
    return MeshPlan(tuple(shape), tuple(names), int(np.prod(shape)), tuple(notes))


def shard_slices(global_shape: Sequence[int], grid: Sequence[int], coord: Sequence[int]):
    """Slices of the shard at ``coord`` in a dense block-partition ``grid``
    (grid[i] divides global_shape[i])."""
    out = []
    for dim, g, c in zip(global_shape, grid, coord):
        step = dim // g
        out.append(slice(c * step, (c + 1) * step))
    return tuple(out)


def reshard_plan(
    global_shape: Sequence[int],
    new_grid: Sequence[int],
    itemsize: int,
) -> Dict[Tuple[int, ...], List[dt.Iov]]:
    """Per-new-shard coalesced read-run lists against the global file.

    Returns {coord: [Iov, ...]} where each Iov is a maximal contiguous
    run (adjacent gap-free subarray segments merged). Total bytes across
    shards == array bytes (verified by the property test) — the
    conservation law that makes the restart correct by construction.
    """
    plans: Dict[Tuple[int, ...], List[dt.Iov]] = {}
    for coord in np.ndindex(*new_grid):
        idx = shard_slices(global_shape, new_grid, coord)
        sub = shard_subarray(tuple(global_shape), idx, itemsize)
        plans[tuple(coord)] = dt.coalesced_iovs(sub)
    return plans


def execute_reshard(
    plans: Dict[Tuple[int, ...], List[dt.Iov]],
    read_run: Callable[[dt.Iov], bytes],
    depth: int = 4,
    engine: ProgressEngine = None,
    stream: MPIXStream = STREAM_NULL,
) -> Tuple[Dict[Tuple[int, ...], bytes], dict]:
    """Stream a :func:`reshard_plan` through a depth-bounded window.

    ``read_run(iov) -> bytes`` performs one read against the global file
    (a pread in production; any callable in tests). Each run is issued as
    a thread-backed generalized request and admitted to an
    :class:`~repro_torch.core.enqueue.OffloadWindow` — the issue loop
    backpressures at ``depth`` outstanding reads instead of spawning one
    thread per run, and the final drain is one batched waitall; each wait is
    bounded by ``WAIT_TIMEOUT_S`` and raises ``TimeoutError``. Returns
    ``({coord: shard_bytes}, window_stats)``; per-shard bytes concatenate
    the runs in plan order regardless of the order reads completed.
    """
    eng = engine or default_engine()
    win = OffloadWindow(stream, depth=depth, engine=eng, name="reshard")
    parts: Dict[Tuple[int, ...], List[bytes]] = {
        coord: [b""] * len(runs) for coord, runs in plans.items()
    }
    errors: List[BaseException] = []
    for coord, runs in plans.items():
        for j, run in enumerate(runs):
            state = {"thread": None}

            def work(coord=coord, j=j, run=run):
                try:
                    parts[coord][j] = bytes(read_run(run))
                except BaseException as e:  # surfaced after the drain
                    errors.append(e)

            with win.issue(timeout=WAIT_TIMEOUT_S) as submit:
                t = threading.Thread(target=work, daemon=True, name=f"reshard-{coord}-{j}")
                state["thread"] = t
                t.start()
                submit(
                    eng.grequest_start(
                        poll_fn=lambda st: not st["thread"].is_alive(),
                        wait_fn=join_thread_states,
                        extra_state=state,
                        stream=stream,
                        name="reshard-read",
                    )
                )
    win.drain(timeout=WAIT_TIMEOUT_S)
    if errors:
        raise errors[0]
    return {coord: b"".join(p) for coord, p in parts.items()}, win.stats(engine=False)
