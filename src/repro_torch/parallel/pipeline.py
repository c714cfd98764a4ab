"""Pipeline parallelism over an explicit mesh axis, transported by the
enqueue extension (paper ext. 4).

The port of ``repro.parallel.pipeline``. Two schedules share the stage
math:

* :func:`gpipe_forward` — per-rank code inside a
  :func:`~repro_torch.core.mesh.shard_map` region: a loop over clock
  ticks in which every stage applies its layers and sends its activation
  to the next stage (a token-threaded ``ppermute``). Backward is autograd
  through the loop: the caller's one ``backward`` after the region routes
  each cotangent back through the reverse permutes, as the reference's
  ``jax.grad`` through its scan does. Bubble fraction = (P-1)/T with
  T = n_micro + P - 1 ticks.
* :func:`gpipe_forward_host` — the host-driven 1F1B-style variant: one
  region per clock tick, whose boundary send runs on the comm's stream and
  is registered in an :class:`~repro_torch.core.enqueue.OffloadWindow`,
  so up to ``depth`` microbatch sends stay outstanding per stage boundary.
  The host only blocks when the window backpressures.

Stage parameters are either tensors stacked ``(n_stages, L/P, ...)`` (a
dict, list or tuple of them) or one object per stage, such as the
``nn.ModuleList``\\ s of the port's per-layer modules that
:func:`split_stages` makes. Every rank receives all of them and takes its
own stage (the reference shards the stack over the pipe axis instead;
the values each stage computes with are the same).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.core.collectives import all_reduce, ppermute
from repro_torch.core.enqueue import OffloadWindow, _poll_dispatched, _wait_dispatched, dispatch_enqueue, dispatch_state
from repro_torch.core.mesh import P, axis_index, axis_size, current_region, shard_map
from repro_torch.core.streams import STREAM_NULL, StreamComm, new_token, serialize_on
from repro_torch.models.transformer import check_dense_only

__all__ = ["gpipe_forward", "gpipe_forward_host", "pipeline_loss_fn", "split_stages"]


def _is_stage_list(stage_params) -> bool:
    return isinstance(stage_params, (list, tuple, nn.ModuleList)) and len(stage_params) > 0 and all(
        isinstance(s, nn.Module) for s in stage_params)


def _stage_of(stage_params, i: int):
    """Stage ``i``'s parameters: row ``i`` of every stacked tensor, or the
    ``i``-th stage object."""
    if _is_stage_list(stage_params):
        return stage_params[i]
    if isinstance(stage_params, torch.Tensor):
        return stage_params[i]
    if isinstance(stage_params, dict):
        return {k: _stage_of(v, i) for k, v in stage_params.items()}
    if isinstance(stage_params, (list, tuple)):
        return type(stage_params)(_stage_of(v, i) for v in stage_params)
    raise TypeError(f"stage params hold a {type(stage_params).__name__}, not tensors or modules")


def _named_leaves(tree, path: str = ""):
    """(path, tensor) of every parameter tensor, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, nn.Module):
        return [(f"{path}/{n}", p) for n, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _named_leaves(v, f"{path}/{i}")]
    raise TypeError(f"stage params hold a {type(tree).__name__}, not tensors or modules")


def _gpipe_fingerprint(stage_params, x_micro, axis: str, n_stages: int, depth: int,
                       stage_fn: Callable) -> dict:
    """The structure a recorded 1F1B schedule depends on. Compared by
    :meth:`~repro_torch.core.schedule.Schedule.check` on every replay — any
    drift raises ``ScheduleStale`` instead of replaying a wrong graph."""
    leaves = _named_leaves(stage_params)
    return {
        "kind": "gpipe_host",
        "axis": axis,
        "n_stages": n_stages,
        "depth": depth,
        "x_shape": tuple(x_micro.shape),
        "x_dtype": str(x_micro.dtype),
        "params_tree": tuple(p for p, _ in leaves),
        "params_leaves": tuple((tuple(t.shape), str(t.dtype)) for _, t in leaves),
        "stage_fn": getattr(stage_fn, "__qualname__", repr(stage_fn)),
    }


def gpipe_forward(stage_fn: Callable, stage_params, x_micro, axis_name: str):
    """Run inside shard_map, ``axis_name`` = pipeline axis.

    stage_fn(stage_params, x) -> y with y.shape == x.shape; ``stage_params``
    are this rank's stage.
    x_micro: (n_micro, mb, S, d) — microbatch activations fed to stage 0.
    Returns (n_micro, mb, S, d) stage-(P-1) outputs (valid on last rank).
    """
    n_stages = axis_size(axis_name)
    rank = axis_index(axis_name)
    comm = StreamComm((axis_name,), (STREAM_NULL,), current_region().mesh)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]
    buf, token, ys = torch.zeros_like(x_micro[0]), new_token(x_micro.device), []
    for t in range(ticks):
        x_in = x_micro[min(t, n_micro - 1)] if rank == 0 else buf
        y = stage_fn(stage_params, x_in)
        # enqueue to the next stage: device-ordered, token-threaded
        token, (y_s,) = serialize_on(token, y)
        buf, token = ppermute(y_s, comm, fwd_perm, token)
        ys.append(y)
    return torch.stack(ys[n_stages - 1:])  # output for microbatch m at tick m + P - 1


_tick_programs: dict = {}


def _tick_program(stage_fn: Callable, comm: StreamComm, n_stages: int):
    """The one-clock-tick region, memoized on (stage_fn, mesh, axis,
    stream, n_stages): the eager loop and the recorded replay run the same
    closure, the boundary send on the comm's stream."""
    mesh, axis = comm.mesh, comm.axes[0]
    key = (stage_fn, mesh, axis, comm.stream, n_stages)
    cached = _tick_programs.get(key)
    if cached is not None:
        return cached
    fwd_perm = [(i, i + 1) for i in range(n_stages - 1)]

    def tick(sp, buf, x0):
        rank = axis_index(axis)
        x_in = x0 if rank == 0 else buf[0]
        y = stage_fn(_stage_of(sp, rank), x_in)
        # the boundary send: device-ordered, token-threaded (enqueue ext.)
        token, (y_s,) = serialize_on(new_token(y.device), y)
        nxt, _ = ppermute(y_s, comm, fwd_perm, token)
        return nxt[None], y[None]

    prog = shard_map(tick, mesh, in_specs=(P(), P(axis), P()), out_specs=(P(axis), P(axis)))
    _tick_programs[key] = prog
    return prog


def gpipe_forward_host(
    stage_fn: Callable,
    stage_params,
    x_micro,
    comm: StreamComm,
    depth: Optional[int] = None,
    engine=None,
    window: Optional[OffloadWindow] = None,
    schedule=None,
):
    """Host-driven pipeline forward with a depth-N boundary-send window.

    Same schedule as :func:`gpipe_forward`, but each clock tick is its own
    region dispatched from the host; the tick's stage-boundary send runs
    on ``comm``'s stream and is registered in an
    :class:`~repro_torch.core.enqueue.OffloadWindow`. Up to ``depth``
    microbatch sends stay in flight — the host keeps issuing (CUDA launches
    are asynchronous) and only blocks when the window backpressures, so
    issue overhead of tick t+1 overlaps device work of tick t. Completions
    are reaped in completion order; the final ``drain`` is the schedule's
    flush.

    ``stage_params``: every stage's parameters (see the module docstring).
    ``x_micro``: (n_micro, mb, S, d) fed to stage 0. Returns ``(outs,
    window)`` with ``outs`` the (n_micro, mb, S, d) stage-(P-1) outputs.
    ``depth`` defaults to 2; pass either your own ``window`` or
    ``depth``/``engine``, not both.

    ``schedule=`` (a :class:`~repro_torch.core.schedule.Schedule`) makes the
    loop record-then-replay: the first call records — it runs the eager
    tick loop unchanged while capturing one pre-resolved issue closure per
    tick (the tick region, the window, the output row pick are all bound
    at record time) and seals the schedule. Every later call with the
    *same* (now sealed) schedule replays the whole graph as one fused
    request set: per tick, a window reserve, the tick region and a fused
    part — no per-tick validation, no per-request engine registration, one
    wait for the whole step. Replay output is byte-identical to the eager
    loop. Structure drift (microbatch shape/dtype, stage-param names or
    leaf shapes, stage count, window depth) raises ``ScheduleStale``.
    """
    if window is not None and (depth is not None or engine is not None):
        raise ValueError(
            "gpipe_forward_host: an explicit window carries its own depth "
            "and engine; passing depth=/engine= alongside it would be "
            "silently ignored"
        )
    mesh = comm.mesh
    axis = comm.axes[0]
    n_stages = mesh.shape[axis]
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    if schedule is not None and schedule.sealed:
        meta = schedule.meta.get("gpipe")
        if meta is None:
            raise ValueError(
                "gpipe_forward_host: the sealed schedule was not recorded "
                "by this loop (no meta['gpipe'])"
            )
        win = meta["window"]
        if window is not None and window is not win:
            raise ValueError(
                "gpipe_forward_host: replay re-issues into the window bound "
                "at record time; pass the same window or none"
            )
        if depth is not None and depth != win.depth:
            raise ValueError(
                "gpipe_forward_host: replay uses the window depth bound at "
                f"record time ({win.depth}); got depth={depth}"
            )
        # the recorded fingerprint op re-checks shapes/dtypes/geometry on
        # every replay — no second wrapper-level check needed
        ctx = schedule.replay(binding={"stage_params": stage_params, "x_micro": x_micro})
        return ctx.outputs["outs"], win
    win = window or OffloadWindow(
        comm.stream, depth=2 if depth is None else depth, engine=engine, name="pipe-1f1b"
    )

    tick = _tick_program(stage_fn, comm, n_stages)
    buf0 = torch.zeros((n_stages,) + tuple(x_micro.shape[1:]), dtype=x_micro.dtype, device=x_micro.device)

    def run_eager():
        buf, outs = buf0, []
        for t in range(ticks):
            # backpressure bracket: at most `depth` boundary sends in flight
            with win.issue() as submit:
                buf, y = tick(stage_params, buf, x_micro[min(t, n_micro - 1)])
                submit(dispatch_enqueue(y, stream=win.stream, engine=win.engine, name="pipe-tick"), value=t)
            if t >= n_stages - 1:  # microbatch t-(P-1) lands on the last stage
                outs.append(y[n_stages - 1])  # keep only the last stage's row
        win.drain()
        return torch.stack(outs), win

    if schedule is None:
        return run_eager()

    # record pass: the eager loop runs unchanged; alongside it the
    # schedule captures one issue closure per tick, all sharing the tick
    # region and `win` — the replayed graph is the same program on the
    # same transport, so its outputs are byte-identical.
    fp = _gpipe_fingerprint(stage_params, x_micro, axis, n_stages, win.depth, stage_fn)

    def check_and_reset(ctx):
        ctx.schedule.check(
            **_gpipe_fingerprint(
                ctx.bound("stage_params"), ctx.bound("x_micro"),
                axis, n_stages, win.depth, stage_fn,
            )
        )
        ctx.scratch["buf"] = buf0
        ctx.scratch["ys"] = []

    def make_tick(t):
        xi = min(t, n_micro - 1)

        def issue(ctx):
            win.reserve(timeout=None)
            try:
                nxt, y = tick(ctx.bound("stage_params"), ctx.scratch["buf"], ctx.bound("x_micro")[xi])
                ctx.scratch["buf"] = nxt
                part = ctx.fused.part(
                    poll_fn=_poll_dispatched, extra_state=dispatch_state(y, win.stream), name="pipe-tick"
                )
                win.register(part, value=t)
            except BaseException:
                win.unreserve()
                raise
            ctx.scratch["ys"].append(y)

        return issue

    def collect(ctx):
        # blocking completion assist: once the tick outputs are ready the
        # fused parent is satisfied on the first sweep, not poll-detected
        done = dispatch_state(ctx.scratch["ys"], win.stream)
        ctx.prewaits.append(lambda: _wait_dispatched([done], None))

        def fin():
            win.drain()  # completion-recorded before any reap can race
            # record-time fusion of the eager loop's per-tick output row
            # picks: one stack + one slice, byte-identical to stacking the
            # per-tick rows
            ctx.outputs["outs"] = torch.stack(ctx.scratch["ys"][n_stages - 1:])[:, n_stages - 1]

        ctx.finalizers.append(fin)

    rec = schedule.record()
    try:
        schedule.fingerprint(**fp)
        schedule.add_op("check", check_and_reset, parts=0, label="fingerprint")
        for t in range(ticks):
            schedule.add_op("pipe_tick", make_tick(t), parts=1, label=f"tick{t}")
        schedule.add_op("collect", collect, parts=0, label="stack-outs")
        out = run_eager()
        schedule.meta["gpipe"] = {
            "window": win, "ticks": ticks, "n_stages": n_stages, "n_micro": n_micro,
        }
        rec.seal()
    finally:
        rec.abort()
    return out


def split_stages(stacked_layer_params, n_stages: int):
    """Stages of ``n_stages`` equal runs of layers: a sequence of the
    port's per-layer modules becomes a list of ``nn.ModuleList``\\ s (the
    same modules, no copy); a tree of ``(L, ...)`` stacked tensors is
    reshaped to ``(n_stages, L/P, ...)``, as in the reference."""
    if _is_stage_list(stacked_layer_params):
        layers = list(stacked_layer_params)
        if len(layers) % n_stages:
            raise ValueError(f"layers {len(layers)} not divisible by {n_stages} stages")
        k = len(layers) // n_stages
        return [nn.ModuleList(layers[i * k:(i + 1) * k]) for i in range(n_stages)]

    def resh(a):
        if isinstance(a, dict):
            return {k: resh(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(resh(v) for v in a)
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"layers {L} not divisible by {n_stages} stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])

    return resh(stacked_layer_params)


def pipeline_loss_fn(
    cfg,
    mesh,
    pipe_axis: str,
    n_micro: int,
    embed_fn: Callable,
    stage_fn: Callable,
    head_loss_fn: Callable,
):
    """Build loss(params, batch) with the block stack pipelined over
    ``pipe_axis``. The embedding runs on every rank (stage 0's feeds the
    pipeline); the head and its loss only on the last stage, whose loss
    every rank of the pipe group receives through a sum (the reference
    computes the head everywhere and masks all but the last stage's).

    params = {"embed": ..., "stages": every stage's parameters (see the
    module docstring), "head": ...}. Call ``backward`` on the result after
    the region, from the caller. Dense configs only (ROADMAP P11c).
    """
    check_dense_only(cfg, "the pipeline")

    def loss(params, batch):
        def inner(stages, tokens):
            rank = axis_index(pipe_axis)
            n_stages = axis_size(pipe_axis)
            x = embed_fn(params["embed"], tokens)  # (B, S, d)
            B = x.shape[0]
            if B % n_micro:
                raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
            xm = x.reshape(n_micro, B // n_micro, *x.shape[1:])
            outs = gpipe_forward(stage_fn, _stage_of(stages, rank), xm, pipe_axis)
            outs = outs.reshape(B, *outs.shape[2:])
            if rank == n_stages - 1:
                l = head_loss_fn(params["head"], outs, tokens)
            else:
                l = torch.zeros((), dtype=torch.float32, device=x.device)
            return all_reduce(l, StreamComm((pipe_axis,), (STREAM_NULL,), mesh))[0]

        return shard_map(inner, mesh, in_specs=(P(), P()), out_specs=P())(params["stages"], batch["tokens"])

    return loss
