"""Training entry point: the step functions and the fault-tolerant loop.

The port of ``repro.launch.train``. ``make_grad_step`` builds the
(model, batch) → (grads, loss) function with microbatch gradient
accumulation: each microbatch's grads come from ``torch.autograd.grad``
and are added into ``cfg.accum_dtype`` (fp32) buffers, then divided by the
accumulation factor, as the reference's ``lax.scan`` does — ``.grad``
would accumulate in the bf16 param dtype. With ``grad_accum == 1`` the
grads keep the param dtype, as in the reference.

With ``dp=`` (the mesh's data-parallel axes, ``sharding.dp_axes``) the
step functions take the sharded state that :func:`device_put` builds under
:func:`train_shardings`: params under ``param_specs``, moments under
``opt_state_specs``, each mesh position (a thread-rank) holding only its
blocks, and the batch split under ``batch_specs`` at step entry (each
accumulation microbatch is the reference's: rows ``i·B/accum ...``, split
over dp). Every position computes the loss of its dp group's rows
tensor-parallel over ``model`` (``models.api.tp_loss`` on ``models.tp``:
heads, hidden units, experts and vocab rows of its own blocks, the
cross-entropy vocab-parallel), as GSPMD partitions the reference's jitted
step; the ``model`` ranks of a group hold the same sums, and the sums and
counts are all-reduced over dp among the ranks of one ``model`` index into
the reference's global loss ``xent + aux + mtp_loss_weight · mtp``, read
from position 0. The MoE layers route over the whole microbatch
(``models.moe.GlobalRouting``), as the reference's ``moe_apply`` on the
global batch does. One backward from the caller routes the cotangents
through the collectives to every block, and a hook moves each block's grad
into its sum as soon as it is ready. The update is ZeRO-1: per leaf, the
block grads are summed over the replica axes the moment is not sharded
over (a ``reduce_scatter`` over the dp axes into the moment chunk, an
``all_reduce`` over the rest), AdamW runs on the chunk with the norm over
every chunk, and an ``all_gather`` over dp puts the chunk back into the
block. Where the reference puts the dp axes on the layer-stacking dim of a
moment (``parallel.sharding.opt_state_specs``: the layer count divides by
the dp size), layer ``l``'s moments live on dp rank ``l // (L / n_dp)``
only: its grad is reduced over dp to that rank, which runs AdamW on it,
and the updated layer is broadcast back over dp. Both steps take every
family of the zoo (the transformer with MoE, MLA with MTP and the VLM
prefix; RWKV-6 on its per-token route; Jamba; Whisper, whose batches carry
``enc_frames``) under every remat policy and both layout hints
(``seq_shard_acts``: Megatron's sequence parallelism on the transformer's
sublayer outputs; ``moe_dispatch_sharding``: the experts' slots laid
capacity over ``data``; ``models.tp``).

``make_prefill_step`` and ``make_serve_step`` take the single-rank model,
or the sharded params of ``device_put(params, named(mesh, param_specs))``
(and a cache under ``cache_specs``, :func:`shard_cache`): then each runs
as one region, the reference's jitted steps under those shardings, the
batch rows over the dp axes, every layer tensor-parallel over ``model``
and the decode attention sequence-parallel over the cache's
``T``-over-``model`` slots (``models.tp``, ``models.api.tp_prefill`` /
``tp_decode_step``), under the two layout hints as the train step; under
``moe_dispatch_sharding`` with the rows split over dp their MoE layers
take their slots from the count exchange over dp (``GlobalRouting``), so
each slot holds one token of one group.

``Trainer`` wires every substrate together the way the paper intends its
extensions to be used: data prefetch + async checkpoints + heartbeats are
generalized requests completed by ONE progress engine; the checkpoint
stream (a ``cudaStream_t`` MPIX stream on the card: the snapshot copies
run there) gets its own progress thread; failures trigger the elastic
re-mesh plan, a windowed reshard of the latest checkpoint and
restore-from-latest. The model is one ``nn.Module`` whose parameters the
trainer turns ``requires_grad`` on for; the optimizer updates it in place.

Run: PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 20
(on the card; ``--device cpu`` for the plain path).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import iovec_store as store
from repro_torch.checkpoint.manager import WRITE_TIMEOUT_S, CheckpointManager
from repro_torch.core.collectives import all_gather, all_reduce, broadcast, reduce, reduce_scatter
from repro_torch.core.mesh import (NamedSharding, P, ShardedTensor, StackRow, current_region, device_put,
                                   shard_map)
from repro_torch.core.progress import AutotunePolicy, ProgressEngine
from repro_torch.core.streams import StreamComm, stream_create, stream_free
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.models import api, tp
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.convert import state_tree
from repro_torch.models.moe import GlobalRouting, router_aux_from_sums
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding as shd

__all__ = ["make_grad_step", "make_train_step", "make_serve_step", "make_prefill_step", "named",
           "train_shardings", "shard_cache", "rows_spec", "Trainer"]


# ----------------------------------------------------------------------
# the sharded step
# ----------------------------------------------------------------------


def _mesh_of(params) -> object:
    meshes = {id(st.mesh): st.mesh for st in params.values()}
    if len(meshes) != 1 or not all(isinstance(st, ShardedTensor) for st in params.values()):
        raise ValueError("dp= takes params that device_put laid over one mesh")
    return next(iter(meshes.values()))


def _turns(mesh):
    """The sharded steps' ranks take turns on the card: they launch small
    ops, and eight threads launching at once each pay several times a lone
    thread's host time per op (``core.mesh.shard_map``); no rank blocks
    outside a collective. CPU ranks compute in their ops and run at once."""
    return True if any(d.type == "cuda" for d in mesh.devices) else None


def _check_dp(mesh, dp) -> None:
    if tuple(dp) != shd.dp_axes(mesh):
        raise ValueError(f"dp={tuple(dp)} but the params' mesh has dp axes {shd.dp_axes(mesh)}")


def _flat_sums(sums) -> torch.Tensor:
    """One rank's sums (``models.api.tp_loss``) as one fp32 vector:
    xent sum and count, MTP sum and count (zeros without MTP), then every
    MoE layer's router row."""
    xs, xc = sums["xent"]
    ms, mc = sums.get("mtp", (torch.zeros_like(xs), torch.zeros_like(xc)))
    return torch.cat([torch.stack([xs, xc, ms, mc]).float()] + sums.get("router", []))


def _loss_of_sums(cfg: ModelConfig, v: torch.Tensor):
    """The reference's loss ``xent + aux + mtp_loss_weight · mtp`` and its
    metrics from :func:`_flat_sums` summed over the dp groups; with MoE
    layers the metrics add ``moe_dropped``, each layer's choices past
    capacity."""
    xent = v[0] / torch.clamp(v[1], min=1.0)
    total, metrics = xent, {"xent": xent}
    if cfg.moe.enabled:
        rows = v[4:].view(-1, 2 * cfg.moe.n_experts + 2)
        metrics["aux"] = aux = router_aux_from_sums(cfg, rows)
        metrics["moe_dropped"] = rows[:, 2 * cfg.moe.n_experts]
        total = total + aux
    if cfg.mtp_depth:
        metrics["mtp"] = mtp = v[2] / torch.clamp(v[3], min=1.0)
        total = total + cfg.mtp_loss_weight * mtp
    return total, metrics


def _partial_grads(cfg: ModelConfig, params, batch):
    """Every position's grads of its own blocks (name → list per position),
    the loss and its metrics (``_loss_of_sums``; the mean over the
    microbatches, the dropped choices summed). A position's block grad
    holds the contributions of the loss terms its block reached; their sum
    over the block's replicas is the gradient."""
    mesh = _mesh_of(params)
    specs = {n: st.sharding.spec for n, st in params.items()}
    dp = shd.dp_axes(mesh)
    groups = StreamComm(dp, mesh=mesh)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    bspecs = shd.batch_specs(cfg, batch, mesh)
    keys = sorted(batch)
    leaves = [(n, slot, b) for n, st in params.items() for slot, b in enumerate(st.blocks)]
    for _, _, b in leaves:
        b.requires_grad_(True)

    def body(*parts):
        w = tp.RankWeights({n: st.blocks[current_region().slot] for n, st in params.items()}, specs, mesh)
        w.route = GlobalRouting(groups) if cfg.moe.enabled else None
        sums = api.tp_loss(cfg, w, dict(zip(keys, parts)))
        total, _ = all_reduce(_flat_sums(sums), groups)
        return _loss_of_sums(cfg, total)

    region = shard_map(body, mesh, tuple(bspecs[k] for k in keys), P(), turns=_turns(mesh))
    accum = max(1, cfg.grad_accum)
    B = batch[keys[0]].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} microbatches")
    adt = torch_dtype(cfg.accum_dtype) if accum > 1 else None
    sums = [None] * len(leaves)

    def take(j, b):
        """Move block ``j``'s grad into its sum as soon as the backward has
        it, so the blocks' grads never all exist beside the sums."""
        g, b.grad = b.grad, None
        if adt is None:
            sums[j] = g
        elif sums[j] is None:
            sums[j] = g.to(adt)
        else:
            sums[j].add_(g.to(adt))

    blocks = [b for _, _, b in leaves]
    hooks = [b.register_post_accumulate_grad_hook(functools.partial(take, j)) for j, b in enumerate(blocks)]
    loss_sum = 0.0
    metrics = {}
    try:
        for i in range(accum):
            rows = slice(i * B // accum, (i + 1) * B // accum)
            loss, m = region(*[batch[k][rows] for k in keys])
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach()
            torch.autograd.backward(loss, inputs=blocks)
            loss_sum = loss_sum + loss.detach()
    finally:
        for h in hooks:
            h.remove()
    out = {n: [None] * mesh.size for n in params}
    for (n, slot, b), g in zip(leaves, sums):
        if g is None:  # a block no loss term reached
            g = torch.zeros_like(b, dtype=adt or b.dtype)
        out[n][slot] = g.div_(accum) if accum > 1 else g  # the fp32 sums are the step's own
    return out, loss_sum / accum, {k: v if k == "moe_dropped" else v / accum for k, v in metrics.items()}


def _zero1_update(opt_cfg: AdamWConfig, params, opt_state, grads):
    """The ZeRO-1 update of the module docstring, in place; returns the
    metrics of mesh position 0. Consumes ``grads``: each block grad is
    dropped once reduced, so its memory goes as its chunk comes."""
    mesh = _mesh_of(params)
    dp = shd.dp_axes(mesh)
    everyone = StreamComm(tuple(mesh.axis_names), mesh=mesh)
    dp_comm = StreamComm(dp, mesh=mesh)
    metrics = [None] * mesh.size

    def plan(n):
        """(non-dp replica axes to all-reduce, dp axes to all-reduce, dim
        the moment shards over dp or None, the dp rank that owns the
        layer's moments or None)."""
        ps, ms = params[n].sharding.spec, opt_state["m"][n].sharding.spec
        replica = [a for a in mesh.axis_names if a not in ps.axes]
        if isinstance(ms, StackRow):
            if tuple(ms) != tuple(ps) or ms.stack != dp:
                raise ValueError(f"{n}: moment spec {ms} is not param spec {ps} held by one dp rank")
            return [a for a in replica if a not in dp], [], None, ms.holder(mesh)
        extra = [a for a in ms.axes if a not in ps.axes]
        dims = [d for d in range(len(ms)) if ms.dim_axes(d) != ps.dim_axes(d)]
        if extra and (tuple(extra) != dp or len(dims) != 1 or ps.dim_axes(dims[0])):
            raise ValueError(f"{n}: moment spec {ms} is not param spec {ps} with the dp axes on one more dim")
        k = dims[0] if extra else None
        return [a for a in replica if a not in dp], [] if extra else [a for a in replica if a in dp], k, None

    plans = {n: plan(n) for n in params}

    def body():
        slot = current_region().slot
        coords = mesh.coords(slot)
        me = dp_comm.rank()
        g_chunks, sq = {}, None
        for n, (rest, dp_rep, k, owner) in plans.items():
            g, grads[n][slot] = grads[n][slot], None
            if rest:
                g, _ = all_reduce(g, StreamComm(tuple(rest), mesh=mesh))
            if owner is not None:
                g, _ = reduce(g, dp_comm, root=owner)
                if owner != me:
                    continue
            elif k is not None:
                g, _ = reduce_scatter(g, dp_comm, axis=k)
            elif dp_rep:
                g, _ = all_reduce(g, StreamComm(tuple(dp_rep), mesh=mesh))
            g_chunks[n] = g
            ms = opt_state["m"][n].sharding.spec
            first = all(coords[a] == 0 for a in mesh.axis_names if a not in ms.axes + (dp if owner is not None else ()))
            s = torch.sum(torch.square(g.to(torch.float32))) * (1.0 if first else 0.0)
            sq = s if sq is None else sq + s
        if sq is None:  # a rank that owns no moment of any leaf
            sq = torch.zeros((), dtype=torch.float32, device=mesh.devices[slot])
        total, _ = all_reduce(sq, everyone)
        gnorm = torch.sqrt(total)
        state = {key: {n: opt_state[key][n].blocks[slot] for n in g_chunks} for key in ("m", "v", "master")
                 if key in opt_state}
        state["count"] = opt_state["count"].blocks[slot]
        ps = {}
        for n in g_chunks:
            block, k = params[n].blocks[slot], plans[n][2]
            if k is None:
                ps[n] = block
            else:  # the block's chunk, updated apart from the block (its peers read the block meanwhile)
                c = g_chunks[n].shape[k]
                ps[n] = block.detach().narrow(k, me * c, c).clone()
        _, _, om = adamw_update(opt_cfg, g_chunks, state, ps, gnorm=gnorm)
        for n, (_, _, k, owner) in plans.items():
            block = params[n].blocks[slot]
            if owner is not None:
                full, _ = broadcast(block, dp_comm, root=owner)  # every rank passes its buffer, as MPI_Bcast
                if owner != me:
                    block.copy_(full)
            elif k is not None:
                full, _ = all_gather(ps[n], dp_comm, axis=k)
                block.copy_(full)
        metrics[slot] = om

    with torch.no_grad():
        shard_map(body, mesh, (), P(), turns=_turns(mesh))()
    return metrics[0]


def make_grad_step(cfg: ModelConfig, dp: tuple = ()):
    """The backward half of the train step: (model, batch) → (grads, loss),
    grads a dict keyed like ``model.named_parameters()``, with the
    microbatch accumulation described in the module docstring.

    With ``dp=`` the step takes the sharded params (name → ShardedTensor,
    from :func:`device_put`) in place of the model and returns the grads
    laid out as the params, summed over every block's replicas."""
    if dp:
        def sharded_grad_step(params, batch):
            mesh = _mesh_of(params)
            _check_dp(mesh, dp)
            partial, loss, _ = _partial_grads(cfg, params, batch)
            res = {n: [None] * mesh.size for n in params}

            def body():
                slot = current_region().slot
                for n, st in params.items():
                    replica = tuple(a for a in mesh.axis_names if a not in st.sharding.spec.axes)
                    g = partial[n][slot]
                    res[n][slot] = all_reduce(g, StreamComm(replica, mesh=mesh))[0] if replica else g

            with torch.no_grad():
                shard_map(body, mesh, (), P(), turns=_turns(mesh))()
            return {n: ShardedTensor(st.shape, st.sharding, res[n]) for n, st in params.items()}, loss

        return sharded_grad_step

    def grad_step(model, batch):
        live = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        names, ps = [n for n, _ in live], [p for _, p in live]
        accum = cfg.grad_accum
        if accum <= 1:
            loss, _metrics = api.loss_fn(cfg, model, batch)
            grads = torch.autograd.grad(loss, ps)
            return dict(zip(names, grads)), loss.detach()
        adt = torch_dtype(cfg.accum_dtype)
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:]) for k, v in batch.items()}
        gsum = {n: torch.zeros(p.shape, dtype=adt, device=p.device) for n, p in live}
        lsum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
        for i in range(accum):
            loss, _metrics = api.loss_fn(cfg, model, {k: v[i] for k, v in micro.items()})
            for n, g in zip(names, torch.autograd.grad(loss, ps)):
                gsum[n].add_(g.to(adt))
            lsum = lsum + loss.detach()
        return {n: g / accum for n, g in gsum.items()}, lsum / accum

    return grad_step


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, dp: tuple = ()):
    """(model, opt_state, batch) → (model, opt_state, metrics): the grad
    step followed by the in-place AdamW update. With ``dp=`` it takes the
    sharded params and optimizer state of :func:`train_shardings` (the
    module docstring) and updates them in place, ZeRO-1; its metrics add
    the loss's parts (``_loss_of_sums``: ``xent``, and ``aux``,
    ``moe_dropped``, ``mtp`` where the config has them)."""
    if dp:
        def sharded_train_step(params, opt_state, batch):
            mesh = _mesh_of(params)
            _check_dp(mesh, dp)
            grads, loss, metrics = _partial_grads(cfg, params, batch)
            om = _zero1_update(opt_cfg, params, opt_state, grads)
            return params, opt_state, {"loss": loss, **metrics, **om}

        return sharded_train_step
    grad_step = make_grad_step(cfg)

    def train_step(model, opt_state, batch):
        grads, loss = grad_step(model, batch)
        _, new_state, om = adamw_update(opt_cfg, grads, opt_state, dict(model.named_parameters()))
        return model, new_state, {"loss": loss, **om}

    return train_step


# ----------------------------------------------------------------------
# the serve steps, single-rank and sharded
# ----------------------------------------------------------------------


def _is_sharded(params) -> bool:
    return isinstance(params, dict) and bool(params) and all(isinstance(v, ShardedTensor) for v in params.values())


def rows_spec(mesh, B: int) -> P:
    """The batch rows' spec: over the dp axes where they divide the rows
    (``cache_specs``' rule for the cache's batch dim), else replicated."""
    dp = shd.dp_axes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= mesh.shape[a]
    return P(dp) if dp and B % n_dp == 0 and B >= n_dp else P()


def _tree_map(fn, tree):
    """``fn`` over a cache tree's leaves (dicts in key order, lists, tuples; a P is a leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _serve_weights(cfg: ModelConfig, params, specs, mesh, rows: P):
    """The rank's ``models.tp.RankWeights`` in a sharded serve step: under
    ``moe_dispatch_sharding``, with the rows split over dp, the MoE layers
    route over the dp groups (their slots global, the capacity laid over
    ``data``); otherwise each group routes its rows alone (dropless)."""
    w = tp.RankWeights({n: st.blocks[current_region().slot] for n, st in params.items()}, specs, mesh)
    if cfg.moe.enabled and cfg.moe_dispatch_sharding and rows.axes:
        w.route = GlobalRouting(StreamComm(shd.dp_axes(mesh), mesh=mesh))
    return w


def _sharded_prefill(cfg: ModelConfig, params, batch, max_len=None):
    """The sharded prefill (``make_prefill_step``'s docstring): one region
    over the params' mesh, each rank running ``models.api.tp_prefill`` on
    its rows; (logits (B, vocab), the cache as ShardedTensors under
    ``cache_specs``)."""
    mesh = _mesh_of(params)
    specs = {n: st.sharding.spec for n, st in params.items()}
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    keys = sorted(batch)
    B, S = batch["tokens"].shape
    if cfg.vlm and "img_embeds" in batch:
        S += batch["img_embeds"].shape[1]
    T = max_len or S
    cache_abs = api.init_cache(cfg, B, T, device="meta")
    cspecs = shd.cache_specs(cfg, cache_abs, mesh)
    rows = rows_spec(mesh, B)
    blocks = [None] * mesh.size

    def body(*parts):
        slot = current_region().slot
        w = _serve_weights(cfg, params, specs, mesh, rows)
        logits, blocks[slot] = api.tp_prefill(cfg, w, dict(zip(keys, parts)), T, cspecs)
        return logits

    with torch.no_grad():
        logits = shard_map(body, mesh, (rows,) * len(keys), rows, turns=_turns(mesh))(*[batch[k] for k in keys])
    per_slot = [_leaves(b) for b in blocks]
    flat = [ShardedTensor(a.shape, NamedSharding(mesh, s), [per_slot[slot][i] for slot in range(mesh.size)])
            for i, (a, s) in enumerate(zip(_leaves(cache_abs), _leaves(cspecs)))]
    it = iter(flat)
    return logits, _tree_map(lambda _: next(it), cache_abs)


def _sharded_decode(cfg: ModelConfig, params, cache, tokens, pos):
    """The sharded decode step (``make_serve_step``'s docstring): one region,
    each rank running ``models.api.tp_decode_step`` on its rows and writing
    its cache blocks in place; (logits (B, vocab), ``cache``)."""
    mesh = _mesh_of(params)
    leaves = _leaves(cache)
    if not all(isinstance(c, ShardedTensor) and c.mesh is mesh for c in leaves):
        raise ValueError("the sharded decode step takes a cache that device_put laid over the params' mesh")
    specs = {n: st.sharding.spec for n, st in params.items()}
    tokens, pos = torch.as_tensor(tokens), torch.as_tensor(pos)
    rows = rows_spec(mesh, tokens.shape[0])
    if any(c.sharding.spec.dim_axes(1) != rows.dim_axes(0) for c in leaves):
        raise ValueError(f"the cache's batch dim is not laid out as the rows' {rows}: {leaves[0].sharding.spec}")

    def body(tok, p):
        return api.tp_decode_step(cfg, _serve_weights(cfg, params, specs, mesh, rows), cache, tok, p)

    with torch.no_grad():
        logits = shard_map(body, mesh, (rows, rows), rows, turns=_turns(mesh))(tokens, pos)
    return logits, cache


def make_serve_step(cfg: ModelConfig):
    """(params, cache, tokens, pos) → (logits, cache): one decode step,
    ``models.api.decode_step``. Given the sharded params of
    ``device_put(params, named(mesh, param_specs))`` and the cache of
    ``device_put(cache, named(mesh, cache_specs))`` (:func:`shard_cache`)
    it runs as one region over the mesh, the reference's jitted step under
    those shardings: the batch rows split over the dp axes (``tokens`` and
    ``pos`` under ``P(dp)``), the layers tensor-parallel over ``model`` and
    the attention sequence-parallel over the cache's ``T``-over-``model``
    slots (``models.tp``); the logits come back whole (the reference's
    ``out_shardings=None``) and the cache blocks are written in place."""
    def serve_step(params, cache, tokens, pos):
        if _is_sharded(params):
            return _sharded_decode(cfg, params, cache, tokens, pos)
        return api.decode_step(cfg, params, cache, tokens, pos)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch[, max_len]) → (last logits, cache): ``models.api.prefill``.
    Given sharded params (as :func:`make_serve_step`) it runs as one region
    over their mesh: each rank prefills its dp rows on its heads (the flash
    kernel per rank where ``attn_impl="flash"``), and the cache comes back
    as ``ShardedTensor`` s under ``cache_specs``, each K/V moved from the
    rank's heads into its ``T`` span by one all-to-all over ``model``."""
    def prefill_step(params, batch, max_len=None):
        if _is_sharded(params):
            return _sharded_prefill(cfg, params, batch, max_len)
        return api.prefill(cfg, params, batch, max_len)

    return prefill_step


# ----------------------------------------------------------------------
# sharded-step construction helpers
# ----------------------------------------------------------------------


def named(mesh, specs):
    """The :class:`NamedSharding` tree of ``specs`` (a tree of P) on ``mesh``."""
    if isinstance(specs, P):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named(mesh, v) for k, v in specs.items()}
    return type(specs)(named(mesh, v) for v in specs)


def shard_cache(cfg: ModelConfig, mesh, B: int, max_len: int, device=None):
    """A fresh (zero) decode cache laid over ``mesh`` under ``cache_specs``:
    ``device_put(api.init_cache(...), named(mesh, cache_specs))``, on the
    mesh's devices."""
    cache = api.init_cache(cfg, B, max_len, device=device or mesh.devices[0])
    return device_put(cache, named(mesh, shd.cache_specs(cfg, cache, mesh)))


def train_shardings(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, model, batch):
    """``(pspecs, ospecs, bspecs, opt_abs)`` for ``model``'s parameters
    (a ``torch.device("meta")`` model gives full-width specs), the AdamW
    state and ``batch``; ``opt_abs`` is the state built on ``model``'s
    device."""
    params = dict(model.named_parameters())
    pspecs = shd.param_specs(cfg, model, mesh)
    opt_abs = adamw_init(opt_cfg, params)
    ospec = shd.opt_state_specs(cfg, pspecs, model, mesh)
    ospecs = {"m": ospec, "v": ospec, "count": P()}
    if opt_cfg.master:
        ospecs["master"] = ospec
    bspecs = shd.batch_specs(cfg, batch, mesh)
    return pspecs, ospecs, bspecs, opt_abs


# ----------------------------------------------------------------------
# fault-tolerant training loop
# ----------------------------------------------------------------------


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        data_cfg: DataConfig,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 50,
        ckpt_keep: int = 3,
        seed: int = 0,
        autotune: bool = True,
        autotune_policy: Optional[AutotunePolicy] = None,
        mesh_shape=(2, 16, 16),
        mesh_axes=("pod", "data", "model"),
        ranks=(0,),
        hb_timeout: float = 3600.0,
        hb_clock=None,
        hb_tick: float = 0.0,
        fault_injector=None,
        grad_overlap: str = "jit",
        grad_bucket_bytes: int = 1 << 16,
        grad_comms: int = 2,
        grad_window_depth: int = 2,
        device="cuda",
    ):
        self.cfg, self.opt_cfg, self.data_cfg = cfg, opt_cfg, data_cfg
        self.device = resolve_device(device)
        self.engine = ProgressEngine()
        # progress placement: the stats()-driven autotuner promotes the
        # streams that are actually hot (ckpt during save bursts, data
        # during prefetch) and demotes them between bursts; autotune=False
        # keeps the static hand placement for comparison
        self.autotune = autotune
        if autotune and autotune_policy is None:
            autotune_policy = AutotunePolicy(tune_spin=True)
        self.tuner = self.engine.autotune(autotune_policy) if autotune else None
        # the checkpoint stream binds a CUDA stream: the snapshot copies run
        # there, beside the training stream
        self.ckpt_stream = stream_create(info={"type": "cudaStream_t"}, name="ckpt")
        self.data_stream = stream_create(name="data")
        self._streams = [self.ckpt_stream, self.data_stream]
        self.pipeline = SyntheticPipeline(cfg, data_cfg, self.engine, self.data_stream)
        # the snapshots live in pinned host memory the manager keeps: at most
        # two saves in flight, so at most two snapshot buffers
        self.ckpt = (
            CheckpointManager(ckpt_dir, self.engine, self.ckpt_stream, keep=ckpt_keep, max_inflight=2)
            if ckpt_dir
            else None
        )
        self.ckpt_every = ckpt_every
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = api.init_params(cfg, gen, self.device)
        self.params.requires_grad_(True)
        self._named = dict(self.params.named_parameters())
        self.opt_state = adamw_init(opt_cfg, self._named)
        self._grad_fn = make_grad_step(cfg)
        # grad_overlap="windowed" drives the real backward through the
        # backward-overlapped bucketed allreduce: grad step → flatten →
        # bucketed_all_reduce_host(window=) with per-bucket RS admitted as
        # buckets are issued and AGs reaped in completion order → unflatten
        # → AdamW. Byte-identical to the fused "jit" step on the 1-rank
        # data axis (RS∘AG is the identity there; flatten→unflatten exact).
        if grad_overlap not in ("jit", "windowed"):
            raise ValueError(
                f"grad_overlap must be 'jit' or 'windowed', got {grad_overlap!r}"
            )
        self.grad_overlap = grad_overlap
        if grad_overlap == "windowed":
            from repro_torch.core.enqueue import OffloadWindow
            from repro_torch.core.mesh import make_mesh
            from repro_torch.core.streams import stream_comm_create
            from repro_torch.optim.grad_overlap import build_buckets

            mesh = make_mesh((1,), ("data",), device=self.device)
            grad_streams = [stream_create(name=f"grad{i}") for i in range(max(1, grad_comms))]
            win_stream = stream_create(name="grad-win")
            self._streams += grad_streams + [win_stream]
            self._grad_comms = [stream_comm_create(mesh, ("data",), s) for s in grad_streams]
            self._grad_window = OffloadWindow(
                win_stream,
                depth=grad_window_depth,
                engine=self.engine,
                name="grad-win",
            )
            self._grad_plan = build_buckets(list(self._named.values()), bucket_bytes=grad_bucket_bytes)
        self.start_step = 0
        # elastic state: the mesh the run believes in, the monitored rank
        # set, and the detect → replan → reshard → resume machinery. The
        # heartbeat's on_failure fires on the detector's polling thread,
        # so it only *notes* the failure; the training loop consumes the
        # note at the next step boundary (recover() rebuilds state there).
        self.mesh_shape = tuple(mesh_shape)
        self.mesh_axes = tuple(mesh_axes)
        self.mesh_plan = None
        self.ranks = list(ranks)
        self.fault_injector = fault_injector
        self._failure_lock = threading.Lock()
        self._pending_failures: list = []
        self.recoveries: list = []
        self.straggler = StragglerMonitor(ranks=self.ranks)
        # straggler mitigation is enacted, not just logged: run() feeds
        # advice through rebalance_shares into the pipeline's weighted
        # prefetch split (see _apply_straggler_advice)
        self.microbatch_total = max(len(self.ranks), int(getattr(cfg, "grad_accum", 1) or 1))
        self.microbatch_shares: Dict[int, int] = {}
        # named communication schedules riding this run: recover()
        # invalidates and re-records them on the new membership
        self.schedules: Dict[str, dict] = {}
        # hb_clock + hb_tick: a virtual clock the loop advances by hb_tick
        # per step makes detection latency a deterministic step count
        self.hb_clock = hb_clock
        self.hb_tick = hb_tick
        hb_kwargs = {} if hb_clock is None else {"clock": hb_clock}
        self.heartbeat = HeartbeatMonitor(
            ranks=self.ranks,
            timeout=hb_timeout,
            engine=self.engine,
            on_failure=self._note_failure,
            **hb_kwargs,
        )
        self.history = []
        self.step_seconds = []
        self.last_progress_stats: Optional[dict] = None

    # -- state ----------------------------------------------------------------
    def state_tree(self) -> dict:
        """The checkpointed state as the reference's tree over the live
        tensors: ``{"params": ..., "opt": {"m", "v", "master", "count"}}``."""
        opt = {k: state_tree(self.cfg, self.params, self.opt_state[k]) for k in ("m", "v", "master")
               if k in self.opt_state}
        opt["count"] = self.opt_state["count"]
        return {"params": state_tree(self.cfg, self.params, self._named), "opt": opt}

    def maybe_restore(self):
        if self.ckpt is None:
            return
        try:
            (state, step) = self.ckpt.restore_latest(self.state_tree())
        except FileNotFoundError:
            return
        self.ckpt.wait_snapshots()  # the copies below write saved tensors in place
        with torch.no_grad():
            for dst, src in zip(store.tree_tensors(self.state_tree()), store.tree_tensors(state)):
                dst.copy_(src)
        self.start_step = step + 1
        print(f"[trainer] restored step {step}")

    # -- fault-tolerance path ------------------------------------------------
    def handle_failure(self, failed_ranks, mesh_shape=(2, 16, 16), axes=("pod", "data", "model")):
        """Elastic recovery: plan a shrunken mesh (DP axes only) and roll
        back to the latest complete checkpoint. Returns the MeshPlan."""
        from repro_torch.ft.elastic import plan_remesh

        plan = plan_remesh(mesh_shape, axes, n_failed=len(failed_ranks))
        print(f"[trainer] failure of ranks {failed_ranks}: re-mesh -> {plan.shape} {plan.dropped}")
        self.maybe_restore()
        return plan

    def _note_failure(self, failed_ranks) -> None:
        """HeartbeatMonitor.on_failure target — runs on whichever thread
        drove the detector poll, so it must not touch the model; the
        training loop picks the note up at its next step boundary."""
        with self._failure_lock:
            self._pending_failures.extend(failed_ranks)

    def pending_failures(self) -> list:
        with self._failure_lock:
            return list(self._pending_failures)

    def _take_failures(self) -> list:
        with self._failure_lock:
            out, self._pending_failures = self._pending_failures, []
        return sorted(set(out))

    # -- straggler mitigation ------------------------------------------------
    def _apply_straggler_advice(self, advice) -> None:
        """Enact 'rebalance' advice: recompute inverse-speed microbatch
        shares and push them into the live pipeline's weighted prefetch
        split. Loader rank w serves mesh rank ``ranks[(w-1) % n]``."""
        if not any(a.action == "rebalance" for a in advice):
            return
        shares = self.straggler.rebalance_shares(self.microbatch_total)
        if not shares:
            return
        self.microbatch_shares = shares
        if self.pipeline.threadcomm is not None and self.ranks:
            weights = {
                w + 1: float(shares.get(self.ranks[w % len(self.ranks)], 1))
                for w in range(self.pipeline.n_workers)
            }
            self.pipeline.set_shares(weights)

    # -- recorded schedules across remesh ------------------------------------
    def register_schedule(self, name: str, schedule, record_fn: Callable) -> None:
        """Track a recorded communication schedule whose graph depends on
        the current membership. ``record_fn(schedule)`` must (re-)record it
        against the trainer's current mesh; recover() invalidates the
        schedule and calls it after every remesh."""
        self.schedules[name] = {"schedule": schedule, "record": record_fn, "rerecords": 0}

    def _rerecord_schedules(self, plan) -> list:
        done = []
        for name, ent in self.schedules.items():
            sch = ent["schedule"]
            if sch is not None and not getattr(sch, "recording", False):
                sch.invalidate(f"membership changed: re-mesh -> {plan.shape}")
            ent["record"](sch)
            ent["rerecords"] += 1
            done.append(name)
        return done

    def recover(self, failed_ranks, reshard_depth: int = 4):
        """The end-to-end elastic path: drop the dead ranks from the
        monitors, plan the shrunken mesh, stream the latest checkpoint's
        largest leaf through a depth-bounded reshard window onto the new
        data-parallel grid, and reload live state from the same files.
        Returns the MeshPlan; the reshard bytes + window stats land in
        ``self.recoveries[-1]``."""
        from repro_torch.ft.elastic import plan_remesh

        failed_ranks = sorted(set(failed_ranks))
        plan = plan_remesh(self.mesh_shape, self.mesh_axes, n_failed=len(failed_ranks))
        print(
            f"[trainer] failure of ranks {failed_ranks}: re-mesh "
            f"{self.mesh_shape} -> {plan.shape} {plan.dropped}"
        )
        for r in failed_ranks:
            self.straggler.drop_rank(r)
            self.heartbeat.remove_rank(r)
            if r in self.ranks:
                self.ranks.remove(r)
        # survivors keep fresh straggler slates on the new mesh
        for r in self.ranks:
            self.straggler.add_rank(r)
        shards, win_stats = None, None
        if self.ckpt is not None:
            # saves are async: settle them so "latest available step" is a
            # deterministic fact of the run, not of save-thread timing
            self._settle_saves()
        ckpt_step = None
        if self.ckpt is not None and self.ckpt.available_steps():
            ckpt_step = self.ckpt.available_steps()[-1]
            ckpt_dir = self.ckpt._dir_for(ckpt_step)
            shards, win_stats = self._reshard_checkpoint(ckpt_dir, plan, depth=reshard_depth)
            self.maybe_restore()
        self.mesh_shape = plan.shape
        self.mesh_plan = plan
        rerecorded = self._rerecord_schedules(plan)
        self.recoveries.append(
            {
                "failed": failed_ranks,
                "plan": plan,
                "ckpt_step": ckpt_step,
                "shards": shards,
                "reshard_stats": win_stats,
                "schedules_rerecorded": rerecorded,
            }
        )
        return plan

    def _reshard_checkpoint(self, ckpt_dir: str, plan, depth: int = 4):
        """Windowed reshard of the checkpoint's largest leaf against the
        new mesh's DP degree: the iovec store addresses the GLOBAL array,
        so the new shards are just different coalesced subarray reads
        over the same .bin files."""
        from repro_torch.ft.elastic import execute_reshard, reshard_plan

        with open(store.manifest_path(ckpt_dir)) as f:
            manifest = json.load(f)
        name, meta = max(
            manifest["leaves"].items(),
            key=lambda kv: int(np.prod(kv[1]["shape"] or [1])),
        )
        shape = tuple(meta["shape"]) or (1,)
        itemsize = np.dtype(meta["dtype"] if meta["dtype"] != "bfloat16" else "uint16").itemsize
        # DP degree on the new mesh, clipped to the largest divisor of the
        # leaf's leading dim (a grid must block-partition the array)
        dp = 1
        for ax in ("pod", "data"):
            if ax in plan.axis_names:
                dp *= plan.shape[plan.axis_names.index(ax)]
        g = max(d for d in range(1, min(dp, shape[0]) + 1) if shape[0] % d == 0)
        grid = (g,) + (1,) * (len(shape) - 1)
        plans = reshard_plan(shape, grid, itemsize)
        path = os.path.join(ckpt_dir, meta["file"])

        def read_run(iov):
            with open(path, "rb") as fh:
                fh.seek(iov.offset)
                return fh.read(iov.length)

        shards, stats = execute_reshard(
            plans, read_run, depth=depth, engine=self.engine, stream=self.ckpt_stream
        )
        return {"leaf": name, "grid": grid, "shards": shards}, stats

    # -- one step -------------------------------------------------------------
    def _update(self, grads, loss) -> Dict:
        """The in-place AdamW update, after the copies of the last save's
        snapshot: until here they ran beside this step's grad step."""
        if self.ckpt is not None:
            self.ckpt.wait_snapshots()
        _, self.opt_state, om = adamw_update(self.opt_cfg, grads, self.opt_state, self._named)
        return {"loss": loss, **om}

    def _windowed_step(self, batch) -> Dict:
        """One step on the windowed grad path: backward → flatten →
        per-bucket reduce-scatter admitted through the OffloadWindow
        (allgathers reaped in completion order) → unflatten → AdamW. The
        buckets' collectives are ordered after the backward's work on the
        current stream, so they need no materialize hook."""
        from repro_torch.optim.grad_overlap import (
            bucketed_all_reduce_host,
            flatten_grads,
            unflatten_grads,
        )

        grads, loss = self._grad_fn(self.params, batch)
        flat = flatten_grads(grads)
        reduced = bucketed_all_reduce_host(
            flat,
            self._grad_plan,
            self._grad_comms,
            engine=self.engine,
            window=self._grad_window,
        )
        return self._update(unflatten_grads(reduced, grads), loss)

    def step(self, batch) -> Dict:
        """One training step on ``batch`` (numpy or tensors) with the
        configured grad path; returns the metrics (tensors)."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        for k in ("img_embeds", "enc_frames"):
            if k in batch:
                batch[k] = batch[k].to(self.cfg.cdtype)
        if self.grad_overlap == "windowed":
            return self._windowed_step(batch)
        return self._update(*self._grad_fn(self.params, batch))

    def _settle_saves(self) -> None:
        if not self.ckpt.wait_for_pending(WRITE_TIMEOUT_S):
            raise TimeoutError(f"checkpoint writes not complete after {WRITE_TIMEOUT_S} s")

    def run(self, steps: int, log_every: int = 10):
        # background progress only where async work is actually in flight —
        # the paper's control knob (ext. 6), driven by stats() through the
        # autotuner; autotune=False keeps static placement on the two streams
        if self.tuner is not None:
            self.tuner.start()
        else:
            self.engine.start_progress_thread(self.ckpt_stream, interval=0.01)
            self.engine.start_progress_thread(self.data_stream, interval=0.0)
        # loader ranks are per-run epochs: re-open the threadcomm bracket
        # if a previous run() closed it
        if self.data_cfg.loader_threads > 0 and self.pipeline.threadcomm is None:
            self.pipeline.start_workers(self.data_cfg.loader_threads)
        try:
            self.pipeline.prefetch(self.start_step)
            for step in range(self.start_step, self.start_step + steps):
                # detect → replan → reshard → resume at the step boundary
                failed = self._take_failures()
                if failed:
                    self.recover(failed)
                t0 = time.perf_counter()
                self.pipeline.prefetch(step + 1)
                metrics = self.step(self.pipeline.get_batch(step))
                loss = float(metrics["loss"])  # waits for the step's device work
                dt_step = time.perf_counter() - t0
                self.step_seconds.append(dt_step)
                durations = {}
                for r in list(self.ranks):
                    d = dt_step
                    if self.fault_injector is not None:
                        # straggle faults report extra step seconds
                        d += self.fault_injector.stage_delay(r)
                    durations[r] = d
                self.straggler.record_step(durations)
                advice = self.straggler.check()
                if advice:
                    self._apply_straggler_advice(advice)
                for r in list(self.ranks):
                    self.heartbeat.record(r)
                if self.hb_clock is not None and self.hb_tick > 0:
                    self.hb_clock.advance(self.hb_tick)
                # one synchronous detector visit per step
                self.heartbeat.check()
                self.history.append(loss)
                if step % log_every == 0:
                    print(f"[trainer] step {step} loss {loss:.4f} ({dt_step*1e3:.0f} ms)")
                if self.ckpt and step > 0 and step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, self.state_tree())
            if self.ckpt:
                final = self.start_step + steps - 1
                self.ckpt.save_async(final, self.state_tree())
                self._settle_saves()
        finally:
            # progress threads and loader ranks are per-run; the heartbeat
            # request stays live until close()
            self.pipeline.stop_workers()
            if self.tuner is not None:
                self.tuner.stop()
            self.engine.stop_all()
            st = self.engine.stats()
            self.last_progress_stats = st
            print(
                f"[trainer] progress engine: {st['completions']} completions, "
                f"{st['polls']} polls, {st['lock_waits']} lock waits, "
                f"{st['parks']} parks / {st['wakes']} wakes "
                f"({st['spin_hits']} spin hits)"
            )
            if self.tuner is not None:
                ts = self.tuner.stats()
                print(
                    f"[trainer] autotuner: {ts['ticks']} ticks, "
                    f"{ts['promotions']} promotions / {ts['demotions']} demotions, "
                    f"spin_s {ts['spin_s']*1e6:.0f}us "
                    f"({ts['spin_grows']} grows / {ts['spin_shrinks']} shrinks)"
                )
        return self.history

    def close(self) -> None:
        """Release what the trainer holds beyond a run: the heartbeat
        detector, the progress threads and its MPIX streams' channels."""
        self.heartbeat.stop()
        self.engine.stop_all()
        for s in self._streams:
            stream_free(s)
        self._streams = []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config

    cfg = get_config(args.arch, smoke=args.smoke)
    tr = Trainer(
        cfg,
        AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps),
        DataConfig(batch=args.batch, seq=args.seq),
        ckpt_dir=args.ckpt_dir,
        device=args.device,
    )
    try:
        tr.maybe_restore()
        hist = tr.run(args.steps)
    finally:
        tr.close()
    print(f"[trainer] loss {hist[0]:.4f} -> {hist[-1]:.4f}")
    return hist


if __name__ == "__main__":
    main()
