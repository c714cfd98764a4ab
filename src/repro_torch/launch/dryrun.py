"""Dry run: take every (arch × shape) cell on the production meshes on the
meta device and report memory per rank, cost and roofline terms on the
H100. No card is touched and nothing is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both --out build/dryrun.json

The port of ``repro.launch.dryrun``. Where the reference lowers and
compiles the SPMD program and reads XLA's memory analysis and HLO, a cell
here is counted:

* ``cost``: ``op_cost.step_cost`` of the GLOBAL step (the single-rank train
  step at the whole global batch, the prefill or the decode step) on meta
  tensors, divided by the chip count, the reference's convention;
* ``memory.argument_bytes``: exact, one rank's blocks under
  ``parallel/sharding``'s specs — params, the ZeRO-1 optimizer state at
  :func:`_opt_cfg`'s dtypes and the batch (train, prefill) or the cache
  and tokens (decode); ``output_bytes`` likewise for what the step returns;
* ``collectives`` and ``memory.temp_bytes``: the sharded step run once on
  the production mesh over meta blocks — the train step
  (``launch.train.make_train_step(dp=)``: every rank computes its share
  tensor-parallel over ``model``; the dp axes folded, so one rank per
  ``model`` index runs for the 16 it stands for, ``_sharded_train``), or
  the sharded prefill or decode step
  (``make_prefill_step``/``make_serve_step`` on params under
  ``param_specs`` and a cache under ``cache_specs``: tensor-parallel over
  ``model``, the decode sequence-parallel over the cache) — its
  thread-ranks' collectives counted at ``core/collectives``
  (``roofline.count_collectives``, the busiest rank) and the peak of live
  meta storage over the step divided by the ranks that ran (a train
  cell's over its 16 computing ranks: at least the unfolded count and
  nearer what a rank holds, ``_sharded_train``). ``--fold-check D,M`` holds
  a folded count against one on every rank of a small meta mesh
  (:func:`fold_check`).

Every family has a sharded train, prefill and decode step, under both
layout hints (``seq_shard_acts``, ``moe_dispatch_sharding``), so every
row is whole.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs import registry
from repro_torch.core.mesh import NamedSharding, P, device_put
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.op_cost import OpCounter, step_cost
from repro_torch.launch.train import (make_prefill_step, make_serve_step, make_train_step, named, rows_spec,
                                     train_shardings)
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding as shd

__all__ = ["lower_cell", "run_cells"]

def _opt_cfg(cfg) -> AdamWConfig:
    big = cfg.fsdp
    return AdamWConfig(
        moments_dtype="bfloat16" if big else "float32",
        master=not big,
    )


def _block_bytes(mesh, spec: P, t: torch.Tensor) -> int:
    """Bytes of mesh position 0's block of ``t`` under ``spec`` (the specs
    split every dim evenly, so every position's block is as large, and the
    dp ranks own equally many layers of a ``StackRow`` leaf)."""
    sharding = NamedSharding(mesh, spec)
    if not sharding.holds(0):
        return 0
    n = 1
    for s in sharding.index(0, t.shape):
        n *= s.stop - s.start
    return n * t.element_size()


def _tree_bytes(mesh, tree, specs) -> int:
    """One rank's bytes of a tree of tensors laid out by a matching tree of specs."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(mesh, v, specs[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(mesh, v, s) for v, s in zip(tree, specs))
    return _block_bytes(mesh, specs, tree)


def _sharded_train(cfg, opt_cfg, mesh, model, opt_abs, batch, pspecs, ospecs):
    """Run the sharded train step once on ``mesh`` over meta blocks:
    (per-chip collective stats, temp bytes per rank). On a mesh that folds
    its dp axes (``core.mesh.Mesh``) only the ranks at dp coordinate 0
    run, one per ``model`` index, the others mirrored, since every dp rank
    issues the same ops on blocks of the same shapes (its rows, its ZeRO-1
    chunk or layers): the collectives are the unfolded step's. The temp
    bytes are the region's peak of live bytes over the ranks that ran.
    That peak is what the ranks hold (activations, the remat recompute's,
    grads: each rank's own, so as many per rank folded or not) plus the
    transient of the one op running at a time (the ranks take turns, the
    backward is one pass on the caller's thread), which a count spreads
    over the ranks that ran: over 16 folded, 256 unfolded, where a real
    rank holds its own transient whole. So a folded count is at least the
    unfolded one and nearer what a rank holds: on ``("data", "model")``
    meta meshes of 2–16 × 2 (:func:`fold_check`, smoke configs) it read
    1.06–1.13 times the unfolded count."""
    step = make_train_step(cfg, opt_cfg, dp=shd.dp_axes(mesh))
    state = device_put({n: p.detach() for n, p in model.named_parameters()}, named(mesh, pspecs))
    opt = device_put(opt_abs, named(mesh, ospecs))
    ran = sum(1 for slot in range(mesh.size) if mesh.mirror(slot) == slot)
    with rl.count_collectives() as coll, OpCounter(track_memory=True) as mem:
        step(state, opt, batch)
    return coll.per_chip(), mem.peak_bytes // ran


def fold_check(arch: str, shape=(16, 2), axes=("data", "model"), smoke: bool = True) -> dict:
    """``arch × train_4k``'s sharded step on a meta mesh of ``shape`` named
    ``axes``, run on every rank and with the dp axes folded: per run its
    collectives, temp bytes per rank and seconds, for holding the folded
    count (:func:`_sharded_train`) against a fully counted mesh."""
    cfg = registry.get_config(arch, smoke=smoke)
    out = {}
    for name in ("unfolded", "folded"):
        mesh = make_host_mesh(shape, axes, device="meta")
        if name == "folded":
            mesh = make_host_mesh(shape, axes, device="meta", fold=shd.dp_axes(mesh))
        model, opt_cfg = api.abstract_params(cfg), _opt_cfg(cfg)
        batch = registry.input_specs(cfg, registry.get_shape("train_4k"))
        pspecs, ospecs, _, opt_abs = train_shardings(cfg, opt_cfg, mesh, model, batch)
        model.requires_grad_(True)
        t0 = time.perf_counter()
        coll, temp = _sharded_train(cfg, opt_cfg, mesh, model, opt_abs, batch, pspecs, ospecs)
        out[name] = dict(collectives={"summary": coll.summary(), **coll.per_op_bytes}, temp_bytes=temp,
                         seconds=round(time.perf_counter() - t0, 2))
    return out


def _sharded_serve(step, mesh, model, pspecs, *args):
    """Run a sharded serve step once on ``mesh`` over meta blocks (the
    params laid out by ``pspecs``, ``args`` already laid out): (per-chip
    collective stats, the region's peak live bytes per rank)."""
    state = device_put({n: p.detach() for n, p in model.named_parameters()}, named(mesh, pspecs))
    with rl.count_collectives() as coll, OpCounter(track_memory=True) as mem:
        step(state, *args)
    return coll.per_chip(), mem.peak_bytes // mesh.size


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True, cfg_transform=None,
               tag: str = ""):
    """Count one cell. Returns a result dict (JSON-safe) with the
    reference's keys (``compile_s`` and ``xla_cost_raw`` null: nothing is
    compiled) plus ``sharded_s``.
    ``cfg_transform(cfg) -> cfg`` applies hillclimb variants."""
    cfg = registry.get_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = registry.get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    t0 = time.perf_counter()

    model = api.abstract_params(cfg)
    pspecs = shd.param_specs(cfg, model, mesh)
    params = dict(model.named_parameters())
    if shape.mode == "train":
        opt_cfg = _opt_cfg(cfg)
        batch = registry.input_specs(cfg, shape)
        pspecs, ospecs, bspecs, opt_abs = train_shardings(cfg, opt_cfg, mesh, model, batch)
        args_bytes = _tree_bytes(mesh, params, pspecs) + _tree_bytes(mesh, batch, bspecs)
        opt_bytes = _tree_bytes(mesh, opt_abs, ospecs)
        args_bytes += opt_bytes
        out_bytes = _tree_bytes(mesh, params, pspecs) + opt_bytes
        model.requires_grad_(True)
        global_cost = step_cost(make_train_step(cfg, opt_cfg), model, opt_abs, batch)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        folded = make_production_mesh(multi_pod=multi_pod, fold=shd.dp_axes(mesh))
        run = lambda: _sharded_train(cfg, opt_cfg, folded, model, opt_abs, batch, pspecs, ospecs)  # noqa: E731
    elif shape.mode == "prefill":
        batch = registry.input_specs(cfg, shape)
        cache = api.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        args_bytes = _tree_bytes(mesh, params, pspecs) + _tree_bytes(mesh, batch, shd.batch_specs(cfg, batch, mesh))
        logits_bytes = shape.global_batch * cfg.vocab * 4
        out_bytes = logits_bytes + _tree_bytes(mesh, cache, shd.cache_specs(cfg, cache, mesh))
        global_cost = step_cost(make_prefill_step(cfg), model, batch)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = lambda: _sharded_serve(make_prefill_step(cfg), mesh, model, pspecs, batch)  # noqa: E731
    else:  # decode
        io = registry.input_specs(cfg, shape)
        cache = registry.decode_cache_specs(cfg, shape)
        cspecs = shd.cache_specs(cfg, cache, mesh)
        B = shape.global_batch
        tok = rows_spec(mesh, B)
        cache_bytes = _tree_bytes(mesh, cache, cspecs)
        args_bytes = (_tree_bytes(mesh, params, pspecs) + cache_bytes
                      + _tree_bytes(mesh, io, {"tokens": tok, "pos": tok}))
        out_bytes = B * cfg.vocab * 4 + cache_bytes
        global_cost = step_cost(make_serve_step(cfg), model, cache, io["tokens"], io["pos"])
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = lambda: _sharded_serve(make_serve_step(cfg), mesh, model, pspecs,  # noqa: E731
                                     device_put(cache, named(mesh, cspecs)), io["tokens"], io["pos"])
    coll, temp = run()
    t_sharded = time.perf_counter() - t0

    mflops = rl.model_step_flops(cfg, shape)
    cost = {"flops": global_cost.flops / n_chips, "bytes accessed": global_cost.bytes / n_chips}
    terms = rl.roofline_terms(cost, coll, n_chips, mflops)
    row = terms.row()

    result = {
        "arch": arch,
        "variant": tag or "baseline",
        "shape": shape_name,
        "mesh": [mesh.shape[a] for a in mesh.axis_names],
        "multi_pod": multi_pod,
        "n_chips": n_chips,
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "sharded_s": round(t_sharded, 2),
        "memory": {
            "argument_bytes": args_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "peak_bytes_per_device": args_bytes + temp,
        },
        "collectives": {"summary": coll.summary(), **coll.per_op_bytes},
        "roofline": row,
        "xla_cost_raw": {"flops": None, "bytes_accessed": None},
    }
    if verbose:
        m = result["memory"]
        print(
            f"[dryrun] {arch}{('['+tag+']') if tag else ''} × {shape_name} × "
            f"{'x'.join(str(n) for n in result['mesh'])}: count {t_lower:.1f}s sharded step {t_sharded:.1f}s"
        )
        print(f"  memory: args={_gb(m['argument_bytes'])} temps={_gb(m['temp_bytes'])} "
              f"peak/device={_gb(m['peak_bytes_per_device'])}")
        print(f"  cost: flops={terms.flops:.3e} bytes={terms.hbm_bytes:.3e}")
        print(f"  collectives: {coll.summary()}")
        print(
            f"  roofline: compute={rl.fmt_seconds(terms.t_compute)} memory={rl.fmt_seconds(terms.t_memory)} "
            f"collective={rl.fmt_seconds(terms.t_collective)} -> {terms.bottleneck}-bound; "
            f"useful={row['useful_ratio']:.3f} mfu_bound={row['mfu_bound']:.3f}"
        )
    return result


def _gb(x):
    return f"{x/2**30:.2f}GiB"


def run_cells(archs, shapes, pods, out_path=None, stop_on_error=False):
    results = []
    for arch in archs:
        cfg = registry.get_config(arch)
        valid = registry.applicable_shapes(cfg)
        for shape in shapes:
            if shape not in valid:
                print(f"[dryrun] SKIP {arch} × {shape} (arch-applicability constraint)")
                results.append({"arch": arch, "shape": shape, "skipped": True})
                continue
            for mp in pods:
                try:
                    results.append(lower_cell(arch, shape, multi_pod=mp))
                except Exception as e:
                    traceback.print_exc()
                    results.append(
                        {"arch": arch, "shape": shape, "multi_pod": mp, "error": repr(e)}
                    )
                    if stop_on_error:
                        raise
                if out_path:
                    with open(out_path, "w") as f:
                        json.dump(results, f, indent=1)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fold-check", default=None, metavar="D,M",
                    help="run --arch's smoke train_4k cell on a (D, M) ('data', 'model') meta mesh, on every rank "
                         "and folded, and print both counts")
    args = ap.parse_args()
    if args.out and os.path.basename(args.out).startswith("BENCH_"):
        ap.error("--out must not be a BENCH_*.json name: those are the JAX package's benchmark files")

    if args.fold_check:
        print(json.dumps(fold_check(args.arch, tuple(int(n) for n in args.fold_check.split(","))), indent=1))
        return
    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    archs = registry.list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = registry.list_shapes() if (args.all or not args.shape) else [args.shape]
    run_cells(archs, shapes, pods, args.out)


if __name__ == "__main__":
    main()
