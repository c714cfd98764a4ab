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
* ``collectives`` and ``memory.temp_bytes``: the sharded train step
  (``launch.train.make_train_step(dp=)``) run once on the production mesh
  over meta blocks, its thread-ranks' collectives counted at
  ``core/collectives`` (``roofline.count_collectives``, the busiest rank)
  and the peak of live meta storage over the step divided by the ranks
  (the ranks share one autograd graph, whose backward runs on the caller's
  thread, so a rank's share is the region's peak over its rank count).

Where the port has no sharded form — a train cell of a family the sharded
step refuses (``models.transformer.check_dense_only``, ROADMAP P11c), and
every prefill and decode cell (the port has no sharded serve step) —
``collectives`` and ``temp_bytes`` are null and the row says why; its cost
and compute and memory terms are still filled.
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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_cost import OpCounter, step_cost
from repro_torch.launch.train import make_prefill_step, make_serve_step, make_train_step, named, train_shardings
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding as shd

__all__ = ["lower_cell", "run_cells"]

#: why a serve cell has no collectives or temp bytes
NO_SHARDED_SERVE = "the port has no sharded serve step: prefill and decode run on one rank"


def _opt_cfg(cfg) -> AdamWConfig:
    big = cfg.fsdp
    return AdamWConfig(
        moments_dtype="bfloat16" if big else "float32",
        master=not big,
    )


def _block_bytes(mesh, spec: P, t: torch.Tensor) -> int:
    """Bytes of mesh position 0's block of ``t`` under ``spec`` (the specs
    split every dim evenly, so every position's block is as large)."""
    n = 1
    for s in NamedSharding(mesh, spec).index(0, t.shape):
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
    (per-chip collective stats, the region's peak live bytes per rank)."""
    step = make_train_step(cfg, opt_cfg, dp=shd.dp_axes(mesh))  # raises first for what it refuses
    state = device_put({n: p.detach() for n, p in model.named_parameters()}, named(mesh, pspecs))
    opt = device_put(opt_abs, named(mesh, ospecs))
    with rl.count_collectives() as coll, OpCounter(track_memory=True) as mem:
        step(state, opt, batch)
    return coll.per_chip(), mem.peak_bytes // mesh.size


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True, cfg_transform=None,
               tag: str = ""):
    """Count one cell. Returns a result dict (JSON-safe) with the
    reference's keys (``compile_s`` and ``xla_cost_raw`` null: nothing is
    compiled) plus ``sharded_s`` and, where a part is null, ``reason``.
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
    coll = temp = None
    reason = NO_SHARDED_SERVE
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
        try:
            coll, temp = _sharded_train(cfg, opt_cfg, mesh, model, opt_abs, batch, pspecs, ospecs)
            reason = None
        except NotImplementedError as e:  # a family or knob the sharded step refuses (ROADMAP P11c)
            reason = str(e)
    elif shape.mode == "prefill":
        batch = registry.input_specs(cfg, shape)
        cache = api.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
        args_bytes = _tree_bytes(mesh, params, pspecs) + _tree_bytes(mesh, batch, shd.batch_specs(cfg, batch, mesh))
        logits_bytes = shape.global_batch * cfg.vocab * 4
        out_bytes = logits_bytes + _tree_bytes(mesh, cache, shd.cache_specs(cfg, cache, mesh))
        global_cost = step_cost(make_prefill_step(cfg), model, batch)
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
    else:  # decode
        io = registry.input_specs(cfg, shape)
        cache = registry.decode_cache_specs(cfg, shape)
        cspecs = shd.cache_specs(cfg, cache, mesh)
        dp = shd.dp_axes(mesh)
        n_dp = 1
        for a in dp:
            n_dp *= mesh.shape[a]
        B = shape.global_batch
        tok = P(dp) if (B % n_dp == 0 and B >= n_dp) else P(None)
        cache_bytes = _tree_bytes(mesh, cache, cspecs)
        args_bytes = (_tree_bytes(mesh, params, pspecs) + cache_bytes
                      + _tree_bytes(mesh, io, {"tokens": tok, "pos": tok}))
        out_bytes = B * cfg.vocab * 4 + cache_bytes
        global_cost = step_cost(make_serve_step(cfg), model, cache, io["tokens"], io["pos"])
        t_lower = time.perf_counter() - t0
        t0 = time.perf_counter()
    t_sharded = time.perf_counter() - t0

    mflops = rl.model_step_flops(cfg, shape)
    cost = {"flops": global_cost.flops / n_chips, "bytes accessed": global_cost.bytes / n_chips}
    terms = rl.roofline_terms(cost, coll or rl.CollectiveStats(), n_chips, mflops)
    row = terms.row()
    if coll is None:
        row["t_collective_s"] = row["coll_bytes_per_chip"] = None

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
            "peak_bytes_per_device": None if temp is None else args_bytes + temp,
        },
        "collectives": None if coll is None else {"summary": coll.summary(), **coll.per_op_bytes},
        "roofline": row,
        "xla_cost_raw": {"flops": None, "bytes_accessed": None},
    }
    if reason is not None:
        result["reason"] = reason
    if verbose:
        m = result["memory"]
        print(
            f"[dryrun] {arch}{('['+tag+']') if tag else ''} × {shape_name} × "
            f"{'x'.join(str(n) for n in result['mesh'])}: count {t_lower:.1f}s sharded step {t_sharded:.1f}s"
        )
        print(f"  memory: args={_gb(m['argument_bytes'])} temps={_gb(m['temp_bytes'])} "
              f"peak/device={_gb(m['peak_bytes_per_device'])}")
        print(f"  cost: flops={terms.flops:.3e} bytes={terms.hbm_bytes:.3e}")
        print(f"  collectives: {'n/a' if coll is None else coll.summary()}")
        if reason:
            print(f"  null: {reason}")
        print(
            f"  roofline: compute={rl.fmt_seconds(terms.t_compute)} memory={rl.fmt_seconds(terms.t_memory)} "
            f"collective={'n/a' if coll is None else rl.fmt_seconds(terms.t_collective)} -> {terms.bottleneck}-bound; "
            f"useful={row['useful_ratio']:.3f} mfu_bound={row['mfu_bound']:.3f}"
        )
    return result


def _gb(x):
    return "n/a" if x is None else f"{x/2**30:.2f}GiB"


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
    args = ap.parse_args()
    if args.out and os.path.basename(args.out).startswith("BENCH_"):
        ap.error("--out must not be a BENCH_*.json name: those are the JAX package's benchmark files")

    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.multi_pod]
    archs = registry.list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = registry.list_shapes() if (args.all or not args.shape) else [args.shape]
    run_cells(archs, shapes, pods, args.out)


if __name__ == "__main__":
    main()
