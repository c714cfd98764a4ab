"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell, its configuration and its traffic are the files that
``BENCHMARK.json`` and ``portbench/workloads/<cell>.json`` name. With
``--trace 0`` the result's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a device trace of part of the
window and from the benchmark's spans and the program's counters.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` (traced runs) and, last, ``check``:
every number compared beside its limit, which also close standard error.
The run exits non-zero with no result when no card is there, when the
cell asks for more cards than there are, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metric_names(bench: dict, name: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``), as ``BENCHMARK.json`` assigns them."""
    reported = [m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return reported
    return [m["name"] for m in bench["per_layer"]
            if name in m.get("workloads", [name]) and m["moves"] in reported]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "portbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "portbench" / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = cell_entry(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench: torch.cuda.is_available() is False: the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    from portbench.harness import cell as cell_mod

    out = cell_mod.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_process=T_PROCESS)
    run = out["run"]
    metrics_dir = ROOT / "portbench" / "metrics"
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    values = cell_mod.metric_values(run, metric_names(bench, args.workload, bool(args.trace)), metrics_dir)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(entry["chips"]),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    extra = cell_mod.trace_device(run) if args.trace else {}
    if args.trace:
        if "busy_s" not in extra:
            print("portbench: the traced run holds no device operation", file=sys.stderr)
            return 3
        device.update(busy_s=extra["busy_s"], window_s=extra["window_s"])

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {bad}: the port's benchmark may load neither JAX nor the JAX "
              "package", file=sys.stderr)
        return 4

    chk = out["check"]
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()}, "device": device}
    if args.trace:
        line["breakdown"] = extra["breakdown"]
    line["diagnostics"] = {
        "readings": chk["readings"], "sampled": chk["sampled"], "check_s": chk["seconds"], "steps": len(run.steps),
        "window_s": run.t_end - run.t_start, "setup_s": run.setup_s, "setup_phases": run.setup_phases,
        "late_s": run.late_s, "tails_ms": cell_mod.tails_ms(run),
        "prefills": len([s for s in run.prefill_spans if run.t_start <= s[0] < run.t_close]),
        "page_move_s": sum(b - a for a, b, _ in run.page_spans if run.t_start <= a < run.t_close)}
    line["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in chk["numbers"].items()}
    print(json.dumps(line), flush=True)
    for k, (v, lim) in chk["numbers"].items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
