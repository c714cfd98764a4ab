"""A cell's traced run with the program's own spans: the device's idle time
divided by the program span that left it waiting, and the span readers.

    python3 portbench/trace_spans.py --workload <cell> --seed <n> --seconds <s> [--workload ...] [--out DIR]

Runs each cell once as ``run.py --trace 1`` does (the profiler over the
window's last seconds, switched at step boundaries) and holds
``repro_torch.tracing.collect()`` open over the same steps, through a hook
beside the benchmark's ``TraceWindow``. Prints one JSON line a cell:
``idle_by_program_span`` (:func:`portbench.harness.spans.idle_by_program_span`,
the ten largest), beside it ``reduce_trace``'s idle by benchmark span, the
span readers of ``portbench/harness/spans.py`` under ``metrics``, and each
span name's count, total and self time under ``self_ms``. The record goes to
``<out>/<cell>-<seed>.json``. It needs a card; the benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class SpanWindow:
    """An engine hook that opens ``tracing.collect()`` at the step where the
    recorder's ``TraceWindow`` starts the profiler, and closes it at the
    first step boundary after the profiler stopped. Put in the hooks before
    the ``TraceWindow``, it sees each step before it."""

    def __init__(self, tracing, trace_window_class):
        self.tracing, self.TraceWindow = tracing, trace_window_class
        self.rec = None
        self.tracer = None
        self.trace = None
        self._cm = None

    def before_step(self, now: float) -> None:
        if self.tracer is None:
            self.tracer = next((h for h in self.rec.hooks if isinstance(h, self.TraceWindow)), None)
        tw = self.tracer
        if tw is None:
            return
        if self.trace is None and tw.prof is None and tw.t_on is None and now >= tw.t_from:
            self._cm = self.tracing.collect()  # the TraceWindow starts the profiler at this same step
            self.trace = self._cm.__enter__()
        elif tw.t_off is not None:
            self.close()

    def after_step(self, now: float) -> None:
        pass

    def close(self) -> None:
        if self._cm is not None:
            self._cm.__exit__(None, None, None)
            self._cm = None


def spanned_engine_class(window: SpanWindow):
    from portbench.harness.engine import bench_engine_class

    def make(base):
        class SpannedEngine(bench_engine_class(base)):
            def __init__(self, *args, recorder, **kw):
                super().__init__(*args, recorder=recorder, **kw)
                window.rec = recorder
                recorder.hooks.append(window)  # run_cell appends its TraceWindow after this

        return SpannedEngine

    return make


def launch_of(kineto_events) -> dict:
    """Each device operation's start, to the host stamp of the runtime call
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) that issued it, matched
    by correlation id."""
    host, device = {}, []
    for e in kineto_events:
        if str(e.device_type()).upper().endswith("CUDA"):
            device.append((e.start_ns(), e.correlation_id()))
        elif e.name().startswith("cu"):  # the CUDA runtime's and driver's calls
            host[e.correlation_id()] = e.start_ns()
    return {start: host[corr] for start, corr in device if corr in host}


def one_cell(name: str, seed: int, seconds: float, out_dir: Path) -> dict:
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness import spans as sp
    from portbench.harness.trace import TraceWindow
    from repro_torch import tracing

    window = SpanWindow(tracing, TraceWindow)
    try:
        out = cell_mod.run_cell(name, seed, seconds, True, t_process=time.perf_counter(),
                                engine_class=spanned_engine_class(window))
    finally:
        window.close()
    run = out["run"]
    events = window.tracer.events()
    w0, w1 = next((a, b) for n, dev, a, b in events if n == "pb.window" and not dev)
    # the collection closes at the step boundary after the profiler stopped
    spans = [s for s in window.trace.spans if s.t1_ns is not None and w0 <= s.t0_ns and s.t1_ns <= w1]
    kineto = window.tracer.prof.profiler.kineto_results.events()
    idle = sp.idle_by_program_span(events, spans, sp.front_thread(spans), launch_of(kineto))
    run.program_spans, run.program_idle = spans, idle
    rec = {
        "cell": name, "seed": seed, "correct": out["correct"], "device": torch.cuda.get_device_name(0),
        "window_s": run.trace["window_s"], "busy_s": run.trace["busy_s"],
        "idle_by_program_span": sorted(idle.items(), key=lambda kv: -kv[1])[:10],
        "idle_by_benchmark_span": sorted(run.trace["idle_by_host"].items(), key=lambda kv: -kv[1]),
        "metrics": {
            "first_token_p95_ms.docqa": sp.first_token_ms(run, 0.95),
            "kv_host_us_per_k1.docqa": sp.kv_host_us_per_k1(run),
            "idle_in_kv_pct.docqa": sp.idle_in_pct(run, "kv."),
            "idle_in_model_pct.score": sp.idle_in_pct(run, "model.", "moe."),
            "decode_issue_ms.longgen": sp.decode_issue_ms(run),
        },
        "self_ms": {k: {"n": v["n"], "total_ms": v["total_ns"] * 1e-6, "self_ms": v["self_ns"] * 1e-6}
                    for k, v in sorted(window.trace.totals().items(), key=lambda kv: -kv[1]["self_ns"])},
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}-{seed}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "spans"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("trace_spans: no card (the traced window needs CUPTI on the card)", file=sys.stderr)
        return 2
    for name in args.workload:
        rec = one_cell(name, args.seed, args.seconds, Path(args.out))
        print(json.dumps({k: v for k, v in rec.items() if k != "self_ms"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
