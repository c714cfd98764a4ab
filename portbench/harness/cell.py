"""One run of one cell: set-up, the measured window, the check, the metrics.

A cell is ``portbench/workloads/<cell>.json``: the configuration and the
traffic mix it names (``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json``), the engine and its sizes, the
arrival rate of an open loop, the trace's part of the window and the
check's sample and limits. :func:`run_cell` reads them by name and needs no
code of its own for a new cell.

The window is the admission front end (``AdmissionFrontEnd.serve``) over
the cell's engine with a progress engine and a recorded decode step, driven
from the seed's offer stream for ``seconds``. An open loop then drains: every
request offered in the window is waited for. A closed loop (a backlog of
offline jobs) stops at the close: what is still in flight is cut, compared
with the tokens it was served, and not counted as failed.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.harness import arch
from portbench.harness import check as check_mod
from portbench.harness import program
from portbench.harness.engine import Recorder, bench_engine_class
from portbench.harness.trace import TraceWindow, breakdown, reduce_trace
from portbench.harness.traffic import OfferStream, TrafficPlan

__all__ = ["Layout", "load_cell", "run_cell"]

PORTBENCH = Path(__file__).resolve().parents[1]


class Layout:
    """Where a cell's files are: ``portbench/`` itself, or a test's tree of
    the same shape."""

    def __init__(self, base: Path = PORTBENCH):
        self.base = Path(base)

    def _json(self, *parts) -> dict:
        return json.loads(self.base.joinpath(*parts).read_text())

    def cell(self, name: str) -> dict:
        return self._json("workloads", f"{name}.json")

    def config_file(self, name: str) -> Path:
        return self.base / "configs" / f"{name}.json"

    def config(self, name: str) -> dict:
        return json.loads(self.config_file(name).read_text())

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")


def load_cell(name: str, layout: Layout) -> tuple:
    cell = layout.cell(name)
    return cell, layout.config(cell["config"]), layout.traffic(cell["traffic"])


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_records(rec: Recorder) -> None:
    rec.steps.clear()
    rec.prefill_spans.clear()
    rec.decode_spans.clear()
    rec.page_spans.clear()


def _start_profiler_once(torch) -> None:
    """The profiler's first start on the card loads and sets up CUPTI, which
    takes seconds: pay it in set-up, not inside the traced window."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _warm_up(eng, plan: TrafficPlan, device) -> None:
    """The mix's warm-up lengths (``TrafficPlan.warm_lengths``) through the
    engine's prefill, then one short request through admission, page moves
    and the recorded decode step, so no kernel meets the device first inside
    the window."""
    lengths = plan.warm_lengths
    for S in lengths:
        eng._prefill(eng.params, {"tokens": np.zeros((1, S), np.int32)})
    _sync(device)
    eng.submit(np.zeros(min(lengths), np.int32), max_new_tokens=3)
    eng.run_until_done(max_steps=100)
    _sync(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_process: float, device="cuda",
             layout: Optional[Layout] = None, engine_class: Callable = bench_engine_class,
             control: bool = False, overrides: Optional[dict] = None) -> dict:
    """Run cell ``name`` once; returns the run record's numbers for the
    result line (``correct``, ``attempted``, ``failed``, ``run``, ``check``,
    ``trace``, ``memory_peak_bytes``). ``overrides`` replaces entries of the
    cell's file (the rate sweep); ``engine_class`` makes the engine class
    from the program's (a test's broken one in place of the benchmark's);
    ``control`` also reads the fp8 control."""
    clock = time.perf_counter
    layout = layout or Layout()
    cell, cfg, mix = load_cell(name, layout)
    cell = {**cell, **(overrides or {})}
    architecture = arch.load(cfg, layout, layout.config_file(cell["config"]))
    device = torch.device(device)
    phases: Dict[str, float] = {"start": clock() - t_process}  # set-up's parts, for the record

    def phase(name: str) -> None:
        _sync(device)
        phases[name] = clock() - t_process - sum(phases.values())

    side = program.ProgramSide()
    if device.type == "cuda":
        side.load_kernels()
    phase("kernels")
    dims = architecture.reference.Dims(cfg)
    mcfg = architecture.program.model_config(cfg)

    # -- set-up -----------------------------------------------------------------
    weights = architecture.reference.draw_weights(dims, seed, device)
    model = architecture.program.build_model(mcfg, weights, device)
    del weights
    phase("weights")
    rec = Recorder(clock)
    pe = side.ProgressEngine()
    Engine = engine_class(side.engines[cell["engine"]])
    eng = Engine(mcfg, model, progress_engine=pe, recorder=rec, **program.engine_kwargs(cell))
    plan = TrafficPlan(mix, cell, dims.vocab, seed, seconds)
    phase("engine")
    _warm_up(eng, plan, device)
    phase("warm_up")
    rec.requests.clear()
    rec.live.clear()
    _reset_records(rec)
    held = []
    if mix.get("fill_slots"):
        for _ in range(eng.max_batch):
            prompt, nout = plan.next_request()
            eng.submit(prompt, max_new_tokens=nout)
        eng.step()  # admits (prefills) every slot and decodes one token
        held = list(rec.requests.values())
        _reset_records(rec)
        phase("fill_slots")
    if trace and device.type == "cuda":
        _start_profiler_once(torch)
        phase("profiler")
    _sync(device)
    setup_s = clock() - t_process
    log(f"set-up {setup_s:.1f} s ({', '.join(f'{k} {v:.2f}' for k, v in phases.items())}); window {seconds} s")

    # -- the window ----------------------------------------------------------------
    polls0 = pe.stats()["polls"]
    t_start = clock()
    t_close = t_start + float(seconds)
    stream = OfferStream(plan, side.make_offer, clock, t_start, t_close, held=len(held))
    rec.due_of = stream.lookup_due
    rec.on_done = lambda r: stream.release()
    if plan.arrivals == "closed":
        eng.close_at = t_close
    tracer = None
    if trace:
        # the window's last ``seconds`` (at most its second half): the profiler
        # stops at the step after, past the close, where gathering its events
        # delays only the drain
        part = min(float(cell.get("trace", {}).get("seconds", 4.0)), 0.5 * seconds)
        tracer = TraceWindow(torch, rec, t_close - part, part)
        if device.type == "cuda":
            rec.hooks.append(tracer)
    completions: List = []
    fe = side.AdmissionFrontEnd(eng, clock=clock)
    fe.serve(stream, on_complete=completions.append, sync_timeout=120.0)
    if tracer is not None:
        tracer.stop()
    _sync(device)
    polls = pe.stats()["polls"] - polls0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    pe.stop_all()

    steps = [s for s in rec.steps if t_start <= s.t0 < t_close]
    log(f"window: {len(steps)} steps, {len(rec.requests)} requests, drained {clock() - t_close:.1f} s after the close")
    held_ids = {r.rid for r in held}
    offered = [r for rid, r in rec.requests.items() if rid not in held_ids]
    trace_summary, trace_steps = None, []
    if tracer is not None and tracer.prof is not None:
        trace_summary = reduce_trace(tracer.events())
        a, b = tracer.step_range
        trace_steps = rec.steps[a:b]
    run = SimpleNamespace(
        cell=cell, cfg=cfg, model=architecture.counts.Model(cfg), setup_s=setup_s, setup_phases=phases,
        seconds=float(seconds),
        t_start=t_start, t_close=t_close, t_end=max((s.t1 for s in steps), default=t_start),
        steps=steps, offered=offered, held=held, completions=completions,
        prefill_spans=rec.prefill_spans, decode_spans=rec.decode_spans, page_spans=rec.page_spans,
        progress={"polls": polls}, trace=trace_summary, trace_steps=trace_steps,
        late_s=max(stream.late_s, default=0.0),
    )

    # -- free the program's state, then the check -------------------------------------
    rejected = len(fe.rejected)
    del eng, model, fe, stream, tracer, pe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    chk = cell["check"]
    result = check_mod.run_check(architecture, cfg, seed, device, offered, held, rejected, chk["limits"],
                                 int(chk["sample"]), control=control)
    log(f"check: {result['sampled']} requests, {result['tokens_compared']} tokens, {result['seconds']:.1f} s")
    attempted = len(offered) + len(held) + rejected
    failed = rejected + result["numbers"]["unfinished"][0]
    return {"correct": result["correct"], "attempted": attempted, "failed": failed, "run": run,
            "check": result, "memory_peak_bytes": int(peak)}


def metric_values(run, names: List[str], metrics_dir: Path) -> Dict[str, float]:
    """Each named metric's reader (``<metrics_dir>/<name>.py``) on ``run``;
    a reader that returns None leaves its metric out."""
    import importlib.util

    out = {}
    for name in names:
        path = metrics_dir / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[name] = float(value)
    return out


def tails_ms(run) -> Dict[str, float]:
    """The latency's and the first token's 90th and 95th percentiles, for
    the record (an open loop's; a closed loop's cut requests read none)."""
    from portbench.harness.readers import latency_ms, ttft_ms

    out = {}
    for q in (0.90, 0.95):
        for name, fn in (("latency", latency_ms), ("ttft", ttft_ms)):
            v = fn(run, q)
            if v is not None:
                out[f"{name}_p{round(q * 100)}"] = v
    return out


def trace_device(run) -> dict:
    """``busy_s``/``window_s`` and the breakdown of a traced run, or {}."""
    if run.trace is None:
        return {}
    return {"busy_s": run.trace["busy_s"], "window_s": run.trace["window_s"], "breakdown": breakdown(run.trace)}
