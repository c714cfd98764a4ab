"""The program-span readers on synthetic events and spans: the device's idle
time divided by the innermost program span, each reader's value, and None
where the program has no spans or stamps (an older commit's run); the hook
that opens the collection with the profiler's traced steps."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import spans as sp
from portbench.harness.engine import ReqRecord
from portbench.harness.trace import reduce_trace
from portbench.trace_spans import SpanWindow

PB = Path(__file__).resolve().parents[1]
MS = 1_000_000
FRONT, WORKER = 11, 22


def _span(name, t0, t1, thread=FRONT, **counts):
    return SimpleNamespace(name=name, t0_ns=t0 * MS, t1_ns=t1 * MS, thread=thread, rid=None, counts=counts)


def _record(**kw):
    base = dict(offered=[], trace=None, program_spans=None, program_idle=None)
    base.update(kw)
    return SimpleNamespace(**base)


EVENTS = [
    ("pb.window", False, 0, 100 * MS),
    ("pb.step", False, 0, 90 * MS),
    ("void flash_fwd_bf16_kernel<96>", True, 10 * MS, 30 * MS),
    ("ampere_bf16_gemm", True, 20 * MS, 35 * MS),
    ("void pack_kernel<uint4>", True, 60 * MS, 70 * MS),
]
SPANS = [
    _span("serve.step", 0, 90),
    _span("serve.admit", 1, 45),
    _span("serve.prefill", 2, 40),
    _span("model.prefill", 3, 33),
    _span("serve.sync", 33, 40),
    _span("serve.decode", 50, 58),
    _span("model.decode", 50, 55),
    _span("serve.advance", 58, 89),
    _span("kv.append", 58, 62, k1=2),
    _span("kv.append", 62, 66, k1=2),
    _span("front.park", 92, 99),
    _span("kv.gather", 0, 99, thread=WORKER, k1=4),  # another thread's: not the front end's
]


def test_idle_goes_to_the_innermost_program_span_on_the_front_thread():
    idle = sp.idle_by_program_span(EVENTS, SPANS, FRONT)
    # busy [10, 35) and [60, 70). Each idle interval goes to the innermost span
    # open where it begins: 0 in serve.step alone; 35 in serve.sync (model.prefill
    # ended at 33); 70 in serve.advance, past both appends
    assert idle == pytest.approx({"serve.step": 0.010, "serve.sync": 0.025, "serve.advance": 0.030})
    summary = reduce_trace(EVENTS)
    assert sum(idle.values()) == pytest.approx(summary["window_s"] - summary["busy_s"])
    late = EVENTS + [("void pack_kernel<uint4>", True, 89 * MS, 90 * MS + MS // 2),
                     ("void pack_kernel<uint4>", True, 91 * MS, 93 * MS)]
    idle = sp.idle_by_program_span(late, SPANS, FRONT)
    assert idle["serve.advance"] == pytest.approx(0.019)
    assert idle["none"] == pytest.approx(0.0005)  # [90.5, 91): past the step, before the park
    assert idle["front.park"] == pytest.approx(0.007)  # [93, 100): the park began at 92
    assert sp.idle_by_program_span(EVENTS, SPANS, WORKER) == pytest.approx({"kv.gather": 0.065})
    assert sp.idle_by_program_span(EVENTS, [], FRONT) == pytest.approx({"none": 0.065})
    assert sp.idle_by_program_span([("pb.window", False, 0, 10)], SPANS, FRONT) is None
    assert sp.front_thread(SPANS) == FRONT


def test_launch_stamps_put_idle_on_the_host_clock():
    # the device stamps read 8 ms late against the host's: the ops ran at
    # [10, 30), [20, 35) and [60, 70) on the host clock, each launched into
    # an idle device (or queued behind the first), so the gap the trace shows
    # from 43 began at 35, in serve.sync, not in serve.admit
    late = [(n, dev, a + 8 * MS, b + 8 * MS) if dev else (n, dev, a, b) for n, dev, a, b in EVENTS]
    launch_of = {18 * MS: 10 * MS, 28 * MS: 12 * MS, 68 * MS: 60 * MS}
    idle = sp.idle_by_program_span(late, SPANS, FRONT, launch_of)
    assert idle == pytest.approx({"serve.step": 0.018, "serve.sync": 0.025, "serve.advance": 0.022})
    raw = sp.idle_by_program_span(late, SPANS, FRONT)
    assert raw == pytest.approx({"serve.step": 0.018, "serve.admit": 0.025, "serve.advance": 0.022})
    summary = reduce_trace(late)
    assert sum(idle.values()) == sum(raw.values()) == pytest.approx(summary["window_s"] - summary["busy_s"])


def test_readers_on_spans():
    run = _record(program_spans=SPANS, trace={"window_s": 0.1, "busy_s": 0.035})
    run.program_idle = sp.idle_by_program_span(EVENTS, SPANS, FRONT)
    # 4 + 4 ms of appends and 99 ms of gather over 2 + 2 + 4 launches
    assert sp.kv_host_us_per_k1(run) == pytest.approx((4 + 4 + 99) * 1e3 / 8)
    assert sp.idle_in_pct(run, "kv.") == 0.0
    assert sp.idle_in_pct(run, "serve.sync", "serve.advance") == pytest.approx(55.0)
    assert sp.decode_issue_ms(run) == pytest.approx(5.0)


def test_first_token_reads_the_programs_stamp():
    offered = [ReqRecord(i, 100, 8, due=float(i), t_submit=float(i), req=SimpleNamespace(t_first=i + 0.1 * (i + 1)))
               for i in range(20)]
    assert sp.first_token_ms(_record(offered=offered), 0.5) == pytest.approx(1050.0)
    assert sp.first_token_ms(_record(offered=offered), 0.95) == pytest.approx(1905.0)


def test_readers_return_none_without_program_spans_or_stamps():
    old = [ReqRecord(0, 100, 8, due=0.0, t_submit=0.0, t_first=0.5, req=SimpleNamespace(rid=0, done=True))]
    run = _record(offered=old, trace={"window_s": 0.1, "busy_s": 0.035})
    assert sp.first_token_ms(run, 0.95) is None  # a Request without t_first
    for fn in (sp.kv_host_us_per_k1, sp.decode_issue_ms):
        assert fn(run) is None
    assert sp.idle_in_pct(run, "kv.") is None
    assert sp.first_token_ms(_record(), 0.95) is None


def test_the_metric_file_reads_the_stamp_or_nothing():
    import importlib.util

    bench = json.loads((PB.parent / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "first_token_p95_ms.docqa"]
    assert entry["workloads"] == ["phi3-docqa-paged"] and entry["moves"] == "latency_p95_ms"
    spec = importlib.util.spec_from_file_location("m_first_token", PB / "metrics" / "first_token_p95_ms.docqa.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stamped = [ReqRecord(0, 100, 8, due=1.0, t_submit=1.0, req=SimpleNamespace(t_first=1.25))]
    assert mod.read(_record(offered=stamped)) == pytest.approx(250.0)
    assert mod.read(_record(offered=[ReqRecord(0, 100, 8, due=1.0, t_submit=1.0, req=object())])) is None


class _FakeTraceWindow:
    def __init__(self, t_from, seconds):
        self.t_from, self.seconds = t_from, seconds
        self.prof = self.t_on = self.t_off = None

    def before_step(self, now):
        if self.prof is None and self.t_on is None and now >= self.t_from:
            self.prof, self.t_on = object(), now

    def after_step(self, now):
        if self.prof is not None and self.t_off is None and now >= self.t_on + self.seconds:
            self.t_off = now


def test_span_window_collects_over_the_profilers_steps():
    from repro_torch import tracing

    rec = SimpleNamespace(hooks=[])
    window = SpanWindow(tracing, _FakeTraceWindow)
    window.rec = rec
    rec.hooks.append(window)
    rec.hooks.append(_FakeTraceWindow(t_from=2.0, seconds=1.5))
    for now in (0.0, 1.0, 2.0, 3.0, 4.0, 5.0):
        for h in rec.hooks:
            h.before_step(now)
        with tracing.span("serve.step"):
            pass
        for h in rec.hooks:
            h.after_step(now + 0.5)
    window.close()
    assert [s.name for s in window.trace.spans] == ["serve.step"] * 2  # the steps at 2.0 and 3.0
    assert tracing.span("x") is tracing.span("y")  # the collection is closed
