"""Program spans (``repro_torch.tracing``) and the serving path's stamps.

Off, a span is one shared object that reads no clock; on, spans nest per
thread with their request and counts, and their clock is the profiler's.
The engines on the smoke presets: one step's span tree has the names and
nesting the serving path fixes, and collecting changes no token. The K1
launch counters count under a lock."""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.progress import ProgressEngine
from repro_torch.kernels import count_launch
from repro_torch.models import api
from repro_torch.serving.admission import AdmissionFrontEnd, make_offer
from repro_torch.serving.engine import PagedServeEngine, ServeEngine

MS = 1_000_000


def _boom():
    raise AssertionError("a span read the clock while tracing was off")


def test_off_span_is_one_shared_object_that_reads_no_clock(monkeypatch):
    monkeypatch.setattr(tracing, "time", SimpleNamespace(time_ns=_boom))
    a, b = tracing.span("serve.step"), tracing.span("kv.append", rid=3, tokens=16, k1=_boom)
    assert a is b
    with a:
        pass
    assert tracing._trace is None


def test_spans_nest_per_thread_with_rid_counts_and_self_time():
    launches = {"n": 0}
    with tracing.collect() as trace:
        with tracing.span("serve.step", k1=lambda: launches["n"]):
            with tracing.span("serve.prefill", rid=7, tokens=12):
                time.sleep(0.002)
            with tracing.span("serve.decode"):
                launches["n"] += 3
                time.sleep(0.002)

        def worker():
            with tracing.span("kv.append", rid=9):
                with tracing.span("kv.reclaim"):
                    pass

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    names = [s.name for s in trace.spans]
    assert names == ["serve.step", "serve.prefill", "serve.decode", "kv.append", "kv.reclaim"]
    step, prefill, decode, append, reclaim = trace.spans
    assert step.parent is None and prefill.parent == 0 and decode.parent == 0
    assert append.parent is None and reclaim.parent == 3  # the worker's own stack
    assert append.thread == reclaim.thread != step.thread == prefill.thread
    assert prefill.rid == 7 and append.rid == 9 and step.rid is None
    assert step.counts == {"k1": 3} and prefill.counts == {"tokens": 12} and decode.counts == {}
    assert trace.children(0) == [1, 2]
    for s in trace.spans:
        assert s.t0_ns <= s.t1_ns
    assert step.t0_ns <= prefill.t0_ns <= prefill.t1_ns <= decode.t0_ns <= decode.t1_ns <= step.t1_ns
    dur = step.t1_ns - step.t0_ns
    covered = (prefill.t1_ns - prefill.t0_ns) + (decode.t1_ns - decode.t0_ns)
    assert trace.self_ns(0) == dur - covered >= 0
    assert trace.self_ns(1) == prefill.t1_ns - prefill.t0_ns >= 2 * MS
    totals = trace.totals()
    assert totals["serve.step"] == {"n": 1, "total_ns": dur, "self_ns": dur - covered}
    # spans are off again after the block, and blocks do not nest
    assert tracing.span("x") is tracing.span("y")
    with tracing.collect():
        with pytest.raises(RuntimeError):
            with tracing.collect():
                pass


def test_span_clock_is_the_profilers():
    """A program span around a ``record_function`` region holds the region's
    kineto start and end: the two share one clock (epoch nanoseconds)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with tracing.collect() as trace:
            with tracing.span("outer"):
                with torch.profiler.record_function("clock.region"):
                    torch.ones(64).add_(1)
                    time.sleep(0.001)
    (s,) = trace.spans
    region = [(int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
              for e in prof.profiler.kineto_results.events() if e.name() == "clock.region"]
    assert len(region) == 1
    a, b = region[0]
    assert s.t0_ns - 50 * MS <= a <= b <= s.t1_ns + 50 * MS


# -- the engines ---------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke():
    out = {}
    for arch in ("qwen1.5-0.5b", "granite-moe-1b-a400m"):
        cfg = get_config(arch, smoke=True).replace(param_dtype="float32", compute_dtype="float32")
        out[arch] = (cfg, api.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    return out


def _prompts(vocab, lens=(5, 9, 7), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, (n,)).astype(np.int32) for n in lens]


def _engine(smoke, arch, kind, schedule):
    cfg, params = smoke[arch]
    cls = PagedServeEngine if kind == "paged" else ServeEngine
    kw = dict(page_size=4) if kind == "paged" else {}
    return cls(cfg, params, max_batch=2, max_len=32, progress_engine=ProgressEngine(), step_schedule=schedule, **kw)


def _tree(trace, i=None):
    """(name, children) from span ``i`` down; the roots from None."""
    kids = [j for j, s in enumerate(trace.spans) if s.parent == i] if i is None else trace.children(i)
    return [(trace.spans[j].name, _tree(trace, j)) for j in kids]


def _names(tree):
    return [n for n, _ in tree]


def _find(tree, name):
    return [kids for n, kids in tree if n == name]


@pytest.mark.parametrize("arch,kind,schedule", [("qwen1.5-0.5b", "serve", False), ("qwen1.5-0.5b", "serve", True),
                                                ("qwen1.5-0.5b", "paged", True), ("granite-moe-1b-a400m", "serve", True)])
def test_one_step_span_tree_and_tokens_unchanged(smoke, arch, kind, schedule):
    cfg = smoke[arch][0]
    plain, traced = _engine(smoke, arch, kind, schedule), _engine(smoke, arch, kind, schedule)
    reqs_plain = [plain.submit(p, max_new_tokens=4) for p in _prompts(cfg.vocab)]
    reqs_traced = [traced.submit(p, max_new_tokens=4) for p in _prompts(cfg.vocab)]
    with tracing.collect() as trace:
        traced.step()
    roots = _tree(trace)
    assert _names(roots) == ["serve.step"]
    step = roots[0][1]
    admit = _find(step, "serve.admit")[0]
    ffn = "model.moe" if arch.startswith("granite") else "model.ffn"
    for prefill in _find(admit, "serve.prefill"):
        assert _names(prefill) == ["model.prefill", "serve.sync"]
        model = prefill[0][1]
        assert _names(model) == ["model.attn", ffn] * cfg.n_layers + ["model.cache"]
        if ffn == "model.moe":
            assert all(_names(kids) == ["moe.route", "moe.experts", "moe.combine"] for kids in _find(model, ffn))
    if kind == "paged":
        # the first two requests take the slots, the third is prefilled ahead and parked
        assert _names(admit) == (["kv.reclaim"] + ["serve.prefill", "kv.append", "kv.gather", "serve.splice"] * 2
                                 + ["serve.prefill", "kv.append"])
    else:
        assert _names(admit) == ["serve.prefill", "serve.splice"] * 2
    assert _names(step) == ["serve.admit", "serve.decode", "serve.advance"]
    decode = _find(step, "serve.decode")[0]
    if schedule:
        assert _names(decode) == ["schedule.replay", "serve.sync"]
        replay = decode[0][1]
        assert _names(replay) == ["schedule.issue", "schedule.wait"]
        model = _find(replay, "schedule.issue")[0]
    else:
        assert _names(decode) == ["model.decode", "serve.sync"]
        model = decode
    layers = _find(model, "model.decode")[0]
    assert _names(layers) == ["model.attn", ffn] * cfg.n_layers
    advance = _find(step, "serve.advance")[0]
    assert _names(advance) == (["kv.append"] * 2 if kind == "paged" else [])
    # the counts at the boundaries
    by_name = {}
    for s in trace.spans:
        by_name.setdefault(s.name, []).append(s)
    n_pre = 3 if kind == "paged" else 2
    assert [s.rid for s in by_name["serve.prefill"]] == [r.rid for r in reqs_traced[:n_pre]]
    assert [s.rid for s in by_name["serve.splice"]] == [r.rid for r in reqs_traced[:2]]
    # only the page moves count (K1 launches; none on the CPU)
    assert all(s.counts == {} for s in trace.spans if not s.name.startswith(("kv.append", "kv.gather")))
    if kind == "paged":
        rids = [r.rid for r in reqs_traced]
        assert [s.rid for s in by_name["kv.append"]] == [rids[0], rids[1], rids[2], rids[0], rids[1]]
        assert [s.rid for s in by_name["kv.gather"]] == rids[:2]
        assert all(s.counts == {"k1": 0} for s in by_name["kv.append"] + by_name["kv.gather"])
    # the same tokens with spans on and off
    plain.step()
    plain.run_until_done(max_steps=100)
    traced.run_until_done(max_steps=100)
    assert [r.out_tokens for r in reqs_plain] == [r.out_tokens for r in reqs_traced]


def test_make_room_and_spill_spans_count_pages(smoke):
    cfg, params = smoke["qwen1.5-0.5b"]
    eng = PagedServeEngine(cfg, params, max_batch=1, max_len=32, progress_engine=ProgressEngine(), page_size=4,
                           pool_pages=9, spill_parked=True)
    reqs = [eng.submit(p, max_new_tokens=6) for p in _prompts(cfg.vocab, lens=(9, 9, 9), seed=3)]
    with tracing.collect() as trace:
        eng.run_until_done(max_steps=200)
    assert eng.kv.stats()["spilled_pages"] > 0
    # the parked requests spilled cold, each in a span of its own request
    spilled = {s.rid for s in trace.spans if s.name == "kv.spill"}
    assert spilled and spilled <= {r.rid for r in reqs}
    names = {s.name for s in trace.spans}
    assert "kv.reclaim" in names
    assert "kv.make_room" in names or eng.kv.stats()["reloaded_pages"] > 0


def test_request_stamps_order_and_front_end_park(smoke):
    cfg, params = smoke["qwen1.5-0.5b"]
    eng = _engine(smoke, "qwen1.5-0.5b", "serve", True)

    completed = []

    def offers():
        for i, p in enumerate(_prompts(cfg.vocab, lens=(5, 6, 7, 8))):
            if i == 2:  # wait for the first two to finish, then hold back: the front end parks
                deadline = time.perf_counter() + 60
                while len(completed) < 2 and time.perf_counter() < deadline:
                    time.sleep(0.005)
                time.sleep(0.1)
            yield make_offer(p, max_new_tokens=1 + i)

    with tracing.collect() as trace:
        cs = AdmissionFrontEnd(eng).serve(offers(), on_complete=completed.append)
    assert len(cs) == 4
    for c in cs:
        r = c.req
        assert c.t_arrival <= c.t_submit <= r.t_first <= r.t_done <= c.t_done and c.t_first == r.t_first
        assert c.ttft_s == c.t_first - c.t_arrival > 0
    assert any(s.name == "front.park" for s in trace.spans)
    one = [c.req for c in cs if c.req.max_new_tokens == 1][0]
    assert one.t_first <= one.t_done  # done at admission: both stamped in the prefill


def test_front_end_clock_stamps_the_engine(smoke):
    """A front end on another clock has the engine stamp on it too, so a
    Completion's stamps never mix two clocks."""
    cfg, params = smoke["qwen1.5-0.5b"]
    eng = _engine(smoke, "qwen1.5-0.5b", "serve", False)

    def clock():
        return time.perf_counter() + 1e6

    (c,) = AdmissionFrontEnd(eng, clock=clock).serve([make_offer(_prompts(cfg.vocab, lens=(5,))[0], max_new_tokens=3)])
    assert c.t_arrival <= c.t_submit <= c.t_first <= c.req.t_done <= c.t_done
    assert 0 < c.ttft_s < 60


def test_no_record_function_under_collect(smoke, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a program span called record_function")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    eng = _engine(smoke, "qwen1.5-0.5b", "paged", True)
    for p in _prompts(smoke["qwen1.5-0.5b"][0].vocab):
        eng.submit(p, max_new_tokens=3)
    with tracing.collect() as trace:
        eng.run_until_done(max_steps=50)
    assert len(trace.spans) > 50


def test_spans_off_read_no_clock_through_a_paged_run(smoke, monkeypatch):
    eng = _engine(smoke, "qwen1.5-0.5b", "paged", True)
    for p in _prompts(smoke["qwen1.5-0.5b"][0].vocab):
        eng.submit(p, max_new_tokens=3)
    monkeypatch.setattr(tracing, "time", SimpleNamespace(time_ns=_boom))
    eng.run_until_done(max_steps=50)
    assert eng._idle()


class _YieldingCount(int):
    """An int whose ``+`` lets other threads run between the read and the
    write of ``launches += 1``, where an unlocked count loses updates."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingCount(int(self) + other)


def test_launch_counter_loses_no_count_under_threads():
    def kernel():
        pass

    kernel.launches = _YieldingCount(0)
    n_threads, per = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(kernel) for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == n_threads * per
