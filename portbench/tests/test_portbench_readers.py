"""The metric readers on synthetic records: rates over all the work and the
whole window, percentiles over every request, the trace's busy and idle
time, and a reader that finds nothing returning None."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench.architectures.gqa.counts import Model
from portbench.harness import readers, traffic
from portbench.harness.engine import ReqRecord, StepRecord
from portbench.harness.trace import breakdown, reduce_trace

PB = Path(__file__).resolve().parents[1]
BENCH = json.loads((PB.parent / "BENCHMARK.json").read_text())


def _run(**kw):
    cfg = json.loads((PB / "configs" / "phi-3-vision-4.2b.json").read_text())
    base = dict(cfg=cfg, model=Model(cfg), setup_s=12.5, t_start=0.0, t_close=10.0, t_end=10.5, steps=[],
                offered=[], held=[], completions=[], prefill_spans=[], decode_spans=[], page_spans=[],
                progress={"polls": 0}, trace=None, trace_steps=[])
    base.update(kw)
    return SimpleNamespace(**base)


def test_rate_is_all_work_over_the_whole_window():
    # a fast burst then a slow tail: a mean of per-step rates would read far higher
    steps = [StepRecord(0.0 + 0.01 * i, 0.01 * (i + 1), decoded=16) for i in range(100)]
    steps.append(StepRecord(1.0, 10.5, prefills=[2048], decoded=16))
    run = _run(steps=steps)
    assert readers.output_tokens_per_s(run) == pytest.approx((100 * 16 + 17) / 10.5)
    assert readers.prompt_tokens_per_s(run) == pytest.approx(2048 / 10.5)


def test_p95_is_over_every_request_not_chunk_medians():
    rng = np.random.default_rng(0)
    lat = rng.lognormal(0.0, 1.0, 400)
    offered = [ReqRecord(i, 100, 8, due=0.0, t_submit=0.0, t_done=float(v)) for i, v in enumerate(lat)]
    run = _run(offered=offered)
    assert readers.latency_ms(run, 0.95) == pytest.approx(np.percentile(lat, 95) * 1e3)
    chunked = np.median([np.percentile(c, 95) for c in np.array_split(lat, 8)]) * 1e3
    assert readers.latency_ms(run, 0.95) != pytest.approx(chunked)
    # a cut request (still in flight at a closed loop's close) is not a latency
    offered.append(ReqRecord(999, 100, 8, due=0.0, t_submit=0.0, t_done=1e6, cut=True))
    assert readers.latency_ms(run, 0.95) == pytest.approx(np.percentile(lat, 95) * 1e3)


def test_quantile_matches_numpy():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0, 10.0]
    for q in (0.0, 0.5, 0.95, 1.0):
        assert readers.quantile(xs, q) == pytest.approx(np.percentile(xs, q * 100))
    assert readers.quantile([], 0.5) is None


def test_decode_step_and_prefill_cost():
    spans = [(1.0, 1.05, 32, 32), (2.0, 2.04, 16, 32), (11.0, 11.5, 32, 32)]  # the last after the close
    run = _run(decode_spans=spans, prefill_spans=[(3.0, 3.03, 3000), (4.0, 4.02, 1000)])
    assert readers.decode_step_ms(run) == pytest.approx(45.0)
    assert readers.prefill_ms_per_ktok(run) == pytest.approx(50.0 / 4.0)


def test_readers_return_none_when_nothing_to_read():
    run = _run()
    for fn in (readers.output_tokens_per_s, readers.mfu_pct, readers.mbu_pct, readers.k2_roofline_pct,
               readers.k1_roofline_pct, readers.idle_share_pct, readers.decode_step_ms,
               readers.prefill_ms_per_ktok):
        assert fn(run) is None
    assert readers.latency_ms(run, 0.95) is None


def test_trace_reduction_busy_idle_and_labels():
    ms = 1_000_000
    events = [
        ("pb.window", False, 0, 100 * ms),
        ("pb.step", False, 0, 90 * ms),
        ("pb.prefill", False, 5 * ms, 40 * ms),
        ("pb.decode", False, 50 * ms, 80 * ms),
        ("pb.step", True, 0, 90 * ms),  # a device copy of an annotation: not work
        ("void flash_fwd_bf16_kernel<96>", True, 10 * ms, 30 * ms),
        ("ampere_bf16_gemm", True, 20 * ms, 35 * ms),  # overlaps: the union counts it once
        ("void pack_kernel<uint4>", True, 60 * ms, 70 * ms),
    ]
    s = reduce_trace(events)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.035)
    # a gap goes to the innermost span the host was in when the device went idle
    assert s["idle_by_host"] == pytest.approx({"step": 0.010, "prefill": 0.025, "decode": 0.030})
    assert sum(s["idle_by_host"].values()) == pytest.approx(0.1 - 0.035)
    late = reduce_trace(events + [("void pack_kernel<uint4>", True, 92 * ms, 95 * ms)])
    assert late["idle_by_host"]["front_end"] == pytest.approx(0.005)  # [95, 100) after the step
    b = breakdown(s)
    assert b["device_ops"][0][0] == "void flash_fwd_bf16_kernel<96>"
    assert len(b["idle_gaps"]) <= 10
    run = _run(trace=s, trace_steps=[StepRecord(0, 0.09, prefills=[2048])])
    assert readers.idle_share_pct(run) == pytest.approx(65.0)
    assert readers.k1_roofline_pct(run) is None  # no page move traced
    assert readers.kernel_launches_per_step(run, readers.K1_NAME) == 1.0
    # one K2 launch where the config's 32 layers need 32: not read
    assert readers.k2_roofline_pct(run) is None
    assert reduce_trace([("pb.window", False, 0, 10)]) is None


def test_every_metric_has_a_reader_file_and_reads_a_record():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    run = _run(steps=[StepRecord(0.0, 10.5, prefills=[2048], decoded=16, decode_positions=[3000] * 16)])
    for name in names:
        path = PB / "metrics" / f"{name}.py"
        assert path.exists(), name
        spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(run)
        assert v is None or isinstance(v, float), name


def test_an_open_loop_offers_the_same_work_at_the_same_times_for_every_seed():
    mix = json.loads((PB / "traffic" / "docqa_lognormal_poisson.json").read_text())
    cell = {"rate_per_s": 2.5}
    a = traffic.TrafficPlan(mix, cell, 32064, 2**31 + 11, 40.0)
    b = traffic.TrafficPlan(mix, cell, 32064, 7, 40.0)
    n = 100  # an open loop's pool: the window's arrivals, rate x seconds
    assert len(a.pool) == n and a.pool == b.pool
    reqs_a = [a.next_request() for _ in range(n)]
    reqs_b = [b.next_request() for _ in range(n)]
    assert a.next_request() is None
    lens_a = [r[0].shape[0] for r in reqs_a]
    assert lens_a == [r[0].shape[0] for r in reqs_b]  # one order for every seed
    assert [r[1] for r in reqs_a] == [r[1] for r in reqs_b]
    assert not np.array_equal(reqs_a[0][0], reqs_b[0][0])  # other token ids
    assert lens_a != sorted(lens_a)  # not in the pool's sorted order
    # token granularity, not rounded to any multiple
    assert all(1536 <= x <= 3584 for x in lens_a) and len({x % 128 for x in lens_a}) > 32
    # prompt and output lengths are not paired in order
    assert np.corrcoef([p for p, _ in a.pool], [o for _, o in a.pool])[0, 1] < 0.5
    gaps_a = [a.next_gap() for _ in range(n)]
    assert a.next_gap() is None
    assert gaps_a == [b.next_gap() for _ in range(n)]
    assert sum(gaps_a) == pytest.approx(n / 2.5)  # the window's span at the rate
    # the same seed gives the same prompts
    c = traffic.TrafficPlan(mix, cell, 32064, 2**31 + 11, 40.0)
    assert np.array_equal(c.next_request()[0], reqs_a[0][0])


def test_a_closed_loop_serves_the_same_pool_in_the_seeds_order():
    mix = json.loads((PB / "traffic" / "score_uniform_backlog.json").read_text())
    a = traffic.TrafficPlan(mix, {}, 49155, 2**31 + 11, 40.0)
    b = traffic.TrafficPlan(mix, {}, 49155, 8, 40.0)
    n = len(a.pool)
    assert a.pool == b.pool
    lens_a = [a.next_request()[0].shape[0] for _ in range(n)]
    lens_b = [b.next_request()[0].shape[0] for _ in range(n)]
    assert sorted(lens_a) == sorted(lens_b) and lens_a != lens_b
    # the pool starts again, in a new order, when it runs out
    again = [a.next_request()[0].shape[0] for _ in range(n)]
    assert sorted(again) == sorted(lens_a) and again != lens_a


@pytest.mark.parametrize("slots", [32, 4])
def test_a_closed_loop_fills_its_slots_with_the_same_sizes_for_every_seed(slots):
    mix = json.loads((PB / "traffic" / "longgen_uniform_backlog.json").read_text())
    assert mix["fill_slots"]
    cell = {"max_batch": slots}
    a = traffic.TrafficPlan(mix, cell, 32064, 2**31 + 11, 40.0)
    b = traffic.TrafficPlan(mix, cell, 32064, 9, 40.0)
    n = len(a.pool)
    reqs_a = [a.next_request() for _ in range(2 * n)]  # two passes of the pool
    reqs_b = [b.next_request() for _ in range(2 * n)]
    sizes_a = [(r[0].shape[0], r[1]) for r in reqs_a]
    sizes_b = [(r[0].shape[0], r[1]) for r in reqs_b]
    for g in range(0, 2 * n, slots):  # each group of slots holds the same sizes
        assert sorted(sizes_a[g:g + slots]) == sorted(sizes_b[g:g + slots])
    assert sizes_a != sizes_b  # in the seed's order within a group
    assert sorted(sizes_a[:n]) == sorted(a.pool) == sorted(sizes_a[n:])  # each pass is the whole pool
    assert sizes_a[:n] != sizes_a[n:]  # in new groups
    assert not np.array_equal(reqs_a[0][0], reqs_b[0][0])  # other token ids
    # the same seed gives the same requests
    c = traffic.TrafficPlan(mix, cell, 32064, 2**31 + 11, 40.0)
    assert all(np.array_equal(c.next_request()[0], r[0]) for r in reqs_a[:slots])


def test_warm_lengths_are_few_and_cover_the_extremes():
    mix = json.loads((PB / "traffic" / "score_uniform_backlog.json").read_text())
    plan = traffic.TrafficPlan(mix, {}, 49155, 3, 40.0)
    lengths = [p for p, _ in plan.pool]
    w = plan.warm_lengths
    assert w[0] == max(lengths) and w[1] == min(lengths)
    assert all(p % 128 == 0 for p in w[2:]) and len(w) < 8
