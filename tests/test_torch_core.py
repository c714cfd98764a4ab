"""The port's runtime core (progress engine, recorded schedules, MPIX
streams, enqueue windows) against the JAX package's.

Behaviour tests run with the same body and the same assertions over both
packages (``pkg`` is ``jax`` or ``torch``). The port-only tests hold the
completion hazard of enqueued CUDA work fixed: a dispatched CUDA tensor is
done when the event recorded after it says so, never at once.
"""

import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core.datatype as jdt  # noqa: E402
import repro.core.enqueue as jenq  # noqa: E402
import repro.core.progress as jpg  # noqa: E402
import repro.core.schedule as jsch  # noqa: E402
import repro.core.streams as jss  # noqa: E402
import repro_torch.core.datatype as tdt  # noqa: E402
import repro_torch.core.enqueue as tenq  # noqa: E402
import repro_torch.core.progress as tpg  # noqa: E402
import repro_torch.core.schedule as tsch  # noqa: E402
import repro_torch.core.streams as tss  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(pg=jpg, sch=jsch, ss=jss, enq=jenq, dt=jdt),
    "torch": SimpleNamespace(pg=tpg, sch=tsch, ss=tss, enq=tenq, dt=tdt),
}
_T = 20.0


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture()
def eng(pkg):
    e = pkg.pg.ProgressEngine()
    yield e
    e.stop_all()


@pytest.fixture()
def offload(pkg):
    s = pkg.ss.stream_create(info={"type": "cudaStream_t"}, name="test-off")
    yield s
    pkg.ss.stream_free(s)


def _external_req(eng, stream):
    return eng.grequest_start(poll_fn=lambda st: False, stream=stream)


# ---------------------------------------------------------------- progress


def test_grequest_poll_fn_completion(pkg, eng):
    state = {"n": 0}

    def poll(st):
        st["n"] += 1
        return st["n"] >= 3

    r = eng.grequest_start(poll_fn=poll, extra_state=state)
    assert not r.done and not eng.test(r)
    assert eng.wait(r, timeout=5)
    assert state["n"] == 3


def test_waitall_batches_wait_fn_once_per_group(pkg, eng):
    hit = {"wait_fn": 0}

    def wait_fn(states, timeout):
        hit["wait_fn"] += 1
        for s in states:
            s["done"] = True

    batch = [eng.grequest_start(poll_fn=lambda st: st.get("done", False), wait_fn=wait_fn, extra_state={})
             for _ in range(3)]
    other = eng.grequest_start(poll_fn=lambda st: True)
    assert eng.wait_all(batch + [other], timeout=5)
    assert hit["wait_fn"] == 1


def test_progress_of_one_stream_polls_only_that_stream(pkg, eng):
    pool = pkg.ss.StreamPool()
    s1, s2 = pool.create(), pool.create()
    polled = {"s1": 0, "s2": 0}
    r1 = eng.grequest_start(poll_fn=lambda st: polled.__setitem__("s1", polled["s1"] + 1) or False, stream=s1)
    r2 = eng.grequest_start(poll_fn=lambda st: polled.__setitem__("s2", polled["s2"] + 1) or False, stream=s2)
    eng.progress(s1)
    eng.progress(s1)
    assert polled == {"s1": 2, "s2": 0}
    eng.progress(None)
    assert polled["s2"] == 1
    r1.complete()
    r2.complete()
    eng.progress(None)
    assert eng.pending() == 0


def test_external_completion_wakes_parked_waiter(pkg, eng):
    r = eng.grequest_start(poll_fn=lambda st: False)
    threading.Timer(0.05, r.complete).start()
    assert eng.wait(r, timeout=5)


# ---------------------------------------------------------------- schedules


def _record_double(sched):
    def issue(ctx):
        ctx.fused.part(poll_fn=lambda st: True, name="double")
        ctx.outputs["y"] = ctx.bound("x") * 2

    rec = sched.record()
    try:
        sched.add_op("double", issue, parts=1, label="double")
        rec.seal()
    finally:
        rec.abort()


def test_schedule_record_seal_replay(pkg, eng):
    sched = pkg.sch.Schedule(engine=eng, name="t-life")
    assert sched.state == "IDLE"
    _record_double(sched)
    for i in range(1, 4):
        ctx = sched.replay(binding={"x": i}, timeout=_T)
        assert ctx.outputs["y"] == 2 * i and ctx.epoch == i and ctx.done
    st = sched.stats()
    assert st["state"] == "SEALED" and st["replays"] == 3 and st["ops"] == 1 and st["parts"] == 1


def test_schedule_stale_fingerprint_then_rerecord(pkg, eng):
    sched = pkg.sch.Schedule(engine=eng, name="t-stale")
    rec = sched.record()
    try:
        sched.fingerprint(n=4)
        sched.add_op("op", lambda ctx: ctx.fused.part(poll_fn=lambda st: True), parts=1)
        rec.seal()
    finally:
        rec.abort()
    sched.replay(timeout=_T)
    with pytest.raises(pkg.sch.ScheduleStale):
        sched.check(n=5)
    with pytest.raises(pkg.sch.ScheduleStale):
        sched.replay(timeout=_T)
    _record_double(sched)
    ctx = sched.replay(binding={"x": 3}, timeout=_T)
    assert ctx.outputs["y"] == 6 and ctx.epoch == 2


def test_schedule_prewait_runs_once(pkg, eng):
    sched = pkg.sch.Schedule(engine=eng, name="t-prewait")
    ran = []

    def issue(ctx):
        ctx.fused.part(poll_fn=lambda st: True)
        ctx.prewaits.append(lambda: ran.append(ctx.epoch))

    rec = sched.record()
    try:
        sched.add_op("op", issue, parts=1)
        rec.seal()
    finally:
        rec.abort()
    ctx = sched.replay(wait=False)
    ctx.wait(timeout=_T)
    ctx.wait(timeout=_T)
    assert ran == [1]


# ---------------------------------------------------------------- streams


def test_stream_pool_exhaustion_and_reuse(pkg):
    pool = pkg.ss.StreamPool(max_channels=3)
    a, b, c = pool.create(), pool.create(), pool.create()
    assert {a.channel, b.channel, c.channel} == {0, 1, 2}
    with pytest.raises(RuntimeError, match="out of communication channels"):
        pool.create()
    pool.free(b)
    assert pool.create().channel == b.channel
    with pytest.raises(RuntimeError, match="already freed"):
        pool.free(b)


def test_offload_streams_get_the_reference_kind_and_channel():
    infos = [{}, {"type": "cudaStream_t"}, {"type": "tpu_stream"}, {}, {"type": "cudaStream_t"},
             {"type": "hipStream_t"}, {"type": "cudaStream_t"}]
    got = {}
    for name, m in (("jax", jss), ("torch", tss)):
        pool = m.StreamPool(max_channels=3)
        got[name] = [(s.kind, s.channel, s.is_offload, s.info) for s in (pool.create(info=i) for i in infos)]
    assert got["torch"] == got["jax"]
    s = tss.StreamPool().create(info={"type": "cudaStream_t"})
    assert s.is_cuda_stream and s.torch_stream("cpu") is None
    assert not tss.StreamPool().create(info={"type": "tpu_stream"}).is_cuda_stream


def test_info_set_hex_matches_reference():
    handle = (123456789).to_bytes(8, "little")
    assert tss.info_set_hex({}, "value", handle) == jss.info_set_hex({}, "value", handle)


def test_tokens_are_identity_on_the_cpu():
    x = torch.ones(3)
    tok = tss.new_token("cpu")
    assert tok is None and tss.token_join(tok, None) is None
    assert tss.serialize_on(tok, x) == (None, (x,))


# ---------------------------------------------------------------- windows


def test_window_depth_must_be_positive(pkg, eng, offload):
    with pytest.raises(ValueError, match="depth"):
        pkg.enq.OffloadWindow(offload, depth=0, engine=eng)


def test_window_reserve_times_out_when_full(pkg, eng, offload):
    win = pkg.enq.OffloadWindow(offload, depth=1, engine=eng)
    r = _external_req(eng, offload)
    assert win.admit(r) is not None
    t0 = time.monotonic()
    assert win.reserve(timeout=0.05) is False
    assert time.monotonic() - t0 < 2.0
    r.complete()


def test_window_reaps_in_completion_order(pkg, eng, offload):
    win = pkg.enq.OffloadWindow(offload, depth=4, engine=eng)
    reqs = [_external_req(eng, offload) for _ in range(3)]
    for i, r in enumerate(reqs):
        win.admit(r, value=i)
    reqs[2].complete()
    early = win.reap()
    assert [s.value for s in early] == [2] and early[0].completion_index == 0
    reqs[0].complete()
    reqs[1].complete()
    assert [s.value for s in win.reap()] == [0, 1]
    assert win.in_flight() == 0


def test_window_backpressure_parks_and_wakes(pkg, eng, offload):
    win = pkg.enq.OffloadWindow(offload, depth=1, engine=eng)
    r = _external_req(eng, offload)
    win.admit(r)
    got = []
    t = threading.Thread(target=lambda: got.append(win.reserve(timeout=10)))
    t.start()
    time.sleep(0.05)
    assert not got  # parked behind the full window
    r.complete()
    t.join(timeout=10)
    assert not t.is_alive() and got == [True]
    assert win.stats(engine=False)["backpressure_parks"] >= 1
    win.unreserve()


def test_window_issue_bracket_returns_unsubmitted_slot(pkg, eng, offload):
    win = pkg.enq.OffloadWindow(offload, depth=1, engine=eng)
    with pytest.raises(RuntimeError, match="dispatch failed"):
        with win.issue(timeout=1):
            raise RuntimeError("dispatch failed")
    assert win.reserve(timeout=0.5)
    win.unreserve()


# ------------------------------------------------ enqueue on the port


class _StubEvent:
    """A CUDA event stand-in whose ``query()`` is False ``pending`` times."""

    def __init__(self, pending):
        self.pending = pending
        self.queries = 0
        self.synchronized = 0

    def query(self):
        self.queries += 1
        return self.queries > self.pending

    def synchronize(self):
        self.synchronized += 1
        self.queries = self.pending


def test_poll_dispatched_follows_the_event():
    ev = _StubEvent(pending=2)
    state = {"y": None, "event": ev}
    assert tenq._poll_dispatched(state) is False
    assert tenq._poll_dispatched(state) is False
    assert tenq._poll_dispatched(state) is True


def test_enqueued_request_completes_only_when_its_event_does():
    e = tpg.ProgressEngine()
    ev = _StubEvent(pending=3)
    req = e.grequest_start(poll_fn=tenq._poll_dispatched, wait_fn=tenq._wait_dispatched,
                           extra_state={"y": None, "event": ev})
    assert not e.test(req)
    assert e.wait(req, timeout=5) and req.done
    assert ev.queries > 3 or ev.synchronized
    e.stop_all()


def test_wait_dispatched_honours_the_deadline():
    ev = _StubEvent(pending=10**9)
    t0 = time.monotonic()
    tenq._wait_dispatched([{"y": None, "event": ev}], 0.05)
    assert time.monotonic() - t0 < 2.0
    assert ev.synchronized == 0 and not tenq._poll_dispatched({"y": None, "event": ev})
    ev2 = _StubEvent(pending=10**9)
    tenq._wait_dispatched([{"y": None, "event": ev2}], None)
    assert ev2.synchronized == 1


def test_cuda_work_without_an_event_is_refused(monkeypatch):
    monkeypatch.setattr(tenq, "_cuda_tensors", lambda y: [y])
    with pytest.raises(RuntimeError, match="no completion event"):
        tenq._poll_dispatched({"y": object(), "event": None})
    with pytest.raises(RuntimeError, match="no completion event"):
        tenq._wait_dispatched([{"y": object()}], None)


def test_host_values_are_complete_when_they_exist():
    state = tenq.dispatch_state(torch.ones(4))
    assert state["event"] is None and tenq._poll_dispatched(state)


def _rand_layouts():
    from test_torch_datatype import _random_datatype

    return [(_random_datatype(jdt, random.Random(s), 2), _random_datatype(tdt, random.Random(s), 2)) for s in range(12)]


@pytest.mark.parametrize("name,build", [
    ("uniform", lambda m: m.vector(16, 3, 7, m.predefined(4))),
    ("irregular", lambda m: m.indexed([1, 2, 1], [0, 3, 9], m.predefined(4))),
    ("overlapping", lambda m: m.hvector(3, 2, 4, m.predefined(4))),
])
def test_pack_send_routes_like_the_reference(monkeypatch, name, build):
    """The kernel route where the reference takes its kernel, the host
    engine where it takes the host engine; the bytes are the reference's."""
    import jax.numpy as jnp

    jd, td = build(jdt), build(tdt)
    buf = np.arange(16 * 7 + 5, dtype=np.float32)
    calls = []
    real = tops.pack_datatype
    monkeypatch.setattr(tops, "pack_datatype", lambda *a, **k: calls.append(1) or real(*a, **k))
    out = tenq.pack_send(torch.from_numpy(buf), td)
    ref = jenq.pack_send(jnp.asarray(buf), jd)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert len(calls) == (1 if name == "uniform" else 0)


def test_pack_send_random_layouts_match_reference_bytes():
    import jax.numpy as jnp

    for jd, td in _rand_layouts():
        need = max(s.offset + s.length for s in jd.iovs())
        buf = np.random.default_rng(need).integers(0, 255, need, dtype=np.uint8)
        out = tenq.pack_send(torch.from_numpy(buf), td)
        np.testing.assert_array_equal(out.numpy().view(np.uint8), np.asarray(jenq.pack_send(jnp.asarray(buf), jd)))


def test_pack_send_through_window_and_engine_on_the_cpu():
    e = tpg.ProgressEngine()
    s = tss.stream_create(info={"type": "cudaStream_t"}, name="cpu-off")
    try:
        leaf = torch.arange(4 * 8 * 16, dtype=torch.float32)
        spans = [tdt.subarray((4, 8, 16), (4, 2, 16), (0, i, 0), tdt.FLOAT) for i in range(4)]
        req = tenq.dispatch_enqueue(tenq.pack_send(leaf, spans[0], stream=s), stream=s, engine=e)
        assert e.wait_all([req.grequest], timeout=5) and req.token is None
        win = tenq.OffloadWindow(stream=s, depth=2, engine=e)
        outs = []
        for dt in spans:
            with win.issue(timeout=5) as submit:
                y = tenq.pack_send(leaf, dt, stream=s)
                submit(tenq.dispatch_enqueue(y, stream=s, engine=e), value=y)
            outs.append(y)
        slots = win.drain(timeout=5)
        assert len(slots) == 4 and win.stats(engine=False)["max_depth_seen"] <= 2
        for dt, y in zip(spans, outs):
            np.testing.assert_array_equal(y.numpy().view(np.uint8), tdt.pack(leaf, dt))
    finally:
        e.stop_all()
        tss.stream_free(s)
