"""The reference's runtime-sanitizer suite (``tests/test_sanitizer.py``)
over both packages: ``ProgressEngine(sanitize=True)`` stays silent on
contract-clean traffic and reports each violation class (lock-order
cycles, parks entered while holding stripe locks, request leaks at
``stop_all()`` and, through the hook, lost wakeups).

Each case runs the reference's body and assertions on ``repro`` and on
``repro_torch`` (``pkg`` is ``jax`` or ``torch``; the sanitizer is
``repro_torch.analysis.sanitizer``), so the two engines' sanitizer
reports are held to the same findings and counts. The sanitized soak is
``tests/test_torch_progress_stress.py``.
"""

import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

import repro.analysis.sanitizer as jsan  # noqa: E402
import repro.core.enqueue as jenq  # noqa: E402
import repro.core.progress as jpg  # noqa: E402
import repro.core.streams as jss  # noqa: E402
import repro_torch.analysis.sanitizer as tsan  # noqa: E402
import repro_torch.core.enqueue as tenq  # noqa: E402
import repro_torch.core.progress as tpg  # noqa: E402
import repro_torch.core.streams as tss  # noqa: E402

PKGS = {"jax": SimpleNamespace(pg=jpg, ss=jss, enq=jenq, san=jsan),
        "torch": SimpleNamespace(pg=tpg, ss=tss, enq=tenq, san=tsan)}


pytestmark = pytest.mark.timeout(60)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _kinds(engine):
    return sorted(f["kind"] for f in engine.sanitizer_report()["findings"])


def test_disabled_engine_reports_disabled(pkg):
    eng = pkg.pg.ProgressEngine()
    rep = eng.sanitizer_report()
    assert rep == {"enabled": False, "findings": [], "counts": {}}


def test_clean_traffic_has_zero_findings(pkg):
    """External completion, polled completion, parks, window traffic,
    progress threads — the whole public surface, all contract-clean."""
    eng = pkg.pg.ProgressEngine(sanitize=True)
    pool = pkg.ss.StreamPool()
    s = pool.create(name="san-clean")
    win_stream = pool.create(name="san-win")
    win = pkg.enq.OffloadWindow(win_stream, depth=2, engine=eng)
    eng.start_progress_thread(s, interval=0.0, park=True)

    # externally-completed request through wait_all
    r = eng.grequest_start(stream=s, name="ext")
    threading.Thread(target=lambda: (time.sleep(0.02), r.complete()), daemon=True).start()
    assert eng.wait_all([r], 10.0)

    # polled request through wait_any
    state = {"left": 2}
    rp = eng.grequest_start(
        poll_fn=lambda st: st.__setitem__("left", st["left"] - 1) or st["left"] <= 0,
        extra_state=state, stream=s, name="poll",
    )
    assert eng.wait_any([rp], 10.0) is rp

    # park/notify pair
    token = {"set": False}

    def fire():
        time.sleep(0.02)
        with eng.channel_section(s.channel):
            token["set"] = True
        eng.notify_channel(s.channel)

    threading.Thread(target=fire, daemon=True).start()
    assert eng.park_on_channel(s.channel, lambda: token["set"], 10.0)

    # window bracket
    with win.issue() as submit:
        rw = eng.grequest_start(stream=win_stream, name="win")
        submit(rw)
    rw.complete()
    win.drain(timeout=10.0)

    eng.progress()
    eng.stop_all()
    rep = eng.sanitizer_report()
    assert rep["enabled"] is True
    assert rep["findings"] == [], rep["findings"]
    assert rep["counts"]["requests_tracked"] == rep["counts"]["requests_retired"]
    assert rep["counts"]["live_requests"] == 0


def test_park_while_holding_stripe_lock_is_flagged(pkg):
    eng = pkg.pg.ProgressEngine(sanitize=True, n_stripes=8)
    with eng.channel_section(0):
        # parks on channel 1's stripe while still holding channel 0's
        assert eng.park_on_channel(1, lambda: True, timeout=1.0)
    findings = [f for f in eng.sanitizer_report()["findings"] if f["kind"] == "park-while-locked"]
    assert findings, eng.sanitizer_report()
    assert findings[0]["held_stripes"] == [0]
    assert findings[0]["kind_entered"] == "park_on_channel"


def test_wait_all_and_wait_any_while_locked_are_flagged(pkg):
    eng = pkg.pg.ProgressEngine(sanitize=True, n_stripes=8)
    s = pkg.ss.StreamPool().create(name="san-w")
    r = eng.grequest_start(stream=s, name="done-early")
    r.complete()
    with eng.channel_section(3):
        eng.wait_all([r], 0.5)
        eng.wait_any([r], 0.5)
    kinds = [
        (f["kind_entered"])
        for f in eng.sanitizer_report()["findings"]
        if f["kind"] == "park-while-locked"
    ]
    assert "wait_all" in kinds and "wait_any" in kinds


def test_lock_order_cycle_detected_without_deadlocking(pkg):
    """Two nesting orders recorded sequentially (no real deadlock) still
    produce a cycle report — the graph remembers what the timing forgave."""
    eng = pkg.pg.ProgressEngine(sanitize=True, n_stripes=4)
    with eng.channel_section(0):
        with eng.channel_section(1):
            pass
    assert _kinds(eng) == []  # one order alone is fine
    with eng.channel_section(1):
        with eng.channel_section(0):
            pass
    cycles = [f for f in eng.sanitizer_report()["findings"] if f["kind"] == "lock-order-cycle"]
    assert cycles
    assert sorted(cycles[0]["cycle"]) == [0, 1]


def test_lock_order_cycle_across_threads(pkg):
    """The graph is cross-thread: thread A takes 0→1, thread B takes 1→0,
    serialized by an event so the test itself can never deadlock."""
    eng = pkg.pg.ProgressEngine(sanitize=True, n_stripes=4)
    first_done = threading.Event()

    def a():
        with eng.channel_section(0):
            with eng.channel_section(1):
                pass
        first_done.set()

    def b():
        first_done.wait(10.0)
        with eng.channel_section(1):
            with eng.channel_section(0):
                pass

    ta, tb = threading.Thread(target=a), threading.Thread(target=b)
    ta.start(); tb.start()
    ta.join(10.0); tb.join(10.0)
    assert "lock-order-cycle" in _kinds(eng)


def test_reentrant_same_stripe_is_not_a_cycle(pkg):
    eng = pkg.pg.ProgressEngine(sanitize=True, n_stripes=4)
    with eng.channel_section(2):
        with eng.channel_section(2):
            pass
    # channels 1 and 5 share stripe 1 when n_stripes=4: also re-entrant
    with eng.channel_section(1):
        with eng.channel_section(5):
            pass
    assert _kinds(eng) == []


def test_request_leak_reported_at_stop_all(pkg):
    eng = pkg.pg.ProgressEngine(sanitize=True)
    s = pkg.ss.StreamPool().create(name="san-leak")
    eng.grequest_start(stream=s, name="leaky-req")
    done = eng.grequest_start(stream=s, name="finished")
    done.complete()
    cancelled = eng.grequest_start(stream=s, name="cancelled")
    cancelled.cancel()
    eng.stop_all()
    leaks = [f for f in eng.sanitizer_report()["findings"] if f["kind"] == "request-leak"]
    assert len(leaks) == 1, leaks
    assert leaks[0]["name"] == "leaky-req"


def test_lost_wakeup_hook_fires_only_on_true_predicate_waking_nobody(pkg):
    san = pkg.san.Sanitizer()
    san.on_notify(channel=3, true_predicates=0, woken=0)  # nothing matched: fine
    san.on_notify(channel=3, true_predicates=2, woken=2)  # matched and woken: fine
    assert san.report()["findings"] == []
    san.on_notify(channel=3, true_predicates=1, woken=0)  # the invariant breach
    findings = san.report()["findings"]
    assert [f["kind"] for f in findings] == ["lost-wakeup"]
    assert findings[0]["channel"] == 3


def test_notify_path_checks_invariant_live(pkg):
    """End-to-end: a real notify that satisfies a parked predicate is
    counted by the sanitizer and produces no finding."""
    eng = pkg.pg.ProgressEngine(sanitize=True, spin_s=0.0)
    s = pkg.ss.StreamPool().create(name="san-notify")
    token = {"set": False}

    def fire():
        time.sleep(0.05)
        with eng.channel_section(s.channel):
            token["set"] = True
        eng.notify_channel(s.channel)

    t = threading.Thread(target=fire, daemon=True)
    t.start()
    assert eng.park_on_channel(s.channel, lambda: token["set"], 10.0)
    t.join(5.0)
    rep = eng.sanitizer_report()
    assert rep["counts"]["notifies_checked"] >= 1
    assert not [f for f in rep["findings"] if f["kind"] == "lost-wakeup"]


def test_progress_thread_park_edges_are_acyclic(pkg):
    """A NULL-stream progress thread scans every stripe while parked on
    the implicit one — those implicit→stripe edges must never be reported
    as a cycle."""
    eng = pkg.pg.ProgressEngine(sanitize=True, n_stripes=4)
    s = pkg.ss.StreamPool().create(name="san-null")
    eng.start_progress_thread(pkg.pg.STREAM_NULL, interval=0.0, park=True)
    state = {"left": 3}
    r = eng.grequest_start(
        poll_fn=lambda st: st.__setitem__("left", st["left"] - 1) or st["left"] <= 0,
        extra_state=state, stream=s, name="null-covered",
    )
    assert eng.wait_all([r], 10.0)
    eng.stop_all()
    assert "lock-order-cycle" not in _kinds(eng)


def test_report_is_stable_and_dedupes_repeat_events(pkg):
    eng = pkg.pg.ProgressEngine(sanitize=True, n_stripes=8)
    for _ in range(5):  # same violation repeated: one finding
        with eng.channel_section(0):
            eng.park_on_channel(1, lambda: True, timeout=0.5)
    parks = [f for f in eng.sanitizer_report()["findings"] if f["kind"] == "park-while-locked"]
    assert len(parks) == 1
    # report() is pure: calling it twice yields the same findings
    assert eng.sanitizer_report()["findings"] == eng.sanitizer_report()["findings"]
