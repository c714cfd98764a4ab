"""The reference's progress-engine suite (``tests/test_progress_engine.py``)
over both packages: the sharded VCI runtime's lock striping under
concurrency, batched wait_fn completion, CV parking, spin-then-park, the
per-channel wait queues, wait_any, the autotuner and the stats counters.

Each case runs the reference's body and assertions on ``repro.core`` and
on ``repro_torch.core`` (``pkg`` is ``jax`` or ``torch``), so the two
engines' results and counters are held to the same values. The
reference's four ``_wait_dispatched`` cases take JAX arrays; their
counterparts here take the port's completion object, a CUDA event, as a
stand-in the test controls.
"""

import threading
import time
from types import SimpleNamespace

import pytest
import torch

pytest.importorskip("jax")

import repro.core.progress as jpg  # noqa: E402
import repro.core.streams as jss  # noqa: E402
import repro_torch.core.enqueue as tenq  # noqa: E402
import repro_torch.core.progress as tpg  # noqa: E402
import repro_torch.core.streams as tss  # noqa: E402
from test_torch_core import _StubEvent  # noqa: E402

PKGS = {"jax": SimpleNamespace(pg=jpg, ss=jss), "torch": SimpleNamespace(pg=tpg, ss=tss)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# ------------------------------------------------------------- striping


def test_stripe_table_is_fixed_and_channel_aligned(pkg):
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    streams = [pool.create() for _ in range(8)]
    # default pool + default table: every compute stream on its own stripe
    stripes = {id(eng.lock_for(s.channel)) for s in streams}
    assert len(stripes) == 8
    # the implicit channel has its own home, shared with no compute stream
    assert id(eng.lock_for(pkg.ss.STREAM_NULL.channel)) not in stripes
    # global-lock mode degenerates to one critical section
    glob = pkg.pg.ProgressEngine(global_lock=True)
    assert id(glob.lock_for(0)) == id(glob.lock_for(17)) == id(glob.lock_for(-1))


def test_concurrent_start_and_progress_8_threads(pkg):
    """8 threads hammer grequest_start + progress on their own streams;
    every request completes exactly once and the counters add up."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    per_thread, n_threads = 50, 8
    streams = [pool.create() for _ in range(n_threads)]
    errors = []

    def worker(stream):
        try:
            for _ in range(per_thread):
                hits = {"n": 0}

                def poll(st):
                    st["n"] += 1
                    return st["n"] >= 2

                r = eng.grequest_start(poll_fn=poll, extra_state=hits, stream=stream)
                while not r.done:
                    eng.progress(stream)
                assert hits["n"] == 2
        except Exception as e:  # surfaced below; a daemon assert would vanish
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in streams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    st = eng.stats(per_stripe=True)
    total = per_thread * n_threads
    assert st["completions"] == total
    assert st["enqueued"] == total
    assert st["polls"] == 2 * total
    # striped: each thread's work stayed on its own stripe
    busy = [row for row in st["stripes"] if row["completions"]]
    assert len(busy) == n_threads
    assert all(row["pending"] == 0 for row in st["stripes"])


# ------------------------------------------------------------- batching


def test_batched_wait_fn_per_stream_groups(pkg):
    """Requests sharing a wait_fn are waited as whole per-stream batches:
    one call per stream, covering all of that stream's states."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s1, s2 = pool.create(), pool.create()
    calls = []

    def wait_fn(states, timeout):
        calls.append(list(states))
        for st in states:
            st["done"] = True

    def poll(st):
        return st.get("done", False)

    reqs = [
        eng.grequest_start(poll_fn=poll, wait_fn=wait_fn, extra_state={"s": i}, stream=s)
        for s in (s1, s2)
        for i in range(3)
    ]
    assert eng.wait_all(reqs, timeout=5)
    assert len(calls) == 2  # one batched call per stream
    assert sorted(len(c) for c in calls) == [3, 3]
    assert eng.stats()["completions"] == 6
    assert eng.pending() == 0  # batch-retired requests are dequeued too


# -------------------------------------------------------------- parking


def test_blocked_wait_all_parks_instead_of_polling(pkg):
    """A wait over externally-completed requests (no poll_fn) must not
    spin: it parks on a CV and is woken by grequest_complete."""
    eng = pkg.pg.ProgressEngine()
    reqs = [eng.grequest_start() for _ in range(4)]

    def completer():
        time.sleep(0.15)
        for r in reqs:
            pkg.pg.grequest_complete(r)

    threading.Thread(target=completer, daemon=True).start()
    t0 = time.monotonic()
    assert eng.wait_all(reqs, timeout=5)
    assert time.monotonic() - t0 >= 0.1  # actually blocked
    st = eng.stats()
    assert st["waiter_parks"] >= 1  # the waiter parked...
    assert st["waiter_wakes"] >= 1  # ...and was woken by completion
    assert st["polls"] == 0  # with zero request polls


def test_wait_parks_when_progress_thread_covers_stream(pkg):
    """With a progress thread owning the stream, the waiting thread parks
    even for poll_fn requests; the background thread does the polling."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s = pool.create()
    gate = threading.Event()
    r = eng.grequest_start(poll_fn=lambda st: gate.is_set(), stream=s)
    eng.start_progress_thread(s, interval=0.001)
    try:
        threading.Timer(0.1, gate.set).start()
        assert eng.wait(r, timeout=5)
        assert eng.stats()["waiter_parks"] >= 1
    finally:
        eng.stop_progress_thread(s)


def test_parked_progress_thread_idles_and_wakes_on_enqueue(pkg):
    """Empty queue → the thread parks on the stripe CV (near-zero loops);
    a new request wakes it and gets completed promptly."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s = pool.create()
    eng.start_progress_thread(s, interval=0.0, park=True)
    try:
        time.sleep(0.3)
        idle = eng.stats()
        assert idle["progress_calls"] < 50  # busy-spin would be ~10k+
        assert idle["parks"] >= 1
        r = eng.grequest_start(poll_fn=lambda st: True, stream=s)
        t0 = time.monotonic()
        while not r.done and time.monotonic() - t0 < 5:
            time.sleep(0.005)
        assert r.done  # woken thread completed it; main thread never polled
    finally:
        eng.stop_progress_thread(s)


# ---------------------------------------------------------------- stats


def test_stats_counters_exact_sequence(pkg):
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s = pool.create()
    reqs = []
    for _ in range(3):
        state = {"n": 0}

        def poll(st):
            st["n"] += 1
            return st["n"] >= 2

        reqs.append(eng.grequest_start(poll_fn=poll, extra_state=state, stream=s))
    eng.progress(s)  # visit 1: all three polled, none done
    assert eng.stats()["completions"] == 0
    eng.progress(s)  # visit 2: all three complete
    st = eng.stats()
    assert st["completions"] == 3
    assert st["polls"] == 6
    assert st["enqueued"] == 3
    assert eng.pending(s) == 0
    eng.reset_stats()
    zeroed = eng.stats()
    assert zeroed["polls"] == zeroed["completions"] == zeroed["parks"] == 0


def test_externally_completed_requests_swept_on_enqueue(pkg):
    """No progress() ever runs, yet a long-lived channel queue must not
    grow without bound: enqueueing sweeps prior externally-completed
    requests (the serving-engine usage pattern)."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s = pool.create()
    freed = []
    for i in range(100):
        r = eng.grequest_start(free_fn=freed.append, extra_state=i, stream=s)
        r.complete()
    assert eng.pending(s) <= 1  # only the newest may linger
    assert eng.stats()["completions"] >= 99
    assert freed == list(range(99))  # free_fn ran exactly once each, in order


def test_timed_out_wait_leaves_no_callbacks(pkg):
    """Repeated short-timeout waits on a long-lived request (heartbeat
    pattern) must not accumulate wake closures."""
    eng = pkg.pg.ProgressEngine()
    r = eng.grequest_start()  # never completes
    for _ in range(20):
        assert not eng.wait(r, timeout=0.001)
    # only the engine's own stripe-notify callback remains
    assert len(r._callbacks) == 1
    r.cancel()


def test_lock_waits_counted_under_contention(pkg):
    eng = pkg.pg.ProgressEngine(global_lock=True)
    stop = threading.Event()

    def holder():
        while not stop.is_set():
            with eng.lock_for(0):
                time.sleep(0.002)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    try:
        for _ in range(20):
            eng.progress()
            time.sleep(0.001)
    finally:
        stop.set()
        t.join(timeout=2)
    assert eng.stats()["lock_waits"] >= 1


# ------------------------------------------- enqueue wait_fn deadline accounting
#
# The reference's cases hand ``_wait_dispatched`` JAX-style arrays
# (``is_ready`` / ``block_until_ready``). The port's completion object is
# the CUDA event recorded after the work (``enqueue._event_of``): here a
# stand-in whose ``query()`` and ``synchronize()`` the test controls
# (``_StubEvent``). The hung-backend case is test_torch_core.py's
# ``test_wait_dispatched_honours_the_deadline``.


def test_wait_dispatched_waits_for_the_event():
    """Counterpart of ``test_wait_dispatched_blocks_backends_without_is_ready``:
    under a deadline the wait polls the event until it completes, never
    calling the work done at once; without one it synchronizes once."""
    ev = _StubEvent(pending=3)
    tenq._wait_dispatched([{"y": None, "event": ev}], timeout=0.5)
    assert ev.queries == 4 and ev.synchronized == 0  # actually waited
    ev2 = _StubEvent(pending=3)
    tenq._wait_dispatched([{"y": None, "event": ev2}], timeout=None)
    assert ev2.synchronized == 1


def test_wait_dispatched_respects_exhausted_budget_on_the_event():
    """Counterpart of ``test_wait_dispatched_respects_exhausted_budget``:
    a spent budget queries the event once and never blocks on it."""
    ev = _StubEvent(pending=10**9)
    tenq._wait_dispatched([{"y": None, "event": ev}], timeout=-0.01)
    assert ev.queries == 1 and ev.synchronized == 0


def test_wait_dispatched_deadline_accounting_spans_batch_of_events():
    """Counterpart of ``test_wait_dispatched_deadline_accounting_spans_batch``:
    the deadline is a batch budget, so once the first event has spent it
    the later ones are neither queried nor synchronized; an item with
    nothing to wait on (a host value) completes without ending the batch,
    whose later events are still waited."""
    never, tail = _StubEvent(pending=10**9), _StubEvent(pending=0)
    t0 = time.monotonic()
    tenq._wait_dispatched([{"y": None, "event": never}, {"y": None, "event": tail}], timeout=0.05)
    assert time.monotonic() - t0 < 1.0
    assert tail.queries == 0 and tail.synchronized == 0  # budget consumed by the first event
    tail2 = _StubEvent(pending=2)
    tenq._wait_dispatched([{"y": torch.zeros(2)}, {"y": None, "event": tail2}], timeout=None)
    assert tail2.synchronized == 1


# ----------------------------------------------------- spin-then-park


def test_spin_hit_avoids_park_and_counts(pkg):
    """A condition satisfied within the spin budget resolves with a
    spin_hit and zero parks on that stripe."""
    eng = pkg.pg.ProgressEngine(spin_s=0.5, adaptive_spin=False)
    flag = [False]

    def arm():
        time.sleep(0.02)
        flag[0] = True
        eng.notify_channel(3)

    t = threading.Thread(target=arm, daemon=True)
    t.start()
    assert eng.park_on_channel(3, lambda: flag[0], timeout=5.0)
    t.join()
    st = eng.stats()
    assert st["spin_hits"] == 1
    assert st["parks"] == 0


def test_spin_disabled_forces_park(pkg):
    eng = pkg.pg.ProgressEngine(spin_s=0.0)
    flag = [False]

    def arm():
        time.sleep(0.05)
        flag[0] = True
        eng.notify_channel(3)

    t = threading.Thread(target=arm, daemon=True)
    t.start()
    assert eng.park_on_channel(3, lambda: flag[0], timeout=5.0)
    t.join()
    st = eng.stats()
    assert st["spin_hits"] == 0
    assert st["parks"] >= 1


def test_adaptive_spin_budget_grows_on_hits_and_shrinks_on_parks(pkg):
    eng = pkg.pg.ProgressEngine(spin_s=1e-3, adaptive_spin=True)
    stripe = eng._stripe(5)
    assert stripe.spin_budget == pytest.approx(1e-3)
    # hits: budget grows toward spin_s * _SPIN_GROW_MAX
    for _ in range(6):
        assert eng.park_on_channel(5, lambda: True, timeout=1.0)
    grown = stripe.spin_budget
    assert grown > 1e-3
    assert grown <= 1e-3 * pkg.pg._SPIN_GROW_MAX + 1e-12
    # misses (timeout without the condition): budget shrinks, floored
    for _ in range(8):
        assert not eng.park_on_channel(5, lambda: False, timeout=0.01)
    shrunk = stripe.spin_budget
    assert shrunk < grown
    assert shrunk >= 1e-3 / pkg.pg._SPIN_SHRINK_MAX - 1e-12
    st = eng.stats()
    assert st["spin_hits"] >= 6 and st["parks"] >= 1


def test_configure_retunes_spin_live(pkg):
    eng = pkg.pg.ProgressEngine(spin_s=1e-3)
    eng.configure(spin_s=0.0)
    assert not eng.park_on_channel(2, lambda: False, timeout=0.01)
    st = eng.stats()
    assert st["spin_hits"] == 0 and st["parks"] >= 1
    eng.configure(spin_s=0.25, adaptive_spin=False)
    assert eng.park_on_channel(2, lambda: True, timeout=1.0)
    assert eng.stats()["spin_hits"] == 1


def test_waiter_spin_hit_counted_separately(pkg):
    """wait_all resolving within the waiter spin window records a
    waiter_spin_hit instead of a waiter_park."""
    eng = pkg.pg.ProgressEngine(spin_s=0.5, adaptive_spin=False)
    r = eng.grequest_start(name="ext")

    def completer():
        time.sleep(0.02)
        r.complete()

    t = threading.Thread(target=completer, daemon=True)
    t.start()
    assert eng.wait_all([r], timeout=5.0)
    t.join()
    st = eng.stats()
    assert st["waiter_spin_hits"] == 1
    assert st["waiter_parks"] == 0


def test_channel_affinity_stack_per_thread(pkg):
    eng = pkg.pg.ProgressEngine()
    assert eng.thread_channel() is None
    eng.bind_thread_to_channel(4)
    eng.bind_thread_to_channel(9)  # nested comm membership
    assert eng.thread_channel() == 9
    seen = []

    def other():
        seen.append(eng.thread_channel())  # bindings are thread-local

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert seen == [None]
    assert eng.unbind_thread_channel() == 9
    assert eng.thread_channel() == 4
    assert eng.unbind_thread_channel() == 4
    assert eng.unbind_thread_channel() is None


# ----------------------------------------------------- per-channel wait queues


def test_notify_wakes_only_matching_waiter(pkg):
    """Two waiters parked on the same channel with different predicates:
    a notify satisfying one must wake exactly that one (the other stays
    parked — notify_skips counts it)."""
    eng = pkg.pg.ProgressEngine(spin_s=0.0)
    flags = {"a": False, "b": False}
    done = []

    def parker(key):
        assert eng.park_on_channel(7, lambda k=key: flags[k], timeout=10.0)
        done.append(key)

    ts = [threading.Thread(target=parker, args=(k,), daemon=True) for k in ("a", "b")]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    while eng.stats()["parks"] < 2 and time.monotonic() < deadline:
        time.sleep(0.005)
    with eng.channel_section(7):
        flags["b"] = True
    eng.notify_channel(7)
    t_b = time.monotonic()
    while "b" not in done and time.monotonic() - t_b < 5:
        time.sleep(0.005)
    assert done == ["b"]  # only the satisfied waiter woke
    st = eng.stats()
    assert st["notify_wakeups"] >= 1
    assert st["notify_skips"] >= 1  # waiter 'a' was evaluated and left asleep
    with eng.channel_section(7):
        flags["a"] = True
    eng.notify_channel(7)
    for t in ts:
        t.join(timeout=5)
    assert sorted(done) == ["a", "b"]


def test_notify_other_channel_leaves_waiter_parked(pkg):
    """A waiter on channel A must not wake for a notify on channel B even
    when both channels share a stripe (the cross-channel herd)."""
    eng = pkg.pg.ProgressEngine(n_stripes=1, spin_s=0.0)  # every channel, one stripe
    flag = [False]
    out = []

    def parker():
        out.append(eng.park_on_channel(3, lambda: flag[0], timeout=1.0))

    t = threading.Thread(target=parker, daemon=True)
    t.start()
    deadline = time.monotonic() + 5
    while eng.stats()["parks"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    for _ in range(10):
        eng.notify_channel(5)  # same stripe, different channel
    st = eng.stats()
    assert st["notify_wakeups"] == 0  # none of those notifies woke anyone
    flag[0] = True
    eng.notify_channel(3)
    t.join(timeout=5)
    assert out == [True]


def test_legacy_stripe_cv_mode_broadcasts(pkg):
    """wait_queues=False keeps the pre-queue behaviour: every notify wakes
    every parked thread on the stripe (the herd baseline the benchmark
    measures against)."""
    eng = pkg.pg.ProgressEngine(spin_s=0.0, wait_queues=False)
    release = [False]
    n = 4

    def parker():
        eng.park_on_channel(2, lambda: release[0], timeout=10.0)

    ts = [threading.Thread(target=parker, daemon=True) for _ in range(n)]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    while eng.stats()["parks"] < n and time.monotonic() < deadline:
        time.sleep(0.005)
    eng.notify_channel(2)  # satisfies nobody, yet wakes all four
    time.sleep(0.1)
    st = eng.stats()
    assert st["notify_wakeups"] >= n  # the herd, counted
    release[0] = True
    eng.notify_channel(2)
    for t in ts:
        t.join(timeout=5)


def test_consuming_predicate_runs_to_true_exactly_once(pkg):
    """A side-effecting predicate (mailbox match-and-pop shape): one
    notify with one token wakes exactly one of several identical
    waiters, and the token is consumed exactly once."""
    eng = pkg.pg.ProgressEngine(spin_s=0.0)
    tokens = []
    got = []

    def pred():
        if tokens:
            got.append(tokens.pop())
            return True
        return False

    ts = [
        threading.Thread(
            target=lambda: eng.park_on_channel(9, pred, timeout=2.0), daemon=True
        )
        for _ in range(3)
    ]
    for t in ts:
        t.start()
    deadline = time.monotonic() + 5
    while eng.stats()["parks"] < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    with eng.channel_section(9):
        tokens.append("tok")
    eng.notify_channel(9)
    for t in ts:
        t.join(timeout=5)
    assert got == ["tok"]  # popped once; the other two waiters timed out
    assert tokens == []


# --------------------------------------------------------------- wait_any


def _ext(eng, **kw):
    return eng.grequest_start(**kw)


@pytest.mark.parametrize(
    "case",
    [
        "empty",
        "all_done_lowest_index",
        "first_completion_order",
        "cancel_counts",
        "timeout_none",
    ],
)
def test_wait_any_table(pkg, case):
    """Table-driven wait_any semantics (MPI_Waitany)."""
    eng = pkg.pg.ProgressEngine()
    if case == "empty":
        assert eng.wait_any([], timeout=1.0) is None
    elif case == "all_done_lowest_index":
        reqs = [_ext(eng) for _ in range(3)]
        reqs[2].complete()
        reqs[1].complete()
        assert eng.wait_any(reqs, timeout=1.0) is reqs[1]  # lowest done index
        reqs[0].cancel()
    elif case == "first_completion_order":
        reqs = [_ext(eng) for _ in range(3)]
        threading.Timer(0.05, reqs[1].complete).start()
        got = eng.wait_any(reqs, timeout=5.0)
        assert got is reqs[1]
        assert not reqs[0].done and not reqs[2].done  # others untouched
        for r in (reqs[0], reqs[2]):
            r.cancel()
    elif case == "cancel_counts":
        reqs = [_ext(eng) for _ in range(2)]
        threading.Timer(0.05, reqs[0].cancel).start()
        got = eng.wait_any(reqs, timeout=5.0)
        assert got is reqs[0] and got._state is pkg.pg.RequestState.CANCELLED
        reqs[1].cancel()
    elif case == "timeout_none":
        reqs = [_ext(eng) for _ in range(2)]
        t0 = time.monotonic()
        assert eng.wait_any(reqs, timeout=0.05) is None
        assert time.monotonic() - t0 < 2.0
        for r in reqs:
            r.cancel()


def test_wait_any_timeout_vs_completion_race_never_loses(pkg):
    """A completion racing the deadline is either reported (the request)
    or not (None with the request still done) — never an exception, and
    the final re-read means a callback that landed before the deadline
    check is returned."""
    eng = pkg.pg.ProgressEngine(spin_s=0.0)
    for i in range(30):
        r = _ext(eng)
        threading.Timer(0.01, r.complete).start()
        got = eng.wait_any([r], timeout=0.01)
        assert got is r or got is None
        if got is None:
            # the completion may land just after; it is never half-reported
            eng.wait(r, timeout=5.0)
        assert r.done
        assert len(r._callbacks) <= 1  # wait_any detached its wake closure


def test_wait_any_polls_uncovered_streams(pkg):
    """poll_fn requests with no covering progress thread: wait_any must
    actively progress the pending streams rather than park forever."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s1, s2 = pool.create(), pool.create()
    state = {"n": 0}

    def poll(st):
        st["n"] += 1
        return st["n"] >= 3

    r_slow = eng.grequest_start(poll_fn=lambda st: False, stream=s1)
    r_fast = eng.grequest_start(poll_fn=poll, extra_state=state, stream=s2)
    got = eng.wait_any([r_slow, r_fast], timeout=10.0)
    assert got is r_fast
    r_slow.cancel()


def test_wait_any_parks_when_covered(pkg):
    """Externally-completed requests: the waiter parks (no polling) and
    the first completion wakes it."""
    eng = pkg.pg.ProgressEngine(spin_s=0.0)
    reqs = [_ext(eng) for _ in range(3)]
    threading.Timer(0.15, reqs[2].complete).start()
    t0 = time.monotonic()
    got = eng.wait_any(reqs, timeout=5.0)
    assert got is reqs[2]
    assert time.monotonic() - t0 >= 0.1
    st = eng.stats()
    assert st["waiter_parks"] >= 1 and st["polls"] == 0
    for r in reqs[:2]:
        r.cancel()


# -------------------------------------------------------------- autotuner


def test_autotune_policy_validates(pkg):
    with pytest.raises(ValueError, match="hysteresis band"):
        pkg.pg.AutotunePolicy(promote_score=1.0, demote_score=1.0)
    with pytest.raises(ValueError, match="streak"):
        pkg.pg.AutotunePolicy(hysteresis_up=0)
    with pytest.raises(ValueError, match="max_threads"):
        pkg.pg.AutotunePolicy(max_threads=0)


def test_autotuner_promotes_hot_and_demotes_idle(pkg):
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    hot, idle = pool.create(), pool.create()
    tuner = eng.autotune(
        pkg.pg.AutotunePolicy(promote_score=2.0, demote_score=0.0, hysteresis_up=2, hysteresis_down=2)
    )
    keep = []

    def burst():
        for _ in range(4):
            keep.append(eng.grequest_start(poll_fn=lambda st: True, stream=hot))

    # two hot ticks -> promote (and only the hot channel)
    burst()
    r1 = tuner.tick()
    assert r1["promoted"] == [] and tuner.placements() == []
    burst()
    r2 = tuner.tick()
    assert r2["promoted"] == [hot.channel]
    assert tuner.placements() == [hot.channel]
    assert eng.has_poller(hot.channel) and not eng.has_poller(idle.channel)
    # the promoted thread retires the pending burst without any waiter
    deadline = time.monotonic() + 5
    while any(not r.done for r in keep) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert all(r.done for r in keep)
    # idle ticks -> demote after the down-hysteresis (the first post-burst
    # tick still sees the promoted thread's own retirement polls, so the
    # idle streak starts one tick later)
    tuner.tick()  # absorbs the retirement-poll delta
    tuner.tick()
    assert tuner.placements() == [hot.channel]  # one idle tick: still held
    r5 = tuner.tick()
    assert r5["demoted"] == [hot.channel]
    assert tuner.placements() == []
    assert not eng.has_poller(hot.channel)
    st = tuner.stats()
    assert st["promotions"] == 1 and st["demotions"] == 1 and st["ticks"] == 5


def test_autotuner_hysteresis_band_prevents_flapping(pkg):
    """Scores oscillating inside the (demote, promote) band must not
    change placement in either direction."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s = pool.create()
    tuner = eng.autotune(
        pkg.pg.AutotunePolicy(promote_score=10.0, demote_score=0.0, hysteresis_up=2, hysteresis_down=2)
    )
    keep = []
    for _ in range(12):  # 12 ticks of mid-band activity (score ~2 each)
        keep.append(eng.grequest_start(poll_fn=lambda st: True, stream=s))
        eng.progress(s)
        tuner.tick()
    assert tuner.stats()["promotions"] == 0
    assert tuner.placements() == []


def test_autotuner_respects_hand_placed_threads_and_cap(pkg):
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    hand = pool.create()
    others = [pool.create() for _ in range(3)]
    eng.start_progress_thread(hand, interval=0.0)
    try:
        tuner = eng.autotune(
            pkg.pg.AutotunePolicy(
                promote_score=1.0, demote_score=0.0, hysteresis_up=1, max_threads=2
            )
        )
        keep = []
        for s in [hand] + others:
            for _ in range(3):
                keep.append(eng.grequest_start(poll_fn=lambda st: True, stream=s))
        tuner.tick()
        placed = tuner.placements()
        assert hand.channel not in placed  # hand placement respected
        assert len(placed) == 2  # capped at max_threads
        tuner.stop()
        assert tuner.placements() == []
    finally:
        eng.stop_all()


def test_autotuner_never_adopts_foreign_thread(pkg):
    """Regression: a hand-placed thread that is spun down (IDLE) makes
    has_poller False, so the tuner tries to promote — start_progress_thread
    refuses (channel occupied) and the tuner must NOT adopt it: demoting
    later would stop a thread the user owns."""
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s = pool.create()
    assert eng.start_progress_thread(s, interval=0.0) is True
    assert eng.start_progress_thread(s, interval=0.0) is False  # already placed
    hand = eng._threads[s.channel]
    hand.spin_down()  # IDLE: has_poller() goes False
    try:
        tuner = eng.autotune(
            pkg.pg.AutotunePolicy(promote_score=1.0, demote_score=0.0, hysteresis_up=1, hysteresis_down=1)
        )
        keep = [eng.grequest_start(poll_fn=lambda st: True, stream=s) for _ in range(4)]
        tuner.tick()
        assert tuner.placements() == []  # refused, not adopted
        assert tuner.stats()["promotions"] == 0
        for _ in range(3):  # idle ticks must not demote the user's thread
            tuner.tick()
        assert s.channel in eng._threads and eng._threads[s.channel] is hand
        hand.spin_up()
        for r in keep:
            assert eng.wait(r, timeout=5.0)
    finally:
        eng.stop_all()


def test_autotuner_background_start_stop(pkg):
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    s = pool.create()
    tuner = eng.autotune(
        pkg.pg.AutotunePolicy(interval=0.01, promote_score=1.0, hysteresis_up=1)
    )
    tuner.start()
    tuner.start()  # idempotent
    keep = [eng.grequest_start(poll_fn=lambda st: True, stream=s) for _ in range(5)]
    deadline = time.monotonic() + 5
    while not tuner.placements() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert tuner.placements() == [s.channel]
    tuner.stop()
    assert tuner.placements() == []
    assert not eng.has_poller(s.channel)
    assert tuner.stats()["ticks"] >= 1
    assert all(r.done for r in keep)


# ------------------------------------------------- spin-budget feedback


def _feed_spin_outcomes(eng, hits=0, parks=0):
    """White-box: credit blocked-caller outcomes to the meta counters the
    tuner samples (the real paths increment these in wait/park loops)."""
    with eng._meta_lock:
        eng._waiter_spin_hits += hits
        eng._waiter_parks += parks


def test_spin_tuner_grows_on_hit_ratio(pkg):
    eng = pkg.pg.ProgressEngine(spin_s=1e-5)
    tuner = eng.autotune(pkg.pg.AutotunePolicy(tune_spin=True, spin_hi=0.6, spin_lo=0.2))
    _feed_spin_outcomes(eng, hits=8, parks=2)  # ratio 0.8 >= hi
    tuner.tick()
    assert eng.spin_s == pytest.approx(2e-5)  # x spin_grow
    st = tuner.stats()
    assert st["spin_grows"] == 1 and st["spin_shrinks"] == 0
    assert st["spin_s"] == pytest.approx(2e-5)
    # the delta was consumed: a quiet tick holds the budget
    tuner.tick()
    assert eng.spin_s == pytest.approx(2e-5)


def test_spin_tuner_shrinks_on_park_ratio_and_clamps_at_min(pkg):
    eng = pkg.pg.ProgressEngine(spin_s=4e-6)
    tuner = eng.autotune(
        pkg.pg.AutotunePolicy(tune_spin=True, spin_lo=0.2, spin_min=1e-6, spin_shrink=0.5)
    )
    _feed_spin_outcomes(eng, hits=1, parks=9)  # ratio 0.1 <= lo
    tuner.tick()
    assert eng.spin_s == pytest.approx(2e-6)
    _feed_spin_outcomes(eng, hits=0, parks=10)
    tuner.tick()
    assert eng.spin_s == pytest.approx(1e-6)  # hit the floor
    _feed_spin_outcomes(eng, hits=0, parks=10)
    tuner.tick()
    assert eng.spin_s == pytest.approx(1e-6)  # clamped, no further shrink
    assert tuner.stats()["spin_shrinks"] == 2


def test_spin_tuner_clamps_at_max(pkg):
    eng = pkg.pg.ProgressEngine(spin_s=6e-4)
    tuner = eng.autotune(pkg.pg.AutotunePolicy(tune_spin=True, spin_max=1e-3))
    _feed_spin_outcomes(eng, hits=10)
    tuner.tick()
    assert eng.spin_s == pytest.approx(1e-3)  # capped, not 1.2e-3
    _feed_spin_outcomes(eng, hits=10)
    tuner.tick()
    assert eng.spin_s == pytest.approx(1e-3)
    assert tuner.stats()["spin_grows"] == 1  # the at-cap tick is not a move


def test_spin_tuner_never_reenables_spin_zero(pkg):
    """spin_s=0 is an explicit never-spin choice (pure parking); feedback
    must not overrule it no matter how hit-heavy the window looks."""
    eng = pkg.pg.ProgressEngine(spin_s=0.0)
    tuner = eng.autotune(pkg.pg.AutotunePolicy(tune_spin=True))
    _feed_spin_outcomes(eng, hits=100)
    tuner.tick()
    assert eng.spin_s == 0.0
    assert tuner.stats()["spin_grows"] == 0


def test_spin_tuner_holds_below_sample_floor_and_when_disabled(pkg):
    eng = pkg.pg.ProgressEngine(spin_s=1e-5)
    tuner = eng.autotune(pkg.pg.AutotunePolicy(tune_spin=True, spin_samples=4))
    _feed_spin_outcomes(eng, hits=3)  # 3 outcomes < spin_samples: noise
    tuner.tick()
    assert eng.spin_s == pytest.approx(1e-5)
    # a window with enough outcomes moves (the held tick reset the baseline)
    _feed_spin_outcomes(eng, hits=5)
    tuner.tick()
    assert eng.spin_s == pytest.approx(2e-5)

    eng2 = pkg.pg.ProgressEngine(spin_s=1e-5)
    tuner2 = eng2.autotune(pkg.pg.AutotunePolicy())  # tune_spin defaults off
    _feed_spin_outcomes(eng2, hits=100)
    tuner2.tick()
    assert eng2.spin_s == pytest.approx(1e-5)
    assert "spin_s" in tuner2.stats()  # surfaced either way


def test_spin_policy_validates(pkg):
    with pytest.raises(ValueError, match="spin_lo"):
        pkg.pg.AutotunePolicy(spin_lo=0.7, spin_hi=0.6)
    with pytest.raises(ValueError, match="spin_grow"):
        pkg.pg.AutotunePolicy(spin_grow=1.0)
    with pytest.raises(ValueError, match="spin_min"):
        pkg.pg.AutotunePolicy(spin_min=2e-3, spin_max=1e-3)
    with pytest.raises(ValueError, match="spin_samples"):
        pkg.pg.AutotunePolicy(spin_samples=0)


def test_per_channel_stats_view(pkg):
    eng = pkg.pg.ProgressEngine()
    pool = pkg.ss.StreamPool()
    a, b = pool.create(), pool.create()
    for _ in range(3):
        eng.grequest_start(poll_fn=lambda st: True, stream=a)
    eng.grequest_start(poll_fn=lambda st: False, stream=b)
    eng.progress(a)
    st = eng.stats(per_channel=True)["channels"]
    assert st[a.channel]["enqueued"] == 3
    assert st[a.channel]["polls"] == 3
    assert st[a.channel]["pending"] == 0
    assert st[b.channel]["enqueued"] == 1 and st[b.channel]["pending"] == 1
    eng.reset_stats()
    assert eng.stats(per_channel=True)["channels"].get(a.channel, {"enqueued": 0})["enqueued"] == 0


def test_channel_section_counts_contention(pkg):
    eng = pkg.pg.ProgressEngine()
    hold = threading.Event()
    release = threading.Event()

    def holder():
        with eng.channel_section(6):
            hold.set()
            release.wait(timeout=5.0)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    hold.wait(timeout=5.0)

    def contender():
        with eng.channel_section(6):
            pass

    t2 = threading.Thread(target=contender, daemon=True)
    t2.start()
    time.sleep(0.05)
    release.set()
    t.join(timeout=5.0)
    t2.join(timeout=5.0)
    assert eng.stats()["lock_waits"] >= 1
