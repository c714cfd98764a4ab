"""The reference's concurrency soak of the progress runtime
(``tests/test_progress_stress.py``) on the port, every schedule under the
lock/park sanitizer (``ProgressEngine(sanitize=True)``).

Deterministic-seed randomized schedules: N worker threads × M channels
churn generalized requests (polled, externally completed, batch-waited),
park/notify pairs, offload-window admissions and channel affinity
bind/unbind, while a chaos thread starts and stops progress threads and
ticks the autotuner, all on one engine; the ``schedule`` and
``large-coll`` configs add threadcomm ranks replaying a recorded
ping-pong or a Rabenseifner allreduce against the eager exchange. The
configs and the seeds are the reference's: 8 configs × 20 seeds, and the
fault-injected soak's 5 seeds (which the reference runs only under
``pytest --faults``; here it always runs). Every schedule asserts the
runtime's invariants:

* **no deadlock**: every thread joins within 10 s;
* **no lost wakeups**: every blocking call (wait/wait_all/wait_any,
  park_on_channel, window reserve, the ranks' sends, receives and
  barriers) returns success within 10 s;
* **counter conservation**: at quiescence everything admitted was
  retired (engine ``enqueued == completions``, nothing pending; window
  ``admitted == reaped``, nothing in flight);
* **a clean sanitizer report**: zero findings, no live request.
"""

import threading
import time
from collections import deque
from random import Random

import pytest

from repro_torch.core import progress as pg
from repro_torch.core import streams as ss
from repro_torch.core.enqueue import OffloadWindow

# Watchdog for any single blocking op or join; a wakeup lost anywhere
# turns into a timeout here, well inside the per-test timeout marker.
_OP_TIMEOUT = 10.0
_JOIN_TIMEOUT = 10.0

CONFIGS = {
    # per-channel wait queues (the default runtime), chaos + autotuner
    "waitq": dict(engine=dict(), n_threads=4, n_channels=3, chaos=True, autotune=True),
    # no spin: every blocked caller pays a real park (max CV traffic)
    "waitq-park": dict(
        engine=dict(spin_s=0.0), n_threads=4, n_channels=2, chaos=True, autotune=False
    ),
    # the legacy stripe-CV broadcast must stay correct too (herd baseline)
    "legacy-cv": dict(
        engine=dict(wait_queues=False), n_threads=3, n_channels=2, chaos=True, autotune=False
    ),
    # every channel on ONE stripe: maximum cross-channel interference
    "one-stripe": dict(
        engine=dict(n_stripes=1, spin_s=0.0), n_threads=4, n_channels=3, chaos=False,
        autotune=True,
    ),
    # pre-VCI global critical section
    "global-lock": dict(
        engine=dict(global_lock=True), n_threads=3, n_channels=2, chaos=False, autotune=False
    ),
    # default runtime under the lock/park sanitizer: the recorder watches
    # every stripe acquisition, park entry, notify and request lifecycle,
    # and the test asserts it ends with ZERO findings — the soak traffic
    # is certified contract-clean, not just deadlock-free-this-time
    "sanitized": dict(
        engine=dict(sanitize=True), n_threads=4, n_channels=3, chaos=True, autotune=True
    ),
    # recorded-schedule replay under chaos: two threadcomm ranks record a
    # scheduled ping-pong + barrier, then replay it repeatedly while the
    # chaos thread churns progress-thread placement and the autotuner
    # ticks, with regular request churn alongside — every replay's output
    # must equal the eager exchange, and the sanitizer must end clean
    "schedule": dict(
        engine=dict(sanitize=True), n_threads=2, n_channels=2, chaos=True,
        autotune=True, schedule=True,
    ),
    # large-collective schedule under chaos: three ranks record a ring
    # Rabenseifner allreduce (the reduce-scatter + allgather hop graph of
    # core.threadcoll) and replay it on fresh bindings while the chaos
    # thread churns progress placement — every replay must be
    # byte-identical to the eager collective on the same data, and the
    # sanitizer must end with zero findings
    "large-coll": dict(
        engine=dict(sanitize=True), n_threads=2, n_channels=2, chaos=True,
        autotune=True, large_coll=True,
    ),
}
SEEDS = range(20)  # 8 configs x 20 seeds = 160 schedules, the reference's


class _Completer(threading.Thread):
    """Services externally-completed work with small seeded delays:
    grequests to complete, park tokens to set+notify."""

    def __init__(self, engine, seed):
        super().__init__(daemon=True, name="stress-completer")
        self.engine = engine
        self.rng = Random(seed ^ 0xC0FFEE)
        self.queue: deque = deque()
        self.lock = threading.Lock()
        self.stop_evt = threading.Event()

    def submit(self, kind, payload) -> None:
        with self.lock:
            self.queue.append((kind, payload))

    def run(self) -> None:
        while True:
            with self.lock:
                item = self.queue.popleft() if self.queue else None
            if item is None:
                if self.stop_evt.is_set():
                    return
                time.sleep(0.0005)
                continue
            if self.rng.random() < 0.5:
                time.sleep(self.rng.random() * 0.002)
            kind, payload = item
            if kind == "complete":
                payload.complete()
            else:  # ("park", (channel, token))
                ch, token = payload
                with self.engine.channel_section(ch):
                    token["set"] = True
                self.engine.notify_channel(ch)


def _worker(engine, streams, window, completer, seed, tid, n_ops, errors):
    rng = Random((seed << 8) | tid)
    try:
        for op_i in range(n_ops):
            stream = rng.choice(streams)
            op = rng.choice(
                ["greq_poll", "greq_ext", "park", "window", "affinity", "progress"]
            )
            if op == "greq_poll":
                state = {"left": rng.randint(1, 3)}

                def poll(st):
                    st["left"] -= 1
                    return st["left"] <= 0

                r = engine.grequest_start(poll_fn=poll, extra_state=state, stream=stream)
                mode = rng.choice(["wait", "wait_all", "wait_any"])
                if mode == "wait":
                    assert engine.wait(r, _OP_TIMEOUT), "lost wakeup: wait(poll)"
                elif mode == "wait_all":
                    assert engine.wait_all([r], _OP_TIMEOUT), "lost wakeup: wait_all(poll)"
                else:
                    assert engine.wait_any([r], _OP_TIMEOUT) is r, "lost wakeup: wait_any(poll)"
            elif op == "greq_ext":
                r = engine.grequest_start(stream=stream, name=f"ext-{tid}-{op_i}")
                completer.submit("complete", r)
                if rng.random() < 0.5:
                    assert engine.wait_all([r], _OP_TIMEOUT), "lost wakeup: wait_all(ext)"
                else:
                    assert engine.wait_any([r], _OP_TIMEOUT) is r, "lost wakeup: wait_any(ext)"
            elif op == "park":
                ch = stream.channel
                token = {"set": False}
                completer.submit("park", (ch, token))
                ok = engine.park_on_channel(ch, lambda t=token: t["set"], _OP_TIMEOUT)
                assert ok, "lost wakeup: park_on_channel"
            elif op == "window":
                ok = window.reserve(timeout=_OP_TIMEOUT)
                assert ok, "lost wakeup: window.reserve"
                r = engine.grequest_start(stream=window.stream, name=f"win-{tid}-{op_i}")
                window.register(r, value=(tid, op_i))
                completer.submit("complete", r)
                if rng.random() < 0.3:
                    window.reap()
            elif op == "affinity":
                ch = stream.channel
                engine.bind_thread_to_channel(ch)
                try:
                    assert engine.thread_channel() == ch
                    engine.progress(stream)
                finally:
                    assert engine.unbind_thread_channel(ch) == ch
            else:  # progress
                engine.progress(stream if rng.random() < 0.7 else None)
    except BaseException as e:  # surfaced by the test thread
        errors.append((tid, e))


def _schedule_worker(comm, rank, seed, n_replays, errors):
    """One threadcomm rank of the recorded-schedule soak: record a
    ping-pong + barrier once, then replay it ``n_replays`` times with
    fresh bindings, asserting every replay's output equals the eager
    exchange it stands for (the peer replays in lockstep, so replay i's
    reply must be the peer's bound payload for step i)."""
    from repro_torch.core import threadcoll as tc
    from repro_torch.core.schedule import Schedule

    rng = Random((seed << 4) | rank)
    peer = 1 - rank
    try:
        h = comm.attach(rank)
        try:
            sched = Schedule(engine=comm.engine, stream=h.stream, name=f"soak-sched-r{rank}")
            rec = sched.record()
            try:
                if rank == 0:
                    h.send_scheduled(sched, peer, ("rec", 0), tag=101, bind="msg")
                    got = h.recv_scheduled(sched, peer, tag=102, out="reply", timeout=_OP_TIMEOUT)
                else:
                    got = h.recv_scheduled(sched, peer, tag=101, out="reply", timeout=_OP_TIMEOUT)
                    h.send_scheduled(sched, peer, ("rec", 1), tag=102, bind="msg")
                tc.record_barrier(h, sched, timeout=_OP_TIMEOUT)
                rec.seal()
            finally:
                rec.abort()
            assert got == ("rec", peer), f"record pass saw {got!r}"
            for i in range(n_replays):
                ctx = sched.replay(binding={"msg": (rank, i)}, timeout=_OP_TIMEOUT)
                assert ctx.outputs["reply"] == (peer, i), (
                    f"replay {i} diverged from eager: {ctx.outputs['reply']!r}"
                )
                if rng.random() < 0.3:
                    time.sleep(rng.random() * 0.002)
            assert sched.stats()["replays"] == n_replays
        finally:
            h.detach()
    except BaseException as e:
        errors.append((f"sched-r{rank}", e))


def _large_coll_worker(comm, rank, seed, n_replays, errors):
    """One threadcomm rank of the large-collective schedule soak: record
    a Rabenseifner ``allreduce_large`` (ring reduce-scatter + allgather)
    once, then replay it on fresh bindings under chaos, asserting every
    replay is byte-identical to the eager collective on the same data
    (same hop graph, same fold order)."""
    import numpy as np

    from repro_torch.core import threadcoll as tc
    from repro_torch.core.schedule import Schedule

    rng = Random((seed << 4) | rank)
    try:
        h = comm.attach(rank)
        try:
            base = (
                np.random.default_rng((seed << 8) | rank)
                .standard_normal(257)
                .astype(np.float32)
            )
            sched = Schedule(engine=comm.engine, stream=h.stream, name=f"soak-lc-r{rank}")
            rec = sched.record()
            try:
                rec_out = tc.record_allreduce_large(
                    h, sched, base, bind="x", out="y", timeout=_OP_TIMEOUT
                )
                rec.seal()
            finally:
                rec.abort()
            eager0 = tc.allreduce_large(h, base, timeout=_OP_TIMEOUT)
            assert np.array_equal(rec_out, eager0), "record pass diverged from eager"
            for i in range(n_replays):
                data = base * (i + 2)
                eager = tc.allreduce_large(h, data, timeout=_OP_TIMEOUT)
                ctx = sched.replay(binding={"x": data}, timeout=_OP_TIMEOUT)
                assert np.array_equal(ctx.outputs["y"], eager), f"replay {i} diverged"
                if rng.random() < 0.3:
                    time.sleep(rng.random() * 0.002)
            assert sched.stats()["replays"] == n_replays
        finally:
            h.detach()
    except BaseException as e:
        errors.append((f"lc-r{rank}", e))


def _chaos(engine, streams, tuner, stop_evt, seed, errors):
    """Start/stop progress threads and tick the autotuner concurrently
    with the churn — placement changes must never strand a waiter."""
    rng = Random(seed ^ 0xD00D)
    try:
        while not stop_evt.is_set():
            roll = rng.random()
            s = rng.choice(streams)
            if roll < 0.3:
                engine.start_progress_thread(s, interval=0.0, park=True)
            elif roll < 0.6:
                engine.stop_progress_thread(s)
            elif roll < 0.8 and tuner is not None:
                tuner.tick()
            else:
                engine.stats(per_stripe=True, per_channel=True)  # reader mixes in
            time.sleep(rng.random() * 0.003)
    except BaseException as e:
        errors.append(("chaos", e))


@pytest.mark.timeout(180)
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_progress_soak(cfg_name, seed):
    cfg = CONFIGS[cfg_name]
    engine = pg.ProgressEngine(**{**cfg["engine"], "sanitize": True})  # every config under the sanitizer
    pool = ss.StreamPool()
    streams = [pool.create(name=f"soak-{i}") for i in range(cfg["n_channels"])]
    win_stream = pool.create(name="soak-win")
    window = OffloadWindow(win_stream, depth=2, engine=engine)
    tuner = (
        engine.autotune(
            pg.AutotunePolicy(promote_score=3.0, hysteresis_up=2, hysteresis_down=2, max_threads=2)
        )
        if cfg["autotune"]
        else None
    )
    completer = _Completer(engine, seed)
    completer.start()
    errors: list = []
    stop_chaos = threading.Event()
    chaos = None
    if cfg["chaos"]:
        chaos = threading.Thread(
            target=_chaos,
            args=(engine, streams + [win_stream], tuner, stop_chaos, seed, errors),
            daemon=True,
        )
        chaos.start()

    n_ops = 10
    workers = [
        threading.Thread(
            target=_worker,
            args=(engine, streams, window, completer, seed, tid, n_ops, errors),
            daemon=True,
            name=f"soak-w{tid}",
        )
        for tid in range(cfg["n_threads"])
    ]
    comm = None
    if cfg.get("schedule"):
        from repro_torch.core.threadcomm import HostThreadComm

        comm = HostThreadComm(2, engine=engine, pool=pool, name="soak-sched")
        comm.start()
        workers += [
            threading.Thread(
                target=_schedule_worker,
                args=(comm, rank, seed, 6, errors),
                daemon=True,
                name=f"soak-sched-r{rank}",
            )
            for rank in range(2)
        ]
    elif cfg.get("large_coll"):
        from repro_torch.core.threadcomm import HostThreadComm

        comm = HostThreadComm(3, engine=engine, pool=pool, name="soak-lc")
        comm.start()
        workers += [
            threading.Thread(
                target=_large_coll_worker,
                args=(comm, rank, seed, 4, errors),
                daemon=True,
                name=f"soak-lc-r{rank}",
            )
            for rank in range(3)
        ]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=_JOIN_TIMEOUT)
    hung = [w.name for w in workers if w.is_alive()]
    # -- invariant 1: no deadlock --------------------------------------
    assert not hung, f"deadlocked workers (cfg={cfg_name} seed={seed}): {hung}"
    stop_chaos.set()
    if chaos is not None:
        chaos.join(timeout=10.0)
        assert not chaos.is_alive(), "chaos thread hung"
    completer.stop_evt.set()
    completer.join(timeout=10.0)
    assert not completer.is_alive(), "completer hung with undrained queue"
    # -- invariant 2: no lost wakeups (worker asserts) -----------------
    assert not errors, f"(cfg={cfg_name} seed={seed}) {errors[0]}"

    # the scheduled ping-pong epoch closes cleanly: every recorded send
    # had its matching recorded recv, on the record pass and every replay
    if comm is not None:
        assert comm.finish(timeout=_OP_TIMEOUT) == 0

    # window drains completely
    window.drain(timeout=_OP_TIMEOUT)
    wst = window.stats(engine=False)
    assert wst["admitted"] == wst["reaped"], wst
    assert wst["in_flight"] == 0 and wst["completed_unreaped"] == 0, wst

    if tuner is not None:
        tuner.stop()
    engine.stop_all()
    # retire anything completed-but-unswept, then check conservation
    engine.progress()
    st = engine.stats()
    # -- invariant 3: counter conservation -----------------------------
    assert st["enqueued"] == st["completions"] + engine.pending(), st
    assert engine.pending() == 0, "requests left pending at quiescence"
    # every notify either woke a matching waiter or counted a skip; the
    # per-channel mode never reports more wakeups than notify decisions
    assert st["notify_wakeups"] >= 0 and st["notifies"] >= 0

    # -- invariant 4: the sanitizer certifies the contract --------------
    rep = engine.sanitizer_report()
    assert rep["findings"] == [], (
        f"sanitizer findings (cfg={cfg_name} seed={seed}): {rep['findings']}"
    )
    assert rep["counts"]["live_requests"] == 0, rep["counts"]


# ----------------------------------------------------------------------
# fault-injected soak
# ----------------------------------------------------------------------


@pytest.mark.timeout(180)
@pytest.mark.parametrize("seed", range(5))
def test_progress_soak_with_faults(seed):
    """The sanitized soak with a seeded FaultPlan layered on: stall/delay
    faults jitter ``notify_channel`` and ``window.reserve`` (widening the
    park/notify race windows), and injector-owned stall requests churn
    the queue — some completed by virtual-clock advance, the rest
    cancelled at uninstall. All four soak invariants must still hold."""
    from repro_torch.ft.faultinject import FaultInjector, FaultPlan, VirtualClock

    engine = pg.ProgressEngine(sanitize=True)
    pool = ss.StreamPool()
    streams = [pool.create(name=f"fsoak-{i}") for i in range(3)]
    win_stream = pool.create(name="fsoak-win")
    window = OffloadWindow(win_stream, depth=2, engine=engine)
    clock = VirtualClock()
    # rank -1 events match the engine/window seams (any-rank); horizon 0
    # arms everything immediately, durations stay tiny for soak speed
    plan = FaultPlan.random(
        seed, ranks=[-1], n_events=4, horizon=0.0,
        kinds=("stall_rank", "delay_rank"), max_duration=0.002,
    )
    completer = _Completer(engine, seed)
    completer.start()
    errors: list = []
    with FaultInjector(plan, clock=clock) as inject:
        inject.attach_engine(engine)
        inject.attach_window(window)
        # injector-owned churn: half complete via the clock, half are
        # still live at uninstall and must be cancelled, not leaked
        for i in range(6):
            inject.stall_request(
                engine, streams[i % 3], until=1.0 if i % 2 else 1e9,
                name=f"fsoak-stall-{i}",
            )
        workers = [
            threading.Thread(
                target=_worker,
                args=(engine, streams, window, completer, seed, tid, 10, errors),
                daemon=True,
                name=f"fsoak-w{tid}",
            )
            for tid in range(4)
        ]
        for w in workers:
            w.start()
        clock.advance(2.0)  # completes the even stall requests mid-churn
        engine.progress()
        for w in workers:
            w.join(timeout=_JOIN_TIMEOUT)
        hung = [w.name for w in workers if w.is_alive()]
        assert not hung, f"deadlocked workers (faults seed={seed}): {hung}"
        completer.stop_evt.set()
        completer.join(timeout=10.0)
        assert not completer.is_alive(), "completer hung with undrained queue"
        assert not errors, f"(faults seed={seed}) {errors[0]}"
        window.drain(timeout=_OP_TIMEOUT)
    # context exit uninstalled the seams and cancelled the odd stalls
    wst = window.stats(engine=False)
    assert wst["admitted"] == wst["reaped"], wst
    engine.stop_all()
    engine.progress()
    st = engine.stats()
    assert st["enqueued"] == st["completions"] + engine.pending(), st
    assert engine.pending() == 0, "requests left pending at quiescence"
    rep = engine.sanitizer_report()
    assert rep["findings"] == [], f"(faults seed={seed}) {rep['findings']}"
    assert rep["counts"]["live_requests"] == 0, rep["counts"]
