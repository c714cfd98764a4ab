"""The port's fault-tolerance substrates against the JAX package's: the
heartbeat detector (the cases of ``tests/test_fault_injection.py:393-469``
and ``tests/test_checkpoint_ft.py``, on the port, including thread-rank
liveness through ``HostThreadComm(heartbeat=)``), the straggler policy (the
tables of ``tests/test_straggler.py``, one parametrised test driving both
packages' classes through the same script and holding their traces
equal), and elastic re-meshing (``plan_remesh``, ``shard_slices``,
``reshard_plan`` and ``execute_reshard`` equal to the reference's). All of
it is host logic: every comparison is exact. Every wait is bounded at 10 s.
"""

import threading
import time

import numpy as np
import pytest

from repro.ft import elastic as j_elastic
from repro.ft.straggler import StragglerMonitor as JStraggler
from repro_torch.core.progress import ProgressEngine
from repro_torch.core.threadcomm import HostThreadComm
from repro_torch.ft import elastic as t_elastic
from repro_torch.ft.faultinject import VirtualClock
from repro_torch.ft.heartbeat import HeartbeatMonitor
from repro_torch.ft.straggler import Advice, StragglerMonitor as TStraggler

WAIT_S = 10.0


# ------------------------------------------------------------- heartbeat


def test_heartbeat_detects_silent_rank():
    clock = {"t": 0.0}
    eng = ProgressEngine()
    failures = []
    mon = HeartbeatMonitor(ranks=[0, 1, 2], timeout=10.0, engine=eng, on_failure=failures.append,
                           clock=lambda: clock["t"])
    for t in (5.0, 9.0):
        clock["t"] = t
        mon.record(0)
        mon.record(1)  # rank 2 silent
        assert mon.check() == []
    clock["t"] = 11.0
    mon.record(0)
    mon.record(1)
    assert mon.check() == [2]
    assert failures == [[2]]
    mon.stop()
    eng.stop_all()


def test_heartbeat_remove_rank_poll_race_regression():
    """A rank deregistered between the detector's deadline scan and its
    report must not trip on_failure."""
    clock = VirtualClock()
    engine = ProgressEngine()
    reported = []
    mon = HeartbeatMonitor(ranks=[0, 1], timeout=1.0, engine=engine, on_failure=reported.extend, clock=clock)
    clock.advance(5.0)

    class _RaceLock:
        def __init__(self, real):
            self.real = real
            self.fired = False

        def __enter__(self):
            self.real.acquire()

        def __exit__(self, *exc):
            self.real.release()
            if not self.fired and 1 in mon._failed:
                self.fired = True
                mon.remove_rank(1)  # rank 1 detaches cleanly mid-poll

    real_lock = mon._lock
    mon._lock = _RaceLock(real_lock)
    mon.check()
    mon._lock = real_lock
    for _ in range(10):
        mon.check()
    assert 1 not in reported, f"cleanly departed rank reported dead: {reported}"
    assert 0 in mon.failed and 1 not in mon.failed
    mon.stop()
    engine.stop_all()


def test_heartbeat_removed_rank_never_fails_later():
    clock = VirtualClock()
    engine = ProgressEngine()
    reported = []
    mon = HeartbeatMonitor(ranks=[0, 1], timeout=1.0, engine=engine, on_failure=reported.extend, clock=clock)
    mon.remove_rank(1)
    clock.advance(10.0)
    mon.record(0)
    for _ in range(5):
        mon.check()
    assert reported == [] and mon.failed == []
    mon.stop()
    engine.stop_all()


def test_heartbeat_readded_rank_gets_clean_slate():
    clock = VirtualClock()
    engine = ProgressEngine()
    mon = HeartbeatMonitor(ranks=[0, 1], timeout=1.0, engine=engine, clock=clock)
    clock.advance(5.0)
    mon.record(0)
    mon.add_rank(1)  # expired but unreported; re-adding wipes it
    mon.check()
    assert mon.failed == []
    mon.stop()
    engine.stop_all()


def test_heartbeat_wait_sleeps_to_the_next_deadline():
    """Waiting on the detector request wakes once a rank can have missed its
    deadline, not before, and completes with the failure reported."""
    eng = ProgressEngine()
    failures = []
    mon = HeartbeatMonitor(ranks=[0], timeout=0.2, engine=eng, on_failure=failures.append)
    t0 = time.monotonic()
    assert eng.wait(mon._req, timeout=WAIT_S)
    assert 0.2 <= time.monotonic() - t0 < WAIT_S
    assert failures == [[0]]
    eng.stop_all()


def test_heartbeat_monitors_threadcomm_rank_liveness():
    """Thread-ranks ping the monitor through their mailbox ops; a stalled
    rank trips on_failure while active ranks stay green, and a cleanly
    detached rank is deregistered."""
    eng = ProgressEngine()
    failures = []
    mon = HeartbeatMonitor(ranks=[], timeout=0.4, engine=eng, on_failure=failures.append)
    comm = HostThreadComm(3, engine=eng, heartbeat=mon, name="hb-tc")
    comm.start()
    try:
        def live(r):
            h = comm.attach(rank=r)
            try:
                for _ in range(20):
                    h.send(r, "self", tag="ping")
                    h.recv(src=r, tag="ping", timeout=WAIT_S)
                    time.sleep(0.05)
            finally:
                h.detach()

        def stalled(r):
            h = comm.attach(rank=r)
            try:
                time.sleep(1.2)  # attached but silent
            finally:
                h.detach()

        threads = [threading.Thread(target=live, args=(0,), daemon=True),
                   threading.Thread(target=live, args=(1,), daemon=True),
                   threading.Thread(target=stalled, args=(2,), daemon=True)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5.0
        while not failures and time.monotonic() < deadline:
            mon.check()
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        comm.finish(timeout=WAIT_S)
    assert failures == [[2]]
    time.sleep(0.5)
    before = list(mon.failed)
    mon.check()
    assert mon.failed == before
    mon.stop()
    eng.stop_all()


# ------------------------------------------------------------- straggler

# each case: constructor kwargs, a script of ops, and the expectations the
# reference's table states. Ops: ("rec", {rank: seconds}) a step;
# ("check",) advice; ("drop", r); ("add", r); ("shares", total);
# ("medians",); ("strikes", r); ("hist", r)
_ESC = {(1, 3): ["evict"] * 3, (2, 3): ["rebalance", "evict", "evict"],
        (3, 4): ["rebalance", "rebalance", "evict", "evict"], (5, 5): ["rebalance"] * 4 + ["evict"]}
_SHARES = [({0: 1.0, 1: 1.0, 2: 1.0}, 12), ({0: 1.0, 1: 2.0, 2: 4.0}, 14), ({0: 1.0, 1: 1.0, 2: 10.0}, 7),
           ({0: 0.5, 1: 3.0}, 5), ({0: 1.0, 1: 1.0, 2: 1.0, 3: 9.0}, 4)]


def _slow(rank, s, ranks=(0, 1, 2), n=1):
    return [("rec", {r: (s if r == rank else 1.0) for r in ranks})] * n


STRAGGLER_CASES = {
    **{f"escalation_{e}_{n}": (dict(ranks=[0, 1, 2], window=4, threshold=1.5, evict_after=e),
                               (_slow(2, 4.0) + [("check",)]) * n, None) for (e, n) in _ESC},
    "healthy_check_resets": (dict(ranks=[0, 1, 2], window=2, threshold=1.5, evict_after=3),
                             (_slow(2, 4.0, n=2) + [("check",)]) * 2 + _slow(2, 1.0, n=2)
                             + [("check",), ("strikes", 2)] + (_slow(2, 4.0, n=2) + [("check",)]) * 2, None),
    "two_stragglers": (dict(ranks=[0, 1, 2, 3], window=2, threshold=1.5, evict_after=2),
                       [("rec", {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0})] * 2 + [("rec", {0: 1.0, 1: 1.0, 2: 1.0, 3: 9.0})] * 2
                       + [("check",)] + [("rec", {0: 1.0, 1: 1.0, 2: 9.0, 3: 9.0})] * 2 + [("check",)], None),
    "threshold_strict": (dict(ranks=[0, 1, 2], window=1, threshold=1.5),
                         [("rec", {0: 1.0, 1: 1.0, 2: 1.5}), ("check",), ("rec", {0: 1.0, 1: 1.0, 2: 1.5 + 1e-9}),
                          ("check",)], None),
    "fewer_than_two_ranks": (dict(ranks=[0], window=1, threshold=1.5), [("rec", {0: 100.0}), ("check",)], None),
    "slowdown_factor": (dict(ranks=[0, 1, 2], window=1, threshold=1.5), [("rec", {0: 1.0, 1: 1.0, 2: 3.0}), ("check",)],
                        None),
    **{f"shares_{i}": (dict(ranks=list(m), window=1), [("rec", m), ("shares", t)], (m, t))
       for i, (m, t) in enumerate(_SHARES)},
    "shares_empty": (dict(ranks=[], window=1), [("shares", 8)], None),
    "dropped_rank_leaves_median": (dict(ranks=[0, 1, 2], window=1, threshold=1.5),
                                   [("rec", {0: 1.0, 1: 1.0, 2: 8.0}), ("check",), ("drop", 2),
                                    ("rec", {0: 1.0, 1: 1.1}), ("check",), ("medians",)], None),
    "added_rank_flaggable": (dict(ranks=[0, 1], window=2, threshold=1.5, evict_after=2),
                             [("rec", {0: 1.0, 1: 1.0}), ("add", 7), ("strikes", 7)]
                             + [("rec", {0: 1.0, 1: 1.0, 7: 5.0})] * 2 + [("check",), ("rec", {0: 1.0, 1: 1.0, 7: 5.0}),
                                                                        ("check",)], None),
    "remesh_then_straggle": (dict(ranks=[0, 1], window=4, threshold=1.5, evict_after=2),
                             [("rec", {0: 1.0, 1: 1.0})] * 4 + [("drop", 1), ("add", 2), ("add", 3)]
                             + [("rec", {0: 1.0, 2: 1.0, 3: 4.0})] * 4 + [("check",), ("check",), ("medians",),
                                                                        ("add", 2), ("hist", 2)], None),
}


def _run_script(cls, kwargs, script):
    mon = cls(**kwargs)
    trace = []
    for op in script:
        if op[0] == "rec":
            mon.record_step(op[1])
        elif op[0] == "check":
            trace.append(("check", [(a.rank, a.action, a.slowdown) for a in mon.check()]))
        elif op[0] == "drop":
            mon.drop_rank(op[1])
        elif op[0] == "add":
            mon.add_rank(op[1])
        elif op[0] == "shares":
            trace.append(("shares", mon.rebalance_shares(op[1])))
        elif op[0] == "medians":
            trace.append(("medians", mon.medians()))
        elif op[0] == "strikes":
            trace.append(("strikes", mon._strikes[op[1]]))
        elif op[0] == "hist":
            trace.append(("hist", len(mon._hist[op[1]])))
    return trace


@pytest.mark.parametrize("case", sorted(STRAGGLER_CASES))
def test_straggler_tables_match_reference(case):
    kwargs, script, share_case = STRAGGLER_CASES[case]
    ref = _run_script(JStraggler, kwargs, script)
    got = _run_script(TStraggler, kwargs, script)
    assert got == ref
    checks = [v for k, v in got if k == "check"]
    if case.startswith("escalation_"):
        e, n = map(int, case.split("_")[1:])
        assert [c[0][:2] for c in checks] == [(2, a) for a in _ESC[(e, n)]]
    if case == "threshold_strict":
        assert checks[0] == [] and [c[0] for c in checks[1]] == [2] and checks[1][0][2] == pytest.approx(1.5)
    if case == "slowdown_factor":
        assert checks[0][0][2] == pytest.approx(3.0)
    if case == "two_stragglers":
        assert set(c[:2] for c in checks[1]) == {(3, "evict"), (2, "rebalance")}
    if share_case is not None:
        meds, total = share_case
        shares = got[-1][1]
        assert set(shares) == set(meds) and sum(shares.values()) == total and min(shares.values()) >= 1
    assert all(isinstance(a, Advice) for a in TStraggler(ranks=[0, 1], window=1).check())


# ------------------------------------------------------------- elastic

REMESH = [((2, 16, 16), ("pod", "data", "model"), 16), ((2, 2, 2), ("pod", "data", "model"), 1),
          ((2, 2, 2), ("pod", "data", "model"), 4), ((4, 8), ("data", "model"), 9), ((8,), ("data",), 3),
          ((1, 1, 16), ("pod", "data", "model"), 15), ((2, 4), ("model", "data"), 5)]


@pytest.mark.parametrize("shape,axes,n_failed", REMESH)
def test_plan_remesh_matches_reference(shape, axes, n_failed):
    try:
        want = j_elastic.plan_remesh(shape, axes, n_failed)
    except RuntimeError as e:
        with pytest.raises(RuntimeError) as got:
            t_elastic.plan_remesh(shape, axes, n_failed)
        assert str(got.value) == str(e)
        return
    got = t_elastic.plan_remesh(shape, axes, n_failed)
    assert (got.shape, got.axis_names, got.n_devices, got.dropped) == (
        want.shape, want.axis_names, want.n_devices, want.dropped)


RESHARD = [((8, 16), (2, 1)), ((16, 16), (4, 1)), ((4, 4, 4), (2, 2, 1)), ((8, 8), (2, 4)), ((151936, 64), (2, 1)),
           ((24, 64, 128), (3, 1, 2))]


@pytest.mark.parametrize("shape,grid", RESHARD)
def test_reshard_plan_matches_reference(shape, grid):
    want = j_elastic.reshard_plan(shape, grid, itemsize=2)
    got = t_elastic.reshard_plan(shape, grid, itemsize=2)
    assert list(got) == list(want)
    for coord in want:
        assert [(i.offset, i.length) for i in got[coord]] == [(i.offset, i.length) for i in want[coord]]
        assert t_elastic.shard_slices(shape, grid, coord) == j_elastic.shard_slices(shape, grid, coord)
    total = sum(i.length for iovs in got.values() for i in iovs)
    assert total == int(np.prod(shape)) * 2


def test_execute_reshard_matches_reference(tmp_path):
    """The same plan over the same file: equal shard bytes, which
    concatenate to the file, and a window that reaped what it admitted."""
    from repro.core.progress import ProgressEngine as JEngine

    arr = np.arange(16 * 24, dtype=np.float32).reshape(16, 24)
    path = tmp_path / "w.bin"
    arr.tofile(path)
    plans_j = j_elastic.reshard_plan(arr.shape, (4, 1), 4)
    plans_t = t_elastic.reshard_plan(arr.shape, (4, 1), 4)

    def read_run(iov):
        with open(path, "rb") as fh:
            fh.seek(iov.offset)
            return fh.read(iov.length)

    want, _ = j_elastic.execute_reshard(plans_j, read_run, depth=2, engine=JEngine())
    eng = ProgressEngine()
    got, stats = t_elastic.execute_reshard(plans_t, read_run, depth=2, engine=eng)
    assert got == want
    assert b"".join(got[c] for c in sorted(got)) == path.read_bytes()
    assert stats["admitted"] == stats["reaped"] == 4
    eng.stop_all()
