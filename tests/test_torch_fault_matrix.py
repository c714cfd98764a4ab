"""The reference's seeded fault-injection matrix
(``tests/test_fault_injection.py:58-73``, ``:121-196``) on the port's
thread communicator, ``OffloadWindow`` and heartbeat: 6 fault configs × 15
seeds inject kills, stalls, delays, send timeouts and heartbeat drops at
the port's own seams (``repro_torch.ft.faultinject``), and every run must
end as the reference's does:

* request conservation — ``enqueued == completions + pending`` and
  nothing pending at quiescence;
* zero sanitizer findings and no live request left;
* ``finish()`` leak-free and the window drained: admitted == reaped,
  nothing in flight or completed-unreaped;
* no worker hung.

Each plan is the reference's: ``FaultPlan.random`` draws the same events
for a seed in both packages (held here per case), and the workers draw
their operations from the same ``Random((seed << 8) | rank)`` streams.
Each case has its own time limit; every wait is bounded.
"""

import threading
import time
from random import Random

import pytest

from repro.ft.faultinject import FaultPlan as RefFaultPlan
from repro_torch.core import progress as pg
from repro_torch.core import streams as ss
from repro_torch.core.enqueue import OffloadWindow
from repro_torch.core.threadcomm import ANY_SOURCE, HostThreadComm
from repro_torch.ft.faultinject import FaultInjector, FaultPlan, RankKilled, SendTimeout, VirtualClock
from repro_torch.ft.heartbeat import HeartbeatMonitor

_OP_TIMEOUT = 10.0
_JOIN_TIMEOUT = 10.0

CONFIGS = {
    "kill-one": dict(kinds=("kill_rank",), n=4, events=2, bounded=None),
    "timeout-send": dict(kinds=("timeout_send",), n=4, events=3, bounded=None),
    "stall-delay": dict(kinds=("stall_rank", "delay_rank"), n=4, events=3, bounded=None),
    "drop-heartbeat": dict(kinds=("drop_heartbeat",), n=3, events=2, bounded=None),
    "mixed": dict(
        kinds=("kill_rank", "timeout_send", "delay_rank", "drop_heartbeat"),
        n=4,
        events=4,
        bounded=None,
    ),
    "bounded-mixed": dict(
        kinds=("kill_rank", "timeout_send", "delay_rank"), n=4, events=3, bounded=2
    ),
}
SEEDS = range(15)  # 6 configs x 15 seeds = 90 injected schedules, as in the reference


def _plan(cls, cfg, seed):
    return cls.random(seed, ranks=list(range(cfg["n"])), n_events=cfg["events"], kinds=cfg["kinds"],
                      horizon=6.0, max_duration=0.004)


def _injected_worker(comm, window, engine, win_stream, seed, rank, n, n_ops, errors):
    rng = Random((seed << 8) | rank)
    bounded = comm.mailbox_capacity is not None
    h = comm.attach(rank=rank)
    try:
        for i in range(n_ops):
            op = rng.choice(["send", "send", "recv", "window"])
            if bounded and op == "send" and rank == n - 1:
                op = "recv"  # keep the bounded wait-for graph acyclic
            try:
                if op == "send":
                    # bounded mailboxes backpressure the sender; sends only go
                    # to higher ranks there so parked senders never form a cycle
                    dst = rng.randrange(rank + 1, n) if bounded else rng.randrange(n)
                    h.send(dst, ("m", rank, i), tag=rng.randrange(3))
                elif op == "recv":
                    try:
                        h.recv(src=ANY_SOURCE, tag=rng.randrange(3), timeout=0.02)
                    except TimeoutError:
                        pass
                else:
                    with window.issue(timeout=_OP_TIMEOUT) as submit:
                        req = engine.grequest_start(stream=win_stream, name=f"fi-{rank}-{i}")
                        submit(req)
                    req.complete()
                    if rng.random() < 0.3:
                        window.reap()
            except RankKilled:
                return  # we (or our peer) died: a clean worker exit
            except SendTimeout:
                continue  # injected timeout: the message never left
            except RuntimeError as e:
                if "departed" in str(e):
                    return  # backpressured onto a receiver that died
                raise
    except BaseException as e:  # noqa: BLE001 — reported by the test
        errors.append((rank, e))
    finally:
        try:
            h.detach()
        except BaseException:  # noqa: BLE001 — a killed rank may already be gone
            pass


@pytest.mark.timeout(60)
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_matrix(cfg_name, seed):
    """Injected faults at the threadcomm/window/heartbeat seams: the run
    must end request-conserving, sanitizer-clean and leak-free."""
    cfg = CONFIGS[cfg_name]
    n = cfg["n"]
    plan = _plan(FaultPlan, cfg, seed)
    assert [(e.at, e.kind, e.rank, e.duration) for e in plan] == [
        (e.at, e.kind, e.rank, e.duration) for e in _plan(RefFaultPlan, cfg, seed)]
    deadline = time.monotonic() + 30.0
    engine = pg.ProgressEngine(sanitize=True)
    pool = ss.StreamPool()
    clock = VirtualClock()
    mon = HeartbeatMonitor(ranks=[], timeout=2.0, engine=engine, clock=clock)
    comm = HostThreadComm(n, engine=engine, pool=pool, heartbeat=mon, mailbox_capacity=cfg["bounded"],
                          name=f"fi-{cfg_name}")
    win_stream = pool.create(name="fi-win")
    window = OffloadWindow(win_stream, depth=2, engine=engine, adaptive=True, adapt_every=4, max_depth=6)
    errors: list = []
    with FaultInjector(plan, clock=clock) as inject:
        inject.attach_comm(comm)
        inject.attach_heartbeat(mon)
        comm.start()
        workers = [
            threading.Thread(target=_injected_worker, args=(comm, window, engine, win_stream, seed, r, n, 25, errors),
                             daemon=True, name=f"fi-w{r}")
            for r in range(n)
        ]
        for w in workers:
            w.start()
        # drive virtual time while the workload runs so timed events arm;
        # the detector sees the same clock the injector fires on
        while any(w.is_alive() for w in workers) and time.monotonic() < deadline:
            clock.advance(0.25)
            mon.check()
            time.sleep(0.002)
        for w in workers:
            w.join(timeout=_JOIN_TIMEOUT)
        hung = [w.name for w in workers if w.is_alive()]
        assert not hung, f"deadlock (cfg={cfg_name} seed={seed}): {hung}"
        assert not errors, f"(cfg={cfg_name} seed={seed}) {errors[0]}"
        window.drain(timeout=_OP_TIMEOUT)
        assert comm.finish(timeout=_OP_TIMEOUT, drain=True) >= 0
    mon.stop()
    engine.stop_all()
    engine.progress()
    wst = window.stats(engine=False)
    assert wst["admitted"] == wst["reaped"], wst
    assert wst["in_flight"] == 0 and wst["completed_unreaped"] == 0, wst
    st = engine.stats()
    assert st["enqueued"] == st["completions"] + engine.pending(), st
    assert engine.pending() == 0, "requests left pending after injected run"
    rep = engine.sanitizer_report()
    assert rep["findings"] == [], f"(cfg={cfg_name} seed={seed}) {rep['findings']}"
    assert rep["counts"]["live_requests"] == 0, rep["counts"]
