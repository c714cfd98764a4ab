"""The port's host-mode thread communicator and host collectives against the
JAX package's (paper ext. 5: real threads as ranks).

Every scenario of the reference's host-thread tests
(``tests/test_threadcomm_host.py``, its hybrid mesh cases aside) and of its
large-array collective tests (``tests/test_threadcoll_large.py``) runs on
both packages with the same seeded inputs; what each rank receives must be
equal, element for element — the ring and tree algorithms fold in the same
order in both — and each scenario's own checks must hold on the port.
Engine counters that depend on thread timing (parks, spin hits) are checked
on the port alone."""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import threadcoll as j_threadcoll
from repro.core import threadcomm as j_threadcomm
from repro.core.progress import ProgressEngine as JProgressEngine
from repro.core.schedule import Schedule as JSchedule
from repro.core.schedule import ScheduleStale as JScheduleStale
from repro.core.streams import StreamPool as JStreamPool
from repro.ft import faultinject as j_faultinject
from repro_torch.core import threadcoll as t_threadcoll
from repro_torch.core import threadcomm as t_threadcomm
from repro_torch.core.progress import ProgressEngine as TProgressEngine
from repro_torch.core.schedule import Schedule as TSchedule
from repro_torch.core.schedule import ScheduleStale as TScheduleStale
from repro_torch.core.streams import StreamPool as TStreamPool
from repro_torch.ft import faultinject as t_faultinject

PKGS = {
    "jax": SimpleNamespace(tc=j_threadcomm, coll=j_threadcoll, PE=JProgressEngine, Pool=JStreamPool,
                           Schedule=JSchedule, Stale=JScheduleStale, fi=j_faultinject),
    "torch": SimpleNamespace(tc=t_threadcomm, coll=t_threadcoll, PE=TProgressEngine, Pool=TStreamPool,
                             Schedule=TSchedule, Stale=TScheduleStale, fi=t_faultinject),
}
_T = 10.0


def _same(a, b) -> bool:
    """Deep equality with numpy arrays compared by dtype, shape and value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _both(scenario):
    """Run ``scenario(m)`` for the reference and the port; the port's result
    must equal the reference's. Returns the port's."""
    ref = scenario(PKGS["jax"])
    got = scenario(PKGS["torch"])
    assert _same(got, ref), (got, ref)
    return got


def _run_ranks(comm, body, ranks=None, join_timeout=_T):
    """One thread per rank running ``body(handle)``; re-raise the first
    worker failure in the test thread."""
    ranks = range(comm.nthreads) if ranks is None else ranks
    errors = []

    def wrap(r):
        h = comm.attach(rank=r)
        try:
            body(h)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            h.detach()

    threads = [threading.Thread(target=wrap, args=(r,), daemon=True) for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=join_timeout)
    assert not any(t.is_alive() for t in threads), "rank thread still running"
    if errors:
        raise errors[0]


def _comm(m, n, **kw):
    return m.tc.HostThreadComm(n, engine=kw.pop("engine", None) or m.PE(), pool=kw.pop("pool", None) or m.Pool(),
                               **kw)


# ----------------------------------------------------------------------
# bracket: start / attach / finish
# ----------------------------------------------------------------------


def test_start_attach_finish_bracket_and_restart():
    def scenario(m):
        pool = m.Pool(max_channels=8)
        comm = m.tc.host_threadcomm_init(3, engine=m.PE(), pool=pool, name="bracket")
        out = [comm.active]
        with pytest.raises(RuntimeError):
            comm.attach()  # before start
        comm.start()
        out.append(pool.n_live)  # one VCI channel per rank
        with pytest.raises(RuntimeError):
            comm.start()  # brackets must nest cleanly
        _run_ranks(comm, lambda h: h.barrier(timeout=_T))
        comm.finish(timeout=10.0)
        out.append(pool.n_live)
        comm.start()  # re-startable: fresh channels
        _run_ranks(comm, lambda h: h.barrier(timeout=_T))
        comm.finish(timeout=10.0)
        out.append(comm.stats()["epoch"])
        return out

    assert _both(scenario) == [False, 3, 0, 2]


def test_out_of_order_attach_assigns_requested_ranks():
    def scenario(m):
        comm = _comm(m, 4, name="ooo")
        comm.start()
        seen = {}
        gate = threading.Barrier(4)

        def body(rank):
            h = comm.attach(rank=rank)
            try:
                gate.wait(timeout=_T)
                h.send(0, h.rank, tag="who")
                if h.rank == 0:
                    seen["ranks"] = sorted(h.recv(src=m.tc.ANY_SOURCE, tag="who", timeout=10.0) for _ in range(4))
                h.barrier(timeout=_T)
            finally:
                h.detach()

        threads = []
        for r in (2, 0, 3, 1):  # join order != rank order
            t = threading.Thread(target=body, args=(r,), daemon=True)
            t.start()
            threads.append(t)
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=_T)
        comm.finish(timeout=10.0)
        return seen["ranks"]

    assert _both(scenario) == [0, 1, 2, 3]


def test_auto_rank_assignment_fills_gaps():
    def scenario(m):
        comm = _comm(m, 3)
        comm.start()
        h1 = comm.attach(rank=1)
        ha, hb = comm.attach(), comm.attach()
        with pytest.raises(RuntimeError):
            comm.attach(rank=1)  # double-claim
        for h in (h1, ha, hb):
            h.detach()
        comm.finish(timeout=5.0)
        return sorted((ha.rank, hb.rank))

    assert _both(scenario) == [0, 2]


def test_finish_with_inflight_sends_raises_then_drains():
    def scenario(m):
        comm = _comm(m, 2, name="leak")
        comm.start()

        def body(h):
            if h.rank == 0:
                h.send(1, np.arange(5), tag="orphan")  # never received

        _run_ranks(comm, body)
        with pytest.raises(RuntimeError, match="undelivered") as err:
            comm.finish(timeout=5.0)
        active = comm.active  # the failed finish leaves the epoch inspectable
        return [str(err.value), active, comm.finish(timeout=5.0, drain=True), comm.active]

    assert _both(scenario)[1:] == [True, 1, False]


def test_finish_times_out_while_rank_attached():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0 = comm.attach(rank=0)
        with pytest.raises(TimeoutError) as err:
            comm.finish(timeout=0.1)
        h0.detach()
        return [str(err.value), comm.finish(timeout=5.0)]

    _both(scenario)


# ----------------------------------------------------------------------
# pt2pt mailboxes
# ----------------------------------------------------------------------


def test_pt2pt_zero_copy_tags_and_any_source():
    def scenario(m):
        comm = _comm(m, 3)
        comm.start()
        payload = np.arange(1024)
        out = {}

        def body(h):
            if h.rank == 1:
                m.tc.tc_send(h, 0, payload, tag="big")
            elif h.rank == 2:
                h.send(0, "hello", tag="small")
            else:
                got = m.tc.tc_recv(h, src=1, tag="big", timeout=10.0)
                out["same_object"] = got is payload  # reference handoff, no copy
                out["any"] = h.recv(src=m.tc.ANY_SOURCE, tag="small", timeout=10.0)

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == {"same_object": True, "any": "hello"}


def test_pt2pt_fifo_per_pair_and_tag_matching():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        out = {}

        def body(h):
            if h.rank == 0:
                for k in range(5):
                    h.send(1, k, tag="seq")
                h.send(1, "late-tag", tag="other")
            else:
                out["other"] = h.recv(src=0, tag="other", timeout=10.0)
                out["seq"] = [h.recv(src=0, tag="seq", timeout=10.0) for _ in range(5)]

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == {"other": "late-tag", "seq": [0, 1, 2, 3, 4]}


def test_recv_timeout_raises_and_send_validates_rank():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0 = comm.attach(rank=0)
        with pytest.raises(TimeoutError) as t_err:
            h0.recv(src=1, tag=0, timeout=0.05)
        with pytest.raises(ValueError) as v_err:
            h0.send(7, "x")
        h0.detach()
        comm.finish(timeout=5.0)
        return [str(v_err.value), "timed out" in str(t_err.value)]

    assert _both(scenario)[1] is True


def test_detached_handle_rejects_operations():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0, h1 = comm.attach(rank=0), comm.attach(rank=1)
        h0.detach()
        with pytest.raises(RuntimeError) as err:
            h0.send(1, "x")
        h1.detach()
        comm.finish(timeout=5.0)
        return "detached" in str(err.value)

    assert _both(scenario) is True


# ----------------------------------------------------------------------
# ANY_TAG, probe/iprobe, posted receives
# ----------------------------------------------------------------------


def test_any_tag_recv_matches_fifo_oracle():
    sent = [("alpha", 1), ("beta", 2), ("alpha", 3), (("tup", 7), 4), ("gamma", 5)]

    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        got = {}

        def body(h):
            if h.rank == 1:
                for tag, payload in sent:
                    h.send(0, payload, tag=tag)
            else:
                deadline = time.monotonic() + 10
                while comm.stats()["pending_messages"][0] < len(sent):
                    assert time.monotonic() < deadline
                    time.sleep(0.005)
                got["seq"] = [h.recv(src=1, tag=m.tc.ANY_TAG, timeout=10.0) for _ in sent]

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return got["seq"]

    assert _both(scenario) == [p for _t, p in sent]  # FIFO across distinct tags


def test_any_source_any_tag_recv_skips_collective_traffic():
    def scenario(m):
        comm = _comm(m, 3)
        comm.start()
        out = {}
        coll_tag = (m.coll._COLL, "bar", 0, 0)

        def body(h):
            if h.rank == 0:
                out["w"] = h.recv(src=m.tc.ANY_SOURCE, tag=m.tc.ANY_TAG, timeout=10.0)
                out["coll"] = h.recv(src=2, tag=coll_tag, timeout=10.0)
            elif h.rank == 1:
                time.sleep(0.1)  # let the collective-tagged send land first
                h.send(0, "user-msg", tag="anything")
            else:
                h.send(0, "coll-msg", tag=coll_tag)

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == {"w": "user-msg", "coll": "coll-msg"}


def test_iprobe_no_steal_and_probe_blocks():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        out = {}

        def body(h):
            if h.rank == 0:
                out["before"] = h.iprobe(src=1, tag="x")
                out["env"] = h.probe(src=1, tag="x", timeout=10.0)  # blocks until queued
                out["ip1"] = h.iprobe(src=1, tag="x")
                out["ip2"] = h.iprobe(src=m.tc.ANY_SOURCE, tag=m.tc.ANY_TAG)
                out["payload"] = h.recv(src=1, tag="x", timeout=10.0)
                out["after"] = h.iprobe(src=1, tag="x")
            else:
                time.sleep(0.15)  # rank 0 genuinely blocks in probe
                h.send(0, {"k": 1}, tag="x")

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == {"before": None, "env": (1, "x"), "ip1": (1, "x"), "ip2": (1, "x"),
                               "payload": {"k": 1}, "after": None}


def test_iprobe_does_not_steal_from_parked_directed_recv():
    def scenario(m):
        comm = _comm(m, 2, engine=m.PE(spin_s=0.0))
        comm.start()
        out, probed = {}, []

        def body(h):
            if h.rank == 0:
                out["got"] = h.recv(src=1, tag="slow", timeout=10.0)
            else:
                h.send(0, "payload", tag="slow")
                probed.append(h.iprobe(src=m.tc.ANY_SOURCE, tag=m.tc.ANY_TAG))

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return [out["got"], probed]

    assert _both(scenario) == ["payload", [None]]


def test_irecv_posted_before_send_is_fulfilled_directly():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        out = {}

        def body(h):
            if h.rank == 0:
                fut = h.irecv(src=1, tag="direct")
                out["done_early"] = fut.done
                out["payload"] = fut.wait(timeout=10.0)
                out["src_tag"] = (fut.source, fut.tag)
                out["queued"] = comm.stats()["pending_messages"][0]  # never hit the queue
            else:
                time.sleep(0.1)
                h.send(0, [1, 2, 3], tag="direct")

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == {"done_early": False, "payload": [1, 2, 3], "src_tag": (1, "direct"), "queued": 0}


def test_irecv_matches_already_queued_message():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0, h1 = comm.attach(rank=0), comm.attach(rank=1)
        h1.send(0, "early", tag="t")
        fut = h0.irecv(src=1, tag="t")
        out = [fut.done, fut.payload]
        for h in (h0, h1):
            h.detach()
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == [True, "early"]


def test_wait_any_over_posted_receives():
    def scenario(m):
        eng = m.PE(spin_s=0.0)
        comm = _comm(m, 3, engine=eng)
        comm.start()
        out = {}

        def body(h):
            if h.rank == 0:
                futs = [h.irecv(src=s, tag="race") for s in (1, 2)]
                first = eng.wait_any([f.grequest for f in futs], timeout=10.0)
                out["first"] = next(f for f in futs if f.grequest is first).source
                out["all"] = [f.wait(timeout=10.0) for f in futs]
            elif h.rank == 2:
                h.send(0, "from-2", tag="race")
            else:
                time.sleep(0.25)
                h.send(0, "from-1", tag="race")

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == {"first": 2, "all": ["from-1", "from-2"]}  # completion order, not post order


def test_any_source_recv_timeout_does_not_lose_later_send():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0, h1 = comm.attach(rank=0), comm.attach(rank=1)
        with pytest.raises(TimeoutError):
            h0.recv(src=m.tc.ANY_SOURCE, tag="late", timeout=0.05)
        h1.send(0, "arrived-late", tag="late")
        got = h0.recv(src=m.tc.ANY_SOURCE, tag="late", timeout=5.0)
        for h in (h0, h1):
            h.detach()
        comm.finish(timeout=5.0)
        return got

    assert _both(scenario) == "arrived-late"


def test_any_source_recv_timeout_leaks_no_engine_requests():
    def scenario(m):
        eng = m.PE()
        comm = _comm(m, 2, engine=eng)
        comm.start()
        h0 = comm.attach(rank=0)
        for _ in range(5):
            with pytest.raises(TimeoutError):
                h0.recv(src=m.tc.ANY_SOURCE, tag="nothing", timeout=0.02)
        eng.progress()  # sweep: cancelled posts must all retire
        out = [eng.pending(), comm.stats()["posted_recvs"][0]]
        h0.detach()
        comm.attach(rank=1).detach()
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == [0, 0]


def test_recv_future_cancel_withdraws_post():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0, h1 = comm.attach(rank=0), comm.attach(rank=1)
        fut = h0.irecv(src=1, tag="maybe")
        out = [fut.cancel()]  # withdrawn while unmatched
        h1.send(0, "late", tag="maybe")
        out.append(h0.recv(src=1, tag="maybe", timeout=5.0))  # the send sits in the mailbox
        with pytest.raises(RuntimeError, match="cancelled"):
            fut.wait(timeout=1.0)
        h1.send(0, "kept", tag="t2")
        fut2 = h0.irecv(src=1, tag="t2")
        out += [fut2.cancel(), fut2.payload]  # cancel after a match: the payload is yours
        for h in (h0, h1):
            h.detach()
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == [True, "late", False, "kept"]


def test_finish_cancels_dangling_posted_receives():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0, h1 = comm.attach(rank=0), comm.attach(rank=1)
        fut = h0.irecv(src=1, tag="never")
        out = [comm.stats()["posted_recvs"][0]]
        for h in (h0, h1):
            h.detach()
        comm.finish(timeout=5.0)
        out.append(fut.grequest.done)  # cancelled, not leaked
        with pytest.raises(RuntimeError, match="not matched"):
            _ = fut.payload
        return out

    assert _both(scenario) == [1, True]


# ----------------------------------------------------------------------
# collectives on the same seeded inputs
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_randomized_collectives_match_reference(n):
    rng = np.random.default_rng(100 + n)
    rounds = 6
    shapes = [tuple(rng.integers(1, 5, size=rng.integers(1, 3))) for _ in range(rounds)]
    values = [[rng.standard_normal(shapes[rd]) for _ in range(n)] for rd in range(rounds)]
    ints = [[int(rng.integers(-50, 50)) for _ in range(n)] for _ in range(rounds)]
    ops = [("sum", "max", "min", "prod")[rng.integers(0, 4)] for _ in range(rounds)]
    roots = [int(rng.integers(0, n)) for _ in range(rounds)]
    stats = {}

    def scenario(m):
        eng = m.PE(spin_s=0.0)  # every blocked rank parks
        comm = _comm(m, n, engine=eng, name=f"coll{n}")
        comm.start()
        results = [dict() for _ in range(rounds)]

        def body(h):
            r = h.rank
            for rd in range(rounds):
                h.barrier(timeout=_T)
                got_b = h.bcast(values[rd][r] if r == roots[rd] else None, root=roots[rd], timeout=_T)
                got_ar = h.allreduce(values[rd][r], op=ops[rd], timeout=_T)
                got_ai = h.allreduce(ints[rd][r], op="sum", timeout=_T)
                got_a2a = h.alltoall([(r, j, rd) for j in range(n)], timeout=_T)
                results[rd][r] = (got_b, got_ar, got_ai, got_a2a)

        _run_ranks(comm, body)
        comm.finish(timeout=10.0)
        stats[m.tc.__name__] = eng.stats()
        return results

    results = _both(scenario)
    for rd in range(rounds):
        stack = np.stack(values[rd])
        oracle = {"sum": stack.sum(0), "prod": stack.prod(0), "max": stack.max(0), "min": stack.min(0)}[ops[rd]]
        for r in range(n):
            got_b, got_ar, got_ai, got_a2a = results[rd][r]
            np.testing.assert_array_equal(got_b, values[rd][roots[rd]])
            np.testing.assert_allclose(got_ar, oracle, rtol=1e-10, atol=1e-12)
            assert got_ai == sum(ints[rd])
            assert got_a2a == [(j, r, rd) for j in range(n)]
    st = stats[t_threadcomm.__name__]
    assert st["polls"] == 0  # pure mailbox traffic: zero request polling
    if n > 1:
        assert st["parks"] >= 1 and st["wakes"] >= st["parks"], st


def test_collectives_detect_mismatched_op_name():
    def scenario(m):
        comm = _comm(m, 1)
        comm.start()
        h = comm.attach()
        with pytest.raises(ValueError) as err:
            h.allreduce(np.ones(2), op="median")
        h.detach()
        comm.finish(timeout=5.0)
        return str(err.value)

    _both(scenario)


def test_back_to_back_collectives_stay_separated():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        out = {0: [], 1: []}

        def body(h):
            for k in range(20):
                out[h.rank].append(h.allreduce(np.array([h.rank + 10 * k]), op="sum", timeout=10.0))

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return out

    out = _both(scenario)
    for r in (0, 1):
        assert [int(x[0]) for x in out[r]] == [20 * k + 1 for k in range(20)]


# ----------------------------------------------------------------------
# VCI channels, affinity, parking
# ----------------------------------------------------------------------


def test_per_rank_channels_distinct_vs_shared():
    def scenario(m):
        pool = m.Pool()
        comm = _comm(m, 4, pool=pool)
        comm.start()
        comm2 = _comm(m, 4, pool=pool, shared_channel=True)
        comm2.start()
        out = [len(set(comm.channels())), len(set(comm2.channels()))]
        comm.attach(rank=0).detach()
        comm.finish(timeout=5.0)
        comm2.finish(timeout=5.0)
        return out

    assert _both(scenario) == [4, 1]


def test_thread_channel_affinity_binding():
    def scenario(m):
        eng = m.PE()
        comm = _comm(m, 2, engine=eng)
        comm.start()
        out = {}

        def body(h):
            out[h.rank] = eng.thread_channel() == h.stream.channel

        _run_ranks(comm, body)
        comm.finish(timeout=5.0)
        return [out[0], out[1], eng.thread_channel()]

    assert _both(scenario) == [True, True, None]


def test_stream_identity_and_mesh_level_wait_for_p9():
    comm = _comm(PKGS["torch"], 2)
    comm.start()
    h = comm.attach(rank=1)
    assert h.stream.kind == "compute" and h.channel == h.stream.channel
    sc = h.as_stream_comm()
    assert sc.stream is h.stream and sc.axes == ("__host__",)  # the mesh level is ported (P9)
    h.detach()
    comm.attach(rank=0).detach()
    comm.finish(timeout=5.0)
    assert callable(t_threadcomm.shard_map)
    tc = t_threadcomm.ThreadComm(SimpleNamespace(shape={"data": 2}), ("data",))
    assert tc.size() == 2 and not t_threadcomm.comm_test_threadcomm(tc)
    assert t_threadcomm.HybridThreadComm(tc, comm).size() == 4


def test_blocked_recv_parks_spin_disabled_and_spin_hits_when_enabled():
    m = PKGS["torch"]
    eng = m.PE(spin_s=0.0)
    comm = _comm(m, 2, engine=eng)
    comm.start()

    def body(h):
        if h.rank == 0:
            assert h.recv(src=1, tag="slow", timeout=10.0) == "payload"
        else:
            time.sleep(0.3)  # rank 0 blocks first
            h.send(0, "payload", tag="slow")

    _run_ranks(comm, body)
    comm.finish(timeout=5.0)
    st = eng.stats()
    assert st["parks"] >= 1 and st["polls"] == 0

    eng2 = m.PE(spin_s=0.5, adaptive_spin=False)
    comm2 = _comm(m, 2, engine=eng2)
    comm2.start()

    def body2(h):
        if h.rank == 0:
            assert h.recv(src=1, tag="fast", timeout=10.0) == "x"
        else:
            h.send(0, "x", tag="fast")

    _run_ranks(comm2, body2)
    comm2.finish(timeout=5.0)
    assert eng2.stats()["spin_hits"] >= 1


def test_host_comm_protocol_surface():
    def scenario(m):
        comm = m.tc.host_threadcomm_init(2, engine=m.PE(), pool=m.Pool())
        single = m.tc.host_threadcomm_init(1, engine=m.PE(), pool=m.Pool())
        return [comm.size(), comm.rank_ids(), m.tc.comm_test_threadcomm(comm), m.tc.comm_test_threadcomm(single)]

    assert _both(scenario) == [2, [0, 1], True, False]


def test_mid_epoch_detached_rank_not_rejoinable():
    def scenario(m):
        comm = _comm(m, 2)
        comm.start()
        h0, h1 = comm.attach(rank=0), comm.attach(rank=1)
        h1.send(0, "meant-for-old-rank0", tag="stale")
        h0.detach()
        with pytest.raises(RuntimeError, match="mid-epoch"):
            comm.attach(rank=0)
        with pytest.raises(ValueError):
            comm.attach()  # auto-assign skips departed rank 0 → out of ranks
        h1.detach()
        out = [comm.finish(timeout=5.0, drain=True)]
        comm.start()
        h = comm.attach(rank=0)
        with pytest.raises(TimeoutError):
            h.recv(src=1, tag="stale", timeout=0.05)  # the old mailbox did not leak over
        h.detach()
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) == [1]


def test_non_lifo_detach_keeps_affinity_bindings_straight():
    def scenario(m):
        eng, pool = m.PE(), m.Pool()
        a = m.tc.HostThreadComm(1, engine=eng, pool=pool, name="aff-a").start()
        b = m.tc.HostThreadComm(1, engine=eng, pool=pool, name="aff-b").start()
        ha, hb = a.attach(), b.attach()
        out = [eng.thread_channel() == hb.channel]
        ha.detach()  # FIFO: first-joined leaves first
        out.append(eng.thread_channel() == hb.channel)
        hb.detach()
        out.append(eng.thread_channel())
        a.finish(timeout=5.0)
        b.finish(timeout=5.0)
        return out

    assert _both(scenario) == [True, True, None]


def test_cross_thread_detach_leaves_other_threads_binding_alone():
    def scenario(m):
        eng = m.PE()
        comm = _comm(m, 2, engine=eng)
        comm.start()
        handles = {}
        joined, release = threading.Event(), threading.Event()

        def joiner():
            handles["h"] = comm.attach(rank=1)
            joined.set()
            release.wait(timeout=10.0)

        t = threading.Thread(target=joiner, daemon=True)
        t.start()
        joined.wait(timeout=10.0)
        h0 = comm.attach(rank=0)
        handles["h"].detach()  # issued from the wrong (main) thread
        out = eng.thread_channel() == h0.channel
        release.set()
        t.join(timeout=10.0)
        h0.detach()
        comm.finish(timeout=5.0)
        return out

    assert _both(scenario) is True


def test_collective_seq_numbers_reset_across_epochs():
    def scenario(m):
        comm = _comm(m, 4, name="epoch-seq")
        epochs = []
        for base in (0.0, 100.0):
            comm.start()
            results, lock = {}, threading.Lock()

            def body(h, base=base):
                acc = []
                for round_i in range(3):
                    h.barrier(timeout=_T)
                    acc.append(h.allreduce(np.full(8, base + h.rank + 10.0 * round_i), op="sum", timeout=_T))
                with lock:
                    results[h.rank] = acc

            _run_ranks(comm, body)
            comm.finish(timeout=10.0)
            epochs.append((comm.stats()["epoch"], results))
        return epochs

    epochs = _both(scenario)
    for epoch, (base, (n_epoch, results)) in enumerate(zip((0.0, 100.0), epochs), start=1):
        assert n_epoch == epoch
        for r in range(4):
            for round_i, got in enumerate(results[r]):
                np.testing.assert_allclose(got, np.full(8, 4 * (base + 10.0 * round_i) + 6))


def test_epoch_restart_with_inflight_point_to_point_drains_clean():
    def scenario(m):
        comm = _comm(m, 2, name="epoch-drain")
        comm.start()

        def epoch1(h):
            if h.rank == 0:
                for k in range(3):
                    h.send(1, np.full(4, 1000.0 + k), tag=7)  # never received in epoch 1
            h.barrier(timeout=_T)

        _run_ranks(comm, epoch1)
        drained = comm.finish(timeout=10.0, drain=True)
        comm.start()
        got = {}

        def epoch2(h):
            if h.rank == 0:
                h.send(1, np.full(4, 42.0), tag=7)
            else:
                got["msg"] = h.recv(src=0, tag=7, timeout=10.0)

        _run_ranks(comm, epoch2)
        comm.finish(timeout=10.0)
        return [drained, got["msg"]]

    drained, msg = _both(scenario)
    assert drained == 3
    np.testing.assert_array_equal(msg, np.full(4, 42.0))


# ----------------------------------------------------------------------
# large-array collectives (ring reduce-scatter, allgather, Rabenseifner)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("total,n", [(10, 3), (7, 5), (3, 8), (0, 4), (4097, 8), (16, 4), (1, 1)])
def test_chunk_bounds_match_reference(total, n):
    bounds = t_threadcoll.chunk_bounds(total, n)
    assert bounds == j_threadcoll.chunk_bounds(total, n)
    assert sum(sz for _, sz in bounds) == total


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_rs_ag_allreduce_large_match_reference(n):
    sizes = [1, 3, 7, 1000, 4097]
    rng = np.random.default_rng(1234 + n)
    fdata = {s: rng.standard_normal((n, s)).astype(np.float32) for s in sizes}
    idata = {s: rng.integers(-50, 50, (n, s)).astype(np.int64) for s in sizes}

    def scenario(m):
        comm = _comm(m, n, name=f"tcl-{n}")
        comm.start()
        results = {}

        def body(h):
            for s in sizes:
                chunk = m.coll.reduce_scatter(h, fdata[s][h.rank], timeout=_T)
                results[("rs", s, h.rank)] = chunk
                results[("ar", s, h.rank)] = m.coll.allreduce_large(h, fdata[s][h.rank], timeout=_T)
                results[("ari", s, h.rank)] = m.coll.allreduce_large(h, idata[s][h.rank], timeout=_T)
                results[("ag", s, h.rank)] = m.coll.allgather(h, chunk, timeout=_T)

        _run_ranks(comm, body)
        comm.finish(timeout=_T, drain=True)
        return results

    results = _both(scenario)
    for s in sizes:
        oracle = fdata[s].astype(np.float64).sum(axis=0)
        full = np.concatenate([results[("rs", s, r)] for r in range(n)])
        np.testing.assert_allclose(full, oracle, rtol=1e-4, atol=1e-5)
        for r in range(n):
            np.testing.assert_array_equal(results[("ari", s, r)], idata[s].sum(axis=0))
            np.testing.assert_array_equal(results[("ag", s, r)], full)
            np.testing.assert_array_equal(results[("ar", s, r)], results[("ar", s, 0)])


def test_allgatherv_ragged_and_reduce_scatter_axis_match_reference():
    parts = [np.arange(r + 1, dtype=np.int32) + 10 * r for r in range(5)]
    data = np.random.default_rng(7).standard_normal((3, 4, 10)).astype(np.float32)

    def scenario(m):
        out = {}
        comm = _comm(m, 5, name="tcl-agv")
        comm.start()
        _run_ranks(comm, lambda h: out.__setitem__(("agv", h.rank), m.coll.allgather(h, parts[h.rank], timeout=_T)))
        comm.finish(timeout=_T, drain=True)
        comm = _comm(m, 3, name="tcl-ax")
        comm.start()
        _run_ranks(comm, lambda h: out.__setitem__(
            ("ax", h.rank), m.coll.reduce_scatter(h, data[h.rank], axis=1, timeout=_T)))
        comm.finish(timeout=_T, drain=True)
        return out

    out = _both(scenario)
    for r in range(5):
        np.testing.assert_array_equal(out[("agv", r)], np.concatenate(parts))
    bounds = t_threadcoll.chunk_bounds(10, 3)
    for r in range(3):
        off, sz = bounds[r]
        assert out[("ax", r)].shape == (4, sz)
        np.testing.assert_allclose(out[("ax", r)], data.astype(np.float64).sum(0)[:, off:off + sz], rtol=1e-4,
                                   atol=1e-5)


def test_allreduce_switches_on_byte_threshold(monkeypatch):
    n = 4
    data = np.random.default_rng(3).standard_normal((n, 256)).astype(np.float32)
    calls = {}

    def scenario(m):
        real_large = m.coll.allreduce_large
        calls[m.coll.__name__] = []
        monkeypatch.setattr(m.coll, "allreduce_large",
                            lambda *a, **kw: (calls[m.coll.__name__].append(1), real_large(*a, **kw))[1])
        comm = _comm(m, n, name="tcl-sw")
        comm.start()
        results = {}

        def body(h):
            x = data[h.rank]
            results[("big", h.rank)] = m.coll.allreduce(h, x, large_threshold=x.nbytes, timeout=_T)
            results[("small", h.rank)] = m.coll.allreduce(h, x, large_threshold=x.nbytes + 1, timeout=_T)
            results[("direct", h.rank)] = real_large(h, x, timeout=_T)

        _run_ranks(comm, body)
        comm.finish(timeout=_T, drain=True)
        return results

    results = _both(scenario)
    assert len(calls[t_threadcoll.__name__]) == n  # each rank took the large branch once
    assert t_threadcoll.LARGE_THRESHOLD == j_threadcoll.LARGE_THRESHOLD == 64 * 1024
    for r in range(n):
        np.testing.assert_array_equal(results[("big", r)], results[("direct", r)])
        np.testing.assert_allclose(results[("small", r)], data.astype(np.float64).sum(0), rtol=1e-4, atol=1e-5)


def test_allreduce_single_rank_and_empty():
    def scenario(m):
        comm = _comm(m, 1, name="tcl-one")
        comm.start()
        results = {}

        def body(h):
            results["large"] = m.coll.allreduce_large(h, np.arange(5.0))
            results["switch"] = m.coll.allreduce(h, np.arange(5.0), large_threshold=0)
            results["rs"] = m.coll.reduce_scatter(h, np.arange(5.0))

        _run_ranks(comm, body)
        comm.finish(timeout=_T, drain=True)
        return results

    for v in _both(scenario).values():
        np.testing.assert_array_equal(v, np.arange(5.0))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_record_allreduce_large_replay_matches_reference(n):
    rng = np.random.default_rng(42 + n)
    d0 = rng.standard_normal((n, 501)).astype(np.float32)
    d1 = rng.standard_normal((n, 501)).astype(np.float32)
    bad = rng.standard_normal((n, 500)).astype(np.float32)

    def scenario(m):
        eng = m.PE()
        comm = _comm(m, n, engine=eng, name=f"tcl-rec{n}")
        comm.start()
        results = {}

        def body(h):
            r = h.rank
            sched = m.Schedule(engine=eng, name=f"ar-r{r}")
            eager0 = m.coll.allreduce_large(h, d0[r], timeout=_T)
            bracket = sched.record()
            try:
                rec = m.coll.record_allreduce_large(h, sched, d0[r], bind="x", out="y", timeout=_T)
                bracket.seal()
            finally:
                bracket.abort()
            eager1 = m.coll.allreduce_large(h, d1[r], timeout=_T)
            ctx = sched.replay(binding={"x": d1[r]}, timeout=_T)
            results[r] = (eager0, rec, eager1, ctx.outputs["y"])
            with pytest.raises(m.Stale):
                sched.replay(binding={"x": bad[r]}, timeout=_T)

        _run_ranks(comm, body)
        results["leftover"] = comm.finish(timeout=_T, drain=True)
        eng.stop_all()
        return results

    results = _both(scenario)
    assert results["leftover"] == 0
    for r in range(n):
        eager0, rec, eager1, replayed = results[r]
        np.testing.assert_array_equal(rec, eager0)  # recording IS an execution
        np.testing.assert_array_equal(replayed, eager1)  # replay == eager, bitwise


def test_record_rs_and_ag_standalone_match_reference():
    n = 3
    rng = np.random.default_rng(11)
    d0 = rng.standard_normal((n, 64)).astype(np.float32)
    d1 = rng.standard_normal((n, 64)).astype(np.float32)

    def scenario(m):
        eng = m.PE()
        comm = _comm(m, n, engine=eng, name="tcl-rsag")
        comm.start()
        results = {}

        def body(h):
            r = h.rank
            srs = m.Schedule(engine=eng, name=f"rs-r{r}")
            b1 = srs.record()
            try:
                rec_chunk = m.coll.record_reduce_scatter(h, srs, d0[r], bind="x", out="c", timeout=_T)
                b1.seal()
            finally:
                b1.abort()
            eager1 = m.coll.reduce_scatter(h, d1[r], timeout=_T)
            ctx = srs.replay(binding={"x": d1[r]}, timeout=_T)
            sag = m.Schedule(engine=eng, name=f"ag-r{r}")
            b2 = sag.record()
            try:
                rec_full = m.coll.record_allgather(h, sag, rec_chunk, out="f", timeout=_T)
                b2.seal()
            finally:
                b2.abort()
            ctx2 = sag.replay(timeout=_T)
            results[r] = (rec_chunk, eager1, ctx.outputs["c"], rec_full, ctx2.outputs["f"])

        _run_ranks(comm, body)
        results["leftover"] = comm.finish(timeout=_T, drain=True)
        eng.stop_all()
        return results

    results = _both(scenario)
    assert results["leftover"] == 0
    full0 = np.concatenate([results[r][0] for r in range(n)])
    for r in range(n):
        rec_chunk, eager1, replay_chunk, rec_full, replay_full = results[r]
        np.testing.assert_array_equal(replay_chunk, eager1)
        np.testing.assert_array_equal(rec_full, full0)
        np.testing.assert_array_equal(replay_full, full0)


def test_kill_rank_mid_allreduce_raises_cleanly():
    """A rank killed mid-Rabenseifner: the victim raises RankKilled, the
    others unwind by RankKilled or TimeoutError, nothing completes, the
    channels return to the pool and the sanitizer finds nothing — on both
    packages."""
    n = 4
    data = np.random.default_rng(5).standard_normal((n, 64 * 1024)).astype(np.float32)

    def scenario(m):
        engine, pool = m.PE(sanitize=True), m.Pool()
        comm = m.tc.HostThreadComm(n, engine=engine, pool=pool, name="tcl-kill")
        outcomes = {}

        def body(h):
            try:
                m.coll.allreduce_large(h, data[h.rank], timeout=2.0)
                outcomes[h.rank] = "completed"
            except m.fi.RankKilled:
                outcomes[h.rank] = "killed"
            except TimeoutError:
                outcomes[h.rank] = "timeout"

        plan = m.fi.FaultPlan([m.fi.FaultEvent(0.0, "kill_rank", 2)])
        with m.fi.FaultInjector(plan, clock=m.fi.VirtualClock()) as inject:
            inject.attach_comm(comm)
            comm.start()
            _run_ranks(comm, body)
            comm.finish(timeout=_T, drain=True)
        engine.stop_all()
        engine.progress()
        rep = engine.sanitizer_report()
        return [outcomes[2], all(v in ("killed", "timeout") for v in outcomes.values()), pool.n_live,
                rep["findings"], rep["counts"]["live_requests"]]

    assert _both(scenario) == ["killed", True, 0, [], 0]
