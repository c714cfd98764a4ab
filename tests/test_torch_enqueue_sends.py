"""The port's enqueue sends over a mesh (paper ext. 4 with ext. 3 comms)
against the JAX package's: windowed ring sends of stacked buffers,
datatype-described send buffers packed per row or over all rows at once,
the recorded ``isend_enqueue_scheduled``, stream communicators, and the
adaptive ``OffloadWindow`` depth.

Mirrors ``tests/test_enqueue_window.py:375-553`` on a 1-position mesh, with
the reference in this process as those tests run it, and
``tests/test_streams_progress.py:42-50``. The 4-position ring runs on the
port alone, every received row held byte for byte against the host engine's
pack of its source row. On the CPU every ``dt_pack`` launch is the kernel's
plain version; the route is read by counting ``ops.pack_datatype`` calls.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

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
from repro_torch.core.mesh import P as TP, make_mesh, shard_map  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

PKGS = {
    "jax": SimpleNamespace(pg=jpg, sch=jsch, ss=jss, enq=jenq, dt=jdt, off="tpu_stream", array=jnp.asarray,
                           ones=jnp.ones, full=jnp.full,
                           mesh=lambda n, name: jax.make_mesh((n,), (name,))),
    "torch": SimpleNamespace(pg=tpg, sch=tsch, ss=tss, enq=tenq, dt=tdt, off="cudaStream_t", array=torch.as_tensor,
                             ones=torch.ones, full=torch.full,
                             mesh=lambda n, name: make_mesh((n,), (name,), device="cpu")),
}
_T = 10.0


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
    s = pkg.ss.stream_create(info={"type": pkg.off}, name="sends-off")
    yield s
    pkg.ss.stream_free(s)


def _ring(pkg, offload, n=1, name="data"):
    return pkg.ss.stream_comm_create(pkg.mesh(n, name), (name,), offload)


@pytest.fixture()
def pack_calls(monkeypatch):
    """Counts of ``ops.pack_datatype`` calls (the kernel route)."""
    calls = []
    real = tops.pack_datatype
    monkeypatch.setattr(tops, "pack_datatype", lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


# ----------------------------------------------------------------------
# stacked packs
# ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(10))
def test_pack_stacked_matches_reference(seed):
    """Multi-rank windowed sends pack all rows at once where the rows form
    one uniform layout, else row by row; the bytes must equal the
    reference's (one vectorized host pack) and the per-rank loop."""
    from test_torch_datatype import _random_datatype

    jd = _random_datatype(jdt, random.Random(seed), random.Random(seed).randint(1, 3))
    td = _random_datatype(tdt, random.Random(seed), random.Random(seed).randint(1, 3))
    if td.size == 0:
        pytest.skip("empty layout")
    _stacked_bytes_match(jd, td, seed)


@pytest.mark.parametrize("seed", range(10))
def test_pack_stacked_matches_reference_negative_lb(seed):
    """As :func:`test_pack_stacked_matches_reference` for a layout whose
    lower bound is negative: each row's byte 0 is the type's lowest byte
    (the reference's rebase), every row packed on its own, the bytes the
    reference's."""
    from test_torch_datatype import _negative_datatype

    depth = random.Random(seed).randint(1, 3)
    jd = _negative_datatype(jdt, random.Random(seed), depth)
    td = _negative_datatype(tdt, random.Random(seed), depth)
    assert td.lb < 0 and td.size > 0
    _stacked_bytes_match(jd, td, seed)


def _stacked_bytes_match(jd, td, seed):
    """``n`` stacked rows, each as long as one element of the layout needs
    (from its lowest byte, rebased to 0 where negative, to its highest)."""
    n = random.Random(seed).randint(2, 5)
    segs = td.iovs()
    lo = min(0, td.lb, min(s.offset for s in segs))
    row = max(max(td.lb + td.extent, max(s.offset + s.length for s in segs)) - lo, 1)
    x = np.random.default_rng(seed).integers(0, 255, (n, row), dtype=np.uint8)
    got = tenq._pack_stacked(torch.from_numpy(x), td, 1, n)
    ref = jenq._pack_stacked(jnp.asarray(x), jd, 1, n)
    per_rank = torch.stack([tenq.pack_send(torch.from_numpy(x[i]), td) for i in range(n)])
    assert np.array_equal(got.numpy().view(np.uint8), np.asarray(ref).view(np.uint8))
    assert torch.equal(got, per_rank)


def _kv_span(m, leaf, slot, pos, span):
    L, B, T, W = leaf
    return m.subarray(leaf, (L, 1, span, W), (0, slot, pos, 0), m.BF16)


def test_served_span_rows_pack_in_one_launch(pack_calls):
    """The KV-span subarray continues at the same stride from row to row, so
    the n stacked rows are ONE uniform layout: one kernel launch packs them,
    byte-identical to the reference's host pack."""
    leaf, n = (3, 2, 8, 4), 4
    td, jd = _kv_span(tdt, leaf, 1, 2, 4), _kv_span(jdt, leaf, 1, 2, 4)
    rowed = tenq._rowed_type(torch.empty(n, *leaf, dtype=torch.bfloat16), td, 1, n)
    assert rowed is not None and rowed[1][0] == n * leaf[0]
    x = np.random.default_rng(1).integers(0, 255, (n, int(np.prod(leaf)) * 2), dtype=np.uint8)
    xt = torch.from_numpy(x).view(torch.bfloat16).reshape(n, *leaf)
    got = tenq._pack_stacked(xt, td, 1, n)
    assert len(pack_calls) == 1 and got.dtype == torch.bfloat16
    ref = jenq._pack_stacked(jnp.asarray(x.view(np.uint16).reshape(n, *leaf)).view(jnp.bfloat16), jd, 1, n)
    assert np.array_equal(got.view(torch.uint8).numpy(), np.asarray(ref).view(np.uint8))


def test_rows_not_one_layout_pack_row_by_row(pack_calls):
    """A vector whose extent does not tile the row: the rows are not one
    uniform layout, so each row is packed by its own launch."""
    td = tdt.vector(4, 2, 4, tdt.FLOAT)
    x = torch.arange(3 * 20, dtype=torch.float32).reshape(3, 20)
    assert tenq._rowed_type(x, td, 1, 3) is None
    got = tenq._pack_stacked(x, td, 1, 3)
    assert len(pack_calls) == 3
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy().view(np.uint8), tdt.pack(x[i], td))


# ----------------------------------------------------------------------
# windowed ring sends (1-position mesh, both packages)
# ----------------------------------------------------------------------


def test_send_enqueue_datatype_on_ring(pkg, eng, offload):
    """A datatype-described send through a windowed 1-rank ring comm
    delivers the packed payload (host-issued: the global buffer stacks each
    rank's payload on the leading dim)."""
    comm = _ring(pkg, offload)
    v = pkg.dt.vector(4, 2, 4, pkg.dt.predefined(4))
    buf = np.arange(16, dtype=np.float32)
    win = pkg.enq.OffloadWindow(offload, depth=2, engine=eng)
    y, tok = pkg.enq.send_enqueue(pkg.array(buf[None]), comm, 0, datatype=v, window=win)
    assert tok is None
    win.drain()
    np.testing.assert_array_equal(np.asarray(y)[0], jdt.pack(buf, jdt.vector(4, 2, 4, jdt.predefined(4))).view(np.float32))
    assert win.stats(engine=False)["admitted"] == 1


def test_unreserve_frees_leaked_slot(pkg, eng, offload):
    win = pkg.enq.OffloadWindow(offload, depth=1, engine=eng)
    assert win.reserve()
    win.unreserve()
    assert win.reserve(timeout=1)
    win.unreserve()
    with pytest.raises(RuntimeError, match="unreserve"):
        win.unreserve()


def test_windowed_send_rejects_input_token(pkg, eng, offload):
    comm = _ring(pkg, offload)
    win = pkg.enq.OffloadWindow(offload, depth=2, engine=eng)
    token = object()  # any token: a windowed send takes none
    with pytest.raises(ValueError, match="token"):
        pkg.enq.send_enqueue(pkg.ones((1, 4)), comm, 0, token, window=win)
    with pytest.raises(ValueError, match="token"):
        pkg.enq.isend_enqueue(pkg.ones((1, 4)), comm, 0, token, window=win)
    assert win.stats(engine=False)["admitted"] == 0


def test_windowed_send_rejects_stream_mismatch(pkg, eng, offload):
    other = pkg.ss.stream_create(info={"type": pkg.off}, name="other-off")
    try:
        comm = _ring(pkg, offload)
        win = pkg.enq.OffloadWindow(other, depth=2, engine=eng)
        with pytest.raises(ValueError, match="bound to stream"):
            pkg.enq.send_enqueue(pkg.ones((1, 4)), comm, 0, window=win)
    finally:
        pkg.ss.stream_free(other)


def test_isend_rejects_conflicting_engine_with_window(pkg, eng, offload):
    comm = _ring(pkg, offload)
    win = pkg.enq.OffloadWindow(offload, depth=2, engine=eng)
    other = pkg.pg.ProgressEngine()
    try:
        with pytest.raises(ValueError, match="engine"):
            pkg.enq.isend_enqueue(pkg.ones((1, 4)), comm, 0, engine=other, window=win)
    finally:
        other.stop_all()
    pkg.enq.isend_enqueue(pkg.ones((1, 4)), comm, 0, engine=eng, window=win)
    win.drain(timeout=5)


def test_windowed_datatype_send_checks_leading_dim(pkg, eng, offload):
    comm = _ring(pkg, offload)
    v = pkg.dt.vector(2, 2, 4, pkg.dt.predefined(4))
    win = pkg.enq.OffloadWindow(offload, depth=2, engine=eng)
    with pytest.raises(ValueError, match="ring size"):
        pkg.enq.send_enqueue(pkg.array(np.zeros((3, 8), np.float32)), comm, 0, datatype=v, window=win)


def test_windowed_send_rejects_per_rank_buffers(pkg, eng, offload):
    """Windowed sends are host-side: inside traced code (the reference) or
    a region (the port) they raise."""
    comm = _ring(pkg, offload)
    win = pkg.enq.OffloadWindow(offload, depth=2, engine=eng)

    def per_rank(x):
        return pkg.enq.send_enqueue(x, comm, 0, window=win)[0]

    with pytest.raises(ValueError, match="host-side"):
        if pkg is PKGS["jax"]:
            jax.jit(per_rank)(jnp.ones((1, 4)))
        else:
            shard_map(per_rank, comm.mesh, TP("data"), TP("data"))(torch.ones(1, 4))


def test_isend_enqueue_windowed_steady_state(pkg, eng, offload):
    comm = _ring(pkg, offload)
    win = pkg.enq.OffloadWindow(offload, depth=3, engine=eng)
    reqs = []
    for i in range(9):
        y, req = pkg.enq.isend_enqueue(pkg.full((1, 8), float(i)), comm, 0, window=win)
        reqs.append((i, y, req))
    assert len(win.drain()) == 9
    assert all(r.done for _, _, r in reqs)
    for i, y, _ in reqs:
        assert np.array_equal(np.asarray(y)[0], np.full((8,), float(i)))
    st = win.stats(engine=False)
    assert st["max_depth_seen"] <= 3 and st["admitted"] == 9


def test_window_takes_a_stream_comm(pkg, eng, offload):
    comm = _ring(pkg, offload)
    win = pkg.enq.OffloadWindow(comm, depth=2, engine=eng)
    assert win.stream is offload


# ----------------------------------------------------------------------
# the 4-position ring (port) against the host pack
# ----------------------------------------------------------------------


@pytest.mark.parametrize("offset", [1, 3])
def test_windowed_ring_of_four_delivers_host_packed_rows(pack_calls, offset):
    """16 windowed sends of the KV span over a ring of 4: row i lands in
    row (i + offset) % 4, byte-equal to the host engine's pack of row i;
    the window admits and reaps all 16 within its depth, and each send packs
    its 4 rows with one kernel launch."""
    e = tpg.ProgressEngine()
    s = tss.stream_create(info={"type": "cudaStream_t"}, name="ring4")
    try:
        comm = tss.stream_comm_create(make_mesh((4,), ("data",), device="cpu"), "data", s)
        leaf = (3, 2, 8, 4)
        rng = np.random.default_rng(offset)
        win = tenq.OffloadWindow(comm, depth=2, engine=e)
        sent = []
        for k in range(16):
            x = torch.from_numpy(rng.integers(0, 255, (4, int(np.prod(leaf)) * 2), dtype=np.uint8))
            x = x.view(torch.bfloat16).reshape(4, *leaf)
            dt = _kv_span(tdt, leaf, k % 2, 2 * (k % 3), 4)
            y, _ = tenq.isend_enqueue(x, comm, offset, datatype=dt, window=win)
            sent.append((x, dt, y))
        assert len(win.drain(timeout=_T)) == 16
        st = win.stats(engine=False)
        assert st["admitted"] == st["reaped"] == 16 and st["max_depth_seen"] <= 2
        assert len(pack_calls) == 16
        for x, dt, y in sent:
            for i in range(4):
                want = tdt.pack(x[i], dt)
                np.testing.assert_array_equal(y[(i + offset) % 4].view(torch.uint8).numpy(), want)
    finally:
        e.stop_all()
        tss.stream_free(s)


# ----------------------------------------------------------------------
# recorded windowed sends
# ----------------------------------------------------------------------


def test_isend_enqueue_scheduled_record_replay_and_stale(pack_calls):
    """Record once, replay with bound buffers: every replay's rows equal an
    eager send's bytes; a buffer of another shape raises ScheduleStale."""
    e = tpg.ProgressEngine()
    s = tss.stream_create(info={"type": "cudaStream_t"}, name="sched-ring")
    try:
        comm = tss.stream_comm_create(make_mesh((4,), ("data",), device="cpu"), ("data",), s)
        leaf = (3, 2, 8, 4)
        dt = _kv_span(tdt, leaf, 1, 2, 4)
        win = tenq.OffloadWindow(comm, depth=2, engine=e)
        sched = tsch.Schedule(engine=e, stream=s, name="ring-send")
        bufs = [torch.randn(4, *leaf, generator=torch.Generator().manual_seed(i)).to(torch.bfloat16)
                for i in range(3)]
        with sched.record():
            y0, _ = tenq.isend_enqueue_scheduled(bufs[0], comm, 1, schedule=sched, window=win, bind="x", out="y",
                                                 datatype=dt)
        win.drain(timeout=_T)
        eager = tenq._pack_stacked(bufs[0], dt, 1, 4).roll(1, 0)
        assert torch.equal(y0.view(torch.uint8), eager.view(torch.uint8))
        for b in bufs[1:]:
            ctx = sched.replay(binding={"x": b}).wait(timeout=_T)
            want = torch.stack([torch.from_numpy(tdt.pack(b[i], dt)).view(torch.bfloat16) for i in range(4)]).roll(1, 0)
            assert torch.equal(ctx.outputs["y"].view(torch.uint8), want.view(torch.uint8))
        win.drain(timeout=_T)
        assert len(pack_calls) == 4  # one launch over all rows: record, the eager check, two replays
        with pytest.raises(tsch.ScheduleStale):
            sched.replay(binding={"x": torch.zeros(4, 3, 2, 8, 2, dtype=torch.bfloat16)})
        assert win.stats(engine=False)["admitted"] == 3
    finally:
        e.stop_all()
        tss.stream_free(s)


# ----------------------------------------------------------------------
# stream communicators (tests/test_streams_progress.py:42-50)
# ----------------------------------------------------------------------


def test_stream_comm_create_and_null_stream(pkg):
    comm = pkg.ss.stream_comm_create(None, ("data",))
    assert comm.stream.is_null  # reverts to conventional communicator
    s = pkg.ss.stream_create(name="x")
    mc = pkg.ss.stream_comm_create_multiplex(None, "data", [s, pkg.ss.STREAM_NULL])
    assert mc.is_multiplex
    assert pkg.ss.comm_get_stream(mc, 0) is s
    assert pkg.ss.comm_get_stream(mc, 1).is_null
    assert mc.channel == s.channel and mc.with_axes(("pod",)).streams == mc.streams
    with pytest.raises(ValueError):
        pkg.ss.StreamComm(())
    pkg.ss.stream_free(s)


# ----------------------------------------------------------------------
# adaptive window depth, one completion schedule for both packages
# ----------------------------------------------------------------------


def _adaptive_trace(pkg):
    """Drive an adaptive window from the test thread alone: request i
    completes when the test flips its flag, and the window (its own poller)
    retires it while it parks in ``reserve``. Phase 1 keeps the window full
    (every admission parks once), phase 2 completes at once and drains
    after each send. Returns the depth after each reserve and the stats."""
    e = pkg.pg.ProgressEngine()
    s = pkg.ss.StreamPool().create(name="adapt")
    win = pkg.enq.OffloadWindow(s, depth=1, engine=e, adaptive=True, min_depth=1, max_depth=4, adapt_every=2)
    depths, flags = [], []
    try:
        for i in range(12):
            if flags:
                flags[-1]["go"] = True  # the schedule: the previous request completes now
            st = {"go": False}
            flags.append(st)
            req = e.grequest_start(poll_fn=lambda x: x["go"], extra_state=st, stream=s, name=f"ad-{i}")
            assert win.admit(req, timeout=_T) is not None
            depths.append(win.depth)
        flags[-1]["go"] = True
        win.drain(timeout=_T)
        grown = win.stats(engine=False)
        for i in range(16):
            with win.issue(timeout=_T) as submit:
                submit(e.grequest_start(poll_fn=lambda _s: True, stream=s, name=f"id-{i}"))
            depths.append(win.depth)
            win.drain(timeout=_T)
        st = win.stats(engine=False)
    finally:
        e.stop_all()
    return depths, grown, {k: st[k] for k in ("depth", "depth_grows", "depth_shrinks", "admitted", "reaped")}


def test_adaptive_window_depth_matches_reference():
    ref = _adaptive_trace(PKGS["jax"])
    got = _adaptive_trace(PKGS["torch"])
    assert got == ref
    depths, grown, final = got
    assert grown["depth_grows"] > 0 and grown["depth"] > 1  # grows under backpressure
    assert final["depth_shrinks"] > 0 and final["depth"] < grown["depth"]  # shrinks when idle
