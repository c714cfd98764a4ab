"""The port's distributed layer (ROADMAP P9) against the JAX package's: stream
communicators, the stream collectives, the hierarchical all-reduce, mesh
thread communicators, the per-rank enqueue sends and the hybrid
host × mesh allreduce, on the ``(2, 4)`` ``("pod", "data")`` mesh.

The reference needs 8 devices, so it runs in a subprocess (this file run as
a script) with the forced device count set in that process only; it reads
the seeded numpy inputs and writes every rank's results to one ``.npz``. The
port runs the same per-rank bodies on the CPU, where its mesh positions are
thread-ranks. Mirrors the P9 checks of ``tests/multidevice_checks.py``
(``threadcomm_rank`` … ``enqueue_shift_*``, ``hybrid_allreduce_large``) and
the hybrid cases of ``tests/test_threadcomm_host.py``.

Tolerances: integer-valued fp32 inputs (sums exact in any order) and every
pure data movement are held exactly; sums of random fp32 inputs, which the
two packages fold in different orders, to |a - b| <= 1e-6 · max |b|.
"""

import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

W = 512  # fp32 per rank: 2 KiB
HYB_SHAPES = {"int": (8, 96), "rand": (8, 4, 24)}
SUMS = {"flat", "hier", "ar_data", "rs", "rs_ag", "ms_ar"}  # outputs that add fp32 values


def _inputs():
    rng = np.random.default_rng(0)
    out = {
        "int": rng.integers(-4, 5, (8, W)).astype(np.float32),
        "rand": rng.standard_normal((8, W)).astype(np.float32),
    }
    for kind, shape in HYB_SHAPES.items():
        for t in range(2):
            v = rng.integers(-4, 5, shape) if kind == "int" else rng.standard_normal(shape)
            out[f"hyb_{kind}_{t}"] = v.astype(np.float32)
    return out


def _cases(m, mesh):
    """The per-rank body over every collective and per-rank send, with its
    out_specs: ``m`` is the reference's or the port's namespace."""
    C, col, enq, hier, P = m.C, m.col, m.enq, m.hier, m.P
    tc = C.threadcomm_init(mesh, ("pod", "data"))
    pd = C.stream_comm_create(mesh, ("pod", "data"))
    data = C.stream_comm_create(mesh, ("data",))
    streams = [C.stream_create(name=f"p9-s{i}") for i in range(4)]
    comms = [C.stream_comm_create(mesh, ("pod", "data"), s) for s in streams]
    dcomms = [C.stream_comm_create(mesh, ("data",), s) for s in streams[:2]]
    mux = C.stream_comm_create_multiplex(mesh, ("data",), streams[:2])
    off = C.stream_create(info={"type": m.offload_type}, name="p9-off")
    ec = C.stream_comm_create(mesh, ("data",), off)
    ring = [(i, (i + 1) % 4) for i in range(4)]

    def body(xs):
        out = {}
        out["rank"] = m.as1(tc.rank())
        out["flat"], _ = hier.flat_all_reduce(xs, tc)
        out["hier"], _ = hier.hierarchical_all_reduce(xs, tc, axis=1)
        out["ar_data"], _ = col.all_reduce(xs, data)
        out["ag_tiled"], _ = col.all_gather(xs, pd, axis=1)
        out["ag_stack"], _ = col.all_gather(xs, data, axis=0, tiled=False)
        out["rs"], _ = col.reduce_scatter(xs, comms[0], axis=1)
        out["rs_ag"], _ = col.all_gather(out["rs"], comms[0], axis=1)
        out["a2a"], _ = col.all_to_all(xs, data, split_axis=1, concat_axis=0)
        out["ppermute"], _ = col.ppermute(xs, data, [(0, 2), (1, 0), (2, 1)])
        out["bcast"], _ = col.broadcast(xs, pd, root=5)
        out["pshuffle"], _ = col.pshuffle(xs, data, shift=1)
        out["ms_ar"], _ = col.multi_stream_all_reduce(xs, comms, [m.new_token() for _ in comms], axis=1)
        out["ms_ag"], _ = col.multi_stream_all_gather(xs, dcomms, axis=1, gather_axis=0)
        out["ssr"], _ = col.stream_send_recv(xs, mux, ring, source_stream_index=0, dest_stream_index=1)
        out["sendrecv"], _ = enq.sendrecv_enqueue(xs, ec, [(i, (i - 1) % 4) for i in range(4)])
        out["shift_fwd"], _ = enq.shift_enqueue(xs, ec, shift=1)
        out["shift_back"], _ = enq.shift_enqueue(xs, ec, shift=-1)
        out["send"], _ = enq.send_enqueue(xs, ec, 2)
        out["recv"], _ = enq.recv_enqueue(xs, ec, 3)
        return tuple(out[k] for k in NAMES)

    def free():
        for s in streams + [off]:
            C.stream_free(s)

    return body, tuple(P() if k == "rs_ag" else P(("pod", "data")) for k in NAMES), tc, free


NAMES = ("rank", "flat", "hier", "ar_data", "ag_tiled", "ag_stack", "rs", "rs_ag", "a2a", "ppermute", "bcast",
         "pshuffle", "ms_ar", "ms_ag", "ssr", "sendrecv", "shift_fwd", "shift_back", "send", "recv")


def _hybrid(m, mesh, vals, timeout):
    """Two host threads × the mesh: each thread's ``allreduce_large``."""
    host = m.tc.HostThreadComm(2, engine=m.PE(), pool=m.Pool(), name="p9-hyb")
    hybrid = m.C.threadcomm_init(mesh, ("pod", "data")).with_host_threads(host)
    out, errors = {}, []

    def worker(t):
        h = host.attach(rank=t)
        try:
            out[t] = hybrid.allreduce_large(h, vals[t], timeout=timeout)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            h.detach()

    host.start()
    try:
        threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
        assert not any(th.is_alive() for th in threads), "hybrid worker still running"
    finally:
        host.finish(timeout=10.0)
    if errors:
        raise errors[0]
    return [out[0], out[1]]


def _jax_namespace():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    import repro.core as C
    from repro.core import collectives, enqueue, hierarchical, threadcomm
    from repro.core.progress import ProgressEngine
    from repro.core.streams import StreamPool

    return SimpleNamespace(C=C, col=collectives, enq=enqueue, hier=hierarchical, tc=threadcomm, P=PartitionSpec,
                           PE=ProgressEngine, Pool=StreamPool, new_token=C.new_token, offload_type="tpu_stream",
                           as1=lambda r: jnp.reshape(r, (1,)), mesh=lambda: jax.make_mesh((2, 4), ("pod", "data")),
                           array=jnp.asarray, numpy=np.asarray)


def _torch_namespace():
    import repro_torch.core as C
    from repro_torch.core import collectives, enqueue, hierarchical, threadcomm
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.core.streams import StreamPool

    return SimpleNamespace(C=C, col=collectives, enq=enqueue, hier=hierarchical, tc=threadcomm, P=C.P,
                           PE=ProgressEngine, Pool=StreamPool, new_token=lambda: C.new_token("cpu"),
                           offload_type="cudaStream_t", as1=lambda r: torch.tensor([r], dtype=torch.int32),
                           mesh=lambda: C.make_mesh((2, 4), ("pod", "data"), device="cpu"),
                           array=torch.from_numpy, numpy=lambda t: t.numpy())


def run_package(m, inputs) -> dict:
    """Every case of one package on ``inputs``: name → numpy result."""
    mesh = m.mesh()
    res = {}
    for kind in ("int", "rand"):
        body, out_specs, tc, free = _cases(m, mesh)
        try:
            got = tc.run(body, m.array(inputs[kind]), in_specs=m.P(("pod", "data")), out_specs=out_specs)
        finally:
            free()
        for name, v in zip(NAMES, got):
            res[f"{kind}/{name}"] = m.numpy(v)
        vals = [inputs[f"hyb_{kind}_{t}"] for t in range(2)]
        for t, v in enumerate(_hybrid(m, mesh, vals, timeout=60.0)):
            res[f"{kind}/hybrid_{t}"] = np.asarray(v)
    return res


def _oracle_main(in_path: str, out_path: str) -> None:
    """Subprocess entry: the reference over 8 forced host devices."""
    inputs = dict(np.load(in_path))
    np.savez(out_path, **run_package(_jax_namespace(), inputs))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(inputs, reference results, port results)."""
    d = tmp_path_factory.mktemp("p9")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(d / "in.npz"), str(d / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"reference subprocess failed:\n{proc.stderr[-4000:]}"
    ref = dict(np.load(d / "out.npz"))
    return inputs, ref, run_package(_torch_namespace(), inputs)


def _hold(got, want, name):
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape, got.dtype, want.dtype)
    kind, case = name.split("/")
    if kind == "rand" and (case in SUMS or case.startswith("hybrid")):
        assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want)), name
    else:
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("kind", ["int", "rand"])
@pytest.mark.parametrize("case", list(NAMES) + ["hybrid_0", "hybrid_1"])
def test_port_matches_reference(results, kind, case):
    _, ref, got = results
    _hold(got[f"{kind}/{case}"], ref[f"{kind}/{case}"], f"{kind}/{case}")


@pytest.mark.parametrize("kind", ["int", "rand"])
def test_multidevice_checks_hold_on_the_port(results, kind):
    """The named P9 checks of tests/multidevice_checks.py:51-158 on the
    port's own results."""
    inputs, _, got = results
    x = inputs[kind]
    total = x.sum(0)
    tol = 0 if kind == "int" else 1e-6 * np.abs(total).max()
    r = lambda name: got[f"{kind}/{name}"]
    assert np.array_equal(r("rank"), np.arange(8))  # threadcomm_rank
    assert np.abs(r("flat") - total).max() <= tol  # flat_allreduce, on every rank
    assert np.abs(r("hier") - r("flat")).max() <= tol  # hier_eq_flat
    assert np.abs(r("ms_ar") - total).max() <= tol  # multistream_allreduce
    assert np.abs(r("rs_ag")[0] - total).max() <= tol  # rs_ag_eq_ar
    y4 = r("shift_fwd")
    assert np.all(y4[0] == 0) and np.all(y4[4] == 0)  # enqueue_shift_zerofill
    assert np.array_equal(y4[1], x[0]) and np.array_equal(y4[5], x[4])  # enqueue_shift_payload
    hyb = sum(inputs[f"hyb_{kind}_{t}"] for t in range(2)).sum(0)
    for t in range(2):  # hybrid_allreduce_large
        h = r(f"hybrid_{t}")
        assert h.shape == hyb.shape and np.abs(h - hyb).max() <= (0 if kind == "int" else 1e-6 * np.abs(hyb).max())


# ----------------------------------------------------------------------
# geometry, identity and the threadcomm algebra (in-process, both packages)
# ----------------------------------------------------------------------


class _StubMesh:
    """Mesh stand-in for rank-arithmetic checks (no devices needed)."""

    def __init__(self, **shape):
        self.shape = dict(shape)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_comm_test_threadcomm_and_algebra(pkg):
    m = _jax_namespace() if pkg == "jax" else _torch_namespace()
    mesh = _StubMesh(pod=2, data=4)
    tc = m.C.threadcomm_init(mesh, ("pod", "data"))
    assert m.C.comm_test_threadcomm(tc) and not m.C.comm_test_threadcomm(tc.outer())
    assert tc.size() == 8 and tc.axis_sizes() == (2, 4)
    assert tc.inner().axes == ("data",) and tc.outer().axes == ("pod",)
    assert m.C.split_comm(tc, ("data",)) == tc.inner()
    assert m.C.flatten_comm(mesh, "pod", "data").axes == ("pod", "data")
    assert m.C.threadcomm_free(tc) is None
    with pytest.raises(ValueError):
        m.C.threadcomm_init(mesh, ("pod", "model"))
    with pytest.raises(ValueError):
        tc.sub(("model",))
    sc = tc.as_stream_comm()
    assert sc.axes == ("pod", "data") and sc.stream.is_null and sc.size() == 8 and sc.axis_sizes() == (2, 4)
    assert sc.with_axes(("data",)).axes == ("data",)
    host = m.tc.HostThreadComm(3, engine=m.PE(), pool=m.Pool())
    assert m.C.comm_test_threadcomm(host) and not m.C.comm_test_threadcomm(
        m.tc.HostThreadComm(1, engine=m.PE(), pool=m.Pool()))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_hybrid_rank_numbering_mesh_major(pkg):
    """Mirror of tests/test_threadcomm_host.py:659-691: one flat rank space
    numbered like the paper, all M thread-ranks of mesh position 0 first."""
    m = _jax_namespace() if pkg == "jax" else _torch_namespace()
    mesh = _StubMesh(pod=2, data=4)
    mc = m.C.threadcomm_init(mesh, ("pod", "data"))
    host = m.tc.HostThreadComm(3, engine=m.PE(), pool=m.Pool())
    hybrid = mc.with_host_threads(host)
    assert hybrid.size() == 24 and hybrid.axis_sizes() == (2, 4, 3)
    assert m.C.comm_test_threadcomm(hybrid) and hybrid.is_threadcomm
    flat = [hybrid.static_rank((p, d), t) for p in range(2) for d in range(4) for t in range(3)]
    assert flat == list(range(24))
    with pytest.raises(ValueError):
        hybrid.static_rank((2, 0), 0)
    with pytest.raises(ValueError):
        hybrid.static_rank((0, 0), 3)
    assert hybrid.inner() is host and hybrid.outer() is mc
    counted = m.C.threadcomm_init(_StubMesh(data=4), ("data",)).with_host_threads(2)
    assert counted.size() == 8 and counted.host.nthreads == 2 and m.C.comm_test_threadcomm(counted)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stream_identity_as_stream_comm(pkg):
    """Mirror of tests/test_threadcomm_host.py:599-609."""
    m = _jax_namespace() if pkg == "jax" else _torch_namespace()
    comm = m.tc.HostThreadComm(2, engine=m.PE(), pool=m.Pool())
    comm.start()
    try:
        h = comm.attach(rank=1)
        try:
            assert h.stream.kind == "compute" and h.channel == h.stream.channel
            sc = h.as_stream_comm()
            assert sc.stream is h.stream and sc.axes == ("__host__",)
            assert h.as_stream_comm(_StubMesh(pod=2, data=4)).axes == ("pod", "data")
        finally:
            h.detach()
        comm.attach(rank=0).detach()
    finally:
        comm.finish(timeout=5.0)


def test_hybrid_rank_inside_region():
    """HybridThreadComm.rank(): mesh flat rank · nthreads + thread rank, read
    inside a region by an attached thread."""
    m = _torch_namespace()
    mesh = m.mesh()
    host = m.tc.HostThreadComm(2, engine=m.PE(), pool=m.Pool())
    hybrid = m.C.threadcomm_init(mesh, ("pod", "data")).with_host_threads(host)
    host.start()
    try:
        h = host.attach(rank=1)
        try:
            ranks = m.C.shard_map(lambda: torch.tensor([hybrid.rank(h)]), mesh, (), m.P(("pod", "data")))()
        finally:
            h.detach()
        host.attach(rank=0).detach()
    finally:
        host.finish(timeout=5.0)
    assert ranks.tolist() == [2 * r + 1 for r in range(8)]


# ----------------------------------------------------------------------
# the port's mesh layer: specs, regions, failure
# ----------------------------------------------------------------------


def test_mesh_specs_and_region_context():
    m = _torch_namespace()
    mesh = m.mesh()
    assert mesh.shape == {"pod": 2, "data": 4} and mesh.size == 8
    assert mesh.coords(6) == {"pod": 1, "data": 2}
    assert m.P("pod", "data").dim_axes(1) == ("data",)  # one entry per dim, as the reference's specs
    with pytest.raises(ValueError):
        m.P("pod", "pod")  # an axis shards at most one dim
    with pytest.raises(RuntimeError, match="region"):
        m.C.mesh.axis_index("data")
    x = torch.arange(24.0).reshape(4, 6)

    def body(xs, rep):
        return xs + 0, rep[None] * (m.C.mesh.axis_index("pod") * 10 + m.C.mesh.axis_index("data")), \
            torch.tensor([m.C.mesh.axis_size("data")])

    blocks, coords, sizes = m.C.shard_map(body, mesh, (m.P("data"), m.P()), (m.P("data"), m.P(("pod", "data")),
                                                                            m.P()))(x, torch.ones(()))
    assert torch.equal(blocks, x)  # split by data, replicated over pod: pod 0's blocks gathered
    assert coords.tolist() == [0, 1, 2, 3, 10, 11, 12, 13] and sizes.tolist() == [4]
    with pytest.raises(ValueError, match="does not split"):
        m.C.shard_map(lambda xs: xs, mesh, m.P(("pod", "data")), m.P())(torch.ones(6))


def test_failing_rank_raises_within_timeout_and_leaves_no_thread(monkeypatch):
    """A rank that raises fails the region: its peers, blocked in a
    collective, wake at once; the caller gets the first failure; no rank
    thread outlives the call. A rank that never arrives times out."""
    m = _torch_namespace()
    mesh = m.mesh()
    tc = m.C.threadcomm_init(mesh, ("pod", "data"))
    before = set(threading.enumerate())

    def body(xs):
        if tc.rank() == 5:
            raise KeyError("rank 5 failed")
        y, _ = m.hier.flat_all_reduce(xs, tc)
        return y

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 5"):
        tc.run(body, torch.ones(8, 4), in_specs=m.P(("pod", "data")), out_specs=m.P())
    assert time.monotonic() - t0 < m.C.mesh.RENDEZVOUS_TIMEOUT_S
    assert set(threading.enumerate()) <= before

    def straggler(xs):
        if tc.rank() == 0:
            return xs  # skips the collective its peers wait in
        y, _ = m.hier.flat_all_reduce(xs, tc)
        return y

    monkeypatch.setattr(m.C.mesh, "RENDEZVOUS_TIMEOUT_S", 0.5)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="7 of 8"):
        m.C.shard_map(straggler, mesh, m.P(("pod", "data")), m.P())(torch.ones(8, 4))
    assert time.monotonic() - t0 < 5.0
    assert set(threading.enumerate()) <= before


def test_rendezvous_stress_more_ranks_than_cores():
    """16 thread-ranks, 40 rounds of collectives on two axis groups each,
    with a short switch interval: every round's sums stay exact and the
    per-group sequence numbers never cross-match."""
    m = _torch_namespace()
    mesh = m.C.make_mesh((4, 4), ("pod", "data"), device="cpu")
    tc = m.C.threadcomm_init(mesh, ("pod", "data"))
    data = tc.inner().as_stream_comm()
    x = torch.from_numpy(np.random.default_rng(3).integers(-4, 5, (16, 64)).astype(np.float32))

    def body(xs):
        acc = torch.zeros_like(xs)
        for k in range(40):
            y, _ = m.hier.flat_all_reduce(xs + k, tc)
            z, _ = m.col.reduce_scatter(xs, data, axis=1)
            acc += y - 16 * k
            acc[:, : z.shape[1]] += z - z
        return acc

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = tc.run(body, x, in_specs=m.P(("pod", "data")), out_specs=m.P(("pod", "data")))
    finally:
        sys.setswitchinterval(old)
    assert torch.equal(out, 40 * x.sum(0, keepdim=True).expand(16, -1))


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2])
