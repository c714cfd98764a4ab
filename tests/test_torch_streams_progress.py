"""The reference's MPIX-streams and generalized-request suite
(``tests/test_streams_progress.py``) over both packages (``pkg`` is
``jax`` or ``torch``): the same bodies and assertions on ``repro.core``
and ``repro_torch.core``. Its cases that ``tests/test_torch_core.py``
already holds (the pool's exhaustion, ``info_set_hex``, a polled and an
externally completed request, the batched ``wait_all``, progress on one
stream) are there.
"""

import threading
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("jax")

import repro.core.progress as jpg  # noqa: E402
import repro.core.streams as jss  # noqa: E402
import repro_torch.core.progress as tpg  # noqa: E402
import repro_torch.core.streams as tss  # noqa: E402

PKGS = {"jax": SimpleNamespace(pg=jpg, ss=jss), "torch": SimpleNamespace(pg=tpg, ss=tss)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------- streams


def test_offload_streams_share_endpoints(pkg):
    pool = pkg.ss.StreamPool(max_channels=2)
    offs = [pool.create(info={"type": "cudaStream_t"}) for _ in range(5)]
    assert all(o.is_offload for o in offs)  # never exhausts
    assert len({o.channel for o in offs}) <= 2


def test_stream_comm_create_and_null_stream(pkg):
    comm = pkg.ss.stream_comm_create(None, ("data",))
    assert comm.stream.is_null  # reverts to conventional communicator
    s = pkg.ss.stream_create(name="x")
    mc = pkg.ss.stream_comm_create_multiplex(None, "data", [s, pkg.ss.STREAM_NULL])
    assert mc.is_multiplex
    assert pkg.ss.comm_get_stream(mc, 0) is s
    assert pkg.ss.comm_get_stream(mc, 1).is_null
    pkg.ss.stream_free(s)


def test_double_free_raises(pkg):
    s = pkg.ss.stream_create(name="df")
    pkg.ss.stream_free(s)
    with pytest.raises(RuntimeError):
        pkg.ss.stream_free(s)


# ---------------------------------------------------------------- progress


# ---------------------------------------------------------------- progress


def test_progress_thread_spin_up_down(pkg):
    pool = pkg.ss.StreamPool()
    s = pool.create()
    eng = pkg.pg.ProgressEngine()
    done = threading.Event()

    def poll(st):
        return done.is_set()

    r = eng.grequest_start(poll_fn=poll, stream=s)
    eng.start_progress_thread(s, interval=0.001)
    time.sleep(0.05)
    assert not r.done
    done.set()
    t0 = time.monotonic()
    while not r.done and time.monotonic() - t0 < 5:
        time.sleep(0.005)
    assert r.done  # background thread completed it — no main-thread polls
    eng.stop_progress_thread(s)


def test_global_lock_mode_still_correct(pkg):
    eng = pkg.pg.ProgressEngine(global_lock=True)
    rs = [eng.grequest_start(poll_fn=lambda st: True) for _ in range(4)]
    assert eng.wait_all(rs, timeout=5)


def test_cancel(pkg):
    eng = pkg.pg.ProgressEngine()
    r = eng.grequest_start(poll_fn=lambda st: False)
    r.cancel()
    assert r.done
