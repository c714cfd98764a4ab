"""The reference's recorded-schedule suite (``tests/test_schedule.py``,
its lifecycle, fused request sets and invalidation) over both packages
(``pkg`` is ``jax`` or ``torch``): the same bodies and assertions on
``repro.core.schedule`` and ``repro_torch.core.schedule``. Its
record-seal-replay, stale-fingerprint and prewait cases are
``tests/test_torch_core.py``'s (extended to its assertions); the port's
scheduled loops are held byte for byte against their eager paths where
the port runs them (``tests/test_torch_{pipeline,train,serving,threadcomm}.py``).
"""

from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core.progress as jpg  # noqa: E402
import repro.core.schedule as jsch  # noqa: E402
import repro_torch.core.progress as tpg  # noqa: E402
import repro_torch.core.schedule as tsch  # noqa: E402
from test_torch_core import _record_double  # noqa: E402

PKGS = {"jax": SimpleNamespace(pg=jpg, sch=jsch), "torch": SimpleNamespace(pg=tpg, sch=tsch)}
_T = 20.0  # generous op timeout: CI hosts stall


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def test_record_bracket_aborts_on_error(pkg):
    sched = pkg.sch.Schedule(engine=pkg.pg.ProgressEngine(), name="t-abort")
    with pytest.raises(RuntimeError, match="boom"):
        with sched.record():
            sched.add_op("noop", lambda ctx: None, parts=0)
            raise RuntimeError("boom")
    # the context manager aborted the recording: nothing was kept
    assert sched.state == "IDLE"
    assert sched.stats()["ops"] == 0


def test_replay_before_seal_raises(pkg):
    sched = pkg.sch.Schedule(engine=pkg.pg.ProgressEngine(), name="t-unsealed")
    with pytest.raises(pkg.sch.ScheduleStateError):
        sched.replay()
    rec = sched.record()
    try:
        with pytest.raises(pkg.sch.ScheduleStateError):
            sched.replay()  # still recording
    finally:
        rec.abort()


def test_missing_binding_is_a_schedule_error(pkg):
    sched = pkg.sch.Schedule(engine=pkg.pg.ProgressEngine(), name="t-bind")
    _record_double(sched)
    with pytest.raises(pkg.sch.ScheduleError, match="needs binding 'x'"):
        sched.replay(binding={"wrong": 1}, timeout=_T)


def test_fused_part_overflow_is_caught(pkg):
    sched = pkg.sch.Schedule(engine=pkg.pg.ProgressEngine(), name="t-overflow")

    def issue(ctx):
        ctx.fused.part(poll_fn=lambda st: True)
        ctx.fused.part(poll_fn=lambda st: True)  # one more than recorded

    rec = sched.record()
    try:
        sched.add_op("op", issue, parts=1)
        rec.seal()
    finally:
        rec.abort()
    with pytest.raises(ValueError, match="exceeds the recorded count"):
        sched.replay(timeout=_T)
    # the failed replay cancelled its fused set: one sweep drains the queue
    sched.engine.progress()
    assert sched.engine.pending() == 0


def test_mid_issue_stale_cancels_fused_set(pkg):
    sched = pkg.sch.Schedule(engine=pkg.pg.ProgressEngine(), name="t-midstale")
    rec = sched.record()
    try:
        sched.fingerprint(shape=(4,))

        def check(ctx):
            ctx.schedule.check(shape=tuple(ctx.bound("x").shape))

        def issue(ctx):
            ctx.fused.part(poll_fn=lambda st: True)

        sched.add_op("check", check, parts=0)
        sched.add_op("op", issue, parts=1)
        rec.seal()
    finally:
        rec.abort()
    ctx = sched.replay(binding={"x": np.zeros(4)}, timeout=_T)
    assert ctx.done
    with pytest.raises(pkg.sch.ScheduleStale):
        sched.replay(binding={"x": np.zeros(5)}, timeout=_T)
    sched.engine.progress()
    assert sched.engine.pending() == 0


def test_engine_counts_fused_sets_and_parts(pkg):
    eng = pkg.pg.ProgressEngine()
    sched = pkg.sch.Schedule(engine=eng, name="t-count")
    _record_double(sched)
    before = eng.stats()
    for i in range(3):
        sched.replay(binding={"x": i}, timeout=_T)
    after = eng.stats()
    assert after["fused_sets"] - before["fused_sets"] == 3
    assert after["fused_parts"] - before["fused_parts"] == 3


def test_finalizers_run_once_after_wait(pkg):
    sched = pkg.sch.Schedule(engine=pkg.pg.ProgressEngine(), name="t-fin")
    order = []

    def issue(ctx):
        ctx.fused.part(poll_fn=lambda st: True)
        ctx.finalizers.append(lambda: order.append("op"))

    rec = sched.record()
    try:
        sched.add_op("op", issue, parts=1)
        sched.add_finalizer(lambda: order.append("sched"))
        rec.seal()
    finally:
        rec.abort()
    ctx = sched.replay(timeout=_T)
    ctx.wait(timeout=_T)
    # op-level finalizers first, then the schedule's per-replay ones
    assert order == ["op", "sched"]
