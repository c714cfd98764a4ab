"""The port's paged serving path against the JAX package's, token for token:
``PagedServeEngine`` (seeded admission, a tight pool with spill, the
elastic loop with a killed rank, deeper admission at equal memory), the
admission front end, the threaded generation loop and elastic serving.

The smoke ``qwen1.5-0.5b`` in fp32 on both sides (the JAX weights go across
with ``params_from_numpy``), the same seeded prompts, the scenarios of the
reference's own tests. fp32 keeps the two greedy decodes identical. The
JAX engines of one ``max_len`` share one pair of jitted functions, so the
reference compiles each prompt length once for the whole file."""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.progress import ProgressEngine as JProgressEngine  # noqa: E402
from repro.ft import faultinject as j_fi  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.admission import AdmissionFrontEnd as JAdmissionFrontEnd  # noqa: E402
from repro.serving.engine import PagedServeEngine as JPagedServeEngine  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.progress import ProgressEngine as TProgressEngine  # noqa: E402
from repro_torch.core.streams import default_pool as t_default_pool  # noqa: E402
from repro_torch.ft import faultinject as t_fi  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.admission import AdmissionFrontEnd as TAdmissionFrontEnd  # noqa: E402
from repro_torch.serving.admission import make_offer  # noqa: E402
from repro_torch.serving.engine import PagedServeEngine as TPagedServeEngine  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TServeEngine  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def side():
    jcfg = j_get_config("qwen1.5-0.5b", smoke=True).replace(**FP32)
    tcfg = t_get_config("qwen1.5-0.5b", smoke=True).replace(**FP32)
    jp = japi.init_params(jcfg, jax.random.key(0))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jitted = {}

    def jax_engine(cls, **kw):
        eng = cls(jcfg, jp, **kw)
        fns = jitted.setdefault(kw["max_len"], (eng._decode, eng._prefill))
        eng._decode, eng._prefill = fns  # same cfg and max_len: the same functions
        return eng

    def torch_engine(cls, **kw):
        return cls(tcfg, model, **kw)

    return dict(jcfg=jcfg, tcfg=tcfg, vocab=jcfg.vocab, jax=jax_engine, torch=torch_engine)


def _submit_seeded(eng, vocab, seed=3, n=9, lo=2, hi=12, mnt_hi=8):
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        plen = int(rng.integers(lo, hi))
        prompt = rng.integers(1, vocab, size=plen).astype(np.int32)
        reqs.append(eng.submit(prompt, max_new_tokens=int(rng.integers(1, mnt_hi))))
    return reqs


def _kv_stats(eng):
    st = dict(eng.stats()["kv"])
    st.pop("spill_window", None)
    return st


# ------------------------------------------------ PagedServeEngine


@pytest.mark.parametrize("seed", [3, 7])
def test_paged_tokens_match_reference_under_seeded_admission(side, seed):
    outs = {}
    for pkg in ("jax", "torch"):
        eng = side[pkg](JPagedServeEngine if pkg == "jax" else TPagedServeEngine,
                        max_batch=2, max_len=32, page_size=4, pool_pages=24)
        reqs = _submit_seeded(eng, side["vocab"], seed=seed)
        eng.run_until_done(max_steps=300)
        outs[pkg] = ([r.out_tokens for r in reqs], _kv_stats(eng), eng.max_concurrent)
    assert outs["torch"] == outs["jax"]  # tokens, page counters, admission depth
    tokens, kv, depth = outs["torch"]
    assert kv["pages_in_use"] == 0 and kv["appends"] > 0 and kv["gathers"] > 0
    assert depth > 2  # prefill-ahead parking admitted deeper than the slot count


def test_paged_tight_pool_with_spill_matches_reference(side):
    outs = {}
    for pkg, PE in (("jax", JProgressEngine), ("torch", TProgressEngine)):
        pe = PE()
        eng = side[pkg](JPagedServeEngine if pkg == "jax" else TPagedServeEngine, max_batch=2, max_len=32,
                        page_size=4, pool_pages=9, spill_parked=True, progress_engine=pe)
        reqs = _submit_seeded(eng, side["vocab"], seed=3)
        eng.run_until_done(max_steps=300)
        outs[pkg] = ([r.out_tokens for r in reqs], eng.stats()["kv"])
        pe.stop_all()
    assert outs["torch"][0] == outs["jax"][0]
    kv = outs["torch"][1]
    assert kv["spilled_pages"] > 0 and kv["reloaded_pages"] == kv["spilled_pages"]
    assert kv["cold_pages"] == 0 and kv["pages_in_use"] == 0


def test_paged_elastic_loop_with_kill_matches_reference(side):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, side["vocab"], (4 + i,)).astype(np.int32) for i in range(3)]
    mnts = [5, 1, 3]
    outs = {}
    for pkg, PE, fi in (("jax", JProgressEngine, j_fi), ("torch", TProgressEngine, t_fi)):
        pe = PE()
        eng = side[pkg](JPagedServeEngine if pkg == "jax" else TPagedServeEngine, max_batch=3, max_len=48,
                        page_size=8, progress_engine=pe)
        reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, mnts)]
        plan = fi.FaultPlan([fi.FaultEvent(0.0, "kill_rank", 1)])
        with fi.FaultInjector(plan, clock=fi.VirtualClock()) as inject:
            summary = eng.run_until_done_elastic(n_threads=3, fault_injector=inject, max_steps=200, sync_timeout=2.0)
        outs[pkg] = ([r.out_tokens for r in reqs], summary["dead_ranks"], eng.stats()["kv"]["pages_in_use"])
        pe.stop_all()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] == [1] and outs["torch"][2] == 0
    assert [len(t) for t in outs["torch"][0]] == mnts


def test_paged_admits_deeper_than_contiguous_at_equal_memory(side):
    outs = {}
    for pkg in ("jax", "torch"):
        eng = side[pkg](JPagedServeEngine if pkg == "jax" else TPagedServeEngine, max_batch=2, max_len=32,
                        page_size=4, pool_pages=2 * (32 // 4))
        rng = np.random.default_rng(5)
        reqs = [eng.submit(rng.integers(1, side["vocab"], size=int(rng.integers(4, 8))).astype(np.int32),
                           max_new_tokens=3 + i % 3) for i in range(10)]
        eng.run_until_done(max_steps=400)
        outs[pkg] = ([r.out_tokens for r in reqs], eng.max_concurrent, _kv_stats(eng))
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1] > 4  # more in flight than the 4 contiguous slots of the same bytes


def test_paged_submit_validates_like_reference(side):
    errs = []
    for pkg in ("jax", "torch"):
        eng = side[pkg](JPagedServeEngine if pkg == "jax" else TPagedServeEngine, max_batch=1, max_len=16,
                        page_size=4)
        with pytest.raises(ValueError, match="does not fit max_len") as err:
            eng.submit(np.arange(16, dtype=np.int32))
        errs.append(str(err.value))
    assert errs[0] == errs[1]


# ------------------------------------------------ admission front end


def _offers(vocab, seed, n, hi, mnt_hi, extra=()):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield make_offer(rng.integers(1, vocab, size=int(rng.integers(2, hi))).astype(np.int32),
                         max_new_tokens=int(rng.integers(1, mnt_hi)))
    yield from extra


def test_admission_front_end_streams_and_rejects_like_reference(side):
    outs = {}
    for pkg, PE, FE in (("jax", JProgressEngine, JAdmissionFrontEnd), ("torch", TProgressEngine, TAdmissionFrontEnd)):
        pe = PE()
        eng = side[pkg](JServeEngine if pkg == "jax" else TServeEngine, max_batch=2, max_len=32,
                        progress_engine=pe)
        fe = FE(eng)
        done = []
        out = fe.serve(_offers(side["vocab"], 7, 6, 12, 6, [make_offer(np.arange(40, dtype=np.int32))]),
                       on_complete=done.append, sync_timeout=10.0)
        assert out == done and len(out) == 6
        assert all(c.t_arrival <= c.t_submit <= c.t_done for c in out)
        outs[pkg] = ([c.req.out_tokens for c in sorted(out, key=lambda c: c.rid)], [r["error"] for r in fe.rejected])
        pe.stop_all()
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"][1]) == 1 and "does not fit max_len" in outs["torch"][1][0]


def test_admission_front_end_paged_matches_reference(side):
    outs = {}
    for pkg, PE, FE in (("jax", JProgressEngine, JAdmissionFrontEnd), ("torch", TProgressEngine, TAdmissionFrontEnd)):
        pe = PE()
        eng = side[pkg](JPagedServeEngine if pkg == "jax" else TPagedServeEngine, max_batch=2, max_len=32,
                        progress_engine=pe, page_size=4, pool_pages=24)
        cs = FE(eng).serve(_offers(side["vocab"], 13, 7, 10, 5), sync_timeout=10.0)
        outs[pkg] = [c.req.out_tokens for c in sorted(cs, key=lambda c: c.rid)]
        pe.stop_all()
    assert outs["torch"] == outs["jax"] and len(outs["torch"]) == 7


def test_admission_front_end_needs_a_progress_engine(side):
    eng = side["torch"](TServeEngine, max_batch=2, max_len=32)
    with pytest.raises(ValueError, match="progress_engine"):
        TAdmissionFrontEnd(eng)


# ------------------------------------------------ threaded generation loop


@pytest.fixture(scope="module")
def threaded_prompts(side):
    return [np.random.default_rng(i).integers(0, side["vocab"], (4 + i,)) for i in range(5)]


@pytest.fixture(scope="module")
def serial_tokens(side, threaded_prompts):
    eng = side["jax"](JServeEngine, max_batch=3, max_len=48, progress_engine=JProgressEngine())
    reqs = [eng.submit(p, max_new_tokens=5) for p in threaded_prompts]
    eng.run_until_done(max_steps=200)
    eng.progress_engine.stop_all()
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("n_threads", [1, 3])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_threaded_loop_matches_reference_serial(side, threaded_prompts, serial_tokens, n_threads, paged):
    pe = TProgressEngine()
    kw = dict(page_size=8) if paged else {}
    eng = side["torch"](TPagedServeEngine if paged else TServeEngine, max_batch=3, max_len=48,
                        progress_engine=pe, **kw)
    reqs = [eng.submit(p, max_new_tokens=5) for p in threaded_prompts]
    eng.run_until_done_threaded(n_threads=n_threads, max_steps=200, sync_timeout=10.0)
    assert all(r.done for r in reqs)
    assert [r.out_tokens for r in reqs] == serial_tokens
    if paged:
        assert eng.stats()["kv"]["pages_in_use"] == 0
    pe.stop_all()


def test_threaded_completion_wakes_parked_waiter(side):
    pe = TProgressEngine()
    eng = side["torch"](TServeEngine, max_batch=2, max_len=32, progress_engine=pe)
    r = eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=3)
    t = threading.Thread(target=lambda: eng.run_until_done_threaded(n_threads=2, sync_timeout=10.0), daemon=True)
    t.start()
    assert eng.wait(r, timeout=10)  # parks on the grequest; woken at EOS
    t.join(timeout=10)
    assert not t.is_alive() and r.done and len(r.out_tokens) == 3
    pe.stop_all()


def test_threaded_decode_error_aborts_cleanly(side):
    eng = side["torch"](TServeEngine, max_batch=2, max_len=32, progress_engine=TProgressEngine())
    eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=4)
    calls = {"n": 0}
    real_decode = eng._decode

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("simulated decode failure")
        return real_decode(*a, **kw)

    eng._decode = flaky
    live_before = t_default_pool().n_live
    with pytest.raises(RuntimeError, match="simulated decode failure"):
        eng.run_until_done_threaded(n_threads=3, sync_timeout=10.0)
    assert t_default_pool().n_live == live_before  # channels not leaked
    eng.progress_engine.stop_all()


def test_threaded_worker_error_aborts_all_ranks(side):
    eng = side["torch"](TServeEngine, max_batch=2, max_len=32, progress_engine=TProgressEngine())
    eng.submit(np.asarray([1, 2, 3], np.int32), max_new_tokens=4)
    eng.submit(np.asarray([4, 5, 6], np.int32), max_new_tokens=4)
    real_advance = eng._advance_slot

    def flaky(i, tok):
        if i % 2 == 1:  # the shard the background worker owns
            raise RuntimeError("simulated shard failure")
        return real_advance(i, tok)

    eng._advance_slot = flaky
    live_before = t_default_pool().n_live
    with pytest.raises(RuntimeError, match="simulated shard failure"):
        eng.run_until_done_threaded(n_threads=2, sync_timeout=10.0)
    assert t_default_pool().n_live == live_before
    eng.progress_engine.stop_all()


def test_threaded_loop_rejects_zero_threads(side):
    eng = side["torch"](TServeEngine, max_batch=2, max_len=32, progress_engine=TProgressEngine())
    for run in (eng.run_until_done_threaded, eng.run_until_done_elastic):
        with pytest.raises(ValueError, match="n_threads >= 1"):
            run(n_threads=0)
    eng.progress_engine.stop_all()


# ------------------------------------------------ elastic serving


def test_elastic_serving_with_kill_matches_reference(side, threaded_prompts):
    """Kill a serving worker mid-decode on the contiguous engine: the epoch
    closes, the survivors inherit the dead shard's slots, and the output is
    the JAX package's, token for token."""
    prompts = threaded_prompts[:3]
    outs = {}
    for pkg, PE, fi in (("jax", JProgressEngine, j_fi), ("torch", TProgressEngine, t_fi)):
        pe = PE()
        eng = side[pkg](JServeEngine if pkg == "jax" else TServeEngine, max_batch=3, max_len=48,
                        progress_engine=pe)
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        plan = fi.FaultPlan([fi.FaultEvent(0.0, "kill_rank", 1)])
        with fi.FaultInjector(plan, clock=fi.VirtualClock()) as inject:
            summary = eng.run_until_done_elastic(n_threads=3, fault_injector=inject, max_steps=200, sync_timeout=2.0)
        assert all(r.done for r in reqs)
        outs[pkg] = ([r.out_tokens for r in reqs], summary)
        pe.stop_all()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][1]["dead_ranks"] == [1] and outs["torch"][1]["epochs"] >= 2
