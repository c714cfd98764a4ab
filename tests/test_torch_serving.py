"""The port's ``ServeEngine`` against the JAX package's on the smoke
``qwen1.5-0.5b`` in fp32: the JAX weights go across with
``params_from_numpy`` and the same seeded prompts are served by both. fp32
keeps the two greedy decodes token for token identical (their logits agree
within a few 1e-6, far from any argmax tie on these seeds)."""

import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.progress import ProgressEngine as JProgressEngine  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.progress import ProgressEngine as TProgressEngine  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TServeEngine  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
LENS = (5, 7, 5, 9, 7)
MAX_NEW = 5


@pytest.fixture(scope="module")
def served():
    """Both packages' config and weights, the prompts, and the JAX
    engine's output tokens for them."""
    jcfg = j_get_config("qwen1.5-0.5b", smoke=True).replace(**FP32)
    tcfg = t_get_config("qwen1.5-0.5b", smoke=True).replace(**FP32)
    jp = japi.init_params(jcfg, jax.random.key(0))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, (n,)).astype(np.int32) for n in LENS]
    eng = JServeEngine(jcfg, jp, max_batch=2, max_len=32)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_until_done(max_steps=200)
    assert all(r.done for r in reqs)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, model=model, prompts=prompts,
                tokens=[list(r.out_tokens) for r in reqs])


@pytest.mark.parametrize("step_schedule", [False, True])
@pytest.mark.parametrize("with_engine", [False, True])
def test_tokens_match_reference(served, step_schedule, with_engine):
    pe = TProgressEngine() if with_engine else None
    eng = TServeEngine(served["tcfg"], served["model"], max_batch=2, max_len=32,
                       progress_engine=pe, step_schedule=step_schedule)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in served["prompts"]]
    eng.run_until_done(max_steps=200)
    assert [r.out_tokens for r in reqs] == served["tokens"]
    assert all(len(t) == MAX_NEW for t in served["tokens"])
    if step_schedule:
        assert eng.step_schedule.stats()["replays"] > 0
    if pe is not None:
        assert pe.wait_all([r.grequest for r in reqs], timeout=10)
        pe.stop_all()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_wait_any_completes_in_order(served, pkg):
    """One slot: requests finish one after another, and ``wait_any``
    hands each back as it finishes, while another thread drives decode."""
    if pkg == "jax":
        pe = JProgressEngine()
        eng = JServeEngine(served["jcfg"], served["jp"], max_batch=1, max_len=32, progress_engine=pe)
    else:
        pe = TProgressEngine()
        eng = TServeEngine(served["tcfg"], served["model"], max_batch=1, max_len=32, progress_engine=pe)
    reqs = [eng.submit(p, max_new_tokens=3) for p in served["prompts"][:3]]
    driver = threading.Thread(target=eng.run_until_done, daemon=True)
    driver.start()
    order, pending = [], list(reqs)
    while pending:
        r = eng.wait_any(pending, timeout=60)
        assert r is not None and r.done
        order.append(r.rid)
        pending.remove(r)
    driver.join(timeout=60)
    assert not driver.is_alive()
    assert order == [r.rid for r in reqs]
    pe.stop_all()


_BAD = {
    "two_dim": dict(prompt=np.zeros((2, 3), np.int32)),
    "empty": dict(prompt=np.zeros((0,), np.int32)),
    "too_long": dict(prompt=np.zeros((32,), np.int32)),
    "no_tokens": dict(prompt=np.zeros((4,), np.int32), max_new_tokens=0),
}


@pytest.mark.parametrize("case", sorted(_BAD))
def test_admission_errors_match_reference(served, case):
    j_eng = JServeEngine(served["jcfg"], served["jp"], max_batch=2, max_len=32)
    t_eng = TServeEngine(served["tcfg"], served["model"], max_batch=2, max_len=32)
    with pytest.raises(ValueError) as j_err:
        j_eng.submit(**_BAD[case])
    with pytest.raises(ValueError) as t_err:
        t_eng.submit(**_BAD[case])
    assert str(t_err.value) == str(j_err.value)
    assert not t_eng.queue


def test_wait_without_progress_engine_raises_like_reference(served):
    j_eng = JServeEngine(served["jcfg"], served["jp"], max_batch=2, max_len=32)
    t_eng = TServeEngine(served["tcfg"], served["model"], max_batch=2, max_len=32)
    j_req, t_req = j_eng.submit(served["prompts"][0]), t_eng.submit(served["prompts"][0])
    for eng, req in ((j_eng, j_req), (t_eng, t_req)):
        with pytest.raises(ValueError, match="no progress_engine"):
            eng.wait(req)
        with pytest.raises(ValueError, match="no progress_engine"):
            eng.wait_any([req])


def test_max_new_tokens_one_finishes_at_admission(served):
    """The prefill token is the first output token: a one-token request
    never takes a slot."""
    t_eng = TServeEngine(served["tcfg"], served["model"], max_batch=2, max_len=32)
    r = t_eng.submit(served["prompts"][0], max_new_tokens=1)
    assert t_eng.step() == 0
    assert r.done and r.out_tokens == served["tokens"][0][:1]
    assert all(s is None for s in t_eng.slot_req)


def test_batch_cache_keeps_reference_layout(served):
    eng = TServeEngine(served["tcfg"], served["model"], max_batch=3, max_len=32)
    (K, V), = eng.cache[0]
    assert tuple(K.shape) == (2, 3, 32, 4, 16) and K.dtype == torch.float32
    eng.submit(served["prompts"][0], max_new_tokens=2)
    eng.step()
    n = len(served["prompts"][0])
    assert float(K[:, 0, : n + 1].abs().sum()) > 0  # prompt + the decoded token
    assert float(K[:, 0, n + 1 :].abs().sum()) == 0
    # idle slots decode too (full-batch step, as in the reference) at position 0
    assert float(K[:, 1:, 1:].abs().sum()) == 0
