"""The port's RWKV-6 against the JAX package's, on the smoke ``rwkv6-7b``
(2 layers, d_model 128, 2 heads of 64): the same numpy inputs go through
both packages, and JAX weights go across with ``params_from_numpy``.

Tolerances, with their reasons:

* ``wkv6`` (the kernel's plain version) against the JAX Pallas kernel in
  interpret mode and against the per-token oracle: 5e-4 absolute and
  relative, the reference's own sweep bound (``test_kernels.py:84``). The
  chunked form sums in another order than the recurrence, and the port
  starts each block from ``state0`` where the reference folds it in by
  linearity afterwards.
* Strong decay (``w = 1e-6``): finite, and 1e-3 / 1e-2 against the oracle
  (``test_kernels.py:100``).
* ``rwkv_forward`` in fp32: 1e-4. Only the summation order of the matmuls,
  the scan and the groupnorm differ.
* bf16 (the config as published), one block at a time on the same input
  (time-mix and channel-mix of every layer): 2e-2 of the output's largest
  magnitude. Every matmul output is rounded to bf16 in both packages, but
  the products are accumulated in other orders, so operands may land one
  bf16 step apart; a value made by cancellation (the token shift
  ``x_prev - x``, a residual sum) then differs at its operands' magnitude.
* ``rwkv_forward`` in bf16, the whole model: 5e-2 of the tensor's largest
  magnitude, the reference's bf16 bound for a whole-model comparison (its
  decode check, ``test_models_smoke.py:107``). One-step differences in a
  block are carried and grown by every later block, so the whole model
  cannot be held to the per-block 2e-2; the per-block test holds that.
* Decode after prefill against the full forward: 5e-2 of the logits'
  scale, the reference's check (``test_models_smoke.py:104-107``); the
  port's decode against the JAX decode in fp32: 1e-4.
* Served tokens: equal, token for token, in fp32.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import rwkv6_scan as jwkv  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import rwkv6 as jR  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import rwkv6_7b as t_rwkv_cfg  # noqa: E402
from repro_torch.core.progress import ProgressEngine as TProgressEngine  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as twkv  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import rwkv6 as tR  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TServeEngine  # noqa: E402

ARCH = "rwkv6-7b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
BLOCK_TOL_BF16 = 2e-2
SERVE_LENS = (64, 100, 128)
MAX_NEW = 5


def _configs(dtype: str, **kw):
    over = dict(FP32 if dtype == "float32" else {}, **kw)
    return j_get_config(ARCH, smoke=True).replace(**over), t_get_config(ARCH, smoke=True).replace(**over)


_WEIGHTS = {}


def _weights(dtype: str):
    """JAX params and the port's model holding them, one pair per dtype
    for the whole module."""
    if dtype not in _WEIGHTS:
        jcfg, tcfg = _configs(dtype)
        jp = japi.init_params(jcfg, jax.random.key(0))
        _WEIGHTS[dtype] = (jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu"))
    return _WEIGHTS[dtype]


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _close(a, b, tol, scaled=False):
    a, b = _f32(a), _f32(b)
    scale = float(np.abs(b).max()) if scaled else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


def _wkv_inputs(seed, B, S, H, hs=64):
    """The reference sweep's distributions (``test_kernels.py:74-80``)."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    w = (1 / (1 + np.exp(-n(B, S, H, hs))) * 0.5 + 0.45).astype(np.float32)
    return w, n(B, S, H, hs), n(B, S, H, hs), n(B, S, H, hs), n(H, hs) * 0.1, n(B, H, hs, hs) * 0.1


# ------------------------------------------------------------ wkv6


@pytest.mark.parametrize("S,chunk", [(64, 32), (128, 64), (256, 64), (96, 32)])
def test_wkv6_plain_matches_pallas_and_oracle(S, chunk):
    args = _wkv_inputs(S + chunk, 2, S, 2)
    y, s = tops.wkv6(*map(torch.from_numpy, args), chunk=chunk)
    y_pl, s_pl = jwkv.wkv6_chunked(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    y_ref, s_ref = jref.wkv6_ref(*map(jnp.asarray, args))
    for a, b in ((y, y_pl), (s, s_pl), (y, y_ref), (s, s_ref)):
        _close(a, b, 5e-4)
    assert twkv.wkv6.launches == 0  # CPU tensors never reach the kernel


def test_wkv6_strong_decay_stays_finite():
    w, r, k, v, _, _ = _wkv_inputs(7, 1, 64, 1)
    w = np.full_like(w, 1e-6)
    u, s0 = np.zeros((1, 64), np.float32), np.zeros((1, 1, 64, 64), np.float32)
    args = (w, r, k, v, u, s0)
    y, _ = tops.wkv6(*map(torch.from_numpy, args), chunk=32)
    assert bool(torch.isfinite(y).all())
    y_ref, _ = jref.wkv6_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(_f32(y), _f32(y_ref), atol=1e-3, rtol=1e-2)


def test_wkv6_ref_matches_reference_oracle():
    args = _wkv_inputs(5, 2, 40, 2)
    y, s = tref.wkv6_ref(*map(torch.from_numpy, args))
    y_j, s_j = jref.wkv6_ref(*map(jnp.asarray, args))
    _close(y, y_j, 5e-4)
    _close(s, s_j, 5e-4)


@pytest.mark.parametrize("S,chunk", [(96, 64), (100, 32)])
def test_wkv6_rejects_ragged_length(S, chunk):
    args = map(torch.from_numpy, _wkv_inputs(1, 1, S, 1))
    with pytest.raises(ValueError, match="S % chunk"):
        tops.wkv6(*args, chunk=chunk)


def test_wkv6_refuses_autograd():
    w, r, k, v, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(2, 1, 64, 1))
    r.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        tops.wkv6(w, r, k, v, u, s0)
    with torch.no_grad():
        assert tops.wkv6(w, r, k, v, u, s0)[0].shape == (1, 64, 1, 64)


# ------------------------------------------------------------ model


def _count_wkv6(monkeypatch):
    calls = []
    real = tops.wkv6

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tops, "wkv6", counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl,S", [("flash", 128), ("flash", 100), ("einsum", 128), ("einsum", 100)])
def test_forward_matches_reference(dtype, attn_impl, S, monkeypatch):
    """``flash`` at S = 128 takes the kernel route and is held against the
    reference's ``use_kernel=True``; every other case takes the default
    route and is held against the reference's default path."""
    jcfg, tcfg = _configs(dtype, attn_impl=attn_impl)
    jp, model = _weights(dtype)
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S)).astype(np.int32)
    kernel_route = attn_impl == "flash" and S % 64 == 0
    j_logits, j_state = jR.rwkv_forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, use_kernel=kernel_route)
    calls = _count_wkv6(monkeypatch)
    t_logits, t_state = tR.rwkv_forward(tcfg, model, {"tokens": toks})
    assert len(calls) == (tcfg.n_layers if kernel_route else 0)
    tol = TOL[dtype]
    _close(t_logits, j_logits, tol, scaled=dtype == "bfloat16")
    for key in ("x_tm", "x_cm", "wkv"):
        _close(t_state[key], j_state[key], tol, scaled=dtype == "bfloat16")


@pytest.mark.parametrize("layer", [0, 1])
def test_bf16_blocks_match_reference(layer):
    """Each block of each layer on one shared bf16 input: the time-mix on
    both WKV routes and the channel-mix."""
    jcfg, tcfg = _configs("bfloat16")
    jp, model = _weights("bfloat16")
    lp = jax.tree.map(lambda a: a[layer], jp["layers"])
    tl = model.layers[layer]
    rng = np.random.default_rng(10 + layer)
    x = rng.standard_normal((2, 128, tcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    assert np.array_equal(_f32(tx), _f32(jx))
    j_state, t_state = jR.init_state(jcfg, 2), tR.init_state(tcfg, 2, device="cpu")
    for use_kernel in (False, True):
        ja, (j_last, j_wkv) = jR._time_mix(jcfg, lp, jx, (j_state["x_tm"][layer], j_state["wkv"][layer]), use_kernel)
        ta, t_last, t_wkv = tR._time_mix(tcfg, tl, tx, t_state["x_tm"][layer], t_state["wkv"][layer], use_kernel)
        _close(ta, ja, BLOCK_TOL_BF16, scaled=True)
        _close(t_wkv, j_wkv, BLOCK_TOL_BF16, scaled=True)
        _close(t_last, j_last, 0.0)
    jc, _ = jR._channel_mix(jcfg, lp, jx, j_state["x_cm"][layer])
    tc, _ = tR._channel_mix(tl.p, tx, t_state["x_cm"][layer])
    _close(tc, jc, BLOCK_TOL_BF16, scaled=True)


def test_kernel_route_rejects_ragged_prompt():
    _, tcfg = _configs("float32")
    _, model = _weights("float32")
    with pytest.raises(ValueError, match="S % 64"):
        tR.rwkv_forward(tcfg, model, {"tokens": np.zeros((1, 100), np.int32)}, use_kernel=True)


def test_kernel_route_under_autograd_raises():
    _, tcfg = _configs("float32")
    model = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    model.layers[0].p["wr"].requires_grad_(True)
    toks = np.zeros((1, 64), np.int32)
    with pytest.raises(NotImplementedError, match="backward"):
        tR.rwkv_forward(tcfg, model, {"tokens": toks}, use_kernel=True)
    loss, _ = tR.rwkv_loss(tcfg, model, {"tokens": toks})  # the default route differentiates
    loss.backward()
    assert model.layers[0].p["wr"].grad is not None


def test_prefill_then_decode_matches_full_forward():
    jcfg, tcfg = _configs("float32")
    jp, model = _weights("float32")
    B, S = 2, 16
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    last, state = tapi.prefill(tcfg, model, {"tokens": toks[:, : S - 1]}, max_len=S)
    wkv_before = state["wkv"]
    dec, state2 = tapi.decode_step(tcfg, model, state, toks[:, S - 1], np.full((B,), S - 1, np.int32))
    assert state2 is state and state2["wkv"] is wkv_before  # updated in place
    full, _ = tR.rwkv_forward(tcfg, model, {"tokens": toks})
    a, b = _f32(dec), _f32(full[:, -1])
    assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 0.05
    j_last, j_state = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, : S - 1])}, max_len=S)
    j_dec, _ = japi.decode_step(jcfg, jp, j_state, jnp.asarray(toks[:, S - 1]), jnp.full((B,), S - 1, jnp.int32))
    _close(last, j_last, TOL["float32"])
    _close(dec, j_dec, TOL["float32"])


# ------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def served():
    """The prompts and the JAX engine's output tokens for them."""
    jcfg, _ = _configs("float32")
    jp, _ = _weights("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, (n,)).astype(np.int32) for n in SERVE_LENS]
    eng = JServeEngine(jcfg, jp, max_batch=2, max_len=160)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    eng.run_until_done(max_steps=200)
    assert all(r.done and len(r.out_tokens) == MAX_NEW for r in reqs)
    return dict(prompts=prompts, tokens=[list(r.out_tokens) for r in reqs])


@pytest.mark.parametrize("step_schedule", [False, True])
@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_served_tokens_match_reference(served, attn_impl, step_schedule):
    _, tcfg = _configs("float32", attn_impl=attn_impl)
    _, model = _weights("float32")
    pe = TProgressEngine()
    eng = TServeEngine(tcfg, model, max_batch=2, max_len=160, progress_engine=pe, step_schedule=step_schedule)
    records = []
    if step_schedule:  # the state's signature must hold across steps: one recording
        record = eng.step_schedule.record
        eng.step_schedule.record = lambda *a, **kw: records.append(1) or record(*a, **kw)
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW) for p in served["prompts"]]
    eng.run_until_done(max_steps=200)
    assert [r.out_tokens for r in reqs] == served["tokens"]
    if step_schedule:
        assert eng.step_schedule.stats()["replays"] > 1 and len(records) == 1
    assert pe.wait_all([r.grequest for r in reqs], timeout=10)
    pe.stop_all()


# ------------------------------------------------------------ weights and configs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_carries_every_leaf_bit_for_bit(dtype):
    jp, model = _weights(dtype)
    src = jax.tree.map(np.asarray, jp)
    pairs = [(model.embed[k], src["embed"][k]) for k in src["embed"]]
    pairs += [(model.final_norm[k], src["final_norm"][k]) for k in src["final_norm"]]
    for key, leaf in src["layers"].items():
        for l, layer in enumerate(model.layers):
            if isinstance(leaf, dict):
                pairs += [(getattr(layer, key)[k], leaf[k][l]) for k in leaf]
            else:
                pairs.append((layer.p[key], leaf[l]))
    n_port = sum(1 for _ in model.parameters())
    assert len(pairs) == n_port == 2 + 1 + 22 * len(model.layers)
    for t, a in pairs:
        assert tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy(),
                              a.view(np.int16) if a.dtype.name == "bfloat16" else a)


def test_convert_rejects_a_key_mismatch():
    _, tcfg = _configs("float32")
    jp, _ = _weights("float32")
    src = jax.tree.map(np.asarray, jp)
    src["layers"] = {k: v for k, v in src["layers"].items() if k != "bonus"}
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tcfg, src, device="cpu")


def test_init_params_uses_reference_scales():
    _, tcfg = _configs("float32")
    model = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(model, tR.RWKVLM) and len(model.layers) == tcfg.n_layers
    p = model.layers[0].p
    assert float(model.final_norm["w"].abs().max()) == 0.0
    assert float(p["w0"].min()) == float(p["w0"].max()) == -6.0
    assert float(p["mu_wkvrg"].min()) == 0.5 and float(model.layers[1].ln_x["w"].min()) == 1.0
    assert abs(float(model.embed["tok"].std()) - 0.02) < 0.004
    for name, scale in (("wr", tcfg.d_model ** -0.5), ("wv_c", tcfg.d_ff ** -0.5), ("maa_w1", 0.01), ("bonus", 0.1)):
        assert abs(float(p[name].std()) - scale) < 0.15 * scale, name
    state = tapi.init_cache(tcfg, 3, 64, device="cpu")
    H = tcfg.d_model // 64
    assert state["wkv"].shape == (tcfg.n_layers, 3, H, 64, 64) and state["wkv"].dtype == torch.float32
    assert state["x_tm"].shape == state["x_cm"].shape == (tcfg.n_layers, 3, tcfg.d_model)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(smoke):
    j = j_get_config(ARCH, smoke=smoke)
    t = (t_rwkv_cfg.smoke if smoke else t_rwkv_cfg.full)()
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
              "norm", "tie_embeddings", "param_dtype", "compute_dtype", "attn_impl"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.param_counts() == j.param_counts()
    if not smoke:
        assert t.param_counts()["total"] == 7_574_913_024
