"""The port's dense transformer against the JAX package's, on the smoke
``qwen1.5-0.5b``: the JAX weights go across with ``params_from_numpy`` and
the same numpy tokens go through prefill, four decode steps and the loss.

Tolerances, with their reasons:

* fp32 (``param_dtype = compute_dtype = "float32"``): 1e-4. Only the
  summation order of the matmuls and the softmax differs between XLA's CPU
  kernels and PyTorch's; over two layers that stays within a few 1e-6.
* bf16 (the config as published): 2e-2 of the tensor's largest magnitude.
  Every matmul output is rounded to bf16 in both packages, but the products
  are accumulated in other orders, so operands may land one bf16 step
  (2^-8 relative) apart. A value made by cancellation (a RoPE rotation, a
  residual sum) then differs by a step at its operands' magnitude, not at
  its own, so the bound is set by the tensor's scale.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _configs(dtype: str, **kw):
    over = dict(FP32 if dtype == "float32" else {}, **kw)
    return j_get_config("qwen1.5-0.5b", smoke=True).replace(**over), t_get_config("qwen1.5-0.5b", smoke=True).replace(**over)


def _weights(jcfg, tcfg, seed=0):
    jp = japi.init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def _f32(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.float32)


def _close(a, b, tol):
    a, b = _f32(a), _f32(b)
    scale = float(np.abs(b).max()) if tol == TOL["bfloat16"] else 1.0
    np.testing.assert_allclose(a, b, atol=tol * scale, rtol=tol)


def _leaves(cache):
    return [t for group in cache for entry in group for t in entry]


def test_convert_carries_every_weight_bit_for_bit():
    jcfg, tcfg = _configs("bfloat16")
    jp, model = _weights(jcfg, tcfg)
    assert model.embed["tok"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        model.embed["tok"].view(torch.int16).numpy(), np.asarray(jp["embed"]["tok"]).view(np.int16)
    )
    layer1 = model.groups[0][1].attn["wq"]
    np.testing.assert_array_equal(
        layer1.view(torch.int16).numpy(), np.asarray(jp["groups"][0][0]["attn"]["wq"])[1].view(np.int16)
    )
    n_jax = sum(np.asarray(a).size for a in jax.tree.leaves(jp))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_four_decode_steps_match_reference(dtype):
    jcfg, tcfg = _configs(dtype)
    jp, model = _weights(jcfg, tcfg)
    tol = TOL[dtype]
    rng = np.random.default_rng(1)
    B, S, max_len = 2, 12, 24
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)

    j_logits, j_cache = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)}, max_len=max_len)
    t_logits, t_cache = tapi.prefill(tcfg, model, {"tokens": tokens}, max_len=max_len)
    assert t_logits.shape == (B, jcfg.vocab) and t_logits.dtype == torch.float32
    _close(t_logits, j_logits, tol)
    for t, j in zip(_leaves(t_cache), jax.tree.leaves(j_cache)):
        assert tuple(t.shape) == j.shape == (2, B, max_len, 4, 16)  # (reps, B, T, nkv, hd)
        _close(t, j, tol)

    pos = np.full((B,), S, np.int32)
    for step in range(4):
        nxt = rng.integers(0, jcfg.vocab, (B,)).astype(np.int32)
        j_logits, j_cache = japi.decode_step(jcfg, jp, j_cache, jnp.asarray(nxt), jnp.asarray(pos))
        t_logits, t_cache = tapi.decode_step(tcfg, model, t_cache, nxt, pos)
        _close(t_logits, j_logits, tol)
        pos = pos + 1
    for t, j in zip(_leaves(t_cache), jax.tree.leaves(j_cache)):
        _close(t, j, tol)


def test_flash_prefill_matches_reference_pallas(monkeypatch):
    """S = 128 takes the flash gate in both packages: the reference runs
    its Pallas kernel in interpret mode, the port the kernel's plain
    version (the gate itself is checked through a counting wrapper)."""
    jcfg, tcfg = _configs("float32", attn_impl="flash")
    jp, model = _weights(jcfg, tcfg, seed=2)
    calls = []
    real = tops.gqa_flash_attention
    monkeypatch.setattr(tops, "gqa_flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab, (1, 128)).astype(np.int32)
    j_logits, j_cache = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(tokens)}, max_len=160)
    t_logits, t_cache = tapi.prefill(tcfg, model, {"tokens": tokens}, max_len=160)
    assert len(calls) == jcfg.n_layers
    _close(t_logits, j_logits, TOL["float32"])
    for t, j in zip(_leaves(t_cache), jax.tree.leaves(j_cache)):
        _close(t, j, TOL["float32"])
    # the same weights through the einsum path: the gate only changes the algorithm
    e_logits, _ = tapi.prefill(tcfg.replace(attn_impl="einsum"), model, {"tokens": tokens}, max_len=160)
    _close(e_logits, t_logits, TOL["float32"])
    assert len(calls) == jcfg.n_layers


@pytest.mark.parametrize("S", [100, 128])
def test_flash_gate_is_the_reference_gate(monkeypatch, S):
    """Only causal full attention over S % 128 == 0 reaches the kernel."""
    _, tcfg = _configs("float32", attn_impl="flash")
    model = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = tops.gqa_flash_attention
    monkeypatch.setattr(tops, "gqa_flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    tapi.prefill(tcfg, model, {"tokens": np.zeros((1, S), np.int32)})
    assert len(calls) == (tcfg.n_layers if S % 128 == 0 else 0)


def test_loss_matches_reference():
    jcfg, tcfg = _configs("float32")
    jp, model = _weights(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 16)).astype(np.int32),
             "loss_mask": (rng.random((2, 16)) > 0.3).astype(np.int32)}
    j_loss, _ = japi.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, metrics = tapi.loss_fn(tcfg, model, batch)
    _close(t_loss, j_loss, TOL["float32"])
    assert set(metrics) >= {"xent", "loss"}


def test_init_params_uses_reference_scales():
    _, tcfg = _configs("float32")
    model = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert float(model.final_norm["w"].abs().max()) == 0.0
    assert float(model.groups[0][0].attn["bq"].abs().max()) == 0.0
    assert abs(float(model.embed["tok"].std()) - 0.02) < 0.004
    wq = model.groups[0][0].attn["wq"]
    assert abs(float(wq.std()) - tcfg.d_model ** -0.5) < 0.1 * tcfg.d_model ** -0.5


@pytest.mark.parametrize("arch_kw,match", [
    (dict(norm="layernorm"), "layernorm"),
    (dict(family="hybrid"), "jamba"),
    (dict(encdec=True), "encdec"),
])
def test_unported_model_parts_raise(arch_kw, match):
    """A layernorm transformer, the hybrid (Jamba) and the encoder-decoder
    (Whisper) initialise in the port with the reference's tree: every
    leaf's shape and dtype, layernorm weights one and biases zero."""
    from repro_torch.models.convert import leaf_map

    arch = {"layernorm": "qwen1.5-0.5b", "jamba": "jamba-v0.1-52b", "encdec": "whisper-tiny"}[match]
    over = dict(FP32, **arch_kw)
    jcfg, tcfg = j_get_config(arch, smoke=True).replace(**over), t_get_config(arch, smoke=True).replace(**over)
    model = tapi.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert tapi.family(tcfg) == {"layernorm": "transformer"}.get(match, match)
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): (tuple(a.shape), str(a.dtype)) for p, a in
            jax.tree_util.tree_flatten_with_path(jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0))))[0]}
    params = dict(model.named_parameters())
    got = {}
    for name, (stacked, names) in leaf_map(tcfg, model).items():
        t = params[names[0]]
        got[name] = (((len(names),) if stacked else ()) + tuple(t.shape), str(t.dtype).split(".")[-1])
    assert got == want
    if tcfg.norm == "layernorm":
        assert all(bool((p == 1).all()) for n, p in params.items() if n.endswith("final_norm.w"))
        assert all(float(p.abs().max()) == 0 for n, p in params.items() if n.endswith((".b", ".bq", ".b_in")))
