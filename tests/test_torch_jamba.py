"""The port's Jamba (``repro_torch.models.jamba``) against the JAX
package's, at the smoke config (one period of 8 layers: 7 Mamba + 1
attention at position 4, MoE of 4 experts top-2 at the odd positions,
d 64).

The weights are numpy draws in the shapes of the reference's tree (every
period position's leaves stacked over the blocks), carried to the port
with ``params_from_numpy``; the same numpy tokens go through the
reference's jitted functions and the port's. Tolerances, as
``tests/test_torch_models.py`` states them: fp32 logits rel. 1e-4, losses
and metrics rel. 1e-5, greedy tokens equal, gradients 1e-4 of each leaf's
largest magnitude; the port's bf16 decode against its own full forward
within 5e-2 of the logits' scale (``tests/test_models_smoke.py``).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import jamba as jJ  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import jamba as tJ  # noqa: E402
from repro_torch.models.convert import leaf_map, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TServeEngine  # noqa: E402

ARCH = "jamba-v0.1-52b"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, MAX_LEN, STEPS = 2, 15, 24, 4


def _cfgs(dtype="float32", **over):
    over = {**(FP32 if dtype == "float32" else {}), **over}
    return jget(ARCH, smoke=True).replace(**over), tget(ARCH, smoke=True).replace(**over)


def _numpy_params(jcfg, seed):
    """The reference's tree filled with numpy draws: normal · 1/sqrt(fan-in)
    (the stacking axis aside), token embedding and router 0.02, norms 0.1 ·
    normal; Mamba's ``A_log`` log(1..d_state), ``D`` ones, ``dt_bias`` -4.6,
    each plus 0.1 · normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    ds = jcfg.ssm.d_state

    def one(path, a):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(a.shape)
        if name in ("tok", "router"):
            v = 0.02 * n
        elif name in ("w", "dt_norm", "b_norm", "c_norm", "conv_b"):
            v = 0.1 * n
        elif name == "A_log":
            v = np.log(np.arange(1, ds + 1)) + 0.1 * n
        elif name == "D":
            v = 1.0 + 0.1 * n
        elif name == "dt_bias":
            v = -4.6 + 0.1 * n
        else:
            v = n * a.shape[-2] ** -0.5
        return v.astype(np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


@functools.lru_cache(maxsize=None)
def _weights(dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    tree = _numpy_params(jcfg, seed=0)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, device="cpu"), tree


def _tokens(jcfg, seed, s=S):
    return np.random.default_rng(seed).integers(0, jcfg.vocab, (B, s)).astype(np.int32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j).astype(np.float32), rtol=tol, atol=tol)


def _leaves(cache):
    out = []
    for e in cache:
        out += [e["conv"], e["ssm"]] if isinstance(e, dict) else list(e)
    return out


def test_layout_and_params_round_trip():
    """One period: attention at 4, MoE at the odd positions; the numpy
    tree crosses both ways byte-exact, every leaf counted once."""
    jcfg, tcfg, _, model, tree = _weights()
    assert tJ.block_layout(tcfg) == jJ.block_layout(jcfg)
    assert [m for m, _ in tJ.block_layout(tcfg)].count("attn") == 1
    back = params_to_numpy(tcfg, model)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(tree), flat(back)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in a.values())


@pytest.mark.parametrize("scatter", [False, True], ids=["gather-combine", "scatter-combine"])
def test_loss_and_logits_match_reference(scatter):
    """``jamba_loss`` (xent + MoE aux) and its metrics, and the full
    forward's logits, in both MoE combine modes."""
    jcfg, tcfg, jp, model, _ = _weights()
    jcfg, tcfg = jcfg.replace(moe_scatter_combine=scatter), tcfg.replace(moe_scatter_combine=scatter)
    toks = _tokens(jcfg, 1)
    rng = np.random.default_rng(2)
    batch = {"tokens": toks, "loss_mask": (rng.random((B, S)) > 0.3).astype(np.int32)}
    j_loss, j_metrics = jax.jit(lambda p, b: japi.loss_fn(jcfg, p, b))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_metrics = tapi.loss_fn(tcfg, model, batch)
    assert set(t_metrics) == set(j_metrics) == {"xent", "aux", "loss"}
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    assert float(t_metrics["aux"]) > 0
    j_logits = jax.jit(lambda p, t: jJ._forward(jcfg, p, t)[0])(jp, jnp.asarray(toks))
    with torch.no_grad():
        t_logits, _ = tJ.jamba_forward(tcfg, model, {"tokens": toks})
    _close(t_logits, j_logits, 1e-4)


def test_prefill_and_decode_match_reference():
    """The prefill's last logits and cache (K/V padded to max_len, Mamba
    states), then four greedy decode steps: logits, tokens and every cache
    leaf; the cache tensors are updated in place."""
    jcfg, tcfg, jp, model, _ = _weights()
    toks = _tokens(jcfg, 3)
    j_logits, j_cache = jax.jit(lambda p, t: japi.prefill(jcfg, p, {"tokens": t}, max_len=MAX_LEN))(jp, jnp.asarray(toks))
    t_logits, t_cache = tapi.prefill(tcfg, model, {"tokens": toks}, max_len=MAX_LEN)
    _close(t_logits, j_logits, 1e-4)
    t_leaves, j_leaves = _leaves(t_cache), jax.tree.leaves(j_cache)
    assert [tuple(t.shape) for t in t_leaves] == [j.shape for j in j_leaves]
    for t, j in zip(t_leaves, j_leaves):
        _close(t, j, 1e-4)
    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(jcfg, p, c, tok, pos))
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for _ in range(STEPS):
        j_logits, j_cache = step(jp, j_cache, jnp.asarray(tok), jnp.asarray(pos))
        t_logits, t_cache2 = tapi.decode_step(tcfg, model, t_cache, tok, pos)
        assert t_cache2 is t_cache and all(a is b for a, b in zip(_leaves(t_cache2), t_leaves))
        _close(t_logits, j_logits, 1e-4)
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(t_logits, -1).numpy(), tok)
        pos = pos + 1
    for t, j in zip(_leaves(t_cache), jax.tree.leaves(j_cache)):
        _close(t, j, 1e-4)


def test_bf16_decode_matches_full_forward():
    """bf16 (the config as published): prefill 14 tokens, decode the 15th
    and 16th; each step's logits against ``jamba_forward`` of the whole
    sequence within 5e-2 of its scale."""
    _, tcfg, _, model, _ = _weights("bfloat16")
    toks = _tokens(tcfg, 4, s=16)
    logits, cache = tapi.prefill(tcfg, model, {"tokens": toks[:, :14]}, max_len=16)
    with torch.no_grad():
        full, _ = tJ.jamba_forward(tcfg, model, {"tokens": toks})
    for i in range(2):
        logits, cache = tapi.decode_step(tcfg, model, cache, toks[:, 14 + i], np.full((B,), 14 + i, np.int32))
        ref = full[:, 14 + i].float()
        np.testing.assert_allclose(logits.float().numpy(), ref.numpy(), atol=5e-2 * float(ref.abs().max()), rtol=0)


def test_serve_engine_tokens_match_reference():
    """Both packages' ``ServeEngine`` on the same prompts, token for token
    in fp32: the splice takes the Mamba states (batch on axis 1) as it
    takes the K/V rows."""
    jcfg, tcfg, jp, model, _ = _weights()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, (n,)).astype(np.int32) for n in (5, 9, 7, 12)]
    outs = []
    for eng in (JServeEngine(jcfg, jp, max_batch=2, max_len=32), TServeEngine(tcfg, model, max_batch=2, max_len=32)):
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_done(max_steps=200)
        assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[1] == outs[0]


def test_gradients_match_reference():
    """The single-rank grad step: the loss and every gradient against
    ``jax.grad`` of the reference's loss (per-period remat off in the smoke
    config, as published)."""
    jcfg, tcfg, jp, _, tree = _weights()
    model = params_from_numpy(tcfg, tree, device="cpu")
    model.requires_grad_(True)
    toks = _tokens(jcfg, 5)
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)})[0]))(jp)
    grads, loss = ttrain.make_grad_step(tcfg)(model, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    jg = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    for name, (stacked, names) in leaf_map(tcfg, model).items():
        want = jg[name]
        got = np.stack([grads[n].numpy() for n in names]) if stacked else grads[names[0]].numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1e-6), rtol=0, err_msg=name)
