"""The port's Whisper (``repro_torch.models.whisper``) against the JAX
package's, at the smoke config (2 encoder + 2 decoder layers, d 64, 4
heads of 16, layernorm, Q/K/V biases, 16 stub frames).

The weights are numpy draws in the shapes of the reference's tree
(``enc_layers`` and ``dec_layers`` stacked), carried to the port with
``params_from_numpy``; the same numpy tokens and frames go through the
reference's jitted functions and the port's. Tolerances, as
``tests/test_torch_models.py`` states them: fp32 logits rel. 1e-4, losses
rel. 1e-5, greedy tokens equal, gradients 1e-4 of each leaf's largest
magnitude; the port's bf16 decode against its own teacher-forced decoder
within 5e-2 of the logits' scale (``tests/test_models_smoke.py``). The
decoder's 128-token case takes the flash route (its plain version here).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import whisper as tW  # noqa: E402
from repro_torch.models.common import logits_out  # noqa: E402
from repro_torch.models.convert import leaf_map, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TServeEngine  # noqa: E402

ARCH = "whisper-tiny"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, MAX_LEN, STEPS = 2, 15, 24, 4


def _cfgs(dtype="float32", **over):
    over = {**(FP32 if dtype == "float32" else {}), **over}
    return jget(ARCH, smoke=True).replace(**over), tget(ARCH, smoke=True).replace(**over)


def _numpy_params(jcfg, seed):
    """The reference's tree filled with numpy draws: normal ·
    1/sqrt(fan-in), token embedding 0.02, norm weights 1 + 0.1 · normal,
    every bias 0.1 · normal (non-zero, so they take part)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))

    def one(path, a):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(a.shape)
        if name == "tok":
            v = 0.02 * n
        elif name == "w":
            v = 1.0 + 0.1 * n
        elif name in ("b", "bq", "bk", "bv", "b_in", "b_out"):
            v = 0.1 * n
        else:
            v = n * a.shape[-2] ** -0.5
        return v.astype(np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


@functools.lru_cache(maxsize=None)
def _weights(dtype="float32"):
    jcfg, tcfg = _cfgs(dtype)
    tree = _numpy_params(jcfg, seed=0)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, device="cpu"), tree


def _batch(jcfg, seed, s=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, jcfg.vocab, (B, s)).astype(np.int32),
            "enc_frames": rng.standard_normal((B, jcfg.n_audio_ctx, jcfg.d_model)).astype(np.float32)}


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j).astype(np.float32), rtol=tol, atol=tol)


def test_params_round_trip():
    """The numpy tree crosses both ways byte-exact: layernorm ``w``/``b``,
    Q/K/V biases, ``xattn`` and the GELU MLP of both stacks."""
    jcfg, tcfg, _, model, tree = _weights()
    back = params_to_numpy(tcfg, model)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(tree), flat(back)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert {"['dec_layers']['xattn']['bq']", "['enc_layers']['mlp']['b_in']", "['enc_ln_post']['b']"} <= a.keys()
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in a.values())


def test_sinusoids_match_reference():
    """The encoder's 1500 positions at d 384, within 2.5e-4: two fp32 steps
    of the largest angle (1500), where the two libraries' ``exp`` may round
    the inverse timescale one step apart."""
    np.testing.assert_allclose(tW.sinusoids(1500, 384).numpy(), np.asarray(jW.sinusoids(1500, 384)), rtol=0,
                               atol=2.5e-4)


@pytest.mark.parametrize("s,attn", [(S, "einsum"), (128, "flash")], ids=["einsum", "flash-128"])
def test_loss_encoder_and_logits_match_reference(s, attn):
    """The encoder's states, the teacher-forced decoder's logits and the
    loss; at 128 tokens with ``attn_impl="flash"`` the decoder's
    self-attention takes the flash route (both packages)."""
    jcfg, tcfg, jp, model, _ = _weights()
    jcfg, tcfg = jcfg.replace(attn_impl=attn), tcfg.replace(attn_impl=attn)
    batch = _batch(jcfg, 1, s)
    batch["loss_mask"] = (np.random.default_rng(2).random((B, s)) > 0.3).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_metrics = jax.jit(lambda p, b: japi.loss_fn(jcfg, p, b))(jp, jb)
    t_loss, t_metrics = tapi.loss_fn(tcfg, model, batch)
    assert set(t_metrics) == set(j_metrics) == {"xent", "loss"}
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    j_enc = jax.jit(lambda p, f: jW.encode(jcfg, p, f))(jp, jb["enc_frames"])
    j_logits = jax.jit(lambda p, t, e: jW._decode_full(jcfg, p, t, e)[0])(jp, jb["tokens"], j_enc)
    with torch.no_grad():
        t_enc = tW.encode(tcfg, model, batch["enc_frames"])
        x, _ = tW.decode_full(tcfg, model, torch.from_numpy(batch["tokens"]).long(), t_enc)
    _close(t_enc, j_enc, 1e-4)
    _close(logits_out(tcfg, model.embed, x), j_logits, 1e-4)


def test_prefill_and_decode_match_reference():
    """The prefill's last logits and cache (self K/V padded to max_len, the
    cross K/V of the encoder), then four greedy decode steps; the
    self-attention cache is updated in place."""
    jcfg, tcfg, jp, model, _ = _weights()
    batch = _batch(jcfg, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_logits, j_cache = jax.jit(lambda p, b: japi.prefill(jcfg, p, b, max_len=MAX_LEN))(jp, jb)
    t_logits, t_cache = tapi.prefill(tcfg, model, batch, max_len=MAX_LEN)
    _close(t_logits, j_logits, 1e-4)
    t_leaves = [*t_cache["cross"], *t_cache["self"]]  # the reference's leaf order: keys sorted
    j_leaves = jax.tree.leaves(j_cache)
    assert [tuple(t.shape) for t in t_leaves] == [j.shape for j in j_leaves]
    for t, j in zip(t_leaves, j_leaves):
        _close(t, j, 1e-4)
    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(jcfg, p, c, tok, pos))
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    pos = np.full((B,), S, np.int32)
    for _ in range(STEPS):
        j_logits, j_cache = step(jp, j_cache, jnp.asarray(tok), jnp.asarray(pos))
        t_logits, t_cache2 = tapi.decode_step(tcfg, model, t_cache, tok, pos)
        assert t_cache2["self"][0] is t_cache["self"][0]
        _close(t_logits, j_logits, 1e-4)
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(t_logits, -1).numpy(), tok)
        pos = pos + 1
    for t, j in zip([*t_cache["cross"], *t_cache["self"]], jax.tree.leaves(j_cache)):
        _close(t, j, 1e-4)


def test_bf16_decode_matches_decoder_forward():
    """bf16 (the config as published): prefill 14 tokens, decode the 15th
    and 16th; each step's logits against the teacher-forced decoder over
    the whole sequence within 5e-2 of its scale."""
    _, tcfg, _, model, _ = _weights("bfloat16")
    batch = _batch(tcfg, 4, s=16)
    logits, cache = tapi.prefill(tcfg, model, {"tokens": batch["tokens"][:, :14], "enc_frames": batch["enc_frames"]},
                                 max_len=16)
    with torch.no_grad():
        x, _ = tW.decode_full(tcfg, model, torch.from_numpy(batch["tokens"]).long(),
                              tW.encode(tcfg, model, batch["enc_frames"]))
        full = logits_out(tcfg, model.embed, x)
    for i in range(2):
        logits, cache = tapi.decode_step(tcfg, model, cache, batch["tokens"][:, 14 + i], np.full((B,), 14 + i, np.int32))
        ref = full[:, 14 + i].float()
        np.testing.assert_allclose(logits.float().numpy(), ref.numpy(), atol=5e-2 * float(ref.abs().max()), rtol=0)


def test_gradients_match_reference():
    """The single-rank grad step on a batch with ``enc_frames``: the loss
    and every gradient against ``jax.grad`` of the reference's loss. A key
    bias shifts a softmax row by a constant, so its true gradient is zero:
    ``bk`` is held at the scale of ``wk``'s gradient."""
    jcfg, tcfg, jp, _, tree = _weights()
    model = params_from_numpy(tcfg, tree, device="cpu")
    model.requires_grad_(True)
    batch = _batch(jcfg, 5)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
    grads, loss = ttrain.make_grad_step(tcfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    jg = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    for name, (stacked, names) in leaf_map(tcfg, model).items():
        want = jg[name]
        got = np.stack([grads[n].numpy() for n in names]) if stacked else grads[names[0]].numpy()
        scale = np.abs(jg[name.replace("attn/bk", "attn/wk")]).max()
        np.testing.assert_allclose(got, want, atol=1e-4 * max(scale, 1e-6), rtol=0, err_msg=name)


def test_serve_engine_refuses_encoder_decoder():
    """``ServeEngine`` prefills prompts alone; Whisper needs its frames, so
    the engine raises at construction, pointing at ``models.api``."""
    _, tcfg, _, model, _ = _weights()
    with pytest.raises(ValueError, match="models.api"):
        TServeEngine(tcfg, model, max_batch=2, max_len=32)
