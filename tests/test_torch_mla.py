"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla``, on the smoke
``deepseek-v3-671b`` (4 heads, q_lora 32, kv_lora 16, nope 16, rope 8, v 16).

Weights and inputs are drawn with numpy from a seed and handed to both
packages. ``mla_full`` is held on its output and its latent cache seed;
``mla_decode`` (the absorbed form) on its output and the cache rows it
writes, which the port writes into the cache tensors in place.

Tolerances: rel. 1e-4 in fp32 (only summation orders differ); in bf16 the
port's absorbed decode against its own full forward of the extended
sequence within 5e-2 of the scale (the reference's decode-vs-full bound):
the two forms round at other places.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import mla as jmla  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import mla as tmla  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
THETA = 10_000.0
B, S, T = 2, 11, 16


def _cfgs(dtype="float32"):
    over = FP32 if dtype == "float32" else {}
    return jget("deepseek-v3-671b", smoke=True).replace(**over), tget("deepseek-v3-671b", smoke=True).replace(**over)


def _params(jcfg, seed):
    """numpy weights of the reference's MLA tree (norm weights non-zero, so
    they take part)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmla.mla_params(jcfg, jax.random.key(0)))
    return {k: (rng.standard_normal(a.shape) * (0.1 if a.ndim == 1 else a.shape[0] ** -0.5)).astype(np.float32)
            for k, a in shapes.items()}


def _x(seed, d, s=S):
    return np.random.default_rng(seed + 100).standard_normal((B, s, d)).astype(np.float32)


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j).astype(np.float32), rtol=tol, atol=tol)


def test_mla_full_matches_reference():
    jcfg, tcfg = _cfgs()
    p, x = _params(jcfg, 0), _x(0, jcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    j_out, (j_c, j_kr) = jmla.mla_full(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                       jnp.asarray(pos), THETA)
    t_out, (t_c, t_kr) = tmla.mla_full(tcfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                                       torch.from_numpy(pos.copy()).long(), THETA)
    assert t_out.shape == (B, S, jcfg.d_model)
    assert t_c.shape == (B, S, jcfg.mla.kv_lora_rank) and t_kr.shape == (B, S, jcfg.mla.qk_rope_head_dim)
    for t, j in ((t_out, j_out), (t_c, j_c), (t_kr, j_kr)):
        _close(t, j)


def test_mla_decode_matches_reference_and_writes_in_place():
    jcfg, tcfg = _cfgs()
    m = jcfg.mla
    p = _params(jcfg, 1)
    rng = np.random.default_rng(1)
    C0 = rng.standard_normal((B, T, m.kv_lora_rank)).astype(np.float32)
    KR0 = rng.standard_normal((B, T, m.qk_rope_head_dim)).astype(np.float32)
    x = _x(1, jcfg.d_model, 1)
    pos = np.array([5, 12], np.int32)  # ragged positions: each row masks its own tail
    j_out, (j_c, j_kr) = jmla.mla_decode(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                         (jnp.asarray(C0), jnp.asarray(KR0)), jnp.asarray(pos), THETA)
    C, KR = torch.from_numpy(C0.copy()), torch.from_numpy(KR0.copy())
    t_out, (t_c, t_kr) = tmla.mla_decode(tcfg, {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                                         (C, KR), torch.from_numpy(pos).long(), THETA)
    assert t_c is C and t_kr is KR  # written in place
    for t, j in ((t_out, j_out), (t_c, j_c), (t_kr, j_kr)):
        _close(t, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_equals_full_forward(dtype):
    """Prefill S tokens through ``mla_full``, decode token S+1 through the
    absorbed latent cache: its output is the full forward's last row."""
    _, tcfg = _cfgs(dtype)
    m = tcfg.mla
    p = {k: torch.from_numpy(v).to(tcfg.pdtype) for k, v in _params(_cfgs()[0], 2).items()}
    x = torch.from_numpy(_x(2, tcfg.d_model, S + 1)).to(tcfg.cdtype)
    pos = torch.arange(S + 1).expand(B, S + 1)
    full, _ = tmla.mla_full(tcfg, p, x, pos, THETA)
    _, (c, kr) = tmla.mla_full(tcfg, p, x[:, :S], pos[:, :S], THETA)
    C = torch.zeros(B, T, m.kv_lora_rank, dtype=tcfg.cdtype)
    KR = torch.zeros(B, T, m.qk_rope_head_dim, dtype=tcfg.cdtype)
    C[:, :S], KR[:, :S] = c, kr
    out, _ = tmla.mla_decode(tcfg, p, x[:, S:], (C, KR), torch.full((B,), S), THETA)
    ref = full[:, S:].float()
    tol = 1e-4 if dtype == "float32" else 5e-2
    scale = 1.0 if dtype == "float32" else float(ref.abs().max())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=tol, atol=tol * scale)
