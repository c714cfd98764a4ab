"""The port's Mamba block (``repro_torch.models.mamba``) against the JAX
package's, at the smoke Jamba config's widths (d 64, d_inner 128, d_state
16, d_conv 4, dt_rank 4), fp32.

The block's weights are numpy draws in the reference's shapes; the same
numpy input goes through the reference's jitted ``mamba_full`` /
``mamba_decode`` and the port's. Tolerances: outputs and states rel. 1e-4
(only summation orders differ), gradients 1e-4 of each leaf's largest
magnitude. ``S = 256`` is two ``CHUNK``s: the reference scans them under
``jax.checkpoint``; the port checkpoints each chunk when autograd records
the forward (the chunked route) and runs one scan otherwise (the
sequential route) — both are held against the reference.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import mamba as jM  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import mamba as tM  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
B = 2


def _cfgs():
    return (jget("jamba-v0.1-52b", smoke=True).replace(**FP32), tget("jamba-v0.1-52b", smoke=True).replace(**FP32))


def _weights(seed=0):
    """The block's params as numpy draws: projections 1/sqrt(fan-in), the
    conv 0.3, norms 0.1 · normal, ``dt_bias`` -4.6 + 0.5 · normal,
    ``A_log`` log(1..d_state) + 0.1 · normal, ``D`` 1 + 0.1 · normal."""
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jM.mamba_params(jcfg, jax.random.key(0)))
    ds = jcfg.ssm.d_state
    tree = {}
    for k, a in shapes.items():
        n = rng.standard_normal(a.shape)
        if k.endswith("_norm") or k == "conv_b":
            v = 0.1 * n
        elif k == "conv_w":
            v = 0.3 * n
        elif k == "dt_bias":
            v = -4.6 + 0.5 * n
        elif k == "A_log":
            v = np.log(np.arange(1, ds + 1))[None, :] + 0.1 * n
        elif k == "D":
            v = 1.0 + 0.1 * n
        else:
            v = n * a.shape[0] ** -0.5
        tree[k] = v.astype(np.float32)
    p = tM.mamba_params(tcfg, "cpu")
    with torch.no_grad():
        for k, v in tree.items():
            p[k].copy_(torch.from_numpy(v))
    return jcfg, tcfg, {k: jnp.asarray(v) for k, v in tree.items()}, p


def _close(t, j, tol=1e-4):
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=tol * max(np.abs(j).max(), 1e-6))


def _state(rng, cfg):
    di, ds, dc = cfg.ssm.d_inner(cfg.d_model), cfg.ssm.d_state, cfg.ssm.d_conv
    return {"conv": rng.standard_normal((B, dc - 1, di)).astype(np.float32),
            "ssm": (0.1 * rng.standard_normal((B, di, ds))).astype(np.float32)}


@pytest.mark.parametrize("S,grad", [(15, True), (256, True), (256, False)],
                         ids=["sequential", "chunked", "sequential-256"])
def test_mamba_full_matches_reference(S, grad):
    """Output and new state from a non-zero state, against the reference."""
    jcfg, tcfg, jp, p = _weights()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    st = _state(rng, jcfg)
    jy, jst = jax.jit(lambda p, x, s: jM.mamba_full(jcfg, p, x, s))(jp, jnp.asarray(x),
                                                                  {k: jnp.asarray(v) for k, v in st.items()})
    with torch.set_grad_enabled(grad):
        ty, tst = tM.mamba_full(tcfg, p, torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in st.items()})
    _close(ty, jy)
    for k in ("conv", "ssm"):
        _close(tst[k], jst[k])


def test_mamba_decode_carries_the_state():
    """Prefill 11 tokens, decode 4 one at a time: each step's output and
    the final state equal the reference's decode, and the output equals the
    port's own full forward of the whole sequence at that position; at
    S = 1 the new conv state is the last d_conv - 1 rows."""
    jcfg, tcfg, jp, p = _weights(1)
    x = np.random.default_rng(5).standard_normal((B, 15, jcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        full, _ = tM.mamba_full(tcfg, p, torch.from_numpy(x))
        _, st = tM.mamba_full(tcfg, p, torch.from_numpy(x[:, :11]))
    _, jst = jax.jit(lambda p, x: jM.mamba_full(jcfg, p, x))(jp, jnp.asarray(x[:, :11]))
    jdec = jax.jit(lambda p, x, s: jM.mamba_decode(jcfg, p, x, s))
    for t in range(11, 15):
        jy, jst = jdec(jp, jnp.asarray(x[:, t : t + 1]), jst)
        prev_conv = st["conv"]
        with torch.no_grad():
            ty, st = tM.mamba_decode(tcfg, p, torch.from_numpy(x[:, t : t + 1]), st)
        _close(ty, jy)
        _close(ty[:, 0], full[:, t].numpy())
        x_in = torch.from_numpy(x[:, t : t + 1]) @ p["in_proj"][:, : p["conv_b"].shape[0]]
        assert torch.equal(st["conv"], torch.cat([prev_conv, x_in], dim=1)[:, 1:])
    for k in ("conv", "ssm"):
        _close(st[k], jst[k])


@pytest.mark.parametrize("S", [15, 256], ids=["sequential", "chunked"])
def test_mamba_gradients_match_reference(S):
    """d(sum(y · w))/d(params, x) against ``jax.grad``: through the
    per-chunk checkpoints at S = 256."""
    jcfg, tcfg, jp, p = _weights(2)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jM.mamba_full(jcfg, p, x)[0] * w), argnums=(0, 1)))(jp, jnp.asarray(x))
    for q in p.values():
        q.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, _ = tM.mamba_full(tcfg, p, tx)
    names = list(p.keys())
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [p[k] for k in names] + [tx])
    for k, g in zip(names, grads):
        _close(g, jg[0][k])
    _close(grads[-1], jg[1])
