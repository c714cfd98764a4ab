"""Hillclimb variants in the port must be REFACTORINGS, not approximations:
the mirror of ``tests/test_perf_variants.py``. Every knob
``launch/hillclimb.py`` turns (scatter-combine, the dispatch layout hint,
``save_acts`` remat, ``tp_strategy``) gives the port the reference's
baseline loss on the same weights and batch; ``save_acts`` gives the
reference's gradients; flash (its plain version on the CPU) gives einsum's
loss.

Weights are numpy draws in the reference's tree shapes (``jax.eval_shape``
of ``init_params``) carried across with ``params_from_numpy``; fp32 in
both packages, so a random router's top-k choices cannot flip between
them. Tolerances are the reference test's: losses rel. 1e-3, gradients
atol 1e-3 + rtol 1e-2, flash vs einsum rel. 2e-3.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.train import make_grad_step  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.convert import leaf_map, params_from_numpy  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _setup(arch, S=32, seed=3):
    jcfg, tcfg = jget(arch, smoke=True).replace(**FP32), tget(arch, smoke=True).replace(**FP32)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    tree = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32), shapes)
    tokens = rng.integers(0, jcfg.vocab, (2, S)).astype(np.int32)
    return jcfg, tcfg, tree, tokens


def _ref_loss(jcfg, tree, tokens):
    loss = jax.jit(lambda p: japi.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)})[0])
    return float(loss(jax.tree.map(jnp.asarray, tree)))


def _loss(tcfg, model, tokens):
    with torch.no_grad():
        return float(tapi.loss_fn(tcfg, model, {"tokens": torch.from_numpy(tokens)})[0])


@pytest.mark.parametrize(
    "arch,overrides",
    [
        ("granite-moe-1b-a400m", dict(moe_scatter_combine=True)),
        ("granite-moe-1b-a400m", dict(moe_scatter_combine=True, moe_dispatch_sharding=True)),
        ("deepseek-v3-671b", dict(moe_scatter_combine=True)),
        ("jamba-v0.1-52b", dict(moe_scatter_combine=True)),
        ("llama3-405b", dict(remat="save_acts")),
        ("internlm2-20b", dict(remat="save_acts")),
        ("granite-moe-1b-a400m", dict(tp_strategy="ep_only")),
    ],
)
def test_variant_loss_equivalence(arch, overrides):
    jcfg, tcfg, tree, tokens = _setup(arch)
    l0 = _ref_loss(jcfg, tree, tokens)
    model = params_from_numpy(tcfg, tree, device="cpu")
    l1 = _loss(tcfg.replace(**overrides), model, tokens)
    assert abs(l1 - l0) / max(abs(l0), 1e-9) < 1e-3, (arch, overrides, l0, l1)


@pytest.mark.parametrize("arch", ["llama3-405b", "internlm2-20b"])
def test_save_acts_gradients_match(arch):
    """The collective-saving remat policy must not change gradients: the
    port's under ``save_acts`` against the reference's under ``full``."""
    jcfg, tcfg, tree, tokens = _setup(arch, S=16)
    jcfg, tcfg = jcfg.replace(remat="full"), tcfg.replace(remat="save_acts")
    j_grads = jax.jit(jax.grad(lambda p: japi.loss_fn(jcfg, p, {"tokens": jnp.asarray(tokens)})[0]))(
        jax.tree.map(jnp.asarray, tree))
    model = params_from_numpy(tcfg, tree, device="cpu").requires_grad_(True)
    grads, _ = make_grad_step(tcfg)(model, {"tokens": torch.from_numpy(tokens)})
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    for name, (stacked, port) in leaf_map(tcfg, model).items():
        got = np.stack([grads[n].numpy() for n in port]) if stacked else grads[port[0]].numpy()
        np.testing.assert_allclose(got, want[name], atol=1e-3, rtol=1e-2, err_msg=name)


def test_flash_attention_impl_matches_einsum():
    """attn_impl='flash' (the kernel's plain version on CPU tensors) equals
    the einsum path, and both the reference's einsum loss."""
    jcfg, tcfg, tree, tokens = _setup("internlm2-20b", S=128)
    model = params_from_numpy(tcfg, tree, device="cpu")
    l_einsum = _loss(tcfg, model, tokens)
    l_flash = _loss(tcfg.replace(attn_impl="flash"), model, tokens)
    assert abs(l_flash - l_einsum) / max(abs(l_einsum), 1e-9) < 2e-3, (l_einsum, l_flash)
    l_ref = _ref_loss(jcfg, tree, tokens)
    assert abs(l_einsum - l_ref) / abs(l_ref) < 1e-3, (l_einsum, l_ref)
