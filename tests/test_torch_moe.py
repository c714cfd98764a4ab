"""The port's MoE block (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the smoke ``granite-moe-1b-a400m`` (4
experts, top-2) and the same with a shared expert, in fp32.

Weights and tokens are drawn with numpy from a seed and handed to both
packages. Covered: train capacity with drops (``capacity_factor`` 0.5 makes
C smaller than the busiest expert's load), the dropless eval capacity, both
combine modes (``k`` gathers and the gate-weighted scatter-add), shared
experts, ``router_aux_loss``, ``moe_capacity`` and the
``moe_dispatch_sharding`` hint on one rank.

Tolerances: outputs rel. 1e-4 and the aux loss rel. 1e-5 in fp32 (only the
summation order of the products differs); the routes must be the
reference's, checked on these inputs together with the absence of an fp32
top-k tie that could make them differ legitimately.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
B, S = 2, 12


def _cfgs(**kw):
    over = dict(FP32, **kw)
    return jget("granite-moe-1b-a400m", smoke=True).replace(**over), tget("granite-moe-1b-a400m", smoke=True).replace(**over)


def _with_moe(jcfg, tcfg, **moe_kw):
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw)),
            tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_kw)))


def _params(jcfg, seed):
    """numpy weights of the reference's MoE tree: normal · 1/sqrt(fan-in),
    the router at 0.02 (its init scale)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmoe.moe_params(jcfg, jax.random.key(0)))

    def one(path, a):
        name = path[-1].key
        scale = 0.02 if name == "router" else 1.0 / np.sqrt(a.shape[-2])
        return (rng.standard_normal(a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def _x(seed, d):
    return np.random.default_rng(seed + 100).standard_normal((B, S, d)).astype(np.float32)


def _route_is_the_reference(jcfg, p, x):
    """The port picks the reference's experts in the reference's order, and
    no fp32 tie sits at the top-k boundary."""
    k = jcfg.moe.top_k
    xf = x.reshape(-1, x.shape[-1])
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(p["router"]), axis=-1)
    _, jtopi = jax.lax.top_k(jprobs, k)
    tprobs = torch.softmax(torch.from_numpy(xf) @ torch.from_numpy(p["router"]), dim=-1)
    _, ttopi = torch.topk(tprobs, k, dim=-1)
    srt = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    assert np.all(np.abs(np.diff(srt[:, : k + 1], axis=-1)) > 1e-6), "an fp32 top-k tie"
    np.testing.assert_array_equal(ttopi.numpy(), np.asarray(jtopi))
    return np.asarray(jtopi)


@pytest.mark.parametrize("n_shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("scatter", [False, True], ids=["gather", "scatter"])
@pytest.mark.parametrize("train", [False, True], ids=["eval_dropless", "train_drops"])
def test_moe_apply_matches_reference(train, scatter, n_shared):
    jcfg, tcfg = _cfgs(moe_scatter_combine=scatter)
    jcfg, tcfg = _with_moe(jcfg, tcfg, n_shared=n_shared, capacity_factor=0.5)
    seed = 4 * train + 2 * scatter + n_shared
    p, x = _params(jcfg, seed), _x(seed, jcfg.d_model)
    topi = _route_is_the_reference(jcfg, p, x)
    C = jmoe.moe_capacity(B * S, jcfg, train=train)
    load = np.bincount(topi.reshape(-1), minlength=jcfg.moe.n_experts).max()
    assert (load > C) == train  # train capacity drops on these inputs; eval never does

    j_out, j_aux = jmoe.moe_apply(jcfg, jax.tree.map(jnp.asarray, p), jnp.asarray(x), train=train)
    t_out, t_aux = tmoe.moe_apply(tcfg, _torch(p), torch.from_numpy(x), train=train)
    assert t_out.shape == (B, S, jcfg.d_model) and t_out.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-5)


def test_combine_modes_agree_and_bf16_stays_close():
    """The two combine modes compute one function; in bf16 (the config as
    published) the port stays within 2e-2 of the tensor's scale of the
    reference (bf16 rounds each product, in other orders)."""
    jcfg, tcfg = _cfgs()
    p, x = _params(jcfg, 11), _x(11, jcfg.d_model)
    a, _ = tmoe.moe_apply(tcfg, _torch(p), torch.from_numpy(x))
    b, _ = tmoe.moe_apply(tcfg.replace(moe_scatter_combine=True), _torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)

    jb, tb = jget("granite-moe-1b-a400m", smoke=True), tget("granite-moe-1b-a400m", smoke=True)
    pb = jax.tree.map(lambda v: jnp.asarray(v).astype(jnp.bfloat16), p)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(torch.bfloat16) if k != "router"
          else torch.from_numpy(p["router"]) for k, v in pb.items()}
    pb["router"] = jnp.asarray(p["router"])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    j_out, _ = jmoe.moe_apply(jb, pb, xb)
    t_out, _ = tmoe.moe_apply(tb, tp, torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    assert t_out.dtype == torch.bfloat16
    ref = np.asarray(j_out.astype(jnp.float32))
    np.testing.assert_allclose(t_out.float().numpy(), ref, atol=2e-2 * np.abs(ref).max(), rtol=2e-2)


def test_router_aux_loss_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((24, 4)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    topi = np.argsort(-probs, axis=-1)[:, :2]
    want = float(jmoe.router_aux_loss(jnp.asarray(probs), jnp.asarray(topi), 4))
    got = float(tmoe.router_aux_loss(torch.from_numpy(probs), torch.from_numpy(topi), 4))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n_tokens", [1, 7, 24, 100, 4096])
def test_moe_capacity_matches_reference(n_tokens):
    jcfg, tcfg = _cfgs()
    for kw in ({}, {"eval_capacity_factor": 1.0}, {"capacity_factor": 0.5}):
        j, t = _with_moe(jcfg, tcfg, **kw)
        for train in (False, True):
            assert tmoe.moe_capacity(n_tokens, t, train) == jmoe.moe_capacity(n_tokens, j, train)
    assert tmoe.moe_capacity(n_tokens, tcfg) == max(8, -(-n_tokens // 8) * 8)  # eval: dropless


def test_dispatch_sharding_knob_raises():
    """``moe_dispatch_sharding`` is a layout hint: on one rank the port's
    single-rank grad step takes it and gives the reference's loss (which
    treats the hint as a no-op without a mesh) within rel. 1e-5, and its
    ``moe_apply`` output equals the knob-free one. The sharded step still
    refuses it (``tests/test_torch_dist_train.py``)."""
    from repro.models import api as japi
    from repro_torch.launch.train import make_grad_step
    from repro_torch.models.convert import params_from_numpy

    jcfg, tcfg = _cfgs(moe_dispatch_sharding=True)
    rng = np.random.default_rng(12)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    tree = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32), shapes)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    want, _ = japi.loss_fn(jcfg, jax.tree.map(jnp.asarray, tree), {"tokens": jnp.asarray(tokens)})
    model = params_from_numpy(tcfg, tree, device="cpu").requires_grad_(True)
    _, got = make_grad_step(tcfg)(model, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

    p, x = _torch(_params(jcfg, 0)), torch.from_numpy(_x(0, jcfg.d_model))
    y_knob, aux_knob = tmoe.moe_apply(tcfg, p, x)
    y, aux = tmoe.moe_apply(tcfg.replace(moe_dispatch_sharding=False), p, x)
    assert torch.equal(y_knob, y) and torch.equal(aux_knob, aux)
