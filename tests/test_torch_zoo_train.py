"""Training on the rest of the zoo in the port, against the JAX package:
RWKV-6's gradients (the default per-token route; the WKV kernel has no
backward in either package), the ``"dots"`` and ``"save_acts"`` remat
policies against ``"full"``, and the single-rank ``Trainer`` on Jamba,
Whisper and RWKV-6 at smoke size.

Weights are numpy draws in the reference's tree shapes carried across with
``params_from_numpy`` (``jax.eval_shape`` of ``init_params``). Tolerances:
losses rel. 1e-5, gradients 1e-4 of each leaf's largest magnitude. A remat
policy only chooses what the backward pass recomputes, and recomputing an
op on the CPU gives its bytes again: its losses and gradients are held
equal to ``"full"``'s, as ``tests/test_perf_variants.py`` holds the
reference's.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.convert import leaf_map, params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def _numpy_tree(jcfg, seed):
    """The reference's params tree as numpy draws: normal · 1/sqrt(fan-in),
    ``tok``/``router`` 0.02, norm-like leaves 1 + 0.1 · normal for
    layernorm weights, else 0.1 · normal; RWKV's decay base ``w0`` -6 and
    its mixing coefficients 0.5, each plus 0.1 · normal; Mamba's ``A_log``
    log(1..d_state), ``D`` 1, ``dt_bias`` -4.6, each plus 0.1 · normal."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    fixed = {"w0": -6.0, "mu_x": 0.5, "mu_wkvrg": 0.5, "mu_k_c": 0.5, "mu_r_c": 0.5, "D": 1.0, "dt_bias": -4.6}

    def one(path, a):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(a.shape)
        if name in ("tok", "router"):
            v = 0.02 * n
        elif name in fixed:
            v = fixed[name] + 0.1 * n
        elif name == "A_log":
            v = np.log(np.arange(1, a.shape[-1] + 1)) + 0.1 * n
        elif name == "w" and (jcfg.norm == "layernorm" or getattr(path[-2], "key", None) == "ln_x"):
            v = 1.0 + 0.1 * n
        elif name in ("w", "b", "bq", "bk", "bv", "q_norm", "kv_norm", "dt_norm", "b_norm", "c_norm", "conv_b"):
            v = 0.1 * n
        else:
            v = n * a.shape[-2] ** -0.5
        return v.astype(np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _setup(arch, seed=0, **over):
    jcfg = jget(arch, smoke=True).replace(**FP32, **over)
    tcfg = tget(arch, smoke=True).replace(**FP32, **over)
    tree = _numpy_tree(jcfg, seed)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), tree


def _grads_vs_reference(jcfg, tcfg, jp, tree, batch):
    model = params_from_numpy(tcfg, tree, device="cpu")
    model.requires_grad_(True)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(jcfg, p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
    grads, loss = ttrain.make_grad_step(tcfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    jg = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    names = leaf_map(tcfg, model)
    assert set(names) == set(jg)
    for name, (stacked, port) in names.items():
        want = jg[name]
        got = np.stack([grads[n].numpy() for n in port]) if stacked else grads[port[0]].numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1e-6), rtol=0, err_msg=name)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_rwkv_gradients_match_reference(attn_impl):
    """``rwkv_loss`` and every gradient against ``jax.grad`` of the
    reference's ``rwkv_loss``, on 64 tokens: a kernel-route length, which
    the loss does not take under either ``attn_impl`` (the reference's
    ``rwkv_loss`` runs ``use_kernel=False``)."""
    jcfg, tcfg, jp, tree = _setup("rwkv6-7b", attn_impl=attn_impl)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 64)).astype(np.int32)
    _grads_vs_reference(jcfg, tcfg, jp, tree, {"tokens": toks})


@pytest.mark.parametrize("policy", ["dots", "save_acts"])
@pytest.mark.parametrize("arch", ["llama3-405b", "internlm2-20b", "granite-moe-1b-a400m"])
def test_remat_policies_equal_full(arch, policy):
    """The loss and every gradient under ``policy`` equal ``"full"``'s,
    byte for byte; under ``"full"`` they match ``jax.grad`` of the
    reference's loss (as ``tests/test_perf_variants.py`` holds the
    reference's ``save_acts`` against its ``full``)."""
    jcfg, tcfg, jp, tree = _setup(arch, remat="full")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    model = params_from_numpy(tcfg, tree, device="cpu")
    model.requires_grad_(True)
    g_full, l_full = ttrain.make_grad_step(tcfg)(model, batch)
    g_pol, l_pol = ttrain.make_grad_step(tcfg.replace(remat=policy))(model, batch)
    assert torch.equal(l_full, l_pol)
    assert g_full.keys() == g_pol.keys() and all(torch.equal(g_full[n], g_pol[n]) for n in g_full)
    j_loss = jax.jit(lambda p: japi.loss_fn(jcfg, p, {"tokens": jnp.asarray(toks)})[0])(jp)
    np.testing.assert_allclose(float(l_full), float(j_loss), rtol=1e-5)


def test_save_acts_saves_the_tagged_outputs():
    """Under ``"save_acts"`` the checkpointed layers keep exactly their two
    tagged outputs each for the backward pass, and under ``"dots"`` only
    products without batch dimensions (``mm``/``addmm``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import common

    seen = {"save_acts": [], "dots": []}
    for policy, fn in (("save_acts", common._save_acts), ("dots", common._save_dots)):
        def spy(ctx, op, *args, fn=fn, policy=policy, **kwargs):
            out = fn(ctx, op, *args, **kwargs)
            if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                seen[policy].append(args[1] if op is torch.ops.repro_torch.tag_act.default else str(op))
            return out

        name = "_save_acts" if policy == "save_acts" else "_save_dots"
        orig = getattr(common, name)
        setattr(common, name, spy)
        try:
            jcfg, tcfg, _, tree = _setup("llama3-405b", remat=policy)
            model = params_from_numpy(tcfg, tree, device="cpu")
            model.requires_grad_(True)
            toks = torch.zeros((1, 8), dtype=torch.long)
            ttrain.make_grad_step(tcfg)(model, {"tokens": toks})
        finally:
            setattr(common, name, orig)
    assert seen["save_acts"] == ["attn_out", "ffn_out"] * tcfg.n_layers
    assert seen["dots"] and all(op.startswith("aten.mm") or op.startswith("aten.addmm") for op in seen["dots"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-tiny", "rwkv6-7b"])
def test_trainer_runs_the_rest_of_the_zoo(arch, tmp_path):
    """The single-rank ``Trainer`` (data pipeline with Whisper's
    ``enc_frames``, AdamW, a checkpoint): its first loss is the reference's
    ``loss_fn`` on the same batch and weights, its losses stay finite and
    the last is below the first, and every parameter moved."""
    jcfg, tcfg, jp, tree = _setup(arch)
    src = params_from_numpy(tcfg, tree, device="cpu")
    tr = ttrain.Trainer(tcfg, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4), DataConfig(batch=2, seq=16, seed=0),
                        ckpt_dir=str(tmp_path), ckpt_every=2, autotune=False, device="cpu")
    try:
        with torch.no_grad():
            for n, p in tr.params.named_parameters():
                p.copy_(dict(src.named_parameters())[n])
        tr.opt_state = adamw_init(tr.opt_cfg, tr._named)
        before = {n: p.detach().clone() for n, p in tr.params.named_parameters()}
        batch = tr.pipeline.get_batch(0)
        assert ("enc_frames" in batch) == (arch == "whisper-tiny")
        j_loss, _ = japi.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tr.run(4, log_every=100)
        assert len(tr.history) == 4 and all(np.isfinite(float(l)) for l in tr.history)
        np.testing.assert_allclose(float(tr.history[0]), float(j_loss), rtol=1e-5)
        assert float(tr.history[-1]) < float(tr.history[0])
        assert all(not torch.equal(p, before[n]) for n, p in tr.params.named_parameters()), "a parameter never moved"
        assert sorted(q.name for q in tmp_path.iterdir() if q.name.startswith("step_")) == ["step_00000002", "step_00000003"]
    finally:
        tr.close()
