"""The port's sharded train step for every family of the zoo, against the
JAX package's sharded step: ``granite-moe-1b-a400m`` (MoE),
``deepseek-v3-671b`` (MLA, MoE with a shared expert, MTP),
``phi-3-vision-4.2b`` (the VLM prefix), ``rwkv6-7b``, ``jamba-v0.1-52b``
(the hybrid, MoE) and ``whisper-tiny`` (the encoder-decoder), each at its
smoke size with ``grad_accum=2`` in fp32, on a ``(2, 2, 2)`` ``("pod",
"data", "model")`` mesh. fp32: in bf16 the two packages' single-device
losses already differ by about 1.5e-4 of the loss at these sizes (their
products round differently), more than the sharded step may add.

The weights are numpy draws in the shapes of the reference's tree
(``jax.eval_shape`` of ``init_params``), carried to the port with
``params_from_numpy``. The reference runs once in a subprocess (this file
run as a script) over 8 forced host devices on ``AxisType.Auto`` axes, as
``tests/test_torch_dist_train.py`` runs it: its sharded step (GSPMD runs
the global microbatch, so its MoE routes over every token) and its
single-device step from the same state.

Tolerances, ``tests/test_torch_dist_train.py``'s: the loss to 1e-4
relative, the grad norm to 1e-2; the updated params within one bf16 step
of the reference's except where a gradient near zero flips AdamW's
first step (at most ``2·lr`` plus a step), such elements at most 1% of the
model and at most twice as many as between the reference's own sharded
and single-device steps (plus a floor of 8 elements: a smoke model's
count is a handful either way).

The MoE cases hold the routing over the dp groups on the port alone: ``moe_apply(route=)`` per group against the reference's
``moe_apply`` on the whole batch; the sharded step's dropped choices per
layer (> 0 on the batch used) and its aux against the single-rank
step's, under the remat policies ``none``, ``full`` (the layer recomputed
outside the region reuses its count exchange) and ``save_acts``; and
``make_grad_step(dp=)`` against the single-rank grads for all ten archs.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b", "phi-3-vision-4.2b", "rwkv6-7b", "jamba-v0.1-52b",
         "whisper-tiny")
MESH = ((2, 2, 2), ("pod", "data", "model"))
B, S, ACCUM = 8, 16, 2
LR = 1e-3
FP32 = dict(param_dtype="float32", compute_dtype="float32", accum_dtype="float32")


def _shapes(jcfg):
    import jax

    from repro.models import api as japi

    return jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))


def _numpy_tree(jcfg, seed):
    """The reference's params tree as numpy draws (flat, '/'-joined paths):
    normal · 1/sqrt(fan-in), ``tok``/``router`` 0.02, norm-like leaves 1 +
    0.1 · normal for layernorm weights, else 0.1 · normal; RWKV's decay base
    ``w0`` -6 and its mixing coefficients 0.5, each plus 0.1 · normal;
    Mamba's ``A_log`` log(1..d_state), ``D`` 1, ``dt_bias`` -4.6, each plus
    0.1 · normal (``tests/test_torch_zoo_train.py``'s draws)."""
    import jax

    rng = np.random.default_rng(seed)
    shapes = _shapes(jcfg)
    fixed = {"w0": -6.0, "mu_x": 0.5, "mu_wkvrg": 0.5, "mu_k_c": 0.5, "mu_r_c": 0.5, "D": 1.0, "dt_bias": -4.6}
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(shapes)[0]:
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
        out[jax.tree_util.keystr(path, simple=True, separator="/")] = v.astype(np.float32).astype(a.dtype)
    return out


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.vlm:
        batch["img_embeds"] = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        batch["enc_frames"] = rng.standard_normal((B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _words(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


#: the jobs (``arch:step``) of each reference subprocess, which run side by
#: side: each compiles its steps, and Jamba's two take as long as the rest
ORACLE_GROUPS = (("jamba-v0.1-52b:sharded",), ("jamba-v0.1-52b:single",),
                 ("deepseek-v3-671b:sharded", "deepseek-v3-671b:single", "phi-3-vision-4.2b:sharded",
                  "phi-3-vision-4.2b:single"),
                 ("granite-moe-1b-a400m:sharded", "granite-moe-1b-a400m:single", "rwkv6-7b:sharded",
                  "rwkv6-7b:single", "whisper-tiny:sharded", "whisper-tiny:single"))


def _oracle_main(in_dir: str, out_dir: str, jobs) -> None:
    """Subprocess entry: the reference's sharded or single-device step
    (``arch:sharded``, ``arch:single``) of each job over 8 forced host
    devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.launch.train import make_train_step, named, train_shardings
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel import sharding as shd

    mesh = jax.make_mesh(MESH[0], MESH[1], axis_types=(AxisType.Auto,) * 3)
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)
    for job in jobs:
        arch, kind = job.split(":")
        cfg = get_config(arch, smoke=True).replace(grad_accum=ACCUM, **FP32)
        flat = dict(np.load(os.path.join(in_dir, f"{arch}.npz")))
        shapes = _shapes(cfg)
        paths, treedef = jax.tree_util.tree_flatten_with_path(shapes)
        params = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(flat[jax.tree_util.keystr(p, simple=True, separator="/")]).astype(a.dtype) for p, a in paths])
        batch = {k[len("batch/"):]: v for k, v in flat.items() if k.startswith("batch/")}
        opt = adamw_init(opt_cfg, params)

        def flat_out(prefix, tree):
            return {f"{prefix}/{shd._path_str(p)}": _words(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

        if kind == "single":
            p1, _, _ = jax.jit(make_train_step(cfg, opt_cfg))(params, opt, batch)
            np.savez(os.path.join(out_dir, f"{arch}.single.npz"), **flat_out("single", p1))
            continue
        pspecs, ospecs, bspecs, _ = train_shardings(cfg, opt_cfg, mesh, params, batch)
        step = jax.jit(
            make_train_step(cfg, opt_cfg, dp=shd.dp_axes(mesh)),
            in_shardings=(named(mesh, pspecs), named(mesh, ospecs), named(mesh, bspecs)),
            out_shardings=(named(mesh, pspecs), named(mesh, ospecs), None),
        )
        with mesh:
            p2, _, m = step(jax.device_put(params, named(mesh, pspecs)), jax.device_put(opt, named(mesh, ospecs)),
                            jax.device_put(batch, named(mesh, bspecs)))
        np.savez(os.path.join(out_dir, f"{arch}.sharded.npz"), loss=np.float32(m["loss"]),
                 grad_norm=np.float32(m["grad_norm"]), **flat_out("p", p2))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """(arch → (the weights as the reference's flat numpy tree, the batch),
    arch → the reference's results)."""
    from repro.configs import get_config

    assert sorted(job for group in ORACLE_GROUPS for job in group) == sorted(
        f"{a}:{k}" for a in ARCHS for k in ("sharded", "single"))
    d = tmp_path_factory.mktemp("p11c_zoo")
    inputs = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch, smoke=True).replace(**FP32)
        inputs[arch] = (_numpy_tree(cfg, seed=i), _batch(cfg, 10 + i))
        np.savez(d / f"{arch}.npz", **{k: v.astype(np.float32) for k, v in inputs[arch][0].items()},
                 **{f"batch/{k}": v for k, v in inputs[arch][1].items()})
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(d), str(d), *group], env=env,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True) for group in ORACLE_GROUPS]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"reference subprocess failed:\n{err[-4000:]}"
    return inputs, {arch: {**np.load(d / f"{arch}.sharded.npz"), **np.load(d / f"{arch}.single.npz")} for arch in ARCHS}


# ----------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------


def _mesh():
    from repro_torch.core.mesh import make_mesh

    return make_mesh(*MESH, device="cpu")


def _opt_cfg():
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)


def _sharded_state(cfg, model, batch):
    from repro_torch.core.mesh import device_put
    from repro_torch.launch.train import named, train_shardings
    from repro_torch.optim.adamw import adamw_init

    mesh, opt_cfg = _mesh(), _opt_cfg()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    pspecs, ospecs, _, _ = train_shardings(cfg, opt_cfg, mesh, model, batch)
    return device_put(params, named(mesh, pspecs)), device_put(adamw_init(opt_cfg, params), named(mesh, ospecs))


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _as_float(words: np.ndarray) -> np.ndarray:
    """A saved leaf as fp32: bf16 words (int16) widened, fp32 as it is."""
    if words.dtype == np.int16:
        return torch.from_numpy(words.copy()).view(torch.bfloat16).float().numpy()
    return words.astype(np.float32)


def _off_by_more_than_a_step(got: np.ndarray, want: np.ndarray, name: str) -> int:
    """Hold one updated leaf to the module docstring's rule; returns how
    many elements differ by more than one bf16 step."""
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    diff = np.abs(got - want)
    off = diff > step
    assert np.all(diff[off] <= 2 * LR + step[off]), (name, float(diff.max()))
    return int(off.sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference(oracle, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.convert import leaf_map, params_from_numpy
    from repro_torch.parallel.sharding import dp_axes

    inputs, results = oracle
    tree, batch = inputs[arch]
    ref = results[arch]
    cfg = get_config(arch, smoke=True).replace(grad_accum=ACCUM, **FP32)
    model = params_from_numpy(cfg, tree, device="cpu")
    params, opt = _sharded_state(cfg, model, batch)
    _, _, metrics = make_train_step(cfg, _opt_cfg(), dp=dp_axes(_mesh()))(params, opt, _torch_batch(batch))
    loss = metrics["loss"].item()
    assert abs(loss - float(ref["loss"])) <= 1e-4 * abs(float(ref["loss"])), (loss, float(ref["loss"]))
    assert abs(metrics["grad_norm"].item() - float(ref["grad_norm"])) <= 1e-2 * float(ref["grad_norm"])
    off = ref_off = total = 0
    for name, (stacked, names) in leaf_map(cfg, model).items():
        pick = (lambda f: np.stack([f(n) for n in names])) if stacked else (lambda f: f(names[0]))
        got = pick(lambda n: params[n].gather().float().numpy())
        want, single = _as_float(ref[f"p/{name}"]), _as_float(ref[f"single/{name}"])
        assert got.shape == want.shape, name
        off += _off_by_more_than_a_step(got, want, name)
        ref_off += _off_by_more_than_a_step(single, want, name)
        total += want.size
    assert off <= 0.01 * total and off <= 2 * ref_off + 8, (off, ref_off, total)


# ----------------------------------------------------------------------
# MoE routing over the dp groups, on the port (fp32)
# ----------------------------------------------------------------------


def _granite(remat="none", seed=0, router_scale=1.0):
    """Smoke granite in fp32 with ``remat``; the router drawn ``router_scale``
    times the reference's scale (a sharper router loads some experts past
    their capacity)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("granite-moe-1b-a400m", smoke=True).replace(grad_accum=ACCUM, remat=remat, **FP32)
    model = api.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("router"):
                p.mul_(router_scale)
    return cfg, model


def _single_drops(cfg, model, batch):
    """Per MoE layer, the choices the single-rank loss drops, summed over
    the microbatches (``moe.observers``, counted without grad: no remat)."""
    from repro_torch.models import api, moe

    seen = []
    moe.observers.append(lambda dropped: seen.append(int(dropped)))
    try:
        with torch.no_grad():
            for i in range(ACCUM):
                api.loss_fn(cfg, model, {k: v[i * B // ACCUM:(i + 1) * B // ACCUM] for k, v in batch.items()})
    finally:
        moe.observers.pop()
    return np.asarray(seen).reshape(ACCUM, -1).sum(0)


def test_global_routing_matches_reference_moe_apply():
    """moe_apply(route=) on each of 4 dp groups' rows (a (4,) mesh) against
    the reference's moe_apply on the whole batch, train capacity: the
    outputs, and the aux formed from the groups' summed sums; the dropped
    choices equal the single-rank port's (> 0)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import moe as jmoe
    from repro_torch.core.collectives import all_reduce
    from repro_torch.core.mesh import P, make_mesh, shard_map
    from repro_torch.core.streams import StreamComm
    from repro_torch.models import moe

    cfg, model = _granite(router_scale=20.0)
    ffn = {k: v.detach() for k, v in model.groups[0][0].ffn.items()}
    rng = np.random.default_rng(5)  # tokens that share a direction: the router loads some experts past capacity
    x = torch.from_numpy((rng.standard_normal((B, S, cfg.d_model)) + rng.standard_normal(cfg.d_model)).astype(np.float32))
    mesh = make_mesh((4,), ("data",), device="cpu")
    comm = StreamComm(("data",), mesh=mesh)

    def body(xs):
        y, sums = moe.moe_apply(cfg, ffn, xs, train=True, route=moe.GlobalRouting(comm))
        return y, all_reduce(sums, comm)[0]

    y, sums = shard_map(body, mesh, P("data"), (P("data"), P()))(x)
    jcfg = jget("granite-moe-1b-a400m", smoke=True).replace(**FP32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(jcfg, p, x, train=True))(
        {k: jnp.asarray(v.numpy()) for k, v in ffn.items()}, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5 * float(np.abs(np.asarray(jy)).max()))
    assert abs(moe.router_aux_from_sums(cfg, sums[None]).item() - float(jaux)) <= 1e-6
    seen = []
    moe.observers.append(lambda dropped: seen.append(int(dropped)))
    try:
        moe.moe_apply(cfg, ffn, x, train=True)
    finally:
        moe.observers.pop()
    assert seen[0] > 0 and int(sums[2 * cfg.moe.n_experts]) == seen[0]


@pytest.mark.parametrize("remat", ["none", "full", "save_acts"])
def test_moe_drops_and_aux_match_single_rank(remat):
    """The sharded step on a batch whose capacity drops choices: per layer
    the same dropped choices (> 0) as the single-rank step, its aux within
    1e-6, its loss to 1e-5 and its grads within 1e-4 of each leaf's
    largest. Under ``remat="full"`` every layer is recomputed in the
    caller's backward, outside the region, from its forward's exchange."""
    from repro_torch.launch.train import make_grad_step, make_train_step
    from repro_torch.models import api
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel.sharding import dp_axes

    cfg, model = _granite(remat, router_scale=20.0)
    batch = _torch_batch(_batch(cfg, 7))
    params, opt = _sharded_state(cfg, model, batch)
    grads, gloss = make_grad_step(cfg, dp=dp_axes(_mesh()))(params, batch)
    _, _, m = make_train_step(cfg, _opt_cfg(), dp=dp_axes(_mesh()))(params, opt, batch)
    want_drops = _single_drops(cfg, model, batch)
    aux = np.mean([float(api.loss_fn(cfg, model, {k: v[i * B // ACCUM:(i + 1) * B // ACCUM]
                                                  for k, v in batch.items()})[1]["aux"]) for i in range(ACCUM)])
    single = copy.deepcopy(model).requires_grad_(True)
    want, loss1 = make_grad_step(cfg)(single, batch)
    _, _, m1 = make_train_step(cfg, _opt_cfg())(single, adamw_init(_opt_cfg(), dict(single.named_parameters())), batch)
    assert want_drops.sum() > 0 and m["moe_dropped"].tolist() == want_drops.tolist(), (m["moe_dropped"], want_drops)
    assert abs(m["aux"].item() - aux) <= 1e-6
    assert abs(m["loss"].item() - m1["loss"].item()) <= 1e-5 * abs(m1["loss"].item())
    assert abs(gloss.item() - loss1.item()) <= 1e-5 * abs(loss1.item())
    for n, g in grads.items():
        w = want[n].numpy()
        assert np.max(np.abs(g.gather().numpy() - w)) <= 1e-4 * max(np.abs(w).max(), 1e-6), n


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b", "granite-moe-1b-a400m", "deepseek-v3-671b",
                                  "llama3-405b", "internlm2-20b", "gemma3-4b", "phi-3-vision-4.2b",
                                  "jamba-v0.1-52b", "whisper-tiny"])
def test_sharded_grads_match_single_rank(arch):
    """make_grad_step(dp=) for every arch of the zoo, fp32 at smoke size:
    every block's gradient, gathered, within 1e-4 of each leaf's largest
    of the single-rank gradient, and the loss to 1e-5; make_train_step(dp=)
    from the same state gives the same loss and finite params. Whisper's
    key biases (``*.attn.bk``, ``*.xattn.bk``) shift each softmax row by a
    constant and it has no rope, so their true gradient is zero and both
    steps hold only their rounding, summed in another order: they are held
    at 1e-4 of the same attention's ``wk`` gradient's largest, each step's
    values as near zero as that."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.train import make_grad_step, make_train_step
    from repro_torch.models import api
    from repro_torch.parallel.sharding import dp_axes

    assert arch in list_archs()
    cfg = get_config(arch, smoke=True).replace(grad_accum=ACCUM, **FP32)
    model = api.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    batch = _torch_batch(_batch(cfg, 3))
    params, opt = _sharded_state(cfg, model, batch)
    grads, loss = make_grad_step(cfg, dp=dp_axes(_mesh()))(params, batch)
    model.requires_grad_(True)
    want, loss1 = make_grad_step(cfg)(model, batch)
    assert abs(loss.item() - loss1.item()) <= 1e-5 * abs(loss1.item())
    for n, g in grads.items():
        assert g.sharding == params[n].sharding
        w, got = want[n].numpy(), g.gather().numpy()
        if arch == "whisper-tiny" and n.endswith("attn.bk"):
            bound = 1e-4 * np.abs(want[n[:-2] + "wk"].numpy()).max()
            assert np.abs(got).max() <= bound and np.abs(w).max() <= bound, n
            assert np.max(np.abs(got - w)) <= bound, n
            continue
        assert np.max(np.abs(got - w)) <= 1e-4 * max(np.abs(w).max(), 1e-6), n
    _, _, m = make_train_step(cfg, _opt_cfg(), dp=dp_axes(_mesh()))(params, opt, batch)
    assert abs(m["loss"].item() - loss.item()) <= 1e-6 * abs(loss.item())
    assert all(bool(torch.isfinite(st.gather()).all()) for st in params.values())


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2], sys.argv[3:])
