"""The sharded train step's tensor-parallel math (``models.tp``, each
family's ``tp_loss``), its two layout hints and ZeRO-1 on the stacking dim,
against the JAX package's sharded step.

The reference runs once, in subprocesses (this file run as a script) over
8 forced host devices on ``AxisType.Auto`` axes, as
``tests/test_torch_sharded_zoo.py`` runs it: its sharded step under
``train_shardings`` for each case (loss, grad norm, updated params), its
single-device step from the same state (the flip allowance's baseline),
and a checkpoint of a 4-layer model's sharded initial state. The weights
are numpy draws in the shapes of the reference's tree, carried to the port
with ``params_from_numpy``; fp32 smoke configs with ``grad_accum=2``.

Tolerances, ``tests/test_torch_dist_train.py``'s: the loss to 1e-4
relative, the grad norm to 1e-2, the updated params within one bf16 step
of the reference's but where a near-zero gradient flips AdamW's first step
(at most ``2·lr`` plus a step; at most 1% of the model and at most twice
as many as between the reference's own sharded and single-device steps,
plus 8). The hinted steps' losses are held to the hint-free port step to
1e-6 relative, the two-layer model's grads to the single-rank grads to
1e-4 of each leaf's largest. Collectives are counted at
``core/collectives._issue`` by kind and mesh axes (mesh position 0).
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

MESH = ((2, 2, 2), ("pod", "data", "model"))
KV_MESH = ((2, 4), ("data", "model"))  # model 4 divides no smoke config's 2 kv heads
B, S, ACCUM = 8, 16, 2
S_MOE = 32  # granite's microbatch of 4 x 32 tokens gives C = 80: C % 16 == 0, the capacity splits over data
LR = 1e-3
FP32 = dict(param_dtype="float32", compute_dtype="float32", accum_dtype="float32")

#: case → (arch, mesh, config overrides, sequence length)
CASES = {
    "qwen-none": ("qwen1.5-0.5b", MESH, dict(remat="none"), S),
    "qwen-full": ("qwen1.5-0.5b", MESH, dict(remat="full"), S),
    "qwen-save_acts": ("qwen1.5-0.5b", MESH, dict(remat="save_acts"), S),
    "qwen-fsdp": ("qwen1.5-0.5b", MESH, dict(fsdp=True), S),
    "llama3-kv": ("llama3-405b", KV_MESH, {}, S),
    "granite-none": ("granite-moe-1b-a400m", MESH, dict(remat="none"), S_MOE),
    "granite-full": ("granite-moe-1b-a400m", MESH, dict(remat="full"), S_MOE),
    "granite-ep_only": ("granite-moe-1b-a400m", MESH, dict(tp_strategy="ep_only"), S_MOE),
    "gemma3": ("gemma3-4b", MESH, {}, S),
    "internlm2": ("internlm2-20b", MESH, {}, S),
    "qwen-seq": ("qwen1.5-0.5b", MESH, dict(seq_shard_acts=True, remat="full"), S),
    "granite-seq": ("granite-moe-1b-a400m", MESH, dict(seq_shard_acts=True, remat="full"), S_MOE),
    "qwen-dispatch": ("qwen1.5-0.5b", MESH, dict(moe_dispatch_sharding=True), S),
    "granite-dispatch": ("granite-moe-1b-a400m", MESH, dict(moe_dispatch_sharding=True, remat="full"), S_MOE),
}
#: the 4-layer model whose moments ZeRO-1 lays on the stacking dim (4 layers over dp 4)
ZERO1 = ("qwen1.5-0.5b", dict(n_layers=4))
#: the reference's jobs, split over subprocesses that run side by side
ORACLE_GROUPS = (("qwen-none", "qwen-full", "qwen-save_acts", "qwen-fsdp", "qwen-seq"),
                 ("granite-none", "granite-full", "granite-ep_only", "granite-seq", "granite-dispatch"),
                 ("llama3-kv", "gemma3", "internlm2", "qwen-dispatch", "zero1"))


def _cfg(pkg_get_config, arch, over):
    return pkg_get_config(arch, smoke=True).replace(grad_accum=ACCUM, **FP32, **over)


def _shapes(jcfg):
    import jax

    from repro.models import api as japi

    return jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))


def _numpy_tree(jcfg, seed):
    """The reference's params tree as numpy draws (flat, '/'-joined paths):
    normal · 1/sqrt(fan-in), ``tok``/``router`` 0.02 (the router × 20, so
    the MoE capacity drops choices), norms and biases 0.1 · normal."""
    import jax

    rng = np.random.default_rng(seed)
    out = {}
    for path, a in jax.tree_util.tree_flatten_with_path(_shapes(jcfg))[0]:
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(a.shape)
        if name == "tok":
            v = 0.02 * n
        elif name == "router":
            v = 0.4 * n
        elif name in ("w", "b", "bq", "bk", "bv"):
            v = 0.1 * n
        else:
            v = n * a.shape[-2] ** -0.5
        out[jax.tree_util.keystr(path, simple=True, separator="/")] = v.astype(np.float32)
    return out


def _batch(cfg, seq, seed):
    return {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab, (B, seq)).astype(np.int32)}


def _words(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _oracle_main(in_dir: str, out_dir: str, jobs) -> None:
    """Subprocess entry: the reference's sharded and single-device steps of
    each case (and the ZeRO-1 model's checkpoint) over 8 forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.checkpoint.iovec_store import save_pytree
    from repro.configs import get_config
    from repro.launch.train import make_train_step, named, train_shardings
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel import sharding as shd

    opt_cfg = AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)
    for job in jobs:
        arch, mesh_def, over, _ = CASES[job] if job != "zero1" else (ZERO1[0], MESH, ZERO1[1], S)
        cfg = _cfg(get_config, arch, over)
        mesh = jax.make_mesh(mesh_def[0], mesh_def[1], axis_types=(AxisType.Auto,) * len(mesh_def[0]))
        flat = dict(np.load(os.path.join(in_dir, f"{job}.npz")))
        paths, treedef = jax.tree_util.tree_flatten_with_path(_shapes(cfg))
        params = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(flat[jax.tree_util.keystr(p, simple=True, separator="/")]).astype(a.dtype) for p, a in paths])
        batch = {"tokens": flat["batch/tokens"]}
        opt = adamw_init(opt_cfg, params)
        pspecs, ospecs, bspecs, _ = train_shardings(cfg, opt_cfg, mesh, params, batch)
        with mesh:
            params_d = jax.device_put(params, named(mesh, pspecs))
            opt_d = jax.device_put(opt, named(mesh, ospecs))
            if job == "zero1":
                save_pytree(os.path.join(out_dir, "zero1-ckpt"), {"params": params_d, "opt": opt_d}, step=0)
                continue
            step = jax.jit(make_train_step(cfg, opt_cfg, dp=shd.dp_axes(mesh)),
                           in_shardings=(named(mesh, pspecs), named(mesh, ospecs), named(mesh, bspecs)),
                           out_shardings=(named(mesh, pspecs), named(mesh, ospecs), None))
            p2, _, m = step(params_d, opt_d, jax.device_put(batch, named(mesh, bspecs)))
        p1, _, _ = jax.jit(make_train_step(cfg.replace(seq_shard_acts=False, moe_dispatch_sharding=False), opt_cfg))(
            params, opt, batch)

        def flat_out(prefix, tree):
            return {f"{prefix}/{shd._path_str(p)}": _words(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

        np.savez(os.path.join(out_dir, f"{job}.out.npz"), loss=np.float32(m["loss"]),
                 grad_norm=np.float32(m["grad_norm"]), **flat_out("p", p2), **flat_out("single", p1))


def _inputs(job):
    from repro.configs import get_config

    arch, _, over, seq = CASES[job] if job != "zero1" else (ZERO1[0], MESH, ZERO1[1], S)
    cfg = _cfg(get_config, arch, over)
    return _numpy_tree(cfg, seed=sorted(CASES).index(job) if job in CASES else 99), _batch(cfg, seq, 7)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """(job → (the weights as the reference's flat numpy tree, the batch),
    the output directory)."""
    jobs = [j for group in ORACLE_GROUPS for j in group]
    assert sorted(jobs) == sorted(list(CASES) + ["zero1"])
    d = tmp_path_factory.mktemp("p11c_tp")
    inputs = {}
    for job in jobs:
        inputs[job] = _inputs(job)
        np.savez(d / f"{job}.npz", **inputs[job][0], **{f"batch/{k}": v for k, v in inputs[job][1].items()})
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
    return inputs, d


# ----------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------


def _opt_cfg():
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)


def _port(job, inputs):
    """(cfg, mesh, model, batch) of a case, the reference's weights in the port."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models.convert import params_from_numpy

    arch, mesh_def, over, _ = CASES[job] if job != "zero1" else (ZERO1[0], MESH, ZERO1[1], S)
    cfg = _cfg(get_config, arch, over)
    tree, batch = inputs[job]
    return (cfg, make_mesh(*mesh_def, device="cpu"), params_from_numpy(cfg, tree, device="cpu"),
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _sharded_state(cfg, opt_cfg, mesh, model, batch):
    from repro_torch.core.mesh import device_put
    from repro_torch.launch.train import named, train_shardings
    from repro_torch.optim.adamw import adamw_init

    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    pspecs, ospecs, _, _ = train_shardings(cfg, opt_cfg, mesh, model, batch)
    return device_put(params, named(mesh, pspecs)), device_put(adamw_init(opt_cfg, params), named(mesh, ospecs))


def _off(got: np.ndarray, want: np.ndarray, name: str) -> int:
    """Elements beyond one bf16 step (each at most ``2·lr`` plus a step off)."""
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    diff = np.abs(got - want)
    off = diff > step
    assert np.all(diff[off] <= 2 * LR + step[off]), (name, float(diff.max()))
    return int(off.sum())


def _step(cfg, mesh, model, batch):
    """The port's sharded train step from ``model``'s weights: (metrics, params)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.parallel.sharding import dp_axes

    params, opt = _sharded_state(cfg, _opt_cfg(), mesh, model, batch)
    _, _, m = make_train_step(cfg, _opt_cfg(), dp=dp_axes(mesh))(params, opt, batch)
    return m, params


def _kinds(cfg, mesh, model, batch) -> dict:
    """The collectives mesh position 0 issues in the sharded grad step
    (forward and the transposes autograd runs), by (kind, comm axes)."""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.train import make_grad_step
    from repro_torch.parallel.sharding import dp_axes

    params, _ = _sharded_state(cfg, _opt_cfg(), mesh, model, batch)
    with rl.count_collectives() as coll:
        make_grad_step(cfg, dp=dp_axes(mesh))(params, batch)
    return coll.by_axes[0]


def _predicted(cfg, seq: bool = False, attention: bool = True) -> dict:
    """The design's collectives over ``model`` in a grad step of a
    transformer whose ``model`` splits every leaf (each microbatch: the
    embedding's all-reduce, each layer's attention and FFN outputs, the
    cross-entropy's maxima gathered and its sums all-reduced; each
    all-reduce, gather and reduce-scatter of a value autograd tracks with
    its transpose). ``seq``: the sublayer outputs reduce-scattered, their
    inputs and the trunk's output all-gathered along ``S``; ``attention``
    False: the attention runs whole (``ep_only``)."""
    L, sub = cfg.n_layers, 2 if attention else 1
    if seq:
        per = {"all-gather": 2 * L + 1 + 1 + 2 * L, "reduce-scatter": 2 * L + 2 * L + 1, "all-reduce": 4}
    else:
        per = {"all-gather": 1, "all-reduce": 2 * (1 + sub * L + 1)}
    return {(k, ("model",)): ACCUM * v for k, v in per.items()}


def _over_model(kinds: dict) -> dict:
    return {k: v for k, v in kinds.items() if k[1] == ("model",)}


@pytest.mark.parametrize("job", list(CASES))
def test_tp_step_matches_reference(oracle, job):
    from repro_torch.models.convert import leaf_map

    inputs, d = oracle
    ref = dict(np.load(d / f"{job}.out.npz"))
    cfg, mesh, model, batch = _port(job, inputs)
    m, params = _step(cfg, mesh, model, batch)
    assert abs(m["loss"].item() - float(ref["loss"])) <= 1e-4 * abs(float(ref["loss"])), (m["loss"], ref["loss"])
    assert abs(m["grad_norm"].item() - float(ref["grad_norm"])) <= 1e-2 * float(ref["grad_norm"])
    off = ref_off = total = 0
    for name, (stacked, names) in leaf_map(cfg, model).items():
        pick = (lambda f: np.stack([f(n) for n in names])) if stacked else (lambda f: f(names[0]))
        got = pick(lambda n: params[n].gather().float().numpy())
        want, single = ref[f"p/{name}"].astype(np.float32), ref[f"single/{name}"].astype(np.float32)
        off += _off(got, want, name)
        ref_off += _off(single, want, name)
        total += want.size
    assert off <= 0.01 * total and off <= 2 * ref_off + 8, (off, ref_off, total)


def test_ep_only_attention_is_whole(oracle):
    """Under ``tp_strategy="ep_only"`` the attention (replicated over
    ``model``) runs whole on every rank with no collective: the grad
    step's collectives over ``model`` are the design's without the
    attention's ``wo`` all-reduce, the TP step's with it."""
    inputs, _ = oracle
    cfg, mesh, model, batch = _port("granite-ep_only", inputs)
    assert _over_model(_kinds(cfg, mesh, model, batch)) == _predicted(cfg, attention=False)
    cfg, mesh, model, batch = _port("granite-none", inputs)
    assert _over_model(_kinds(cfg, mesh, model, batch)) == _predicted(cfg)


@pytest.mark.parametrize("job", ["qwen-seq", "granite-seq", "qwen-dispatch", "granite-dispatch"])
def test_hints_match_the_hint_free_step(oracle, job):
    """Each layout hint's step against the hint-free port step from the
    same weights: the loss within 1e-6 relative, and the grad step's
    collectives the design's: ``seq_shard_acts`` trades the sublayers'
    all-reduces over ``model`` for reduce-scatters and all-gathers along
    ``S``; ``moe_dispatch_sharding`` adds two all-to-alls over ``data`` a
    MoE layer and their transposes (none on dense qwen)."""
    inputs, _ = oracle
    cfg, mesh, model, batch = _port(job, inputs)
    plain = cfg.replace(seq_shard_acts=False, moe_dispatch_sharding=False)
    m, _ = _step(cfg, mesh, model, batch)
    m0, _ = _step(plain, mesh, model, batch)
    assert abs(m["loss"].item() - m0["loss"].item()) <= 1e-6 * abs(m0["loss"].item())
    kinds, kinds0 = _kinds(cfg, mesh, model, batch), _kinds(plain, mesh, model, batch)
    assert _over_model(kinds0) == _predicted(cfg)
    assert _over_model(kinds) == _predicted(cfg, seq=cfg.seq_shard_acts)
    moe_layers = cfg.n_layers if cfg.moe.enabled else 0
    assert kinds.get(("all-to-all", ("data",)), 0) == (ACCUM * 4 * moe_layers if cfg.moe_dispatch_sharding else 0)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_granite_drops_and_aux_match_single_rank(oracle, remat):
    """The TP step routes as the single-rank step over the whole
    microbatch: per MoE layer the same dropped choices (> 0) and the aux
    within 1e-6."""
    from repro_torch.models import api, moe

    inputs, _ = oracle
    cfg, mesh, model, batch = _port(f"granite-{remat}", inputs)
    m, _ = _step(cfg, mesh, model, batch)
    seen = []
    moe.observers.append(lambda dropped: seen.append(int(dropped)))
    try:
        with torch.no_grad():
            aux = [float(api.loss_fn(cfg, model, {k: v[i * B // ACCUM:(i + 1) * B // ACCUM]
                                                  for k, v in batch.items()})[1]["aux"]) for i in range(ACCUM)]
    finally:
        moe.observers.pop()
    drops = np.asarray(seen).reshape(ACCUM, -1).sum(0)
    assert drops.sum() > 0 and m["moe_dropped"].tolist() == drops.tolist(), (m["moe_dropped"], drops)
    assert abs(m["aux"].item() - float(np.mean(aux))) <= 1e-6


def test_two_layer_tp_grads_equal_single_rank(oracle):
    """One autograd graph spans the ranks: the two-layer qwen's TP grads
    (every block, gathered) equal the single-rank grads, no Megatron
    operator pair needed."""
    from repro_torch.launch.train import make_grad_step
    from repro_torch.parallel.sharding import dp_axes

    inputs, _ = oracle
    cfg, mesh, model, batch = _port("qwen-none", inputs)
    assert cfg.n_layers == 2
    params, _ = _sharded_state(cfg, _opt_cfg(), mesh, model, batch)
    grads, loss = make_grad_step(cfg, dp=dp_axes(mesh))(params, batch)
    single = copy.deepcopy(model).requires_grad_(True)
    want, loss1 = make_grad_step(cfg)(single, batch)
    assert abs(loss.item() - loss1.item()) <= 1e-5 * abs(loss1.item())
    for n, g in grads.items():
        w = want[n].numpy()
        assert np.max(np.abs(g.gather().numpy() - w)) <= 1e-4 * np.abs(w).max(), n


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("tied", [True, False])
def test_vocab_parallel_xent_at_large_logits(model, tied):
    """``tp.xent`` on a ``model`` mesh against ``next_token_xent`` of the
    whole logits, with logits near 100 (a shift that is not the row
    maximum overflows or underflows there) and a vocab of 251 rows, which
    ``model`` does not divide: the sum to 1e-5 relative, the count exact,
    with and without a loss mask."""
    from repro_torch.core.mesh import P, make_mesh, shard_map
    from repro_torch.models import tp
    from repro_torch.models.common import next_token_xent
    from repro_torch.models.config import ModelConfig

    V, d = 251, 32
    cfg = ModelConfig(name="xent", family="dense", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2, d_ff=64, vocab=V,
                      tie_embeddings=tied, param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(model)
    x = torch.from_numpy(rng.standard_normal((2, 9, d)).astype(np.float32))
    w = torch.from_numpy((10 * rng.standard_normal((V, d))).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, V, (2, 9)))
    mask = torch.ones(2, 9, dtype=torch.int32)
    mask[1, 4:] = 0
    name = "embed.tok" if tied else "embed.out"
    leaf = w if tied else w.t().contiguous()
    mesh = make_mesh((model,), ("model",), device="cpu")
    for m in (None, mask):
        sums = shard_map(lambda: torch.stack(tp.xent(cfg, tp.RankWeights({name: leaf}, {name: P(None, None)}, mesh),
                                                    x, tokens, m)), mesh, (), P())()
        want = next_token_xent(x @ w.t(), tokens, m)
        count = float(mask[:, 1:].sum()) if m is not None else float(tokens[:, 1:].numel())
        assert float(sums[1]) == count
        assert abs(float(sums[0] / sums[1]) - float(want)) <= 1e-5 * abs(float(want)), (float(sums[0] / sums[1]), want)


# ----------------------------------------------------------------------
# ZeRO-1 on the stacking dim
# ----------------------------------------------------------------------


def _zero1_tree(cfg, model, params, opt):
    from repro_torch.models.convert import state_tree

    tree = {k: state_tree(cfg, model, opt[k]) for k in ("m", "v", "master")}
    tree["count"] = opt["count"]
    return {"params": state_tree(cfg, model, params), "opt": tree}


def test_zero1_layers_live_on_one_dp_rank(oracle):
    """4 layers over dp 4: each layer's moments and master are held by the
    two positions of one dp rank (layer ``l`` by dp rank ``l``), whose block
    is its ``model`` block; the step updates the params as the reference's
    does (``test_tp_step_matches_reference`` runs the 2-layer models)."""
    from repro_torch.core.mesh import StackRow
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.convert import leaf_map
    from repro_torch.parallel.sharding import dp_axes

    inputs, _ = oracle
    cfg, mesh, model, batch = _port("zero1", inputs)
    params, opt = _sharded_state(cfg, _opt_cfg(), mesh, model, batch)
    stacked = [names for _, (s, names) in leaf_map(cfg, model).items() if s]
    assert stacked and all(len(names) == 4 for names in stacked)
    for names in stacked:
        for l, n in enumerate(names):
            for key in ("m", "v", "master"):
                st = opt[key][n]
                assert isinstance(st.sharding.spec, StackRow)
                held = [slot for slot in range(mesh.size) if st.blocks[slot] is not None]
                assert held == [s for s in range(mesh.size) if 2 * mesh.coords(s)["pod"] + mesh.coords(s)["data"] == l]
                assert all(st.blocks[s].shape == params[n].blocks[s].shape for s in held)
    moment_bytes = sum(st.resident_bytes(0) for key in ("m", "v", "master") for st in opt[key].values())
    param_bytes = sum(st.resident_bytes(0) for st in params.values())
    assert moment_bytes < 3 * param_bytes / 2  # a quarter of the layers' moments, not all of them
    single = copy.deepcopy(model).requires_grad_(True)
    from repro_torch.optim.adamw import adamw_init

    _, _, m1 = make_train_step(cfg, _opt_cfg())(single, adamw_init(_opt_cfg(), dict(single.named_parameters())), batch)
    _, _, m = make_train_step(cfg, _opt_cfg(), dp=dp_axes(mesh))(params, opt, batch)
    assert abs(m["loss"].item() - m1["loss"].item()) <= 1e-5 * abs(m1["loss"].item())
    assert abs(m["grad_norm"].item() - m1["grad_norm"].item()) <= 1e-4 * m1["grad_norm"].item()
    off = total = 0
    for n, p in single.named_parameters():
        want = p.detach().numpy()
        off += _off(params[n].gather().numpy(), want, n)
        total += want.size
    assert off <= 0.01 * total, (off, total)


def test_zero1_checkpoint_is_the_reference_files(oracle, tmp_path):
    """The 4-layer model's sharded state, its moments on one dp rank a
    layer, written block by block: byte for byte the reference's
    checkpoint of its sharded state; restored with ``shardings=`` (a
    ``RowShardings`` per stacked moment), every held block reads back its
    slice and the others stay empty."""
    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.mesh import ShardedTensor
    from repro_torch.models.convert import shardings_tree

    inputs, d = oracle
    cfg, mesh, model, batch = _port("zero1", inputs)
    params, opt = _sharded_state(cfg, _opt_cfg(), mesh, model, batch)
    tree = _zero1_tree(cfg, model, params, opt)
    CheckpointManager(str(tmp_path)).save_sync(0, tree)
    ours, theirs = tmp_path / "step_00000000", d / "zero1-ckpt"
    files = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == files and len(files) > 20
    for f in files:
        assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f
    per = lambda t: shardings_tree(cfg, model, {n: st.sharding for n, st in t.items()})  # noqa: E731
    shardings = {"params": per(params), "opt": {**{k: per(opt[k]) for k in ("m", "v", "master")},
                                                "count": opt["count"].sharding}}
    assert isinstance(shardings["opt"]["m"]["groups"][0][0]["ln1"]["w"], store.RowShardings)
    os.symlink(theirs, tmp_path / "step_00000001")
    loaded, step = CheckpointManager(str(tmp_path)).restore_step(1, tree, shardings=shardings)
    got, want = store.leaf_names(loaded), store.leaf_names(tree)
    held = empty = 0
    for name, leaf in got.items():
        rows = leaf.rows if isinstance(leaf, store.StackedLeaf) else [leaf]
        wrows = want[name].rows if isinstance(want[name], store.StackedLeaf) else [want[name]]
        for r, w in zip(rows, wrows):
            assert isinstance(r, ShardedTensor) and r.sharding == w.sharding
            for slot, b in enumerate(r.blocks):
                if b is None:
                    assert w.blocks[slot] is None
                    empty += 1
                    continue
                assert torch.equal(b, w.blocks[slot]), (name, slot)
                held += 1
    assert step == 0 and held > 0 and empty > 0


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2], sys.argv[3:])
