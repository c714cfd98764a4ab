"""The port's sharded train step, sharded checkpoints and sharded restore
against the JAX package's ``dist_*`` checks (``tests/multidevice_checks.py``
:231-255): smoke ``qwen1.5-0.5b`` with ``grad_accum=2`` on a ``(2, 2, 2)``
``("pod", "data", "model")`` mesh, params under ``param_specs``, moments
under ``opt_state_specs``, the batch under ``batch_specs``.

The reference runs once in a subprocess (this file run as a script) with 8
forced host devices, on a mesh of ``AxisType.Auto`` axes (JAX 0.9's
default Explicit axes make its sharded step raise ``ShardingTypeError`` at
the microbatch reshape). It writes the sharded and the single-device
step's loss, the sharded step's updated params, and a checkpoint of the
sharded initial state. The port carries the same initial weights over with
``params_from_numpy`` and runs on its CPU mesh of thread-ranks.

Tolerances: the loss to 1e-4 relative. Updated params: every element
within one bf16 step (at its own magnitude) of the other step's, except
where a gradient within rounding of zero moved the update: AdamW's first
step moves each element by ``lr·g/(|g| + eps)``, ``lr`` in the direction of
the gradient's sign, and a gradient near zero (``attn/bk``'s is zero in
exact arithmetic) takes either sign, or a fraction of ``lr``, when the
sums run in another order. Such an element differs by at most ``2·lr``
plus one bf16 step, and they are at most 1% of the model
and at most twice as many as between the reference's own sharded and
single-device steps (about 0.4% of the model there). Grads: on an fp32
copy within 1e-4 of each leaf's largest; in bf16 no farther from the fp32
grads than the single-rank bf16 grads, plus two bf16 steps at the leaf's
largest. Checkpoint files and restored blocks byte for
byte.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ARCH = "qwen1.5-0.5b"
MESH = ((2, 2, 2), ("pod", "data", "model"))
B, S = 8, 32
LR = 1e-3


def _inputs():
    return {"tokens": np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)}


def _words(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _oracle_main(in_path: str, out_dir: str) -> None:
    """Subprocess entry: the reference over 8 forced host devices."""
    import jax
    from jax.sharding import AxisType

    from repro.checkpoint.iovec_store import save_pytree
    from repro.configs import get_config
    from repro.launch.train import make_train_step, named, train_shardings
    from repro.models import api
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.parallel import sharding as shd

    cfg = get_config(ARCH, smoke=True).replace(grad_accum=2)
    mesh = jax.make_mesh(MESH[0], MESH[1], axis_types=(AxisType.Auto,) * 3)
    params = api.init_params(cfg, jax.random.key(0))
    opt_cfg = AdamWConfig(lr=LR, warmup_steps=0, total_steps=10)
    opt = adamw_init(opt_cfg, params)
    batch = {"tokens": np.load(in_path)["tokens"]}
    pspecs, ospecs, bspecs, _ = train_shardings(cfg, opt_cfg, mesh, params, batch)
    step = jax.jit(
        make_train_step(cfg, opt_cfg, dp=shd.dp_axes(mesh)),
        in_shardings=(named(mesh, pspecs), named(mesh, ospecs), named(mesh, bspecs)),
        out_shardings=(named(mesh, pspecs), named(mesh, ospecs), None),
    )
    with mesh:
        params_d = jax.device_put(params, named(mesh, pspecs))
        opt_d = jax.device_put(opt, named(mesh, ospecs))
        save_pytree(os.path.join(out_dir, "ckpt"), {"params": params_d, "opt": opt_d}, step=0)
        p2, _, m = step(params_d, opt_d, jax.device_put(batch, named(mesh, bspecs)))
    p1, _, m1 = jax.jit(make_train_step(cfg, opt_cfg))(params, opt, batch)

    def flat(prefix, tree):
        return {f"{prefix}/{shd._path_str(p)}": _words(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    np.savez(os.path.join(out_dir, "out.npz"), loss=np.float32(m["loss"]), loss_single=np.float32(m1["loss"]),
             grad_norm=np.float32(m["grad_norm"]), **flat("p", p2), **flat("single", p1))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    d = tmp_path_factory.mktemp("p11b_dist")
    np.savez(d / "in.npz", **_inputs())
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(d / "in.npz"), str(d)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"reference subprocess failed:\n{proc.stderr[-4000:]}"
    return d, dict(np.load(d / "out.npz"))


# ----------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """(cfg, opt_cfg, mesh, the reference's initial weights in the port,
    batch)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models import api as japi
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig

    jcfg = jget(ARCH, smoke=True).replace(grad_accum=2)
    tree = jax.tree.map(np.asarray, japi.init_params(jcfg, jax.random.key(0)))
    cfg = get_config(ARCH, smoke=True).replace(grad_accum=2)
    model = params_from_numpy(cfg, tree, device="cpu")
    return (cfg, AdamWConfig(lr=LR, warmup_steps=0, total_steps=10), make_mesh(*MESH, device="cpu"), model,
            {"tokens": torch.from_numpy(_inputs()["tokens"])})


def _sharded_state(cfg, opt_cfg, mesh, model, batch):
    from repro_torch.core.mesh import device_put
    from repro_torch.launch.train import named, train_shardings
    from repro_torch.optim.adamw import adamw_init

    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    pspecs, ospecs, bspecs, _ = train_shardings(cfg, opt_cfg, mesh, model, batch)
    return device_put(params, named(mesh, pspecs)), device_put(adamw_init(opt_cfg, params), named(mesh, ospecs))


def _state_tree(cfg, model, params, opt):
    from repro_torch.models.convert import state_tree

    tree = {k: state_tree(cfg, model, opt[k]) for k in ("m", "v", "master")}
    tree["count"] = opt["count"]
    return {"params": state_tree(cfg, model, params), "opt": tree}


def _bf16_step(x: np.ndarray) -> float:
    """The spacing of bf16 values at the magnitude of ``x``'s largest element."""
    top = float(np.max(np.abs(x)))
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def _off_by_more_than_a_step(got: np.ndarray, want: np.ndarray, name: str) -> int:
    """Hold one updated leaf to the module docstring's rule; returns how
    many elements differ by more than one bf16 step."""
    top = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -126)
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    diff = np.abs(got - want)
    off = diff > step
    assert np.all(diff[off] <= 2 * LR + step[off]), (name, float(diff.max()))
    return int(off.sum())


def _bf16(words: np.ndarray) -> np.ndarray:
    return torch.from_numpy(words.astype(np.int16)).view(torch.bfloat16).float().numpy()


def test_sharded_step_matches_reference(oracle, setup):
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.convert import leaf_map
    from repro_torch.parallel.sharding import dp_axes

    _, ref = oracle
    cfg, opt_cfg, mesh, model, batch = setup
    params, opt = _sharded_state(cfg, opt_cfg, mesh, model, batch)
    _, _, metrics = make_train_step(cfg, opt_cfg, dp=dp_axes(mesh))(params, opt, batch)
    loss = metrics["loss"].item()
    assert abs(loss - float(ref["loss"])) <= 1e-4 * abs(float(ref["loss"]))
    assert abs(metrics["grad_norm"].item() - float(ref["grad_norm"])) <= 1e-2 * float(ref["grad_norm"])
    off = ref_off = total = 0
    for name, (stacked, names) in leaf_map(cfg, model).items():
        pick = (lambda f: np.stack([f(n) for n in names])) if stacked else (lambda f: f(names[0]))
        got = pick(lambda n: params[n].gather().float().numpy())
        want, single = _bf16(ref[f"p/{name}"]), _bf16(ref[f"single/{name}"])
        assert got.shape == want.shape, name
        off += _off_by_more_than_a_step(got, want, name)
        ref_off += _off_by_more_than_a_step(single, want, name)
        total += want.size
    assert off <= 0.01 * total and off <= 2 * ref_off, (off, ref_off, total)


def test_sharded_step_matches_single_rank_port(setup):
    """The port's sharded step against the port's own single-rank step
    from the same state (the reference's dist_matches_single)."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel.sharding import dp_axes

    cfg, opt_cfg, mesh, model, batch = setup
    params, opt = _sharded_state(cfg, opt_cfg, mesh, model, batch)
    _, _, m = make_train_step(cfg, opt_cfg, dp=dp_axes(mesh))(params, opt, batch)
    single = copy.deepcopy(model).requires_grad_(True)
    _, _, m1 = make_train_step(cfg, opt_cfg)(single, adamw_init(opt_cfg, dict(single.named_parameters())), batch)
    assert abs(m["loss"].item() - m1["loss"].item()) <= 1e-4 * abs(m1["loss"].item())
    off = total = 0
    for n, p in single.named_parameters():
        want = p.detach().float().numpy()
        off += _off_by_more_than_a_step(params[n].gather().float().numpy(), want, n)
        total += want.size
    assert off <= 0.01 * total, (off, total)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_sharded_grad_step_matches_unsharded(setup, remat):
    """make_grad_step(dp=) gives every position the whole gradient of its
    block: gathered, it matches the single-rank grads; under remat="full"
    the layers recompute in the caller's backward, outside the region,
    reading back their logged collectives. On an fp32 copy (the
    reference's weights widened) every grad is within 1e-4 of its leaf's
    largest. In bf16 the step is tensor-parallel, so its products and
    reduces add partial sums in another order than the single-rank step,
    each difference a bf16 rounding of its own: there the sharded grads lie
    no farther from the fp32 grads than the single-rank bf16 grads do, plus
    two bf16 steps at the leaf's largest."""
    from repro_torch.launch.train import make_grad_step
    from repro_torch.parallel.sharding import dp_axes

    cfg, opt_cfg, mesh, model, batch = setup
    cfg = cfg.replace(remat=remat)
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    m32 = copy.deepcopy(model).float()
    p32, _ = _sharded_state(c32, opt_cfg, mesh, m32, batch)
    grads, loss = make_grad_step(c32, dp=dp_axes(mesh))(p32, batch)
    want, loss1 = make_grad_step(c32)(m32.requires_grad_(True), batch)
    assert abs(loss.item() - loss1.item()) <= 1e-5 * abs(loss1.item())
    for n, g in grads.items():
        assert g.sharding == p32[n].sharding
        w = want[n].float().numpy()
        for slot, b in enumerate(g.blocks):
            assert np.max(np.abs(b.float().numpy() - w[g.index(slot)])) <= 1e-4 * np.abs(w).max(), (n, slot)

    params, _ = _sharded_state(cfg, opt_cfg, mesh, model, batch)
    g16, l16 = make_grad_step(cfg, dp=dp_axes(mesh))(params, batch)
    one16, l1 = make_grad_step(cfg)(copy.deepcopy(model).requires_grad_(True), batch)
    assert abs(l16.item() - l1.item()) <= 1e-4 * abs(l1.item())
    for n, g in g16.items():
        assert g.sharding == params[n].sharding
        w = want[n].float().numpy()
        own = np.max(np.abs(one16[n].float().numpy() - w))
        for slot, b in enumerate(g.blocks):
            assert np.max(np.abs(b.float().numpy() - w[g.index(slot)])) <= own + 2 * _bf16_step(w), (n, slot)


def test_sharded_loss_with_a_mask_is_the_global_mean(setup):
    """With a loss mask that leaves the dp groups unequal token counts,
    the sharded loss is the mean over every unmasked token, as the
    unsharded loss is (not a mean of the groups' means)."""
    from repro_torch.launch.train import make_grad_step
    from repro_torch.parallel.sharding import dp_axes

    cfg, opt_cfg, mesh, model, batch = setup
    cfg = cfg.replace(grad_accum=1)
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[:3, 5:] = 0
    masked = {**batch, "loss_mask": mask}
    params, _ = _sharded_state(cfg, opt_cfg, mesh, model, masked)
    _, loss = make_grad_step(cfg, dp=dp_axes(mesh))(params, masked)
    model.requires_grad_(True)
    try:
        _, want = make_grad_step(cfg)(model, masked)
    finally:
        model.requires_grad_(False)
    assert abs(loss.item() - want.item()) <= 1e-5 * abs(want.item())


def test_sharded_checkpoint_is_the_reference_files(oracle, setup, tmp_path):
    """A checkpoint of the sharded initial state, written block by block,
    is byte for byte the reference's checkpoint of its sharded state."""
    from repro_torch.checkpoint.manager import CheckpointManager

    d, _ = oracle
    cfg, opt_cfg, mesh, model, batch = setup
    params, opt = _sharded_state(cfg, opt_cfg, mesh, model, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_sync(0, _state_tree(cfg, model, params, opt))
    ours, theirs = tmp_path / "step_00000000", d / "ckpt"
    files = sorted(os.listdir(theirs))
    assert sorted(os.listdir(ours)) == files and len(files) > 20
    for f in files:
        assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f


def test_sharded_restore_reads_each_block(oracle, setup, tmp_path):
    """restore_step(..., shardings=) from the reference's files: every
    position's block byte-equal to its slice of the global leaf."""
    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.mesh import ShardedTensor
    from repro_torch.models.convert import shardings_tree
    from repro_torch.optim.adamw import adamw_init

    d, _ = oracle
    cfg, opt_cfg, mesh, model, batch = setup
    params, opt = _sharded_state(cfg, opt_cfg, mesh, model, batch)
    template = _state_tree(cfg, model, params, opt)
    per = lambda tree: shardings_tree(cfg, model, {n: st.sharding for n, st in tree.items()})  # noqa: E731
    shardings = {"params": per(params), "opt": {**{k: per(opt[k]) for k in ("m", "v", "master")},
                                                "count": opt["count"].sharding}}
    os.symlink(d / "ckpt", tmp_path / "step_00000000")
    loaded, step = CheckpointManager(str(tmp_path)).restore_step(0, template, shardings=shardings)
    plain = {n: p.detach() for n, p in model.named_parameters()}
    globals_ = _state_tree(cfg, model, plain, adamw_init(opt_cfg, plain))
    got, want = store.leaf_names(loaded), store.leaf_names(globals_)
    assert step == 0 and set(got) == set(want)
    n_blocks = 0
    for name, leaf in got.items():
        rows = leaf.rows if isinstance(leaf, store.StackedLeaf) else [leaf]
        full = want[name].rows if isinstance(want[name], store.StackedLeaf) else [want[name]]
        for r, g in zip(rows, full):
            assert isinstance(r, ShardedTensor)
            for slot, b in enumerate(r.blocks):
                assert torch.equal(b.view(torch.uint8) if b.dtype == torch.bfloat16 else b,
                                   (lambda t: t.view(torch.uint8) if t.dtype == torch.bfloat16 else t)(
                                       g[r.index(slot)].contiguous())), (name, slot)
                n_blocks += 1
    assert n_blocks == 8 * sum(len(l.rows) if isinstance(l, store.StackedLeaf) else 1 for l in got.values())


def test_each_rank_holds_only_its_blocks(setup):
    cfg, opt_cfg, mesh, model, batch = setup
    params, opt = _sharded_state(cfg, opt_cfg, mesh, model, batch)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    per_rank = [sum(st.resident_bytes(slot) for st in params.values()) for slot in range(mesh.size)]
    assert all(b < total for b in per_rank)
    assert sum(st.blocks[0].numel() for st in params.values()) < sum(p.numel() for p in model.parameters())


def test_sharded_step_refuses_what_it_cannot_run(setup):
    """The sharded step refuses dp axes other than the mesh's; each layout
    hint runs and matches the hint-free step: the loss within 1e-6, and on
    an fp32 copy every grad within 1e-5 of its leaf's largest (in bf16
    ``seq_shard_acts``' reduce-scatters and gathers add the backward's
    partial sums in another order, a bf16 rounding apart)."""
    from repro_torch.launch.train import make_grad_step, make_train_step

    cfg, opt_cfg, mesh, model, batch = setup
    params, opt = _sharded_state(cfg, opt_cfg, mesh, model, batch)
    with pytest.raises(ValueError, match="dp axes"):
        make_train_step(cfg, opt_cfg, dp=("data",))(params, opt, batch)
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    p32, _ = _sharded_state(c32, opt_cfg, mesh, copy.deepcopy(model).float(), batch)
    _, loss = make_grad_step(cfg, dp=("pod", "data"))(params, batch)
    grads, _ = make_grad_step(c32, dp=("pod", "data"))(p32, batch)
    for flag in ("seq_shard_acts", "moe_dispatch_sharding"):
        _, l2 = make_grad_step(cfg.replace(**{flag: True}), dp=("pod", "data"))(params, batch)
        assert abs(l2.item() - loss.item()) <= 1e-6 * abs(loss.item()), flag
        g2, _ = make_grad_step(c32.replace(**{flag: True}), dp=("pod", "data"))(p32, batch)
        for n, g in grads.items():
            w = g.gather()
            assert torch.max(torch.abs(g2[n].gather() - w)) <= 1e-5 * torch.max(torch.abs(w)), (flag, n)


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2])
