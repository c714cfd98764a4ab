"""The port's pipeline parallelism (``repro_torch.parallel.pipeline``) and the
autograd transposes of its collectives, against the JAX package.

The reference needs 8 devices, so it runs once in a subprocess (this file
run as a script) with the forced device count set there, on meshes whose
axes are ``AxisType.Auto`` (JAX 0.9's ``jax.make_mesh`` defaults to
Explicit axes, under which the reference's ``gpipe_backward`` check in
``tests/multidevice_checks.py`` no longer runs). It reads the seeded numpy
inputs and writes its results to one ``.npz``:

* ``gpipe_forward`` on a ``(4, 2)`` ``("pipe", "dp")`` mesh, 4 stages of 2
  ``tanh(x @ W)`` layers, D 16, 4 microbatches of 2 (the shapes of
  ``tests/multidevice_checks.py:160-205``): the loss and its gradient;
* ``gpipe_forward_host`` at depth 3 on ``(4,)`` (those shapes) and ``(1,)``
  (the shapes of ``tests/test_enqueue_window.py:546-568``): the outputs
  and the window's counters;
* the gradient of ``Σ <collective(x), c>`` for ``ppermute``,
  ``all_gather``, ``all_reduce`` and ``reduce_scatter`` on ``(2, 4)``;
* ``pipeline_loss_fn`` with a MoE ``stage_fn`` (smoke granite cut to 4
  layers, fp32, train capacity) on ``(4, 2)``, 4 microbatches: the weights
  it drew, the loss and every gradient.

Tolerances: fp32 results to 1e-5 of their scale (the two packages sum in
different orders; the reference's own checks allow 1e-4); the window's
counters exactly; a replay byte-equal to the eager run.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

P_STAGES, L, D, MB, NM = 4, 8, 16, 2, 4
H_L, H_D, H_MB, H_NM = 4, 8, 2, 5  # the (1,) mesh's case
W = 16
PERM = [(0, 2), (1, 0), (2, 1)]
OPS = ("ppermute", "all_gather", "all_reduce", "reduce_scatter")
OUT_W = {"ppermute": W, "all_gather": 8 * W, "all_reduce": W, "reduce_scatter": W // 8}
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    out = {
        "Ws": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
        "xs": rng.standard_normal((NM, MB, D)).astype(np.float32),
        "Ws1": (rng.standard_normal((1, H_L, H_D, H_D)) * 0.3).astype(np.float32),
        "xs1": rng.standard_normal((H_NM, H_MB, H_D)).astype(np.float32),
        "x": rng.standard_normal((8, W)).astype(np.float32),
        "moe_tokens": rng.integers(0, 256, (8, 16)).astype(np.int32),
    }
    for op in OPS:
        out[f"c_{op}"] = rng.standard_normal((8, OUT_W[op])).astype(np.float32)
    return out


STAT_KEYS = ("depth", "admitted", "reaped", "max_depth_seen", "in_flight", "completed_unreaped")


def _oracle_main(in_path: str, out_path: str) -> None:
    """Subprocess entry: the reference over 8 forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as JP

    from repro.core import collectives as col, streams as ss
    from repro.core.progress import ProgressEngine
    from repro.core.threadcomm import shard_map
    from repro.parallel.pipeline import gpipe_forward, gpipe_forward_host, split_stages

    def auto_mesh(shape, names):
        return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

    inp = dict(np.load(in_path))
    out = {}
    Ws, xs = jnp.asarray(inp["Ws"]), jnp.asarray(inp["xs"])

    def stage_fn(sp, x):
        y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, sp)
        return y

    pmesh = auto_mesh((4, 2), ("pipe", "dp"))

    def loss_pipe(Wst, xs):
        def inner(sp, xm):
            sp = jax.tree.map(lambda a: a[0], sp)
            outs = gpipe_forward(stage_fn, sp, xm, "pipe")
            rank = jax.lax.axis_index("pipe")
            l = jnp.where(rank == P_STAGES - 1, jnp.sum(outs ** 2), 0.0)
            return jax.lax.psum(l, "pipe")

        return shard_map(inner, mesh=pmesh, in_specs=(JP("pipe"), JP()), out_specs=JP(),
                         check_vma=False)(split_stages(Wst, P_STAGES), xs)

    with pmesh:
        out["gpipe_loss"] = np.asarray(loss_pipe(Ws, xs))
        out["gpipe_grad"] = np.asarray(jax.grad(lambda w: loss_pipe(w, xs))(Ws))

    for name, shape, ws, x in (("host4", (4,), split_stages(Ws, P_STAGES), xs),
                               ("host1", (1,), jnp.asarray(inp["Ws1"]), jnp.asarray(inp["xs1"]))):
        mesh = auto_mesh(shape, ("pipe",))
        off = ss.stream_create(info={"type": "tpu_stream"}, name=f"pipe-{name}")
        comm = ss.stream_comm_create(mesh, ("pipe",), off)
        outs, win = gpipe_forward_host(stage_fn, ws, x, comm, depth=3, engine=ProgressEngine())
        out[f"{name}_outs"] = np.asarray(outs)
        st = win.stats(engine=False)
        out[f"{name}_stats"] = np.array([st[k] for k in STAT_KEYS])
        ss.stream_free(off)

    mesh = auto_mesh((2, 4), ("pod", "data"))
    data = ss.stream_comm_create(mesh, ("data",))
    pd = ss.stream_comm_create(mesh, ("pod", "data"))
    ops = {"ppermute": lambda x: col.ppermute(x, data, PERM)[0],
           "all_gather": lambda x: col.all_gather(x, pd, axis=1)[0],
           "all_reduce": lambda x: col.all_reduce(x, data)[0],
           "reduce_scatter": lambda x: col.reduce_scatter(x, pd, axis=1)[0]}
    for op, f in ops.items():
        def loss(x, c, f=f):
            per_rank = shard_map(lambda xs, cs: jnp.sum(f(xs) * cs)[None], mesh=mesh,
                                 in_specs=(JP(("pod", "data")), JP(("pod", "data"))),
                                 out_specs=JP(("pod", "data")), check_vma=False)
            return jnp.sum(per_rank(x, c))

        with mesh:
            out[f"grad_{op}"] = np.asarray(jax.grad(loss)(jnp.asarray(inp["x"]), jnp.asarray(inp[f"c_{op}"])))
    out.update(_oracle_moe_pipeline(pmesh, inp["moe_tokens"]))
    np.savez(out_path, **out)


def _moe_cfg(get_config):
    return get_config("granite-moe-1b-a400m", smoke=True).replace(n_layers=4, param_dtype="float32",
                                                                   compute_dtype="float32")


def _oracle_moe_pipeline(pmesh, tokens) -> dict:
    """The reference's pipeline_loss_fn over granite's MoE layers: the
    weights, the loss and its gradient, flat under '/'-joined paths."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import api, common as jc, transformer as jtf
    from repro.parallel.pipeline import pipeline_loss_fn, split_stages

    cfg = _moe_cfg(get_config)
    spec = jtf.layer_groups(cfg)[0][0][0]
    params = jax.jit(lambda: api.init_params(cfg, jax.random.key(0)))()
    positions = jnp.broadcast_to(jnp.arange(tokens.shape[1]), (tokens.shape[0] // P_STAGES, tokens.shape[1]))

    def stage_fn(sp, x):
        y, _ = jax.lax.scan(lambda c, lp: (jtf._apply_layer_full(cfg, spec, lp, c, positions, train=True)[0], None),
                            x, sp)
        return y

    def head_loss(head, x, toks):
        return jc.next_token_xent(jc.logits_out(cfg, head["embed"], jc.apply_norm(cfg, head["norm"], x)), toks)

    loss_fn = pipeline_loss_fn(cfg, pmesh, "pipe", P_STAGES, lambda p, t: jc.embed(cfg, p, t), stage_fn, head_loss)

    def loss(p):
        return loss_fn({"embed": p["embed"], "stages": split_stages(p["groups"][0][0], P_STAGES),
                        "head": {"embed": p["embed"], "norm": p["final_norm"]}}, {"tokens": jnp.asarray(tokens)})

    with pmesh:
        l, g = jax.value_and_grad(loss)(params)

    def flat(prefix, tree):
        return {f"{prefix}/{jax.tree_util.keystr(p, simple=True, separator='/')}": np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}

    return {"moe_loss": np.asarray(l), **flat("moe_param", params), **flat("moe_grad", g)}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    d = tmp_path_factory.mktemp("p11b_pipe")
    inputs = _inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(d / "in.npz"), str(d / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"reference subprocess failed:\n{proc.stderr[-4000:]}"
    return inputs, dict(np.load(d / "out.npz"))


# ----------------------------------------------------------------------
# the port's side
# ----------------------------------------------------------------------


def _stage_fn(sp, x):
    for w in sp:
        x = torch.tanh(x @ w)
    return x


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1.0), np.max(np.abs(got - want))


def _port_gpipe_loss(Ws, xs):
    from repro_torch.core.collectives import all_reduce
    from repro_torch.core.mesh import P, axis_index, make_mesh, shard_map
    from repro_torch.core.streams import StreamComm
    from repro_torch.parallel.pipeline import gpipe_forward, split_stages

    mesh = make_mesh((4, 2), ("pipe", "dp"), device="cpu")

    def inner(sp, xm):
        rank = axis_index("pipe")
        outs = gpipe_forward(_stage_fn, sp[rank], xm, "pipe")
        l = torch.sum(outs ** 2) if rank == P_STAGES - 1 else torch.zeros(())
        return all_reduce(l, StreamComm(("pipe",), mesh=mesh))[0]

    return shard_map(inner, mesh, (P(), P()), P())(split_stages(Ws, P_STAGES), xs)


def test_gpipe_forward_and_backward_match_reference(oracle):
    """The reference's gpipe_forward / gpipe_backward checks: loss and the
    gradient of every layer's weight through the reverse permutes."""
    inputs, ref = oracle
    Ws = torch.from_numpy(inputs["Ws"]).requires_grad_(True)
    loss = _port_gpipe_loss(Ws, torch.from_numpy(inputs["xs"]))
    (grad,) = torch.autograd.grad(loss, Ws)
    _close(loss, ref["gpipe_loss"])
    _close(grad, ref["gpipe_grad"])
    # and the sequential stack the reference check holds both against
    y = torch.from_numpy(inputs["xs"]).reshape(NM * MB, D)
    for w in torch.from_numpy(inputs["Ws"]):
        y = torch.tanh(y @ w)
    assert abs(loss.item() - torch.sum(y ** 2).item()) <= 1e-4 * torch.sum(y ** 2).item()


def _host_case(name, inputs):
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.core.streams import stream_comm_create, stream_create, stream_free
    from repro_torch.parallel.pipeline import split_stages

    if name == "host4":
        shape, ws, xs = (4,), split_stages(torch.from_numpy(inputs["Ws"]), P_STAGES), torch.from_numpy(inputs["xs"])
    else:
        shape, ws, xs = (1,), torch.from_numpy(inputs["Ws1"]), torch.from_numpy(inputs["xs1"])
    mesh = make_mesh(shape, ("pipe",), device="cpu")
    off = stream_create(info={"type": "cudaStream_t"}, name=f"pipe-{name}")
    return stream_comm_create(mesh, ("pipe",), off), ws, xs, ProgressEngine(), lambda: stream_free(off)


@pytest.mark.parametrize("name", ["host4", "host1"])
def test_gpipe_forward_host_matches_reference(oracle, name):
    from repro_torch.parallel.pipeline import gpipe_forward_host

    inputs, ref = oracle
    comm, ws, xs, eng, free = _host_case(name, inputs)
    try:
        outs, win = gpipe_forward_host(_stage_fn, ws, xs, comm, depth=3, engine=eng)
    finally:
        free()
    _close(outs, ref[f"{name}_outs"])
    st = win.stats(engine=False)
    assert [st[k] for k in STAT_KEYS] == ref[f"{name}_stats"].tolist(), st


def test_gpipe_host_replay_is_byte_equal_and_drift_raises(oracle):
    from repro_torch.core.schedule import Schedule, ScheduleStale
    from repro_torch.parallel.pipeline import gpipe_forward_host

    inputs, ref = oracle
    comm, ws, xs, eng, free = _host_case("host4", inputs)
    try:
        eager, _ = gpipe_forward_host(_stage_fn, ws, xs, comm, depth=3, engine=eng)
        sched = Schedule(engine=eng, name="pipe")
        recorded, win = gpipe_forward_host(_stage_fn, ws, xs, comm, depth=3, engine=eng, schedule=sched)
        assert sched.sealed and len(sched.ops()) == 1 + (NM + P_STAGES - 1) + 1
        replayed, win2 = gpipe_forward_host(_stage_fn, ws, xs, comm, schedule=sched)
        assert win2 is win
        for a in (recorded, replayed):
            assert torch.equal(a.view(torch.int32), eager.view(torch.int32))
        st = win.stats(engine=False)
        assert st["admitted"] == st["reaped"] == 2 * (NM + P_STAGES - 1) and st["max_depth_seen"] <= 3
        with pytest.raises(ValueError, match="depth"):
            gpipe_forward_host(_stage_fn, ws, xs, comm, depth=2, schedule=sched)
        with pytest.raises(ScheduleStale, match="x_shape"):
            gpipe_forward_host(_stage_fn, ws, xs[:, :1], comm, schedule=sched)
        assert sched.state == "INVALID"  # the raise invalidated it: the next call re-records
        again, _ = gpipe_forward_host(_stage_fn, ws, xs, comm, schedule=sched)
        assert sched.sealed and torch.equal(again.view(torch.int32), eager.view(torch.int32))
    finally:
        free()


def test_gpipe_host_rejects_window_plus_depth():
    from repro_torch.core.enqueue import OffloadWindow
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.core.streams import stream_comm_create, stream_create, stream_free
    from repro_torch.parallel.pipeline import gpipe_forward_host

    off = stream_create(info={"type": "cudaStream_t"}, name="pipe-reject")
    try:
        comm = stream_comm_create(make_mesh((1,), ("pipe",), device="cpu"), ("pipe",), off)
        win = OffloadWindow(off, depth=2, engine=ProgressEngine())
        with pytest.raises(ValueError, match="window"):
            gpipe_forward_host(lambda sp, x: x, torch.zeros(1, 1), torch.zeros(2, 1), comm, depth=4, window=win)
    finally:
        stream_free(off)


@pytest.mark.parametrize("op", OPS)
def test_collective_transposes_match_reference(oracle, op):
    """One graph across the thread-ranks: the caller's autograd.grad after
    the region gives the reference's transpose of each collective."""
    from repro_torch.core import collectives as col
    from repro_torch.core.mesh import P, make_mesh, shard_map
    from repro_torch.core.streams import stream_comm_create

    inputs, ref = oracle
    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    data, pd = stream_comm_create(mesh, ("data",)), stream_comm_create(mesh, ("pod", "data"))
    f = {"ppermute": lambda x: col.ppermute(x, data, PERM)[0],
         "all_gather": lambda x: col.all_gather(x, pd, axis=1)[0],
         "all_reduce": lambda x: col.all_reduce(x, data)[0],
         "reduce_scatter": lambda x: col.reduce_scatter(x, pd, axis=1)[0]}[op]
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    per_rank = shard_map(lambda xs, cs: torch.sum(f(xs) * cs)[None], mesh, P(("pod", "data")), P(("pod", "data")))
    (grad,) = torch.autograd.grad(per_rank(x, torch.from_numpy(inputs[f"c_{op}"])).sum(), x)
    _close(grad, ref[f"grad_{op}"])


def test_backward_inside_a_region_raises():
    """A rank thread must not run a backward through a collective itself."""
    from repro_torch.core import collectives as col
    from repro_torch.core.mesh import P, make_mesh, shard_map
    from repro_torch.core.streams import stream_comm_create

    mesh = make_mesh((2,), ("data",), device="cpu")
    comm = stream_comm_create(mesh, ("data",))

    def body(x):
        y, _ = col.all_reduce(x * 2, comm)
        y.sum().backward()
        return y

    with pytest.raises(RuntimeError, match="from the caller"):
        shard_map(body, mesh, P("data"), P("data"))(torch.ones(2, 3, requires_grad=True))


def test_pipeline_loss_fn_matches_lm_loss():
    """pipeline_loss_fn over the port's per-layer modules (smoke qwen, fp32,
    4 stages on a (4, 2) ("pipe", "dp") mesh, 4 microbatches) against the
    single-rank lm_loss on the same batch: the loss and every gradient to
    1e-4 of the largest, the reference check's tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.models.common import apply_norm, embed, logits_out, next_token_xent
    from repro_torch.models.transformer import lm_loss
    from repro_torch.parallel.pipeline import pipeline_loss_fn, split_stages

    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(n_layers=4, param_dtype="float32",
                                                          compute_dtype="float32")
    model = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu").requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (8, 16)))
    positions = torch.arange(16).expand(2, 16)

    def stage_fn(layers, x):
        for layer in layers:
            x, _ = layer.forward_full(cfg, x, positions[: x.shape[0]])
        return x

    def head_loss(head, x, toks):
        return next_token_xent(logits_out(cfg, head["embed"], apply_norm(cfg, head["norm"], x)), toks)

    mesh = make_mesh((4, 2), ("pipe", "dp"), device="cpu")
    loss_fn = pipeline_loss_fn(cfg, mesh, "pipe", 4, lambda p, t: embed(cfg, p, t), stage_fn, head_loss)
    params = {"embed": model.embed, "stages": split_stages(model.groups[0], 4),
              "head": {"embed": model.embed, "norm": model.final_norm}}
    ps = list(model.parameters())
    lp = loss_fn(params, {"tokens": tokens})
    gp = torch.autograd.grad(lp, ps)
    ls, _ = lm_loss(cfg, model, {"tokens": tokens})
    gs = torch.autograd.grad(ls, ps)
    assert abs(lp.item() - ls.item()) <= 1e-4 * abs(ls.item())
    for a, b in zip(gp, gs):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-12


def test_pipeline_loss_fn_with_moe_stages_matches_reference(oracle):
    """pipeline_loss_fn with a MoE stage_fn (granite's layers at train
    capacity, fp32) against the reference's pipeline_loss_fn with the same
    stage_fn on the same weights: the loss and every gradient to 1e-4 of
    its leaf's largest. Only x passes between stages in both, so both drop
    the router aux, and each microbatch routes over its own rows."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models.common import apply_norm, embed, logits_out, next_token_xent
    from repro_torch.models.convert import leaf_map, params_from_numpy
    from repro_torch.parallel.pipeline import pipeline_loss_fn, split_stages

    inputs, ref = oracle
    cfg = _moe_cfg(get_config)
    tree = {k[len("moe_param/"):]: v for k, v in ref.items() if k.startswith("moe_param/")}
    model = params_from_numpy(cfg, tree, device="cpu").requires_grad_(True)
    tokens = torch.from_numpy(inputs["moe_tokens"]).long()
    positions = torch.arange(tokens.shape[1]).expand(tokens.shape[0] // P_STAGES, tokens.shape[1])

    def stage_fn(layers, x):
        for layer in layers:
            x = layer.apply_full(cfg, x, positions, True)[0]
        return x

    def head_loss(head, x, toks):
        return next_token_xent(logits_out(cfg, head["embed"], apply_norm(cfg, head["norm"], x)), toks)

    mesh = make_mesh((4, 2), ("pipe", "dp"), device="cpu")
    loss_fn = pipeline_loss_fn(cfg, mesh, "pipe", P_STAGES, lambda p, t: embed(cfg, p, t), stage_fn, head_loss)
    params = {"embed": model.embed, "stages": split_stages(model.groups[0], P_STAGES),
              "head": {"embed": model.embed, "norm": model.final_norm}}
    names = dict(model.named_parameters())
    loss = loss_fn(params, {"tokens": tokens})
    grads = dict(zip(names, torch.autograd.grad(loss, list(names.values()))))
    assert abs(loss.item() - float(ref["moe_loss"])) <= 1e-5 * abs(float(ref["moe_loss"]))
    for name, (stacked, port) in leaf_map(cfg, model).items():
        got = np.stack([grads[n].numpy() for n in port]) if stacked else grads[port[0]].numpy()
        _close(got, ref[f"moe_grad/{name}"], tol=1e-4)


def test_split_stages_of_modules_and_tensors():
    from repro_torch.parallel.pipeline import split_stages

    layers = [torch.nn.Linear(2, 2) for _ in range(6)]
    stages = split_stages(layers, 3)
    assert [len(s) for s in stages] == [2, 2, 2] and stages[1][0] is layers[2]
    t = split_stages({"w": torch.zeros(6, 4, 4)}, 2)
    assert t["w"].shape == (2, 3, 4, 4)
    with pytest.raises(ValueError, match="not divisible"):
        split_stages(layers, 4)


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2])
