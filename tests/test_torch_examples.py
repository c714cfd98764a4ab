"""The port's examples (``examples/port/``) against the JAX package's
(``examples/``): the same flags, the same printed lines where both compute
the same thing, and the same results on the same inputs.

* quickstart: both run in fresh processes; the ``[grequest]`` and
  ``[datatype]`` lines are equal line for line and both end in ``OK``.
* streams_overlap: the reference in its own process (it forces 8 host
  devices before importing JAX), the port with ``--device cpu``; the
  ``[buckets]`` and ``[hier]`` lines are equal, and the port's parts (a)-(c)
  are byte-equal to numpy's sum over the ranks of the same gradients, (d)
  equal in total to rtol 1e-5, as the reference asserts.
* serve_lm: the reference's smoke qwen1.5-0.5b weights, carried over with
  ``params_from_numpy``, served by the port example's loop with the default
  flags; every request's tokens equal the reference ``ServeEngine``'s.
* train_lm: both presets field for field, the same ``M params`` line, and a
  tiny run resumed from its checkpoint at the next step.
* pipeline_train: the reference example's init and first three losses from
  one 8-device subprocess (on ``AxisType.Auto`` axes: under JAX 0.9's
  default Explicit axes the reference example itself raises); the port's
  first three losses from those weights within rel. 1e-4 in fp32, and the
  port's own 30 iterations ending below 2.0.

Every subprocess is started when the module's fixture is first used and
runs beside the in-process cases; each is bounded by ``TIMEOUT_S``.
"""

import dataclasses
import importlib.util
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
PORT_EXAMPLES = EXAMPLES / "port"
TIMEOUT_S = 120
PIPE_ITERS = 3
PIPE_RTOL = 1e-4


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _start(args, **env) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *map(str, args)], env=_env(**env), cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc: subprocess.Popen) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, f"{proc.args} exited {proc.returncode}:\n{err[-4000:]}"
    return out


def _lines(out: str, *prefixes: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Every subprocess of the file, started at once."""
    d = tmp_path_factory.mktemp("examples")
    started = {
        "quickstart_ref": _start([EXAMPLES / "quickstart.py"]),
        "quickstart_port": _start([PORT_EXAMPLES / "quickstart.py", "--device", "cpu"]),
        "streams_ref": _start([EXAMPLES / "streams_overlap.py"]),
        "streams_port": _start([PORT_EXAMPLES / "streams_overlap.py", "--device", "cpu"]),
        "pipeline_ref": _start([Path(__file__), d / "pipeline_ref.npz"],
                               XLA_FLAGS="--xla_force_host_platform_device_count=8"),
    }
    yield started, d
    for p in started.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


# ----------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------


def test_quickstart_lines_match_reference(procs):
    started, _ = procs
    ref, port = _finish(started["quickstart_ref"]), _finish(started["quickstart_port"])
    want = _lines(ref, "[grequest]", "[datatype]")
    assert len(want) == 7, ref
    assert _lines(port, "[grequest]", "[datatype]") == want
    assert ref.splitlines()[-1] == port.splitlines()[-1] == "OK"
    assert _lines(port, "[streams]") == _lines(ref, "[streams]")  # the CPU has no CUDA stream to name


# ----------------------------------------------------------------------
# streams_overlap
# ----------------------------------------------------------------------


def test_streams_overlap_lines_match_reference(procs):
    started, _ = procs
    ref, port = _finish(started["streams_ref"]), _finish(started["streams_port"])
    want = _lines(ref, "[buckets]", "[hier]", "[mesh]")
    assert len(want) == 4, ref
    assert _lines(port, "[buckets]", "[hier]", "[mesh]") == want
    assert ref.splitlines()[-1] == port.splitlines()[-1] == "OK"
    assert "ran on 0 distinct CUDA streams" in port  # no card here


def _rank_sum(grads: np.ndarray) -> np.ndarray:
    """The ranks' rows summed in rank order, as each all-reduce folds them."""
    out = grads[0].copy()
    for row in grads[1:]:
        out = out + row
    return out


def test_streams_overlap_parts_equal_the_rank_sum():
    from repro_torch.core import make_mesh, stream_comm_create, stream_create, stream_free, threadcomm_init

    ex = _load(PORT_EXAMPLES / "streams_overlap.py", "port_streams_overlap")
    grads_np = np.arange(8 * 4096, dtype=np.float32).reshape(8, 4096) / np.float32(1e4)
    grads = ex.make_grads("cpu")
    assert grads.numpy().tobytes() == grads_np.tobytes()
    want = _rank_sum(grads_np)
    assert want.tobytes() == grads_np.sum(axis=0).tobytes()

    mesh = make_mesh((2, 4), ("pod", "data"), device="cpu")
    tc = threadcomm_init(mesh, ("pod", "data"))
    streams = [stream_create(name=f"test-vci{i}") for i in range(4)]
    try:
        comms = [stream_comm_create(mesh, ("pod", "data"), s) for s in streams]
        seen = set()
        parts = {"serialized": ex.serialized(tc, mesh, grads),
                 "streamed": ex.streamed(tc, comms, grads, seen),
                 "bucketed": ex.bucketed(tc, ex.bucket_plan(), comms, grads)}
        hier = ex.hierarchical(tc, grads)
    finally:
        for s in streams:
            stream_free(s)
    assert seen == {None}  # the CPU has no CUDA streams
    for name, y in parts.items():
        assert y.dtype == torch.float32 and y.numpy().tobytes() == want.tobytes(), name
    assert hier.shape == (1, 4096)
    np.testing.assert_allclose(hier.numpy().sum(), want.sum(), rtol=1e-5)


# ----------------------------------------------------------------------
# serve_lm
# ----------------------------------------------------------------------


def test_serve_lm_tokens_match_reference_on_its_weights(capsys):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_get_config
    from repro.models import api as japi
    from repro.serving.engine import ServeEngine as JServeEngine
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_numpy

    ex = _load(PORT_EXAMPLES / "serve_lm.py", "port_serve_lm")
    args = ex.parse_args(["--device", "cpu"])
    assert (args.arch, args.requests, args.max_new, args.max_batch) == ("qwen1.5-0.5b", 6, 12, 3)

    # the reference example's weights and loop (examples/serve_lm.py:25-38)
    jcfg = j_get_config(args.arch, smoke=True)
    jparams = japi.init_params(jcfg, jax.random.key(0))
    engine = JServeEngine(jcfg, jparams, max_batch=args.max_batch, max_len=128)
    rng = np.random.default_rng(0)
    jreqs = [engine.submit(rng.integers(0, jcfg.vocab, (4 + i % 5,)), max_new_tokens=args.max_new)
             for i in range(args.requests)]
    for _ in range(400):
        if all(r.done for r in jreqs):
            break
        engine.step()
    assert all(r.done for r in jreqs)

    model = params_from_numpy(get_config(args.arch, smoke=True), jax.tree.map(np.asarray, jparams), device="cpu")
    reqs = ex.serve(get_config(args.arch, smoke=True), model, args)
    out = capsys.readouterr().out
    assert [list(r.prompt) for r in reqs] == [list(r.prompt) for r in jreqs]
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert _lines(out, "[serve] req") == [f"[serve] req{r.rid}: prompt={list(r.prompt[:4])}… out={r.out_tokens}"
                                          for r in jreqs[:3]]


# ----------------------------------------------------------------------
# train_lm
# ----------------------------------------------------------------------


class _Stop(Exception):
    pass


def _params_line(mod, argv, monkeypatch, capsys) -> str:
    """The line ``mod.main`` prints before it builds its Trainer."""

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(mod, "Trainer", stop)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    with pytest.raises(_Stop):
        mod.main()
    return capsys.readouterr().out.strip()


@pytest.mark.parametrize("preset", ["100m", "tiny"])
def test_train_lm_configs_and_params_line_match_reference(preset, monkeypatch, capsys):
    pytest.importorskip("jax")
    ref = _load(EXAMPLES / "train_lm.py", "ref_train_lm")
    port = _load(PORT_EXAMPLES / "train_lm.py", "port_train_lm")
    make = f"model_{preset}"
    assert dataclasses.asdict(getattr(port, make)()) == dataclasses.asdict(getattr(ref, make)())
    want = _params_line(ref, ["--preset", preset], monkeypatch, capsys)
    got = _params_line(port, ["--preset", preset, "--device", "cpu"], monkeypatch, capsys)
    assert got == want and re.fullmatch(r"\[train_lm\] lm-\w+: [\d.]+M params, 200 steps", want)
    if preset == "100m":  # 12 layers of 6.88M and the tied 12.58M embedding
        assert want == "[train_lm] lm-100m: 95.2M params, 200 steps"


def test_train_lm_resumes_at_the_next_step(tmp_path, capsys):
    ex = _load(PORT_EXAMPLES / "train_lm.py", "port_train_lm")
    argv = ["--preset", "tiny", "--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = ex.main(argv)
    out1 = capsys.readouterr().out
    second = ex.main(argv)
    out2 = capsys.readouterr().out
    assert len(first) == len(second) == 3 and all(math.isfinite(x) for x in first + second)
    assert "restored" not in out1 and "[train_lm] steps 0..2:" in out1
    assert "[trainer] restored step 2" in out2 and "[train_lm] steps 3..5:" in out2
    assert out2.splitlines()[-1] == f"[train_lm] loss {second[0]:.4f} -> {second[-1]:.4f} over 3 steps"
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_")) == \
        ["step_00000002", "step_00000005"]


# ----------------------------------------------------------------------
# pipeline_train
# ----------------------------------------------------------------------


def _pipeline_oracle(out_path: str) -> None:
    """Subprocess entry: the reference example's init and its first
    PIPE_ITERS losses, its loss and step (examples/pipeline_train.py:44-77)
    on a mesh of Auto axes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as JP

    from repro.core.threadcomm import shard_map
    from repro.parallel.pipeline import gpipe_forward

    ref = _load(EXAMPLES / "pipeline_train.py", "ref_pipeline_train")
    mesh = jax.make_mesh((ref.N_STAGES, 2), ("pipe", "dp"), axis_types=(AxisType.Auto,) * 2)
    params = ref.init(jax.random.key(0))
    init = {k: np.asarray(v) for k, v in params.items()}

    def loss_fn(params, tokens):
        def inner(sp, toks):
            sp = jax.tree.map(lambda a: a[0], sp)
            x = params["embed"][toks]
            B = x.shape[0]
            xm = x.reshape(ref.N_MICRO, B // ref.N_MICRO, *x.shape[1:])
            outs = gpipe_forward(ref.stage_fn, sp, xm, "pipe")
            outs = outs.reshape(B, -1, ref.D)
            logits = outs @ params["head"]
            tgt = toks[:, 1:]
            lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
            ll = jnp.take_along_axis(lp, tgt[..., None], -1)[..., 0]
            rank = jax.lax.axis_index("pipe")
            l = jnp.where(rank == ref.N_STAGES - 1, -ll.mean(), 0.0)
            return jax.lax.psum(l, "pipe")

        return shard_map(inner, mesh=mesh, in_specs=(JP("pipe"), JP()), out_specs=JP(), check_vma=False)(
            params["stages"], tokens)

    @jax.jit
    def step(params, tokens, lr=0.5):
        l, g = jax.value_and_grad(loss_fn)(params, tokens)
        return jax.tree.map(lambda p, gi: p - lr * gi, params, g), l

    rng = np.random.default_rng(0)
    losses = []
    with mesh:
        for _ in range(PIPE_ITERS):
            start = rng.integers(0, 64, (ref.MB * ref.N_MICRO, 1))
            toks = jnp.asarray((start + np.arange(32)[None, :]) % 64, jnp.int32)
            params, l = step(params, toks)
            losses.append(float(l))
    np.savez(out_path, losses=np.asarray(losses), **init)


def test_pipeline_train_first_losses_match_reference(procs):
    from repro_torch.core.mesh import make_mesh

    started, d = procs
    _finish(started["pipeline_ref"])
    ref = dict(np.load(d / "pipeline_ref.npz"))
    ex = _load(PORT_EXAMPLES / "pipeline_train.py", "port_pipeline_train")
    own = ex.init(torch.Generator().manual_seed(0), "cpu")
    params = {k: torch.from_numpy(ref[k]) for k in ("embed", "stages", "head")}
    assert {k: tuple(v.shape) for k, v in params.items()} == {k: tuple(v.shape) for k, v in own.items()}
    assert all(v.dtype == torch.float32 for v in params.values())

    mesh = make_mesh((ex.N_STAGES, 2), ("pipe", "dp"), device="cpu")
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(PIPE_ITERS):
        params, l = ex.step(params, ex.batch(rng, "cpu"), mesh)
        losses.append(float(l))
    np.testing.assert_allclose(losses, ref["losses"], rtol=PIPE_RTOL)
    assert losses[0] > losses[-1]


def test_pipeline_train_own_init_ends_below_two(capsys):
    ex = _load(PORT_EXAMPLES / "pipeline_train.py", "port_pipeline_train")
    losses = ex.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(losses) == ex.ITERS and losses[-1] < 2.0
    assert _lines(out, "[pipeline] iter") == [f"[pipeline] iter {i}: loss {losses[i]:.4f}" for i in range(0, 30, 5)]
    assert out.splitlines()[-1] == "OK"


if __name__ == "__main__":
    _pipeline_oracle(sys.argv[1])
