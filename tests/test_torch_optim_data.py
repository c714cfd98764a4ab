"""The port's optimizer, gradient buckets, int8 compression, data pipeline
and mesh gradient sync against the JAX package's, on the same seeded numpy
inputs.

Tolerances, with their reasons:

* AdamW on shared grads, 3 steps: params, master and moments within
  2e-6 of their largest magnitude. Both packages run the same fp32
  arithmetic per element, but the schedule's cosine, the bias-correction
  powers and XLA's fused elementwise code may round a last bit
  differently; bf16 results (params, bf16 moments) may then land one bf16
  step apart, so they are held to one bf16 step (2**-8 relative) instead.
  ``lr_schedule`` and ``global_norm`` within 1e-6 relative.
* ``build_buckets``, ``flatten``/``unflatten``, ``quantize_int8`` and the
  batches: exact (plans are integers, the rest moves bytes or rounds one
  fp32 division the same way).
* The gradient sync on the ``(2, 4)`` mesh: integer-valued fp32 sums
  exact; random fp32 sums, which the packages fold in different orders,
  within 1e-6 of the largest magnitude. The reference needs 8 devices, so
  it runs in a subprocess (this file run as a script) and writes an
  ``.npz``; the port's mesh positions are thread-ranks on the CPU.

Every wait is bounded at 10 s.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticPipeline as JPipeline  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import grad_overlap as jgo  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.progress import ProgressEngine  # noqa: E402
from repro_torch.data.pipeline import DataConfig as TDataConfig, SyntheticPipeline as TPipeline  # noqa: E402
from repro_torch.models.convert import tensor_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import grad_overlap as tgo  # noqa: E402

WAIT_S = 10.0
SHAPES = {"a": (8, 16), "b": (33,), "c": (4, 4, 4), "d": (2, 64, 32)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _close(got, want, bf16: bool, what: str) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    scale = max(float(np.abs(w).max()), 1e-30)
    tol = 2.0 ** -8 if bf16 else 2e-6
    assert np.abs(g - w).max() <= tol * scale, (what, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("variant", ["master_fp32", "bf16_moments_no_master"])
def test_adamw_three_steps_on_shared_grads(variant):
    over = dict(moments_dtype="bfloat16", master=False) if variant == "bf16_moments_no_master" else {}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, **over)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = {k: np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)) for k, s in sorted(SHAPES.items())}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: tensor_from_numpy(v) for k, v in p0.items()}
    jst, tst = jadamw.adamw_init(jcfg, jp), tadamw.adamw_init(tcfg, tp)
    j_update = jax.jit(lambda g, st, p: jadamw.adamw_update(jcfg, g, st, p))
    for step in range(3):
        # grads of mixed scale: the clip engages on the first step only
        g = {k: (rng.standard_normal(s) * (3.0 if step == 0 else 0.05)).astype(np.float32)
             for k, s in sorted(SHAPES.items())}
        jp, jst, jm = j_update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        tp_out, tst_out, tm = tadamw.adamw_update(tcfg, {k: torch.from_numpy(v) for k, v in g.items()}, tst, tp)
        assert tp_out is tp and tst_out is tst  # updated in place
        assert int(tst["count"]) == int(jst["count"]) == step + 1 and tst["count"].dtype == torch.int32
        for name in ("grad_norm", "lr"):
            assert abs(float(tm[name]) - float(jm[name])) <= 1e-6 * abs(float(jm[name])), name
        for k in SHAPES:
            _close(tp[k], jp[k], True, f"params/{k}@{step}")
            assert tp[k].dtype == torch.bfloat16
            for part in ("m", "v"):
                _close(tst[part][k], jst[part][k], tcfg.moments_dtype == "bfloat16", f"{part}/{k}@{step}")
            if tcfg.master:
                _close(tst["master"][k], jst["master"][k], False, f"master/{k}@{step}")
    assert ("master" in tst) == tcfg.master


def test_lr_schedule_and_global_norm_match_reference():
    cfg_kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jc, tc = jadamw.AdamWConfig(**cfg_kw), tadamw.AdamWConfig(**cfg_kw)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        j = float(jadamw.lr_schedule(jc, jnp.int32(s)))
        t = float(tadamw.lr_schedule(tc, torch.tensor(s, dtype=torch.int32)))
        assert abs(t - j) <= 1e-6 * abs(j), s
    rng = np.random.default_rng(3)
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in sorted(SHAPES.items())}
    j = float(jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    t = float(tadamw.global_norm({k: torch.from_numpy(v) for k, v in g.items()}))
    assert abs(t - j) <= 1e-6 * j


# ------------------------------------------------- buckets, compression


BUCKET_CASES = [
    ([(64, 8), (300,), (33,)], 1024),
    ([(96,), (40,)], 128),
    ([(1024, 64), (64,), (64, 128), (128, 64)], 1 << 14),
    ([(5,), (7,), (11,), (13,)], 4),
    ([(151936 // 64, 64), (24, 64)], 1 << 16),
]


@pytest.mark.parametrize("case", range(len(BUCKET_CASES)))
def test_build_buckets_matches_reference(case):
    shapes, bucket_bytes = BUCKET_CASES[case]
    want = jgo.build_buckets([jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes], bucket_bytes=bucket_bytes)
    got = tgo.build_buckets([torch.empty(s) for s in shapes], bucket_bytes=bucket_bytes)
    assert got.leaf_sizes == want.leaf_sizes and got.bucket_slices == want.bucket_slices
    assert got.n_buckets == want.n_buckets and got.total_elems == want.total_elems
    # every bucket holds whole leaves within the budget, or one oversized leaf
    starts = np.cumsum((0,) + got.leaf_sizes)
    for start, n in got.bucket_slices:
        assert start in starts and start + n in starts
        assert n * 4 <= bucket_bytes or start + n in starts[: list(starts).index(start) + 2]


def test_flatten_unflatten_match_reference():
    rng = np.random.default_rng(2)
    g = {k: np.asarray(jnp.asarray(rng.standard_normal(s), jnp.bfloat16)) for k, s in sorted(SHAPES.items())}
    jflat = jgo.flatten_grads({k: jnp.asarray(v) for k, v in g.items()})
    tg = {k: tensor_from_numpy(v) for k, v in g.items()}
    tflat = tgo.flatten_grads(tg)
    assert tflat.dtype == torch.float32 and np.array_equal(tflat.numpy(), np.asarray(jflat))
    back = tgo.unflatten_grads(tflat, tg)
    assert list(back) == list(tg)
    for k in tg:
        assert back[k].dtype == torch.bfloat16 and torch.equal(back[k], tg[k])


@pytest.mark.parametrize("block", [256, 2048])
def test_quantize_int8_bit_equal(block):
    rng = np.random.default_rng(block)
    x = (rng.standard_normal(4 * block) * np.repeat(rng.uniform(1e-3, 10, 4), block)).astype(np.float32)
    x[:block] = 0.0  # an all-zero block: the 1e-12 scale floor
    jq, js = jcomp.quantize_int8(jnp.asarray(x), block)
    tq, ts = tcomp.quantize_int8(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tcomp.dequantize_int8(tq, ts, block).numpy(), np.asarray(jcomp.dequantize_int8(jq, js, block)))


# ------------------------------------------------------------- data


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b"])
def test_build_batch_byte_equal(arch):
    for smoke in (True, False):
        jp = JPipeline(j_get_config(arch, smoke=smoke), JDataConfig(batch=4, seq=32, seed=3))
        tp = TPipeline(t_get_config(arch, smoke=smoke), TDataConfig(batch=4, seq=32, seed=3))
        for step in range(6):
            want, got = jp.build_batch(step), tp.build_batch(step)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), (step, k)


@pytest.mark.parametrize("loaders", [0, 2])
def test_prefetch_modes_equal_a_direct_build(loaders):
    cfg = t_get_config("qwen1.5-0.5b", smoke=True)
    eng = ProgressEngine()
    p = TPipeline(cfg, TDataConfig(batch=2, seq=16, loader_threads=loaders), engine=eng)
    try:
        assert p.n_workers == loaders and (p.threadcomm is not None) == bool(loaders)
        reqs = [p.prefetch(s) for s in range(6)]
        assert eng.wait_all([r for r in reqs if r is not None], timeout=WAIT_S)
        for s in range(6):
            got, want = p.get_batch(s), p.build_batch(s)
            assert got["tokens"].tobytes() == want["tokens"].tobytes()
        if loaders:
            assert p.assignments == {1: 3, 2: 3}  # equal shares: the rotation
    finally:
        p.stop_workers()
        eng.stop_all()
    assert p.threadcomm is None and p.n_workers == 0


def test_loader_epoch_closes_on_error():
    """The loader epoch is one bracket: an exception inside it still stops
    the workers, detaches rank 0 and finishes the threadcomm."""
    cfg = t_get_config("qwen1.5-0.5b", smoke=True)
    eng = ProgressEngine()
    p = TPipeline(cfg, TDataConfig(batch=2, seq=16), engine=eng)
    workers = []
    with pytest.raises(KeyError):
        with p.loader_epoch(2):
            workers = list(p._workers)
            p.prefetch(0)
            assert p.get_batch(0)["tokens"].shape == (2, 16)
            raise KeyError("boom")
    assert p.threadcomm is None and all(not t.is_alive() for t in workers)
    eng.stop_all()


# ------------------------------------------------- gradient sync on a mesh

MESH_PARAMS = {"a": (96,), "b": (40,)}
GRAD_N = 136


def _mesh_inputs():
    rng = np.random.default_rng(5)
    return {
        "int": rng.integers(-4, 5, (8, GRAD_N)).astype(np.float32),
        "rand": rng.standard_normal((8, GRAD_N)).astype(np.float32),
        "comp": (np.tile(np.linspace(-1, 1, 4096)[None], (8, 1)) * 0.01
                 + rng.standard_normal((8, 4096)) * 1e-3).astype(np.float32),
    }


def _jax_ns():
    import repro.core as C
    from jax.sharding import PartitionSpec

    from repro.core.enqueue import OffloadWindow
    from repro.core.progress import ProgressEngine as PE
    from repro.core.schedule import Schedule

    return SimpleNamespace(C=C, go=jgo, comp=jcomp, P=PartitionSpec, PE=PE, Window=OffloadWindow, Schedule=Schedule,
                           mesh=lambda: jax.make_mesh((2, 4), ("pod", "data")), array=jnp.asarray,
                           spec=lambda s: jax.ShapeDtypeStruct(s, jnp.float32), numpy=np.asarray)


def _torch_ns():
    import repro_torch.core as C
    from repro_torch.core.enqueue import OffloadWindow
    from repro_torch.core.schedule import Schedule

    return SimpleNamespace(C=C, go=tgo, comp=tcomp, P=C.P, PE=ProgressEngine, Window=OffloadWindow, Schedule=Schedule,
                           mesh=lambda: C.make_mesh((2, 4), ("pod", "data"), device="cpu"),
                           array=torch.from_numpy, spec=lambda s: torch.empty(s), numpy=lambda t: t.numpy())


def run_mesh_sync(m, inputs) -> dict:
    """Both gradient syncs of one package on ``inputs``: name → numpy."""
    mesh, eng = m.mesh(), m.PE()
    plan = m.go.build_buckets([m.spec(s) for s in MESH_PARAMS.values()], bucket_bytes=128)
    streams = [m.C.stream_create(name=f"gs{i}") for i in range(3)]
    tc = m.C.threadcomm_init(mesh, ("pod", "data"))
    full = [m.C.stream_comm_create(mesh, ("pod", "data"), s) for s in streams[:2]]
    data = [m.C.stream_comm_create(mesh, ("data",), s) for s in streams[:2]]
    win = m.Window(streams[2], depth=2, engine=eng, name="gs-win")
    out = {}
    try:
        for kind in ("int", "rand"):
            x = m.array(inputs[kind])

            def in_region(g):
                y, _ = m.go.bucketed_all_reduce(g.reshape(-1), plan, full)
                return y

            out[f"{kind}/region"] = m.numpy(tc.run(in_region, x, in_specs=m.P(("pod", "data")), out_specs=m.P()))
            flat = m.array(inputs[kind][0])
            out[f"{kind}/host"] = m.numpy(m.go.bucketed_all_reduce_host(flat, plan, data, engine=eng))
            out[f"{kind}/host_scatter"] = m.numpy(
                m.go.bucketed_all_reduce_host(flat, plan, data, scatter=True, engine=eng))
            out[f"{kind}/host_windowed"] = m.numpy(
                m.go.bucketed_all_reduce_host(flat, plan, data, engine=eng, window=win))
            sched = m.Schedule(engine=eng, stream=data[0].stream, name=f"gs-{kind}")
            m.go.bucketed_all_reduce_host(flat, plan, data, engine=eng, schedule=sched)
            out[f"{kind}/host_replay"] = m.numpy(m.go.bucketed_all_reduce_host(flat, plan, data, engine=eng,
                                                                               schedule=sched))
        g = m.array(inputs["comp"])
        sc = m.C.stream_comm_create(mesh, ("pod", "data"), streams[0])

        def flat_comp(gs):
            return m.comp.compressed_all_reduce(gs.reshape(-1), sc, block=256)

        def hier_comp(gs):
            return m.comp.hierarchical_compressed_all_reduce(gs.reshape(-1), tc, block=256)

        for name, body in (("compressed", flat_comp), ("hier_compressed", hier_comp)):
            y, ef = tc.run(body, g, in_specs=m.P(("pod", "data")), out_specs=(m.P(), m.P(("pod", "data"))))
            out[f"comp/{name}"], out[f"comp/{name}_ef"] = m.numpy(y), m.numpy(ef)
    finally:
        eng.stop_all()
    return out


def _oracle_main(in_path: str, out_path: str) -> None:
    """Subprocess entry: the reference over 8 forced host devices."""
    np.savez(out_path, **run_mesh_sync(_jax_ns(), dict(np.load(in_path))))


@pytest.fixture(scope="module")
def mesh_sync(tmp_path_factory):
    d = tmp_path_factory.mktemp("gsync")
    inputs = _mesh_inputs()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    src = os.path.abspath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(d / "in.npz"), str(d / "out.npz")],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"reference subprocess failed:\n{proc.stderr[-4000:]}"
    return inputs, dict(np.load(d / "out.npz")), run_mesh_sync(_torch_ns(), inputs)


SYNC_CASES = [f"{k}/{c}" for k in ("int", "rand") for c in ("region", "host", "host_scatter", "host_windowed",
                                                           "host_replay")]
SYNC_CASES += [f"comp/{c}" for c in ("compressed", "compressed_ef", "hier_compressed", "hier_compressed_ef")]


@pytest.mark.parametrize("case", SYNC_CASES)
def test_gradient_sync_matches_reference(mesh_sync, case):
    inputs, ref, got = mesh_sync
    g, w = got[case], ref[case]
    assert g.shape == w.shape and g.dtype == w.dtype, (case, g.shape, w.shape)
    if case.startswith("int/"):
        assert np.array_equal(g, w), case
    else:
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), case
    if case.startswith("int/") and case.endswith(("host", "host_windowed", "host_replay")):
        assert np.array_equal(g, 4 * inputs["int"][0])  # replicated flat, summed over the 4 data ranks
    if case == "comp/hier_compressed":  # the reference's check: within int8 error of the exact sum
        exact = inputs["comp"].sum(0)
        assert np.abs(g - exact).max() / np.abs(exact).max() < 0.05


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2])
