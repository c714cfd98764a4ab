"""The port's checkpoint store and manager against the JAX package's.

The same state — the smoke model's params (bf16, per-layer leaves stacked
in the reference, one tensor per layer in the port) and AdamW's m, v,
master (fp32) and count (int32) — is saved by both packages: the ``.bin``
files are byte-identical and the parsed manifests equal, and each package
loads the other's checkpoint byte for byte. Then the reference's
``tests/test_checkpoint_ft.py`` cases on the port: the store round trip,
an incomplete checkpoint rejected, async saves with retention, a crash
mid-save falling back, and the ``execute_reshard`` error paths. Every
comparison here is exact: checkpoints move bytes. Every wait is bounded
at 10 s.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import iovec_store as jstore  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.checkpoint import iovec_store as tstore  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core.progress import ProgressEngine  # noqa: E402
from repro_torch.core.streams import StreamPool  # noqa: E402
from repro_torch.ft.elastic import execute_reshard, plan_remesh, reshard_plan  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    leaf_map,
    params_from_numpy,
    params_to_numpy,
    state_tree,
    tensor_from_numpy,
)

WAIT_S = 10.0
ARCHS = ("qwen1.5-0.5b", "rwkv6-7b")


def _state(arch: str):
    """One training state in both packages' forms: (JAX tree of numpy,
    port tree over the port's tensors)."""
    jcfg, tcfg = j_get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    jp = jax.tree.map(np.asarray, japi.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(1)
    rand = lambda a: rng.standard_normal(a.shape).astype(np.float32)  # noqa: E731
    jopt = {"m": jax.tree.map(rand, jp), "v": jax.tree.map(lambda a: np.abs(rand(a)), jp),
            "master": jax.tree.map(lambda a: a.astype(np.float32), jp), "count": np.asarray(7, np.int32)}
    jtree = {"params": jp, "opt": jopt}
    model = params_from_numpy(tcfg, jp, device="cpu")
    flat = jstore.leaf_names(jtree)

    def values(prefix):
        out = {}
        for name, (stacked, names) in leaf_map(tcfg, model).items():
            arr = flat[f"{prefix}/{name}"]
            for r, n in enumerate(names):
                out[n] = tensor_from_numpy(arr[r] if stacked else arr)
        return out

    opt = {k: state_tree(tcfg, model, values(f"opt/{k}")) for k in ("m", "v", "master")}
    opt["count"] = torch.tensor(7, dtype=torch.int32)
    ttree = {"params": state_tree(tcfg, model), "opt": opt}
    return jtree, ttree


def _port_leaf_bytes(leaf) -> bytes:
    if isinstance(leaf, tstore.StackedLeaf):
        return b"".join(_port_leaf_bytes(r) for r in leaf.rows)
    return leaf.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.fixture(scope="module", params=ARCHS)
def saved(request, tmp_path_factory):
    jtree, ttree = _state(request.param)
    d = tmp_path_factory.mktemp(request.param.replace(".", "_"))
    jstore.save_pytree(str(d / "ref"), jtree, step=3, extra={"note": "same state"})
    tstore.save_pytree(str(d / "port"), ttree, step=3, extra={"note": "same state"})
    return jtree, ttree, d, request.param


def test_bins_byte_identical_and_manifests_equal(saved):
    _, _, d, _ = saved
    ref, port = sorted(os.listdir(d / "ref")), sorted(os.listdir(d / "port"))
    assert ref == port and "manifest.json" in ref
    stacked = 0
    for f in ref:
        assert (d / "ref" / f).read_bytes() == (d / "port" / f).read_bytes() or f == "manifest.json", f
    jm, tm = (json.loads((d / x / "manifest.json").read_text()) for x in ("ref", "port"))
    assert jm == tm
    assert list(jm["leaves"]) == list(tm["leaves"])  # the same leaf order too
    for meta in tm["leaves"].values():
        stacked += meta["file"].startswith(("params.groups", "params.layers"))
    assert stacked > 0 and tm["leaves"]["opt/count"] == {"shape": [], "dtype": "int32", "file": "opt.count.bin"}
    assert any(m["dtype"] == "bfloat16" for m in tm["leaves"].values())


def test_port_checkpoint_loads_in_reference(saved):
    jtree, _, d, _ = saved
    loaded, step = jstore.load_pytree(str(d / "port"), jtree)
    assert step == 3
    for (name, want), got in zip(jstore.leaf_names(jtree).items(), jax.tree_util.tree_leaves(loaded)):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == np.asarray(want).tobytes(), name


def test_reference_checkpoint_loads_in_port(saved):
    _, ttree, d, _ = saved
    loaded, step = tstore.load_pytree(str(d / "ref"), ttree)
    assert step == 3
    want, got = tstore.leaf_names(ttree), tstore.leaf_names(loaded)
    assert list(want) == list(got)
    for name in want:
        stacked = isinstance(want[name], tstore.StackedLeaf)
        assert isinstance(got[name], tstore.StackedLeaf) == stacked, name
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert got[name].dtype == want[name].dtype, name
        assert _port_leaf_bytes(got[name]) == _port_leaf_bytes(want[name]), name


def test_params_to_numpy_is_the_reference_params_tree(saved):
    """``params_to_numpy`` inverts ``params_from_numpy``: the reference's
    params tree, leaf for leaf and bit for bit, a bf16 leaf as its int16
    words."""
    jtree, _, _, arch = saved
    tcfg = t_get_config(arch, smoke=True)
    got = params_to_numpy(tcfg, params_from_numpy(tcfg, jtree["params"], device="cpu"))
    want = jax.tree.map(lambda a: a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a, jtree["params"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
    assert any(w.dtype == np.int16 for w in jax.tree.leaves(want))


# ------------------------------------------------------------- the store alone


def _tree():
    """The reference's test tree (test_checkpoint_ft.py:24): fp32, bf16,
    int32 and a scalar, in both packages' forms."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = np.asarray(jnp.asarray(rng.standard_normal((4, 4, 4)), jnp.bfloat16))
    c = rng.integers(0, 100, (7,)).astype(np.int32)
    jtree = {"a": jnp.asarray(a), "nested": {"b": jnp.asarray(b), "c": jnp.asarray(c)}, "scalar": jnp.float32(3.5)}
    ttree = {"a": torch.from_numpy(a), "nested": {"b": tensor_from_numpy(b), "c": torch.from_numpy(c)},
             "scalar": torch.tensor(3.5, dtype=torch.float32)}
    return jtree, ttree


def _equal(got, want) -> bool:
    return all(g.dtype == w.dtype and torch.equal(g, w) for g, w in
               zip(tstore.leaf_names(got).values(), tstore.leaf_names(want).values()))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_store_roundtrip_both_ways(tmp_path, writer):
    jtree, ttree = _tree()
    d = str(tmp_path / "ck")
    if writer == "port":
        tstore.save_pytree(d, ttree, step=5)
    else:
        jstore.save_pytree(d, jtree, step=5)
    loaded, step = tstore.load_pytree(d, ttree)
    assert step == 5 and _equal(loaded, ttree)
    jl, jstep = jstore.load_pytree(d, jtree)
    assert jstep == 5
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(jl)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_stacked_leaf_written_as_row_shards(tmp_path):
    """A StackedLeaf writes each row at its global offset: the file is the
    stacked array's bytes, and a bf16 leaf is its 16-bit words."""
    rows = [torch.randn(3, 5, generator=torch.Generator().manual_seed(r)).to(torch.bfloat16) for r in range(4)]
    tstore.save_pytree(str(tmp_path / "ck"), {"w": tstore.StackedLeaf(rows)})
    raw = (tmp_path / "ck" / "w.bin").read_bytes()
    assert raw == torch.stack(rows).view(torch.int16).numpy().tobytes()
    back = np.frombuffer(raw, dtype=ml_dtypes.bfloat16).reshape(4, 3, 5)
    assert np.array_equal(back.astype(np.float32), torch.stack(rows).float().numpy())


def test_store_incomplete_checkpoint_rejected(tmp_path):
    _, ttree = _tree()
    d = str(tmp_path / "ck")
    tstore.save_pytree(d, ttree, step=1)
    man = json.loads(open(tstore.manifest_path(d)).read())
    man["complete"] = False
    with open(tstore.manifest_path(d), "w") as f:
        json.dump(man, f)
    with pytest.raises(RuntimeError, match="incomplete"):
        tstore.load_pytree(d, ttree)
    os.remove(tstore.manifest_path(d))
    with pytest.raises(FileNotFoundError):
        tstore.load_pytree(d, ttree)


def test_load_refuses_a_template_of_another_shape(tmp_path):
    _, ttree = _tree()
    d = str(tmp_path / "ck")
    tstore.save_pytree(d, ttree)
    ttree["a"] = torch.zeros(16, 8)
    with pytest.raises(ValueError, match="template wants"):
        tstore.load_pytree(d, ttree)


# ------------------------------------------------------------- manager


def test_manager_async_save_and_restore_latest(tmp_path):
    eng = ProgressEngine()
    mgr = CheckpointManager(str(tmp_path), eng, keep=2)
    _, tree = _tree()
    for s in (1, 2, 3):
        scaled = tstore.map_leaves(lambda a: a if a.dim() == 0 else a * s, tree)
        mgr.save_async(s, scaled)
    assert mgr.wait_for_pending(timeout=WAIT_S)
    assert mgr.available_steps() == [2, 3]  # retention keeps newest 2
    loaded, step = mgr.restore_latest(tree)
    assert step == 3
    assert torch.equal(loaded["a"], tree["a"] * 3)
    times = mgr.snapshot_times()
    assert [s["step"] for s in times] == [1, 2, 3]
    assert all(s["ms"] is None and s["write_s"] > 0 for s in times)  # CPU snapshots; written
    eng.stop_all()


def test_manager_crash_midsave_falls_back(tmp_path):
    eng = ProgressEngine()
    mgr = CheckpointManager(str(tmp_path), eng, keep=5)
    _, tree = _tree()
    mgr.save_sync(1, tree)
    # simulate a crash mid-save of step 2: tmp dir exists, no manifest
    os.makedirs(str(tmp_path / "step_00000002.tmp"))
    loaded, step = mgr.restore_latest(tree)
    assert step == 1 and _equal(loaded, tree)
    eng.stop_all()


def test_manager_snapshot_holds_the_step_bytes_and_reuses_buffers(tmp_path):
    """A save issued at step k holds step k's bytes though the caller
    updates the tensors in place right after; the host buffers of one
    bounded save window are reused, never reallocated per save."""
    eng = ProgressEngine()
    mgr = CheckpointManager(str(tmp_path), eng, keep=0, max_inflight=1)
    _, tree = _tree()
    want = {}
    for s in range(1, 5):
        want[s] = tstore.map_leaves(lambda t: t.clone(), tree)
        mgr.save_async(s, tree)
        mgr.wait_snapshots()  # the caller's duty before it writes saved tensors in place
        with torch.no_grad():
            for t in tstore.tree_tensors(tree):
                t.add_(1)  # the next step's in-place update
    assert mgr.wait_for_pending(timeout=WAIT_S)
    for s in range(1, 5):
        loaded, step = mgr.restore_step(s, tree)
        assert step == s and _equal(loaded, want[s]), s
    assert len(mgr._free_sets) == 1  # one buffer set served all four saves
    eng.stop_all()


# ------------------------------------------------- reshard failure paths


def _reshard_engine():
    eng = ProgressEngine()
    return eng, StreamPool().create(name="reshard-fail")


def test_execute_reshard_midwindow_error_drains_and_surfaces():
    eng, stream = _reshard_engine()
    plans = reshard_plan((16, 8), (4, 1), itemsize=4)
    assert sum(len(v) for v in plans.values()) >= 4
    boom = ValueError("disk sector went dark")
    calls = {"n": 0}

    def read_run(iov):
        calls["n"] += 1
        if calls["n"] == 2:
            raise boom
        return b"\0" * iov.length

    with pytest.raises(ValueError, match="sector went dark") as ei:
        execute_reshard(plans, read_run, depth=2, engine=eng, stream=stream)
    assert ei.value is boom
    eng.progress()
    assert eng.pending() == 0, "reshard failure leaked live requests"
    st = eng.stats()
    assert st["enqueued"] == st["completions"]


def test_execute_reshard_first_read_error_still_drains():
    eng, stream = _reshard_engine()
    plans = reshard_plan((8, 4), (2, 1), itemsize=4)

    def read_run(iov):
        raise OSError("pread: EIO")

    with pytest.raises(OSError, match="EIO"):
        execute_reshard(plans, read_run, depth=3, engine=eng, stream=stream)
    eng.progress()
    assert eng.pending() == 0


def test_execute_reshard_all_reads_fail_reports_first():
    eng, stream = _reshard_engine()
    plans = reshard_plan((8, 4), (4, 1), itemsize=4)
    seen = []

    def read_run(iov):
        e = RuntimeError(f"fail@{iov.offset}")
        seen.append(e)
        raise e

    with pytest.raises(RuntimeError) as ei:
        execute_reshard(plans, read_run, depth=2, engine=eng, stream=stream)
    assert ei.value in seen
    eng.progress()
    assert eng.pending() == 0


def test_trainer_reshard_checkpoint_error_path(tmp_path):
    """Mirror of test_checkpoint_ft.py:331: the healthy reshard conserves
    bytes; a missing .bin raises cleanly without leaking window slots."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.adamw import AdamWConfig

    cfg = t_get_config("qwen1.5-0.5b", smoke=True)
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2), DataConfig(batch=2, seq=16, seed=0),
                 ckpt_dir=str(tmp_path / "ck"), ckpt_every=5, autotune=False, device="cpu")
    try:
        tr.run(2)
        d = tr.ckpt._dir_for(tr.ckpt.available_steps()[-1])
        plan = plan_remesh((2, 2, 2), ("pod", "data", "model"), n_failed=1)
        got, stats = tr._reshard_checkpoint(d, plan)
        with open(os.path.join(d, "manifest.json")) as f:
            leaf = json.load(f)["leaves"][got["leaf"]]
        nbytes = os.path.getsize(os.path.join(d, leaf["file"]))
        assert sum(len(b) for b in got["shards"].values()) == nbytes
        assert stats["admitted"] == stats["reaped"]
        os.remove(os.path.join(d, leaf["file"]))
        with pytest.raises(FileNotFoundError):
            tr._reshard_checkpoint(d, plan)
        tr.heartbeat.stop()
        tr.engine.progress()
        assert tr.engine.pending() == 0, "failed reshard leaked live requests"
    finally:
        tr.close()
