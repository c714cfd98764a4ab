"""The port's training path against the JAX package's, on the smoke
``qwen1.5-0.5b``: the JAX initial params go across with
``params_from_numpy`` and both packages read the same seeded batches.

Tolerances, with their reasons:

* The first step in fp32: the loss within 1e-5 relative, every grad leaf
  within 1e-4 of its largest magnitude, ``global_norm`` within 1e-5
  relative. Forward and backward are the same fp32 operations summed in
  other orders.
* A 4-step loss history in fp32: within 2e-3 of the first loss. AdamW's
  first step moves every element by about ``lr · g / |g|``, so an element
  whose grad is near zero and of the other sign in the other package moves
  by ``2 · lr`` there; later losses carry those elements.
* ``grad_accum = 2`` in bf16 (the published dtype): the accumulated grads
  are fp32 and equal, bit for bit, to the port's own two microbatch grads
  (bf16) added in fp32 and halved; against the reference within 2e-2 of
  each leaf's largest magnitude (bf16 microbatch grads, which the packages
  round after other summation orders). The key bias ``attn/bk`` is held
  against the scale of ``attn/wk``'s grads instead: softmax is invariant to
  the per-query constant ``q · bk`` it adds, so its exact gradient is zero
  and what either package computes is rounding.
* The windowed grad path, checkpoint restarts and ``remat="full"`` are
  held byte for byte against the port's own fused step: on one rank RS∘AG
  is the identity and flatten→unflatten is exact.

Every wait is bounded at 10 s.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig, SyntheticPipeline as JPipeline  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig, global_norm as j_global_norm  # noqa: E402
from repro_torch.checkpoint import iovec_store as tstore  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig as TDataConfig  # noqa: E402
from repro_torch.ft.faultinject import FaultEvent, FaultInjector, FaultPlan, VirtualClock  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.convert import leaf_map, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig as TAdamWConfig, adamw_init, global_norm as t_global_norm  # noqa: E402

WAIT_S = 10.0
FP32 = dict(param_dtype="float32", compute_dtype="float32")
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=12)
DATA = dict(batch=4, seq=32, seed=7)


def _cfgs(**over):
    return (j_get_config("qwen1.5-0.5b", smoke=True).replace(**over),
            t_get_config("qwen1.5-0.5b", smoke=True).replace(**over))


def _trainer(tcfg, **kw):
    kw.setdefault("autotune", False)
    return ttrain.Trainer(tcfg, TAdamWConfig(**OPT), TDataConfig(**DATA), device="cpu", **kw)


def _carry(tr, tcfg, jparams) -> None:
    """Give the port trainer the JAX params (and a fresh optimizer state)."""
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    src = dict(model.named_parameters())
    with torch.no_grad():
        for n, p in tr.params.named_parameters():
            p.copy_(src[n])
    tr.opt_state = adamw_init(tr.opt_cfg, tr._named)


def _port_grads_as_tree(tcfg, model, grads):
    """name → stacked numpy leaf, the reference's leaf names."""
    out = {}
    for name, (stacked, names) in leaf_map(tcfg, model).items():
        rows = [grads[n].float().numpy() for n in names]
        out[name] = np.stack(rows) if stacked else rows[0]
    return out


def _flat_ref(tree) -> dict:
    from repro.checkpoint.iovec_store import leaf_names

    return {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in leaf_names(tree).items()}


def _state_bytes(tr) -> list:
    return [t.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()
            for t in tstore.tree_tensors(tr.state_tree())]


@pytest.fixture(scope="module")
def ref_run():
    """The reference trainer's initial params, first-step grads and a
    4-step loss history, fp32."""
    jcfg, _ = _cfgs(**FP32)
    jtr = jtrain.Trainer(jcfg, JAdamWConfig(**OPT), JDataConfig(**DATA), autotune=False)
    params0 = jtr.params
    batch = {k: jnp.asarray(v) for k, v in jtr.pipeline.get_batch(0).items()}
    grads, loss = jax.jit(jtrain.make_grad_step(jcfg))(params0, batch)
    hist = jtr.run(4, log_every=100)
    jtr.heartbeat.stop()
    jtr.engine.stop_all()
    return dict(params=params0, grads=grads, loss=float(loss), hist=hist)


def test_first_step_loss_and_grads_match_reference(ref_run):
    _, tcfg = _cfgs(**FP32)
    tr = _trainer(tcfg)
    try:
        _carry(tr, tcfg, ref_run["params"])
        batch = {k: torch.from_numpy(v) for k, v in tr.pipeline.get_batch(0).items()}
        grads, loss = ttrain.make_grad_step(tcfg)(tr.params, batch)
        assert abs(float(loss) - ref_run["loss"]) <= 1e-5 * abs(ref_run["loss"])
        got, want = _port_grads_as_tree(tcfg, tr.params, grads), _flat_ref(ref_run["grads"])
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].shape == want[name].shape, name
            assert np.abs(got[name] - want[name]).max() <= 1e-4 * np.abs(want[name]).max(), name
        jn, tn = float(j_global_norm(ref_run["grads"])), float(t_global_norm(grads))
        assert abs(tn - jn) <= 1e-5 * jn
    finally:
        tr.close()


def test_loss_history_matches_reference(ref_run):
    _, tcfg = _cfgs(**FP32)
    tr = _trainer(tcfg)
    try:
        _carry(tr, tcfg, ref_run["params"])
        hist = tr.run(4, log_every=100)
    finally:
        tr.close()
    want = np.asarray(ref_run["hist"])
    print(f"[train parity] port {hist} reference {want.tolist()}")
    assert len(hist) == 4 and np.all(np.isfinite(hist))
    assert np.abs(np.asarray(hist) - want).max() <= 2e-3 * want[0], (hist, want)
    assert abs(hist[0] - want[0]) <= 1e-5 * want[0]  # step 0 runs on the carried params: tight


def test_grad_accum2_accumulates_in_fp32():
    jcfg, tcfg = _cfgs(grad_accum=2)
    assert tcfg.param_dtype == "bfloat16" and tcfg.accum_dtype == "float32"
    jp = jax.tree.map(np.asarray, japi.init_params(jcfg, jax.random.key(0)))
    model = params_from_numpy(tcfg, jp, device="cpu")
    model.requires_grad_(True)
    nb = JPipeline(jcfg, JDataConfig(**DATA)).build_batch(0)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    grads, loss = ttrain.make_grad_step(tcfg)(model, batch)
    assert all(g.dtype == torch.float32 for g in grads.values()) and loss.dtype == torch.float32
    # the port's own microbatch grads (bf16), added in fp32 and halved
    one = tcfg.replace(grad_accum=1)
    halves = [ttrain.make_grad_step(one)(model, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}) for i in range(2)]
    assert all(g.dtype == torch.bfloat16 for g in halves[0][0].values())
    for n, g in grads.items():
        want = (torch.zeros_like(g).add_(halves[0][0][n].float()).add_(halves[1][0][n].float())) / 2
        assert torch.equal(g, want), n
    assert torch.equal(loss, (torch.zeros(()) + halves[0][1] + halves[1][1]) / 2)
    jg, jl = jax.jit(jtrain.make_grad_step(jcfg))(jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in nb.items()})
    assert abs(float(loss) - float(jl)) <= 1e-2 * abs(float(jl))
    got, want = _port_grads_as_tree(tcfg, model, grads), _flat_ref(jg)
    for name in want:
        scale = np.abs(want[name.replace("attn/bk", "attn/wk")]).max()
        assert np.abs(got[name] - want[name]).max() <= 2e-2 * scale, name


def test_remat_full_equals_none_and_other_policies_raise():
    """``"full"``, ``"dots"`` and ``"save_acts"`` give ``"none"``'s loss and
    gradients byte for byte: a policy only chooses what the backward pass
    recomputes."""
    _, tcfg = _cfgs(**FP32)
    tr = _trainer(tcfg)
    try:
        batch = {k: torch.from_numpy(v) for k, v in tr.pipeline.get_batch(0).items()}
        g_none, l_none = ttrain.make_grad_step(tcfg.replace(remat="none"))(tr.params, batch)
        for policy in ("full", "dots", "save_acts"):
            g, l = ttrain.make_grad_step(tcfg.replace(remat=policy))(tr.params, batch)
            assert torch.equal(l_none, l) and all(torch.equal(g_none[n], g[n]) for n in g_none), policy
    finally:
        tr.close()


def test_windowed_step_byte_equal_to_fused():
    """grad_overlap='windowed' (buckets through the window, RS∘AG on the
    1-rank data axis) leaves params, master, m and v byte-equal to the
    fused step after every step."""
    _, tcfg = _cfgs()
    fused, windowed = _trainer(tcfg), _trainer(tcfg, grad_overlap="windowed", grad_bucket_bytes=1 << 12)
    try:
        assert windowed._grad_plan.n_buckets > 4
        assert _state_bytes(fused) == _state_bytes(windowed)
        for step in range(3):
            batch = fused.pipeline.build_batch(step)
            mf, mw = fused.step(batch), windowed.step(batch)
            assert torch.equal(mf["loss"], mw["loss"]) and torch.equal(mf["grad_norm"], mw["grad_norm"])
            assert _state_bytes(fused) == _state_bytes(windowed), step
        st = windowed._grad_window.stats(engine=False)
        assert st["admitted"] == st["reaped"] == 3 * windowed._grad_plan.n_buckets
    finally:
        fused.close()
        windowed.close()


def test_make_train_step_equals_trainer_step():
    """``make_train_step`` (grad step, then the in-place AdamW update) leaves
    the state byte-equal to ``Trainer.step`` on the same batches."""
    _, tcfg = _cfgs()
    tr, ref = _trainer(tcfg), _trainer(tcfg)
    try:
        train_step = ttrain.make_train_step(tcfg, ref.opt_cfg)
        for step in range(2):
            batch = tr.pipeline.build_batch(step)
            m = tr.step(batch)
            _, ref.opt_state, mr = train_step(ref.params, ref.opt_state,
                                              {k: torch.from_numpy(v) for k, v in batch.items()})
            assert torch.equal(m["loss"], mr["loss"]) and torch.equal(m["grad_norm"], mr["grad_norm"])
            assert _state_bytes(tr) == _state_bytes(ref), step
    finally:
        tr.close()
        ref.close()


def test_checkpoint_restart_resumes_identically(tmp_path):
    """Mirror of test_system.py:36: 6 steps straight against 4 steps, a
    fresh trainer restoring, and 2 more — equal losses and state, byte for
    byte (the batches are a function of the step; the state is restored
    exactly)."""
    _, tcfg = _cfgs()
    tr1 = _trainer(tcfg, ckpt_dir=str(tmp_path / "a"), ckpt_every=2)
    tr2 = _trainer(tcfg, ckpt_dir=str(tmp_path / "b"), ckpt_every=2)
    tr3 = _trainer(tcfg, ckpt_dir=str(tmp_path / "b"), ckpt_every=2)
    try:
        full = tr1.run(6, log_every=100)
        tr2.run(4, log_every=100)  # saves at step 2 and the final step 3
        assert tr2.ckpt.available_steps() == [2, 3]
        tr3.maybe_restore()
        assert tr3.start_step == 4 and _state_bytes(tr3) == _state_bytes(tr2)
        resumed = tr3.run(2, log_every=100)
        assert resumed == full[4:6]
        assert _state_bytes(tr3) == _state_bytes(tr1)
        with open(tstore.manifest_path(tr1.ckpt._dir_for(5))) as f:
            assert json.load(f)["leaves"]["opt/count"] == {"shape": [], "dtype": "int32", "file": "opt.count.bin"}
    finally:
        for tr in (tr1, tr2, tr3):
            tr.close()


def test_handle_failure_replans_and_restores_like_reference(tmp_path):
    """Mirror of test_system.py:62 on both packages: after 4 steps (saves at
    step 2 and the final step 3) the port's params are zeroed and ranks
    [3, 7] fail on a (2, 16, 16) mesh. Each package's trainer plans the same
    shrunken mesh (the model axis intact) and rolls back to the step-3
    checkpoint the port wrote, its params byte-equal to the saved ones."""
    jcfg, tcfg = _cfgs()
    d = str(tmp_path / "ck")
    tr = _trainer(tcfg, ckpt_dir=d, ckpt_every=2)
    jtr = jtrain.Trainer(jcfg, JAdamWConfig(**OPT), JDataConfig(**DATA), ckpt_dir=d, autotune=False)
    try:
        tr.run(4, log_every=100)
        saved = params_to_numpy(tcfg, tr.params)
        with torch.no_grad():
            for p in tr.params.parameters():
                p.zero_()
        plan = tr.handle_failure([3, 7], mesh_shape=(2, 16, 16))
        jplan = jtr.handle_failure([3, 7], mesh_shape=(2, 16, 16))
        assert (plan.shape, plan.axis_names, plan.n_devices, plan.dropped) == (
            jplan.shape, jplan.axis_names, jplan.n_devices, jplan.dropped)
        assert plan.shape[2] == 16 and plan.n_devices <= 510
        assert tr.start_step == jtr.start_step == 4
        got = params_to_numpy(tcfg, tr.params)
        jgot = jax.tree.map(lambda a: np.asarray(a).view(np.int16) if a.dtype == jnp.bfloat16 else np.asarray(a),
                            jtr.params)
        for s_, g, j in zip(jax.tree.leaves(saved), jax.tree.leaves(got), jax.tree.leaves(jgot)):
            assert np.array_equal(s_, g) and np.array_equal(s_, j)
        assert any(np.abs(g.astype(np.float32)).max() > 0 for g in jax.tree.leaves(got))
    finally:
        tr.close()
        jtr.heartbeat.stop()
        jtr.engine.stop_all()


def test_kill_rank_mid_epoch_end_to_end(tmp_path):
    """Mirror of test_fault_injection.py:501: injected rank death →
    heartbeat detect on a virtual clock → plan_remesh → windowed reshard
    (byte-equal to a clean restart) → training resumes on the shrunk mesh."""
    steps = 12
    _, tcfg = _cfgs()
    clock = VirtualClock()
    with FaultInjector(FaultPlan([FaultEvent(1.0, "kill_rank", 1)]), clock=clock) as inject:
        tr = ttrain.Trainer(tcfg, TAdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps), TDataConfig(**DATA),
                            ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2, ckpt_keep=0, autotune=False,
                            mesh_shape=(2, 2, 2), mesh_axes=("pod", "data", "model"), ranks=(0, 1, 2, 3),
                            hb_timeout=2.0, hb_clock=clock, hb_tick=0.5, fault_injector=inject, device="cpu")
        try:
            inject.attach_heartbeat(tr.heartbeat)
            hist = tr.run(steps, log_every=100)
        finally:
            tr.close()
    assert len(tr.recoveries) == 1
    rec = tr.recoveries[0]
    assert rec["failed"] == [1] and rec["plan"].shape == (1, 2, 2) and 1 not in tr.ranks
    assert len(hist) == steps and all(np.isfinite(hist))
    assert rec["reshard_stats"]["admitted"] == rec["reshard_stats"]["reaped"]
    shards = rec["shards"]
    d = tr.ckpt._dir_for(rec["ckpt_step"])
    clean, _ = tr._reshard_checkpoint(d, rec["plan"])
    assert clean["shards"] == shards["shards"], "recovery reshard != clean restart"
    with open(tstore.manifest_path(d)) as f:
        manifest = json.load(f)
    raw = open(os.path.join(d, manifest["leaves"][shards["leaf"]]["file"]), "rb").read()
    assert b"".join(shards["shards"][c] for c in sorted(shards["shards"])) == raw


def test_recover_rerecords_grad_bucket_schedule_byte_equal():
    """Mirror of test_grad_overlap_window.py:173: recover() invalidates a
    registered grad-bucket schedule and re-records it; replays stay
    byte-equal to the eager collective."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.schedule import Schedule
    from repro_torch.core.streams import StreamPool, stream_comm_create
    from repro_torch.optim.grad_overlap import bucketed_all_reduce_host, build_buckets

    _, tcfg = _cfgs()
    tr = _trainer(tcfg, ranks=(0, 1, 2, 3), mesh_shape=(2, 2, 2))
    eng, pool = tr.engine, StreamPool()
    mesh = make_mesh((1,), ("data",), device="cpu")
    comms = [stream_comm_create(mesh, ("data",), pool.create(name=f"gwrm{i}")) for i in range(2)]
    plan = build_buckets([torch.empty(64, 8), torch.empty(256)], bucket_bytes=1024)
    flat = torch.arange(plan.total_elems, dtype=torch.float32) / plan.total_elems
    try:
        eager = bucketed_all_reduce_host(flat, plan, comms, engine=eng)
        sched = Schedule(engine=eng, stream=comms[0].stream, name="t-grads-remesh")
        outs = []

        def record_grads(s):
            outs.append(bucketed_all_reduce_host(flat, plan, comms, engine=eng, schedule=s))

        record_grads(sched)
        assert sched.sealed and torch.equal(outs[0], eager)
        tr.register_schedule("grad-buckets", sched, record_grads)
        tr._note_failure([1])
        failed = tr._take_failures()
        assert failed == [1]
        tr.recover(failed)
        assert tr.recoveries[-1]["schedules_rerecorded"] == ["grad-buckets"]
        assert sched.sealed and torch.equal(outs[1], eager)
        out = bucketed_all_reduce_host(flat, plan, comms, engine=eng, schedule=sched)
        assert torch.equal(out, eager) and sched.stats()["replays"] == 1
    finally:
        tr.close()


def test_rebalance_enacts_fewer_microbatches():
    """Mirror of test_grad_overlap_window.py:113: straggler advice lands in
    the live pipeline's weighted prefetch split."""
    _, tcfg = _cfgs()
    tr = ttrain.Trainer(tcfg, TAdamWConfig(**OPT), TDataConfig(batch=2, seq=16, loader_threads=3), autotune=False,
                        ranks=(0, 1, 2), device="cpu")
    try:
        tr.microbatch_total = 12
        for _ in range(4):
            tr.straggler.record_step({0: 1.0, 1: 1.0, 2: 4.0})
        advice = tr.straggler.check()
        assert [a.rank for a in advice] == [2] and advice[0].action == "rebalance"
        tr._apply_straggler_advice(advice)
        assert tr.microbatch_shares[2] < tr.microbatch_shares[0]
        for s in range(12):
            tr.pipeline.prefetch(s)
            tr.pipeline.get_batch(s)
        counts = tr.pipeline.assignments
        assert sum(counts.values()) == 12 and 1 <= counts.get(3, 0) < min(counts[1], counts[2]), counts
    finally:
        tr.pipeline.stop_workers()
        tr.close()


def test_prefill_step_serves_the_trained_model():
    """make_prefill_step on a trained model: the flash route (its plain
    version on the CPU) against the einsum route, under no_grad though the
    parameters take gradients."""
    _, tcfg = _cfgs(**FP32)
    tr = _trainer(tcfg)
    try:
        tr.run(2, log_every=100)
        assert all(p.requires_grad for p in tr.params.parameters())
        prompt = {"tokens": np.random.default_rng(0).integers(0, tcfg.vocab, (1, 128)).astype(np.int32)}
        lf, cache = ttrain.make_prefill_step(tcfg.replace(attn_impl="flash"))(tr.params, prompt)
        le, _ = ttrain.make_prefill_step(tcfg)(tr.params, prompt)
        assert not lf.requires_grad and lf.shape == (1, tcfg.vocab)
        assert (lf - le).abs().max() <= 1e-4 * le.abs().max()
    finally:
        tr.close()


def test_train_cli_runs_and_restores_on_the_cpu(tmp_path, capsys):
    hist = ttrain.main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 3 and all(np.isfinite(hist))
    ttrain.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[trainer] restored step 2" in out and "progress engine:" in out
