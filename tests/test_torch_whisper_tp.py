"""Whisper's tensor-parallel sharded train step (``models.whisper.tp_loss``
through ``launch.train.make_grad_step(dp=)`` / ``make_train_step(dp=)``)
against the port's single-rank step and the JAX package's loss and
gradients, fp32 at the smoke size (2 encoder + 2 decoder layers, d 64, 4
heads of 16, vocab 256, 16 stub frames) with ``grad_accum=2``.

The weights are numpy draws in the shapes of the reference's tree
(``jax.eval_shape`` of ``init_params``), carried to the port with
``params_from_numpy``; the reference's ``loss_fn`` and its gradient run
under ``jax.jit`` on one device on the whole batch (its mean over the
microbatches' equal token counts). The meshes: ``(2, 2, 2)`` ``("pod",
"data", "model")`` and ``(1, 4)`` ``("data", "model")``; 6 heads on
``model`` 4 (q heads 1, 2, 1, 2 a rank; every rank reads the whole
``wk``/``wv``) and on ``model`` 8 (two ranks hold no head); a vocab of 257
rows on ``(1, 2)`` (uneven vocab shares).

Tolerances: the loss to 1e-5 relative, every gradient within 1e-4 of its
leaf's largest, but the key biases (``*.attn.bk``, ``*.xattn.bk``): a key
bias shifts each softmax row by a constant and Whisper has no rope, so
their true gradient is zero and each step holds only its rounding; they
are held at 1e-4 of the same attention's ``wk`` gradient's largest, every
step's values as near zero as that (``tests/test_torch_whisper.py``'s
rule). Every rendezvous of the mesh's ranks waits at most
``core.mesh.RENDEZVOUS_TIMEOUT_S`` (10 s) and the checkpoint's write is
waited on for 10 s.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.mesh import device_put, make_mesh  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch.train import (make_grad_step, make_prefill_step, make_serve_step, make_train_step,  # noqa: E402
                                      named, train_shardings)
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.convert import leaf_map, params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.parallel.sharding import dp_axes, param_specs  # noqa: E402

ARCH = "whisper-tiny"
B, S, ACCUM = 8, 16, 2
FP32 = dict(param_dtype="float32", compute_dtype="float32", accum_dtype="float32", grad_accum=ACCUM)
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")), "1x4": ((1, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")), "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
HEADS6 = (("n_heads", 6), ("n_kv_heads", 6))
#: case → (mesh, config overrides)
CASES = {
    "2x2x2-none": ("2x2x2", (("remat", "none"),)),
    "2x2x2-full": ("2x2x2", (("remat", "full"),)),
    "1x4-full": ("1x4", (("remat", "full"),)),
    "1x4-heads6": ("1x4", HEADS6),
    "1x8-heads6": ("1x8", HEADS6),
    "1x2-vocab257": ("1x2", (("vocab", 257),)),
}


def _cfgs(over=()):
    over = dict(FP32, **dict(over))
    return jget(ARCH, smoke=True).replace(**over), tget(ARCH, smoke=True).replace(**over)


@functools.lru_cache(maxsize=None)
def _tree(over=()):
    """The reference's params tree of numpy draws (``tests/test_torch_whisper.py``'s
    distributions: every bias non-zero, so each takes part)."""
    jcfg, _ = _cfgs(over)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))

    def one(path, a):
        name = getattr(path[-1], "key", None)
        n = rng.standard_normal(a.shape)
        if name == "tok":
            v = 0.02 * n
        elif name == "w":
            v = 1.0 + 0.1 * n
        elif name in ("b", "bq", "bk", "bv", "b_in", "b_out"):
            v = 0.1 * n
        else:
            v = n * a.shape[-2] ** -0.5
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
            "enc_frames": torch.from_numpy(rng.standard_normal((B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32))}


def _reference(over=()):
    """The reference's loss and gradients (leaf name → numpy) on the whole
    batch; the remat policy changes neither."""
    return _reference_of(tuple(kv for kv in over if kv[0] != "remat"))


@functools.lru_cache(maxsize=None)
def _reference_of(over):
    jcfg, tcfg = _cfgs(over)
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(tcfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, batch)[0]))(
        jax.tree.map(jnp.asarray, _tree(over)))
    flat = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), flat


def _opt_cfg():
    return AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)


def _setup(mesh_name, over=()):
    _, cfg = _cfgs(over)
    mesh = make_mesh(*MESHES[mesh_name], device="cpu")
    model = params_from_numpy(cfg, _tree(over), device="cpu")
    return cfg, mesh, model, _batch(cfg)


def _sharded_state(cfg, mesh, model, batch):
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    pspecs, ospecs, _, _ = train_shardings(cfg, _opt_cfg(), mesh, model, batch)
    return device_put(params, named(mesh, pspecs)), device_put(adamw_init(_opt_cfg(), params), named(mesh, ospecs))


@functools.lru_cache(maxsize=None)
def _tp_run(mesh_name, over=()):
    """:func:`_grads` of a case's setup, computed once."""
    return _grads(*_setup(mesh_name, over))


def _grads(cfg, mesh, model, batch):
    """The sharded grad step: (grads gathered, loss, collectives of position 0 by kind and axes)."""
    params, _ = _sharded_state(cfg, mesh, model, batch)
    with rl.count_collectives() as coll:
        grads, loss = make_grad_step(cfg, dp=dp_axes(mesh))(params, batch)
    return {n: g.gather().numpy() for n, g in grads.items()}, loss.item(), coll.by_axes[0]


def _designed(cfg) -> dict:
    """The grad step's collectives over ``model`` by design, at mesh position
    0: each microbatch's embedding all-reduce, each encoder layer's two and
    each decoder layer's three sublayer outputs all-reduced, the
    cross-entropy's sums all-reduced and its maxima all-gathered, each
    all-reduce with its transpose (a recompute reads its log: none more)."""
    subs = 2 * cfg.n_enc_layers + 3 * cfg.n_layers
    return {("all-gather", ("model",)): ACCUM, ("all-reduce", ("model",)): ACCUM * (2 * subs + 4)}


def _hold(got: dict, want: dict, what: str) -> None:
    """Every leaf within 1e-4 of its largest; the key biases by the module docstring's rule."""
    for n, w in want.items():
        if n.endswith("attn.bk"):
            bound = 1e-4 * np.abs(want[n[:-2] + "wk"]).max()
            assert np.abs(got[n]).max() <= bound and np.abs(w).max() <= bound, (what, n)
        else:
            bound = 1e-4 * max(np.abs(w).max(), 1e-6)
        assert np.max(np.abs(got[n] - w)) <= bound, (what, n, float(np.max(np.abs(got[n] - w))), bound)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_grads_match_single_rank_and_reference(case):
    """The TP grad step's loss and every gradient against the single-rank
    step's and the reference's, the encoder's leaves among them (their
    gradient comes through every decoder layer's cross K/V on every rank's
    heads). Where ``model`` divides the heads the step issues the design's
    collectives over ``model`` (:func:`_designed`), under ``remat="full"``
    too: each layer's recompute reads its logged collectives back."""
    mesh_name, over = CASES[case]
    cfg, mesh, model, batch = _setup(mesh_name, over)
    got, loss, kinds = _tp_run(mesh_name, over)
    single = model.requires_grad_(True)
    want, loss1 = make_grad_step(cfg)(single, batch)
    want = {n: g.numpy() for n, g in want.items()}
    assert abs(loss - loss1.item()) <= 1e-5 * abs(loss1.item()), (loss, loss1.item())
    _hold(got, want, "single-rank")
    jloss, jgrads = _reference(over)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss), (loss, jloss)
    ref = {}
    for name, (stacked, names) in leaf_map(cfg, model).items():
        for i, n in enumerate(names):
            ref[n] = jgrads[name][i] if stacked else jgrads[name]
    _hold(got, ref, "reference")
    assert any(n.startswith("enc_layers.") for n in got) and "enc_ln_post.w" in got
    if cfg.n_heads % mesh.shape["model"] == 0:  # else the leaves split off head boundaries are gathered whole
        assert {k: v for k, v in kinds.items() if k[1] == ("model",)} == _designed(cfg), kinds


@pytest.mark.parametrize("mesh_name,over", [("1x4", ()), ("1x4", HEADS6), ("1x8", HEADS6)],
                         ids=["1x4", "1x4-heads6", "1x8-heads6"])
def test_encoder_output_gradient_is_counted_once(mesh_name, over):
    """The gradient of the encoder's output, the same tensor on every
    ``model`` rank, through the TP decoder (both layers' cross K/V on each
    rank's heads, the rank's own K/V heads or every head from the whole
    ``wk``/``wv``, two ranks with no head on ``model`` 8): the ranks'
    partial cotangents add up to the single-rank decoder's gradient, within
    1e-4 of its largest, counted once."""
    from repro_torch.core.mesh import P, current_region, shard_map
    from repro_torch.models import tp, whisper
    from repro_torch.models.common import logits_out, next_token_xent

    cfg, mesh, model, batch = _setup(mesh_name, over)
    specs = param_specs(cfg, model, mesh)
    params = device_put({n: p.detach().clone() for n, p in model.named_parameters()}, named(mesh, specs))
    enc = torch.from_numpy(np.random.default_rng(5).standard_normal((B, cfg.n_audio_ctx, cfg.d_model))
                           .astype(np.float32)).requires_grad_(True)
    tokens = batch["tokens"].long()

    def body(tokens, enc):
        w = tp.RankWeights({n: st.blocks[current_region().slot] for n, st in params.items()}, specs, mesh)
        x, positions = whisper._tp_dec_in(cfg, w, tokens)
        for l in range(cfg.n_layers):
            x = whisper._tp_train_dec_layer(cfg, w, l, x, positions, enc)
        total, count = tp.xent(cfg, w, tp.norm(cfg, w, "final_norm.", x), tokens)
        return total / count

    (got,) = torch.autograd.grad(shard_map(body, mesh, (P(), P()), P())(tokens, enc), enc)
    single = enc.detach().clone().requires_grad_(True)
    x, _ = whisper.decode_full(cfg, model, tokens, single)
    (want,) = torch.autograd.grad(next_token_xent(logits_out(cfg, model.embed, x), tokens), single)
    assert torch.max(torch.abs(got - want)) <= 1e-4 * torch.max(torch.abs(want)), float(torch.abs(got - want).max())


@pytest.mark.parametrize("hint", ["seq_shard_acts", "moe_dispatch_sharding"])
def test_hints_change_nothing(hint):
    """Each layout hint on Whisper's TP grad step: the same loss and grads
    as the hint-free step (1e-6 of the loss and of each leaf's largest, the
    key biases at their ``wk``'s scale) and the same collectives by kind
    and axes; the sharded prefill and two decode steps under it give the
    hint-free logits. (``make_train_step`` under either hint runs in
    ``tests/test_torch_dryrun.py`` and on the card.)"""
    over = CASES["2x2x2-none"][1]
    cfg, mesh, model, batch = _setup("2x2x2", over)
    hinted = cfg.replace(**{hint: True})
    g0, l0, k0 = _tp_run("2x2x2", over)
    g1, l1, k1 = _grads(hinted, mesh, model, batch)
    assert abs(l1 - l0) <= 1e-6 * abs(l0) and k1 == k0, (l0, l1, k0, k1)
    for n, w in g0.items():
        scale = np.abs(g0[n[:-2] + "wk"] if n.endswith("attn.bk") else w).max()
        assert np.max(np.abs(g1[n] - w)) <= 1e-6 * scale, (hint, n)
    smesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    sp = device_put({n: p.detach().clone() for n, p in model.named_parameters()},
                    named(smesh, param_specs(cfg, model, smesh)))
    prompt = {"tokens": batch["tokens"][:4, :8], "enc_frames": batch["enc_frames"][:4]}
    runs = []
    for c in (cfg, hinted):
        logits, cache = make_prefill_step(c)(sp, prompt, 12)
        outs, tok = [logits], torch.argmax(logits, -1)
        for i in range(2):
            out, cache = make_serve_step(c)(sp, cache, tok, torch.full((4,), 8 + i))
            outs.append(out)
            tok = torch.argmax(out, -1)
        runs.append(outs)
    for a, b in zip(*runs):
        assert torch.allclose(a, b, rtol=0, atol=1e-6 * float(b.abs().max())), hint


def test_zero1_checkpoint_round_trip(tmp_path):
    """2 + 2 layers over dp 2 (``(2, 2)``): each layer's moments of both
    stacks, ``enc_layers`` and ``dec_layers``, held by one dp rank (layer
    ``l`` by dp rank ``l``); after one TP train step the sharded state's checkpoint
    is byte for byte the checkpoint of the same state gathered whole, and
    restored with ``shardings=`` every held block reads back its bytes and
    the others stay empty."""
    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.mesh import ShardedTensor, StackRow
    from repro_torch.models.convert import shardings_tree, state_tree

    cfg, mesh, model, batch = _setup("2x2")
    params, opt = _sharded_state(cfg, mesh, model, batch)
    for stack in ("enc_layers", "dec_layers"):
        for l in range(2):
            st = opt["m"][f"{stack}.{l}.mlp.w_in"]
            assert isinstance(st.sharding.spec, StackRow)
            held = [s for s in range(mesh.size) if st.blocks[s] is not None]
            assert held == [s for s in range(mesh.size) if mesh.coords(s)["data"] == l]
    make_train_step(cfg, _opt_cfg(), dp=dp_axes(mesh))(params, opt, batch)

    def tree(p, o):
        t = {k: state_tree(cfg, model, o[k]) for k in ("m", "v", "master")}
        t["count"] = o["count"]
        return {"params": state_tree(cfg, model, p), "opt": t}

    whole = lambda d: {n: st.gather() for n, st in d.items()}  # noqa: E731
    sharded = tree(params, opt)
    gathered = tree(whole(params), {**{k: whole(opt[k]) for k in ("m", "v", "master")}, "count": opt["count"].gather()})
    for name, t in (("sharded", sharded), ("whole", gathered)):
        mgr = CheckpointManager(str(tmp_path / name))
        req = mgr.save_async(0, t)
        assert mgr.engine.wait(req, 10.0) and req.status() is None, name
    ours, theirs = tmp_path / "sharded" / "step_00000000", tmp_path / "whole" / "step_00000000"
    files = sorted(p.name for p in theirs.iterdir())
    assert sorted(p.name for p in ours.iterdir()) == files and len(files) > 20
    for f in files:
        assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f
    per = lambda t: shardings_tree(cfg, model, {n: st.sharding for n, st in t.items()})  # noqa: E731
    shardings = {"params": per(params), "opt": {**{k: per(opt[k]) for k in ("m", "v", "master")},
                                                "count": opt["count"].sharding}}
    loaded, step = CheckpointManager(str(tmp_path / "whole")).restore_step(0, sharded, shardings=shardings)
    got, want = store.leaf_names(loaded), store.leaf_names(sharded)
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


def test_api_tp_loss_has_every_family():
    """Every family's sharded train step runs ``api.tp_loss``: the
    encoder-decoder's entry is Whisper's."""
    from repro_torch.models import whisper

    _, cfg = _cfgs()
    assert tapi._TP[tapi.family(cfg)][0] is whisper.tp_loss
    assert all(fn is not None for fn, _, _ in tapi._TP.values())
