"""The rest of the transformer zoo on the port against the JAX package:
``granite-moe-1b-a400m`` (MoE), ``deepseek-v3-671b`` (MLA, MoE with a
shared expert, MTP), ``llama3-405b`` and ``internlm2-20b`` (dense GQA),
``gemma3-4b`` (5 local : 1 global, ring caches) and ``phi-3-vision-4.2b``
(the VLM prefix), each at its smoke size.

The weights are drawn with numpy from a seed in the shapes of the
reference's tree and carried to the port with ``params_from_numpy``; the
same numpy tokens (and image embeddings) go through the reference's jitted
``loss_fn``, ``prefill`` and ``decode_step`` and the port's. gemma3's
15-token prompt is longer than its window of 8, so its local layers' rings
wrap in the prefill and again while decoding.

Tolerances, as ``tests/test_torch_models.py`` states them: in fp32 logits
rel. 1e-4, losses and their metrics rel. 1e-5, greedy tokens equal,
gradients 1e-4 of each leaf's largest magnitude (only summation orders
differ); in bf16 the port's decode against its own full forward of the
extended sequence within 5e-2 of the logits' scale (the reference's
decode-vs-full bound, ``tests/test_models_smoke.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.convert import leaf_map, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.parallel.pipeline import pipeline_loss_fn  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TServeEngine  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b", "llama3-405b", "internlm2-20b", "gemma3-4b", "phi-3-vision-4.2b")
FP32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, MAX_LEN, STEPS = 2, 15, 24, 4


def _cfgs(arch, dtype="float32"):
    over = FP32 if dtype == "float32" else {}
    return jget(arch, smoke=True).replace(**over), tget(arch, smoke=True).replace(**over)


def _numpy_params(jcfg, seed):
    """The reference's params tree filled with numpy draws: normal ·
    1/sqrt(fan-in), token embedding and router 0.02, norm weights and
    biases 0.1 · normal (non-zero, so they take part)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))

    def one(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("tok", "router"):
            scale = 0.02
        elif name in ("w", "q_norm", "kv_norm", "bq", "bk", "bv"):
            scale = 0.1
        else:
            scale = a.shape[-2] ** -0.5
        return (rng.standard_normal(a.shape) * scale).astype(np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32"):
    jcfg, tcfg = _cfgs(arch, dtype)
    tree = _numpy_params(jcfg, seed=ARCHS.index(arch))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree, device="cpu"), tree


def _batch(jcfg, seed, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (B, s)).astype(np.int32)}
    if jcfg.vlm:
        batch["img_embeds"] = rng.standard_normal((B, jcfg.n_img_tokens, jcfg.d_model)).astype(np.float32)
    return batch


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j).astype(np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "rwkv6-7b") + ARCHS + ("jamba-v0.1-52b", "whisper-tiny"))
def test_config_matches_reference(arch, smoke):
    """Every field of every ported architecture's config, its nested MoE
    and MLA configs included, is the reference's, at both sizes."""
    assert dataclasses.asdict(tget(arch, smoke=smoke)) == dataclasses.asdict(jget(arch, smoke=smoke))


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_matches_reference(arch):
    """Weights both ways, the loss and its metrics, the prefill's logits and
    cache, and four greedy decode steps."""
    jcfg, tcfg, jp, model, tree = _weights(arch)
    back = params_to_numpy(tcfg, model)
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(tree), flat(back)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert sum(p.numel() for p in model.parameters()) == sum(v.size for v in a.values())

    batch = _batch(jcfg, 1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_metrics = jax.jit(lambda p, bt: japi.loss_fn(jcfg, p, bt))(jp, jbatch)
    t_loss, t_metrics = tapi.loss_fn(tcfg, model, batch)
    assert set(t_metrics) == set(j_metrics) == {"xent", "aux", "loss"} | ({"mtp"} if jcfg.mtp_depth else set())
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    if jcfg.moe.enabled:
        assert float(t_metrics["aux"]) > 0

    j_logits, j_cache = jax.jit(lambda p, bt: japi.prefill(jcfg, p, bt, max_len=MAX_LEN))(jp, jbatch)
    t_logits, t_cache = tapi.prefill(tcfg, model, batch, max_len=MAX_LEN)
    _close(t_logits, j_logits, 1e-4)
    t_leaves = [t for g in t_cache for e in g for t in e]
    j_leaves = jax.tree.leaves(j_cache)
    assert [tuple(t.shape) for t in t_leaves] == [j.shape for j in j_leaves]
    for t, j in zip(t_leaves, j_leaves):
        _close(t, j, 1e-4)

    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(jcfg, p, c, tok, pos))
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
    assert np.array_equal(torch.argmax(t_logits, -1).numpy(), tok)
    pos = np.full((B,), S + (jcfg.n_img_tokens if jcfg.vlm else 0), np.int32)
    for _ in range(STEPS):
        j_logits, j_cache = step(jp, j_cache, jnp.asarray(tok), jnp.asarray(pos))
        t_logits, t_cache = tapi.decode_step(tcfg, model, t_cache, tok, pos)
        _close(t_logits, j_logits, 1e-4)
        tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)
        assert np.array_equal(torch.argmax(t_logits, -1).numpy(), tok)  # greedy tokens equal
        pos = pos + 1
    for t, j in zip([t for g in t_cache for e in g for t in e], jax.tree.leaves(j_cache)):
        _close(t, j, 1e-4)


def test_gemma3_rings_wrap():
    """The smoke gemma3's local layers have a ring of window 8: the cache of
    a local layer is 8 positions long and a global layer's is max_len."""
    jcfg, tcfg, _, model, _ = _weights("gemma3-4b")
    (pattern, reps), = ttf.layer_groups(tcfg)
    assert [s.window for s in pattern] == [8] * 5 + [0] and reps == 1
    cache = tapi.init_cache(tcfg, B, MAX_LEN, device="cpu")
    assert [tuple(e[0].shape) for e in cache[0]] == [(1, B, 8, 2, 16)] * 5 + [(1, B, MAX_LEN, 2, 16)]
    assert S > jcfg.sliding_window


@pytest.mark.parametrize("pos", [[3, 6], [7, 9], [20, 31]], ids=["filling", "wrapping", "wrapped"])
def test_windowed_decode_matches_reference(pos):
    """``gqa_attention_decode`` with a window: slot ``pos % T``, every slot
    valid once ``pos + 1 >= T``, the cache row written in place."""
    jcfg, tcfg = _cfgs("gemma3-4b")
    hd, nkv, T = jcfg.resolved_head_dim, jcfg.n_kv_heads, jcfg.sliding_window
    rng = np.random.default_rng(sum(pos))
    p = {k: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32) for k, s in
         {"wq": (jcfg.d_model, jcfg.n_heads * hd), "wk": (jcfg.d_model, nkv * hd), "wv": (jcfg.d_model, nkv * hd),
          "wo": (jcfg.n_heads * hd, jcfg.d_model)}.items()}
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    K0, V0 = (rng.standard_normal((B, T, nkv, hd)).astype(np.float32) for _ in range(2))
    posa = np.asarray(pos, np.int32)
    j_out, (jK, jV) = jcommon.gqa_attention_decode(jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                                   (jnp.asarray(K0), jnp.asarray(V0)), jnp.asarray(posa), window=T,
                                                   theta=jcfg.rope_theta_local)
    K, V = torch.from_numpy(K0.copy()), torch.from_numpy(V0.copy())
    t_out, (tK, tV) = tcommon.gqa_attention_decode(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                                                   torch.from_numpy(x), (K, V), torch.from_numpy(posa).long(),
                                                   window=T, theta=tcfg.rope_theta_local)
    assert tK is K and tV is V
    for t, j in ((t_out, j_out), (tK, jK), (tV, jV)):
        _close(t, j, 1e-4)


SERVE = {"granite-moe-1b-a400m": (5, 7, 9, 6), "gemma3-4b": (5, 11, 9, 14)}


@pytest.mark.parametrize("arch", sorted(SERVE))
def test_serve_engine_tokens_match_reference(arch):
    """Both packages' ``ServeEngine`` on the same prompts, token for token in
    fp32 (gemma3's prompts of 9 to 14 tokens wrap its rings of 8)."""
    jcfg, tcfg, jp, model, _ = _weights(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab, (n,)).astype(np.int32) for n in SERVE[arch]]
    outs = []
    for eng in (JServeEngine(jcfg, jp, max_batch=2, max_len=32), TServeEngine(tcfg, model, max_batch=2, max_len=32)):
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run_until_done(max_steps=200)
        assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[1] == outs[0]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b", "gemma3-4b"])
def test_bf16_decode_matches_full_forward(arch):
    """bf16 (the configs as published): prefill, two decode steps, each
    step's logits against ``lm_forward`` of the extended sequence."""
    _, tcfg, _, model, _ = _weights(arch, "bfloat16")
    tokens = _batch(tcfg, 3, s=S + 2)["tokens"]
    logits, cache = tapi.prefill(tcfg, model, {"tokens": tokens[:, :S]}, max_len=MAX_LEN)
    full, _, _, _, _ = ttf.lm_forward(tcfg, model, {"tokens": tokens})
    for i in range(2):
        logits, cache = tapi.decode_step(tcfg, model, cache, tokens[:, S + i], np.full((B,), S + i, np.int32))
        ref = full[:, S + i].float()
        scale = float(ref.abs().max())
        np.testing.assert_allclose(logits.float().numpy(), ref.numpy(), atol=5e-2 * scale, rtol=0)


class _Routes:
    """The MoE routers' top-k choices over a forward: ``mod.<name>``
    (``torch.topk`` or ``jax.lax.top_k``, which inside a forward only the
    MoE block calls) is wrapped while the context is open. Without
    ``impose`` every call's expert indices are recorded in ``calls`` (numpy
    ``(N, k)``, in call order); with it, call ``i`` takes the experts
    ``impose(i)`` instead, at its own router's probabilities."""

    def __init__(self, mod, name, impose=None):
        self.mod, self.name, self.impose, self.calls = mod, name, impose, []

    def __enter__(self):
        orig = self.orig = getattr(self.mod, self.name)

        def top_k(probs, k, *args, **kwargs):
            if self.impose is None:
                v, idx = orig(probs, k, *args, **kwargs)
                self.calls.append(np.asarray(idx))
                return v, idx
            idx = self.impose(len(self.calls))
            self.calls.append(idx)
            if self.mod is torch:
                idx = torch.tensor(idx, dtype=torch.long)
                return probs.gather(-1, idx), idx
            return jnp.take_along_axis(probs, jnp.asarray(idx), -1), jnp.asarray(idx)

        setattr(self.mod, self.name, top_k)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def _flips(a, b):
    """(layer, token) top-k expert sets that differ between two runs' calls."""
    return sum(int((np.sort(x, -1) != np.sort(y, -1)).any(-1).sum()) for x, y in zip(a, b))


def _rel(a, b):
    a, b = (x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32) for x in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _decode_vs_full(api, cfg, model, tokens, full, full_calls, n, impose: bool):
    """Prefill ``n`` tokens, decode the rest; the largest error of a step's
    logits against ``full`` at its position, and the flips of the cached
    path's choices against ``full_calls`` — or, with ``impose``, those
    choices imposed on the cached path."""
    Bn, T = tokens.shape
    L, k = len(full_calls), cfg.moe.top_k

    def choice(i):  # the full forward's choices for the cached path's i-th call
        at = slice(0, n) if i < L else slice(n + i // L - 1, n + i // L)
        return np.ascontiguousarray(full_calls[i % L].reshape(Bn, T, k)[:, at].reshape(-1, k))

    mod, name = (torch, "topk") if api is tapi else (jax.lax, "top_k")
    with _Routes(mod, name, impose=choice if impose else None) as own:
        _, cache = api.prefill(cfg, model, {"tokens": tokens[:, :n]}, max_len=T)
        worst = 0.0
        for p in range(n, T):
            logits, cache = api.decode_step(cfg, model, cache, tokens[:, p], np.full((Bn,), p, np.int32))
            worst = max(worst, _rel(logits, full[:, p]))
    return worst, _flips(own.calls, [choice(i) for i in range(len(own.calls))])


def _bf16_route_gaps(arch, seed, ref_decode=False):
    """bf16 at smoke size, the same numpy weights and tokens on both sides
    (the reference run eagerly, so that its choices can be read): the
    port's full forward against the reference's, alone and with the
    reference's choices imposed, with the flips between them; the decode
    against the full forward in the port alone and with the full forward's
    choices imposed, with its flips; with ``ref_decode``, the reference's
    own decode against its full forward and its flips as well."""
    jcfg, tcfg, jp, model, _ = _weights(arch, "bfloat16")
    tokens = np.random.default_rng(seed).integers(0, jcfg.vocab, (B, MAX_LEN)).astype(np.int32)
    out = {}
    with jax.disable_jit():
        with _Routes(jax.lax, "top_k") as jr:
            jfull = np.asarray(jtf.lm_forward(jcfg, jp, {"tokens": jnp.asarray(tokens)})[0], np.float32)
        if ref_decode:
            out["ref_dvf"], out["ref_dvf_flips"] = _decode_vs_full(japi, jcfg, jp, jnp.asarray(tokens), jfull,
                                                                   jr.calls, S, impose=False)
    run = lambda: ttf.lm_forward(tcfg, model, {"tokens": torch.from_numpy(tokens).long()})[0].float().numpy()
    with torch.no_grad():
        with _Routes(torch, "topk") as tr:
            tfull = run()
        with _Routes(torch, "topk", impose=jr.calls.__getitem__):
            tshared = run()
        t_dvf, t_flips = _decode_vs_full(tapi, tcfg, model, tokens, tfull, tr.calls, S, impose=False)
        t_dvf_shared, _ = _decode_vs_full(tapi, tcfg, model, tokens, tfull, tr.calls, S, impose=True)
    return dict(full_rel=_rel(tfull, jfull), full_flips=_flips(tr.calls, jr.calls), full_rel_shared=_rel(tshared, jfull),
                dvf=t_dvf, dvf_flips=t_flips, dvf_shared=t_dvf_shared, **out)


@pytest.mark.parametrize("arch,seed", [("granite-moe-1b-a400m", 5), ("granite-moe-1b-a400m", 10),
                                       ("deepseek-v3-671b", 0), ("deepseek-v3-671b", 3)])
def test_bf16_whole_model_gaps_are_route_flips(arch, seed):
    """A random-weight MoE in bf16 routes near-tied tokens by rounding: the
    port's bf16 full forward and decode leave 5e-2 (the reference's
    decode-vs-full bound) only where a top-k expert set differs, and with
    the other run's choices imposed both fall within 5e-2. The seeds are
    ones where a set does differ (``python tests/test_torch_zoo.py`` prints
    seeds 0-11 of both models, the reference's own decode beside)."""
    g = _bf16_route_gaps(arch, seed)
    assert g["full_flips"] or g["full_rel"] <= 5e-2, g
    assert g["dvf_flips"] or g["dvf"] <= 5e-2, g
    assert g["full_rel_shared"] <= 5e-2 and g["dvf_shared"] <= 5e-2, g
    assert g["full_flips"] + g["dvf_flips"] > 0, g  # the case exercises a flip


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-v3-671b"])
def test_train_step_gradients_match_reference(arch):
    """The single-rank grad step on MoE and MLA + MTP: the loss (xent + aux
    + 0.3 · mtp) and every gradient against ``jax.grad`` of the reference's
    loss; then one AdamW step runs."""
    jcfg, tcfg, jp, _, tree = _weights(arch)
    model = params_from_numpy(tcfg, tree, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = _batch(jcfg, 4)
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, {
        k: jnp.asarray(v) for k, v in batch.items()})[0]))(jp)
    grads, loss = ttrain.make_grad_step(tcfg)(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    jg = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
          for p, v in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    for name, (stacked, names) in leaf_map(tcfg, model).items():
        want = jg[name]
        got = np.stack([grads[n].numpy() for n in names]) if stacked else grads[names[0]].numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1e-6), rtol=0, err_msg=name)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    opt_cfg = AdamWConfig()
    opt = adamw_init(opt_cfg, dict(model.named_parameters()))
    _, _, metrics = ttrain.make_train_step(tcfg, opt_cfg)(model, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["loss"]), float(j_loss), rtol=1e-5)
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


def test_dense_only_paths_raise_for_moe():
    """The sharded step, the sharded forward and the pipeline, once dense
    only, take MoE and MLA (with MTP) configs, and the sharded step takes
    both layout hints (the name is the test's from before). On a
    one-position mesh ``tp_loss``' sums give ``lm_loss``'s xent, aux and
    MTP loss."""
    from repro_torch.core.mesh import P, make_mesh, shard_map
    from repro_torch.core.streams import StreamComm
    from repro_torch.models import moe, tp

    mesh = make_mesh((1,), ("data",), device="cpu")
    comm = StreamComm(("data",), mesh=mesh)
    for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b"):
        jcfg, tcfg, _, model, _ = _weights(arch)
        assert callable(ttrain.make_grad_step(tcfg, dp=("data",)))
        assert callable(ttrain.make_train_step(tcfg, None, dp=("data",)))
        assert callable(pipeline_loss_fn(tcfg, None, "pipe", 1, None, None, None))
        for flag in ("seq_shard_acts", "moe_dispatch_sharding"):
            assert callable(ttrain.make_grad_step(tcfg.replace(**{flag: True}), dp=("data",)))
        batch = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 1).items()}
        blocks = {n: p.detach() for n, p in model.named_parameters()}
        specs = {n: P(*([None] * p.dim())) for n, p in blocks.items()}

        def body():
            w = tp.RankWeights(blocks, specs, mesh)
            w.route = moe.GlobalRouting(comm)
            return ttf.tp_loss(tcfg, w, batch)

        sums = shard_map(body, mesh, (), P())()
        with torch.no_grad():
            _, metrics = tapi.loss_fn(tcfg, model, batch)
        xs, xc = sums["xent"]
        np.testing.assert_allclose(float(xs / xc), float(metrics["xent"]), rtol=1e-5)
        np.testing.assert_allclose(float(moe.router_aux_from_sums(tcfg, torch.stack(sums["router"]))),
                                   float(metrics["aux"]), rtol=0, atol=1e-6)
        if tcfg.mtp_depth:
            ms, mc = sums["mtp"]
            np.testing.assert_allclose(float(ms / mc), float(metrics["mtp"]), rtol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "phi-3-vision-4.2b"])
def test_trainer_runs_the_zoo(arch, tmp_path):
    """The single-rank ``Trainer`` (data pipeline, AdamW, checkpoints) on
    MLA + MoE + MTP and on the VLM prefix: its first loss is the reference's
    ``loss_fn`` on the same batch and weights, its losses stay finite, and
    its checkpoints (MTP and expert leaves included) are written."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    jcfg, tcfg, jp, model, _ = _weights(arch)
    tr = ttrain.Trainer(tcfg, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=4), DataConfig(batch=2, seq=16, seed=0),
                        ckpt_dir=str(tmp_path), ckpt_every=2, autotune=False, device="cpu")
    try:
        src = dict(model.named_parameters())
        with torch.no_grad():
            for n, p in tr.params.named_parameters():
                p.copy_(src[n])
        tr.opt_state = adamw_init(tr.opt_cfg, tr._named)
        batch = tr.pipeline.get_batch(0)
        j_loss, _ = japi.loss_fn(jcfg, jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tr.run(4, log_every=100)  # saves at step 2 and at the last step, 3
        assert len(tr.history) == 4 and all(np.isfinite(float(l)) for l in tr.history)
        np.testing.assert_allclose(float(tr.history[0]), float(j_loss), rtol=1e-5)
        assert sorted(q.name for q in tmp_path.iterdir() if q.name.startswith("step_")) == ["step_00000002",
                                                                                               "step_00000003"]
    finally:
        tr.close()


if __name__ == "__main__":  # the route-flip table behind test_bf16_whole_model_gaps_are_route_flips
    for arch in ("granite-moe-1b-a400m", "deepseek-v3-671b"):
        for seed in range(12):
            print(arch, seed, {k: round(v, 4) if isinstance(v, float) else v
                               for k, v in _bf16_route_gaps(arch, seed, ref_decode=True).items()}, flush=True)
