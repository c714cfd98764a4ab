"""The port's sharded serve steps against the JAX package: the sharded
prefill and four greedy sharded decode steps (``launch.train``'s
``make_prefill_step``/``make_serve_step`` on params under ``param_specs``
and caches under ``cache_specs``: tensor-parallel over ``model``,
sequence-parallel decode, ``models.tp``) on CPU meshes of thread-ranks,
held against the reference's single-device ``api.prefill`` and
``api.decode_step`` under ``jax.jit`` on the same numpy weights and tokens
(GSPMD does not change values, so this is the reference's sharded
function), fp32 at smoke size.

Tolerances: the last logits and every decode step's logits within 1e-4 of
the reference's scale, the greedy tokens equal, and every rank's cache
block within 1e-5 of the leaf's scale of the reference cache's shard under
``cache_specs`` (the same index). The cases cover the leaf rule's routes:
qwen on ``(2, 2, 2)``, on ``(2, 4)`` (one head a rank) and on ``(8,)``
(no dp axis; half the ranks hold no head), llama3's 2 kv
heads on 4 ranks (each rank computes the kv head its q head reads),
internlm2's 6 heads on 4 ranks (uneven shares), a decode whose rows cross
a ``T/model`` boundary at different steps (``pos`` differs per row), the
flash route (S = 128, the kernel's plain version on each rank), granite's
experts over ``model``, gemma3's local rings wrapping (2 slots a rank),
phi-3's image prefix, deepseek's MLA latent cache, whisper's cross cache,
rwkv6 with its heads over ``model`` and replicated, and jamba's Mamba
``d_inner`` share under the concatenated ``in_proj``.

One case runs the reference's own sharded steps in an 8-device
``AxisType.Auto`` subprocess (``jax.jit`` with the ``in_shardings`` and
``out_shardings`` of ``src/repro/launch/dryrun.py``) and holds its logits
and its output cache's shard shapes to the port's.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core.mesh import P  # noqa: E402

FP32 = dict(param_dtype="float32", compute_dtype="float32")
B, S, MAX_LEN, STEPS = 4, 15, 24, 4


def _numpy_tree(jcfg, seed):
    """The reference's params tree as numpy draws: normal · 1/sqrt(fan-in),
    ``tok``/``router`` 0.02, norm-like leaves and biases 0.1 · normal
    (layernorm weights and RWKV's ``ln_x`` 1 + 0.1 · normal), RWKV's decay
    base and mixing coefficients and Mamba's fixed leaves at their init
    values plus 0.1 · normal."""
    from repro.models import api as japi

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: japi.init_params(jcfg, jax.random.key(0)))
    fixed = {"w0": -6.0, "mu_x": 0.5, "mu_wkvrg": 0.5, "mu_k_c": 0.5, "mu_r_c": 0.5, "D": 1.0, "dt_bias": -4.6}

    def one(path, a):
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
        elif name in ("w", "b", "bq", "bk", "bv", "q_norm", "kv_norm", "dt_norm", "b_norm", "c_norm", "conv_b",
                      "b_in", "b_out"):
            v = 0.1 * n
        else:
            v = n * a.shape[-2] ** -0.5
        return v.astype(np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _batch(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.vlm:
        batch["img_embeds"] = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encdec:
        batch["enc_frames"] = rng.standard_normal((B, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
    return batch


def _offset(cfg):
    return cfg.n_img_tokens if cfg.vlm else 0


@functools.lru_cache(maxsize=None)
def _reference(arch, s, max_len, stagger):
    """The reference's prefill and ``STEPS`` greedy decode steps under
    ``jax.jit``: (numpy weights tree, batch, last logits, per-step logits,
    per-step tokens fed, per-step positions, final cache leaves). With
    ``stagger`` row r decodes at ``pos + r``."""
    from repro.configs import get_config
    from repro.models import api as japi

    jcfg = get_config(arch, smoke=True).replace(**FP32)
    tree = _numpy_tree(jcfg, seed=sum(map(ord, arch)))
    jp = jax.tree.map(jnp.asarray, tree)
    batch = _batch(jcfg, 7, s)
    logits, cache = jax.jit(lambda p, bt: japi.prefill(jcfg, p, bt, max_len=max_len))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(jcfg, p, c, tok, pos))
    pos = np.full((B,), s + _offset(jcfg), np.int32) + (np.arange(B, dtype=np.int32) if stagger else 0)
    steps, toks, poss = [], [], []
    tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for _ in range(STEPS):
        toks.append(tok)
        poss.append(pos)
        out, cache = step(jp, cache, jnp.asarray(tok), jnp.asarray(pos))
        steps.append(np.asarray(out))
        tok = np.asarray(jnp.argmax(out, -1)).astype(np.int32)
        pos = pos + 1
    return tree, batch, np.asarray(logits), steps, toks, poss, [np.asarray(a) for a in jax.tree.leaves(cache)]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _sharded(arch, mesh_shape, names, attn_impl="einsum"):
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import device_put, make_mesh
    from repro_torch.launch.train import named
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd

    cfg = get_config(arch, smoke=True).replace(attn_impl=attn_impl, **FP32)
    mesh = make_mesh(mesh_shape, names, device="cpu")
    return cfg, mesh, lambda model: device_put({n: p.detach() for n, p in model.named_parameters()},
                                               named(mesh, shd.param_specs(cfg, api.abstract_params(cfg), mesh)))


def _close(got, want, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.max(np.abs(got - want)) <= tol * scale, (what, float(np.max(np.abs(got - want))), scale)


def _hold_blocks(cache, want_leaves, what):
    """Every rank's block of every cache leaf against the reference leaf's
    shard at the same index."""
    got = _leaves(cache)
    assert len(got) == len(want_leaves), what
    for i, (st, want) in enumerate(zip(got, want_leaves)):
        assert st.shape == want.shape, (what, i, st.shape, want.shape)
        for slot, block in enumerate(st.blocks):
            _close(block, want[st.index(slot)], 1e-5, f"{what}: leaf {i} rank {slot}")


CASES = {
    "qwen-2x2x2": ("qwen1.5-0.5b", (2, 2, 2), ("pod", "data", "model"), {}),
    "qwen-2x4": ("qwen1.5-0.5b", (2, 4), ("data", "model"), {}),
    "qwen-2x4-stagger": ("qwen1.5-0.5b", (2, 4), ("data", "model"), dict(stagger=True)),
    "qwen-2x4-flash": ("qwen1.5-0.5b", (2, 4), ("data", "model"), dict(attn_impl="flash", s=128, max_len=136)),
    "qwen-8-model": ("qwen1.5-0.5b", (8,), ("model",), {}),
    "llama3-2x4": ("llama3-405b", (2, 4), ("data", "model"), {}),
    "internlm2-2x4": ("internlm2-20b", (2, 4), ("data", "model"), {}),
    "granite-2x4": ("granite-moe-1b-a400m", (2, 4), ("data", "model"), {}),
    "granite-2x2x2": ("granite-moe-1b-a400m", (2, 2, 2), ("pod", "data", "model"), {}),
    "gemma3-2x4": ("gemma3-4b", (2, 4), ("data", "model"), {}),
    "phi3-2x4": ("phi-3-vision-4.2b", (2, 4), ("data", "model"), dict(max_len=28)),
    "deepseek-2x4": ("deepseek-v3-671b", (2, 4), ("data", "model"), {}),
    "whisper-2x4": ("whisper-tiny", (2, 4), ("data", "model"), {}),
    "rwkv6-2x2x2": ("rwkv6-7b", (2, 2, 2), ("pod", "data", "model"), {}),
    "rwkv6-2x4": ("rwkv6-7b", (2, 4), ("data", "model"), {}),
    "jamba-2x2x2": ("jamba-v0.1-52b", (2, 2, 2), ("pod", "data", "model"), {}),
    "jamba-2x4": ("jamba-v0.1-52b", (2, 4), ("data", "model"), {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_serve_matches_reference(case):
    from repro_torch.launch.train import make_prefill_step, make_serve_step
    from repro_torch.models.convert import params_from_numpy

    arch, shape, names, kw = CASES[case]
    s, max_len = kw.get("s", S), kw.get("max_len", MAX_LEN)
    tree, batch, j_logits, j_steps, j_toks, j_pos, j_cache = _reference(arch, s, max_len, kw.get("stagger", False))
    cfg, mesh, put = _sharded(arch, shape, names, kw.get("attn_impl", "einsum"))
    params = put(params_from_numpy(cfg, tree, device="cpu"))
    logits, cache = make_prefill_step(cfg)(params, {k: torch.from_numpy(v) for k, v in batch.items()}, max_len)
    _close(logits, j_logits, 1e-4, "prefill logits")
    assert np.array_equal(torch.argmax(logits, -1).numpy(), j_toks[0])
    serve = make_serve_step(cfg)
    for i in range(STEPS):
        out, cache = serve(params, cache, torch.from_numpy(j_toks[i]), torch.from_numpy(j_pos[i]))
        _close(out, j_steps[i], 1e-4, f"decode step {i}")
        if i + 1 < STEPS:
            assert np.array_equal(torch.argmax(out, -1).numpy(), j_toks[i + 1]), f"step {i}: greedy tokens"
    _hold_blocks(cache, j_cache, case)


def test_stagger_crosses_rank_spans():
    """The staggered case's rows write into three ranks' ``T`` spans over
    the steps, row 3 crossing into the last span a step before row 0."""
    pos = np.stack(_reference("qwen1.5-0.5b", S, MAX_LEN, True)[5])
    owner = pos // (MAX_LEN // 4)
    assert set(owner.ravel()) == {2, 3} and (owner[:, 0] == 2).sum() > (owner[:, 3] == 2).sum()


@pytest.mark.parametrize("knob", ["seq_shard_acts", "moe_dispatch_sharding"])
def test_sharded_serve_refuses_layout_hints(knob):
    """Each layout hint in the sharded serve steps (granite on ``(2, 2)``
    ``("data", "model")``, the rows split over ``data``): the prefill's
    logits and cache blocks and three decode steps' logits equal the
    hint-free steps' (1e-6), and the prefill counts the hint's collectives
    over its axis: reduce-scatters over ``model`` (the 16-token prompt
    splits over ``model``; decode's one token does not), or all-to-alls
    over ``data`` (the prefill's 32 tokens give ``C = 32``, ``C % 16 ==
    0``). (The test's name is the refusal it held before the hints were
    laid out.)"""
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.train import make_prefill_step, make_serve_step

    cfg, mesh, put = _sharded("granite-moe-1b-a400m", (2, 2), ("data", "model"))
    params = put(api_init(cfg))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)))
    runs = []
    for c in (cfg, cfg.replace(**{knob: True})):
        with rl.count_collectives() as coll:
            logits, cache = make_prefill_step(c)(params, {"tokens": tokens}, 24)
        steps, tok = [], torch.argmax(logits, -1)
        for i in range(3):
            out, cache = make_serve_step(c)(params, cache, tok, torch.full((2,), 16 + i))
            steps.append(out)
            tok = torch.argmax(out, -1)
        runs.append((logits, cache, steps, coll.by_axes[0]))
    (l0, c0, s0, k0), (l1, c1, s1, k1) = runs
    _close(l1, l0.numpy(), 1e-6, "prefill logits")
    for a, b in zip(_leaves(c1), _leaves(c0)):
        for slot in range(mesh.size):
            _close(a.blocks[slot], b.blocks[slot].numpy(), 1e-6, "cache block")
    for i, (a, b) in enumerate(zip(s1, s0)):
        _close(a, b.numpy(), 1e-6, f"decode step {i}")
    if knob == "seq_shard_acts":
        assert k1.get(("reduce-scatter", ("model",)), 0) == 2 * cfg.n_layers
        assert k1.get(("all-reduce", ("model",)), 0) < k0[("all-reduce", ("model",))]
    else:
        assert k1.get(("all-to-all", ("data",)), 0) == 2 * cfg.n_layers and ("all-to-all", ("data",)) not in k0


def api_init(cfg):
    from repro_torch.models import api

    return api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def test_shard_cache_lays_out_cache_specs():
    """``shard_cache`` is ``device_put(init_cache(...), named(mesh,
    cache_specs))``: zero blocks of the specs' shapes on every rank."""
    from repro_torch.launch.train import shard_cache
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd

    cfg, mesh, _ = _sharded("gemma3-4b", (2, 4), ("data", "model"))
    cache = shard_cache(cfg, mesh, 4, 24)
    specs = _leaves(shd.cache_specs(cfg, api.init_cache(cfg, 4, 24, device="meta"), mesh))
    for st, spec in zip(_leaves(cache), specs):
        assert st.sharding.spec == spec and all(not b.any() for b in st.blocks)
    assert {tuple(st.blocks[0].shape[1:3]) for st in _leaves(cache)} == {(2, 2), (2, 6)}  # rings of 8, T of 24


def test_merge_attend_is_softmax_attention():
    """``merge_attend``'s log-sum-exp merge over 4 ranks' slot spans equals
    one softmax over all of them, a span with no valid slot included."""
    from repro_torch.core.mesh import make_mesh, shard_map
    from repro_torch.models import tp
    from repro_torch.models.common import attend

    g = torch.Generator().manual_seed(3)
    q, K, V = (torch.randn(shape, generator=g) for shape in ((2, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8)))
    valid = torch.arange(16)[None, :] <= torch.tensor([[5], [9]])  # the last two spans of row 0 hold none
    mesh = make_mesh((4,), ("model",), device="cpu")

    def body(k, v, m):
        w = tp.RankWeights({}, {}, mesh)
        return tp.merge_attend(w, q, k, v, m, 0.3, split=True)

    got = shard_map(body, mesh, (P(None, "model"), P(None, "model"), P(None, "model")), P())(K, V, valid)
    want = attend(q[:, None], K, V, valid[:, None, None, None, :], 0.3)[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the reference's own sharded steps (8-device subprocess)
# ----------------------------------------------------------------------

ORACLE = ("qwen1.5-0.5b", (2, 4), ("data", "model"))


def _oracle_main(in_path: str, out_path: str) -> None:
    """Subprocess entry: the reference's jitted sharded prefill (T = S) and
    one sharded decode step over a ``MAX_LEN`` cache, with the dry run's
    ``in_shardings``/``out_shardings``, on 8 forced host devices."""
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_config
    from repro.launch.train import make_prefill_step, make_serve_step, named
    from repro.models import api as japi
    from repro.parallel import sharding as shd

    arch, shape, names = ORACLE
    cfg = get_config(arch, smoke=True).replace(**FP32)
    flat = dict(np.load(in_path))
    tree = _numpy_tree(cfg, seed=sum(map(ord, arch)))
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)
    params = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat["p/" + jax.tree_util.keystr(p)]) for p, _ in paths])
    batch = {"tokens": jnp.asarray(flat["tokens"])}
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    pspecs = shd.param_specs(cfg, params, mesh)
    bspecs = shd.batch_specs(cfg, batch, mesh)
    out = {}
    with mesh:
        cache_abs = jax.eval_shape(lambda: japi.init_cache(cfg, B, S))
        prefill = jax.jit(make_prefill_step(cfg), in_shardings=(named(mesh, pspecs), named(mesh, bspecs)),
                          out_shardings=(None, named(mesh, shd.cache_specs(cfg, cache_abs, mesh))))
        logits, cache = prefill(params, batch)
        out["prefill_logits"] = np.asarray(logits)
        for i, leaf in enumerate(jax.tree.leaves(cache)):
            out[f"prefill_shard/{i}"] = np.asarray(leaf.addressable_shards[0].data.shape)
        _, full = jax.jit(lambda p, b: japi.prefill(cfg, p, b, max_len=MAX_LEN))(params, batch)
        cspecs = shd.cache_specs(cfg, full, mesh)
        full = jax.device_put(full, named(mesh, cspecs))
        tok_sh = NamedSharding(mesh, JP(shd.dp_axes(mesh)))
        step = jax.jit(make_serve_step(cfg), in_shardings=(named(mesh, pspecs), named(mesh, cspecs), tok_sh, tok_sh),
                       out_shardings=(None, named(mesh, cspecs)))
        logits, cache = step(params, full, jnp.asarray(flat["tok"]), jnp.asarray(flat["pos"]))
        out["decode_logits"] = np.asarray(logits)
        for i, leaf in enumerate(jax.tree.leaves(cache)):
            out[f"decode_shard/{i}"] = np.asarray(leaf.addressable_shards[0].data.shape)
    np.savez(out_path, **out)


def test_reference_sharded_steps_match_port(tmp_path):
    from repro_torch.launch.train import make_prefill_step, make_serve_step
    from repro_torch.models.convert import params_from_numpy

    arch, shape, names = ORACLE
    tree, batch, _, _, j_toks, j_pos, _ = _reference(arch, S, MAX_LEN, False)
    flat = {"p/" + jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(tmp_path / "in.npz", tokens=batch["tokens"], tok=j_toks[0], pos=j_pos[0], **flat)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), str(tmp_path / "in.npz"),
                           str(tmp_path / "out.npz")], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = np.load(tmp_path / "out.npz")

    cfg, mesh, put = _sharded(arch, shape, names)
    params = put(params_from_numpy(cfg, tree, device="cpu"))
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    logits, cache = make_prefill_step(cfg)(params, tb)  # T = S, as the reference's step
    _close(logits, ref["prefill_logits"], 1e-4, "sharded prefill logits")
    assert [tuple(st.blocks[0].shape) for st in _leaves(cache)] == [
        tuple(ref[f"prefill_shard/{i}"]) for i in range(len(_leaves(cache)))]
    _, cache = make_prefill_step(cfg)(params, tb, MAX_LEN)
    logits, cache = make_serve_step(cfg)(params, cache, torch.from_numpy(j_toks[0]), torch.from_numpy(j_pos[0]))
    _close(logits, ref["decode_logits"], 1e-4, "sharded decode logits")
    assert [tuple(st.blocks[0].shape) for st in _leaves(cache)] == [
        tuple(ref[f"decode_shard/{i}"]) for i in range(len(_leaves(cache)))]


if __name__ == "__main__":
    _oracle_main(sys.argv[1], sys.argv[2])
