"""The port's roofline machinery (``repro_torch.launch.{op_cost,roofline}``)
against the JAX package's (``repro.launch.{jaxpr_cost,roofline}``), the
mirror of ``tests/test_roofline.py``: the aten-op counter's trip counts,
its exact matmul count, grad with remat, ``RooflineTerms`` on the H100's
constants, ``model_step_flops`` for every arch and shape, the smoke qwen
prefill and train step against the reference's ``step_cost``, and the
collective counter on a ``(2, 2)`` CPU mesh of thread-ranks.

``test_xla_cost_analysis_counts_loop_bodies_once`` has no counterpart: it
calibrates XLA's compiled cost analysis, which an eager PyTorch step does
not have (``launch/roofline.py`` says so). Neither has the HLO parser's
trip counts: the port counts each collective a rank issues as it runs, so
the mirror issues the 24 iterations the HLO sample's loop stands for.

Tolerances: exact, but for the smoke steps, whose FLOPs are held within
3% of the reference's (the ops differ in form: aten's fused softmax and
norms against JAX's primitives).
"""

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.jaxpr_cost import step_cost as jstep_cost  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamW  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import HW, make_host_mesh  # noqa: E402
from repro_torch.launch.op_cost import step_cost  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402

TOL = 0.03


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_op_cost_multiplies_trip_counts():
    def f(x, ws):
        c = x
        for w in ws:  # every layer runs eagerly: the trip count is the loop's
            c = torch.tanh(c @ w)
        return c

    c2 = step_cost(f, _meta(128, 128), _meta(2, 128, 128))
    c32 = step_cost(f, _meta(128, 128), _meta(32, 128, 128))
    assert abs(c32.flops / c2.flops - 16.0) < 0.5
    assert c32.flops >= 32 * 2 * 128**3


def test_op_cost_exact_for_plain_matmul():
    c = step_cost(lambda a, b: a @ b, _meta(256, 512), _meta(512, 128))
    assert c.flops == 2 * 256 * 512 * 128
    ref = jstep_cost(lambda a, b: a @ b, jax.ShapeDtypeStruct((256, 512), jnp.float32),
                     jax.ShapeDtypeStruct((512, 128), jnp.float32))
    assert c.flops == ref.flops


def test_op_cost_counts_grad_and_remat():
    from torch.utils.checkpoint import checkpoint

    w, x = _meta(64, 64).requires_grad_(True), _meta(32, 64)

    def grad(w, x):
        y = checkpoint(lambda w, x: torch.tanh(x @ w), w, x, use_reentrant=False)
        return torch.autograd.grad(torch.sum(y**2), w)

    fwd = step_cost(lambda w, x: torch.sum(torch.tanh(x @ w) ** 2), w, x)
    bwd = step_cost(grad, w, x)
    # grad-with-remat ≥ 3 matmul passes (fwd + recompute + 2 bwd products)
    assert bwd.flops >= 2.9 * fwd.flops


def test_roofline_terms_and_bottleneck():
    t = rl.RooflineTerms(
        flops=HW.PEAK_FLOPS_BF16, hbm_bytes=HW.HBM_BW / 2, coll_bytes_per_chip=HW.NVLINK_BW * 2, n_chips=256,
        model_flops=HW.PEAK_FLOPS_BF16 * 256 * 0.5,
    )
    assert abs(t.t_compute - 1.0) < 1e-6
    assert abs(t.t_memory - 0.5) < 1e-6
    assert abs(t.t_collective - 2.0) < 1e-6
    assert t.bottleneck == "collective"
    assert abs(t.useful_flops_ratio - 0.5) < 1e-6
    assert abs(t.roofline_fraction - 0.25) < 1e-6
    assert sorted(t.row()) == sorted(jrl.RooflineTerms(1.0, 1.0, 1.0, 1).row())
    assert (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.PEAK_FLOPS_FP32, HW.HBM_BYTES) == (989e12, 3.35e12, 67e12, 80 * 1024**3)


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_model_step_flops_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name in jreg.list_shapes():
        want = jrl.model_step_flops(jcfg, jreg.get_shape(name))
        assert rl.model_step_flops(tcfg, treg.get_shape(name)) == want, (arch, name)
    n = tcfg.param_counts()["active"]
    assert rl.model_step_flops(tcfg, treg.get_shape("train_4k")) == 6 * n * 256 * 4096


def _smoke(B=2, S=64):
    jcfg, tcfg = jreg.get_config("qwen1.5-0.5b", smoke=True), treg.get_config("qwen1.5-0.5b", smoke=True)
    jbatch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    tbatch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    return jcfg, tcfg, japi.abstract_params(jcfg), tapi.abstract_params(tcfg), jbatch, tbatch


def test_smoke_prefill_flops_match_reference():
    """The reference's prefill computes every position's logits and keeps
    the last; the port's computes the last only (``transformer.prefill``),
    so the reference's count is the port's plus the skipped rows of the
    output projection, 2·B·(S−1)·d·vocab."""
    B, S = 2, 64
    jcfg, tcfg, jp, model, jbatch, tbatch = _smoke(B, S)
    want = jstep_cost(jtrain.make_prefill_step(jcfg), jp, jbatch)
    got = step_cost(ttrain.make_prefill_step(tcfg), model, tbatch)
    skipped = 2 * B * (S - 1) * tcfg.d_model * tcfg.vocab
    print(f"prefill flops port {got.flops} + skipped logits {skipped} vs reference {want.flops}; "
          f"bytes port {got.bytes} vs reference {want.bytes}")
    assert abs(got.flops + skipped - want.flops) <= TOL * want.flops


def test_smoke_train_step_flops_match_reference():
    jcfg, tcfg, jp, model, jbatch, tbatch = _smoke()
    jopt = jax.eval_shape(lambda p: jadamw_init(JAdamW(), p), jp)
    want = jstep_cost(jtrain.make_train_step(jcfg, JAdamW()), jp, jopt, jbatch)
    model.requires_grad_(True)
    opt = adamw_init(AdamWConfig(), dict(model.named_parameters()))
    got = step_cost(ttrain.make_train_step(tcfg, AdamWConfig()), model, opt, tbatch)
    print(f"train flops port {got.flops} vs reference {want.flops}; bytes port {got.bytes} vs reference {want.bytes}")
    assert abs(got.flops - want.flops) <= TOL * want.flops


def test_count_collectives_per_op_bytes():
    """The HLO sample of ``tests/test_roofline.py`` run as thread-ranks: 24
    iterations of an all-reduce and an all-gather of 16 fp32 each, one
    reduce-scatter and one permute of 16 fp32 — 64 operand bytes per op
    per rank, the reference's convention."""
    from repro_torch.core.collectives import all_gather, all_reduce, ppermute, reduce_scatter
    from repro_torch.core.mesh import P, shard_map
    from repro_torch.core.streams import StreamComm

    mesh = make_host_mesh((2, 2), device="cpu")

    def body(x):
        data, everyone = StreamComm(("data",), mesh=mesh), StreamComm(("data", "model"), mesh=mesh)
        for _ in range(24):
            y, _ = all_reduce(x, everyone)
            g, _ = all_gather(y, data)
        rs, _ = reduce_scatter(x, data)
        cp, _ = ppermute(x, data, [(0, 1), (1, 0)])
        return g[:1] + rs[:1] + cp[:1]

    with rl.count_collectives() as counted:
        shard_map(body, mesh, P(), P())(torch.ones(16))
    assert sorted(counted.per_rank) == [0, 1, 2, 3]
    for stats in counted.per_rank.values():
        assert stats.per_op_bytes == {"all-reduce": 24 * 64, "all-gather": 24 * 64, "reduce-scatter": 64,
                                      "collective-permute": 64}
        assert stats.per_op_count["all-reduce"] == 24
    chip = counted.per_chip()
    assert chip.total_bytes == 50 * 64 and "all-reduce: 24 ops" in chip.summary()


def test_kernel_wrappers_raise_on_meta():
    """A kernel has no meta version: its wrapper raises on meta tensors, so
    a counted step takes the einsum path (each config's default)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6_scan import wkv6

    q = torch.empty((1, 128, 4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        flash_attention(q, q, q)
    w = torch.empty((1, 64, 2, 64), device="meta")
    with pytest.raises(ValueError, match="meta"):
        wkv6(w, w, w, w, torch.empty((2, 64), device="meta"), torch.empty((1, 2, 64, 64), device="meta"))
    assert treg.get_config("qwen1.5-0.5b").attn_impl == "einsum"


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_meta_scan_counts_every_token(arch):
    """The per-token loops (RWKV-6's WKV, Mamba's scan) run one step on
    meta tensors standing for all S: a 64-token prefill's outputs keep
    their shapes and its count equals the count of the real loop on CPU
    tensors (within 1e-4: the CPU's index checks run an ``aminmax`` where
    meta runs an ``eq``); the train step at S = 256 (Mamba's per-128-step
    checkpoint recomputing its chunks) is within 6% of the reference's
    ``step_cost``, whose ``lax.scan`` bodies count once per step."""
    from repro_torch.launch.op_cost import OpCounter

    B, S = 2, 256
    jcfg, tcfg = jreg.get_config(arch, smoke=True), treg.get_config(arch, smoke=True)
    meta = tapi.abstract_params(tcfg)
    real = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.zeros((B, 64), dtype=torch.int32)
    outs = []
    for model, tokens in ((meta, prompt.to("meta")), (real, prompt)):
        with torch.no_grad(), OpCounter() as counted:
            logits, cache = ttrain.make_prefill_step(tcfg)(model, {"tokens": tokens})
        outs.append((counted.cost.flops, tuple(logits.shape),
                     [tuple(t.shape) for t in jax.tree_util.tree_leaves(cache) if isinstance(t, torch.Tensor)]))
    (got, *meta_shapes), (want, *real_shapes) = outs
    assert abs(got - want) <= 1e-4 * want and meta_shapes == real_shapes

    jp = japi.abstract_params(jcfg)
    jopt = jax.eval_shape(lambda p: jadamw_init(JAdamW(), p), jp)
    ref = jstep_cost(jtrain.make_train_step(jcfg, JAdamW()), jp, jopt, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    meta.requires_grad_(True)
    opt = adamw_init(AdamWConfig(), dict(meta.named_parameters()))
    got = step_cost(ttrain.make_train_step(tcfg, AdamWConfig()), meta, opt,
                    {"tokens": torch.zeros((B, S), dtype=torch.int32, device="meta")})
    print(f"{arch} train flops port {got.flops} vs reference {ref.flops}")
    assert abs(got.flops - ref.flops) <= 0.06 * ref.flops


def test_op_counter_shared_by_many_thread_ranks():
    """32 thread-ranks (more than the cores) on a meta mesh share one
    counter, with the interpreter switching threads every microsecond:
    every rank's ops are counted exactly once (a lost update would show)
    and every byte they allocate is freed again."""
    import sys

    from repro_torch.core.collectives import all_reduce
    from repro_torch.core.mesh import P, shard_map
    from repro_torch.core.streams import StreamComm
    from repro_torch.launch.op_cost import OpCounter

    mesh = make_host_mesh((4, 8), device="meta")

    def body(x):
        for _ in range(50):
            x = x * 2.0 + 1.0
        total, _ = all_reduce(x, StreamComm(("data", "model"), mesh=mesh))  # 31 adds of 64 each
        return total

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with OpCounter(track_memory=True) as counted:
            out = shard_map(body, mesh, P(), P())(torch.empty(64, device="meta"))
    finally:
        sys.setswitchinterval(interval)
    assert out.shape == (64,)
    assert counted.cost.flops == 32 * (50 * 2 + 31) * 64
    assert counted.by_op["mul"].flops == counted.by_op["add"].flops - 32 * 31 * 64 == 32 * 50 * 64
    del out
    assert counted.live_bytes == 0 and counted.peak_bytes >= 32 * 64 * 4
