"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's, and the port's sharded tensors.

The reference's specs are computed on its abstract params
(``jax.eval_shape``), the port's on a model built on
``torch.device("meta")``, at smoke and full width, for ``qwen1.5-0.5b`` and
``rwkv6-7b``, on the ``(2, 16, 16)`` and ``(16, 16)`` meshes (only the
axis names and sizes are read, so a stand-in mesh serves), with the
baseline layout, ``fsdp`` and ``tp_strategy="ep_only"``; the parameter and
moment specs also for ``granite-moe-1b-a400m`` (MoE) and
``deepseek-v3-671b`` (MLA, MoE with a shared expert, MTP). A port spec must
equal the reference's spec of the stacked leaf with the stacking entry
dropped; ``models.convert.leaf_map`` pairs the names. Exact equality.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_config as jget
from repro.models import api as japi
from repro.parallel import sharding as js
from repro_torch.configs import get_config
from repro_torch.core.mesh import NamedSharding, P, ShardedTensor, device_put, make_mesh, shard_map
from repro_torch.models import rwkv6 as trwkv, transformer as ttf
from repro_torch.models.convert import leaf_map
from repro_torch.parallel import sharding as ts


class _StubMesh:
    def __init__(self, names, shape):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = {"2x16x16": (("pod", "data", "model"), (2, 16, 16)), "16x16": (("data", "model"), (16, 16))}
VARIANTS = {"base": {}, "fsdp": {"fsdp": True}, "ep_only": {"tp_strategy": "ep_only"}}


def _norm(spec):
    """A spec as a tuple, a one-axis tuple written as the axis (JAX's form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _axes(spec):
    return [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]


@functools.lru_cache(maxsize=None)
def _abstract(arch, smoke, variant):
    return japi.abstract_params(jget(arch, smoke=smoke).replace(**VARIANTS[variant]))


def _meta_model(cfg):
    cls = trwkv.RWKVLM if cfg.family == "ssm_rwkv" else ttf.TransformerLM
    return cls(cfg, torch.device("meta"))


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {js._path_str(p): s for p, s in leaves}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b", "granite-moe-1b-a400m", "deepseek-v3-671b"])
def test_param_and_moment_specs_match_reference(arch, smoke, mesh_name, variant):
    mesh = _StubMesh(*MESHES[mesh_name])
    jcfg = jget(arch, smoke=smoke).replace(**VARIANTS[variant])
    cfg = get_config(arch, smoke=smoke).replace(**VARIANTS[variant])
    pabs = _abstract(arch, smoke, variant)
    jp = js.param_specs(jcfg, pabs, mesh)
    ref_p, ref_o = _flat(jp), _flat(js.opt_state_specs(jcfg, jp, pabs, mesh))
    model = _meta_model(cfg)
    tp = ts.param_specs(cfg, model, mesh)
    to = ts.opt_state_specs(cfg, tp, model, mesh)
    params = dict(model.named_parameters())
    assert set(tp) == set(params) == set(to)
    twice = 0
    for name, (stacked, names) in leaf_map(cfg, model).items():
        ndim = params[names[0]].dim() + stacked
        for ref, port in ((ref_p[name], tp), (ref_o[name], to)):
            want = _norm(ref) + (None,) * (ndim - len(ref))
            if stacked:
                want = want[1:]  # the port's per-layer parameter has no stacking dim
            for n in names:
                if len(set(_axes(ref))) != len(_axes(ref)):
                    # FSDP + ZeRO-1: the reference names the dp axes twice,
                    # a spec JAX refuses to use; the port keeps the param spec
                    assert variant == "fsdp" and port is to and to[n] == tp[n], (name, ref)
                    twice += 1
                else:
                    assert tuple(port[n]) == want, (name, tuple(port[n]), want)
    if variant != "fsdp":
        assert twice == 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_specs_match_reference(mesh_name):
    mesh = _StubMesh(*MESHES[mesh_name])
    shapes = {"tokens": (32, 128), "loss_mask": (32, 128), "img_embeds": (32, 16, 64)}
    ref = js.batch_specs(None, {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in shapes.items()}, mesh)
    got = ts.batch_specs(None, {k: torch.empty(s, device="meta") for k, s in shapes.items()}, mesh)
    assert {k: tuple(v) for k, v in got.items()} == {k: _norm(v) for k, v in ref.items()}


@pytest.mark.parametrize("seq_axis_model", [True, False])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-7b"])
def test_cache_specs_match_reference(arch, smoke, mesh_name, seq_axis_model):
    mesh = _StubMesh(*MESHES[mesh_name])
    jcfg, cfg = jget(arch, smoke=smoke), get_config(arch, smoke=smoke)
    B, T = 32, 512
    ref_cache = jax.eval_shape(lambda: japi.init_cache(jcfg, B, T))
    meta = torch.device("meta")
    cache = trwkv.init_state(cfg, B, T, meta) if cfg.family == "ssm_rwkv" else ttf.init_cache(cfg, B, T, meta)
    ref = js.cache_specs(jcfg, ref_cache, mesh, seq_axis_model)
    got = ts.cache_specs(cfg, cache, mesh, seq_axis_model)
    ref_leaves = jax.tree_util.tree_leaves(ref, is_leaf=lambda x: isinstance(x, PartitionSpec))
    got_leaves = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, P))
    assert len(ref_leaves) == len(got_leaves) > 0
    assert [tuple(g) for g in got_leaves] == [_norm(r) for r in ref_leaves]


def test_rule_table_and_dp_axes_match_reference():
    assert ts.logical_rules(None) == js.logical_rules(None)
    for names, shape in MESHES.values():
        assert ts.dp_axes(_StubMesh(names, shape)) == js.dp_axes(_StubMesh(names, shape))


# ----------------------------------------------------------------------
# specs on any dim, sharded tensors
# ----------------------------------------------------------------------


@pytest.mark.parametrize("spec", [P(), P("model"), P(None, "model"), P(("pod", "data"), "model"),
                                  P("model", ("pod", "data")), P(None, ("data", "pod"))])
def test_device_put_blocks_and_shard_map_round_trip(spec):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    st = device_put(x, NamedSharding(mesh, spec))
    assert isinstance(st, ShardedTensor) and st.shape == (8, 12)
    for slot, b in enumerate(st.blocks):
        assert torch.equal(b, x[st.index(slot)])
        assert b.data_ptr() != x.data_ptr()  # each position holds its own copy
    assert torch.equal(st.gather(), x)
    assert sum(b.numel() for _, b in st.shards()) == x.numel()  # every element once
    assert torch.equal(shard_map(lambda a: a + 0, mesh, spec, spec)(x), x)


def test_specs_reject_an_axis_twice_and_bad_splits():
    with pytest.raises(ValueError, match="at most one dim"):
        P("data", ("pod", "data"))
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        device_put(torch.ones(3, 4), NamedSharding(mesh, P("data")))
    with pytest.raises(ValueError, match="not in mesh"):
        NamedSharding(mesh, P("pod"))
