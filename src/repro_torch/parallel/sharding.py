"""Sharding rules: param/batch/cache partition specs per architecture.

The port of ``repro.parallel.sharding``: one rule table, pattern-matched on
the reference's leaf names, covers the zoo; rules describe the TRAILING
dims and leading dims get ``None``.

Baseline layout (single-pod ``(data=16, model=16)``; multi-pod adds a
leading ``"pod"`` axis folded into data-parallel):

* TP over ``"model"``: attention heads / FFN hidden / experts / vocab;
* DP over ``("pod", "data")``: batch dims of activations and inputs;
* decode KV caches: batch over ``"data"``, cache length T over ``"model"``.

**Layers.** The reference stacks the layers of a group on a leading axis
and shards the stacked leaf; the port keeps one module per layer. A port
param spec is the reference's spec of the stacked leaf with the leading
stacking entry dropped, given per parameter name of
``model.named_parameters()``; ``repro_torch.models.convert.leaf_map`` is
the bridge between the two trees' names. Every rule is applied to the
stacked shape, as in the reference, so the divisibility checks and the
FSDP and ZeRO-1 dim choices are the reference's. Where ZeRO-1 puts the dp
axes on the stacking dim itself (the layer count divides by the dp size),
layer ``l``'s moment spec is a ``core.mesh.StackRow``: the layer's own
dims laid out as its param's, held only by dp rank ``l // (L / n_dp)``,
whose block of the reference's stacked moment holds row ``l``.

Shapes come from the module's parameters, so a model built on
``torch.device("meta")`` gives full-width specs without allocating
(the reference's ``jax.eval_shape``). Meshes need only ``axis_names`` and
``shape``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

from repro_torch.core.mesh import P, StackRow
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import leaf_map

__all__ = [
    "dp_axes",
    "param_specs",
    "batch_specs",
    "cache_specs",
    "opt_state_specs",
    "logical_rules",
]

M = "model"


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: ('pod','data') on the multi-pod mesh."""
    names = tuple(mesh.axis_names)
    return tuple(a for a in names if a in ("pod", "data"))


# rule table: (leaf-name regex, trailing-dim spec entries)
# entries may be None, "model", or "dp" (replaced by the dp axes tuple)
_RULES = [
    # embeddings
    (r"embed/tok$", ("model", None)),
    (r"embed/out$", (None, "model")),
    (r"img_proj$", (None, None)),
    # attention (gqa)
    (r"attn/wq$", (None, "model")),
    (r"attn/wk$", (None, "model")),
    (r"attn/wv$", (None, "model")),
    (r"attn/wo$", ("model", None)),
    (r"attn/b[qkv]$", ("model",)),
    (r"xattn/wq$", (None, "model")),
    (r"xattn/wk$", (None, "model")),
    (r"xattn/wv$", (None, "model")),
    (r"xattn/wo$", ("model", None)),
    (r"xattn/b[qkv]$", ("model",)),
    # MLA
    (r"attn/wq_a$", (None, None)),
    (r"attn/wq_b$", (None, "model")),
    (r"attn/wkv_a$", (None, None)),
    (r"attn/wkv_b$", (None, "model")),
    (r"attn/(q_norm|kv_norm)$", (None,)),
    # dense MLPs
    (r"(ffn|mlp|shared)/w_gate$", (None, "model")),
    (r"(ffn|mlp|shared)/w_up$", (None, "model")),
    (r"(ffn|mlp|shared)/w_down$", ("model", None)),
    (r"mlp/w_in$", (None, "model")),
    (r"mlp/b_in$", ("model",)),
    (r"mlp/w_out$", ("model", None)),
    (r"mlp/b_out$", (None,)),
    # MoE (leading experts dim → EP); we_* keys are the expert stacks
    (r"ffn/router$", (None, None)),
    (r"ffn/we_(gate|up|down)$", ("model", None, None)),
    # RWKV6
    (r"w[rkvg]$", (None, "model")),
    (r"wo$", ("model", None)),
    (r"maa_w1$", (None, None)),
    (r"maa_w2$", (None, None, None)),
    (r"decay_w[12]$", (None, None)),
    (r"bonus$", ("model", None)),
    (r"wk_c$", (None, "model")),
    (r"wv_c$", ("model", None)),
    (r"wr_c$", (None, "model")),
    # Mamba
    (r"mixer/in_proj$", (None, "model")),
    (r"mixer/conv_w$", (None, "model")),
    (r"mixer/conv_b$", ("model",)),
    (r"mixer/x_proj$", ("model", None)),
    (r"mixer/dt_proj$", (None, "model")),
    (r"mixer/dt_bias$", ("model",)),
    (r"mixer/A_log$", ("model", None)),
    (r"mixer/D$", ("model",)),
    (r"mixer/out_proj$", ("model", None)),
]


def _match_rule(path: str, ndim: int, mesh) -> P:
    for pat, trailing in _RULES:
        if re.search(pat, path):
            entries = [dp_axes(mesh) if e == "dp" else e for e in trailing]
            lead = [None] * (ndim - len(entries))
            return P(*(lead + entries))
    return P(*([None] * ndim))  # replicate by default (norms, scalars)


def _axes_size(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _divisible(shape, spec, mesh) -> bool:
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if dim % _axes_size(mesh, axes) != 0:
            return False
    return True


def _leaves(cfg: ModelConfig, model):
    """(reference name, stacked, port names, shape of the reference's leaf)
    for every leaf of the reference's params tree."""
    params = dict(model.named_parameters())
    for name, (stacked, names) in leaf_map(cfg, model).items():
        shape = tuple(params[names[0]].shape)
        yield name, stacked, names, ((len(names),) + shape if stacked else shape)


def _per_layer(spec: P, stacked: bool, ndim: int) -> P:
    """The port's spec of one parameter: the stacked leaf's spec padded to
    its dims, the stacking entry dropped."""
    entries = list(spec) + [None] * (ndim - len(spec))
    return P(*(entries[1:] if stacked else entries))


def param_specs(cfg: ModelConfig, model, mesh) -> Dict[str, P]:
    """Port parameter name → spec (the module docstring's layer rule).

    Falls back to replication for any leaf whose matched spec doesn't
    divide (e.g. a reduced smoke config whose d_ff < model-axis size)."""
    dp = dp_axes(mesh)
    n_dp = _axes_size(mesh, dp)
    # ep_only: keep EP sharding of the expert stacks, replicate dense/attn
    # weights. Expert rules are the 3-D ffn/we_* entries.
    ep_paths = re.compile(r"ffn/we_(gate|up|down)$")

    def one(pstr, shape):
        spec = _match_rule(pstr, len(shape), mesh)
        if cfg.tp_strategy == "ep_only":
            if not (ep_paths.search(pstr) or re.search(r"embed/(tok|out)$", pstr)):
                spec = P(*(None if e == M else e for e in list(spec) + [None] * (len(shape) - len(spec))))
        if not _divisible(shape, spec, mesh):
            return P(*([None] * len(shape)))
        if cfg.fsdp:
            # ZeRO-3 / FSDP: additionally shard the first open dim over the
            # DP axes; i >= 1 skips the reference's layer-stacking dim
            entries = list(spec) + [None] * (len(shape) - len(spec))
            for i in range(len(entries)):
                if entries[i] is None and shape[i] % n_dp == 0 and shape[i] >= n_dp and i >= 1:
                    entries[i] = dp
                    break
            spec2 = P(*entries)
            if _divisible(shape, spec2, mesh):
                return spec2
        return spec

    out = {}
    for name, stacked, names, shape in _leaves(cfg, model):
        spec = _per_layer(one(name, shape), stacked, len(shape))
        for n in names:
            out[n] = spec
    return out


def batch_specs(cfg: ModelConfig, batch, mesh):
    """Batch key → spec: dim 0 over the dp axes."""
    dp = dp_axes(mesh)
    return {k: P(*((dp,) + (None,) * (len(v.shape) - 1))) for k, v in batch.items()}


def _divisible_dim(dim, axis, mesh) -> bool:
    return dim % mesh.shape[axis] == 0


def cache_specs(cfg: ModelConfig, cache, mesh, seq_axis_model: bool = True):
    """Decode caches: (..., B, T, heads, hd) → batch over data, T over
    model (sequence-parallel decode). Recurrent states (RWKV/Mamba) shard
    their channel/head dim over model instead. The port's caches keep the
    reference's layout (per-layer state stacked on dim 0), so the specs are
    the reference's, in a tree of the cache's structure."""
    dp = dp_axes(mesh)
    n_dp = _axes_size(mesh, dp)

    def dp_if(dim):
        return dp if dim % n_dp == 0 and dim >= n_dp else None

    def one(p, shape):
        nd = len(shape)
        spec = [None] * nd
        if re.search(r"(wkv|ssm)", p):
            # (L,B,H,hs,hs) / (nb,B,di,ds): batch→data, channel→model
            spec[1] = dp_if(shape[1])
            if _divisible_dim(shape[2], M, mesh):
                spec[2] = M
        elif re.search(r"(x_tm|x_cm|conv)", p):
            spec[1] = dp_if(shape[1])
            spec[-1] = M if _divisible_dim(shape[-1], M, mesh) else None
        elif nd >= 3:
            # attention KV / MLA latent: (L,B,T,·[,·])
            spec[1] = dp_if(shape[1])
            if seq_axis_model and _divisible_dim(shape[2], M, mesh):
                spec[2] = M
        return P(*spec)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        return one("/".join(path), tuple(node.shape))

    return walk(cache, ())


def opt_state_specs(cfg: ModelConfig, pspecs: Dict[str, P], model, mesh, zero1: bool = True) -> Dict[str, P]:
    """Optimizer-moment specs = param specs, optionally ZeRO-1-extended:
    the first unsharded, data-divisible dim of the reference's (stacked)
    leaf also shards over the dp axes — the stacking dim itself gives each
    layer a ``StackRow`` spec (the module docstring). Keyed like
    ``pspecs``. A param spec that FSDP already shards over the dp axes
    stays as it is, where the reference would name the dp axes twice (a
    spec JAX refuses to use)."""
    dp = dp_axes(mesh)
    n_dp = _axes_size(mesh, dp)
    out = {}
    for _name, stacked, names, shape in _leaves(cfg, model):
        spec = pspecs[names[0]]
        entries = ([None] if stacked else []) + list(spec) + [None] * (len(shape) - len(spec) - stacked)
        if zero1 and not set(dp) & set(P(*entries).axes):  # FSDP already shards it over dp
            for i, (e, dim) in enumerate(zip(entries, shape)):
                if e is None and dim % n_dp == 0 and dim >= n_dp:
                    entries[i] = dp
                    break
        spec = _per_layer(P(*entries), stacked, len(shape))
        for l, n in enumerate(names):
            out[n] = StackRow(spec, dp, l, len(names)) if stacked and dp and entries[0] == dp else spec
    return out


def logical_rules(cfg: ModelConfig):
    """Human-readable summary for DESIGN/EXPERIMENTS docs."""
    return [(pat, spec) for pat, spec in _RULES]
