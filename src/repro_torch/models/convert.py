"""Carry weights between the JAX package and the port.

:func:`params_from_numpy` takes the JAX params pytree with every leaf
already converted to numpy (``np.asarray``): nested dicts/lists/tuples,
per-layer leaves stacked on axis 0 as ``repro.models.transformer.init_lm``
and ``repro.models.rwkv6.init_rwkv`` (``jax.vmap`` over layers) build them.
It returns a :class:`~repro_torch.models.transformer.TransformerLM`, or an
:class:`~repro_torch.models.rwkv6.RWKVLM` for the RWKV family, holding the
same values; a key set that differs from the port's raises. Every leaf of
the transformer family's tree crosses: multi-position patterns
(``groups[g][p]``), the MoE and shared-expert leaves, the MLA leaves,
``img_proj`` and ``mtp/*``.
``np.asarray`` of a JAX bfloat16 array is an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` refuses, so such leaves travel as their
16-bit pattern (``int16``) and are re-viewed as ``torch.bfloat16``.

The reverse direction goes through the same name map: :func:`leaf_map`
gives, for each leaf name of the reference's tree (``groups/0/0/attn/wq``),
the port's parameter names that hold it — one per layer for a leaf the
reference stacks. :func:`state_tree` builds the reference's nested tree
over the port's tensors, a stacked leaf as a
:class:`~repro_torch.checkpoint.iovec_store.StackedLeaf` of the per-layer
tensors (no stacked copy: the checkpoint store writes each row as a shard),
and :func:`params_to_numpy` returns that tree as numpy arrays, the stacked
leaves stacked. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.iovec_store import StackedLeaf, map_leaves
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import RWKVLM
from repro_torch.models.transformer import TransformerLM, layer_groups

__all__ = ["params_from_numpy", "tensor_from_numpy", "leaf_map", "state_tree", "shardings_tree", "params_to_numpy"]


def tensor_from_numpy(a) -> torch.Tensor:
    """A CPU tensor with ``a``'s values and dtype (bfloat16 included)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _assign(dst: torch.nn.Parameter, src, what: str) -> None:
    t = tensor_from_numpy(src)
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != expected {tuple(dst.shape)}")
    if t.dtype != dst.dtype:
        raise ValueError(f"{what}: dtype {t.dtype} != config's {dst.dtype}")
    dst.copy_(t)


def _same_keys(mod, src, what: str) -> None:
    if set(mod.keys()) != set(src.keys()):
        raise ValueError(f"{what}: keys {sorted(src)} != {sorted(mod.keys())}")


def _rwkv_from_numpy(cfg: ModelConfig, tree, device) -> RWKVLM:
    model = RWKVLM(cfg, device)
    _same_keys(model.embed, tree["embed"], "embed")
    for k, p in model.embed.items():
        _assign(p, tree["embed"][k], f"embed.{k}")
    _same_keys(model.final_norm, tree["final_norm"], "final_norm")
    for k, p in model.final_norm.items():
        _assign(p, tree["final_norm"][k], f"final_norm.{k}")
    src = tree["layers"]
    expected = model.layers[0].leaf_names()
    if set(src) != expected:
        raise ValueError(f"layers: keys {sorted(src)} != {sorted(expected)}")
    for l, layer in enumerate(model.layers):
        for part in ("ln1", "ln2", "ln_x"):
            mod = getattr(layer, part)
            _same_keys(mod, src[part], f"layers.{part}")
            for k, p in mod.items():
                _assign(p, np.asarray(src[part][k])[l], f"layers.{part}.{k}[{l}]")
        for k, p in layer.p.items():
            _assign(p, np.asarray(src[k])[l], f"layers.{k}[{l}]")
    return model


def _flat_paths(tree, prefix: str = "") -> Dict[str, object]:
    """'/'-joined path → leaf of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, object] = {}
    for k, v in items:
        out.update(_flat_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's model holding the values of the JAX params ``tree``."""
    if cfg.family == "ssm_rwkv":
        return _rwkv_from_numpy(cfg, tree, resolve_device(device))
    model = TransformerLM(cfg, resolve_device(device))
    src = _flat_paths(tree)
    names = leaf_map(cfg, model)
    if set(src) != set(names):
        raise ValueError(f"params tree: keys {sorted(set(src) - set(names))} are not the port's, "
                         f"{sorted(set(names) - set(src))} are missing")
    params = dict(model.named_parameters())
    for ref, (stacked, port) in names.items():
        for r, n in enumerate(port):
            _assign(params[n], np.asarray(src[ref])[r] if stacked else src[ref], f"{ref}[{r}]" if stacked else ref)
    return model


# ----------------------------------------------------------------------
# the port's parameters as the reference's tree
# ----------------------------------------------------------------------


def leaf_map(cfg: ModelConfig, model) -> Dict[str, Tuple[bool, Tuple[str, ...]]]:
    """Reference leaf name → (stacked, the port's parameter names): one
    name for an unstacked leaf, one per layer (row) for a stacked one. A
    transformer layer's parameter ``groups.{g}.{i}.{rest}`` is row ``i //
    len(pattern)`` of the reference's ``groups/{g}/{i % len(pattern)}/{rest}``
    (``rest`` with '/' for '.', ``ffn/shared/w_gate`` included); every other
    parameter (``embed``, ``final_norm``, ``img_proj``, ``mtp``) is a leaf of
    its own, its name the reference's path."""
    out: Dict[str, Tuple[bool, Tuple[str, ...]]] = {}
    if isinstance(model, RWKVLM):
        for k in model.embed.keys():
            out[f"embed/{k}"] = (False, (f"embed.{k}",))
        for k in model.final_norm.keys():
            out[f"final_norm/{k}"] = (False, (f"final_norm.{k}",))
        first = model.layers[0]
        n = len(model.layers)
        for part in ("ln1", "ln2", "ln_x"):
            for k in getattr(first, part).keys():
                out[f"layers/{part}/{k}"] = (True, tuple(f"layers.{l}.{part}.{k}" for l in range(n)))
        for k in first.p.keys():
            out[f"layers/{k}"] = (True, tuple(f"layers.{l}.p.{k}" for l in range(n)))
        return out
    patterns = [len(pattern) for pattern, _ in layer_groups(cfg)]
    rows: Dict[str, Dict[int, str]] = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "groups":
            out["/".join(parts)] = (False, (name,))
            continue
        gi, li = int(parts[1]), int(parts[2])
        r, pi = divmod(li, patterns[gi])
        ref = "/".join(["groups", str(gi), str(pi)] + parts[3:])
        if ref not in out:
            out[ref] = (True, ())
            rows[ref] = {}
        rows[ref][r] = name
    for ref, by_row in rows.items():
        out[ref] = (True, tuple(by_row[r] for r in range(len(by_row))))
    return out


def _nest(flat: Dict[str, object]):
    """Nested dicts from '/'-joined names; a dict keyed 0..n-1 becomes a list."""
    root: dict = {}
    for name, leaf in flat.items():
        node = root
        *head, last = name.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node) and sorted(int(k) for k in node) == list(range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def state_tree(cfg: ModelConfig, model, values: Optional[Mapping[str, torch.Tensor]] = None):
    """The reference's params tree over ``values`` (parameter name → tensor;
    default the model's own parameters), a stacked leaf as a
    :class:`StackedLeaf` of the per-layer tensors."""
    if values is None:
        values = dict(model.named_parameters())
    flat = {}
    for name, (stacked, names) in leaf_map(cfg, model).items():
        flat[name] = StackedLeaf([values[n] for n in names]) if stacked else values[names[0]]
    return _nest(flat)


def shardings_tree(cfg: ModelConfig, model, shardings: Mapping[str, object]):
    """The reference's params tree over per-parameter ``shardings``
    (parameter name → :class:`~repro_torch.core.mesh.NamedSharding`): a
    stacked leaf takes the sharding its rows share — the ``shardings=``
    argument of a restore into :func:`state_tree`'s structure."""
    flat = {}
    for name, (_stacked, names) in leaf_map(cfg, model).items():
        if any(shardings[n] != shardings[names[0]] for n in names):
            raise ValueError(f"{name}: the rows of a stacked leaf must share one sharding")
        flat[name] = shardings[names[0]]
    return _nest(flat)


@torch.no_grad()
def params_to_numpy(cfg: ModelConfig, model):
    """The model's weights as the reference's params tree of numpy arrays,
    the inverse of :func:`params_from_numpy`. numpy has no bfloat16 of its
    own: a bf16 leaf comes out as its 16-bit words (``int16``)."""

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        if isinstance(node, list):
            return [stack(v) for v in node]
        if isinstance(node, StackedLeaf):
            return np.stack(node.rows)
        return node

    return stack(map_leaves(host, state_tree(cfg, model)))
