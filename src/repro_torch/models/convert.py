"""Carry weights between the JAX package and the port.

:func:`params_from_numpy` takes the JAX params pytree with every leaf
already converted to numpy (``np.asarray``): nested dicts/lists/tuples,
per-layer leaves stacked on axis 0 as the reference's ``init_params``
(``jax.vmap`` over layers) builds them. It returns the family's module
(:class:`~repro_torch.models.transformer.TransformerLM`,
:class:`~repro_torch.models.rwkv6.RWKVLM`,
:class:`~repro_torch.models.jamba.JambaLM` or
:class:`~repro_torch.models.whisper.WhisperLM`) holding the same values; a
key set that differs from the port's raises. Every leaf crosses: the
transformer's multi-position patterns (``groups[g][p]``), MoE, MLA,
``img_proj`` and ``mtp/*``; RWKV-6's ``layers``; Jamba's per-position
``blocks[p]`` stacked over blocks (GQA or Mamba mixer, MoE or SwiGLU);
Whisper's ``enc_layers`` and ``dec_layers`` (layernorm ``w``/``b``, Q/K/V
biases, ``xattn``, the GELU MLP).
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

from repro_torch.checkpoint.iovec_store import RowShardings, StackedLeaf, map_leaves
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.models.jamba import JambaLM
from repro_torch.models.rwkv6 import RWKVLM
from repro_torch.models.transformer import TransformerLM, layer_groups
from repro_torch.models.whisper import WhisperLM

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
    model = api.model_class(cfg)(cfg, resolve_device(device))
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


def _ref_leaf(model, patterns, parts) -> Tuple[str, Optional[int]]:
    """The reference's leaf path of the port's parameter ``parts`` (its
    name split at '.'), and the row it is of a stacked leaf (None if the
    leaf is not stacked)."""
    head = parts[0]
    if isinstance(model, TransformerLM) and head == "groups":
        r, pi = divmod(int(parts[2]), patterns[int(parts[1])])
        return "/".join(["groups", parts[1], str(pi)] + parts[3:]), r
    if isinstance(model, RWKVLM) and head == "layers":
        return "/".join(["layers"] + parts[3 if parts[2] == "p" else 2:]), int(parts[1])
    if isinstance(model, JambaLM) and head == "blocks":
        return "/".join(["blocks"] + parts[2:]), int(parts[1])
    if isinstance(model, WhisperLM) and head in ("enc_layers", "dec_layers"):
        return "/".join([head] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def leaf_map(cfg: ModelConfig, model) -> Dict[str, Tuple[bool, Tuple[str, ...]]]:
    """Reference leaf name → (stacked, the port's parameter names): one
    name for an unstacked leaf, one per layer (row) for a stacked one. A
    transformer layer's parameter ``groups.{g}.{i}.{rest}`` is row ``i //
    len(pattern)`` of the reference's ``groups/{g}/{i % len(pattern)}/{rest}``
    (``rest`` with '/' for '.', ``ffn/shared/w_gate`` included); RWKV-6's
    ``layers.{l}.p.{k}`` and ``layers.{l}.{ln}.{k}`` are row ``l`` of
    ``layers/{k}`` and ``layers/{ln}/{k}``; Jamba's ``blocks.{b}.{p}.{rest}``
    row ``b`` of ``blocks/{p}/{rest}``; Whisper's ``enc_layers.{l}.{rest}``
    (``dec_layers``) row ``l`` of ``enc_layers/{rest}``. Every other
    parameter (``embed``, norms, ``img_proj``, ``mtp``) is a leaf of its
    own, its name the reference's path."""
    patterns = [len(pattern) for pattern, _ in layer_groups(cfg)] if isinstance(model, TransformerLM) else []
    out: Dict[str, Tuple[bool, Tuple[str, ...]]] = {}
    rows: Dict[str, Dict[int, str]] = {}
    for name, _ in model.named_parameters():
        ref, r = _ref_leaf(model, patterns, name.split("."))
        if r is None:
            out[ref] = (False, (name,))
        else:
            out[ref] = (True, ())
            rows.setdefault(ref, {})[r] = name
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
    stacked leaf takes the sharding its rows share, or the
    ``iovec_store.RowShardings`` of its rows where they differ (a
    ``StackRow`` each) — the ``shardings=`` argument of a restore into
    :func:`state_tree`'s structure."""
    flat = {}
    for name, (_stacked, names) in leaf_map(cfg, model).items():
        rows = [shardings[n] for n in names]
        flat[name] = rows[0] if all(r == rows[0] for r in rows) else RowShardings(rows)
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
