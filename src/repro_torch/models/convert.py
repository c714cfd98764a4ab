"""Carry weights from the JAX package into the port.

:func:`params_from_numpy` takes the JAX params pytree with every leaf
already converted to numpy (``np.asarray``): nested dicts/lists/tuples,
per-layer leaves stacked on axis 0 as ``repro.models.transformer.init_lm``
and ``repro.models.rwkv6.init_rwkv`` (``jax.vmap`` over layers) build them.
It returns a :class:`~repro_torch.models.transformer.TransformerLM`, or an
:class:`~repro_torch.models.rwkv6.RWKVLM` for the RWKV family, holding the
same values; a key set that differs from the port's raises.
``np.asarray`` of a JAX bfloat16 array is an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` refuses, so such leaves travel as their
16-bit pattern (``int16``) and are re-viewed as ``torch.bfloat16``.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.rwkv6 import RWKVLM
from repro_torch.models.transformer import TransformerLM, layer_groups

__all__ = ["params_from_numpy", "tensor_from_numpy"]


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


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's model holding the values of the JAX params ``tree``."""
    if cfg.family == "ssm_rwkv":
        return _rwkv_from_numpy(cfg, tree, resolve_device(device))
    model = TransformerLM(cfg, resolve_device(device))
    for k, p in model.embed.items():
        _assign(p, tree["embed"][k], f"embed.{k}")
    _assign(model.final_norm["w"], tree["final_norm"]["w"], "final_norm.w")
    for gi, ((pattern, reps), layers) in enumerate(zip(layer_groups(cfg), model.groups)):
        for i, layer in enumerate(layers):
            r, pi = divmod(i, len(pattern))
            src = tree["groups"][gi][pi]
            for part in ("ln1", "ln2", "attn", "ffn"):
                mod = getattr(layer, part)
                if set(mod.keys()) != set(src[part].keys()):
                    raise ValueError(f"groups[{gi}][{pi}].{part}: keys {sorted(src[part])} != {sorted(mod.keys())}")
                for k, p in mod.items():
                    _assign(p, np.asarray(src[part][k])[r], f"groups[{gi}][{pi}].{part}.{k}[{r}]")
    return model
