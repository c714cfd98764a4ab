"""AdamW with fp32 master weights, global-norm clipping, warmup+cosine.

The JAX package's optimizer (``repro.optim.adamw``) over a module's
parameters: the state is ``{m, v, master, count}``, each of ``m``, ``v``
and ``master`` a dict keyed like ``params`` (the module's
``named_parameters()`` names); ``master`` holds fp32 weights (params stay
bf16 on the forward path) and ``count`` is an int32 scalar tensor. The
schedule and the bias corrections are computed in fp32 from ``count``, on
the device, with no host synchronisation.

PyTorch idiom inside: :func:`adamw_update` updates params, master, m, v
and count **in place** (under ``no_grad``) and returns the same objects,
where the reference returns new pytrees. A caller that snapshots the
state between steps must order the next update after its copy (the
checkpoint manager does: see ``repro_torch.checkpoint.manager``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping

import torch

from repro_torch.models.config import torch_dtype

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "lr_schedule", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "float32"  # bf16 for memory-bound giants
    master: bool = True             # keep fp32 master weights


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an fp32 tensor."""
    step = _f32(step, device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares, leaves in order."""
    total = None
    for x in tree.values():
        s = torch.sum(torch.square(x.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_init(cfg: AdamWConfig, params: Mapping[str, torch.Tensor]) -> Dict:
    mdt = torch_dtype(cfg.moments_dtype)
    first = next(iter(params.values()))
    state = {
        "m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=first.device),
    }
    if cfg.master:
        state["master"] = {k: p.detach().to(torch.float32).clone() for k, p in params.items()}
    return state


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], state: Dict, params: Mapping[str, torch.Tensor],
                 gnorm=None):
    """One step, in place. Returns (params, state, metrics) — the objects
    passed in, updated — with metrics ``grad_norm`` and ``lr`` as fp32
    scalar tensors. ``gnorm`` replaces the norm of ``grads`` for clipping:
    a sharded update passes the norm over every rank's chunks."""
    state["count"].add_(1)
    count = state["count"]
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0) if cfg.clip_norm > 0 else 1.0
    lr = lr_schedule(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device), cf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device), cf)
    masters = state["master"] if cfg.master else params
    for k, g in grads.items():
        m, v, p = state["m"][k], state["v"][k], params[k]
        g = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mh = m32 / b1c
        vh = v32 / b2c
        w32 = masters[k].to(torch.float32)
        w32 = w32 - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * w32)
        m.copy_(m32)
        v.copy_(v32)
        if cfg.master:
            masters[k].copy_(w32)
        p.copy_(w32)
    return params, state, {"grad_norm": gnorm, "lr": lr}
