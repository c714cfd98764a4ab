"""Public model API of the port: the JAX package's dispatch surface.

    init_params(cfg, generator, device)       → TransformerLM | RWKVLM (nn.Module)
    loss_fn(cfg, params, batch)               → (loss, metrics)
    init_cache(cfg, B, max_len, device)       → decode cache / recurrent state
    prefill(cfg, params, batch, max_len)      → (last_logits, cache)
    decode_step(cfg, params, cache, tok, pos) → (logits, cache)

Batches are dicts with ``tokens`` (numpy or tensor), an optional
``loss_mask`` and, for a VLM, optional ``img_embeds`` (B, n_img, d). The
transformer family (dense, MoE, MLA with MTP, local/global attention, the
VLM prefix) and RWKV-6 are ported; Jamba and Whisper raise
``NotImplementedError`` with a pointer to ROADMAP.md (P12b).
Entry points that create tensors run on ``cuda`` unless the caller passes
``device="cpu"``; the others run where ``params`` live.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.config import ModelConfig

__all__ = ["init_params", "loss_fn", "init_cache", "prefill", "decode_step"]


def _family(cfg: ModelConfig) -> str:
    if cfg.encdec:
        f = "encdec"
    elif cfg.family == "ssm_rwkv":
        return "rwkv"
    elif cfg.family == "hybrid":
        f = "jamba"
    else:
        return "transformer"
    raise NotImplementedError(
        f"{cfg.name}: the {f} model family is not ported to repro_torch yet (ROADMAP P12b: model zoo)"
    )


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    if _family(cfg) == "rwkv":
        return rwkv_mod.init_rwkv(cfg, generator, resolve_device(device))
    return tf_mod.init_lm(cfg, generator, resolve_device(device))


def loss_fn(cfg: ModelConfig, params, batch):
    if _family(cfg) == "rwkv":
        return rwkv_mod.rwkv_loss(cfg, params, batch)
    return tf_mod.lm_loss(cfg, params, batch)


def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda"):
    if _family(cfg) == "rwkv":
        return rwkv_mod.init_state(cfg, B, max_len, resolve_device(device))
    return tf_mod.init_cache(cfg, B, max_len, resolve_device(device))


def prefill(cfg: ModelConfig, params, batch, max_len=None):
    if _family(cfg) == "rwkv":
        return rwkv_mod.rwkv_prefill(cfg, params, batch, max_len)
    return tf_mod.prefill(cfg, params, batch, max_len)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    if _family(cfg) == "rwkv":
        return rwkv_mod.rwkv_decode_step(cfg, params, cache, tokens, pos)
    return tf_mod.decode_step(cfg, params, cache, tokens, pos)
