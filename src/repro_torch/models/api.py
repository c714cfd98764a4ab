"""Public model API of the port: the JAX package's dispatch surface.

    init_params(cfg, generator, device)       → the family's nn.Module
    abstract_params(cfg)                      → the same on the meta device
    loss_fn(cfg, params, batch)               → (loss, metrics)
    init_cache(cfg, B, max_len, device)       → decode cache / recurrent state
    prefill(cfg, params, batch, max_len)      → (last_logits, cache)
    decode_step(cfg, params, cache, tok, pos) → (logits, cache)

Batches are dicts with ``tokens`` (numpy or tensor), an optional
``loss_mask``, ``enc_frames`` (B, n_audio_ctx, d) for the encoder-decoder
(Whisper's stub front end) and, for a VLM, optional ``img_embeds`` (B,
n_img, d). Every family of the JAX package is ported: the transformer
(dense, MoE, MLA with MTP, local/global attention, the VLM prefix), RWKV-6,
the Jamba hybrid and the Whisper encoder-decoder.
Entry points that create tensors run on ``cuda`` unless the caller passes
``device="cpu"``; the others run where ``params`` live.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import jamba as jamba_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models import whisper as whisper_mod
from repro_torch.models.config import ModelConfig

__all__ = ["family", "model_class", "init_params", "abstract_params", "loss_fn", "init_cache", "prefill", "decode_step"]


def family(cfg: ModelConfig) -> str:
    """``"encdec"``, ``"rwkv"``, ``"jamba"`` or ``"transformer"``."""
    if cfg.encdec:
        return "encdec"
    if cfg.family == "ssm_rwkv":
        return "rwkv"
    if cfg.family == "hybrid":
        return "jamba"
    return "transformer"


_CLASS = {"rwkv": rwkv_mod.RWKVLM, "jamba": jamba_mod.JambaLM, "encdec": whisper_mod.WhisperLM,
          "transformer": tf_mod.TransformerLM}
_INIT = {"rwkv": rwkv_mod.init_rwkv, "jamba": jamba_mod.init_jamba, "encdec": whisper_mod.init_whisper,
         "transformer": tf_mod.init_lm}
_LOSS = {"rwkv": rwkv_mod.rwkv_loss, "jamba": jamba_mod.jamba_loss, "encdec": whisper_mod.whisper_loss,
         "transformer": tf_mod.lm_loss}
_CACHE = {"rwkv": rwkv_mod.init_state, "jamba": jamba_mod.init_cache, "encdec": whisper_mod.init_cache,
          "transformer": tf_mod.init_cache}
_PREFILL = {"rwkv": rwkv_mod.rwkv_prefill, "jamba": jamba_mod.jamba_prefill, "encdec": whisper_mod.whisper_prefill,
            "transformer": tf_mod.prefill}
_DECODE = {"rwkv": rwkv_mod.rwkv_decode_step, "jamba": jamba_mod.jamba_decode_step,
           "encdec": whisper_mod.whisper_decode_step, "transformer": tf_mod.decode_step}


def model_class(cfg: ModelConfig):
    """The family's module class: ``cls(cfg, device)`` builds it
    uninitialised (on ``torch.device("meta")``: shapes only)."""
    return _CLASS[family(cfg)]


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    return _INIT[family(cfg)](cfg, generator, resolve_device(device))


def abstract_params(cfg: ModelConfig):
    """The family's module on ``torch.device("meta")``: every parameter's
    shape and dtype, no allocation (the dry-run path)."""
    return model_class(cfg)(cfg, torch.device("meta"))


def loss_fn(cfg: ModelConfig, params, batch):
    return _LOSS[family(cfg)](cfg, params, batch)


def init_cache(cfg: ModelConfig, B: int, max_len: int, device="cuda"):
    return _CACHE[family(cfg)](cfg, B, max_len, resolve_device(device))


def prefill(cfg: ModelConfig, params, batch, max_len=None):
    return _PREFILL[family(cfg)](cfg, params, batch, max_len)


def decode_step(cfg: ModelConfig, params, cache, tokens, pos):
    return _DECODE[family(cfg)](cfg, params, cache, tokens, pos)
