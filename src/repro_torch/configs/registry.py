"""Architecture + input-shape registry of the port (the 10×4 grid).

``get_config(arch, smoke=False)`` → ModelConfig with the exact published
numbers (or the reduced smoke variant), as in ``repro.configs.registry``,
for all ten architectures of the JAX package's zoo. ``input_specs(cfg,
shape)`` → stand-ins for every model input on ``torch.device("meta")``:
shapes and dtypes, no allocation — the dry run's contract, where the
reference returns ``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from repro_torch.configs import (
    deepseek_v3,
    gemma3_4b,
    granite_moe_1b,
    internlm2_20b,
    jamba_v0p1,
    llama3_405b,
    phi3_vision,
    qwen1p5_0p5b,
    rwkv6_7b,
    whisper_tiny,
)
from repro_torch.models.config import ModelConfig

_MODULES = {m.ARCH: m for m in (qwen1p5_0p5b, rwkv6_7b, granite_moe_1b, deepseek_v3, llama3_405b, internlm2_20b,
                                gemma3_4b, phi3_vision, jamba_v0p1, whisper_tiny)}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    m = _MODULES[arch]
    return m.smoke() if smoke else m.full()


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def list_shapes() -> List[str]:
    return list(SHAPES)


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    """The grid's skip rules: long_500k only for sub-quadratic-KV archs
    (SSM / hybrid / local-global); every arch here has a decoder."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_decode:
        out.append("long_500k")
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta stand-ins of the batch for train/prefill, of ``tokens`` and
    ``pos`` for decode (whose cache comes from :func:`decode_cache_specs`)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode == "decode":
        return {"tokens": _meta((B,), torch.int32), "pos": _meta((B,), torch.int32)}
    if cfg.vlm and cfg.n_img_tokens:
        return {"tokens": _meta((B, S - cfg.n_img_tokens), torch.int32),
                "img_embeds": _meta((B, cfg.n_img_tokens, cfg.d_model), torch.float32)}
    if cfg.encdec:
        return {"tokens": _meta((B, S), torch.int32),
                "enc_frames": _meta((B, cfg.n_audio_ctx, cfg.d_model), torch.float32)}
    return {"tokens": _meta((B, S), torch.int32)}


def decode_cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache of ``shape`` on ``torch.device("meta")``: no
    allocation even for the 500k cache."""
    from repro_torch.models import api

    return api.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
