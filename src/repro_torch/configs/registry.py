"""Architecture registry of the port.

``get_config(arch, smoke=False)`` → ModelConfig with the exact published
numbers (or the reduced smoke variant), as in ``repro.configs.registry``,
for all ten architectures of the JAX package's zoo.
"""

from __future__ import annotations

from typing import List

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
