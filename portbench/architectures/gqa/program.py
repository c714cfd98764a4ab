"""The GQA transformer's side of the port: the port's ``ModelConfig`` for a
configuration file, and the port's module filled with the benchmark's
weights (``reference.py``'s draws, by name). The harness loads this file
through ``portbench/harness/arch.py``; it imports the port inside its
functions only.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["model_config", "build_model"]


def model_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file, served in its
    ``torch_dtype`` with the attention kernel (``attn_impl="flash"``)."""
    from repro_torch.models.config import ModelConfig, MoEConfig

    port = cfg.get("port", {})
    family = port.get("family", "dense")
    moe = MoEConfig()
    if cfg.get("num_local_experts"):
        moe = MoEConfig(n_experts=int(cfg["num_local_experts"]), top_k=int(cfg["num_experts_per_tok"]),
                        d_expert=int(cfg["intermediate_size"]))
    return ModelConfig(
        name=cfg["name"], family=family, vlm=family == "vlm", n_img_tokens=int(port.get("n_img_tokens", 0)),
        n_layers=int(cfg["num_hidden_layers"]), d_model=int(cfg["hidden_size"]),
        n_heads=int(cfg["num_attention_heads"]), n_kv_heads=int(cfg["num_key_value_heads"]),
        head_dim=int(cfg.get("head_dim") or 0), d_ff=int(cfg["intermediate_size"]), vocab=int(cfg["vocab_size"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]), rope_theta=float(cfg["rope_theta"]), moe=moe,
        param_dtype=cfg["torch_dtype"], compute_dtype=cfg["torch_dtype"], remat="none", grad_accum=1,
        attn_impl="flash",
    )


#: the program's parameter name, by layer, for each of the reference's
#: stacked weights (``reference.model.weight_specs``)
_LAYER_LEAVES = {
    "ln1": "ln1.w", "ln2": "ln2.w", "wq": "attn.wq", "wk": "attn.wk", "wv": "attn.wv", "wo": "attn.wo",
    "w_gate": "ffn.w_gate", "w_up": "ffn.w_up", "w_down": "ffn.w_down", "router": "ffn.router",
    "we_gate": "ffn.we_gate", "we_up": "ffn.we_up", "we_down": "ffn.we_down",
}
_WHOLE_LEAVES = {"tok": "embed.tok", "out": "embed.out", "final_norm": "final_norm.w"}


@torch.no_grad()
def build_model(mcfg, weights: Dict[str, torch.Tensor], device):
    """The port's module for ``mcfg``, uninitialised on ``device``, every
    parameter copied from the benchmark's ``weights``; the image projection
    a text-only run never uses is zero. Raises if a parameter is left
    without a weight or a weight without a parameter."""
    from repro_torch.models import api

    model = api.model_class(mcfg)(mcfg, torch.device(device))
    params = dict(model.named_parameters())
    filled = set()
    for name, stacked in weights.items():
        if name in _WHOLE_LEAVES:
            targets = [(_WHOLE_LEAVES[name], stacked)]
        else:
            targets = [(f"groups.0.{i}.{_LAYER_LEAVES[name]}", stacked[i]) for i in range(stacked.shape[0])]
        for pname, value in targets:
            if pname not in params:
                raise KeyError(f"the program has no parameter {pname!r} for the weight {name!r}")
            params[pname].copy_(value)
            filled.add(pname)
    if "img_proj" in params:
        params["img_proj"].zero_()
        filled.add("img_proj")
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"program parameters without a benchmark weight: {missing[:8]}")
    return model
