"""Decoder-only transformer LM (dense GQA family), in PyTorch.

Mirrors the dense-GQA path of ``repro.models.transformer`` (llama3 /
internlm2 / qwen, QKV bias included). Layers are organised into *groups*
of a repeated block pattern exactly as in the JAX package; where JAX runs
``lax.scan`` over parameters stacked on a leading ``reps`` axis, the port
holds one :class:`DecoderLayer` per layer in an ``nn.ModuleList`` and
loops over them. The KV cache keeps the JAX layout — per group, a tuple
per pattern position of ``(K, V)``, each ``(reps, B, T, nkv, hd)`` — which
the paged KV store of the next slice depends on.

MLA, MoE, local/global attention, VLM and multi-token-prediction specs are
not ported yet: they raise ``NotImplementedError`` (never skipped).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.collectives import all_gather
from repro_torch.core.mesh import current_region
from repro_torch.core.streams import StreamComm
from repro_torch.models.common import (
    apply_norm,
    embed,
    gqa_attention_decode,
    gqa_attention_full,
    logits_out,
    next_token_xent,
    remat_wrap,
    swiglu,
)
from repro_torch.models.config import ModelConfig

__all__ = [
    "LayerSpec",
    "layer_groups",
    "DecoderLayer",
    "TransformerLM",
    "init_lm",
    "lm_forward",
    "lm_loss",
    "init_cache",
    "prefill",
    "decode_step",
    "lm_xent_blocks",
]


@dataclass(frozen=True)
class LayerSpec:
    attn: str = "gqa"  # gqa | mla
    window: int = 0  # 0 = full attention
    theta: float = 10_000.0
    moe: bool = False
    d_ff: int = 0


def layer_groups(cfg: ModelConfig) -> List[Tuple[Tuple[LayerSpec, ...], int]]:
    """Return [(block_pattern, reps), ...] covering cfg.n_layers."""
    unported = []
    if cfg.mla is not None:
        unported.append("MLA attention")
    if cfg.moe.enabled:
        unported.append("MoE FFN")
    if cfg.local_global_pattern > 0:
        unported.append("local/global attention")
    if cfg.vlm:
        unported.append("VLM prefix")
    if cfg.mtp_depth:
        unported.append("multi-token prediction")
    if cfg.encdec or cfg.family not in ("dense", "vlm", "moe", "mla_moe"):
        unported.append(f"family {cfg.family!r}")
    if unported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unported)} not ported to repro_torch yet (ROADMAP: model zoo)"
        )
    spec = LayerSpec("gqa", 0, cfg.rope_theta, False, cfg.d_ff)
    return [((spec,), cfg.n_layers)]


def _param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    # created without gradients: serving never takes them, and the trainer
    # turns them on for the model it trains
    return nn.Parameter(torch.empty(shape, dtype=cfg.pdtype, device=device), requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm GQA + SwiGLU layer. Parameter names follow the JAX
    package's tree: ``ln1.w``, ``ln2.w``, ``attn.{wq,wk,wv,wo,bq,bk,bv}``,
    ``ffn.{w_gate,w_up,w_down}``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        self.spec = spec
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        d_ff = spec.d_ff or cfg.d_ff
        self.ln1 = nn.ParameterDict({"w": _param((d,), cfg, device)})
        self.ln2 = nn.ParameterDict({"w": _param((d,), cfg, device)})
        attn = {
            "wq": _param((d, nq * hd), cfg, device),
            "wk": _param((d, nkv * hd), cfg, device),
            "wv": _param((d, nkv * hd), cfg, device),
            "wo": _param((nq * hd, d), cfg, device),
        }
        if cfg.qkv_bias:
            attn["bq"] = _param((nq * hd,), cfg, device)
            attn["bk"] = _param((nkv * hd,), cfg, device)
            attn["bv"] = _param((nkv * hd,), cfg, device)
        self.attn = nn.ParameterDict(attn)
        self.ffn = nn.ParameterDict(
            {
                "w_gate": _param((d, d_ff), cfg, device),
                "w_up": _param((d, d_ff), cfg, device),
                "w_down": _param((d_ff, d), cfg, device),
            }
        )

    def forward_full(self, cfg: ModelConfig, x, positions):
        h = apply_norm(cfg, self.ln1, x)
        a, seed = gqa_attention_full(cfg, self.attn, h, positions, window=self.spec.window, theta=self.spec.theta)
        x = x + a
        return x + swiglu(cfg, self.ffn, apply_norm(cfg, self.ln2, x)), seed

    forward = forward_full  # what torch.func.functional_call runs

    def forward_decode(self, cfg: ModelConfig, x, cache_kv, pos):
        h = apply_norm(cfg, self.ln1, x)
        a, _ = gqa_attention_decode(cfg, self.attn, h, cache_kv, pos, theta=self.spec.theta)
        x = x + a
        return x + swiglu(cfg, self.ffn, apply_norm(cfg, self.ln2, x))


class TransformerLM(nn.Module):
    """Embedding, ``groups[g]`` = the layers of group ``g`` in execution
    order (rep-major over the group's pattern), final norm, tied or untied
    output projection. The forward functions take the config explicitly
    (as the JAX API does), so one set of weights serves several
    ``attn_impl`` settings."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        emb = {"tok": _param((cfg.vocab, d), cfg, device)}
        if not cfg.tie_embeddings:
            emb["out"] = _param((d, cfg.vocab), cfg, device)
        self.embed = nn.ParameterDict(emb)
        self.final_norm = nn.ParameterDict({"w": _param((d,), cfg, device)})
        self.groups = nn.ModuleList(
            nn.ModuleList(DecoderLayer(cfg, spec, device) for _ in range(reps) for spec in pattern)
            for pattern, reps in layer_groups(cfg)
        )

    @property
    def device(self) -> torch.device:
        return self.final_norm["w"].device


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> TransformerLM:
    """Random init with the JAX package's scales (``dense_init``: normal ·
    1/sqrt(fan_in); token embedding 0.02; norm weights and biases zero),
    drawn in fp32 from ``generator`` (on its own device) and cast to
    ``cfg.param_dtype``. The draws differ from ``jax.random``'s: tests carry
    JAX weights across with :func:`repro_torch.models.convert.params_from_numpy`."""
    model = TransformerLM(cfg, device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w" or leaf.startswith("b"):
            p.zero_()
            continue
        scale = 0.02 if leaf == "tok" else 1.0 / math.sqrt(p.shape[0])
        draw = torch.randn(tuple(p.shape), generator=generator, device=generator.device, dtype=torch.float32)
        p.copy_((draw * scale).to(p.dtype))
    return model


# ----------------------------------------------------------------------
# full forward (prefill / loss)
# ----------------------------------------------------------------------


def _tokens(model: TransformerLM, tokens) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=model.device, dtype=torch.long)


def _trunk(cfg: ModelConfig, model: TransformerLM, batch, collect_cache: bool):
    tokens = _tokens(model, batch["tokens"])
    x = embed(cfg, model.embed, tokens)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    seeds = []
    for layers in model.groups:
        g_seeds = []
        for layer in layers:
            # remat only matters where autograd records the forward
            fwd = remat_wrap(cfg, layer.forward_full) if torch.is_grad_enabled() else layer.forward_full
            x, seed = fwd(cfg, x, positions)
            if collect_cache:
                g_seeds.append(seed)
        seeds.append(g_seeds)
    return apply_norm(cfg, model.final_norm, x), seeds


def lm_forward(cfg: ModelConfig, model: TransformerLM, batch, collect_cache: bool = False):
    """Returns (logits (B,S,vocab), per-group lists of per-layer (k, v)
    seeds | None)."""
    x, seeds = _trunk(cfg, model, batch, collect_cache)
    return logits_out(cfg, model.embed, x), (seeds if collect_cache else None)


def lm_loss(cfg: ModelConfig, model: TransformerLM, batch):
    """Scalar next-token loss (+metrics dict)."""
    logits, _ = lm_forward(cfg, model, batch)
    tokens = _tokens(model, batch["tokens"])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = _tokens(model, mask)
    loss = next_token_xent(logits, tokens, mask)
    return loss, {"xent": loss, "aux": torch.zeros((), device=loss.device), "loss": loss}


# ----------------------------------------------------------------------
# KV cache / prefill / decode
# ----------------------------------------------------------------------


def _cache_len(spec: LayerSpec, max_len: int) -> int:
    return min(spec.window, max_len) if spec.window else max_len


def init_cache(cfg: ModelConfig, B: int, max_len: int, device):
    """Zero cache mirroring the group structure: per group, a tuple per
    pattern position of (K, V), each (reps, B, T, nkv, hd)."""
    hd = cfg.resolved_head_dim
    cache = []
    for pattern, reps in layer_groups(cfg):
        entries = []
        for spec in pattern:
            shape = (reps, B, _cache_len(spec, max_len), cfg.n_kv_heads, hd)
            entries.append(
                (
                    torch.zeros(shape, dtype=cfg.cdtype, device=device),
                    torch.zeros(shape, dtype=cfg.cdtype, device=device),
                )
            )
        cache.append(tuple(entries))
    return cache


@torch.no_grad()
def prefill(cfg: ModelConfig, model: TransformerLM, batch, max_len: Optional[int] = None):
    """Full forward returning (last-position logits (B,vocab), cache filled
    to S and zero-padded to ``max_len``). Only the last position's logits
    are computed: each row of the output projection is independent, so
    they equal the JAX package's full-sequence logits taken at ``[:, -1]``."""
    x, seeds = _trunk(cfg, model, batch, collect_cache=True)
    logits = logits_out(cfg, model.embed, x[:, -1])
    S = x.shape[1]
    max_len = max_len or S
    cache = []
    for (pattern, reps), g_seeds in zip(layer_groups(cfg), seeds):
        entries = []
        for pi, spec in enumerate(pattern):
            T = _cache_len(spec, max_len)
            pair = []
            for j in (0, 1):  # k, v
                a = torch.stack([g_seeds[r * len(pattern) + pi][j] for r in range(reps)])
                if S >= T:
                    # ring convention: position p lives at slot p % T
                    pair.append(torch.roll(a[:, :, S - T :], shifts=(S - T) % T, dims=2))
                else:
                    full = torch.zeros(a.shape[:2] + (T,) + a.shape[3:], dtype=a.dtype, device=a.device)
                    full[:, :, :S] = a
                    pair.append(full)
            entries.append(tuple(pair))
        cache.append(tuple(entries))
    return logits, cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: TransformerLM, cache, tokens, pos):
    """One-token decode. tokens (B,), pos (B,) absolute positions. Returns
    (logits (B,vocab), cache) — the cache tensors are updated in place
    (see :func:`repro_torch.models.common.gqa_attention_decode`)."""
    tokens = _tokens(model, tokens)
    pos = _tokens(model, pos)
    x = embed(cfg, model.embed, tokens[:, None])
    for (pattern, reps), layers, gc in zip(layer_groups(cfg), model.groups, cache):
        for i, layer in enumerate(layers):
            r, pi = divmod(i, len(pattern))
            K, V = gc[pi]
            x = layer.forward_decode(cfg, x, (K[r], V[r]), pos)
    x = apply_norm(cfg, model.final_norm, x)
    return logits_out(cfg, model.embed, x)[:, 0], cache


# ----------------------------------------------------------------------
# the sharded forward: per-rank code over a rank's parameter blocks
# ----------------------------------------------------------------------


def _constrain_layer(cfg: ModelConfig, blocks, specs, prefix: str):
    """The parameters under ``prefix`` (a layer's, ``"groups.0.3."``), whole,
    gathered from this rank's blocks at block entry: each leaf all-gathered
    over the axes its spec shards it on, dim by dim. Per-rank code, inside a
    region. The reference re-constrains the scan-sliced layer to its TP
    layout (``fsdp_gather_layers``) and lets GSPMD run it sharded; a thread
    mesh has no partitioner, so the port gathers each layer's weights whole
    (Megatron-style sharded math is ROADMAP work). Autograd reaches the
    blocks through the gathers. Returns names relative to ``prefix``."""
    mesh = current_region().mesh
    out = {}
    for name, block in blocks.items():
        if not name.startswith(prefix):
            continue
        full, spec = block, specs[name]
        for d in range(len(spec)):
            if spec.dim_axes(d):
                full, _ = all_gather(full, StreamComm(spec.dim_axes(d), mesh=mesh), axis=d)
        out[name[len(prefix):]] = full
    return out


def lm_xent_blocks(cfg: ModelConfig, model: TransformerLM, blocks, specs, batch, compute: bool = True):
    """Per-rank: ``(summed next-token xent, token count)`` of this rank's
    ``batch``, every parameter gathered from this rank's ``blocks`` (name →
    block, laid out by ``specs``) at the entry of the layer that uses it
    and applied with ``torch.func.functional_call`` on ``model``'s modules
    (which may live on ``torch.device("meta")``). With ``compute=False``
    the rank only takes part in the gathers its peers need and returns
    ``None``. The sum and count give the reference's mean over any split
    of the batch: ``Σ sum / Σ count``."""
    emb = _constrain_layer(cfg, blocks, specs, "embed.")
    x = None
    if compute:
        tokens = batch["tokens"].long()
        x = embed(cfg, emb, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
    for gi, layers in enumerate(model.groups):
        for li, layer in enumerate(layers):
            lp = _constrain_layer(cfg, blocks, specs, f"groups.{gi}.{li}.")
            if compute:
                def fwd(cfg_, x_, pos_, layer=layer, lp=lp):
                    return torch.func.functional_call(layer, lp, (cfg_, x_, pos_))[0]

                x = (remat_wrap(cfg, fwd) if torch.is_grad_enabled() else fwd)(cfg, x, positions)
    norm = _constrain_layer(cfg, blocks, specs, "final_norm.")
    if not compute:
        return None
    logits = logits_out(cfg, emb, apply_norm(cfg, norm, x))
    mask = batch.get("loss_mask")
    count = mask[:, 1:].float().sum() if mask is not None else torch.tensor(
        float(tokens[:, 1:].numel()), device=logits.device)
    return next_token_xent(logits, tokens, mask) * count, count
