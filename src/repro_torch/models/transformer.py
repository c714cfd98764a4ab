"""Unified decoder-only transformer LM, in PyTorch.

Mirrors ``repro.models.transformer``: dense GQA (llama3 / internlm2 /
qwen, QKV bias included), MoE (granite), MLA + MoE + multi-token
prediction (deepseek-v3), 5:1 local:global attention with ring caches
(gemma3), and the VLM prefix (phi-3-vision's backbone fed precomputed
patch embeddings). Layers are organised into *groups* of a repeated block
pattern exactly as in the JAX package (gemma3: 5 × (5 local + 1 global) +
a tail of 4 locals; deepseek: the leading dense layers, then the MoE
layers); where JAX runs ``lax.scan`` over parameters stacked on a leading
``reps`` axis, the port holds one :class:`DecoderLayer` per layer in an
``nn.ModuleList`` and loops over them. The cache keeps the JAX layout —
per group, a tuple per pattern position of a pair, each ``(reps, B, T,
...)``: ``(K, V)`` of ``(nkv, hd)`` rows for GQA (``T = min(window,
max_len)`` on a sliding-window layer, a ring where position ``p`` lives at
slot ``p % T``), ``(c_kv, k_rope)`` latent rows for MLA.

The sharded forward (:func:`lm_xent_blocks`) covers the dense configs
only; MoE, MLA, the VLM prefix and MTP raise there (ROADMAP P11c).
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
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
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
    "MTPHead",
    "TransformerLM",
    "init_lm",
    "lm_forward",
    "lm_loss",
    "init_cache",
    "prefill",
    "decode_step",
    "lm_xent_blocks",
    "check_dense_only",
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
    if cfg.encdec or cfg.family not in ("dense", "vlm", "moe", "mla_moe"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not a transformer of repro_torch (ROADMAP P12b: the model zoo)"
        )
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"{cfg.name}: norm {cfg.norm!r} is not ported yet (ROADMAP P12b: the model zoo)")
    if cfg.mla is not None:
        groups = []
        kd = cfg.moe.first_k_dense
        if kd:
            groups.append(((LayerSpec("mla", 0, cfg.rope_theta, False, cfg.moe.dense_d_ff or cfg.d_ff),), kd))
        groups.append(((LayerSpec("mla", 0, cfg.rope_theta, True, cfg.d_ff),), cfg.n_layers - kd))
        return groups
    if cfg.local_global_pattern > 0:
        k = cfg.local_global_pattern
        local = LayerSpec("gqa", cfg.sliding_window, cfg.rope_theta_local, False, cfg.d_ff)
        glob = LayerSpec("gqa", 0, cfg.rope_theta, False, cfg.d_ff)
        reps = cfg.n_layers // (k + 1)
        groups = [((local,) * k + (glob,), reps)] if reps else []
        tail = cfg.n_layers - reps * (k + 1)
        if tail:
            groups.append(((local,), tail))
        return groups
    groups = []
    kd = cfg.moe.first_k_dense if cfg.moe.enabled else 0
    if kd:
        groups.append(((LayerSpec("gqa", 0, cfg.rope_theta, False, cfg.moe.dense_d_ff or cfg.d_ff),), kd))
    groups.append(((LayerSpec("gqa", 0, cfg.rope_theta, cfg.moe.enabled, cfg.d_ff),), cfg.n_layers - kd))
    return groups


def check_dense_only(cfg: ModelConfig, what: str) -> None:
    """Raise for a config the sharded forward, the sharded step and the
    pipeline do not cover yet: MoE, MLA, the VLM prefix, MTP."""
    parts = [name for name, on in (("MoE", cfg.moe.enabled), ("MLA", cfg.mla is not None), ("the VLM prefix", cfg.vlm),
                                   ("MTP", cfg.mtp_depth > 0)) if on]
    if parts:
        raise NotImplementedError(
            f"{what} covers dense configs only; {cfg.name} has {', '.join(parts)} (ROADMAP P11c)"
        )


def _param(shape, cfg: ModelConfig, device, dtype=None) -> nn.Parameter:
    # created without gradients: serving never takes them, and the trainer
    # turns them on for the model it trains
    return nn.Parameter(torch.empty(shape, dtype=dtype or cfg.pdtype, device=device), requires_grad=False)


def _params(cfg: ModelConfig, device, shapes: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(s, cfg, device) for k, s in shapes.items()})


class DecoderLayer(nn.Module):
    """One pre-norm layer: GQA or MLA attention, then a SwiGLU or MoE FFN.
    Parameter names follow the JAX package's tree: ``ln1.w``, ``ln2.w``,
    ``attn.{wq,wk,wv,wo,bq,bk,bv}`` (GQA) or
    ``attn.{wq_a,q_norm,wq_b,wkv_a,kv_norm,wkv_b,wo}`` (MLA),
    ``ffn.{w_gate,w_up,w_down}`` (SwiGLU) or ``ffn.{router,we_gate,we_up,
    we_down}`` with ``ffn.shared.{w_gate,w_up,w_down}`` (MoE; the router is
    fp32 whatever the param dtype)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        self.spec = spec
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.ln1 = _params(cfg, device, {"w": (d,)})
        self.ln2 = _params(cfg, device, {"w": (d,)})
        if spec.attn == "mla":
            m = cfg.mla
            self.attn = _params(cfg, device, {
                "wq_a": (d, m.q_lora_rank),
                "q_norm": (m.q_lora_rank,),
                "wq_b": (m.q_lora_rank, nq * m.qk_head_dim),
                "wkv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
                "kv_norm": (m.kv_lora_rank,),
                "wkv_b": (m.kv_lora_rank, nq * (m.qk_nope_head_dim + m.v_head_dim)),
                "wo": (nq * m.v_head_dim, d),
            })
        else:
            attn = {"wq": (d, nq * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd), "wo": (nq * hd, d)}
            if cfg.qkv_bias:
                attn.update(bq=(nq * hd,), bk=(nkv * hd,), bv=(nkv * hd,))
            self.attn = _params(cfg, device, attn)
        if spec.moe:
            m = cfg.moe
            E, de = m.n_experts, m.d_expert
            self.ffn = nn.ParameterDict({
                "router": _param((d, E), cfg, device, torch.float32),
                "we_gate": _param((E, d, de), cfg, device),
                "we_up": _param((E, d, de), cfg, device),
                "we_down": _param((E, de, d), cfg, device),
            })
            if m.n_shared:
                ds = m.n_shared * (m.d_shared or m.d_expert)
                self.ffn.add_module("shared", _params(cfg, device, {"w_gate": (d, ds), "w_up": (d, ds),
                                                                    "w_down": (ds, d)}))
        else:
            d_ff = spec.d_ff or cfg.d_ff
            self.ffn = _params(cfg, device, {"w_gate": (d, d_ff), "w_up": (d, d_ff), "w_down": (d_ff, d)})

    def apply_full(self, cfg: ModelConfig, x, positions, train: bool = False):
        """(x, aux loss, cache seed) of the full-sequence layer; ``train``
        selects the MoE's train capacity."""
        spec = self.spec
        h = apply_norm(cfg, self.ln1, x)
        if spec.attn == "mla":
            a, seed = mla_mod.mla_full(cfg, self.attn, h, positions, spec.theta)
        else:
            a, seed = gqa_attention_full(cfg, self.attn, h, positions, window=spec.window, theta=spec.theta)
        x = x + a
        h = apply_norm(cfg, self.ln2, x)
        if spec.moe:
            f, aux = moe_mod.moe_apply(cfg, self.ffn, h, train=train)
        else:
            f, aux = swiglu(cfg, self.ffn, h), torch.zeros((), dtype=torch.float32, device=x.device)
        return x + f, aux, seed

    def forward_full(self, cfg: ModelConfig, x, positions):
        """(x, cache seed) of the full-sequence layer at eval capacity."""
        x, _, seed = self.apply_full(cfg, x, positions)
        return x, seed

    forward = forward_full  # what torch.func.functional_call runs

    def forward_decode(self, cfg: ModelConfig, x, cache, pos):
        """One-token layer; ``cache`` (this layer's pair) is written in place."""
        spec = self.spec
        h = apply_norm(cfg, self.ln1, x)
        if spec.attn == "mla":
            a, _ = mla_mod.mla_decode(cfg, self.attn, h, cache, pos, spec.theta)
        else:
            a, _ = gqa_attention_decode(cfg, self.attn, h, cache, pos, window=spec.window, theta=spec.theta)
        x = x + a
        h = apply_norm(cfg, self.ln2, x)
        f = moe_mod.moe_apply(cfg, self.ffn, h)[0] if spec.moe else swiglu(cfg, self.ffn, h)
        return x + f


class MTPHead(nn.Module):
    """DeepSeek-V3's multi-token prediction module (depth 1): ``proj``
    (2d, d), ``norm_h.w``, ``norm_e.w`` and one layer of the last group's
    spec, as the reference's ``params["mtp"]``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device):
        super().__init__()
        d = cfg.d_model
        self.proj = _param((2 * d, d), cfg, device)
        self.norm_h = _params(cfg, device, {"w": (d,)})
        self.norm_e = _params(cfg, device, {"w": (d,)})
        self.layer = DecoderLayer(cfg, spec, device)


class TransformerLM(nn.Module):
    """Embedding, ``groups[g]`` = the layers of group ``g`` in execution
    order (rep-major over the group's pattern), final norm, tied or untied
    output projection, and — where the config has them — ``img_proj``
    (d, d) for the VLM prefix and the ``mtp`` head. The forward functions
    take the config explicitly (as the JAX API does), so one set of
    weights serves several ``attn_impl`` settings."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        emb = {"tok": (cfg.vocab, d)}
        if not cfg.tie_embeddings:
            emb["out"] = (d, cfg.vocab)
        self.embed = _params(cfg, device, emb)
        self.final_norm = _params(cfg, device, {"w": (d,)})
        groups = layer_groups(cfg)
        self.groups = nn.ModuleList(
            nn.ModuleList(DecoderLayer(cfg, spec, device) for _ in range(reps) for spec in pattern)
            for pattern, reps in groups
        )
        if cfg.vlm:
            self.img_proj = _param((d, d), cfg, device)
        if cfg.mtp_depth:
            self.mtp = MTPHead(cfg, groups[-1][0][0], device)

    @property
    def device(self) -> torch.device:
        return self.final_norm["w"].device


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------


@torch.no_grad()
def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> TransformerLM:
    """Random init with the JAX package's scales (``dense_init``: normal ·
    1/sqrt(shape[0]), which for an expert stack ``(E, ...)`` is 1/sqrt(E);
    token embedding and router 0.02; norm weights and biases zero), drawn
    in fp32 from ``generator`` (on its own device) and cast to the
    parameter's dtype. The draws differ from ``jax.random``'s: tests carry
    JAX weights across with :func:`repro_torch.models.convert.params_from_numpy`."""
    model = TransformerLM(cfg, device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("w", "q_norm", "kv_norm", "bq", "bk", "bv"):
            p.zero_()
            continue
        scale = 0.02 if leaf in ("tok", "router") else 1.0 / math.sqrt(p.shape[0])
        draw = torch.randn(tuple(p.shape), generator=generator, device=generator.device, dtype=torch.float32)
        p.copy_((draw * scale).to(p.dtype))
        del draw
    return model


# ----------------------------------------------------------------------
# full forward (prefill / loss)
# ----------------------------------------------------------------------


def _tokens(model: TransformerLM, tokens) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=model.device, dtype=torch.long)


def _embed_inputs(cfg: ModelConfig, model: TransformerLM, batch):
    """Token embeddings, with the projected image prefix in front when the
    config is a VLM and the batch has ``img_embeds`` (B, n_img, d).
    Returns (x, positions, n_img, tokens); positions count the prefix."""
    tokens = _tokens(model, batch["tokens"])
    x = embed(cfg, model.embed, tokens)
    n_img = 0
    if cfg.vlm and "img_embeds" in batch:
        img = torch.as_tensor(batch["img_embeds"]).to(device=x.device, dtype=cfg.cdtype)
        x = torch.cat([img @ model.img_proj.to(cfg.cdtype), x], dim=1)
        n_img = img.shape[1]
    B, S, _ = x.shape
    return x, torch.arange(S, device=x.device).expand(B, S), n_img, tokens


def _trunk(cfg: ModelConfig, model: TransformerLM, batch, collect_cache: bool, train: bool = False):
    """(trunk output before the final norm, summed aux loss, per-group
    lists of per-layer cache seeds, n_img, tokens)."""
    x, positions, n_img, tokens = _embed_inputs(cfg, model, batch)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seeds = []
    for layers in model.groups:
        g_seeds = []
        for layer in layers:
            # remat only matters where autograd records the forward
            fwd = remat_wrap(cfg, layer.apply_full) if torch.is_grad_enabled() else layer.apply_full
            x, a, seed = fwd(cfg, x, positions, train)
            aux = aux + a
            if collect_cache:
                g_seeds.append(seed)
        seeds.append(g_seeds)
    return x, aux, seeds, n_img, tokens


def lm_forward(cfg: ModelConfig, model: TransformerLM, batch, collect_cache: bool = False, train: bool = False):
    """Returns (logits (B,S,vocab), aux loss, per-group lists of per-layer
    cache seeds | None, n_img, trunk output h) — the reference's tuple. The
    VLM prefix is part of the sequence; the logits cover all of it."""
    h, aux, seeds, n_img, _ = _trunk(cfg, model, batch, collect_cache, train)
    logits = logits_out(cfg, model.embed, apply_norm(cfg, model.final_norm, h))
    return logits, aux, (seeds if collect_cache else None), n_img, h


def _mtp_loss(cfg: ModelConfig, model: TransformerLM, h_final, tokens):
    """DeepSeek-V3 multi-token prediction (depth 1): predict t+2 from the
    trunk state at t combined with the embedding of token t+1."""
    mp = model.mtp
    B, S, _ = h_final.shape
    h = apply_norm(cfg, mp.norm_h, h_final[:, : S - 1])
    e = apply_norm(cfg, mp.norm_e, embed(cfg, model.embed, tokens[:, 1:]))
    z = torch.cat([h, e], dim=-1) @ mp.proj.to(cfg.cdtype)
    positions = torch.arange(S - 1, device=z.device).expand(B, S - 1)
    z, _, _ = mp.layer.apply_full(cfg, z, positions, train=True)
    logits = logits_out(cfg, model.embed, apply_norm(cfg, model.final_norm, z))
    return next_token_xent(logits, tokens[:, 1:])  # logits[t] predicts tokens[t+2]


def lm_loss(cfg: ModelConfig, model: TransformerLM, batch):
    """Scalar training loss ``xent + aux + mtp_loss_weight · mtp`` and the
    reference's metrics: ``xent``, ``aux``, ``mtp`` (with MTP) and ``loss``.
    The VLM prefix's logits are left out of the loss."""
    logits, aux, _, n_img, h = lm_forward(cfg, model, batch, train=True)
    tokens = _tokens(model, batch["tokens"])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = _tokens(model, mask)
    loss = next_token_xent(logits[:, n_img:] if n_img else logits, tokens, mask)
    metrics = {"xent": loss, "aux": aux}
    total = loss + aux
    if cfg.mtp_depth:
        mtp = _mtp_loss(cfg, model, h[:, n_img:] if n_img else h, tokens)
        metrics["mtp"] = mtp
        total = total + cfg.mtp_loss_weight * mtp
    metrics["loss"] = total
    return total, metrics


# ----------------------------------------------------------------------
# KV cache / prefill / decode
# ----------------------------------------------------------------------


def _cache_len(spec: LayerSpec, max_len: int) -> int:
    return min(spec.window, max_len) if spec.window else max_len


def _cache_rows(cfg: ModelConfig, spec: LayerSpec) -> Tuple[tuple, tuple]:
    """The per-position shapes of a layer's cache pair."""
    if spec.attn == "mla":
        return (cfg.mla.kv_lora_rank,), (cfg.mla.qk_rope_head_dim,)
    row = (cfg.n_kv_heads, cfg.resolved_head_dim)
    return row, row


def init_cache(cfg: ModelConfig, B: int, max_len: int, device):
    """Zero cache mirroring the group structure: per group, a tuple per
    pattern position of a pair, each (reps, B, T, ...) — (K, V) for GQA,
    (c_kv, k_rope) for MLA; T = min(window, max_len) on a windowed layer."""
    cache = []
    for pattern, reps in layer_groups(cfg):
        entries = []
        for spec in pattern:
            lead = (reps, B, _cache_len(spec, max_len))
            entries.append(tuple(torch.zeros(lead + row, dtype=cfg.cdtype, device=device)
                                 for row in _cache_rows(cfg, spec)))
        cache.append(tuple(entries))
    return cache


@torch.no_grad()
def prefill(cfg: ModelConfig, model: TransformerLM, batch, max_len: Optional[int] = None):
    """Full forward returning (last-position logits (B,vocab), cache filled
    to S and zero-padded to ``max_len``; a windowed layer's ring holds the
    last T positions, position p at slot p % T). Only the last position's
    logits are computed: each row of the output projection is independent,
    so they equal the JAX package's full-sequence logits taken at ``[:, -1]``."""
    x, _, seeds, _, _ = _trunk(cfg, model, batch, collect_cache=True)
    logits = logits_out(cfg, model.embed, apply_norm(cfg, model.final_norm, x[:, -1]))
    S = x.shape[1]
    max_len = max_len or S
    cache = []
    for (pattern, reps), g_seeds in zip(layer_groups(cfg), seeds):
        entries = []
        for pi, spec in enumerate(pattern):
            T = _cache_len(spec, max_len)
            pair = []
            for j in (0, 1):
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
            a, b = gc[pi]
            x = layer.forward_decode(cfg, x, (a[r], b[r]), pos)
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
    of the batch: ``Σ sum / Σ count``. Dense configs only (ROADMAP P11c)."""
    check_dense_only(cfg, "lm_xent_blocks")
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
