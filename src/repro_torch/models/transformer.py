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

The sharded steps' per-rank forms (:func:`tp_loss`, :func:`tp_prefill`,
:func:`tp_decode_step`, on ``models.tp``) cover every config: MoE layers
expert-parallel (in training routed over the whole microbatch,
``models.moe.GlobalRouting``), MLA, local windows, the VLM prefix and MTP
as in :func:`lm_loss`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import tp
from repro_torch.models.common import (
    apply_norm,
    embed,
    gqa_attention_decode,
    gqa_attention_full,
    logits_out,
    next_token_xent,
    remat_wrap,
    swiglu,
    tag_act,
)
from repro_torch.models.config import ModelConfig
from repro_torch.tracing import span

__all__ = [
    "LayerSpec",
    "layer_groups",
    "DecoderLayer",
    "MTPHead",
    "TransformerLM",
    "gqa_params",
    "swiglu_params",
    "gelu_mlp_params",
    "moe_params",
    "init_leaves",
    "init_lm",
    "lm_forward",
    "lm_loss",
    "init_cache",
    "prefill",
    "decode_step",
    "tp_loss",
    "tp_prefill",
    "tp_decode_step",
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
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r}{' (encoder-decoder)' if cfg.encdec else ''} is not a decoder-only "
            "transformer: models.api dispatches it to its own module"
        )
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


def _param(shape, cfg: ModelConfig, device, dtype=None) -> nn.Parameter:
    # created without gradients: serving never takes them, and the trainer
    # turns them on for the model it trains
    return nn.Parameter(torch.empty(shape, dtype=dtype or cfg.pdtype, device=device), requires_grad=False)


def _params(cfg: ModelConfig, device, shapes: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(s, cfg, device) for k, s in shapes.items()})


def _norm(cfg: ModelConfig, device, d: int) -> nn.ParameterDict:
    """A norm's weights: ``w`` and, for layernorm, ``b``."""
    return _params(cfg, device, {"w": (d,), "b": (d,)} if cfg.norm == "layernorm" else {"w": (d,)})


def gqa_params(cfg: ModelConfig, device) -> nn.ParameterDict:
    """GQA attention weights ``wq, wk, wv, wo`` and, with ``qkv_bias``,
    ``bq, bk, bv`` (uninitialised)."""
    d, hd, nq, nkv = cfg.d_model, cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = {"wq": (d, nq * hd), "wk": (d, nkv * hd), "wv": (d, nkv * hd), "wo": (nq * hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(nq * hd,), bk=(nkv * hd,), bv=(nkv * hd,))
    return _params(cfg, device, attn)


def swiglu_params(cfg: ModelConfig, device, d_ff: int) -> nn.ParameterDict:
    d = cfg.d_model
    return _params(cfg, device, {"w_gate": (d, d_ff), "w_up": (d, d_ff), "w_down": (d_ff, d)})


def gelu_mlp_params(cfg: ModelConfig, device) -> nn.ParameterDict:
    """The GELU MLP's ``w_in, b_in, w_out, b_out`` (uninitialised)."""
    d, f = cfg.d_model, cfg.d_ff
    return _params(cfg, device, {"w_in": (d, f), "b_in": (f,), "w_out": (f, d), "b_out": (d,)})


def moe_params(cfg: ModelConfig, device) -> nn.ParameterDict:
    """The MoE FFN's ``router`` (fp32 whatever the param dtype), expert
    stacks ``we_gate, we_up, we_down`` and, with shared experts,
    ``shared.{w_gate, w_up, w_down}`` (uninitialised)."""
    d, m = cfg.d_model, cfg.moe
    E, de = m.n_experts, m.d_expert
    ffn = nn.ParameterDict({
        "router": _param((d, E), cfg, device, torch.float32),
        "we_gate": _param((E, d, de), cfg, device),
        "we_up": _param((E, d, de), cfg, device),
        "we_down": _param((E, de, d), cfg, device),
    })
    if m.n_shared:
        ffn.add_module("shared", swiglu_params(cfg, device, m.n_shared * (m.d_shared or m.d_expert)))
    return ffn


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
        d, nq = cfg.d_model, cfg.n_heads
        self.ln1 = _norm(cfg, device, d)
        self.ln2 = _norm(cfg, device, d)
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
            self.attn = gqa_params(cfg, device)
        self.ffn = moe_params(cfg, device) if spec.moe else swiglu_params(cfg, device, spec.d_ff or cfg.d_ff)

    def apply_full(self, cfg: ModelConfig, x, positions, train: bool = False, route=None):
        """(x, aux loss, cache seed) of the full-sequence layer; ``train``
        selects the MoE's train capacity, ``route`` its routing over the dp
        groups (``moe.moe_apply``: the aux comes back as its sums)."""
        spec = self.spec
        with span("model.attn"):
            h = apply_norm(cfg, self.ln1, x)
            if spec.attn == "mla":
                a, seed = mla_mod.mla_full(cfg, self.attn, h, positions, spec.theta)
            else:
                a, seed = gqa_attention_full(cfg, self.attn, h, positions, window=spec.window, theta=spec.theta)
            x = x + tag_act(cfg, a, "attn_out")
        with span("model.moe" if spec.moe else "model.ffn"):
            h = apply_norm(cfg, self.ln2, x)
            if spec.moe:
                f, aux = moe_mod.moe_apply(cfg, self.ffn, h, train=train, route=route)
            else:
                f, aux = swiglu(cfg, self.ffn, h), torch.zeros((), dtype=torch.float32, device=x.device)
            return x + tag_act(cfg, f, "ffn_out"), aux, seed

    def forward_full(self, cfg: ModelConfig, x, positions):
        """(x, cache seed) of the full-sequence layer at eval capacity."""
        x, _, seed = self.apply_full(cfg, x, positions)
        return x, seed

    forward = forward_full  # what torch.func.functional_call runs

    def forward_decode(self, cfg: ModelConfig, x, cache, pos):
        """One-token layer; ``cache`` (this layer's pair) is written in place."""
        spec = self.spec
        with span("model.attn"):
            h = apply_norm(cfg, self.ln1, x)
            if spec.attn == "mla":
                a, _ = mla_mod.mla_decode(cfg, self.attn, h, cache, pos, spec.theta)
            else:
                a, _ = gqa_attention_decode(cfg, self.attn, h, cache, pos, window=spec.window, theta=spec.theta)
            x = x + a
        with span("model.moe" if spec.moe else "model.ffn"):
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
        self.norm_h = _norm(cfg, device, d)
        self.norm_e = _norm(cfg, device, d)
        self.layer = DecoderLayer(cfg, spec, device)

    def loss(self, cfg: ModelConfig, emb, final_norm, h_final, tokens, route=None):
        """Predict t+2 from the trunk state at t combined with the embedding
        of token t+1 (the reference's ``_mtp_loss``): the mean xent, through
        the model's ``emb`` and ``final_norm`` weights. The layer's router
        aux is dropped, as the reference drops it."""
        B, S, _ = h_final.shape
        h = apply_norm(cfg, self.norm_h, h_final[:, : S - 1])
        e = apply_norm(cfg, self.norm_e, embed(cfg, emb, tokens[:, 1:]))
        z = torch.cat([h, e], dim=-1) @ self.proj.to(cfg.cdtype)
        positions = torch.arange(S - 1, device=z.device).expand(B, S - 1)
        z, _, _ = self.layer.apply_full(cfg, z, positions, train=True, route=route)
        logits = logits_out(cfg, emb, apply_norm(cfg, final_norm, z))
        return next_token_xent(logits, tokens[:, 1:])  # logits[t] predicts tokens[t+2]


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
        self.final_norm = _norm(cfg, device, d)
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


#: leaves initialised to zero: rmsnorm weights (scaled by ``1 + w``), biases,
#: MLA's latent norms and Mamba's dt/B/C norms
_ZERO_LEAVES = ("w", "b", "q_norm", "kv_norm", "bq", "bk", "bv", "b_in", "b_out", "conv_b", "dt_norm", "b_norm",
                "c_norm")


@torch.no_grad()
def init_leaves(cfg: ModelConfig, model: nn.Module, generator: torch.Generator, scales=None) -> nn.Module:
    """Fill every parameter of ``model`` by its leaf name, with the JAX
    package's init: norm weights one under layernorm, the leaves of
    ``_ZERO_LEAVES`` zero, the others normal · ``scales[leaf]`` (default:
    0.02 for ``tok`` and ``router``, else 1/sqrt(shape[0]), which for an
    expert stack ``(E, ...)`` is 1/sqrt(E)), drawn in fp32 from
    ``generator`` (on its own device) and cast to the parameter's dtype."""
    scales = {"tok": 0.02, "router": 0.02, **(scales or {})}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "w" and cfg.norm == "layernorm":
            p.fill_(1.0)
        elif leaf in _ZERO_LEAVES:
            p.zero_()
        else:
            draw = torch.randn(tuple(p.shape), generator=generator, device=generator.device, dtype=torch.float32)
            p.copy_((draw * scales.get(leaf, 1.0 / math.sqrt(p.shape[0]))).to(p.dtype))
            del draw
    return model


def init_lm(cfg: ModelConfig, generator: torch.Generator, device) -> TransformerLM:
    """Random init with the JAX package's scales (:func:`init_leaves`). The
    draws differ from ``jax.random``'s: tests carry JAX weights across with
    :func:`repro_torch.models.convert.params_from_numpy`."""
    return init_leaves(cfg, TransformerLM(cfg, device), generator)


# ----------------------------------------------------------------------
# full forward (prefill / loss)
# ----------------------------------------------------------------------


def _tokens(model: TransformerLM, tokens) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=model.device, dtype=torch.long)


def _embed_x(cfg: ModelConfig, emb, img_proj, tokens, batch):
    """Token embeddings, with the projected image prefix in front when the
    config is a VLM and the batch has ``img_embeds`` (B, n_img, d).
    Returns (x, positions, n_img); positions count the prefix."""
    x = embed(cfg, emb, tokens)
    n_img = 0
    if cfg.vlm and "img_embeds" in batch:
        img = torch.as_tensor(batch["img_embeds"]).to(device=x.device, dtype=cfg.cdtype)
        x = torch.cat([img @ img_proj.to(cfg.cdtype), x], dim=1)
        n_img = img.shape[1]
    B, S, _ = x.shape
    return x, torch.arange(S, device=x.device).expand(B, S), n_img


def _embed_inputs(cfg: ModelConfig, model: TransformerLM, batch):
    """:func:`_embed_x` of the model's weights: (x, positions, n_img, tokens)."""
    tokens = _tokens(model, batch["tokens"])
    return (*_embed_x(cfg, model.embed, getattr(model, "img_proj", None), tokens, batch), tokens)


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
        mtp = model.mtp.loss(cfg, model.embed, model.final_norm, h[:, n_img:] if n_img else h, tokens)
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
    with span("model.prefill"):
        x, _, seeds, _, _ = _trunk(cfg, model, batch, collect_cache=True)
        logits = logits_out(cfg, model.embed, apply_norm(cfg, model.final_norm, x[:, -1]))
        S = x.shape[1]
        max_len = max_len or S
        with span("model.cache"):
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
    with span("model.decode"):
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
# the sharded steps' per-rank forms (models.tp)
# ----------------------------------------------------------------------


def _tp_layer(cfg: ModelConfig, w, pre: str, spec: LayerSpec, x, positions, seq: bool, train: bool = False):
    """One full-sequence layer on the rank: (x, aux, cache seed). The
    attention on the rank's heads (MLA: ``mla.tp_mla_full``), the FFN
    column/row- or expert-parallel, a sublayer whose weights are all
    replicated over ``model`` whole (``models.tp``'s leaf rule). With
    ``seq`` (``seq_shard_acts``) ``x`` is the rank's share of ``S``: each
    sublayer's input is all-gathered along ``S`` and its output
    reduce-scattered back to the share (``RankWeights.enter``/``leave``)."""
    with w.sequence(seq):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = tp.norm(cfg, w, pre + "ln1.", x)
        if spec.attn == "mla":
            a, seed = mla_mod.tp_mla_full(cfg, w, pre + "attn.", h, positions, spec.theta)
        else:
            a, seed = tp.attention_full(cfg, w, pre + "attn.", h, positions, window=spec.window, theta=spec.theta)
        x = x + tag_act(cfg, a, "attn_out")
        h = tp.norm(cfg, w, pre + "ln2.", x)
        if spec.moe:
            f, aux = tp.moe(cfg, w, pre + "ffn.", h, train)
        else:
            f = tp.swiglu(cfg, w, pre + "ffn.", h, spec.d_ff or cfg.d_ff)
        return x + tag_act(cfg, f, "ffn_out"), aux, seed


def _tp_train_layer(cfg: ModelConfig, w, pre: str, spec: LayerSpec, x, positions, seq: bool):
    x, aux, _ = _tp_layer(cfg, w, pre, spec, x, positions, seq, True)
    return x, aux


def _tp_layers(cfg: ModelConfig):
    """(group, pattern position, rep, prefix, spec) of every layer, in
    execution order."""
    for gi, (pattern, reps) in enumerate(layer_groups(cfg)):
        for i in range(reps * len(pattern)):
            r, pi = divmod(i, len(pattern))
            yield gi, pi, r, f"groups.{gi}.{i}.", pattern[pi]


def _tp_embed(cfg: ModelConfig, w, tokens, batch, seq: bool):
    """(x, positions, n_img): :func:`_embed_x` on the rank (the embedding
    vocab-parallel, ``img_proj`` whole), with ``seq`` the rank's share of
    the sequence (the prefix included)."""
    x = tp.embed(cfg, w, tokens)
    n_img = 0
    if cfg.vlm and "img_embeds" in batch:
        img = batch["img_embeds"].to(cfg.cdtype)
        x = torch.cat([img @ w.whole("img_proj").to(cfg.cdtype), x], dim=1)
        n_img = img.shape[1]
    B, S, _ = x.shape
    with w.sequence(seq):
        x = w.local(x)
    return x, torch.arange(S, device=x.device).expand(B, S), n_img


def _tp_mtp(cfg: ModelConfig, w, h, tokens):
    """:meth:`MTPHead.loss` on the rank, as (sum, count): the head's layer
    tensor-parallel, its logits vocab-parallel (``models.tp.xent``)."""
    B, S, _ = h.shape
    hh = tp.norm(cfg, w, "mtp.norm_h.", h[:, : S - 1])
    e = tp.norm(cfg, w, "mtp.norm_e.", tp.embed(cfg, w, tokens[:, 1:]))
    z = torch.cat([hh, e], dim=-1) @ w.whole("mtp.proj").to(cfg.cdtype)
    positions = torch.arange(S - 1, device=z.device).expand(B, S - 1)
    z, _ = _tp_train_layer(cfg, w, "mtp.layer.", layer_groups(cfg)[-1][0][0], z, positions, False)
    return tp.xent(cfg, w, tp.norm(cfg, w, "final_norm.", z), tokens[:, 1:])


def tp_loss(cfg: ModelConfig, w, batch):
    """Per rank, inside the sharded train step's region: the sums of
    :func:`lm_loss` over this rank's rows of ``batch`` with
    tensor-parallel layers (``models.tp``, ``w`` a
    :class:`~repro_torch.models.tp.RankWeights` whose ``route`` routes the
    MoE layers over the dp groups), each layer under the remat policy:
    ``{"xent": (sum, count), "router": [per MoE layer, moe_apply's sums],
    "mtp": (sum, count)}`` (``mtp`` with MTP; its layer's router sums
    dropped, as :func:`lm_loss` drops them). The VLM prefix is left out of
    the loss."""
    tokens = batch["tokens"].long()
    seq = w.seq_splits(cfg, tokens.shape[1] + (batch["img_embeds"].shape[1] if cfg.vlm and "img_embeds" in batch
                                               else 0))
    x, positions, n_img = _tp_embed(cfg, w, tokens, batch, seq)
    router = []
    for _, _, _, pre, spec in _tp_layers(cfg):
        x, aux = tp.remat(cfg, _tp_train_layer)(cfg, w, pre, spec, x, positions, seq)
        if spec.moe:
            router.append(aux)
    with w.sequence(seq):  # under seq_shard_acts the trunk's output gathered along S
        h = w.enter(x)[:, n_img:]
    sums = {"xent": tp.xent(cfg, w, tp.norm(cfg, w, "final_norm.", h), tokens, batch.get("loss_mask")),
            "router": router}
    if cfg.mtp_depth:
        sums["mtp"] = _tp_mtp(cfg, w, h, tokens)
    return sums


def tp_prefill(cfg: ModelConfig, w, batch, max_len: int, specs):
    """Per rank, inside the sharded prefill's region: :func:`prefill` on
    this rank's rows of ``batch`` with tensor-parallel layers
    (``models.tp``, ``w`` a :class:`~repro_torch.models.tp.RankWeights`).
    Returns (last logits (B_l, vocab), the rank's cache blocks in the
    cache's tree), ``specs`` being that tree's ``cache_specs``."""
    tokens = batch["tokens"].long()
    seq = w.seq_splits(cfg, tokens.shape[1] + (batch["img_embeds"].shape[1] if cfg.vlm and "img_embeds" in batch
                                               else 0))
    x, positions, _ = _tp_embed(cfg, w, tokens, batch, seq)
    blocks = [[[[], []] for _ in pattern] for pattern, _ in layer_groups(cfg)]
    for gi, pi, _, pre, spec in _tp_layers(cfg):
        T, spec0 = _cache_len(spec, max_len), specs[gi][pi][0]
        x, _, seed = _tp_layer(cfg, w, pre, spec, x, positions, seq)
        if spec.attn == "mla":
            pair = tp.span_block(w, seed[0], T, spec0), tp.span_block(w, seed[1], T, specs[gi][pi][1])
        else:
            pair = tp.cache_block(w, seed, T, spec0)
        for j in (0, 1):
            blocks[gi][pi][j].append(pair[j])
    last = w.gather(x[:, -1:], axis=1)[:, -1] if seq else x[:, -1]
    logits = tp.logits(cfg, w, tp.norm(cfg, w, "final_norm.", last))
    return logits, [tuple(tuple(torch.stack(t) for t in pair) for pair in g) for g in blocks]


def _tp_ffn(cfg: ModelConfig, w, pre: str, spec: LayerSpec, h):
    return tp.moe(cfg, w, pre + "ffn.", h)[0] if spec.moe else tp.swiglu(cfg, w, pre + "ffn.", h,
                                                                          spec.d_ff or cfg.d_ff)


def tp_decode_step(cfg: ModelConfig, w, cache, tokens, pos):
    """Per rank, inside the sharded decode step's region: :func:`decode_step`
    on this rank's rows with tensor-parallel layers and the
    sequence-parallel attention of ``models.tp``. ``cache`` is the cache's
    tree of ``ShardedTensor`` s (their blocks at ``w.slot`` are written in
    place). Returns the logits (B_l, vocab). One token: ``seq_shard_acts``
    does not split it."""
    tokens, pos = tokens.long(), pos.long()
    x = tp.embed(cfg, w, tokens[:, None])
    for gi, pi, r, pre, spec in _tp_layers(cfg):
        K, V = cache[gi][pi]
        h = tp.norm(cfg, w, pre + "ln1.", x)
        blocks = (K.blocks[w.slot][r], V.blocks[w.slot][r])
        if spec.attn == "mla":
            x = x + mla_mod.tp_mla_decode(cfg, w, pre + "attn.", h, blocks, pos, K.shape[2], K.sharding.spec,
                                          spec.theta)
        else:
            x = x + tp.attention_decode(cfg, w, pre + "attn.", h, blocks, pos, K.shape[2], K.sharding.spec,
                                        window=spec.window, theta=spec.theta)
        x = x + _tp_ffn(cfg, w, pre, spec, tp.norm(cfg, w, pre + "ln2.", x))
    return tp.logits(cfg, w, tp.norm(cfg, w, "final_norm.", x))[:, 0]
