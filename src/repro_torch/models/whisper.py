"""Whisper-tiny (arXiv:2212.04356): encoder-decoder audio transformer, in PyTorch.

Mirrors ``repro.models.whisper``. The conv front end is a stub in the
reference too: batches carry precomputed frame embeddings ``enc_frames``
(B, n_audio_ctx, d_model). LayerNorm everywhere, GELU MLPs, bias on Q/K/V,
sinusoidal positions for the encoder and (the reference's adaptation) the
decoder. The encoder is non-causal without rope, so it runs the einsum
attention; the decoder's causal self-attention takes the flash kernel on
prefills of ``S % 128 == 0`` under ``attn_impl="flash"``; its
cross-attention (``kv_override``) is einsum, as in the reference.

The reference stacks the layers (``enc_layers``, ``dec_layers``) and
scans; the port holds one module per layer (``models.convert`` maps
``enc_layers.{l}.<leaf>`` to row ``l`` of ``enc_layers/<leaf>``). The
cache keeps the reference's layout, ``{"self": (K, V), "cross": (K, V)}``,
each ``(L, B, T, nkv, hd)``; decode writes the self-attention rows in
place. The sharded steps run each rank's share of the heads, hidden units
and vocab rows (``models.tp``): :func:`tp_loss`, :func:`tp_prefill` and
:func:`tp_decode_step`. The encoder's output is the same on every
``model`` rank; each rank's cross-attention projects it to its own heads'
K/V, and the backward of the all-reduces that made it sums the ranks'
partial cotangents, so its gradient is counted once. Neither layout hint
changes Whisper (the reference tags no activation of it and it has no
MoE): the sharded steps run it as without them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.common import (
    apply_norm,
    embed,
    gelu_mlp,
    gqa_attention_decode,
    gqa_attention_full,
    logits_out,
    next_token_xent,
    remat_wrap,
)
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _norm, _params, gelu_mlp_params, gqa_params, init_leaves

__all__ = [
    "sinusoids",
    "WhisperLM",
    "init_whisper",
    "encode",
    "decode_full",
    "whisper_loss",
    "init_cache",
    "whisper_prefill",
    "whisper_decode_step",
    "tp_loss",
    "tp_prefill",
    "tp_decode_step",
]


def _inv_timescales(channels: int, device) -> torch.Tensor:
    # fp32 throughout, as the reference's jnp.log(10_000.0) / (half - 1)
    log_timescale = torch.log(torch.tensor(10_000.0, device=device)) / (channels // 2 - 1)
    return torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32, device=device))


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] * _inv_timescales(channels, device)[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _norm(cfg, device, cfg.d_model)
        self.attn = gqa_params(cfg, device)
        self.ln2 = _norm(cfg, device, cfg.d_model)
        self.mlp = gelu_mlp_params(cfg, device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = _norm(cfg, device, cfg.d_model)
        self.attn = gqa_params(cfg, device)
        self.lnx = _norm(cfg, device, cfg.d_model)
        self.xattn = gqa_params(cfg, device)
        self.ln2 = _norm(cfg, device, cfg.d_model)
        self.mlp = gelu_mlp_params(cfg, device)


class WhisperLM(nn.Module):
    """``embed``, ``enc_layers``, ``enc_ln_post``, ``dec_layers``,
    ``final_norm``: the reference's tree, one module per layer."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        emb = {"tok": (cfg.vocab, d)}
        if not cfg.tie_embeddings:
            emb["out"] = (d, cfg.vocab)
        self.embed = _params(cfg, device, emb)
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, device) for _ in range(cfg.n_enc_layers))
        self.enc_ln_post = _norm(cfg, device, d)
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = _norm(cfg, device, d)

    @property
    def device(self) -> torch.device:
        return self.final_norm["w"].device


def init_whisper(cfg: ModelConfig, generator: torch.Generator, device) -> WhisperLM:
    """Random init with the reference's distributions (``init_leaves``)."""
    return init_leaves(cfg, WhisperLM(cfg, device), generator)


def _tokens(model: WhisperLM, tokens) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=model.device, dtype=torch.long)


def _frames(cfg: ModelConfig, model: WhisperLM, frames) -> torch.Tensor:
    return torch.as_tensor(frames).to(device=model.device, dtype=cfg.cdtype)


def _layers(cfg: ModelConfig, layers, body, x):
    for layer in layers:
        fwd = remat_wrap(cfg, body) if torch.is_grad_enabled() else body
        x = fwd(layer, x)
    return x


def _enc_in(cfg: ModelConfig, x):
    """The stub frames with their sinusoids: (x, positions)."""
    B, Se, d = x.shape
    return x + sinusoids(Se, d, x.device).to(cfg.cdtype), torch.arange(Se, device=x.device).expand(B, Se)


def _enc_layer(cfg: ModelConfig, lp, x, positions):
    h = apply_norm(cfg, lp.ln1, x)
    a, _ = gqa_attention_full(cfg, lp.attn, h, positions, causal=False, use_rope=False)
    x = x + a
    return x + gelu_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln2, x))


def encode(cfg: ModelConfig, model: WhisperLM, frames):
    """frames (B, Se, d) — the stub conv output. Returns encoder states."""
    x, positions = _enc_in(cfg, _frames(cfg, model, frames))
    x = _layers(cfg, model.enc_layers, lambda lp, x: _enc_layer(cfg, lp, x, positions), x)
    return apply_norm(cfg, model.enc_ln_post, x)


def _cross_kv(cfg: ModelConfig, lp, enc):
    B, Se, _ = enc.shape
    hd, cd = cfg.resolved_head_dim, cfg.cdtype
    k = (enc @ lp.xattn["wk"].to(cd)).reshape(B, Se, cfg.n_kv_heads, hd)
    v = (enc @ lp.xattn["wv"].to(cd)).reshape(B, Se, cfg.n_kv_heads, hd)
    if cfg.qkv_bias:
        k = k + lp.xattn["bk"].to(cd).reshape(cfg.n_kv_heads, hd)
        v = v + lp.xattn["bv"].to(cd).reshape(cfg.n_kv_heads, hd)
    return k, v


def _dec_in(cfg: ModelConfig, emb, tokens):
    """The decoder's token embeddings with their sinusoids: (x, positions)."""
    B, S = tokens.shape
    x = embed(cfg, emb, tokens)
    return x + sinusoids(S, cfg.d_model, x.device).to(cfg.cdtype), torch.arange(S, device=x.device).expand(B, S)


def _dec_layer(cfg: ModelConfig, lp, x, positions, enc):
    """One decoder layer: (x, its self-attention (k, v), its cross (k, v))."""
    h = apply_norm(cfg, lp.ln1, x)
    a, kv = gqa_attention_full(cfg, lp.attn, h, positions, causal=True, use_rope=False)
    x = x + a
    h = apply_norm(cfg, lp.lnx, x)
    xkv = _cross_kv(cfg, lp, enc)
    a, _ = gqa_attention_full(cfg, lp.xattn, h, positions, kv_override=xkv)
    x = x + a
    return x + gelu_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln2, x)), kv, xkv


def decode_full(cfg: ModelConfig, model: WhisperLM, tokens, enc, collect_cache: bool = False):
    """The teacher-forced decoder over ``tokens`` against the encoder
    states ``enc`` — the reference's ``_decode_full``. Returns (trunk output
    after the final norm (B, S, d), per-layer ``((k, v), (cross k, cross v))``
    seeds, or None without ``collect_cache``)."""
    x, positions = _dec_in(cfg, model.embed, tokens)
    seeds = []

    def body(lp, x):
        x, kv, xkv = _dec_layer(cfg, lp, x, positions, enc)
        if collect_cache:
            seeds.append((kv, xkv))
        return x

    x = _layers(cfg, model.dec_layers, body, x)
    return apply_norm(cfg, model.final_norm, x), (seeds if collect_cache else None)


def whisper_loss(cfg: ModelConfig, model: WhisperLM, batch):
    """Next-token loss of the decoder over ``tokens`` given ``enc_frames``."""
    enc = encode(cfg, model, batch["enc_frames"])
    tokens = _tokens(model, batch["tokens"])
    x, _ = decode_full(cfg, model, tokens, enc)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = _tokens(model, mask)
    loss = next_token_xent(logits_out(cfg, model.embed, x), tokens, mask)
    return loss, {"xent": loss, "loss": loss}


# -- serving ---------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_len: int, device):
    hd, L = cfg.resolved_head_dim, cfg.n_layers
    kv = lambda T: tuple(torch.zeros((L, B, T, cfg.n_kv_heads, hd), dtype=cfg.cdtype, device=device) for _ in range(2))
    return {"self": kv(max_len), "cross": kv(cfg.n_audio_ctx)}


@torch.no_grad()
def whisper_prefill(cfg: ModelConfig, model: WhisperLM, batch, max_len: Optional[int] = None):
    """Teacher-forced prefill over the prompt tokens + the cross K/V from
    the encoder. Returns (last logits (B, vocab), cache); only the last
    position's logits are computed."""
    enc = encode(cfg, model, batch["enc_frames"])
    tokens = _tokens(model, batch["tokens"])
    S = tokens.shape[1]
    max_len = max_len or S
    x, seeds = decode_full(cfg, model, tokens, enc, collect_cache=True)
    k_self, v_self = (torch.stack([s[0][j] for s in seeds]) for j in (0, 1))

    def pad_to(a, T):
        full = a.new_zeros(a.shape[:2] + (T,) + a.shape[3:])
        full[:, :, : a.shape[2]] = a
        return full

    cache = {
        "self": (pad_to(k_self, max_len), pad_to(v_self, max_len)),
        "cross": tuple(torch.stack([s[1][j] for s in seeds]) for j in (0, 1)),
    }
    return logits_out(cfg, model.embed, x[:, -1]), cache


@torch.no_grad()
def whisper_decode_step(cfg: ModelConfig, model: WhisperLM, cache, tokens, pos):
    """One token for every row; the sinusoid of ``pos`` computed inline as
    the reference does. The self-attention cache is written in place."""
    tokens, pos = _tokens(model, tokens), _tokens(model, pos)
    x = embed(cfg, model.embed, tokens[:, None])
    ang = pos[:, None].float() * _inv_timescales(cfg.d_model, x.device)[None, :]
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None, :].to(cfg.cdtype)
    (ks, vs), (kx, vx) = cache["self"], cache["cross"]
    for l, lp in enumerate(model.dec_layers):
        h = apply_norm(cfg, lp.ln1, x)
        a, _ = gqa_attention_decode(cfg, lp.attn, h, (ks[l], vs[l]), pos, use_rope=False)
        x = x + a
        h = apply_norm(cfg, lp.lnx, x)
        a, _ = gqa_attention_full(cfg, lp.xattn, h, None, kv_override=(kx[l], vx[l]))
        x = x + a
        x = x + gelu_mlp(cfg, lp.mlp, apply_norm(cfg, lp.ln2, x))
    x = apply_norm(cfg, model.final_norm, x)
    return logits_out(cfg, model.embed, x)[:, 0], cache


# -- the sharded steps' per-rank forms (models.tp) ----------------------------


def _tp_enc_layer(cfg: ModelConfig, w, l: int, x, positions):
    pre = f"enc_layers.{l}."
    a, _ = tp.attention_full(cfg, w, pre + "attn.", tp.norm(cfg, w, pre + "ln1.", x), positions, causal=False,
                             use_rope=False)
    x = x + a
    return x + tp.gelu_mlp(cfg, w, pre + "mlp.", tp.norm(cfg, w, pre + "ln2.", x))


def _tp_encode(cfg: ModelConfig, w, frames):
    """The encoder on the rank, each layer under ``tp.remat`` (a no-op
    without grad), its output after ``enc_ln_post``: the same on every
    ``model`` rank."""
    x, positions = _enc_in(cfg, frames.to(cfg.cdtype))
    for l in range(cfg.n_enc_layers):
        x = tp.remat(cfg, _tp_enc_layer)(cfg, w, l, x, positions)
    return tp.norm(cfg, w, "enc_ln_post.", x)


def _tp_dec_in(cfg: ModelConfig, w, tokens):
    """The decoder's vocab-parallel embedding with its sinusoids: (x, positions)."""
    B, S = tokens.shape
    x = tp.embed(cfg, w, tokens) + sinusoids(S, cfg.d_model, tokens.device).to(cfg.cdtype)
    return x, torch.arange(S, device=x.device).expand(B, S)


def _tp_dec_layer(cfg: ModelConfig, w, l: int, x, positions, enc):
    """One decoder layer on the rank: (x, its self-attention seed, its
    cross-attention seed), the seeds as ``models.tp.cache_block`` takes them."""
    pre = f"dec_layers.{l}."
    a, seed = tp.attention_full(cfg, w, pre + "attn.", tp.norm(cfg, w, pre + "ln1.", x), positions, use_rope=False)
    x = x + a
    a, xseed = tp.attention_full(cfg, w, pre + "xattn.", tp.norm(cfg, w, pre + "lnx.", x), positions, kv_x=enc)
    x = x + a
    return x + tp.gelu_mlp(cfg, w, pre + "mlp.", tp.norm(cfg, w, pre + "ln2.", x)), seed, xseed


def _tp_train_dec_layer(cfg: ModelConfig, w, l: int, x, positions, enc):
    return _tp_dec_layer(cfg, w, l, x, positions, enc)[0]


def tp_loss(cfg: ModelConfig, w, batch):
    """Per rank, inside the sharded train step's region: the sums of
    :func:`whisper_loss` over this rank's rows of ``batch``
    (``{"xent": (sum, count)}``), every layer of the encoder and the
    decoder tensor-parallel (``models.tp``) under the remat policy, one
    ``tp.remat`` per layer run, as :func:`whisper_loss` runs them."""
    enc = _tp_encode(cfg, w, batch["enc_frames"])
    tokens = batch["tokens"].long()
    x, positions = _tp_dec_in(cfg, w, tokens)
    for l in range(cfg.n_layers):
        x = tp.remat(cfg, _tp_train_dec_layer)(cfg, w, l, x, positions, enc)
    return {"xent": tp.xent(cfg, w, tp.norm(cfg, w, "final_norm.", x), tokens, batch.get("loss_mask"))}


def tp_prefill(cfg: ModelConfig, w, batch, max_len: int, specs):
    """Per rank: :func:`whisper_prefill` on this rank's rows with
    tensor-parallel layers (``models.tp``): the encoder's and the decoder's
    attention on the rank's heads, their GELU MLPs column/row-parallel with
    ``b_out`` added once. Returns (last logits, {"self": (K, V), "cross":
    (K, V)} blocks); the cross K/V go into their ``T_enc``-over-``model``
    blocks as the self K/V do."""
    enc = _tp_encode(cfg, w, batch["enc_frames"])
    x, positions = _tp_dec_in(cfg, w, batch["tokens"].long())
    (sk, _), (xk, _) = specs["self"], specs["cross"]
    out = {"self": ([], []), "cross": ([], [])}
    for l in range(cfg.n_layers):
        x, seed, xseed = _tp_dec_layer(cfg, w, l, x, positions, enc)
        for key, sd, T, spec in (("self", seed, max_len, sk), ("cross", xseed, cfg.n_audio_ctx, xk)):
            for j, t in enumerate(tp.cache_block(w, sd, T, spec)):
                out[key][j].append(t)
    logits = tp.logits(cfg, w, tp.norm(cfg, w, "final_norm.", x[:, -1]))
    return logits, {k: tuple(torch.stack(t) for t in pair) for k, pair in out.items()}


def tp_decode_step(cfg: ModelConfig, w, cache, tokens, pos):
    """Per rank: :func:`whisper_decode_step` with the self-attention
    sequence-parallel over its written cache and the cross-attention over
    the encoder's (``models.tp``)."""
    tokens, pos = tokens.long(), pos.long()
    x = tp.embed(cfg, w, tokens[:, None])
    ang = pos[:, None].float() * _inv_timescales(cfg.d_model, x.device)[None, :]
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, None, :].to(cfg.cdtype)
    (ks, vs), (kx, vx) = cache["self"], cache["cross"]
    s = w.slot
    for l in range(cfg.n_layers):
        pre = f"dec_layers.{l}."
        x = x + tp.attention_decode(cfg, w, pre + "attn.", tp.norm(cfg, w, pre + "ln1.", x),
                                    (ks.blocks[s][l], vs.blocks[s][l]), pos, ks.shape[2], ks.sharding.spec,
                                    use_rope=False)
        x = x + tp.attention_cached(cfg, w, pre + "xattn.", tp.norm(cfg, w, pre + "lnx.", x),
                                    (kx.blocks[s][l], vx.blocks[s][l]), kx.shape[2], kx.sharding.spec)
        x = x + tp.gelu_mlp(cfg, w, pre + "mlp.", tp.norm(cfg, w, pre + "ln2.", x))
    return tp.logits(cfg, w, tp.norm(cfg, w, "final_norm.", x))[:, 0]
