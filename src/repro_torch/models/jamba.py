"""Jamba (arXiv:2403.19887): hybrid Mamba/attention with MoE, in PyTorch.

Mirrors ``repro.models.jamba``. One period of ``hybrid_period`` (8)
layers: attention at position ``hybrid_attn_pos`` (4), Mamba elsewhere;
the MoE FFN at odd positions, a dense SwiGLU at even ones. The reference
stacks each period position's parameters over the ``n_blocks`` periods
and scans over them; the port holds ``blocks[b][pi]``, one
:class:`JambaLayer` per layer, and loops (``models.convert`` maps
``blocks.{b}.{pi}.<leaf>`` to row ``b`` of the reference's
``blocks/{pi}/<leaf>``). The cache keeps the reference's layout: a list
over the period positions, each ``(K, V)`` of ``(nb, B, T, nkv, hd)`` or a
Mamba state ``{"conv": (nb, B, d_conv-1, d_inner), "ssm": (nb, B, d_inner,
d_state)}`` — every leaf stacked per block on axis 0 with the batch on
axis 1, so ``ServeEngine``'s splice takes it as it is. Decode writes the
new K/V rows and Mamba states into the cache tensors in place.

The attention layer takes the flash kernel on prefills of ``S % 128 ==
0`` under ``attn_impl="flash"`` (``models.common.gqa_attention_full``);
the Mamba layers are PyTorch ops, as the reference's are ``lax.scan``.
The sharded train step's per-rank loss (:func:`tp_loss`) runs a period
under the remat policy as :func:`jamba_loss` runs it, tensor-parallel
(``models.tp``); its MoE layers route over the whole microbatch
(``models.moe.GlobalRouting``).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models import mamba as mamba_mod
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
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import _norm, _params, gqa_params, init_leaves, moe_params, swiglu_params

__all__ = [
    "block_layout",
    "n_blocks",
    "JambaLayer",
    "JambaLM",
    "init_jamba",
    "init_cache",
    "jamba_forward",
    "jamba_loss",
    "jamba_prefill",
    "jamba_decode_step",
    "tp_loss",
    "tp_prefill",
    "tp_decode_step",
]


def block_layout(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """[(mixer, ffn)] for one period: mixer ∈ {attn, mamba}, ffn ∈ {moe, mlp}."""
    out = []
    for i in range(cfg.hybrid_period):
        mixer = "attn" if i == cfg.hybrid_attn_pos else "mamba"
        ffn = "moe" if (cfg.moe.enabled and i % cfg.hybrid_moe_every == 1) else "mlp"
        out.append((mixer, ffn))
    return out


def n_blocks(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.hybrid_period:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of the period {cfg.hybrid_period}")
    return cfg.n_layers // cfg.hybrid_period


class JambaLayer(nn.Module):
    """One pre-norm layer: ``ln1``, ``mixer`` (GQA ``wq..wo`` or the Mamba
    leaves), ``ln2``, ``ffn`` (SwiGLU or MoE), the reference's names."""

    def __init__(self, cfg: ModelConfig, mixer: str, ffn: str, device):
        super().__init__()
        self.kind = (mixer, ffn)
        self.ln1 = _norm(cfg, device, cfg.d_model)
        self.ln2 = _norm(cfg, device, cfg.d_model)
        self.mixer = gqa_params(cfg, device) if mixer == "attn" else mamba_mod.mamba_params(cfg, device)
        self.ffn = moe_params(cfg, device) if ffn == "moe" else swiglu_params(cfg, device, cfg.d_ff)

    def apply_full(self, cfg: ModelConfig, x, positions, state, train: bool = False, route=None):
        """(x, aux loss, cache seed): ``(k, v)`` of the attention layer or
        the Mamba layer's state after ``x`` (from ``state``, zeros if None);
        ``route`` as in ``moe.moe_apply``."""
        mixer, ffn = self.kind
        h = apply_norm(cfg, self.ln1, x)
        if mixer == "attn":
            a, seed = gqa_attention_full(cfg, self.mixer, h, positions, theta=cfg.rope_theta)
        else:
            a, seed = mamba_mod.mamba_full(cfg, self.mixer, h, state)
        x = x + a
        h = apply_norm(cfg, self.ln2, x)
        if ffn == "moe":
            f, aux = moe_mod.moe_apply(cfg, self.ffn, h, train=train, route=route)
        else:
            f, aux = swiglu(cfg, self.ffn, h), torch.zeros((), dtype=torch.float32, device=x.device)
        return x + f, aux, seed

    def forward_decode(self, cfg: ModelConfig, x, cache, pos):
        """One token; ``cache`` (this layer's ``(K, V)`` or Mamba state) is
        written in place."""
        mixer, ffn = self.kind
        h = apply_norm(cfg, self.ln1, x)
        if mixer == "attn":
            a, _ = gqa_attention_decode(cfg, self.mixer, h, cache, pos, theta=cfg.rope_theta)
        else:
            a, new = mamba_mod.mamba_decode(cfg, self.mixer, h, cache)
            for key in ("conv", "ssm"):
                cache[key].copy_(new[key])
        x = x + a
        h = apply_norm(cfg, self.ln2, x)
        f = moe_mod.moe_apply(cfg, self.ffn, h)[0] if ffn == "moe" else swiglu(cfg, self.ffn, h)
        return x + f


class JambaLM(nn.Module):
    """Embedding, ``blocks[b][pi]`` (block ``b``, period position ``pi``),
    final norm. The forward functions take the config explicitly, so one
    set of weights serves both ``attn_impl`` settings."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        emb = {"tok": (cfg.vocab, d)}
        if not cfg.tie_embeddings:
            emb["out"] = (d, cfg.vocab)
        self.embed = _params(cfg, device, emb)
        self.final_norm = _norm(cfg, device, d)
        layout = block_layout(cfg)
        self.blocks = nn.ModuleList(
            nn.ModuleList(JambaLayer(cfg, m, f, device) for m, f in layout) for _ in range(n_blocks(cfg))
        )

    @property
    def device(self) -> torch.device:
        return self.final_norm["w"].device


def init_jamba(cfg: ModelConfig, generator: torch.Generator, device) -> JambaLM:
    """Random init with the reference's distributions (``init_leaves``;
    the Mamba conv at scale 0.3 and its fixed leaves)."""
    model = init_leaves(cfg, JambaLM(cfg, device), generator, scales={"conv_w": 0.3})
    for block in model.blocks:
        for layer in block:
            if layer.kind[0] == "mamba":
                mamba_mod.init_mamba_leaves(cfg, layer.mixer)
    return model


# -- cache ---------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, max_len: int, device):
    """Zeros: per period position, ``(K, V)`` of ``(nb, B, max_len, nkv,
    hd)`` or ``{"conv", "ssm"}`` stacked over the ``nb`` blocks."""
    nb, hd = n_blocks(cfg), cfg.resolved_head_dim
    entries = []
    for mixer, _ in block_layout(cfg):
        if mixer == "attn":
            entries.append(tuple(torch.zeros((nb, B, max_len, cfg.n_kv_heads, hd), dtype=cfg.cdtype, device=device)
                                 for _ in range(2)))
        else:
            one = mamba_mod.mamba_init_state(cfg, B, device)
            entries.append({k: v.expand((nb,) + v.shape).clone() for k, v in one.items()})
    return entries


# -- forward ---------------------------------------------------------------


def _tokens(model: JambaLM, tokens) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=model.device, dtype=torch.long)


def _period(cfg: ModelConfig, block, x, positions, train: bool, route=None):
    """One period's layers over ``x``: (x, per-layer aux losses, per-layer
    cache seeds)."""
    auxes, seeds = [], []
    for layer in block:
        x, a, seed = layer.apply_full(cfg, x, positions, None, train, route)
        auxes.append(a)
        seeds.append(seed)
    return x, auxes, seeds


def _trunk(cfg: ModelConfig, model: JambaLM, tokens, train: bool = False):
    """(trunk output before the final norm, summed aux loss, per-position
    lists over blocks of cache seeds)."""
    B, S = tokens.shape
    x = embed(cfg, model.embed, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seeds: List[list] = [[] for _ in block_layout(cfg)]
    for block in model.blocks:
        fn = functools.partial(_period, cfg, block, positions=positions, train=train)
        # the reference rematerialises a whole period
        x, auxes, out = (remat_wrap(cfg, fn) if torch.is_grad_enabled() else fn)(x)
        a = torch.zeros((), dtype=torch.float32, device=x.device)
        for a_l in auxes:
            a = a + a_l
        aux = aux + a
        for pi, seed in enumerate(out):
            seeds[pi].append(seed)
    return x, aux, seeds


def jamba_forward(cfg: ModelConfig, model: JambaLM, batch, train: bool = False):
    """(logits (B,S,vocab), aux loss) of the full forward — the reference's
    ``_forward`` without a cache."""
    x, aux, _ = _trunk(cfg, model, _tokens(model, batch["tokens"]), train)
    return logits_out(cfg, model.embed, apply_norm(cfg, model.final_norm, x)), aux


def jamba_loss(cfg: ModelConfig, model: JambaLM, batch):
    """``xent + aux`` and the reference's metrics ``xent``, ``aux``, ``loss``."""
    logits, aux = jamba_forward(cfg, model, batch, train=True)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = _tokens(model, mask)
    loss = next_token_xent(logits, _tokens(model, batch["tokens"]), mask)
    total = loss + aux
    return total, {"xent": loss, "aux": aux, "loss": total}


@torch.no_grad()
def jamba_prefill(cfg: ModelConfig, model: JambaLM, batch, max_len: Optional[int] = None):
    """(last-position logits (B,vocab), cache): the attention K/V zero-padded
    on axis 2 to ``max_len``, the Mamba states after the prompt. Only the
    last position's logits are computed: they equal the reference's
    full-sequence logits taken at ``[:, -1]``."""
    tokens = _tokens(model, batch["tokens"])
    x, _, seeds = _trunk(cfg, model, tokens)
    logits = logits_out(cfg, model.embed, apply_norm(cfg, model.final_norm, x[:, -1]))
    S = tokens.shape[1]
    max_len = max_len or S
    cache = []
    for (mixer, _), per_block in zip(block_layout(cfg), seeds):
        if mixer == "attn":
            pair = []
            for j in (0, 1):
                a = torch.stack([kv[j] for kv in per_block])  # (nb, B, S, nkv, hd)
                full = a.new_zeros(a.shape[:2] + (max_len,) + a.shape[3:])
                full[:, :, :S] = a
                pair.append(full)
            cache.append(tuple(pair))
        else:
            cache.append({k: torch.stack([st[k] for st in per_block]) for k in ("conv", "ssm")})
    return logits, cache


@torch.no_grad()
def jamba_decode_step(cfg: ModelConfig, model: JambaLM, cache, tokens, pos):
    """One-token decode. tokens (B,), pos (B,). Returns (logits (B,vocab),
    cache) — the cache tensors are updated in place."""
    tokens, pos = _tokens(model, tokens), _tokens(model, pos)
    x = embed(cfg, model.embed, tokens[:, None])
    for b, block in enumerate(model.blocks):
        for layer, entry in zip(block, cache):
            one = (entry[0][b], entry[1][b]) if isinstance(entry, tuple) else {k: v[b] for k, v in entry.items()}
            x = layer.forward_decode(cfg, x, one, pos)
    x = apply_norm(cfg, model.final_norm, x)
    return logits_out(cfg, model.embed, x)[:, 0], cache


# -- the sharded serve steps' per-rank forms (models.tp) ----------------------


def _tp_layer(cfg: ModelConfig, w, pre: str, kind, x, positions, entry, split: bool, spec, T: int,
              decode_pos=None, train: bool = False):
    """One Jamba layer on the rank: (x, the prefill's cache pair or None,
    aux). ``entry``: the attention layer's (K, V) blocks at decode (None at
    prefill), or the Mamba layer's state blocks (written in place; None in
    the training loss, which starts from zeros); ``split``: the Mamba
    layer's ``d_inner`` over ``model``; ``spec`` the attention cache leaf's
    spec."""
    mixer, ffn = kind
    h = tp.norm(cfg, w, pre + "ln1.", x)
    pair = None
    if mixer == "attn":
        if decode_pos is None:
            a, seed = tp.attention_full(cfg, w, pre + "mixer.", h, positions, theta=cfg.rope_theta)
            if spec is not None:
                pair = tp.cache_block(w, seed, T, spec)
        else:
            a = tp.attention_decode(cfg, w, pre + "mixer.", h, entry, decode_pos, T, spec, theta=cfg.rope_theta)
    else:
        a = mamba_mod.tp_mamba(cfg, w, pre + "mixer.", h, entry, split)
    x = x + a
    h = tp.norm(cfg, w, pre + "ln2.", x)
    aux = None
    if ffn == "moe":
        f, aux = tp.moe(cfg, w, pre + "ffn.", h, train)
    else:
        f = tp.swiglu(cfg, w, pre + "ffn.", h, cfg.d_ff)
    return x + f, pair, aux


def _tp_period(cfg: ModelConfig, w, b: int, x, positions):
    """Period ``b`` of the training loss on the rank: (x, its MoE layers'
    router sums)."""
    di = cfg.ssm.d_inner(cfg.d_model)
    auxes = []
    for pi, kind in enumerate(block_layout(cfg)):
        pre = f"blocks.{b}.{pi}."
        split = di % w.size == 0 and not w.replicated(pre + "mixer.")  # a replicated Mamba layer runs whole
        x, _, aux = _tp_layer(cfg, w, pre, kind, x, positions, None, split, None, 0, train=True)
        if aux is not None:
            auxes.append(aux)
    return x, auxes


def tp_loss(cfg: ModelConfig, w, batch):
    """Per rank, inside the sharded train step's region: the sums of
    :func:`jamba_loss` over this rank's rows (``{"xent", "router"}`` as
    ``transformer.tp_loss``'s), each period under the remat policy."""
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    x = tp.embed(cfg, w, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    router = []
    for b in range(n_blocks(cfg)):
        x, auxes = tp.remat(cfg, _tp_period)(cfg, w, b, x, positions)
        router += auxes
    return {"xent": tp.xent(cfg, w, tp.norm(cfg, w, "final_norm.", x), tokens, batch.get("loss_mask")),
            "router": router}


def tp_prefill(cfg: ModelConfig, w, batch, max_len: int, specs):
    """Per rank: :func:`jamba_prefill` on this rank's rows with
    tensor-parallel layers: the attention layer's heads (K2 where the flash
    gate lets it run) and its K/V into the ``T``-over-``model`` cache, the
    Mamba layers on the rank's ``d_inner`` share (``mamba.tp_mamba``), the
    FFNs column/row- or expert-parallel. Returns (last logits, the rank's
    cache blocks)."""
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    x = tp.embed(cfg, w, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    layout = block_layout(cfg)
    out = [[[], []] if m == "attn" else {"conv": [], "ssm": []} for m, _ in layout]
    for b in range(n_blocks(cfg)):
        for pi, kind in enumerate(layout):
            pre = f"blocks.{b}.{pi}."
            if kind[0] == "attn":
                x, pair, _ = _tp_layer(cfg, w, pre, kind, x, positions, None, False, specs[pi][0], max_len)
                out[pi][0].append(pair[0])
                out[pi][1].append(pair[1])
            else:
                di = cfg.ssm.d_inner(cfg.d_model)
                split = tp.MODEL in specs[pi]["ssm"].dim_axes(2)
                one = mamba_mod.mamba_init_state(cfg, B, x.device)
                n = di // w.size if split else di
                st = {"conv": one["conv"][..., :n].clone(), "ssm": one["ssm"][:, :n].clone()}
                x, _, _ = _tp_layer(cfg, w, pre, kind, x, positions, st, split, None, max_len)
                for k in ("conv", "ssm"):
                    out[pi][k].append(st[k])
    logits = tp.logits(cfg, w, tp.norm(cfg, w, "final_norm.", x[:, -1]))
    cache = [tuple(torch.stack(t) for t in e) if isinstance(e, list) else {k: torch.stack(v) for k, v in e.items()}
             for e in out]
    return logits, cache


def tp_decode_step(cfg: ModelConfig, w, cache, tokens, pos):
    """Per rank: :func:`jamba_decode_step` on the rank's cache blocks
    (``cache``'s ShardedTensors at ``w.slot``), written in place; the
    attention sequence-parallel over its ``T`` span."""
    tokens, pos = tokens.long(), pos.long()
    x = tp.embed(cfg, w, tokens[:, None])
    s = w.slot
    for b in range(n_blocks(cfg)):
        for pi, kind in enumerate(block_layout(cfg)):
            entry = cache[pi]
            if kind[0] == "attn":
                K, V = entry
                x, _, _ = _tp_layer(cfg, w, f"blocks.{b}.{pi}.", kind, x, None, (K.blocks[s][b], V.blocks[s][b]),
                                    False, K.sharding.spec, K.shape[2], decode_pos=pos)
            else:
                st = {k: entry[k].blocks[s][b] for k in ("conv", "ssm")}
                x, _, _ = _tp_layer(cfg, w, f"blocks.{b}.{pi}.", kind, x, None, st,
                                    tp.MODEL in entry["ssm"].sharding.spec.dim_axes(2), None, 0)
    return tp.logits(cfg, w, tp.norm(cfg, w, "final_norm.", x))[:, 0]
