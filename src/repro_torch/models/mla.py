"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), in PyTorch.

Mirrors ``repro.models.mla``. The full forward (loss, prefill) expands the
latent into per-head K/V; the one-token decode uses the *absorbed* form:
the cache holds only the ``(c_kv (B,T,r), k_rope (B,T,dr))`` latent per
token, ``W_UK`` is folded into the query and ``W_UV`` into the output. As
in the GQA decode, the new latent rows are written into the cache tensors
in place. MLA has no Pallas kernel in the reference: these are PyTorch
einsums, as there.

Parameters (any string-keyed mapping of tensors): ``wq_a`` (d, q_lora),
``q_norm`` (q_lora,), ``wq_b`` (q_lora, nq·(nope+rope)), ``wkv_a``
(d, kv_lora+rope), ``kv_norm`` (kv_lora,), ``wkv_b`` (kv_lora,
nq·(nope+v)), ``wo`` (nq·v, d).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import NEG_INF, apply_rope, rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["mla_full", "mla_decode"]


def _project_q(cfg: ModelConfig, p, x, positions, theta: float):
    m = cfg.mla
    B, S, _ = x.shape
    cd = cfg.cdtype
    cq = rms_norm(x @ p["wq_a"].to(cd), p["q_norm"])
    q = (cq @ p["wq_b"].to(cd)).reshape(B, S, cfg.n_heads, m.qk_head_dim)
    q_nope, q_rope = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, theta)


def _project_latent(cfg: ModelConfig, p, x, positions, theta: float):
    m = cfg.mla
    c_kv, k_rope = torch.split(x @ p["wkv_a"].to(cfg.cdtype), [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions, theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_full(cfg: ModelConfig, p, x, positions, theta: float):
    """Full-sequence causal MLA. Returns (out, (c_kv, k_rope)), the latent
    cache seed."""
    m = cfg.mla
    B, S, _ = x.shape
    nq, cd = cfg.n_heads, cfg.cdtype
    q_nope, q_rope = _project_q(cfg, p, x, positions, theta)
    c_kv, k_rope = _project_latent(cfg, p, x, positions, theta)
    kv = (c_kv @ p["wkv_b"].to(cd)).reshape(B, S, nq, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, nq, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    logits = torch.einsum("bsnh,btnh->bnst", q, k).float() * (1.0 / math.sqrt(m.qk_head_dim))
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1).to(v.dtype)
    out = torch.einsum("bnst,btnv->bsnv", probs, v).reshape(B, S, nq * m.v_head_dim)
    return out @ p["wo"].to(cd), (c_kv, k_rope)


def mla_decode(cfg: ModelConfig, p, x, cache, pos, theta: float):
    """Absorbed one-token decode. x (B,1,d); cache = (c_kv (B,T,r),
    k_rope (B,T,dr)), written in place at ``pos``; pos (B,). Scores and
    outputs are computed in latent space. Returns (out, cache)."""
    m = cfg.mla
    B = x.shape[0]
    nq, cd = cfg.n_heads, cfg.cdtype
    q_nope, q_rope = _project_q(cfg, p, x, pos[:, None], theta)  # (B,1,nq,·)
    c_new, kr_new = _project_latent(cfg, p, x, pos[:, None], theta)
    C, KR = cache
    T = C.shape[1]
    bidx = torch.arange(B, device=x.device)
    C.index_put_((bidx, pos), c_new[:, 0].to(C.dtype))
    KR.index_put_((bidx, pos), kr_new[:, 0].to(KR.dtype))

    wkv_b = p["wkv_b"].to(cd).reshape(m.kv_lora_rank, nq, -1)
    wk, wv = wkv_b[..., : m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim :]
    q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, wk)  # absorb W_UK
    Cc, KRc = C.to(cd), KR.to(cd)
    logits = (torch.einsum("bsnr,btr->bnst", q_lat, Cc) + torch.einsum("bsnh,bth->bnst", q_rope, KRc)).float()
    logits = logits * (1.0 / math.sqrt(m.qk_head_dim))
    mask = (torch.arange(T, device=x.device)[None, :] <= pos[:, None])[:, None, None]
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1).to(cd)
    out_lat = torch.einsum("bnst,btr->bsnr", probs, Cc)
    out = torch.einsum("bsnr,rnv->bsnv", out_lat, wv).reshape(B, 1, nq * m.v_head_dim)
    return out @ p["wo"].to(cd), (C, KR)
