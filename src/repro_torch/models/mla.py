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

from repro_torch.models import tp
from repro_torch.models.common import NEG_INF, apply_rope, rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["mla_full", "mla_decode", "tp_mla_full", "tp_mla_decode"]


def _project_q(cfg: ModelConfig, p, x, positions, theta: float):
    """(q_nope, q_rope) of as many heads as ``wq_b``'s columns hold (every
    head, or a rank's share)."""
    m = cfg.mla
    B, S, _ = x.shape
    cd = cfg.cdtype
    cq = rms_norm(x @ p["wq_a"].to(cd), p["q_norm"])
    q = (cq @ p["wq_b"].to(cd)).reshape(B, S, -1, m.qk_head_dim)
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


# ----------------------------------------------------------------------
# the sharded serve steps' per-rank forms (models.tp)
# ----------------------------------------------------------------------


def _tp_params(cfg: ModelConfig, w, pre: str) -> dict:
    """The rank's MLA weights: the latent projections and norms whole
    (replicated), ``wq_b``/``wkv_b`` on its heads (column-parallel)."""
    nq = cfg.n_heads
    p = {k: w.whole(pre + k) for k in ("wq_a", "q_norm", "wkv_a", "kv_norm")}
    p["wq_b"], p["wkv_b"] = w.part(pre + "wq_b", 1, nq), w.part(pre + "wkv_b", 1, nq)
    return p


def tp_mla_full(cfg: ModelConfig, w, pre: str, x, positions, theta: float):
    """:func:`mla_full` on the rank's heads, ``wo`` row-parallel (whole
    where no leaf is split over ``model``). Returns (out, (c_kv, k_rope)):
    the latent is the same on every ``model`` rank."""
    if w.replicated(pre):
        return tp._whole(w, lambda h: mla_full(cfg, w.tree(pre), h, positions, theta), x)
    x = w.enter(x)
    m = cfg.mla
    B, S, _ = x.shape
    cd = cfg.cdtype
    p = _tp_params(cfg, w, pre)
    q_nope, q_rope = _project_q(cfg, p, x, positions, theta)
    c_kv, k_rope = _project_latent(cfg, p, x, positions, theta)
    kv = (c_kv @ p["wkv_b"].to(cd)).reshape(B, S, -1, m.qk_nope_head_dim + m.v_head_dim)
    nl = kv.shape[2]
    k_nope, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, nl, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    logits = torch.einsum("bsnh,btnh->bnst", q, k).float() * (1.0 / math.sqrt(m.qk_head_dim))
    mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(logits.masked_fill(~mask, NEG_INF), dim=-1).to(v.dtype)
    out = torch.einsum("bnst,btnv->bsnv", probs, v).reshape(B, S, -1)
    return tp.row(cfg, w, out, pre + "wo", cfg.n_heads), (c_kv, k_rope)


def tp_mla_decode(cfg: ModelConfig, w, pre: str, x, cache, pos, T: int, spec, theta: float):
    """:func:`mla_decode` sequence-parallel over the rank's latent block
    ``cache = (c_kv (B_l,T_l,r), k_rope (B_l,T_l,dr))`` of ``T`` slots laid
    out by ``spec``: every rank computes the new latent row and the one
    holding its slot writes it; the absorbed queries of the rank's heads are
    all-gathered to every head, attend over the rank's slots, and the
    partials are merged over ``model`` (``models.tp.merge_attend``); each
    rank keeps its heads for ``W_UV`` and the row-parallel ``wo``."""
    m = cfg.mla
    B = x.shape[0]
    nq, cd = cfg.n_heads, cfg.cdtype
    p = _tp_params(cfg, w, pre)
    q_nope, q_rope = _project_q(cfg, p, x, pos[:, None], theta)  # (B,1,nq_l,·)
    c_new, kr_new = _project_latent(cfg, p, x, pos[:, None], theta)
    C, KR = cache
    t0, n, split = tp.seq_span(w, spec, T)
    tp.write_row(C, c_new[:, 0], pos, t0)
    tp.write_row(KR, kr_new[:, 0], pos, t0)
    wkv_b = p["wkv_b"].to(cd).reshape(m.kv_lora_rank, -1, m.qk_nope_head_dim + m.v_head_dim)
    wk, wv = wkv_b[..., : m.qk_nope_head_dim], wkv_b[..., m.qk_nope_head_dim :]
    q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, wk)  # absorb W_UK
    q = torch.cat([q_lat, q_rope], dim=-1)[:, 0]  # (B, nq_l, r + dr)
    q = w.gather(q.reshape(B, -1), axis=1).view(B, nq, -1)
    keys = torch.cat([C, KR], dim=-1)[:, :, None]
    valid = (t0 + torch.arange(n, device=x.device))[None, :] <= pos[:, None]
    out_lat = tp.merge_attend(w, q, keys, C[:, :, None], valid, 1.0 / math.sqrt(m.qk_head_dim), split)
    h0, h1 = w.share(nq)
    out = torch.einsum("bnr,rnv->bnv", out_lat[:, h0:h1].to(cd), wv).reshape(B, 1, -1)
    return tp.row(cfg, w, out, pre + "wo", nq)
