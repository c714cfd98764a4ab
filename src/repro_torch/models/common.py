"""Shared neural building blocks of the dense transformer and RWKV-6, in PyTorch.

Mirrors the dense parts of ``repro.models.common`` operation for
operation, so the two packages agree within rounding:

* ``rms_norm`` scales by ``(1 + w)`` (zero-initialised weights);
* RoPE rotates split halves (``x[..., :hd/2]``, ``x[..., hd/2:]``), not
  interleaved pairs;
* ``attend`` takes the logits to fp32, the softmax in fp32, then casts
  the probabilities to ``v.dtype`` before P·V;
* logits come out in ``cfg.logit_dtype`` (fp32) through the tied
  embedding;
* activations run in ``cfg.compute_dtype``, norms and softmax in fp32.

Parameters are any string-keyed mapping of tensors (the port's
``nn.ParameterDict``s). The init helpers (``dense_init``, ``norm_params``,
``embed_params``) keep the reference's distributions but draw from a
``torch.Generator``, whose numbers differ from ``jax.random``'s: tests
carry JAX weights across with ``models.convert.params_from_numpy``.

The flash gate of :func:`gqa_attention_full` is the reference's:
``attn_impl == "flash"``, causal, no sliding window and ``S % 128 == 0``;
it calls the flash kernel for CUDA tensors and its plain version for CPU
tensors.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig

__all__ = [
    "dense_init",
    "norm_params",
    "embed_params",
    "rms_norm",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "attend",
    "causal_mask",
    "gqa_qkv",
    "gqa_attention_full",
    "gqa_attention_decode",
    "swiglu",
    "embed",
    "logits_out",
    "next_token_xent",
    "remat_wrap",
]

NEG_INF = -1e30

# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, scale=None, dtype=torch.bfloat16, device=None):
    """Normal draws times ``scale`` (default ``1/sqrt(shape[0])``, the
    reference's fan-in), drawn in fp32 on the generator's device and cast."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    draw = torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=torch.float32)
    return (draw * scale).to(device=device or generator.device, dtype=dtype)


def norm_params(cfg: ModelConfig, d: int, device) -> dict:
    """Norm weights as the reference initialises them: layernorm ``w = 1,
    b = 0``; rmsnorm (scaled by ``1 + w``) ``w = 0``."""
    if cfg.norm == "layernorm":
        return {"w": torch.ones((d,), dtype=cfg.pdtype, device=device),
                "b": torch.zeros((d,), dtype=cfg.pdtype, device=device)}
    return {"w": torch.zeros((d,), dtype=cfg.pdtype, device=device)}


def embed_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Token embedding at scale 0.02 and, when untied, an output projection
    at ``1/sqrt(d_model)``."""
    p = {"tok": dense_init(generator, (cfg.vocab, cfg.d_model), 0.02, cfg.pdtype, device)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(generator, (cfg.d_model, cfg.vocab), None, cfg.pdtype, device)
    return p

# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet (ROADMAP: model zoo)")
    return rms_norm(x, p["w"])


# ----------------------------------------------------------------------
# rotary position embedding
# ----------------------------------------------------------------------


def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, n, hd) rotated over its full last dim; positions (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., :, None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------


def attend(q, k, v, mask, scale: float):
    """q (B,S,nq,hd), k/v (B,T,nkv,hd), mask broadcastable to (B,nkv,G,S,T).

    GQA via head grouping; softmax in fp32.
    """
    B, S, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    G = nq // nkv
    qg = q.reshape(B, S, nkv, G, hd)
    logits = torch.einsum("bsngh,btnh->bngst", qg, k).float() * scale
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v)
    return out.reshape(B, S, nq, hd)


def causal_mask(S: int, T: int, offset: int = 0, window: int = 0, device=None):
    """(S,T) mask: query s (absolute pos offset+s) sees keys t <= offset+s,
    and within ``window`` if window > 0."""
    qpos = offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None, None, None]  # (1,1,1,S,T)


def gqa_qkv(cfg: ModelConfig, p, x, positions, theta: float, use_rope: bool = True):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = cfg.cdtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if use_rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def gqa_attention_full(
    cfg: ModelConfig,
    p,
    x,
    positions,
    window: int = 0,
    theta: float = 10_000.0,
    causal: bool = True,
):
    """Full-sequence (prefill) self-attention. Returns (out, (k, v)) so
    callers can seed a KV cache."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q, k, v = gqa_qkv(cfg, p, x, positions, theta)
    if cfg.attn_impl == "flash" and causal and window == 0 and S % 128 == 0:
        # blocked attention: O(S·d) device-memory traffic instead of the
        # einsum path's O(S²) logit materialization
        from repro_torch.kernels.ops import gqa_flash_attention

        out = gqa_flash_attention(q, k, v, causal=True)
        out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(cfg.cdtype)
        return out, (k, v)
    if causal:
        mask = causal_mask(S, S, window=window, device=x.device)
    else:
        mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=x.device)
    out = attend(q, k, v, mask, 1.0 / math.sqrt(hd))
    out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(cfg.cdtype)
    return out, (k, v)


def gqa_attention_decode(cfg: ModelConfig, p, x, cache_kv, pos, theta: float = 10_000.0):
    """One-token decode. x (B,1,d); cache_kv = (K,V) of (B,T,nkv,hd); pos
    (B,) absolute position of the new token.

    The new K/V rows are written **in place** into the cache tensors at
    ``slot = pos`` (``index_put_``), where the JAX package returns an
    updated copy: the serving engine's batch cache is updated without a
    per-step copy of every layer. Returns (out, (K, V)) with K/V the same
    tensors that were passed in."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k_new, v_new = gqa_qkv(cfg, p, x, pos[:, None], theta)
    K, V = cache_kv
    T = K.shape[1]
    bidx = torch.arange(B, device=x.device)
    K.index_put_((bidx, pos), k_new[:, 0].to(K.dtype))
    V.index_put_((bidx, pos), v_new[:, 0].to(V.dtype))
    mask = (torch.arange(T, device=x.device)[None, :] <= pos[:, None])[:, None, None, None]
    out = attend(q, K.to(cfg.cdtype), V.to(cfg.cdtype), mask, 1.0 / math.sqrt(hd))
    out = out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"].to(cfg.cdtype)
    return out, (K, V)


# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------


def swiglu(cfg: ModelConfig, p, x):
    cd = cfg.cdtype
    g = F.silu(x @ p["w_gate"].to(cd))
    u = x @ p["w_up"].to(cd)
    return (g * u) @ p["w_down"].to(cd)


# ----------------------------------------------------------------------
# embeddings / logits / loss
# ----------------------------------------------------------------------


def embed(cfg: ModelConfig, p, tokens):
    return p["tok"].to(cfg.cdtype)[tokens]


def logits_out(cfg: ModelConfig, p, x):
    w = p["tok"].t() if cfg.tie_embeddings else p["out"]
    return (x @ w.to(cfg.cdtype)).to(cfg.ldtype)


def next_token_xent(logits, tokens, mask=None):
    """Mean cross-entropy of logits[:, :-1] predicting tokens[:, 1:]."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:]
    ll = torch.gather(lp, -1, tgt[..., None].long())[..., 0]
    if mask is not None:
        m = mask[:, 1:].float()
        return -(ll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return -ll.mean()


# ----------------------------------------------------------------------
# rematerialisation
# ----------------------------------------------------------------------


def remat_wrap(cfg: ModelConfig, fn):
    """``fn`` under the config's remat policy (the reference's
    ``jax.checkpoint`` wrapping of each layer): ``"none"`` is ``fn``;
    ``"full"`` saves only the layer's inputs and recomputes its forward in
    the backward pass (``torch.utils.checkpoint``, non-reentrant). The
    reference's ``"dots"`` and ``"save_acts"`` policies are not ported."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    raise NotImplementedError(
        f"remat policy {cfg.remat!r} is not ported to repro_torch yet (ROADMAP P12: the configs that use it)"
    )
