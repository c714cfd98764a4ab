"""Shared neural building blocks of the model zoo, in PyTorch.

Mirrors ``repro.models.common`` operation for operation, so the two
packages agree within rounding:

* ``rms_norm`` scales by ``(1 + w)`` (zero-initialised weights);
  ``layer_norm`` (eps 1e-5) by ``w`` plus ``b``;
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

Sliding-window layers (gemma3's local layers) mask the full forward to the
window and decode into a ring cache (:func:`gqa_attention_decode`).

The flash gate of :func:`gqa_attention_full` is the reference's:
``attn_impl == "flash"``, causal, no sliding window, ``S % 128 == 0`` and
no ``kv_override`` (cross-attention); it calls the flash kernel for CUDA
tensors and its plain version for CPU tensors.

On ``torch.device("meta")`` (shapes only) a per-token loop runs one step
that stands for all of them (:func:`meta_scan`), so ``launch.op_cost`` can
count a 32k- or 500k-token loop without running it.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.models.config import ModelConfig

__all__ = [
    "dense_init",
    "norm_params",
    "embed_params",
    "rms_norm",
    "layer_norm",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "attend",
    "causal_mask",
    "gqa_qkv",
    "gqa_attention_full",
    "gqa_attention_decode",
    "swiglu",
    "gelu_mlp",
    "embed",
    "logits_out",
    "next_token_xent",
    "meta_scan",
    "trip_count",
    "remat_wrap",
    "tag_act",
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


def layer_norm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm == "layernorm":
        return layer_norm(x, p["w"], p["b"])
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
    kv_override=None,
    causal: bool = True,
    use_rope: bool = True,
):
    """Full-sequence (train/prefill) self-attention. Returns (out, (k, v))
    so callers can seed a KV cache. ``kv_override`` supplies the K/V of a
    cross-attention (no mask, no rope on the queries)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    cd = cfg.cdtype
    if kv_override is None:
        q, k, v = gqa_qkv(cfg, p, x, positions, theta, use_rope=use_rope)
        if cfg.attn_impl == "flash" and causal and window == 0 and S % 128 == 0:
            # blocked attention: O(S·d) device-memory traffic instead of the
            # einsum path's O(S²) logit materialization
            from repro_torch.kernels.ops import gqa_flash_attention

            out = gqa_flash_attention(q, k, v, causal=True)
            out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(cd)
            return out, (k, v)
        if causal:
            mask = causal_mask(S, S, window=window, device=x.device)
        else:
            mask = torch.ones((1, 1, 1, S, S), dtype=torch.bool, device=x.device)
    else:
        q = (x @ p["wq"].to(cd)).reshape(B, S, cfg.n_heads, hd)
        if cfg.qkv_bias and "bq" in p:
            q = q + p["bq"].to(cd).reshape(cfg.n_heads, hd)
        k, v = kv_override
        mask = torch.ones((1, 1, 1, S, k.shape[1]), dtype=torch.bool, device=x.device)
    out = attend(q, k, v, mask, 1.0 / math.sqrt(hd))
    out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(cd)
    return out, (k, v)


def gqa_attention_decode(cfg: ModelConfig, p, x, cache_kv, pos, window: int = 0, theta: float = 10_000.0,
                         use_rope: bool = True):
    """One-token decode. x (B,1,d); cache_kv = (K,V) of (B,T,nkv,hd); pos
    (B,) absolute position of the new token. With ``window > 0`` the cache
    is a ring of ``T = min(window, max_len)`` slots: the new token goes to
    slot ``pos % T``, and every slot is valid once ``pos + 1 >= T``.

    The new K/V rows are written **in place** into the cache tensors
    (``index_put_``), where the JAX package returns an updated copy: the
    serving engine's batch cache is updated without a per-step copy of
    every layer. Returns (out, (K, V)) with K/V the same tensors that were
    passed in.

    The attention reads each slot's first ``min(pos + 1, T)`` cache rows:
    the rows up to ``pos`` of a full cache, every row of a ring cache once
    ``pos + 1 >= T``. On the card the decode-attention kernel reads them in
    place (``kernels.ops.decode_attention``); on the CPU its plain version
    runs :func:`attend`'s arithmetic over them."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k_new, v_new = gqa_qkv(cfg, p, x, pos[:, None], theta, use_rope=use_rope)
    K, V = cache_kv
    T = K.shape[1]
    slot = pos % max(T, 1) if window > 0 else pos
    bidx = torch.arange(B, device=x.device)
    K.index_put_((bidx, slot), k_new[:, 0].to(K.dtype))
    V.index_put_((bidx, slot), v_new[:, 0].to(V.dtype))
    from repro_torch.kernels.ops import decode_attention

    out = decode_attention(q[:, 0], K, V, pos)
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


def gelu_mlp(cfg: ModelConfig, p, x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    cd = cfg.cdtype
    h = F.gelu(x @ p["w_in"].to(cd) + p["b_in"].to(cd), approximate="tanh")
    return h @ p["w_out"].to(cd) + p["b_out"].to(cd)


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

#: what the ``"dots"`` policy saves: products without batch dimensions, as
#: ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims`` (a
#: ``(B, S, d) @ (d, n)`` product reaches the dispatcher as ``mm``; the
#: attention's and the experts' batched products as ``bmm`` and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
#: the sublayer outputs the ``"save_acts"`` policy saves (``tag_act``'s names)
_SAVED_ACTS = ("attn_out", "ffn_out")


@torch.library.custom_op("repro_torch::tag_act", mutates_args=())
def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """A copy of ``x`` that the ``"save_acts"`` policy recognises by
    ``name``: the counterpart of ``jax.ad_checkpoint.checkpoint_name``. A
    custom op's output may not alias its input, hence the copy."""
    return x.clone()


@_tag.register_fake
def _(x, name):
    return torch.empty_like(x)


_tag.register_autograd(lambda ctx, grad: (grad, None))


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _save_acts(ctx, op, *args, **kwargs):
    if op is torch.ops.repro_torch.tag_act.default and args[1] in _SAVED_ACTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(cfg: ModelConfig, fn):
    """``fn`` under the config's remat policy (the reference's
    ``jax.checkpoint`` wrapping of each layer): ``"none"`` is ``fn``;
    ``"full"`` saves only the layer's inputs and recomputes its forward in
    the backward pass (``torch.utils.checkpoint``, non-reentrant);
    ``"dots"`` saves the outputs of the products without batch dimensions
    and ``"save_acts"`` only the sublayer outputs that :func:`tag_act`
    names ``attn_out`` and ``ffn_out``, recomputing the rest (selective
    checkpointing)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat in ("dots", "save_acts"):
        policy = _save_dots if cfg.remat == "dots" else _save_acts
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=lambda: create_selective_checkpoint_contexts(policy))
    raise ValueError(f"unknown remat policy {cfg.remat!r}")


def tag_act(cfg: ModelConfig, x, name: str):
    """Name the (B, S, d) sublayer output ``x`` for the ``"save_acts"``
    policy; ``x`` itself under every other policy. ``seq_shard_acts``, the
    reference's sequence-parallel constraint here, is laid out by the
    sharded steps (``models.tp``); on one rank it changes nothing."""
    return _tag(x, name) if cfg.remat == "save_acts" else x


# ----------------------------------------------------------------------
# per-token loops on the meta device
# ----------------------------------------------------------------------

_trips = threading.local()


def trip_count() -> int:
    """How many loop steps each op dispatched on this thread stands for:
    the trip count inside :func:`meta_scan`'s one step (forward, recompute
    or backward), else 1. ``launch.op_cost`` multiplies each op's cost by it."""
    return getattr(_trips, "n", 1)


def _same(t):
    return t


@contextmanager
def _standing_for(n: int):
    outer = trip_count()
    _trips.n = outer * n
    try:
        yield
    finally:
        _trips.n = outer


class _OneStep(torch.autograd.Function):
    """One step of a per-token loop on meta tensors, standing for ``n``:
    the forward runs the step at position 0 under ``trip_count() == n`` and
    keeps its graph (its saved tensors held as they are, out of reach of an
    enclosing checkpoint's hooks); the backward runs that graph's backward
    under the same count. The node saves its stacked output, so an
    enclosing ``torch.utils.checkpoint`` recomputes its region (this node
    counted again) when the backward unpacks it, before the count is
    raised, as it recomputes a real loop."""

    @staticmethod
    def forward(ctx, step, n, nx, nc, *tensors):
        with torch.enable_grad(), _standing_for(n), torch.autograd.graph.saved_tensors_hooks(_same, _same):
            ins = [t.select(1, 0) if i < nx else t for i, t in enumerate(tensors)]
            ins = [t.detach().requires_grad_(t.requires_grad) for t in ins]
            y, carry = step(*ins)
        ctx.n, ctx.nx, ctx.ins, ctx.outs = n, nx, ins, (y, carry)
        ys = y.new_empty((y.shape[0], n) + tuple(y.shape[1:]))
        ctx.save_for_backward(ys)
        return ys, carry.detach()

    @staticmethod
    def backward(ctx, g_ys, g_carry):
        ctx.saved_tensors  # unpacked at trip count 1: an enclosing checkpoint recomputes here
        live = [t for t in ctx.ins if t.requires_grad]
        outs = [o for o, g in zip(ctx.outs, (g_ys, g_carry)) if g is not None and o.requires_grad]
        grads_out = [g.select(1, 0) if o is ctx.outs[0] else g
                     for o, g in zip(ctx.outs, (g_ys, g_carry)) if g is not None and o.requires_grad]
        with _standing_for(ctx.n):
            got = iter(torch.autograd.grad(outs, live, grads_out, allow_unused=True) if outs and live else ())
        grads = []
        for i, t in enumerate(ctx.ins):
            g = next(got) if t.requires_grad else None
            if g is not None and i < ctx.nx:  # every position's gradient has step 0's shape
                g = g.unsqueeze(1).expand((g.shape[0], ctx.n) + tuple(g.shape[1:]))
            grads.append(g)
        return (None, None, None, None, *grads)


def meta_scan(step, n: int, xs, consts, carry):
    """The meta-device stand-in of
    ``for t in range(n): y_t, carry = step(*(x[:, t] for x in xs), *consts, carry)``
    returning ``(ys stacked on dim 1, carry)``: one step runs, with the
    outputs' shapes right, and ``launch.op_cost`` counts its ops (and under
    autograd its backward's) ``n`` times, as ``repro.launch.jaxpr_cost``
    multiplies a ``scan`` body by its length."""
    if not torch.is_grad_enabled():
        with _standing_for(n):
            y, carry = step(*(x.select(1, 0) for x in xs), *consts, carry)
        return y.new_empty((y.shape[0], n) + tuple(y.shape[1:])), carry
    return _OneStep.apply(step, n, len(xs), len(consts), *xs, *consts, carry)
