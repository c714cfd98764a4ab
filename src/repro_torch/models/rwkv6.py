"""RWKV-6 "Finch" (arXiv:2404.05892) in PyTorch: attention-free LM with
data-dependent per-channel decay.

Mirrors ``repro.models.rwkv6`` operation for operation. Time-mix:
token-shift lerp with low-rank data-dependent deltas (the ``maa`` LoRA),
data-dependent decay ``w = exp(-exp(w0 + lora(x)))`` computed in fp32, and
the matrix-valued WKV state S (H, 64, 64) in fp32:

    y_t = r_t · (S_{t-1} + u ⊙ kᵀ_t v_t)
    S_t = diag(w_t) S_{t-1} + kᵀ_t v_t

followed by a per-head groupnorm (population variance, eps 64e-5) in fp32,
the gate ``g`` and the output projection. Channel-mix is
``sigmoid(xr W_r) * (relu(xk W_k)² W_v)``.

**Which route runs the WKV recurrence.** ``rwkv_forward(..., use_kernel)``:

* ``True`` is the reference's kernel path: ``ops.wkv6`` with chunk 64,
  which launches K3 (``csrc/rwkv6_scan.cu``) for CUDA tensors and runs its
  plain chunked version for CPU tensors. ``S % 64 != 0`` raises
  ``ValueError`` where the reference asserts.
* ``False`` is the reference's default path: the per-token recurrence
  (:func:`_wkv_scan`). The reference runs it as a 128-chunked ``lax.scan``
  under ``jax.checkpoint``, which computes the same thing and only saves
  memory under autodiff; here it is a Python loop over time.
* ``None`` (what :mod:`repro_torch.models.api` passes, so what
  ``ServeEngine`` runs) takes the kernel when ``cfg.attn_impl == "flash"``
  and ``S % 64 == 0``, and the default path otherwise. The JAX
  ``rwkv6.py`` ignores ``attn_impl`` and nothing in its serving path sets
  ``use_kernel``; the port reaches K3 through the same switch that reaches
  the flash kernel for the transformer, and adds no option. Decode
  (S = 1) therefore never launches K3.

The state keeps the reference's layout, every leaf stacked per layer on
axis 0 with the batch on axis 1, so ``ServeEngine``'s splice holds:
``{"x_tm": (L,B,d), "x_cm": (L,B,d), "wkv": (L,B,H,64,64) fp32}``.
:func:`rwkv_loss` takes the default route, as the reference's does, so
the trainer differentiates it; under autograd with inputs that need a
gradient the kernel route raises ``NotImplementedError`` (K3 has no
backward, nor has the reference's kernel).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import (
    apply_norm,
    dense_init,
    embed,
    embed_params,
    logits_out,
    meta_scan,
    next_token_xent,
    norm_params,
)
from repro_torch.models.config import ModelConfig

__all__ = [
    "RWKVLayer",
    "RWKVLM",
    "init_rwkv",
    "init_state",
    "rwkv_forward",
    "rwkv_loss",
    "rwkv_prefill",
    "rwkv_decode_step",
    "HEAD_SIZE",
    "KERNEL_CHUNK",
]

HEAD_SIZE = 64
MAA_RANK = 32
DECAY_RANK = 64
#: chunk of the kernel route (the reference's ``wkv6_chunked`` default)
KERNEL_CHUNK = 64
STATE_KEYS = ("x_tm", "x_cm", "wkv")


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_SIZE


def _param(t: torch.Tensor) -> nn.Parameter:
    # created without gradients: serving never takes them, and the trainer
    # turns them on for the model it trains
    return nn.Parameter(t, requires_grad=False)


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(t) for k, t in tensors.items()})


class RWKVLayer(nn.Module):
    """One RWKV-6 block. Parameter names follow the JAX package's per-layer
    tree: ``ln1``, ``ln2`` and ``ln_x`` are norm dicts, every other leaf
    lives in ``p`` under its reference name (``mu_x``, ``maa_w1``, ``w0``,
    ``bonus``, ``wr`` ... ``wr_c``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, H = cfg.d_model, _n_heads(cfg)
        empty = lambda *shape: torch.empty(shape, dtype=cfg.pdtype, device=device)
        self.ln1 = _params(norm_params(cfg, d, device))
        self.ln2 = _params(norm_params(cfg, d, device))
        self.ln_x = _params({"w": empty(d), "b": empty(d)})
        self.p = _params({
            "mu_x": empty(d),
            "mu_wkvrg": empty(5, d),
            "maa_w1": empty(d, 5 * MAA_RANK),
            "maa_w2": empty(5, MAA_RANK, d),
            "w0": empty(d),
            "decay_w1": empty(d, DECAY_RANK),
            "decay_w2": empty(DECAY_RANK, d),
            "bonus": empty(H, HEAD_SIZE),
            "wr": empty(d, d),
            "wk": empty(d, d),
            "wv": empty(d, d),
            "wg": empty(d, d),
            "wo": empty(d, d),
            "mu_k_c": empty(d),
            "mu_r_c": empty(d),
            "wk_c": empty(d, cfg.d_ff),
            "wv_c": empty(cfg.d_ff, d),
            "wr_c": empty(d, d),
        })

    def leaf_names(self):
        """The reference's per-layer keys."""
        return set(self.p.keys()) | {"ln1", "ln2", "ln_x"}


class RWKVLM(nn.Module):
    """Embedding (untied ``tok``/``out`` as configured), ``layers`` in
    execution order, final norm. The forward functions take the config
    explicitly, so one set of weights serves both ``attn_impl`` settings."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.d_model % HEAD_SIZE:
            raise ValueError(f"{cfg.name}: d_model {cfg.d_model} is not a multiple of the head size {HEAD_SIZE}")
        emb = {"tok": torch.empty((cfg.vocab, cfg.d_model), dtype=cfg.pdtype, device=device)}
        if not cfg.tie_embeddings:
            emb["out"] = torch.empty((cfg.d_model, cfg.vocab), dtype=cfg.pdtype, device=device)
        self.embed = _params(emb)
        self.final_norm = _params(norm_params(cfg, cfg.d_model, device))
        self.layers = nn.ModuleList(RWKVLayer(cfg, device) for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.final_norm["w"].device


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------


@torch.no_grad()
def init_rwkv(cfg: ModelConfig, generator: torch.Generator, device) -> RWKVLM:
    """Random init with the reference's distributions, drawn from
    ``generator`` in fp32 and cast to ``cfg.param_dtype``: token embedding
    0.02, untied output and the five time-mix and three channel-mix
    projections ``1/sqrt(fan_in)``, the ``maa`` and decay LoRAs 0.01, the
    bonus 0.1; ``mu_*`` 0.5, ``w0`` -6, ``ln_x`` ones/zeros, norms as
    :func:`~repro_torch.models.common.norm_params`.

    The reference draws ``wr_c`` from the same key as ``wk_c`` (``ks[12]``
    twice, ``rwkv6.py:86-88``); here every leaf gets its own draws. Weights
    carried across with ``params_from_numpy`` keep whatever the reference
    drew, so this does not change any comparison."""
    model = RWKVLM(cfg, device)
    for k, t in embed_params(cfg, generator, device).items():
        model.embed[k].copy_(t)
    pd = cfg.pdtype
    for layer in model.layers:
        p = layer.p
        for name in ("mu_x", "mu_wkvrg", "mu_k_c", "mu_r_c"):
            p[name].fill_(0.5)
        p["w0"].fill_(-6.0)
        layer.ln_x["w"].fill_(1.0)
        layer.ln_x["b"].zero_()
        for name, scale in (("maa_w1", 0.01), ("maa_w2", 0.01), ("decay_w1", 0.01), ("decay_w2", 0.01),
                            ("bonus", 0.1), ("wr", None), ("wk", None), ("wv", None), ("wg", None),
                            ("wo", None), ("wk_c", None), ("wv_c", None), ("wr_c", None)):
            p[name].copy_(dense_init(generator, p[name].shape, scale, pd, device))
    return model


def init_state(cfg: ModelConfig, B: int, max_len: int = 0, device="cuda"):
    """O(1) recurrent state per layer (``max_len`` ignored — that's the point)."""
    L, H, d = cfg.n_layers, _n_heads(cfg), cfg.d_model
    return {
        "x_tm": torch.zeros((L, B, d), dtype=cfg.cdtype, device=device),
        "x_cm": torch.zeros((L, B, d), dtype=cfg.cdtype, device=device),
        "wkv": torch.zeros((L, B, H, HEAD_SIZE, HEAD_SIZE), dtype=torch.float32, device=device),
    }


# ----------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------


def _time_mix_projections(p, x, x_prev_first):
    """x (B,S,d); x_prev_first (B,d) = last token of the previous segment.
    Returns per-time (w, r, k, v, g) of shape (B,S,d) and x's last token."""
    B, S, d = x.shape
    cd = x.dtype
    x_prev = torch.cat([x_prev_first[:, None], x[:, :-1]], dim=1)
    dx = x_prev - x
    xxx = x + dx * p["mu_x"].to(cd)
    maa = torch.tanh(xxx @ p["maa_w1"].to(cd)).reshape(B, S, 5, MAA_RANK)
    maa = torch.einsum("bsfr,frd->bsfd", maa, p["maa_w2"].to(cd))
    mu = p["mu_wkvrg"].to(cd)
    xw, xk, xv, xr, xg = [x + dx * (mu[i] + maa[:, :, i]) for i in range(5)]
    lora = torch.tanh(xw @ p["decay_w1"].to(cd)) @ p["decay_w2"].to(cd)
    w = torch.exp(-torch.exp(p["w0"].float() + lora.float()))  # (B,S,d) in (0,1), fp32
    r = xr @ p["wr"].to(cd)
    k = xk @ p["wk"].to(cd)
    v = xv @ p["wv"].to(cd)
    xg = xg @ p["wg"].to(cd)
    g = xg * torch.sigmoid(xg)  # jax.nn.silu's two roundings in bf16
    return w, r, k, v, g, x[:, -1]


def _wkv_step(w_t, r_t, k_t, v_t, bonus, state):
    kv = k_t[:, :, :, None] * v_t[:, :, None, :]
    y = torch.einsum("bhi,bhij->bhj", r_t, state + bonus[None, :, :, None] * kv)
    return y, w_t[:, :, :, None] * state + kv


def _wkv_scan(w, r, k, v, bonus, state):
    """The per-token WKV recurrence. w/r/k/v (B,S,H,hs) fp32, state
    (B,H,hs,hs) fp32. Returns (y (B,S,H,hs), state). On meta tensors one
    step stands for all (``common.meta_scan``)."""
    if w.is_meta:
        return meta_scan(_wkv_step, w.shape[1], (w, r, k, v), (bonus,), state)
    ys = []
    for t in range(w.shape[1]):
        y, state = _wkv_step(w[:, t], r[:, t], k[:, t], v[:, t], bonus, state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _time_mix(cfg: ModelConfig, layer: RWKVLayer, x, x_last, wkv, use_kernel: bool):
    B, S, d = x.shape
    p = layer.p
    w, r, k, v, g, x_last = _time_mix_projections(p, x, x_last)
    shp = (B, S, _n_heads(cfg), HEAD_SIZE)
    w32, r32, k32, v32 = (a.float().reshape(shp) for a in (w, r, k, v))
    bonus = p["bonus"].float()
    if use_kernel:
        yh, wkv = ops.wkv6(w32, r32, k32, v32, bonus, wkv, chunk=KERNEL_CHUNK)
    else:
        yh, wkv = _wkv_scan(w32, r32, k32, v32, bonus, wkv)
    # per-head groupnorm, fp32
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, d) * layer.ln_x["w"].float() + layer.ln_x["b"].float()
    y = y.to(x.dtype) * g
    return y @ p["wo"].to(x.dtype), x_last, wkv


def _channel_mix(p, x, x_prev_first):
    cd = x.dtype
    x_prev = torch.cat([x_prev_first[:, None], x[:, :-1]], dim=1)
    dx = x_prev - x
    xk = x + dx * p["mu_k_c"].to(cd)
    xr = x + dx * p["mu_r_c"].to(cd)
    k = torch.square(torch.relu(xk @ p["wk_c"].to(cd)))
    return torch.sigmoid(xr @ p["wr_c"].to(cd)) * (k @ p["wv_c"].to(cd)), x[:, -1]


def _layer(cfg: ModelConfig, layer: RWKVLayer, x, st, use_kernel: bool):
    a, x_tm, wkv = _time_mix(cfg, layer, apply_norm(cfg, layer.ln1, x), st["x_tm"], st["wkv"], use_kernel)
    x = x + a
    c, x_cm = _channel_mix(layer.p, apply_norm(cfg, layer.ln2, x), st["x_cm"])
    return x + c, {"x_tm": x_tm, "x_cm": x_cm, "wkv": wkv}


# ----------------------------------------------------------------------
# model-level API (the transformer's contract)
# ----------------------------------------------------------------------


def _route(cfg: ModelConfig, S: int, use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        return cfg.attn_impl == "flash" and S % KERNEL_CHUNK == 0
    if use_kernel and S % KERNEL_CHUNK:
        raise ValueError(f"the WKV kernel route needs S % {KERNEL_CHUNK} == 0, got S={S}")
    return bool(use_kernel)


def _tokens(model: RWKVLM, tokens) -> torch.Tensor:
    if isinstance(tokens, np.ndarray):
        tokens = torch.from_numpy(tokens)
    return tokens.to(device=model.device, dtype=torch.long)


def _trunk(cfg: ModelConfig, model: RWKVLM, tokens, state, use_kernel, out=None):
    """Every layer over ``tokens`` from ``state`` (zeros when None).
    Returns (final-normed activations, new state). With ``out`` the new
    state is written into ``out`` layer by layer (``out`` may be ``state``
    itself: layer ``l``'s entries are read only by layer ``l``, before it
    writes them) — for the no-grad serving paths; without, it is stacked
    afresh, which autograd can differentiate."""
    x = embed(cfg, model.embed, tokens)
    route = _route(cfg, x.shape[1], use_kernel)
    if state is None:
        state = init_state(cfg, x.shape[0], device=x.device)
    new = {key: [] for key in STATE_KEYS}
    for l, layer in enumerate(model.layers):
        x, st = _layer(cfg, layer, x, {key: state[key][l] for key in STATE_KEYS}, route)
        for key in STATE_KEYS:
            if out is None:
                new[key].append(st[key])
            else:
                out[key][l].copy_(st[key])
    new = out if out is not None else {key: torch.stack(v) for key, v in new.items()}
    return apply_norm(cfg, model.final_norm, x), new


def rwkv_forward(cfg: ModelConfig, model: RWKVLM, batch, state=None, use_kernel: Optional[bool] = None):
    """Returns (logits (B,S,vocab), new state). ``state`` (default: zeros)
    is not modified."""
    x, new = _trunk(cfg, model, _tokens(model, batch["tokens"]), state, use_kernel)
    return logits_out(cfg, model.embed, x), new


def rwkv_loss(cfg: ModelConfig, model: RWKVLM, batch):
    """Scalar next-token loss (+metrics dict), on the default (per-token)
    route whatever ``attn_impl`` says: the reference's ``rwkv_loss``."""
    logits, _ = rwkv_forward(cfg, model, batch, use_kernel=False)
    tokens = _tokens(model, batch["tokens"])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = _tokens(model, mask)
    loss = next_token_xent(logits, tokens, mask)
    return loss, {"xent": loss, "loss": loss}


@torch.no_grad()
def rwkv_prefill(cfg: ModelConfig, model: RWKVLM, batch, max_len=None):
    """(last-position logits (B,vocab), state after the prompt). Only the
    last position's logits are computed: they equal the reference's
    full-sequence logits taken at ``[:, -1]``. ``max_len`` is ignored."""
    tokens = _tokens(model, batch["tokens"])
    state = init_state(cfg, tokens.shape[0], device=model.device)
    x, state = _trunk(cfg, model, tokens, state, None, out=state)
    return logits_out(cfg, model.embed, x[:, -1]), state


@torch.no_grad()
def rwkv_decode_step(cfg: ModelConfig, model: RWKVLM, state, tokens, pos):
    """One token for every row. tokens (B,); ``pos`` is ignored (the state
    carries the history). The state tensors are updated **in place**, where
    the reference returns new ones; the same dict is returned."""
    tokens = _tokens(model, tokens)
    x, state = _trunk(cfg, model, tokens[:, None], state, None, out=state)
    return logits_out(cfg, model.embed, x)[:, 0], state
