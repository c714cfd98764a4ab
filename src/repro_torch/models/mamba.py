"""Mamba-1 selective-SSM block (for Jamba, arXiv:2403.19887), in PyTorch.

Mirrors ``repro.models.mamba`` operation for operation. Jamba flavour:
RMSNorm on dt/B/C, d_state 16, d_conv 4, expand 2. The depthwise causal
conv is a shift-sum over ``d_conv`` taps; the selective scan runs
sequentially over time in fp32 with ``A = -exp(A_log)``:

    h_t = exp(dt_t · A) ⊙ h_{t-1} + (dt_t · x_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ x_t

Decode keeps an O(1) ``{"conv": (B, d_conv-1, d_inner), "ssm": (B,
d_inner, d_state) fp32}`` state. The reference has no Pallas kernel here,
only a ``lax.scan``, so the port's scan is PyTorch ops too. Where the
reference runs the scan as ``CHUNK``-step chunks under ``jax.checkpoint``
(``S % CHUNK == 0``, more than one chunk), the port checkpoints each chunk
with ``torch.utils.checkpoint`` when autograd records the forward; the
chunked and the sequential route compute the same operations in the same
order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import tp
from repro_torch.models.common import meta_scan, rms_norm
from repro_torch.models.config import ModelConfig

__all__ = ["CHUNK", "mamba_params", "init_mamba_leaves", "mamba_init_state", "mamba_full", "mamba_decode", "tp_mamba"]

CHUNK = 128


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    return s.d_inner(cfg.d_model), s.d_state, s.d_conv, s.resolved_dt_rank(cfg.d_model)


def mamba_params(cfg: ModelConfig, device) -> nn.ParameterDict:
    """The block's weights under the reference's names (uninitialised;
    ``A_log`` and ``D`` fp32 whatever the param dtype), created without
    gradients as the transformer's are."""
    d = cfg.d_model
    di, ds, dc, dtr = _dims(cfg)
    shapes = {
        "in_proj": (d, 2 * di),
        "conv_w": (dc, di),
        "conv_b": (di,),
        "x_proj": (di, dtr + 2 * ds),
        "dt_proj": (dtr, di),
        "dt_bias": (di,),
        "A_log": (di, ds),
        "D": (di,),
        "dt_norm": (dtr,),
        "b_norm": (ds,),
        "c_norm": (ds,),
        "out_proj": (di, d),
    }
    fp32 = ("A_log", "D")
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(s, dtype=torch.float32 if k in fp32 else cfg.pdtype, device=device),
                        requires_grad=False)
        for k, s in shapes.items()
    })


@torch.no_grad()
def init_mamba_leaves(cfg: ModelConfig, p) -> None:
    """The reference's fixed leaves: ``dt_bias`` -4.6 (softplus⁻¹(0.01)),
    ``A_log`` log(1..d_state) on every channel, ``D`` ones."""
    ds = cfg.ssm.d_state
    p["dt_bias"].fill_(-4.6)
    p["A_log"].copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=p["A_log"].device)).expand_as(
        p["A_log"]))
    p["D"].fill_(1.0)


def mamba_init_state(cfg: ModelConfig, B: int, device) -> dict:
    di, ds, dc, _ = _dims(cfg)
    return {
        "conv": torch.zeros((B, dc - 1, di), dtype=cfg.cdtype, device=device),
        "ssm": torch.zeros((B, di, ds), dtype=torch.float32, device=device),
    }


def _causal_conv(p, x, conv_state):
    """Depthwise causal conv via shift-sum (d_conv is tiny). x (B,S,di);
    conv_state (B, dc-1, di) = trailing inputs of the previous segment.
    The new state is the last ``dc-1`` rows of the concatenation."""
    dc = p["conv_w"].shape[0]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)  # (B, S+dc-1, di)
    S = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(dc):
        out = out + xp[:, i : i + S] * p["conv_w"][i].to(x.dtype)
    return out + p["conv_b"].to(x.dtype), xp[:, xp.shape[1] - (dc - 1) :]


def _silu(x):
    return x * torch.sigmoid(x)  # jax.nn.silu's two roundings in bf16


def _ssm_inputs(cfg: ModelConfig, p, xc):
    """xc (B,S,di) post-conv+silu → (dt, B_, C_) fp32."""
    dtr, ds = cfg.ssm.resolved_dt_rank(cfg.d_model), cfg.ssm.d_state
    x_dbl = xc @ p["x_proj"].to(xc.dtype)
    dt_r, B_, C_ = torch.split(x_dbl, [dtr, ds, ds], dim=-1)
    dt_r = rms_norm(dt_r, p["dt_norm"])
    B_ = rms_norm(B_, p["b_norm"]).float()
    C_ = rms_norm(C_, p["c_norm"]).float()
    dt = F.softplus((dt_r @ p["dt_proj"].to(xc.dtype)).float() + p["dt_bias"].float())  # (B,S,di)
    return dt, B_, C_


def _ssm_step(dt_t, B_t, C_t, x_t, A, D, h):
    dA = torch.exp(dt_t[..., None] * A)  # (B,di,ds)
    dBx = (dt_t * x_t)[..., None] * B_t[:, None, :]
    h = dA * h + dBx
    return torch.einsum("bds,bs->bd", h, C_t) + D * x_t, h


def _ssm_scan(dt, B_, C_, x32, A, D, h):
    """Sequential selective scan. dt/x32 (B,c,di); B_/C_ (B,c,ds); h
    (B,di,ds). Returns y (B,c,di), h'. On meta tensors one step stands for
    all (``common.meta_scan``)."""
    if dt.is_meta:
        return meta_scan(_ssm_step, dt.shape[1], (dt, B_, C_, x32), (A, D), h)
    ys = []
    for t in range(dt.shape[1]):
        y, h = _ssm_step(dt[:, t], B_[:, t], C_[:, t], x32[:, t], A, D, h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _scan(dt, B_, C_, x32, A, D, h):
    """:func:`_ssm_scan`, as ``CHUNK``-step chunks each under
    ``torch.utils.checkpoint`` where autograd records the forward (``S %
    CHUNK == 0``, more than one chunk), as the reference's ``jax.checkpoint``."""
    S = dt.shape[1]
    if not (S % CHUNK == 0 and S // CHUNK > 1 and torch.is_grad_enabled()):
        return _ssm_scan(dt, B_, C_, x32, A, D, h)
    ys = []
    for c in range(0, S, CHUNK):
        sl = slice(c, c + CHUNK)
        y, h = checkpoint(_ssm_scan, dt[:, sl], B_[:, sl], C_[:, sl], x32[:, sl], A, D, h, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_full(cfg: ModelConfig, p, x, state=None):
    """x (B,S,d) → (y (B,S,d), new state). ``state`` (default zeros) is not
    modified."""
    B, S, _ = x.shape
    if state is None:
        state = mamba_init_state(cfg, B, x.device)
    xz = x @ p["in_proj"].to(x.dtype)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    xc, conv_state = _causal_conv(p, x_in, state["conv"])
    xc = _silu(xc)
    dt, B_, C_ = _ssm_inputs(cfg, p, xc)
    A = -torch.exp(p["A_log"].float())  # (di,ds)
    D = p["D"].float()
    x32 = xc.float()
    y, h = _scan(dt, B_, C_, x32, A, D, state["ssm"])
    y = y.to(x.dtype) * _silu(z)
    return y @ p["out_proj"].to(x.dtype), {"conv": conv_state, "ssm": h}


def mamba_decode(cfg: ModelConfig, p, x, state):
    """Single-token step: x (B,1,d)."""
    return mamba_full(cfg, p, x, state)


def tp_mamba(cfg: ModelConfig, w, pre: str, x, state, split: bool):
    """:func:`mamba_full` on the rank: with ``split`` (the state's
    ``d_inner`` over ``model``) on the rank's channel share, else on every
    channel. ``in_proj`` is ``(None, "model")`` over the concatenated
    ``[x | z]`` (width ``2·d_inner``), so its column blocks are not channel
    shares (at ``model = 2`` rank 0 holds all of ``x``, rank 1 all of
    ``z``): the leaf is gathered whole and both halves cut to the share.
    ``x_proj`` is row-parallel (a small all-reduce of dt, B and C),
    ``out_proj`` row-parallel. ``state`` holds the rank's ``conv`` (B,
    d_conv-1, di_l) and ``ssm`` (B, di_l, ds) blocks, written in place; None
    (the training loss) starts from zeros and keeps nothing."""
    di, ds, dc, dtr = _dims(cfg)
    c0, c1 = w.share(di) if split else (0, di)
    if state is None:
        zero = mamba_init_state(cfg, x.shape[0], x.device)
        state, keep = {"conv": zero["conv"][..., c0:c1], "ssm": zero["ssm"][:, c0:c1]}, False
    else:
        keep = True
    ch = (lambda n, dim: w.part(pre + n, dim, di)) if split else (lambda n, dim: w.whole(pre + n))
    xz = x @ w.whole(pre + "in_proj").to(x.dtype)
    x_in, z = xz[..., c0:c1], xz[..., di + c0: di + c1]
    p = {"conv_w": ch("conv_w", 1), "conv_b": ch("conv_b", 0)}
    xc, conv_state = _causal_conv(p, x_in, state["conv"])
    xc = _silu(xc)
    x_dbl = w.sum(xc.float() @ ch("x_proj", 0).float()).to(xc.dtype) if split else xc @ ch("x_proj", 0).to(
        xc.dtype)
    dt_r, B_, C_ = torch.split(x_dbl, [dtr, ds, ds], dim=-1)
    dt_r = rms_norm(dt_r, w.whole(pre + "dt_norm"))
    B_ = rms_norm(B_, w.whole(pre + "b_norm")).float()
    C_ = rms_norm(C_, w.whole(pre + "c_norm")).float()
    dt = F.softplus((dt_r @ ch("dt_proj", 1).to(xc.dtype)).float() + ch("dt_bias", 0).float())
    A = -torch.exp(ch("A_log", 0).float())
    y, h = _scan(dt, B_, C_, xc.float(), A, ch("D", 0).float(), state["ssm"])
    if keep:
        state["conv"].copy_(conv_state)
        state["ssm"].copy_(h)
    y = y.to(x.dtype) * _silu(z)
    return tp.row(cfg, w, y, pre + "out_proj", di) if split else y @ w.whole(pre + "out_proj").to(x.dtype)
