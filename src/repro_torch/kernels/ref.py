"""Plain-torch oracles for the port's kernels (the allclose ground truth),
mirroring ``repro.kernels.ref``."""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref", "wkv6_ref", "pack_ref", "unpack_ref"]


def attention_ref(q, k, v, causal: bool = True):
    """q/k/v (BH, S, d). fp32 softmax, no blocking."""
    BH, S, d = q.shape
    s = torch.einsum("bsd,btd->bst", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p, v.float()).to(q.dtype)


def wkv6_ref(w, r, k, v, bonus, state0):
    """Per-token WKV recurrence. w/r/k/v (B,S,H,hs) fp32; bonus (H,hs);
    state0 (B,H,hs,hs). Returns (y, state)."""
    state = state0
    ys = []
    for t in range(w.shape[1]):
        w_t, r_t, k_t, v_t = w[:, t], r[:, t], k[:, t], v[:, t]
        kv = torch.einsum("bhi,bhj->bhij", k_t, v_t)
        ys.append(torch.einsum("bhi,bhij->bhj", r_t, state + bonus[None, :, :, None] * kv))
        state = w_t[..., None] * state + kv
    return torch.stack(ys, dim=1), state


def pack_ref(src, seg_len: int):
    return src[:, :seg_len]


def unpack_ref(packed, stride: int):
    nseg, seg_len = packed.shape
    out = torch.zeros((nseg, stride), dtype=packed.dtype, device=packed.device)
    out[:, :seg_len] = packed
    return out
