"""Mixture-of-Experts block: top-k router + capacity-based dispatch, in PyTorch.

Mirrors ``repro.models.moe`` operation for operation. The router runs in
fp32; each token's top-k experts get a position in their expert's queue in
the reference's order (k passes, the j-th choices of all tokens in
row-major ``B*S`` order before the (j+1)-th), and the choices past an
expert's capacity ``C`` are dropped. Kept choices fill an ``(E, C)``
token-id table (sentinel ``N`` on free slots) whose gather builds the
``(E, C, d)`` expert batch; the expert FFN is one batched product per
weight over the expert axis. The combine is either ``k`` gathers (the
default) or one gate-weighted scatter-add (``moe_scatter_combine``).
``moe_dispatch_sharding`` only pins the ``(E, C, d)`` layout on a mesh in
the reference; with no partitioner here it changes nothing, as in the
reference without a mesh.

Where the reference scatters with ``mode="drop"`` at an out-of-range
slot, the port's tables have one padding slot past their end: a dropped
choice is written there and the slot is sliced off (``index_put_`` raises
on an index out of range, and selecting the kept choices with a mask would
sync the host). Its ``k``-gather combine reads a dropped choice at queue
position 0 before masking it out (JAX's gather clamps the position instead;
either value is masked). MoE has no Pallas kernel in the reference: these
are PyTorch ops.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

__all__ = ["moe_capacity", "moe_apply", "router_aux_loss"]


def moe_capacity(n_tokens: int, cfg: ModelConfig, train: bool = False) -> int:
    """Per-expert token capacity C. Train: ``N·k·capacity_factor/E``, the
    overflow dropped. Eval (default): dropless unless
    ``eval_capacity_factor`` is set — C = N, so a token's output does not
    depend on the other tokens of its batch. Rounded up to 8, at least 8."""
    m = cfg.moe
    factor = m.capacity_factor if train else m.eval_capacity_factor
    c = n_tokens if factor is None else int(n_tokens * m.top_k * factor / m.n_experts)
    return max(8, -(-c // 8) * 8)


def router_aux_loss(probs, topi, E: int):
    """Switch-style load-balancing loss: ``E · Σ_e f_e · P_e`` with ``f_e``
    the fraction of tokens whose top-1 choice is ``e`` and ``P_e`` the mean
    router probability of ``e``."""
    f = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    return E * torch.sum(f * probs.mean(dim=0))


def moe_apply(cfg: ModelConfig, p, x, train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) → (y (B,S,d), aux loss scalar). ``p`` holds ``router``
    (d,E) fp32, ``we_gate``/``we_up`` (E,d,de), ``we_down`` (E,de,d) and,
    with shared experts, ``shared`` (a nested mapping: a plain dict's key
    or an ``nn.ParameterDict``'s child module) with ``w_gate``/``w_up``/``w_down``.
    ``train`` selects the capacity regime (see :func:`moe_capacity`)."""
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    E, k = m.n_experts, m.top_k
    C = moe_capacity(N, cfg, train=train)
    xf = x.reshape(N, d)

    # --- route (fp32) --------------------------------------------------
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)  # (N,E)
    topv, topi = torch.topk(probs, k, dim=-1)  # (N,k), largest first
    gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    aux = router_aux_loss(probs, topi, E) * m.router_aux_weight

    # --- position-in-expert: k passes, tokens in row-major B*S order ------
    running = torch.zeros((E,), dtype=torch.long, device=x.device)
    pos_cols = []
    for j in range(k):
        oh = F.one_hot(topi[:, j], E)  # (N,E)
        within = torch.cumsum(oh, dim=0) - oh  # exclusive count per expert
        pos_cols.append(within.gather(1, topi[:, j : j + 1])[:, 0] + running[topi[:, j]])
        running = running + oh.sum(0)
    pos = torch.stack(pos_cols, dim=1)  # (N,k)
    keep = pos < C

    # --- dispatch: token-id table (E,C), sentinel N, then gather ----------
    # flat (e, c) of every kept choice, unique by construction; a dropped
    # choice goes to the padding slot E*C, sliced off below
    slot = torch.where(keep, topi * C + pos, E * C).reshape(-1)
    table = torch.full((E * C + 1,), N, dtype=torch.long, device=x.device)
    table[slot] = torch.arange(N, device=x.device)[:, None].expand(N, k).reshape(-1)
    table = table[: E * C]
    x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = x_pad[table.view(E, C)]  # (E,C,d)

    # --- grouped expert FFN ----------------------------------------------
    g = F.silu(torch.bmm(xe, p["we_gate"].to(xe.dtype)))
    u = torch.bmm(xe, p["we_up"].to(xe.dtype))
    ye = torch.bmm(g * u, p["we_down"].to(xe.dtype))  # (E,C,d)

    # --- combine -----------------------------------------------------------
    if cfg.moe_scatter_combine:
        gate_table = torch.zeros((E * C + 1,), dtype=torch.float32, device=x.device)
        gate_table[slot] = gates.reshape(-1)
        yw = ye * gate_table[: E * C].view(E, C, 1).to(ye.dtype)
        out = x.new_zeros((N + 1, d)).index_add_(0, table, yw.reshape(E * C, d).to(x.dtype))[:N]
    else:
        out = x.new_zeros((N, d))
        cpos = torch.where(keep, pos, torch.zeros_like(pos))
        for j in range(k):
            yj = ye[topi[:, j], cpos[:, j]]  # (N,d)
            out = out + torch.where(keep[:, j, None], gates[:, j, None].to(x.dtype) * yj, torch.zeros_like(yj))

    # --- shared experts ----------------------------------------------------
    if m.n_shared:
        sp = p["shared"]
        sg = F.silu(xf @ sp["w_gate"].to(xf.dtype))
        su = xf @ sp["w_up"].to(xf.dtype)
        out = out + (sg * su) @ sp["w_down"].to(xf.dtype)

    return out.reshape(B, S, d), aux
