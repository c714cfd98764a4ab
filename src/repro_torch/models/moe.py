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
``moe_dispatch_sharding`` pins the ``(E, C, d)`` layout on a mesh in the
reference: the sharded steps lay it out (``models.tp.moe``, through
``moe_apply``'s ``dispatch``); on one rank it changes nothing, as in the
reference without a mesh.

Where the reference scatters with ``mode="drop"`` at an out-of-range
slot, the port's tables have one padding slot past their end: a dropped
choice is written there and the slot is sliced off (``index_put_`` raises
on an index out of range, and selecting the kept choices with a mask would
sync the host). Its ``k``-gather combine reads a dropped choice at queue
position 0 before masking it out (JAX's gather clamps the position instead;
either value is masked). MoE has no Pallas kernel in the reference: these
are PyTorch ops.

**Routing over the data-parallel groups.** The reference routes the
global microbatch; in the port's sharded step each dp group's computing
rank holds only its rows. With ``route=`` (a :class:`GlobalRouting`)
``moe_apply`` routes as if it saw every group's tokens: the capacity comes
from the global token count, each pass's per-expert pick counts are
exchanged over the dp axes so a group's queue positions continue where the
earlier groups' (in row order) stop, and the aux loss comes back as its
sums (:func:`router_aux_from_sums` forms it after the caller's
all-reduce). A layer recomputed by ``remat`` in the caller's backward runs
outside the region, where no collective may be issued: it reads back the
exchange its forward made (``models.tp.remat``).
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import all_gather
from repro_torch.core.streams import StreamComm
from repro_torch.models.config import ModelConfig
from repro_torch.tracing import span

__all__ = ["moe_capacity", "moe_apply", "router_aux_loss", "router_aux_from_sums", "GlobalRouting", "observers"]

#: callbacks ``fn(dropped)`` told of every routing ``moe_apply`` computes
#: (``dropped``: the choices past their expert's capacity, an integer
#: tensor); a remat policy's recompute is a routing too, so count under
#: ``torch.no_grad()``, where nothing is recomputed
observers: List[Callable[[torch.Tensor], None]] = []


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


def router_aux_from_sums(cfg: ModelConfig, sums: torch.Tensor) -> torch.Tensor:
    """The summed aux loss of the MoE layers whose routing sums ``sums``
    (L, 2E+2) holds, each row ``moe_apply(route=)``'s, summed over the dp
    groups: ``router_aux_weight · E · Σ_e f_e · P_e`` per layer, ``f`` and
    ``P`` the row's top-1 counts and summed probabilities over its token
    count (the last entry)."""
    E = cfg.moe.n_experts
    n = sums[:, -1:]
    per_layer = E * torch.sum((sums[:, :E] / n) * (sums[:, E: 2 * E] / n), dim=1)
    return torch.sum(per_layer) * cfg.moe.router_aux_weight


class GlobalRouting:
    """One rank's view of the routing over every dp group of the sharded
    step (the module docstring). ``comm`` is the rank's :class:`StreamComm`
    over the dp axes (bound to the mesh), whose group-rank order is the
    batch's row order."""

    def __init__(self, comm: StreamComm):
        self.comm, self.n_groups = comm, comm.size()
        self.rank = comm.rank()  # read in the region: a remat recompute runs outside it

    def offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """(k, E) queue offsets of this group's choices, pass by pass, from
        ``counts`` (k, E), this group's picks per expert in each pass: every
        group's picks in the earlier passes, then the earlier groups' in
        this pass."""
        every, _ = all_gather(counts, self.comm, axis=0, tiled=False)  # (G, k, E)
        per_pass = every.sum(0)
        return torch.cumsum(per_pass, dim=0) - per_pass + every[: self.rank].sum(0)


def _expert_ffn(p, xe):
    """The grouped SwiGLU of the experts ``p`` holds on ``xe`` (E_l, C, d)."""
    g = F.silu(torch.bmm(xe, p["we_gate"].to(xe.dtype)))
    u = torch.bmm(xe, p["we_up"].to(xe.dtype))
    return torch.bmm(g * u, p["we_down"].to(xe.dtype))


def moe_apply(cfg: ModelConfig, p, x, train: bool = False, route: GlobalRouting | None = None,
              experts: Tuple[int, int] | None = None, dispatch: Callable | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) → (y (B,S,d), aux loss scalar). ``p`` holds ``router``
    (d,E) fp32, ``we_gate``/``we_up`` (E,d,de), ``we_down`` (E,de,d) and,
    with shared experts, ``shared`` (a nested mapping: a plain dict's key
    or an ``nn.ParameterDict``'s child module) with ``w_gate``/``w_up``/``w_down``.
    ``train`` selects the capacity regime (see :func:`moe_capacity`).

    With ``route`` the tokens are one dp group's rows of the microbatch
    (the module docstring) and the aux comes back as its sums, a (2E+2,)
    fp32 row: the top-1 counts, the summed probabilities, the dropped
    choices and the token count.

    With ``experts=(e0, e1)`` (expert parallelism, ``models.tp.moe``) the
    stacks hold experts ``[e0, e1)`` of ``E`` only: the routing is the
    same over all ``E``, but only the choices of those experts are
    dispatched and combined, so the outputs of the ranks that hold the
    other experts add up to the whole; this partial comes back in fp32
    (``models.tp.RankWeights.leave`` rounds the sum once)."""
    m = cfg.moe
    B, S, d = x.shape
    N = B * S
    E, k = m.n_experts, m.top_k
    C = moe_capacity(N * (route.n_groups if route is not None else 1), cfg, train=train)
    xf = x.reshape(N, d)

    with span("moe.route"):
        # --- route (fp32) --------------------------------------------------
        probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)  # (N,E)
        topv, topi = torch.topk(probs, k, dim=-1)  # (N,k), largest first
        gates = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

        # --- position-in-expert: k passes, tokens in row-major B*S order ------
        within_cols, counts = [], []
        for j in range(k):
            oh = F.one_hot(topi[:, j], E)  # (N,E)
            within = torch.cumsum(oh, dim=0) - oh  # exclusive count per expert
            within_cols.append(within.gather(1, topi[:, j : j + 1])[:, 0])
            counts.append(oh.sum(0))
        counts = torch.stack(counts)  # (k,E)
        base = route.offsets(counts) if route is not None else torch.cumsum(counts, dim=0) - counts
        pos = torch.stack([c + base[j][topi[:, j]] for j, c in enumerate(within_cols)], dim=1)  # (N,k)
        keep = pos < C
        for fn in observers:
            fn(torch.sum(~keep))
        if route is None:
            aux = router_aux_loss(probs, topi, E) * m.router_aux_weight
        else:
            top1 = F.one_hot(topi[:, 0], E).sum(0).float()
            aux = torch.cat([top1, probs.sum(0), torch.sum(~keep).float()[None], top1.new_full((1,), float(N))])

        # --- dispatch: token-id table (E,C), sentinel N, then gather ----------
        # flat (e, c) of every kept choice, unique by construction; a dropped
        # choice goes to the padding slot E*C, sliced off below
        slot = torch.where(keep, topi * C + pos, E * C).reshape(-1)
        table = torch.full((E * C + 1,), N, dtype=torch.long, device=x.device)
        table[slot] = torch.arange(N, device=x.device)[:, None].expand(N, k).reshape(-1)
        table = table[: E * C]
        e0, e1 = experts if experts is not None else (0, E)
        if experts is not None:  # this rank's experts only
            keep = keep & (topi >= e0) & (topi < e1)
            table = table[e0 * C: e1 * C]
        x_pad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)

    with span("moe.experts"):
        # --- grouped expert FFN ----------------------------------------------
        if dispatch is not None and C % 16 == 0:
            ye = dispatch(table.view(e1 - e0, C), x_pad, lambda xe: _expert_ffn(p, xe))
        else:
            ye = _expert_ffn(p, x_pad[table.view(e1 - e0, C)])  # (E,C,d)

    with span("moe.combine"):
        # --- combine -----------------------------------------------------------
        odt = x.dtype if experts is None else torch.float32
        if cfg.moe_scatter_combine:
            gate_table = torch.zeros((E * C + 1,), dtype=torch.float32, device=x.device)
            gate_table[slot] = gates.reshape(-1)
            yw = ye * gate_table[e0 * C: e1 * C].view(e1 - e0, C, 1).to(ye.dtype)
            out = x.new_zeros((N + 1, d), dtype=odt).index_add_(0, table, yw.reshape(-1, d).to(odt))[:N]
        else:
            out = x.new_zeros((N, d), dtype=odt)
            cpos = torch.where(keep, pos, torch.zeros_like(pos))
            ei = topi if experts is None else (topi - e0).clamp(0, e1 - e0 - 1)
            for j in range(k):
                yj = ye[ei[:, j], cpos[:, j]].to(odt)  # (N,d)
                out = out + torch.where(keep[:, j, None], gates[:, j, None].to(odt) * yj, torch.zeros_like(yj))

        # --- shared experts ----------------------------------------------------
        if m.n_shared:
            sp = p["shared"]
            sg = F.silu(xf @ sp["w_gate"].to(xf.dtype))
            su = xf @ sp["w_up"].to(xf.dtype)
            if experts is None:
                out = out + (sg * su) @ sp["w_down"].to(xf.dtype)
            else:
                out = out + (sg * su).float() @ sp["w_down"].float()

    return out.reshape(B, S, d), aux
