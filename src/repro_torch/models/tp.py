"""Tensor-parallel math over the mesh axis ``model``: the per-rank layers of
the sharded train step (``launch.train.make_train_step(dp=)``) and of the
sharded prefill and decode steps (``make_prefill_step`` / ``make_serve_step``
given params that ``core.mesh.device_put`` laid out under
``parallel.sharding.param_specs``).

The reference lays its weights out by ``param_specs`` (TP over ``model``:
heads, FFN hidden units, experts, vocab rows) and its decode caches by
``cache_specs`` (batch over the dp axes, the cache length ``T`` over
``model``), and GSPMD partitions its jitted steps. A mesh of thread-ranks
has no partitioner, so the port writes the partitioned math out, per rank,
inside one ``shard_map`` region. These are its pieces:

* :func:`column` — a column-parallel product: the rank's heads or hidden
  units, with their slice of the bias;
* :func:`row` — a row-parallel product, all-reduced over ``model``; a
  replicated bias is added once, after the reduce;
* :func:`embed` — the vocab-parallel embedding: ids outside the rank's
  rows masked, looked up, all-reduced;
* :func:`logits` — the vocab-parallel output projection (the untied
  ``embed.out`` or the tied ``embed.tok``), all-gathered along vocab;
* :func:`xent` — the vocab-parallel cross-entropy of the training loss:
  the logits of the rank's vocab share only, never gathered; the row
  maxima all-gathered and maxed (the port's all-reduce only sums), the
  sums of exponentials and the targets' logits (each on the rank that owns
  the target) all-reduced;
* :func:`moe` — expert parallelism: every rank routes the same
  (replicated) tokens with the replicated router, applies its own experts
  and the combine is all-reduced; in training the routing is global over
  the dp groups (``models.moe.GlobalRouting``);
* :func:`attention_full` / :func:`cache_block` — the prefill's attention
  on the rank's heads (the flash kernel K2 where the reference's gate
  lets it run) and its K/V laid into the ``T``-over-``model`` cache by one
  all-to-all over ``model``;
* :func:`attention_decode` / :func:`merge_attend` — the sequence-parallel
  decode: q all-gathered to every head, each rank attending over its
  ``T/model`` cache slots, the partials (running max, denominator,
  unnormalised output) all-gathered and merged by log-sum-exp (the port's
  all-reduce only sums, so the maxima are gathered, not reduced), each
  rank keeping its heads for the row-parallel ``wo``. The new token's K/V
  row is gathered over heads and written only by the rank whose slots hold
  its position (``pos`` differs per row).

**The leaf rule.** A rank computes on its own block only where the spec
splits the dim on a unit boundary (a head, a hidden unit, an expert, a
vocab row) into equal shares; axes other than ``model`` in the spec
(FSDP's dp axes) are gathered at the layer that reads the leaf. Where the
spec splits a leaf off those boundaries, or replicates it because it does
not divide, the rank gathers the leaf whole and takes the units of its
share, ``[n·i/M, n·(i+1)/M)`` of ``n`` units at ``model`` index ``i`` of
``M``; a rank whose q heads read a kv head it does not hold computes that
head itself (Megatron's KV-head replication). A sublayer none of whose
leaves is split over ``model`` (:meth:`RankWeights.replicated`: the dense
and attention weights under ``tp_strategy="ep_only"``) runs whole on every
rank with no collective, as GSPMD runs it. Which route a leaf takes
depends on its spec and shape only, so every rank issues the same
collectives.

**Autograd.** The collectives build one autograd graph across the ranks
(``core.collectives``), so the row-parallel reduce needs no Megatron
``f``/``g`` operator pair: the caller's one backward routes every
cotangent, the replicated activations' included. A layer under a remat
policy (:func:`remat`) logs its collectives' results in its forward and
its recompute, in the caller's backward, reads them back: each result
stays alive until the backward, where the reference's ``"full"`` policy
re-runs its all-reduces instead.

**The layout hints.** ``seq_shard_acts`` (Megatron's sequence parallelism,
:meth:`RankWeights.sequence`): the residual stream holds the rank's share
of ``S``; a sublayer's input is all-gathered along ``S``, its row-parallel
output reduce-scattered along ``S`` instead of all-reduced, its norm and
residual run on the share; where ``model`` does not divide ``S`` it
changes nothing, as a constraint that does not divide cannot split.
``moe_dispatch_sharding`` (:func:`moe`): the ``(E, C)`` slots of the
rank's experts laid capacity over ``data`` where ``C % 16 == 0`` (the
reference's condition), each token sent by an all-to-all over ``data`` to
the rank that holds its slot and its expert output brought back by the
reverse all-to-all before the combine.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import CollectiveLog, all_gather, all_reduce, all_to_all, reduce_scatter
from repro_torch.core.mesh import P, axis_index, current_region
from repro_torch.core.streams import StreamComm
from repro_torch.models import common
from repro_torch.models.common import NEG_INF, apply_norm, apply_rope, attend, causal_mask, remat_wrap
from repro_torch.models.config import ModelConfig

__all__ = ["MODEL", "DATA", "share", "RankWeights", "column", "row", "embed", "logits", "xent", "swiglu", "gelu_mlp",
           "moe", "remat",
           "qkv", "read_heads", "attention_full", "cache_block", "attention_decode", "merge_attend", "write_row",
           "seq_span", "span_block", "attention_cached", "norm"]

#: the tensor-parallel mesh axis
MODEL = "model"
#: the axis ``moe_dispatch_sharding`` lays the experts' capacity over
DATA = "data"


def share(n: int, size: int, index: int) -> Tuple[int, int]:
    """Units ``[a, b)`` of ``n`` that ``model`` index ``index`` of ``size``
    takes: the equal block where ``size`` divides ``n``, else as even a
    split as there is."""
    return n * index // size, n * (index + 1) // size


class RankWeights:
    """One rank's view of the sharded params inside a region: its blocks
    (name → block), their specs, and its place on ``model``. Leaves are
    taken by the module docstring's rule."""

    def __init__(self, blocks: Dict[str, torch.Tensor], specs: Dict[str, P], mesh):
        self.blocks, self.specs, self.mesh = blocks, specs, mesh
        self.slot = current_region().slot
        self.size = mesh.shape.get(MODEL, 1)
        self.index = axis_index(MODEL) if MODEL in mesh.shape else 0
        self.data_index = axis_index(DATA) if DATA in mesh.shape else 0  # read here: a recompute runs outside
        self.comm = StreamComm((MODEL,), mesh=mesh) if self.size > 1 else None
        self.seq = False  # under :meth:`sequence`: the residual stream holds the rank's share of S
        self.route = None  # the MoE layers' ``GlobalRouting`` over the dp axes, or None: each group alone
        self._under: Dict[str, list] = {}

    @contextmanager
    def sequence(self, on: bool):
        """Run a full-sequence forward with ``seq_shard_acts``' layout on
        (where ``on``): :meth:`leave` reduce-scatters along ``S``,
        :meth:`enter` gathers along it."""
        outer, self.seq = self.seq, on
        try:
            yield
        finally:
            self.seq = outer

    def seq_splits(self, cfg: ModelConfig, S: int) -> bool:
        """Whether ``seq_shard_acts`` splits a sequence of ``S`` over ``model``."""
        return cfg.seq_shard_acts and self.size > 1 and S % self.size == 0

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's share of ``x``'s dim 1 (``S``) under :meth:`sequence`, else ``x``."""
        if not self.seq:
            return x
        n = x.shape[1] // self.size
        return x.narrow(1, self.index * n, n)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor-parallel sublayer's input, the same on every ``model``
        rank, from the rank's residual-stream tensor ``x``: all-gathered
        along ``S`` under :meth:`sequence`, else ``x`` itself."""
        return self.gather(x, axis=1) if self.seq else x

    def leave(self, partial: torch.Tensor, dtype) -> torch.Tensor:
        """A sublayer's output from the ranks' fp32 partial sums
        ``partial``, summed over ``model`` and rounded to ``dtype`` once:
        the rank's share of ``S`` under :meth:`sequence` (a
        reduce-scatter), else the sum (an all-reduce). The single-rank
        product rounds its fp32 accumulator once, and a reduce of partials
        already rounded to bf16 would round five times (at full width that
        moves bf16 logits by more than their bound)."""
        p = partial.float()
        if self.seq and self.comm is not None:
            return reduce_scatter(p, self.comm, axis=1)[0].to(dtype)
        return self.sum(p).to(dtype)

    def replicated(self, prefix: str) -> bool:
        """Whether no leaf under ``prefix`` is split over ``model``."""
        return all(MODEL not in self.specs[n].axes for n in self.under(prefix))

    def split(self, name: str, dim: int, n: int) -> bool:
        """Whether this leaf's blocks along ``dim`` are the equal shares of
        its ``n`` units, split over ``model`` alone."""
        return self.size > 1 and self.specs[name].dim_axes(dim) == (MODEL,) and n % self.size == 0

    def _gathered(self, name: str, keep: Optional[int] = None) -> torch.Tensor:
        full, spec = self.blocks[name], self.specs[name]
        for d in range(len(spec)):
            axes = spec.dim_axes(d)
            if axes and d != keep:
                full, _ = all_gather(full, StreamComm(axes, mesh=self.mesh), axis=d)
        return full

    def whole(self, name: str) -> torch.Tensor:
        """The leaf whole (gathered over every axis its spec splits it on)."""
        return self._gathered(name)

    def under(self, prefix: str) -> list:
        """The names of the leaves under ``prefix``."""
        got = self._under.get(prefix)
        if got is None:
            got = self._under[prefix] = [n for n in self.blocks if n.startswith(prefix)]
        return got

    def tree(self, prefix: str) -> dict:
        """Every leaf under ``prefix``, whole, names relative to it."""
        return {n[len(prefix):]: self.whole(n) for n in self.under(prefix)}

    def part(self, name: str, dim: int, n: int) -> torch.Tensor:
        """This rank's share of the ``n`` units that make up ``dim`` of the
        leaf: its block where the spec splits on the unit boundary, else
        cut from the whole leaf."""
        if self.split(name, dim, n):
            return self._gathered(name, keep=dim)
        full = self._gathered(name)
        a, b = self.share(n)
        unit = full.shape[dim] // n
        return full.narrow(dim, a * unit, (b - a) * unit)

    def share(self, n: int) -> Tuple[int, int]:
        return share(n, self.size, self.index)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce over ``model``."""
        return x if self.comm is None else all_reduce(x, self.comm)[0]

    def gather(self, x: torch.Tensor, axis: int, stacked: bool = False) -> torch.Tensor:
        """All-gather over ``model`` along ``axis`` (on a new leading axis
        with ``stacked``), in ``model`` order."""
        if self.comm is None:
            return x[None] if stacked else x
        return all_gather(x, self.comm, axis=0 if stacked else axis, tiled=not stacked)[0]


# ----------------------------------------------------------------------
# linear layers, embedding, logits
# ----------------------------------------------------------------------


def column(cfg: ModelConfig, w: RankWeights, x, name: str, n: int, bias: Optional[str] = None):
    """``x @ W[:, share]`` (+ the bias' share): the rank's ``n`` column
    units (heads or hidden units) of ``name``."""
    cd = cfg.cdtype
    y = x @ w.part(name, 1, n).to(cd)
    return y if bias is None else y + w.part(bias, 0, n).to(cd)


def row(cfg: ModelConfig, w: RankWeights, x, name: str, n: int, bias: Optional[str] = None):
    """``x @ W[share, :]`` summed over ``model`` (:meth:`RankWeights.leave`);
    ``bias`` (replicated) added once, after the reduce."""
    cd = cfg.cdtype
    y = w.leave(x.float() @ w.part(name, 0, n).float(), cd)
    return y if bias is None else y + w.whole(bias).to(cd)


def _whole(w: RankWeights, fn, x):
    """``fn(x) → (out, seed)`` of a sublayer none of whose leaves is split
    over ``model``, run whole on every rank with no collective; under
    :meth:`RankWeights.sequence` on ``x`` gathered along ``S``, the output
    cut back to the rank's share."""
    out, seed = fn(w.enter(x))
    return w.local(out), seed


def remat(cfg: ModelConfig, fn):
    """``fn`` (per-rank code that issues collectives) under the config's
    remat policy (``models.common.remat_wrap``), its collectives logged in
    the forward and read back by the recompute in the caller's backward
    (``core.collectives.CollectiveLog``). One log per call of ``remat``:
    call it once per layer run."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    log = CollectiveLog()

    def logged(*args):
        with log.scope():
            return fn(*args)

    return remat_wrap(cfg, logged)


def embed(cfg: ModelConfig, w: RankWeights, tokens):
    """The vocab-parallel lookup of ``embed.tok``: each rank looks up the
    ids in its rows (others zero) and the ranks' rows are summed, so every
    row is one rank's, unchanged."""
    a, b = w.share(cfg.vocab)
    tok = w.part("embed.tok", 0, cfg.vocab).to(cfg.cdtype)
    ids = tokens.long() - a
    inside = (ids >= 0) & (ids < b - a)
    x = tok[ids.clamp(0, max(b - a - 1, 0))] * inside[..., None].to(tok.dtype)
    return w.sum(x)


def logits(cfg: ModelConfig, w: RankWeights, x):
    """The output projection through ``embed`` (tied: ``tok``'s rows;
    untied: ``out``'s columns), the rank's vocab share, all-gathered along
    vocab; ``cfg.logit_dtype``."""
    V = cfg.vocab
    wt = w.part("embed.tok", 0, V).t() if cfg.tie_embeddings else w.part("embed.out", 1, V)
    return w.gather((x @ wt.to(cfg.cdtype)).to(cfg.ldtype), axis=-1)


def xent(cfg: ModelConfig, w: RankWeights, x, tokens, mask=None):
    """``(summed next-token xent, token count)``, whose ratio over any split
    of the batch is ``models.common.next_token_xent`` over all of it, from
    the final normed ``x`` (B, S, d), the same on every ``model`` rank,
    vocab-parallel: the rank's logits cover its vocab share only.
    The row maxima (a constant shift of the log-sum-exp, no gradient) are
    all-gathered and maxed, the rank's sums of exponentials and the
    target logits it owns (zero elsewhere) all-reduced in one vector."""
    V = cfg.vocab
    a, b = w.share(V)
    wt = w.part("embed.tok", 0, V).t() if cfg.tie_embeddings else w.part("embed.out", 1, V)
    z = (x[:, :-1] @ wt.to(cfg.cdtype)).to(cfg.ldtype).float()  # (B, S-1, V_l)
    m = w.gather(z.detach().amax(-1), 0, stacked=True).amax(0)
    tgt = tokens[:, 1:].long() - a
    inside = (tgt >= 0) & (tgt < b - a)
    t = torch.gather(z, -1, tgt.clamp(0, b - a - 1)[..., None])[..., 0] * inside
    se, t = w.sum(torch.stack([torch.exp(z - m[..., None]).sum(-1), t])).unbind(0)
    ll = t - torch.log(se) - m
    if mask is not None:
        keep = mask[:, 1:].float()
        return -(ll * keep).sum(), keep.sum()
    return -ll.sum(), torch.tensor(float(ll.numel()), device=x.device)


def swiglu(cfg: ModelConfig, w: RankWeights, pre: str, x, d_ff: int):
    """The SwiGLU FFN ``pre`` on the rank's ``d_ff`` share, row-reduced
    (whole where no leaf is split over ``model``)."""
    if w.replicated(pre):
        return _whole(w, lambda h: (common.swiglu(cfg, w.tree(pre), h), None), x)[0]
    x = w.enter(x)
    g = torch.nn.functional.silu(column(cfg, w, x, pre + "w_gate", d_ff))
    return row(cfg, w, g * column(cfg, w, x, pre + "w_up", d_ff), pre + "w_down", d_ff)


def gelu_mlp(cfg: ModelConfig, w: RankWeights, pre: str, x):
    """The GELU MLP ``pre``: ``w_in``/``b_in`` column-parallel,
    ``w_out`` row-parallel, the replicated ``b_out`` once after the reduce
    (whole where no leaf is split over ``model``)."""
    if w.replicated(pre):
        return _whole(w, lambda h: (common.gelu_mlp(cfg, w.tree(pre), h), None), x)[0]
    x = w.enter(x)
    h = torch.nn.functional.gelu(column(cfg, w, x, pre + "w_in", cfg.d_ff, pre + "b_in"), approximate="tanh")
    return row(cfg, w, h, pre + "w_out", cfg.d_ff, pre + "b_out")


def _capacity_dispatch(w: RankWeights, split: bool):
    """``moe_dispatch_sharding``'s expert pass (``moe.moe_apply``'s
    ``dispatch``): the rank's ``(E_l, C)`` slots split over ``data`` as
    :func:`share` splits ``C``, the data rank ``j`` applying the rank's
    experts to slots ``share(C, D, j)``. With ``split`` (the dp groups hold
    different rows, their slots global: ``GlobalRouting``) each rank sends
    every data rank the tokens of its slots by one all-to-all over
    ``data`` (a slot holds one token of one group, zeros elsewhere, so the
    sources add up) and gets their outputs back by the reverse all-to-all;
    without, every data rank holds the same tokens, takes its slots
    locally and all-gathers the outputs."""
    comm = StreamComm((DATA,), mesh=w.mesh)
    D, j = w.mesh.shape[DATA], w.data_index

    def dispatch(table, x_pad, ffn):
        E_l, C = table.shape
        spans = [share(C, D, i) for i in range(D)]
        n = max(b - a for a, b in spans)

        def slots(a, b):  # (E_l, n, d): the tokens of slots [a, b), zero-padded to n
            return F.pad(x_pad[table[:, a:b]], (0, 0, 0, n - (b - a)))

        if split:
            sent = torch.stack([slots(a, b) for a, b in spans])  # (D, E_l, n, d)
            ye = ffn(all_to_all(sent, comm, split_axis=0, concat_axis=0)[0].sum(0))
            back = all_to_all(ye.expand(D, *ye.shape), comm, split_axis=0, concat_axis=0)[0]
        else:
            ye = ffn(slots(*spans[j]))
            back = all_gather(ye, comm, axis=0, tiled=False)[0]
        return torch.cat([back[i, :, : b - a] for i, (a, b) in enumerate(spans)], dim=1)

    return dispatch


def moe(cfg: ModelConfig, w: RankWeights, pre: str, x, train: bool = False):
    """The MoE FFN ``pre`` with expert parallelism: (y, aux). The router
    and the tokens are the same on every ``model`` rank, so all route
    alike; each applies its experts (and its share of the shared experts'
    hidden units) and the combine is summed over ``model``. ``w.route`` (a
    ``models.moe.GlobalRouting`` over the dp axes, whose count exchange
    runs among the ranks of one ``model`` index) routes the dp groups' rows
    as one batch; ``aux`` is then ``moe_apply``'s sums. Under
    ``moe_dispatch_sharding`` on a mesh with a ``data`` axis the experts'
    slots are laid capacity over ``data`` (:func:`_capacity_dispatch`)."""
    from repro_torch.models.moe import moe_apply

    m = cfg.moe
    E = m.n_experts
    x = w.enter(x)
    p = {"router": w.whole(pre + "router")}
    for k in ("we_gate", "we_up", "we_down"):
        p[k] = w.part(pre + k, 0, E)
    if m.n_shared:
        f = m.n_shared * (m.d_shared or m.d_expert)
        sp = pre + "shared."
        p["shared"] = {"w_gate": w.part(sp + "w_gate", 1, f), "w_up": w.part(sp + "w_up", 1, f),
                       "w_down": w.part(sp + "w_down", 0, f)}
    dispatch = None
    if cfg.moe_dispatch_sharding and w.mesh.shape.get(DATA, 1) > 1:
        dispatch = _capacity_dispatch(w, split=w.route is not None)
    y, aux = moe_apply(cfg, p, x, train=train, route=w.route, experts=w.share(E), dispatch=dispatch)
    return w.leave(y, x.dtype), aux  # ``y``: the rank's experts' fp32 partial


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------


def qkv(cfg: ModelConfig, w: RankWeights, pre: str, x, positions, theta: float, use_rope: bool = True, kv_x=None):
    """(q of the rank's heads (B,S,nq_l,hd), k, v, kv_local): with
    ``kv_local`` k/v are the rank's share of the kv heads, exactly the ones
    its q heads read (``model`` divides both head counts); otherwise they
    are every kv head, from the whole ``wk``/``wv``. ``kv_x`` (a
    cross-attention's source, no rope) projects to k/v in place of ``x``."""
    B, S, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    cd = cfg.cdtype
    bias = cfg.qkv_bias and pre + "bq" in w.blocks
    q = column(cfg, w, x, pre + "wq", nq, pre + "bq" if bias else None).reshape(B, S, -1, hd)
    src = x if kv_x is None else kv_x
    kv_local = nq % w.size == 0 and nkv % w.size == 0
    if kv_local:
        k = column(cfg, w, src, pre + "wk", nkv, pre + "bk" if bias else None)
        v = column(cfg, w, src, pre + "wv", nkv, pre + "bv" if bias else None)
    else:
        k, v = src @ w.whole(pre + "wk").to(cd), src @ w.whole(pre + "wv").to(cd)
        if bias:
            k, v = k + w.whole(pre + "bk").to(cd), v + w.whole(pre + "bv").to(cd)
    k, v = k.reshape(B, src.shape[1], -1, hd), v.reshape(B, src.shape[1], -1, hd)
    if use_rope:
        q, k = apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    return q, k, v, kv_local


def read_heads(cfg: ModelConfig, w: RankWeights, k, v, kv_local: bool):
    """k/v narrowed to the kv heads the rank's q heads read, laid out so
    that local q head ``h`` reads kv head ``h // (nq_l / nkv_l)`` (the
    flash kernel's mapping): a contiguous run of kv heads where the rank's
    q heads cover whole groups or one group, else one kv head per q head."""
    if kv_local:
        return k, v
    G = cfg.n_heads // cfg.n_kv_heads
    h0, h1 = w.share(cfg.n_heads)
    k0, k1 = h0 // G, (h1 - 1) // G + 1 if h1 > h0 else h0 // G
    if k1 - k0 == 1 or (h0 % G == 0 and h1 % G == 0):
        return k[:, :, k0:k1], v[:, :, k0:k1]
    idx = torch.arange(h0, h1, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def attention_full(cfg: ModelConfig, w: RankWeights, pre: str, x, positions, window: int = 0,
                   theta: float = 10_000.0, causal: bool = True, use_rope: bool = True, kv_x=None):
    """The full-sequence attention ``pre`` on the rank's heads
    (``gqa_attention_full``'s math and flash gate: the K2 kernel when
    ``attn_impl == "flash"``, causal, no window, no ``kv_x`` and
    ``S % 128 == 0``), its output row-reduced over ``model``; with ``kv_x``
    a cross-attention onto it (no mask, no rope). Returns (out, (k, v,
    kv_local)), the seed of :func:`cache_block`. Where no leaf of ``pre``
    is split over ``model`` a self-attention runs whole."""
    hd = cfg.resolved_head_dim
    if kv_x is None and w.replicated(pre):
        def run(h):
            out, (k, v) = common.gqa_attention_full(cfg, w.tree(pre), h, positions, window=window, theta=theta,
                                                    causal=causal, use_rope=use_rope)
            return out, (k, v, False)

        return _whole(w, run, x)
    x = w.enter(x)
    B, S, _ = x.shape
    if kv_x is not None:
        causal, use_rope = False, False
    q, k, v, kv_local = qkv(cfg, w, pre, x, positions, theta, use_rope, kv_x)
    ks, vs = read_heads(cfg, w, k, v, kv_local)
    if q.shape[2] == 0:  # more ranks than heads: this rank holds none
        out = q
    elif cfg.attn_impl == "flash" and causal and window == 0 and S % 128 == 0:
        from repro_torch.kernels.ops import gqa_flash_attention

        out = gqa_flash_attention(q, ks, vs, causal=True)
    else:
        mask = (causal_mask(S, S, window=window, device=x.device) if causal
                else torch.ones((1, 1, 1, S, k.shape[1]), dtype=torch.bool, device=x.device))
        out = attend(q, ks, vs, mask, 1.0 / math.sqrt(hd))
    return row(cfg, w, out.reshape(B, S, -1), pre + "wo", cfg.n_heads), (k, v, kv_local)


def seq_span(w: RankWeights, spec: P, T: int) -> Tuple[int, int, bool]:
    """(first slot, slots, split) of the rank's block of a cache leaf of
    length ``T`` (dim 2 of its ``(L, B, T, ...)`` layout) under ``spec``."""
    split = MODEL in spec.dim_axes(2)
    n = T // w.size if split else T
    return (w.index * n if split else 0), n, split


def _ring(a, S: int, T: int, dim: int = 1):
    """Rows ``S`` on ``dim`` laid into a cache of ``T`` slots as the
    single-rank prefill lays them: position p at slot p % T (the last T
    positions when S >= T), zeros past S."""
    if S >= T:
        return torch.roll(a.narrow(dim, S - T, T), shifts=(S - T) % T, dims=dim)
    pad = list(a.shape)
    pad[dim] = T - S
    return torch.cat([a, a.new_zeros(pad)], dim=dim)


def cache_block(w: RankWeights, seed, T: int, spec: P):
    """The rank's (K, V) block ``(B_l, T_l, nkv, hd)`` of one layer's cache
    from its prefill seed: the rows laid out over ``T`` slots, then, from
    the rank's kv heads, one all-to-all over ``model`` (split ``T``, concat
    heads) or an all-gather of the heads where ``T`` is not split; from
    every kv head, the rank's ``T`` span."""
    k, v, kv_local = seed
    kv = _ring(torch.stack([k, v]), k.shape[1], T, dim=2)  # (2, B, T, n, hd)
    t0, n, split = seq_span(w, spec, T)
    if kv_local and w.comm is not None:
        if split:
            kv, _ = all_to_all(kv, w.comm, split_axis=2, concat_axis=3)
        else:
            kv = w.gather(kv, axis=3)
    elif split:
        kv = kv.narrow(2, t0, n)
    return kv[0], kv[1]


def span_block(w: RankWeights, a, T: int, spec: P):
    """The rank's block of a cache leaf whose prefill rows ``a`` (B, S, ...)
    every ``model`` rank holds alike (MLA's latent): the rows laid over
    ``T`` slots and cut to the rank's span; no collective."""
    t0, n, split = seq_span(w, spec, T)
    full = _ring(a, a.shape[1], T)
    return full.narrow(1, t0, n) if split else full


def write_row(C, new, slot, t0: int):
    """Write ``new`` (B, ...) into the cache block ``C`` (B, T_l, ...) at
    global slot ``slot`` (B,) where the block's slots ``[t0, t0 + T_l)``
    hold it, in place; other rows keep their values (no host sync)."""
    n = C.shape[1]
    here = (slot >= t0) & (slot < t0 + n)
    at = (slot - t0).clamp(0, n - 1)
    b = torch.arange(C.shape[0], device=C.device)
    keep = here.view((-1,) + (1,) * (new.dim() - 1))
    C.index_put_((b, at), torch.where(keep, new.to(C.dtype), C[b, at]))


def merge_attend(w: RankWeights, q, K, V, valid, scale: float, split: bool):
    """Softmax attention of q (B, nq, dk) over the keys K (B, T_l, nk, dk)
    and values V (B, T_l, nk, dv) of the rank's slots (``valid`` (B, T_l)),
    ``nq = nk·G`` with q head h reading key head h // G; with ``split`` the
    ranks' partials are all-gathered over ``model`` and merged by
    log-sum-exp. fp32; returns (B, nq, dv)."""
    B, nq, dk = q.shape
    nk, dv = K.shape[2], V.shape[3]
    qg = q.float().view(B, nk, nq // nk, dk)
    s = torch.einsum("bngh,btnh->bngt", qg, K.float()) * scale
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    part = torch.cat([torch.einsum("bngt,btnh->bngh", p, V.float()), p.sum(-1)[..., None], m[..., None]], dim=-1)
    parts = w.gather(part, 0, stacked=True) if split else part[None]  # (M, B, nk, G, dv + 2)
    mg = parts[..., -1].amax(0)
    wgt = torch.exp(parts[..., -1] - mg)
    out = (wgt[..., None] * parts[..., :dv]).sum(0) / (wgt * parts[..., dv]).sum(0)[..., None]
    return out.reshape(B, nq, dv)


def attention_decode(cfg: ModelConfig, w: RankWeights, pre: str, x, cache_kv, pos, T: int, spec: P,
                     window: int = 0, theta: float = 10_000.0, use_rope: bool = True):
    """The one-token self-attention ``pre``, sequence-parallel over the
    rank's block (K, V) ``(B_l, T_l, nkv, hd)`` of a cache of ``T`` slots
    (a ring when ``window > 0``), laid out by ``spec``: the new K/V row
    written in place by the rank that holds its slot, q gathered to every
    head, the partials merged over ``model``, the rank's heads through the
    row-parallel ``wo``."""
    B = x.shape[0]
    hd, nq, nkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q, k, v, kv_local = qkv(cfg, w, pre, x, pos[:, None], theta, use_rope)
    q = w.gather(q.reshape(B, -1), axis=1).view(B, nq, hd)
    kv = torch.stack([k[:, 0], v[:, 0]]).reshape(2, B, -1)
    if kv_local:
        kv = w.gather(kv, axis=2)
    kv = kv.view(2, B, nkv, hd)
    K, V = cache_kv
    t0, n, split = seq_span(w, spec, T)
    slot = pos % T if window > 0 else pos
    write_row(K, kv[0], slot, t0)
    write_row(V, kv[1], slot, t0)
    g = t0 + torch.arange(n, device=x.device)
    valid = g[None, :] <= pos[:, None]
    if window > 0:
        valid = valid | (pos[:, None] + 1 >= T)
    out = merge_attend(w, q, K, V, valid, 1.0 / math.sqrt(hd), split)
    h0, h1 = w.share(nq)
    out = out[:, h0:h1].reshape(B, 1, -1).to(cfg.cdtype)
    return row(cfg, w, out, pre + "wo", nq)


def attention_cached(cfg: ModelConfig, w: RankWeights, pre: str, x, cache_kv, T: int, spec: P):
    """A one-token cross-attention ``pre`` (no rope, every slot valid)
    sequence-parallel over the rank's block (K, V) of a cache of ``T``
    slots that the prefill filled (Whisper's encoder K/V), read only."""
    B = x.shape[0]
    hd, nq = cfg.resolved_head_dim, cfg.n_heads
    bias = cfg.qkv_bias and pre + "bq" in w.blocks
    q = column(cfg, w, x, pre + "wq", nq, pre + "bq" if bias else None)
    q = w.gather(q.reshape(B, -1), axis=1).view(B, nq, hd)
    K, V = cache_kv
    _, n, split = seq_span(w, spec, T)
    valid = torch.ones((B, n), dtype=torch.bool, device=x.device)
    out = merge_attend(w, q, K, V, valid, 1.0 / math.sqrt(hd), split)
    h0, h1 = w.share(nq)
    return row(cfg, w, out[:, h0:h1].reshape(B, 1, -1).to(cfg.cdtype), pre + "wo", nq)


def norm(cfg: ModelConfig, w: RankWeights, prefix: str, x):
    """The (replicated) norm ``prefix`` applied to ``x``."""
    return apply_norm(cfg, w.tree(prefix), x)
