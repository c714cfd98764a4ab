"""FLOP / HBM-traffic accounting by counting the aten ops a step runs.

The port's counterpart of ``repro.launch.jaxpr_cost``, named for what it
walks: where the reference traces the step to a jaxpr and walks its
equations, :class:`OpCounter` is a ``TorchDispatchMode`` under which the
step runs eagerly — on ``torch.device("meta")`` tensors, so nothing is
allocated or computed — and every aten op that reaches the dispatcher is
counted, forward and backward, by the reference's conventions:

* FLOPs: 2·out·K for every matmul (``mm``/``bmm``/``addmm``/``baddbmm``)
  and the conv ops (``torch.utils.flop_counter``'s formulas), n for
  reductions and cumulative ops, n·log₂n for ``sort``/``topk``, 1 per
  output element for anything else elementwise.
* HBM bytes: every op's OUTPUT is written once; matmul, conv and
  scatter/``index_put`` additionally READ their operands, gather/index/
  embedding count 2× their output (read + write); elementwise reads are
  assumed fused. Views, reshapes, dtype casts, ``cat``, ``pad``,
  ``copy_``, ``clone``, ``empty``/``full`` and ``arange`` are free (the
  reference's ``_CHEAP``). One departure, where the port itself departs:
  an in-place scatter (``index_put_``, ``index_add_``, …: the decode's
  K/V writes into the cache, which the reference returns as an updated
  copy) reads its updates and indices and writes the updated rows only,
  not the whole tensor.

Trip counts come for free: in eager mode every layer and every microbatch
really runs, and remat recompute appears as real ops in the backward. The
per-token loops of ``models/mamba.py`` and RWKV-6 run one step on meta
tensors that stands for all of them (``models.common.meta_scan``); each op
is multiplied by ``models.common.trip_count()``, as ``jaxpr_cost``
multiplies a ``scan`` body by its length.

With ``track_memory=True`` the counter also keeps the live bytes of the
storages the counted ops create (freed when their last tensor dies) and
their peak: the dry run's ``temp_bytes`` and the chip check's predicted
peak memory. Host reads (``.item()``) raise on meta; the counted steps
have none.

A counter is shared by every thread whose dispatch-mode stack holds it
(``core/mesh.shard_map`` gives its ranks the caller's).
"""

from __future__ import annotations

import math
import threading
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models.common import trip_count

__all__ = ["Cost", "OpCounter", "step_cost"]


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes)


_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution", "convolution_backward"}
_GATHER = {"index", "_unsafe_index", "gather", "embedding", "index_select", "take"}
_SCATTER = {"scatter", "scatter_add", "scatter_reduce", "index_put", "_index_put_impl", "_unsafe_index_put",
            "index_add", "index_copy", "index_reduce", "masked_scatter", "embedding_dense_backward"}
_SORT = {"sort", "topk", "argsort", "msort"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "any", "all", "nansum",
           "logsumexp", "var", "std", "var_mean", "std_mean", "cumsum", "cumprod", "logcumsumexp", "cummax",
           "cummin"}
_CHEAP = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "view_as", "expand", "expand_as", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "slice", "select", "narrow", "split", "split_with_sizes", "unbind", "chunk",
    "as_strided", "alias", "detach", "diagonal", "flip", "roll", "repeat", "slice_scatter", "select_scatter",
    "slice_backward", "select_backward",
    "clone", "contiguous", "_to_copy", "to", "copy", "cat", "stack", "constant_pad_nd", "pad",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full", "fill", "zero", "arange",
    "scalar_tensor", "lift_fresh", "lift_fresh_copy", "resolve_conj", "resolve_neg", "_local_scalar_dense",
    "tag_act",  # models.common's checkpoint_name stand-in: a copy
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _name(func) -> str:
    """``aten.add_.Tensor`` → ``add``: the op family, in-place or not."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def _op_cost(func, args, kwargs, out, ins) -> Tuple[str, Cost]:
    """(family, cost) of one dispatched op by the module docstring's
    conventions; ``ins`` are its tensor arguments."""
    name = _name(func)
    outs = _tensors(out)
    out_bytes = sum(_nbytes(t) for t in outs)
    if name in _MATMUL:
        flops = flop_registry[func.overloadpacket](*args, **kwargs, out_val=out)
        return name, Cost(float(flops), out_bytes + sum(_nbytes(t) for t in ins))
    if name in _CHEAP:
        return name, Cost()
    if name in _GATHER:
        return name, Cost(0.0, 2.0 * out_bytes)
    if name in _SCATTER:
        if func._schema.is_mutable:  # in place: reads its updates and indices, writes the updated rows
            rest = sum(_nbytes(t) for t in ins[1:])
            return name, Cost(0.0, rest + _nbytes(ins[-1]))
        return name, Cost(0.0, out_bytes + sum(_nbytes(t) for t in ins))
    if name in _SORT:
        n = ins[0].numel()
        return name, Cost(n * max(1.0, math.log2(max(n, 2))), out_bytes + _nbytes(ins[0]))
    if name in _REDUCE and func._overloadname != "other":  # max.other / min.other are elementwise
        return name, Cost(float(ins[0].numel()), out_bytes)
    return name, Cost(float(sum(t.numel() for t in outs)), out_bytes)


def _pointwise_meta(func, args, kwargs):
    """The output of an out-of-place pointwise op on meta tensors, without
    running its meta kernel (most are Python reference implementations,
    ~0.1 ms an op, which set the pace of a dry run's AdamW on 256
    thread-ranks): the broadcast shape, contiguous, in the dtype the op
    gives on one-element CPU tensors of the same dtypes and ranks. None
    for anything else."""
    if torch.Tag.pointwise not in func.tags or func._schema.is_mutable or len(func._schema.returns) != 1:
        return None
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or not all(t.is_meta for t in tensors) or any(isinstance(v, torch.Tensor) for v in kwargs.values()):
        return None
    shapes = {tuple(t.shape) for t in tensors}
    shape = shapes.pop() if len(shapes) == 1 else torch.broadcast_shapes(*shapes)
    probe = func(*[torch.ones((1,) * a.dim(), dtype=a.dtype) if isinstance(a, torch.Tensor) else a for a in args],
                 **kwargs)
    return torch.empty(shape, dtype=probe.dtype, device="meta")


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while it is entered (module docstring):
    ``cost`` in all, ``by_op`` per op family and, with ``track_memory``,
    ``live_bytes``/``peak_bytes`` of the storages the ops created.

    The ranks of a region dispatch on many threads at once, so the hot
    path takes no lock a thread could block on (with hundreds of
    thread-ranks a shared lock convoys on the GIL): each thread adds into
    its own sums, and allocations and frees are appended, in the order
    they happen, to one event log that is folded into the live and peak
    bytes by whichever thread finds the fold free."""

    _FOLD_EVERY = 4096

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.track_memory = track_memory
        self._mine = threading.local()
        self._sums: List[Dict[str, List[float]]] = []  # one per dispatching thread
        self._live: Dict[int, weakref.ref] = {}  # storage → its weakref, whose callback logs the free
        self._events: deque = deque()  # +nbytes allocated / -nbytes freed
        self._fold_lock = threading.Lock()
        self._live_bytes = 0
        self._peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise_meta(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        ins = _tensors(list(args) + list(kwargs.values()))
        name, c = _op_cost(func, args, kwargs, out, ins)
        if c.flops or c.bytes:
            sums = getattr(self._mine, "sums", None)
            if sums is None:
                sums = self._mine.sums = {}
                self._sums.append(sums)
            n = trip_count()
            acc = sums.setdefault(name, [0.0, 0.0])
            acc[0] += c.flops * n
            acc[1] += c.bytes * n
        if self.track_memory:  # an output on an input's storage (a view, an in-place op) allocated nothing
            held = {t.untyped_storage()._cdata for t in ins}
            for t in _tensors(out):
                st = t.untyped_storage()
                if st._cdata not in held and st._cdata not in self._live:
                    self._track(st)
            if len(self._events) > self._FOLD_EVERY and self._fold_lock.acquire(blocking=False):
                try:
                    self._fold()
                finally:
                    self._fold_lock.release()
        return out

    def _track(self, st) -> None:
        key, nbytes = st._cdata, st.nbytes()

        def freed(_, key=key, nbytes=nbytes):
            if self._live.pop(key, None) is not None:
                self._events.append(-nbytes)

        self._live[key] = weakref.ref(st, freed)
        self._events.append(nbytes)

    def _fold(self) -> None:
        while self._events:
            self._live_bytes += self._events.popleft()
            self._peak_bytes = max(self._peak_bytes, self._live_bytes)

    def _memory(self) -> Tuple[int, int]:
        with self._fold_lock:
            self._fold()
            return self._live_bytes, self._peak_bytes

    @property
    def live_bytes(self) -> int:
        return self._memory()[0]

    @property
    def peak_bytes(self) -> int:
        return self._memory()[1]

    @property
    def by_op(self) -> Dict[str, Cost]:
        out: Dict[str, Cost] = {}
        for sums in list(self._sums):
            for name, (f, b) in list(sums.items()):
                out[name] = out.get(name, Cost()) + Cost(f, b)
        return out

    @property
    def cost(self) -> Cost:
        total = Cost()
        for c in self.by_op.values():
            total = total + c
        return total

    def top(self, k: int = 8) -> List[dict]:
        """The ``k`` op families with the most FLOPs, with their bytes."""
        rows = sorted(self.by_op.items(), key=lambda kv: (-kv[1].flops, -kv[1].bytes))[:k]
        return [{"op": name, "flops": c.flops, "bytes": c.bytes} for name, c in rows]


def step_cost(fn, *args) -> Cost:
    """Run ``fn(*args)`` under an :class:`OpCounter` and return what it
    counted. With meta arguments nothing is allocated. Returns GLOBAL
    (whole-fleet) flops/bytes for a global step: divide by the chip count
    for per-chip roofline terms, as the reference does."""
    with OpCounter() as counter:
        fn(*args)
    return counter.cost
