"""Roofline terms of a step on the H100.

    compute term    = FLOPs per chip / 989 TFLOP/s (bf16 tensor cores)
    memory term     = HBM bytes per chip / 3.35 TB/s
    collective term = collective bytes per chip / 450 GB/s (NVLink, one direction)

The port of ``repro.launch.roofline`` over :class:`~repro_torch.launch.mesh.HW`.
FLOPs and bytes come from ``launch.op_cost.step_cost`` (the counterpart of
``jaxpr_cost``). The reference's ``xla_cost_analysis`` and
``collective_bytes`` read XLA's compiled cost analysis and parse its
optimized HLO text; an eager PyTorch step has neither, so they have no
counterpart here. Collective bytes are counted instead where every port
collective passes: ``core/collectives._issue`` tells
:func:`count_collectives` of each op a rank issues, with its operand's
bytes, and of the transpose autograd runs for it in the backward. The
byte convention is the reference's (operand sizes: all-reduce, all-to-all
and collective-permute = result bytes; all-gather = result / group;
reduce-scatter = result × group), and the per-chip value is the largest
rank's total.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.core import collectives
from repro_torch.launch.mesh import HW

__all__ = [
    "CollectiveStats",
    "count_collectives",
    "RooflineTerms",
    "roofline_terms",
    "fmt_seconds",
    "model_step_flops",
]

_COLL_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
             "collective-broadcast")


@dataclass
class CollectiveStats:
    per_op_bytes: Dict[str, float] = field(default_factory=dict)
    per_op_count: Dict[str, float] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.per_op_bytes.values())

    def add(self, op: str, nbytes: float, count: float = 1.0):
        self.per_op_bytes[op] = self.per_op_bytes.get(op, 0) + nbytes
        self.per_op_count[op] = self.per_op_count.get(op, 0) + count

    def summary(self) -> str:
        parts = [
            f"{op}: {self.per_op_count.get(op,0):.0f} ops, {self.per_op_bytes.get(op,0)/1e9:.3f} GB"
            for op in _COLL_OPS
            if self.per_op_count.get(op)
        ]
        return "; ".join(parts) if parts else "none"


class CollectiveCount:
    """What :func:`count_collectives` gathers: per mesh position, the
    operand bytes and count of each op its rank issued."""

    def __init__(self):
        self.per_rank: Dict[int, CollectiveStats] = {}
        self._lock = threading.Lock()  # the ranks are threads

    def __call__(self, op: str, slot: int, nbytes: int) -> None:
        with self._lock:
            self.per_rank.setdefault(slot, CollectiveStats()).add(op, nbytes)

    def per_chip(self) -> CollectiveStats:
        """The busiest rank's stats (the per-chip value)."""
        with self._lock:
            ranks = list(self.per_rank.values())
        return max(ranks, key=lambda s: s.total_bytes, default=CollectiveStats())


@contextmanager
def count_collectives():
    """Count every collective issued (and every transpose autograd runs for
    one) while open: ``with count_collectives() as c: ...``, then
    ``c.per_chip()`` or ``c.per_rank``."""
    counter = CollectiveCount()
    collectives.observers.append(counter)
    try:
        yield counter
    finally:
        collectives.observers.remove(counter)


@dataclass
class RooflineTerms:
    """All byte/FLOP inputs are PER-CHIP: the global step's counts divided
    by the chip count, collective bytes of the busiest rank."""

    flops: float  # per-chip FLOPs
    hbm_bytes: float  # per-chip bytes accessed
    coll_bytes_per_chip: float  # per-chip collective operand bytes
    n_chips: int
    model_flops: float = 0.0  # whole-model 6·N·D convention

    @property
    def t_compute(self) -> float:
        return self.flops / HW.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HW.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / HW.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (remat/redundancy waste)."""
        return self.model_flops / (self.flops * self.n_chips) if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MFU bound: useful model FLOPs per chip over peak, if the
        dominant roofline term were the step wall time."""
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops / self.n_chips / self.t_bound) / HW.PEAK_FLOPS_BF16

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.flops,
            "hlo_bytes": self.hbm_bytes,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_bound": self.roofline_fraction,
        }


def roofline_terms(cost: dict, coll: CollectiveStats, n_chips: int, model_flops: float = 0.0) -> RooflineTerms:
    return RooflineTerms(
        flops=float(cost.get("flops", 0.0)),
        hbm_bytes=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_chip=float(coll.total_bytes),
        n_chips=n_chips,
        model_flops=model_flops,
    )


def fmt_seconds(t: float) -> str:
    if t >= 1:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t*1e3:.2f}ms"
    return f"{t*1e6:.1f}us"


def model_step_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for train (D = tokens), 2·N·D for fwd-only."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
