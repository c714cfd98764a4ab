"""The benchmark's own count of operations and bytes, and the chip's peaks.

These are the yardstick: what a prefill, a decode step, an attention call
or a page move needs, worked out from the configuration file's sizes and
the shapes the run served, never from the program. A roofline share divides
the least time these counts allow by the time the device took, so a count
that is too high would read above 100%; each count is of what the
algorithm needs (causal attention over its lower triangle, the experts a
token is routed to, the cache positions in use), not of what an
implementation happens to do. What an architecture needs is counted by its
own ``Model`` (``portbench/architectures/<name>/counts.py``) from these.
"""

from __future__ import annotations

__all__ = ["PEAK", "attention_cost", "roofline_s"]

#: NVIDIA H100 SXM, dense, from NVIDIA's data sheet (at a 700 W power limit)
PEAK = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


def attention_cost(S: int, nq: int, nkv: int, hd: int, elem_bytes: int = 2) -> dict:
    """One causal self-attention call over ``S`` positions: the multiply-adds
    of ``Q K^T`` and ``P V`` over the lower triangle (``S(S+1)/2`` query-key
    pairs a head) as FLOPs, and each of q, k, v read once and the output
    written once."""
    flops = 2 * 2 * nq * hd * S * (S + 1) // 2
    nbytes = elem_bytes * S * hd * (2 * nq + 2 * nkv)
    return {"flops": flops, "bytes": nbytes}


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK["bf16_flops"], nbytes / PEAK["hbm_bytes_per_s"])
