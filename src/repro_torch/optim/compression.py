"""Gradient compression: int8 block quantization with error feedback.

Distributed-optimization trick for slow (cross-pod) links: the inter-pod
leg of the hierarchical all-reduce runs on int8-quantized gradients with
an error-feedback accumulator so the quantization bias vanishes over
steps (Seide et al.-style EF-SGD, adapted to block-wise int8).

The port of ``repro.optim.compression``: the same arithmetic in fp32
(round half to even, as ``jnp.round``), so a quantization is bit-equal to
the reference's. The all-reduces are per-rank code over the port's
stream and thread communicators: call them inside a ``shard_map`` region.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import all_gather, all_reduce, reduce_scatter
from repro_torch.core.streams import StreamComm
from repro_torch.core.threadcomm import ThreadComm

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "compressed_all_reduce",
    "hierarchical_compressed_all_reduce",
]

BLOCK = 2048


def quantize_int8(x, block: int = BLOCK):
    """Block-wise symmetric int8. x (n,) fp32, n % block == 0 → (q int8,
    scales (n/block,) fp32)."""
    n = x.shape[0]
    xb = x.reshape(n // block, block)
    scale = torch.amax(torch.abs(xb), dim=1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(xb / scale[:, None]), -127, 127).to(torch.int8)
    return q.reshape(n), scale


def dequantize_int8(q, scale, block: int = BLOCK):
    n = q.shape[0]
    return (q.reshape(n // block, block).to(torch.float32) * scale[:, None]).reshape(n)


def compressed_all_reduce(x, comm: StreamComm, ef_state: Optional[torch.Tensor] = None, block: int = BLOCK):
    """All-reduce of x (n,) fp32 with an int8 payload + error feedback:
    add the EF residual, quantize, reduce the dequantized values (what the
    int8 wire carries), keep ``residual = x_plus_ef - dequant(quant(x_plus_ef))``.
    Returns (y, new_ef)."""
    if ef_state is None:
        ef_state = torch.zeros_like(x)
    x_c = x + ef_state
    q, s = quantize_int8(x_c, block)
    xq = dequantize_int8(q, s, block)  # what actually goes on the wire
    new_ef = x_c - xq
    y, _ = all_reduce(xq, comm)
    return y, new_ef


def hierarchical_compressed_all_reduce(x, comm: ThreadComm, ef_state=None, block: int = BLOCK):
    """Fast-path intra-pod legs in full precision; slow inter-pod leg
    quantized. comm.axes = (pod, inner...)."""
    if ef_state is None:
        ef_state = torch.zeros_like(x)
    inner = comm.inner().as_stream_comm()
    outer = comm.outer().as_stream_comm()
    n_inner = comm.inner().size()
    if x.shape[0] % (n_inner * block) != 0:
        # fall back: compress the whole flat all-reduce
        return compressed_all_reduce(x, comm.as_stream_comm(), ef_state, block)
    part, _ = reduce_scatter(x, inner, axis=0)  # fp32, fast links
    part_c = part + ef_state_slice(ef_state, part.shape[0])
    q, s = quantize_int8(part_c, block)
    wire = dequantize_int8(q, s, block)
    new_ef_part = part_c - wire
    red, _ = all_reduce(wire, outer)  # int8-payload leg (slow links)
    y, _ = all_gather(red, inner, axis=0)
    # only this rank's part of the EF state is meaningful: each rank keeps
    # its own slice
    return y, new_ef_part


def ef_state_slice(ef_state, n):
    return ef_state[:n]
