"""Public wrappers around the port's kernels, mirroring
``repro.kernels.ops``: the integration points the models and the enqueue
path call (flash attention for GQA layers, the chunked WKV for RWKV-6,
dt_pack for datatype-described send buffers). Each wrapper launches the
CUDA kernel for CUDA tensors and the kernel's plain PyTorch version for CPU
tensors. The reference's ``interpret`` switch has no counterpart: the
tensor's device decides.
"""

from __future__ import annotations

from repro_torch.core import datatype as dt
from repro_torch.kernels import dt_pack as _dtp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rwkv6_scan as _wkv

__all__ = ["gqa_flash_attention", "wkv6", "pack_datatype", "unpack_datatype"]


def gqa_flash_attention(q, k, v, causal: bool = True):
    """q (B,S,nq,hd); k/v (B,S,nkv,hd) → (B,S,nq,hd). GQA by head index:
    query head h reads KV head h // (nq // nkv) — no repeated KV copy."""
    return _fa.flash_attention(q, k, v, causal=causal)


def wkv6(w, r, k, v, bonus, state0, chunk: int = 64):
    """w/r/k/v (B,S,H,64) fp32; bonus (H,64); state0 (B,H,64,64) →
    (y (B,S,H,64), state (B,H,64,64)). S must be a multiple of ``chunk``."""
    return _wkv.wkv6(w, r, k, v, bonus, state0, chunk=chunk)


def _kernel_info(dtype_descr: dt.Datatype, info, itemsize: int):
    """Resolve + validate the exact uniform descriptor for the dense
    kernel.  ``pack_info`` is structurally exact (a returned tuple proves
    segment i == disp0 + i*stride), so a non-None info can be trusted;
    layouts the (nseg, stride)-window kernel cannot express — descending
    or overlapping strides — are rejected with a clear redirect to the
    host engine rather than corrupting the window math."""
    if info is None:
        info = dt.pack_info(dtype_descr)
    if info is None:
        raise ValueError("irregular datatype: use core.datatype.pack/unpack (host path)")
    nseg, seg_bytes, stride_bytes, disp = info
    if nseg > 1 and stride_bytes < seg_bytes:
        raise ValueError(
            "uniform layout with descending/overlapping stride "
            f"(stride {stride_bytes} < segment {seg_bytes}): use the host path"
        )
    if disp < 0:
        raise ValueError("negative displacement (lb < 0): use the host path, which rebases")
    if seg_bytes % itemsize or stride_bytes % itemsize or disp % itemsize:
        raise ValueError(
            f"descriptor bytes ({seg_bytes}/{stride_bytes}/{disp}) not divisible "
            f"by element size {itemsize}"
        )
    return nseg, seg_bytes, stride_bytes, disp


def pack_datatype(buf_flat, dtype_descr: dt.Datatype, *, info=None):
    """Pack a uniform-strided datatype from a flat element buffer with the
    ``dt_pack`` kernel; raises on irregular layouts (the host iovec path
    covers those — see core.datatype.pack). ``info`` accepts a precomputed
    ``pack_info`` tuple so batch callers resolve the descriptor once."""
    item = buf_flat.element_size()
    nseg, seg_bytes, stride_bytes, disp = _kernel_info(dtype_descr, info, item)
    stride = stride_bytes // item if nseg > 1 else seg_bytes // item
    return _dtp.dt_pack(
        buf_flat, nseg=nseg, seg_len=seg_bytes // item, stride=stride, start=disp // item
    )


def unpack_datatype(packed_flat, dtype_descr: dt.Datatype, out_len: int, *, info=None):
    """Inverse of pack_datatype into a fresh zeroed flat buffer of out_len
    elements (segments written, every other element zero)."""
    item = packed_flat.element_size()
    nseg, seg_bytes, stride_bytes, disp = _kernel_info(dtype_descr, info, item)
    stride = stride_bytes // item if nseg > 1 else seg_bytes // item
    return _dtp.dt_unpack(
        packed_flat, nseg=nseg, seg_len=seg_bytes // item, stride=stride,
        start=disp // item, out_len=out_len,
    )
