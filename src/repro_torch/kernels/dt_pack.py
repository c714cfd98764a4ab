"""Datatype pack/unpack: the Hopper kernels and their plain versions.

Replaces the Pallas TPU kernels ``pack_kernel``/``dt_pack`` and
``unpack_kernel``/``dt_unpack`` (``src/repro/kernels/dt_pack.py``). The
CUDA source, with its note on what bounds it on the card and what its
design does about that, is ``csrc/dt_pack.cu``.

Both work on a flat 1-D buffer and a uniform layout: ``nseg`` segments of
``seg_len`` elements, segment ``i`` starting at element
``start + i * stride``. The kernels address the segments straight from the
buffer's base — the TPU wrapper's padded ``(nseg, stride)`` window copy is
never built — and move bytes only, so they are byte-exact for any dtype.

:func:`pack_plan` fixes how the pack kernel runs from the layout and the
two pointers' alignment alone: the access width and the grid of equal spans
of the packed output. The kernel's own index arithmetic (32- or 64-bit
indices, the multiply-shift divide) is chosen by the C entry.

:func:`dt_unpack_into` is the in-place scatter a paged KV cache needs: the
segments are written into an existing buffer whose other elements keep
their values (the host engine's ``datatype.unpack`` contract). It has no TPU
kernel of its own; it runs the pack kernel with the strided and the dense
side exchanged, under the same :func:`pack_plan`.

:func:`dt_pack`/:func:`dt_unpack`/:func:`dt_unpack_into` launch the kernels
for CUDA tensors and run :func:`dt_pack_plain`/:func:`dt_unpack_plain`/
:func:`dt_unpack_into_plain` for CPU tensors only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import count_launch

__all__ = ["dt_pack", "dt_unpack", "dt_unpack_into", "dt_pack_plain", "dt_unpack_plain", "dt_unpack_into_plain",
           "PackPlan", "pack_plan", "access_width"]

H100_SMS = 132
BLOCKS_PER_SM = 8  # 256-thread blocks: the 2048 threads an H100 SM holds
SPAN_UNIT = 4096  # bytes; a block's span is a whole number of these


class PackPlan(NamedTuple):
    """How one pack is launched: ``width`` the access width in bytes;
    ``grid`` blocks, block ``b`` owning packed bytes
    ``[b * span_bytes, (b + 1) * span_bytes)``."""

    width: int
    grid: int
    span_bytes: int


def access_width(*quantities: int) -> int:
    """The widest access (16, 8, 4, 2 or 1 bytes) that divides every one of
    ``quantities`` (addresses and byte counts)."""
    w = 16
    while w > 1 and any(q % w for q in quantities):
        w >>= 1
    return w


def pack_plan(nseg: int, seg_bytes: int, stride_bytes: int, src_addr: int, out_addr: int, *,
              sms: int = H100_SMS) -> PackPlan:
    """The pack's access width and grid: a pure function of the layout, the
    two pointers' alignment and the card's SM count. The width is the
    widest access dividing both pointers, the segment length and the
    stride. The grid has at most ``BLOCKS_PER_SM`` blocks per SM, owning
    equal spans of the packed output, each a whole number of
    ``SPAN_UNIT`` bytes, none empty."""
    if nseg <= 1:
        stride_bytes = seg_bytes
    width = access_width(src_addr, out_addr, seg_bytes, stride_bytes)
    total = nseg * seg_bytes
    grid = max(1, min(sms * BLOCKS_PER_SM, -(-total // SPAN_UNIT)))
    span = -(-max(total, 1) // grid)
    span = -(-span // SPAN_UNIT) * SPAN_UNIT
    return PackPlan(width, max(1, -(-total // span)), span)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _window_check(numel: int, nseg: int, seg_len: int, stride: int, start: int, what: str) -> None:
    if nseg < 0 or seg_len < 0 or start < 0:
        raise ValueError(f"{what}: negative layout (nseg={nseg}, seg_len={seg_len}, start={start})")
    if nseg > 1 and stride < seg_len:
        raise ValueError(f"{what}: stride {stride} < segment {seg_len} (overlapping segments)")
    end = start + (nseg - 1) * stride + seg_len if nseg else start
    if end > numel:
        raise ValueError(f"{what}: layout ends at element {end}, buffer holds {numel}")


def _check_flat(t, what: str) -> None:
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous 1-D buffer, got shape {tuple(t.shape)}")


def _index(nseg: int, seg_len: int, stride: int, start: int, device) -> torch.Tensor:
    rows = torch.arange(nseg, device=device, dtype=torch.int64)[:, None] * stride
    cols = torch.arange(seg_len, device=device, dtype=torch.int64)[None, :]
    return (start + rows + cols).reshape(-1)


def dt_pack_plain(buf, nseg: int, seg_len: int, stride: int, start: int = 0):
    """``out[i*seg_len + j] = buf[start + i*stride + j]`` by an index gather."""
    return buf[_index(nseg, seg_len, stride, start, buf.device)]


def dt_unpack_plain(packed, nseg: int, seg_len: int, stride: int, start: int, out_len: int):
    """A fresh zeroed ``out_len`` buffer with the segments scattered back."""
    out = torch.zeros(out_len, dtype=packed.dtype, device=packed.device)
    out[_index(nseg, seg_len, stride, start, packed.device)] = packed
    return out


def dt_unpack_into_plain(packed, out, nseg: int, seg_len: int, stride: int, start: int = 0):
    """``out[start + i*stride + j] = packed[i*seg_len + j]`` by an index
    scatter into ``out``, in place; every other element keeps its value."""
    out[_index(nseg, seg_len, stride, start, out.device)] = packed
    return out


def dt_pack(buf, *, nseg: int, seg_len: int, stride: int, start: int = 0):
    """Gather ``nseg`` segments of ``seg_len`` elements, ``stride`` apart,
    from ``start`` in the flat buffer ``buf`` → ``(nseg * seg_len,)``."""
    _check_flat(buf, "dt_pack")
    _window_check(buf.numel(), nseg, seg_len, stride, start, "dt_pack")
    if buf.device.type == "cpu":
        return dt_pack_plain(buf, nseg, seg_len, stride, start)
    if buf.device.type != "cuda":
        raise ValueError(f"dt_pack: unsupported device {buf.device}")
    from repro_torch.kernels import _build

    lib = _build.load()
    item = buf.element_size()
    out = torch.empty(nseg * seg_len, dtype=buf.dtype, device=buf.device)
    src = buf.data_ptr() + start * item
    plan = pack_plan(nseg, seg_len * item, stride * item, src, out.data_ptr(), sms=_sm_count(buf.device))
    rc = lib.repro_dt_pack(
        src, out.data_ptr(), nseg, seg_len * item, stride * item, plan.width, plan.grid, plan.span_bytes,
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dt_pack kernel launch failed: cudaError {rc} ({plan})")
    count_launch(dt_pack)
    return out


def dt_unpack(packed, *, nseg: int, seg_len: int, stride: int, start: int = 0, out_len: int):
    """Inverse of :func:`dt_pack` into a fresh zeroed buffer of ``out_len``
    elements: segments written, every other element zero."""
    _check_flat(packed, "dt_unpack")
    if packed.numel() != nseg * seg_len:
        raise ValueError(f"dt_unpack: packed holds {packed.numel()} elements, layout needs {nseg * seg_len}")
    _window_check(out_len, nseg, seg_len, stride, start, "dt_unpack")
    if packed.device.type == "cpu":
        return dt_unpack_plain(packed, nseg, seg_len, stride, start, out_len)
    if packed.device.type != "cuda":
        raise ValueError(f"dt_unpack: unsupported device {packed.device}")
    from repro_torch.kernels import _build

    lib = _build.load()
    item = packed.element_size()
    out = torch.empty(out_len, dtype=packed.dtype, device=packed.device)
    rc = lib.repro_dt_unpack(
        packed.data_ptr(), out.data_ptr(), nseg, seg_len * item, stride * item, start * item,
        out_len * item, torch.cuda.current_stream(packed.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dt_unpack kernel launch failed: cudaError {rc}")
    count_launch(dt_unpack)
    return out


def dt_unpack_into(packed, out, *, nseg: int, seg_len: int, stride: int, start: int = 0):
    """Scatter :func:`dt_pack`'s output back into the existing flat buffer
    ``out``, in place: ``nseg`` segments of ``seg_len`` elements, ``stride``
    apart, from element ``start``. Elements outside the segments keep their
    values. Returns ``out``."""
    _check_flat(packed, "dt_unpack_into")
    _check_flat(out, "dt_unpack_into")
    if packed.dtype != out.dtype or packed.device != out.device:
        raise ValueError(
            f"dt_unpack_into: packed is {packed.dtype} on {packed.device}, out is {out.dtype} on {out.device}"
        )
    if packed.numel() != nseg * seg_len:
        raise ValueError(f"dt_unpack_into: packed holds {packed.numel()} elements, layout needs {nseg * seg_len}")
    _window_check(out.numel(), nseg, seg_len, stride, start, "dt_unpack_into")
    if out.device.type == "cpu":
        return dt_unpack_into_plain(packed, out, nseg, seg_len, stride, start)
    if out.device.type != "cuda":
        raise ValueError(f"dt_unpack_into: unsupported device {out.device}")
    from repro_torch.kernels import _build

    lib = _build.load()
    item = out.element_size()
    dst = out.data_ptr() + start * item
    plan = pack_plan(nseg, seg_len * item, stride * item, dst, packed.data_ptr(), sms=_sm_count(out.device))
    rc = lib.repro_dt_unpack_into(
        packed.data_ptr(), out.data_ptr(), nseg, seg_len * item, stride * item, start * item,
        plan.width, plan.grid, plan.span_bytes, torch.cuda.current_stream(out.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dt_unpack_into kernel launch failed: cudaError {rc} ({plan})")
    count_launch(dt_unpack_into)
    return out


dt_pack.launches = 0
dt_unpack.launches = 0
dt_unpack_into.launches = 0
