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

:func:`dt_pack`/:func:`dt_unpack` launch the kernels for CUDA tensors and
run :func:`dt_pack_plain`/:func:`dt_unpack_plain` for CPU tensors only.
"""

from __future__ import annotations

import torch

__all__ = ["dt_pack", "dt_unpack", "dt_pack_plain", "dt_unpack_plain"]


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
    rc = lib.repro_dt_pack(
        buf.data_ptr() + start * item, out.data_ptr(), nseg, seg_len * item, stride * item,
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dt_pack kernel launch failed: cudaError {rc}")
    dt_pack.launches += 1
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
    dt_unpack.launches += 1
    return out


dt_pack.launches = 0
dt_unpack.launches = 0
