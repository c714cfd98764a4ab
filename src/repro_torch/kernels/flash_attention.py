"""Blocked causal (flash) attention: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``flash_attention_kernel`` /
``flash_attention`` (``src/repro/kernels/flash_attention.py``) together
with the GQA head folding of ``repro.kernels.ops.gqa_flash_attention``.
The CUDA source, with its note on what bounds it on the card and what its
design does about that, is ``csrc/flash_attention.cu``: bf16 runs on the
tensor cores (``wgmma``, K/V tiles through a two-stage ``cp.async`` ring,
P kept in registers), fp32 on the CUDA cores. The wrapper picks the kernel
by dtype; neither falls back to the other.

Layout is the JAX package's: q ``(B, S, nq, hd)``, k/v ``(B, S, nkv, hd)``,
out ``(B, S, nq, hd)`` in q's dtype. Query head ``h`` reads KV head
``h // (nq // nkv)`` by index.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors only. The kernel is a forward
kernel: the serving path never differentiates through it, and a call that
would need a gradient raises until a backward kernel is ported.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

__all__ = ["flash_attention", "flash_attention_plain", "check_kernel_inputs", "tensor_core_layout_error",
           "KERNEL_HEAD_DIMS", "KERNEL_BLOCK"]

#: head dims the CUDA kernels are instantiated for (the zoo's: 64, 96, 128, 256)
KERNEL_HEAD_DIMS = (64, 96, 128, 256)
#: query/key tile of the CUDA kernel: S must be a multiple of it
KERNEL_BLOCK = 64
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, causal: bool = True):
    """The same function in plain PyTorch: fp32 logits, scale ``1/sqrt(hd)``,
    masked logits ``-1e30``, fp32 softmax and P·V, output in q's dtype."""
    B, S, nq, hd = q.shape
    G = nq // k.shape[2]
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bsnd,btnd->bnst", q.float(), kf) * (1.0 / math.sqrt(hd))
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bnst,btnd->bsnd", p, vf).to(q.dtype)


def tensor_core_layout_error(ptrs, strides):
    """Why the bf16 kernel cannot read q/k/v with these base addresses
    (bytes) and ``(batch, seq, head)`` element strides, or ``None``. Its
    16-byte ``cp.async`` copies need every base 16-byte aligned and every
    stride a multiple of 8 bf16 elements."""
    for name, ptr, st in zip("qkv", ptrs, strides):
        if ptr % 16:
            return f"flash_attention bf16 kernel needs 16-byte aligned {name}, got address {ptr:#x}"
        if any(s_ % 8 for s_ in st):
            return f"flash_attention bf16 kernel needs {name} strides that are multiples of 8 elements, got {tuple(st)}"
    return None


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants (B,S,n,hd) tensors, got {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}")
    B, S, nq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if k.shape[2] < 1 or nq % k.shape[2]:
        raise ValueError(f"nq={nq} is not a multiple of nkv={k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash_attention has a forward kernel only: no backward kernel is ported yet"
        )


def check_kernel_inputs(q, k, v) -> None:
    """Raise ``ValueError`` for q/k/v the CUDA kernels do not take: a head
    dim outside :data:`KERNEL_HEAD_DIMS`, another dtype than float32 or
    bfloat16, S not a multiple of :data:`KERNEL_BLOCK`, a non-unit hd
    stride, or (bf16) a layout the tensor cores cannot read. There is no
    fallback: a CUDA call the kernels do not take raises."""
    B, S, nq, hd = q.shape
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports hd in {KERNEL_HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if S % KERNEL_BLOCK:
        raise ValueError(f"flash_attention kernel needs S % {KERNEL_BLOCK} == 0, got S={S}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel needs a unit stride over hd")
    if q.dtype == torch.bfloat16:
        err = tensor_core_layout_error([t.data_ptr() for t in (q, k, v)], [t.stride()[:3] for t in (q, k, v)])
        if err:
            raise ValueError(err)


def flash_attention(q, k, v, causal: bool = True):
    """Flash attention forward. CUDA tensors launch the Hopper kernel (or
    raise); CPU tensors run :func:`flash_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_kernel_inputs(q, k, v)
    B, S, nq, hd = q.shape
    from repro_torch.kernels import _build

    lib = _build.load()
    out = torch.empty((B, S, nq, hd), dtype=q.dtype, device=q.device)
    strides = [(ctypes.c_int64 * 3)(t.stride(0), t.stride(1), t.stride(2)) for t in (q, k, v)]
    rc = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, nq, k.shape[2], hd, _DTYPE_CODES[q.dtype],
        strides[0], strides[1], strides[2], int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    with _launches_lock:  # thread-ranks launch concurrently; += alone can lose a count
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
_launches_lock = threading.Lock()
