"""Decode attention (K4): the Hopper kernel and its plain version.

One new query token a slot attends to the slot's K/V cache, read in place
up to the slot's length ``n_b = min(pos_b + 1, T)``: the rows ``0..pos`` of
a full cache, and every row of a ring cache (a sliding-window layer's) once
``pos + 1 >= T``. It replaces no TPU kernel: the JAX package's decode
attention is an einsum under ``decode_mask``, which XLA fuses, while the
port's eager einsums copied the whole cache twice a layer. The CUDA source,
with its note on what bounds it on the card and what its design does about
that, is ``csrc/decode_attention.cu``: split over positions, each K/V row
read once a query-head group through a ``cp.async`` ring, fp32 logits,
softmax and P·V, the chunks merged by a second kernel.

Layout: q ``(B, nq, hd)``, K and V ``(B, T, nkv, hd)`` in the cache's own
strides (unit hd stride), pos ``(B,)`` int32 or int64 on q's device; the
output ``(B, nq, hd)`` is in q's dtype. Query head ``h`` reads KV head
``h // (nq // nkv)``.

:func:`decode_attention` launches the kernel for CUDA tensors and runs
:func:`decode_attention_plain` for CPU (and shape-only meta) tensors only;
a CUDA call the kernel does not take raises. The plain version is the
arithmetic the JAX package's decode runs (fp32 logits and softmax, the
probabilities cast to V's dtype before P·V), so the CPU path keeps the
numbers it had before the kernel existed.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import count_launch

__all__ = ["decode_attention", "decode_attention_plain", "check_kernel_inputs", "split_plan",
           "DECODE_HEAD_DIMS", "MAX_GROUP"]

#: head dims the CUDA kernel is instantiated for: the zoo's (K2's 64, 96, 128
#: and 256) and the smoke presets' 16, which the examples decode on the card
DECODE_HEAD_DIMS = (16, 64, 96, 128, 256)
#: most query heads a KV head the kernel's shared memory is sized for
MAX_GROUP = 16
#: a block's chunk of positions: a multiple of every tile (64 rows at most)
CHUNK_UNIT = 64
#: a block's chunk lies between these: longer chunks leave slots of unequal
#: lengths unbalanced, shorter ones pay a block's start and the merge for few
#: rows (on one H100 at phi-3's shapes 1,024 read 1-3% faster than 512 or
#: 2,048, and granite's small cache 16% faster in chunks of 256 than of 128)
MIN_CHUNK = 256
MAX_CHUNK = 1024
#: blocks wanted an SM (two resident, four waves), so slots of unequal
#: lengths still spread over every SM
BLOCKS_PER_SM = 8
MAX_SPLITS = 64
NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_POS_CODES = {torch.int32: 0, torch.int64: 1}


def decode_attention_plain(q, k, v, pos):
    """The same function in plain PyTorch, as the einsum decode computes it:
    the logits of ``(q, K)`` in K's dtype taken to fp32 and scaled by
    ``1/sqrt(hd)``, rows at or past ``n_b`` set to ``-1e30``, an fp32 softmax,
    the probabilities cast to V's dtype, P·V."""
    B, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q.reshape(B, 1, nkv, nq // nkv, hd)
    logits = torch.einsum("bsngh,btnh->bngst", qg, k).float() * (1.0 / math.sqrt(hd))
    n_b = torch.clamp(pos + 1, max=T)
    valid = torch.arange(T, device=pos.device)[None, :] < n_b[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bngst,btnh->bsngh", probs, v).reshape(B, nq, hd)


def split_plan(B: int, nkv: int, T: int, sms: int):
    """``(chunk, splits)``: the positions a block takes and how many blocks a
    (slot, KV head) gets, from the shapes alone (never from pos). Enough
    blocks for :data:`BLOCKS_PER_SM` on each of ``sms`` SMs, no chunk longer
    than :data:`MAX_CHUNK` (so slots of different lengths balance) nor
    shorter than :data:`MIN_CHUNK`; ``chunk`` is a multiple of
    :data:`CHUNK_UNIT` and ``splits = ceil(T / chunk)``."""
    splits = max(-(-BLOCKS_PER_SM * sms // (B * nkv)), -(-T // MAX_CHUNK))
    splits = max(1, min(splits, -(-T // MIN_CHUNK), MAX_SPLITS))
    chunk = -(-T // splits)
    chunk = -(-chunk // CHUNK_UNIT) * CHUNK_UNIT
    return chunk, -(-T // chunk)


def _check(q, k, v, pos) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4 or pos.dim() != 1:
        raise ValueError(f"decode_attention wants q (B,nq,hd), k/v (B,T,nkv,hd) and pos (B,), got "
                         f"{tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)}/{tuple(pos.shape)}")
    B, nq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or pos.shape[0] != B:
        raise ValueError(f"k/v/pos shapes {tuple(k.shape)}/{tuple(v.shape)}/{tuple(pos.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k.shape[2] < 1 or nq % k.shape[2]:
        raise ValueError(f"nq={nq} is not a multiple of nkv={k.shape[2]}")
    if not (q.device == k.device == v.device == pos.device):
        raise ValueError(f"q/k/v/pos on different devices: {q.device}, {k.device}, {v.device}, {pos.device}")


def check_kernel_inputs(q, k, v, pos) -> None:
    """Raise ``ValueError`` for inputs the CUDA kernel does not take: a head
    dim outside :data:`DECODE_HEAD_DIMS`, q/k/v not all float32 or all
    bfloat16, pos not int32 or int64 or not at unit stride (the kernel reads
    ``pos[b]`` at ``pos + b``), more than :data:`MAX_GROUP` query heads a KV
    head, a non-unit hd stride, or K/V whose base addresses or (batch,
    seq, head) strides are not whole 16-byte units (its ``cp.async`` copies
    move 16 bytes). There is no fallback: a CUDA call the kernel does not
    take raises."""
    B, nq, hd = q.shape
    if hd not in DECODE_HEAD_DIMS:
        raise ValueError(f"decode_attention kernel supports hd in {DECODE_HEAD_DIMS}, got {hd}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention kernel takes float32 or bfloat16 q/k/v of one dtype, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if pos.dtype not in _POS_CODES:
        raise ValueError(f"decode_attention kernel takes int32 or int64 pos, got {pos.dtype}")
    if B > 1 and pos.stride(0) != 1:
        raise ValueError(f"decode_attention kernel needs pos at unit stride, got stride {pos.stride(0)}")
    if nq // k.shape[2] > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes at most {MAX_GROUP} query heads a KV head, "
                         f"got {nq // k.shape[2]}")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("decode_attention kernel needs a unit stride over hd")
    item = k.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * item % 16 for s in t.stride()[:3]):
            raise ValueError(f"decode_attention kernel needs 16-byte aligned {name} rows, got address "
                             f"{t.data_ptr():#x} and strides {tuple(t.stride())}")


def _sm_count(device) -> int:
    return _sm_count_of(device.index if device.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k, v, pos):
    """Decode attention of q ``(B, nq, hd)`` over the first
    ``min(pos + 1, T)`` rows of each slot's K/V ``(B, T, nkv, hd)``. CUDA
    tensors launch the Hopper kernel (or raise); CPU and meta tensors run
    :func:`decode_attention_plain`."""
    _check(q, k, v, pos)
    if q.device.type in ("cpu", "meta"):
        return decode_attention_plain(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    check_kernel_inputs(q, k, v, pos)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("decode_attention has a forward kernel only: decode runs without gradients")
    B, nq, hd = q.shape
    T, nkv = k.shape[1], k.shape[2]
    chunk, splits = split_plan(B, nkv, T, _sm_count(q.device))
    from repro_torch.kernels import _build

    lib = _build.load()
    out = torch.empty((B, nq, hd), dtype=q.dtype, device=q.device)
    part_acc = part_ml = 0
    if splits > 1:
        work = torch.empty((B * nq * splits * (hd + 2),), dtype=torch.float32, device=q.device)
        part_acc = work.data_ptr()
        part_ml = part_acc + 4 * B * nq * splits * hd
    qst = (ctypes.c_int64 * 2)(q.stride(0), q.stride(1))
    kst, vst = ((ctypes.c_int64 * 3)(*t.stride()[:3]) for t in (k, v))
    rc = lib.repro_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), _POS_CODES[pos.dtype], out.data_ptr(),
        part_acc, part_ml, B, T, nq, nkv, hd, _DTYPE_CODES[q.dtype], qst, kst, vst, chunk, splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError {rc}")
    count_launch(decode_attention)
    return out


decode_attention.launches = 0
