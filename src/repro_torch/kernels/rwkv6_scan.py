"""RWKV-6 WKV recurrence, chunk-parallel: the Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``wkv6_kernel`` / ``wkv6_chunked``
(``src/repro/kernels/rwkv6_scan.py``). The CUDA source, with its note on
what bounds it on the card (the exp of the intra-chunk triangle, ahead of
the bytes and the fp32 operations) and what its design does about that,
is ``csrc/rwkv6_scan.cu``. One call launches two passes over a grid of
one block per (batch, head, chunk): the first computes everything a chunk
needs of itself (the scores for ``j < t`` only, each exp on the fly, the
intra-chunk ``y``, the chunk's state increment ``U_c`` and decay), the
second carries the state to its chunk and adds the inter-chunk ``y``. The
passes hand over through three scratch tensors the wrapper allocates.

With ``cw`` the inclusive in-chunk cumsum of ``log(max(w, 1e-38))``,
``cw_prev = cw - log w`` and ``cw_last = cw[-1]``, every chunk computes

    scores[t,j] = Σ_i r[t,i]·k[j,i]·e^{cw_prev[t,i] - cw[j,i]}   (j < t)
    diag[t]     = Σ_i r[t,i]·u[i]·k[t,i]
    y           = scores @ v + diag·v + (r ⊙ e^{cw_prev}) @ S
    S          ← e^{cw_last}ᵀ ⊙ S + (k ⊙ e^{cw_last - cw})ᵀ @ v

starting from ``S = state0``. The reference starts from zero and folds
``state0`` in afterwards by linearity, with a log-cumsum over the whole
sequence; the two are the same function up to summation order.

Layout is the JAX package's: w/r/k/v ``(B, S, H, hs)`` fp32 with ``hs = 64``,
bonus ``(H, hs)``, state0 ``(B, H, hs, hs)``; returns y ``(B, S, H, hs)`` and
the last state ``(B, H, hs, hs)``, fp32.

:func:`wkv6` launches the kernel for CUDA tensors and runs :func:`wkv6_plain`
for CPU tensors only. The kernel is a forward kernel: a call that would need
a gradient raises until a backward kernel is ported.
"""

from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import count_launch

__all__ = ["wkv6", "wkv6_plain", "state_alignment_error", "KERNEL_CHUNKS", "HEAD_SIZE"]

#: chunk lengths the CUDA kernel is instantiated for
KERNEL_CHUNKS = (32, 64)
#: the only head size the kernel takes (``rwkv6.HEAD_SIZE``)
HEAD_SIZE = 64
LOG_FLOOR = 1e-38


def wkv6_plain(w, r, k, v, bonus, state0, chunk: int = 64):
    """The same chunked log-difference form in plain PyTorch, one chunk at
    a time: the ``(B, H, c, c, hs)`` exponent tensor is built per chunk,
    masked to ``j < t`` before the exponential."""
    B, S, H, hs = w.shape
    if S % chunk:
        raise ValueError(f"wkv6 needs S % chunk == 0, got S={S}, chunk={chunk}")
    fold = lambda a: a.float().permute(0, 2, 1, 3)  # (B, H, S, hs)
    w, r, k, v = map(fold, (w, r, k, v))
    u = bonus.float()[None, :, None, :]
    state = state0.float()
    below = torch.ones((chunk, chunk), dtype=torch.bool, device=w.device).tril(-1)[..., None]
    ys = []
    for c0 in range(0, S, chunk):
        wc, rc, kc, vc = (a[:, :, c0 : c0 + chunk] for a in (w, r, k, v))
        logw = torch.log(torch.clamp_min(wc, LOG_FLOOR))
        cw = torch.cumsum(logw, dim=2)
        cw_prev = cw - logw
        cw_last = cw[:, :, -1:]
        D = cw_prev[:, :, :, None, :] - cw[:, :, None, :, :]  # (B, H, c, c, hs)
        D = torch.where(below, D, torch.full_like(D, float("-inf")))
        scores = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * torch.exp(D)).sum(-1)
        diag = (rc * u * kc).sum(-1, keepdim=True)
        ys.append(scores @ vc + diag * vc + (rc * torch.exp(cw_prev)) @ state)
        state = torch.exp(cw_last).transpose(-1, -2) * state + (kc * torch.exp(cw_last - cw)).transpose(-1, -2) @ vc
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3).contiguous(), state


def state_alignment_error(ptr: int):
    """Why the kernel cannot read ``state0`` at this base address (bytes),
    or ``None``: its second pass reads the state as float4, which needs a
    16-byte aligned base."""
    if ptr % 16:
        return f"wkv6 kernel needs a 16-byte aligned state0, got address {ptr:#x}"
    return None


def _check(w, r, k, v, bonus, state0, chunk: int) -> None:
    if any(t.dim() != 4 for t in (w, r, k, v)):
        raise ValueError(f"wkv6 wants (B,S,H,hs) w/r/k/v, got {[tuple(t.shape) for t in (w, r, k, v)]}")
    B, S, H, hs = w.shape
    if not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"w/r/k/v shapes differ: {[tuple(t.shape) for t in (w, r, k, v)]}")
    if tuple(bonus.shape) != (H, hs) or tuple(state0.shape) != (B, H, hs, hs):
        raise ValueError(f"bonus {tuple(bonus.shape)} / state0 {tuple(state0.shape)} do not match w {tuple(w.shape)}")
    if S % chunk:
        raise ValueError(f"wkv6 needs S % chunk == 0, got S={S}, chunk={chunk}")
    devices = {t.device for t in (w, r, k, v, bonus, state0)}
    if len(devices) != 1:
        raise ValueError(f"wkv6 inputs on different devices: {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, r, k, v, bonus, state0)):
        raise NotImplementedError("wkv6 has a forward kernel only: no backward kernel is ported yet")


def wkv6(w, r, k, v, bonus, state0, chunk: int = 64):
    """WKV-6 forward. CUDA tensors launch the Hopper kernel (or raise); CPU
    tensors run :func:`wkv6_plain`."""
    _check(w, r, k, v, bonus, state0, chunk)
    if w.device.type == "cpu":
        return wkv6_plain(w, r, k, v, bonus, state0, chunk)
    if w.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {w.device}")
    B, S, H, hs = w.shape
    if hs != HEAD_SIZE:
        raise ValueError(f"wkv6 kernel takes hs == {HEAD_SIZE}, got {hs}")
    if chunk not in KERNEL_CHUNKS:
        raise ValueError(f"wkv6 kernel takes chunk in {KERNEL_CHUNKS}, got {chunk}")
    if any(t.dtype != torch.float32 for t in (w, r, k, v, bonus, state0)):
        raise ValueError(f"wkv6 kernel takes float32 only, got {[t.dtype for t in (w, r, k, v, bonus, state0)]}")
    if any(t.stride(3) != 1 for t in (w, r, k, v)):
        raise ValueError("wkv6 kernel needs a unit stride over hs")
    from repro_torch.kernels import _build

    lib = _build.load()
    bonus, state0 = bonus.contiguous(), state0.contiguous()
    err = state_alignment_error(state0.data_ptr())
    if err:
        raise ValueError(err)
    y = torch.empty((B, S, H, hs), dtype=torch.float32, device=w.device)
    s_out = torch.empty((B, H, hs, hs), dtype=torch.float32, device=w.device)
    # scratch the two passes hand over: each chunk's state increment U_c,
    # its decay e^{cw_last} and r * e^{cw_prev}, channel-major per chunk
    nc = S // chunk
    parts = [torch.empty(shape, dtype=torch.float32, device=w.device)
             for shape in ((B, H, nc, hs, hs), (B, H, nc, hs), (B, H, nc, hs, chunk))]
    strides = (ctypes.c_int64 * 12)(*(s for t in (w, r, k, v) for s in t.stride()[:3]))
    rc = lib.repro_wkv6_fwd(
        w.data_ptr(), r.data_ptr(), k.data_ptr(), v.data_ptr(), bonus.data_ptr(), state0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), *(t.data_ptr() for t in parts), B, S, H, hs, chunk, strides,
        torch.cuda.current_stream(w.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: cudaError {rc}")
    count_launch(wkv6)
    return y, s_out


wkv6.launches = 0
