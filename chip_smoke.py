#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds every
kernel against its plain PyTorch version on the card, serves requests with
the full-width ``qwen1.5-0.5b`` (random weights from a seed) through
``ServeEngine`` with the flash kernel on every prefill, runs an on-stream
datatype enqueue (MPIX stream → ``pack_send`` → ``dispatch_enqueue`` →
progress engine, then an ``OffloadWindow``) over a live KV leaf of the
served engine, and serves requests with the full-width ``rwkv6-7b``
(32 layers, d_model 4096, bf16, random weights from a seed) with the WKV-6
kernel on every prefill. Each phase prints one JSON line; any failure exits
non-zero before the last line. The last two lines are the per-kernel summary, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when CUDA is unavailable or when the
repository's ``src/`` is missing. Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, H100 SXM data sheet
# exp/log results: 16 per SM per clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, cc 9.0) x 132 SMs x 1.98 GHz boost
H100_SFU_PER_S = 16 * 132 * 1.98e9
TIMED_REPS = 20

# main-path shapes: the full-width qwen1.5-0.5b prefill (16 heads, hd 64)
# at the served prompt lengths, and one slot's 256-position span of a
# full-width KV leaf (24 layers, 4 slots, 512 positions, 16x64 per position)
FLASH_SERVE_S = (128, 256, 384)
KV_LEAF = (24, 4, 512, 1024)
KV_SPAN = 256
# WKV-6: the reference's sweep (test_kernels.py:71) at B = 2, H = 2, and the
# full-width rwkv6-7b prefill of the longest served prompt (B = 1, 64 heads)
WKV_SWEEP = ((64, 32), (128, 64), (256, 64), (96, 32))
WKV_SERVE = (1, 448, 64)
RWKV_SERVE_S = (128, 256, 448)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median device time of a callable over TIMED_REPS launches, each
    timed with its own CUDA events, with the 50 MB L2 flushed before each
    launch (the serving path finds these operands cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(TIMED_REPS):
            self.flush.zero_()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def within(a, b, tol: float, rtol=None) -> bool:
    """assert_allclose semantics: |a - b| <= tol + rtol * |b| elementwise
    (``rtol`` defaults to ``tol``)."""
    a, b = a.float(), b.float()
    rtol = tol if rtol is None else rtol
    return bool(((a - b).abs() <= tol + rtol * b.abs()).all().item())


def host_ms(torch, fn, reps=5) -> float:
    """Median host-clock ms of ``fn`` alone, between two syncs."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def bytes_equal(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def phase_kernels(torch, timer):
    """Every kernel against its plain version at the main-path shapes, and
    the timings of the summary line."""
    from repro_torch.kernels import dt_pack as dp
    from repro_torch.kernels import flash_attention as fa

    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(11)

    def qkv(B, S, nq, nkv, hd, dtype):
        mk = lambda n: torch.randn(B, S, n, hd, generator=gen, device="cuda").to(dtype)
        return mk(nq), mk(nkv), mk(nkv)

    cases = [(1, S, 16, 16, 64, torch.bfloat16, True, 2e-2) for S in FLASH_SERVE_S]
    cases += [(1, S, 16, 16, 64, torch.float32, True, 2e-5) for S in FLASH_SERVE_S]
    cases += [
        (1, 256, 16, 4, 64, torch.float32, True, 3e-5),  # GQA, 4 query heads per KV head
        (1, 256, 8, 8, 128, torch.float32, True, 2e-5),  # hd 128
        (1, 256, 16, 16, 64, torch.float32, False, 2e-5),  # non-causal
        (2, 128, 16, 4, 128, torch.bfloat16, True, 2e-2),
    ]
    flash_rows = []
    serve_err = 0.0
    for B, S, nq, nkv, hd, dtype, causal, tol in cases:
        q, k, v = qkv(B, S, nq, nkv, hd, dtype)
        out = fa.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal)
        err = max_err(out, ref)
        row = dict(B=B, S=S, nq=nq, nkv=nkv, hd=hd, dtype=str(dtype).split(".")[-1], causal=causal,
                   tol=tol, max_abs_err=err, ok=within(out, ref, tol))
        flash_rows.append(row)
        check(row["ok"], f"flash_attention vs plain within {tol}: {row}")
        if dtype == torch.bfloat16 and (B, nq, nkv, hd) == (1, 16, 16, 64):
            serve_err = max(serve_err, err)

    # timings at each served prompt length (bf16, the serving dtype)
    flash_times = []
    for S in FLASH_SERVE_S:
        q, k, v = qkv(1, S, 16, 16, 64, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = timer(lambda: fa.flash_attention(q, k, v))
        plain_ms = timer(lambda: fa.flash_attention_plain(q, k, v))
        lib_ms = timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        nbytes = 4 * q.numel() * q.element_size()  # q, k, v read once, out written once
        flops = 4 * 16 * 64 * S * (S + 1) // 2  # QK^T and PV over the causal triangle
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, flops / H100_BF16_FLOPS * 1e3
        flash_times.append(dict(S=S, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes, flops=flops,
                                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                                fp32_pipe_ms=flops / H100_FP32_FLOPS * 1e3))
    emit("kernels", kernel="flash_attention", cases=flash_rows, timings=flash_times)

    # dt_pack / dt_unpack: byte-exact over the reference sweep shapes and
    # the enqueue phase's KV span (start = slot 1, position 128)
    sweep = [(64, 8, 16, torch.float32, 0), (128, 16, 64, torch.float32, 0), (256, 4, 8, torch.bfloat16, 0),
             (32, 32, 32, torch.float32, 0), (61, 8, 16, torch.float32, 0), (300, 16, 4096, torch.float32, 0),
             (61, 8, 16, torch.float32, 3), (256, 4, 8, torch.bfloat16, 1)]
    L, Bs, T, W = KV_LEAF
    span = (L, KV_SPAN * W, Bs * T * W, (1 * T + 128) * W)  # nseg, seg_len, stride, start
    sweep.append((span[0], span[1], span[2], torch.bfloat16, span[3]))
    pack_rows = []
    for nseg, seg, stride, dtype, start in sweep:
        n = start + nseg * stride
        buf = torch.randn(n, generator=gen, device="cuda").to(dtype)
        out = dp.dt_pack(buf, nseg=nseg, seg_len=seg, stride=stride, start=start)
        back = dp.dt_unpack(out, nseg=nseg, seg_len=seg, stride=stride, start=start, out_len=n)
        torch.cuda.synchronize()
        ok_pack = bytes_equal(torch, out, dp.dt_pack_plain(buf, nseg, seg, stride, start))
        ok_unpack = bytes_equal(torch, back, dp.dt_unpack_plain(out, nseg, seg, stride, start, n))
        row = dict(nseg=nseg, seg_len=seg, stride=stride, start=start, dtype=str(dtype).split(".")[-1],
                   pack_byte_exact=ok_pack, unpack_byte_exact=ok_unpack)
        pack_rows.append(row)
        check(ok_pack and ok_unpack, f"dt_pack/dt_unpack byte-exact: {row}")

    nseg, seg, stride, start = span
    out_len = L * Bs * T * W
    buf = torch.randn(out_len, generator=gen, device="cuda").to(torch.bfloat16)
    packed = dp.dt_pack(buf, nseg=nseg, seg_len=seg, stride=stride, start=start)
    zeros = torch.zeros(out_len, dtype=torch.bfloat16, device="cuda")
    item = 2
    pack_bytes = 2 * nseg * seg * item
    unpack_bytes = nseg * seg * item + out_len * item
    pack_t = dict(
        ms=timer(lambda: dp.dt_pack(buf, nseg=nseg, seg_len=seg, stride=stride, start=start)),
        plain_ms=timer(lambda: dp.dt_pack_plain(buf, nseg, seg, stride, start)),
        library_ms=timer(lambda: buf.as_strided((nseg, seg), (stride, 1), start).contiguous()),
        bytes=pack_bytes, bound_ms=pack_bytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    unpack_t = dict(
        ms=timer(lambda: dp.dt_unpack(packed, nseg=nseg, seg_len=seg, stride=stride, start=start, out_len=out_len)),
        plain_ms=timer(lambda: dp.dt_unpack_plain(packed, nseg, seg, stride, start, out_len)),
        library_ms=timer(lambda: torch.as_strided_scatter(zeros, packed.view(nseg, seg), (nseg, seg), (stride, 1), start)),
        bytes=unpack_bytes, bound_ms=unpack_bytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    emit("kernels", kernel="dt_pack", cases=pack_rows, shape=dict(nseg=nseg, seg_len=seg, stride=stride, start=start,
         out_len=out_len, dtype="bfloat16"), pack=pack_t, unpack=unpack_t)
    wkv = wkv6_kernel_rows(torch, timer, gen)
    return dict(flash_times=flash_times, flash_err=serve_err, pack=pack_t, unpack=unpack_t, wkv=wkv)


def wkv6_bound(B, S, H, chunk, hs=64) -> dict:
    """The least time the card needs for one WKV-6 call: each input read
    and each output written once (w/r/k/v and y, state0 and the last
    state, the bonus), the fp32 operations of the chunked form, and its
    exp/log results; the largest of the three times."""
    n = B * H * (S // chunk)  # (batch, head, chunk) tiles
    tri = chunk * (chunk - 1) // 2  # strict lower triangle of the scores
    nbytes = (5 * B * S * H * hs + 2 * B * H * hs * hs + H * hs) * 4
    flops = n * (4 * tri * hs          # r·k·e^{Δ} summed over i
                 + 2 * tri * hs        # scores @ v over the triangle
                 + 3 * chunk * hs      # bonus diagonal
                 + 2 * chunk * hs      # diag · v
                 + 2 * chunk * hs * hs  # (r e^{cw_prev}) @ S
                 + 2 * chunk * hs * hs  # k_remᵀ @ v
                 + 2 * hs * hs         # e^{cw_last} ⊙ S
                 + 4 * chunk * hs)     # log-cumsum, cw_prev, r and k decays
    sfu = n * (tri * hs + 3 * chunk * hs + hs)  # exp over the triangle, log w, two decays, e^{cw_last}
    t = dict(bytes=nbytes / H100_BYTES_PER_S * 1e3, fp32=flops / H100_FP32_FLOPS * 1e3, sfu=sfu / H100_SFU_PER_S * 1e3)
    top = max(t, key=t.get)
    return dict(bytes=nbytes, flops=flops, exp_log=sfu, bytes_ms=t["bytes"], fp32_ms=t["fp32"], exp_log_ms=t["sfu"],
                bound_ms=t[top], bound_by="bytes" if top == "bytes" else "operations", set_by=top)


def wkv6_kernel_rows(torch, timer, gen):
    """K3 against its plain version: the reference's sweep at 5e-4, the
    strong-decay case (finite, 1e-3 abs / 1e-2 rel), and the served shape
    with a non-zero state0, timed there."""
    from repro_torch.kernels import rwkv6_scan as wk

    def inputs(B, S, H):
        n = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
        w = torch.sigmoid(n(B, S, H, 64)) * 0.5 + 0.45
        return w, n(B, S, H, 64), n(B, S, H, 64), n(B, S, H, 64), n(H, 64) * 0.1, n(B, H, 64, 64) * 0.1

    rows = []
    for S, chunk in WKV_SWEEP:
        args = inputs(2, S, 2)
        y, st = wk.wkv6(*args, chunk=chunk)
        torch.cuda.synchronize()
        yp, sp = wk.wkv6_plain(*args, chunk=chunk)
        row = dict(B=2, S=S, H=2, chunk=chunk, tol=5e-4, max_abs_err=max(max_err(y, yp), max_err(st, sp)),
                   ok=within(y, yp, 5e-4) and within(st, sp, 5e-4))
        rows.append(row)
        check(row["ok"], f"wkv6 vs plain within 5e-4: {row}")

    w, r, k, v, _, _ = inputs(1, 64, 1)
    w = torch.full_like(w, 1e-6)
    u, s0 = torch.zeros(1, 64, device="cuda"), torch.zeros(1, 1, 64, 64, device="cuda")
    y, _ = wk.wkv6(w, r, k, v, u, s0, chunk=32)
    torch.cuda.synchronize()
    yp, _ = wk.wkv6_plain(w, r, k, v, u, s0, chunk=32)
    strong = dict(S=64, chunk=32, w=1e-6, finite=bool(torch.isfinite(y).all()), max_abs_err=max_err(y, yp),
                  ok=bool(torch.isfinite(y).all()) and within(y, yp, 1e-3, 1e-2))
    check(strong["ok"], f"wkv6 strong decay finite and within 1e-3/1e-2: {strong}")

    B, S, H = WKV_SERVE
    args = inputs(B, S, H)
    y, st = wk.wkv6(*args, chunk=64)
    torch.cuda.synchronize()
    yp, sp = wk.wkv6_plain(*args, chunk=64)
    err = max(max_err(y, yp), max_err(st, sp))
    served = dict(B=B, S=S, H=H, chunk=64, tol=5e-4, max_abs_err=err, y_scale=yp.abs().max().item(),
                  ok=within(y, yp, 5e-4) and within(st, sp, 5e-4))
    check(served["ok"], f"wkv6 vs plain at the served shape within 5e-4: {served}")
    served.update(ms=timer(lambda: wk.wkv6(*args, chunk=64)), plain_ms=timer(lambda: wk.wkv6_plain(*args, chunk=64)),
                  library_ms=None, library_note="no single PyTorch call computes WKV-6", **wkv6_bound(B, S, H, 64))
    emit("kernels", kernel="wkv6", cases=rows, strong_decay=strong, served=served)
    return served


def phase_serve(torch):
    """Full-width qwen1.5-0.5b behind ServeEngine, flash on every prefill."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("qwen1.5-0.5b").replace(attn_impl="flash")
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    lens = [FLASH_SERVE_S[i % len(FLASH_SERVE_S)] for i in range(8)]
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in lens]

    # warm-up (library handles, allocator) outside the counted run
    for p in prompts[: len(FLASH_SERVE_S)]:
        api.prefill(cfg, model, {"tokens": p[None]}, max_len=512)
    torch.cuda.synchronize()

    pe = ProgressEngine()
    eng = ServeEngine(cfg, model, max_batch=4, max_len=512, progress_engine=pe, step_schedule=True)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0  # count the main path only
    errors = []

    def drive():
        try:
            eng.run_until_done()
        except BaseException as e:  # surfaced on the main thread below
            errors.append(e)

    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    submitted = time.perf_counter()
    worker = threading.Thread(target=drive, name="serve-driver")
    worker.start()
    done_at, order = {}, []
    pending = list(reqs)
    deadline = time.monotonic() + 600
    while pending and time.monotonic() < deadline and not errors:
        r = eng.wait_any(pending, timeout=1.0)  # stream results as they finish
        if r is not None:
            done_at[r.rid] = time.perf_counter()
            order.append(r.rid)
            pending.remove(r)
    worker.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_launches = fa.flash_attention.launches
    decode_steps = eng.step_schedule.stats()["replays"]
    pe.stop_all()
    if errors:
        raise errors[0]
    check(not worker.is_alive(), "serve driver thread finished")
    check(not pending, f"{len(pending)} requests never completed")
    check(all(r.done and len(r.out_tokens) == 16 for r in reqs),
          f"every request has 16 tokens: {[len(r.out_tokens) for r in reqs]}")
    n_prefills = len(reqs)
    check(flash_launches >= cfg.n_layers * n_prefills,
          f"flash launches {flash_launches} >= {cfg.n_layers} layers x {n_prefills} prefills")
    toks = sum(len(r.out_tokens) for r in reqs)
    lats = [done_at[r.rid] - submitted for r in reqs]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one prefill's last logits: flash kernel vs the einsum path, same weights
    p = {"tokens": prompts[1][None]}  # 256 tokens
    l_flash, _ = api.prefill(cfg, model, p, max_len=512)
    l_ein, _ = api.prefill(cfg.replace(attn_impl="einsum"), model, p, max_len=512)
    rel_bf16 = max_err(l_flash, l_ein) / l_ein.abs().max().item()
    # bf16 rounds P (and the logits) in the einsum path but not in the kernel;
    # over 24 random-weight layers that drift stays a few percent of scale
    tol_bf16 = 5e-2
    check(rel_bf16 <= tol_bf16, f"bf16 flash vs einsum prefill logits: rel {rel_bf16} <= {tol_bf16}")
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model32 = copy.deepcopy(model).float()  # same weights, widened
    l32_flash, _ = api.prefill(cfg32, model32, p, max_len=512)
    l32_ein, _ = api.prefill(cfg32.replace(attn_impl="einsum"), model32, p, max_len=512)
    rel_fp32 = max_err(l32_flash, l32_ein) / l32_ein.abs().max().item()
    tol_fp32 = 1e-3  # fp32 everywhere: only summation order differs
    check(rel_fp32 <= tol_fp32, f"fp32 flash vs einsum prefill logits: rel {rel_fp32} <= {tol_fp32}")
    check(bool(torch.isfinite(l_flash).all()) and l_flash.shape == (1, cfg.vocab), "finite (1, vocab) logits")
    del model32

    # where the serve time goes: one prefill of the longest prompt and one
    # batched decode step, each alone on the host clock between two syncs
    cache = api.init_cache(cfg, 4, 512, "cuda")
    step_tok = torch.zeros(4, dtype=torch.long, device="cuda")
    step_pos = torch.full((4,), 400, dtype=torch.long, device="cuda")
    prefill_ms = host_ms(torch, lambda: api.prefill(cfg, model, {"tokens": prompts[2][None]}, max_len=512))
    decode_ms = host_ms(torch, lambda: api.decode_step(cfg, model, cache, step_tok, step_pos))
    # a decode step reads every weight and the whole KV cache once
    kv_bytes = sum(t.numel() * t.element_size() for group in cache for entry in group for t in entry)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    decode_bound_ms = (param_bytes + kv_bytes) / H100_BYTES_PER_S * 1e3
    del cache

    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
         init_s=init_s, requests=len(reqs), prompt_lens=lens, max_new_tokens=16, max_batch=4, max_len=512,
         tokens=toks, wall_s=wall, tokens_per_s=toks / wall,
         latency_p50_ms=float(np.percentile(lats, 50) * 1e3), latency_p95_ms=float(np.percentile(lats, 95) * 1e3),
         completion_order=order, flash_launches=flash_launches, prefills=n_prefills, decode_steps=decode_steps,
         prefill_384_host_ms=prefill_ms, decode_step_host_ms=decode_ms, decode_step_bound_ms=decode_bound_ms,
         peak_mem_gb=peak_gb, prefill_logits_rel_err_bf16=rel_bf16, tol_bf16=tol_bf16,
         prefill_logits_rel_err_fp32=rel_fp32, tol_fp32=tol_fp32, device=torch.cuda.get_device_name(0))
    return eng, dict(flash_launches=flash_launches)


def phase_enqueue(torch, eng):
    """Extensions 2+3+4 on the card: datatype-described send buffers
    packed on an MPIX stream bound to a CUDA stream, completed through the
    progress engine, then through an OffloadWindow of depth 2."""
    import numpy as np

    from repro_torch.core import datatype as dtt
    from repro_torch.core.enqueue import OffloadWindow, _poll_dispatched, dispatch_enqueue, pack_send
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.core.streams import stream_create, stream_free
    from repro_torch.kernels import dt_pack as dp
    from repro_torch.kernels.ops import unpack_datatype

    leaf = eng.cache[0][0][0]  # K of every layer: (24, 4, 512, 16, 64) bf16, live
    check(tuple(leaf.shape[:3]) + (leaf.shape[3] * leaf.shape[4],) == KV_LEAF, f"KV leaf shape {tuple(leaf.shape)}")
    L, Bs, T, W = KV_LEAF

    def span(slot, p0):
        return dtt.subarray(KV_LEAF, (L, 1, KV_SPAN, W), (0, slot, p0, 0), dtt.BF16)

    pe = ProgressEngine()
    s = stream_create(info={"type": "cudaStream_t"}, name="kv-offload")
    side = s.torch_stream(leaf.device)
    check(s.is_offload and side is not None, "cudaStream_t MPIX stream owns a CUDA stream")
    host = leaf.cpu()
    dp.dt_pack.launches = dp.dt_unpack.launches = 0  # count the main path only
    try:
        dt0 = span(1, 128)
        info = dtt.pack_info(dt0)
        y = pack_send(leaf, dt0, stream=s)
        req = dispatch_enqueue(y, stream=s, engine=pe, name="kv-span")
        check(pe.wait_all([req.grequest], timeout=60), "enqueued pack completes through wait_all")
        check(bytes_equal(torch, y.cpu(), torch.from_numpy(dtt.pack(host, dt0)).view(torch.bfloat16)),
              "on-stream pack == host datatype.pack, byte for byte")

        win = OffloadWindow(stream=s, depth=2, engine=pe, name="kv-spans")
        spans = [span(i % Bs, 128 * (i % 3)) for i in range(4)]
        ys = []
        for dt in spans:
            with win.issue(timeout=60) as submit:
                yi = pack_send(leaf, dt, stream=s)
                submit(dispatch_enqueue(yi, stream=s, engine=pe, name="kv-span-win"), value=yi)
            ys.append(yi)
        slots = win.drain(timeout=60)
        wst = win.stats(engine=False)
        check(len(slots) == 4 and wst["admitted"] == 4 and wst["max_depth_seen"] <= 2, f"window stats {wst}")
        for dt, yi in zip(spans, ys):
            check(bytes_equal(torch, yi.cpu(), torch.from_numpy(dtt.pack(host, dt)).view(torch.bfloat16)),
                  "windowed pack == host datatype.pack")

        back = unpack_datatype(y, dt0, leaf.numel(), info=info)
        ref = torch.zeros(leaf.numel(), dtype=torch.bfloat16)
        dtt.unpack(y.cpu(), dt0, ref)
        check(bytes_equal(torch, back.cpu(), ref), "unpack_datatype == host datatype.unpack (zero gaps)")
        region = back.view(leaf.shape)[:, 1, 128:128 + KV_SPAN]
        check(bytes_equal(torch, region, leaf[:, 1, 128:128 + KV_SPAN]), "round trip restores the span")

        # a not-yet-complete event polls False: the pack queues behind a sleep
        with torch.cuda.stream(side):
            torch.cuda._sleep(int(5e8))
        y_late = pack_send(leaf, dt0, stream=s)
        late = dispatch_enqueue(y_late, stream=s, engine=pe, name="kv-span-late")
        polled_early = _poll_dispatched(late.grequest.extra_state)
        tested_early = pe.test(late.grequest)
        check(not polled_early and not tested_early, "event behind a device sleep polls False")
        check(pe.wait_all([late.grequest], timeout=60) and late.done, "late pack completes")
        torch.cuda.synchronize()
        launches = dict(dt_pack=dp.dt_pack.launches, dt_unpack=dp.dt_unpack.launches)
        check(launches["dt_pack"] > 0 and launches["dt_unpack"] > 0, f"dt_pack kernels launched: {launches}")
        st = pe.stats()
    finally:
        pe.stop_all()
        stream_free(s)
    emit("enqueue", stream=dict(kind=s.kind, channel=s.channel, info=dict(s.info)),
         layout=dict(zip(("nseg", "seg_bytes", "stride_bytes", "disp"), info)), packed_mb=y.numel() * 2 / 1e6,
         window=wst, early_poll=polled_early, early_test=tested_early, launches=launches,
         engine=dict(completions=st["completions"], polls=st["polls"], parks=st["parks"]))
    return launches


def rwkv_route_errors(torch, cfg, model, p) -> dict:
    """On prompt ``p`` (448 tokens): the last logits of the kernel route
    against the default route, and of one decode step after a 447-token
    prefill against the 448-token prefill; each as max |a - b| over the
    second's largest magnitude. Every logit must be finite. Returns the
    errors and the default route's logits."""
    from repro_torch.models import api
    from repro_torch.models import rwkv6 as R

    with torch.no_grad():
        l_kernel = R.rwkv_forward(cfg, model, {"tokens": p[None]}, use_kernel=True)[0][:, -1]
        l_default = R.rwkv_forward(cfg, model, {"tokens": p[None]}, use_kernel=False)[0][:, -1]
    l_pre, state = api.prefill(cfg, model, {"tokens": p[None, :-1]}, max_len=512)
    l_dec, _ = api.decode_step(cfg, model, state, torch.as_tensor(p[-1:], device="cuda"),
                               torch.full((1,), len(p) - 1, dtype=torch.long, device="cuda"))
    for name, t in (("kernel", l_kernel), ("default", l_default), ("prefill_447", l_pre), ("decode", l_dec)):
        check(bool(torch.isfinite(t).all()) and t.shape == (1, cfg.vocab), f"{cfg.param_dtype} {name} logits finite")
    return dict(kernel_vs_default=max_err(l_kernel, l_default) / l_default.abs().max().item(),
                decode_vs_prefill=max_err(l_dec, l_kernel) / l_kernel.abs().max().item(),
                logit_scale=l_kernel.abs().max().item()), l_default


def rwkv_layer_route_errors(torch, cfg, model, p) -> list:
    """Every layer's time-mix on one shared input (the kernel route's own
    activations), through both WKV routes: max |kernel - default| over the
    default output's largest magnitude, per layer. One bf16 rounding apart
    at most, before any later layer can compound it."""
    from repro_torch.models import rwkv6 as R
    from repro_torch.models.common import apply_norm, embed

    errs = []
    with torch.no_grad():
        x = embed(cfg, model.embed, torch.as_tensor(p, device="cuda")[None].long())
        st = R.init_state(cfg, 1, device="cuda")
        for l, layer in enumerate(model.layers):
            h = apply_norm(cfg, layer.ln1, x)
            a_k = R._time_mix(cfg, layer, h, st["x_tm"][l], st["wkv"][l], True)[0]
            a_d = R._time_mix(cfg, layer, h, st["x_tm"][l], st["wkv"][l], False)[0]
            errs.append(max_err(a_k, a_d) / a_d.abs().max().item())
            x, _ = R._layer(cfg, layer, x, {k: st[k][l] for k in R.STATE_KEYS}, True)
    return errs


def phase_serve_rwkv(torch):
    """Full-width rwkv6-7b behind ServeEngine, the WKV-6 kernel on every
    prefill (every prompt length is a multiple of 64), none in decode."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.kernels import rwkv6_scan as wk
    from repro_torch.models import api
    from repro_torch.models import rwkv6 as R
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("rwkv6-7b").replace(attn_impl="flash")
    t0 = time.perf_counter()
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    lens = [RWKV_SERVE_S[i % len(RWKV_SERVE_S)] for i in range(8)]
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in lens]

    # warm-up (library handles, allocator) outside the counted run
    for p in prompts[: len(RWKV_SERVE_S)]:
        api.prefill(cfg, model, {"tokens": p[None]}, max_len=512)
    torch.cuda.synchronize()

    pe = ProgressEngine()
    eng = ServeEngine(cfg, model, max_batch=4, max_len=512, progress_engine=pe, step_schedule=True)
    decode_launches = []
    plain_decode = eng._decode

    def counted_decode(*a):  # K3 launches inside each decode step
        before = wk.wkv6.launches
        out = plain_decode(*a)
        decode_launches.append(wk.wkv6.launches - before)
        return out

    eng._decode = counted_decode
    torch.cuda.reset_peak_memory_stats()
    wk.wkv6.launches = 0  # count the main path only
    errors = []

    def drive():
        try:
            eng.run_until_done()
        except BaseException as e:  # surfaced on the main thread below
            errors.append(e)

    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    submitted = time.perf_counter()
    worker = threading.Thread(target=drive, name="serve-rwkv-driver")
    worker.start()
    done_at, order = {}, []
    pending = list(reqs)
    deadline = time.monotonic() + 600
    while pending and time.monotonic() < deadline and not errors:
        r = eng.wait_any(pending, timeout=1.0)
        if r is not None:
            done_at[r.rid] = time.perf_counter()
            order.append(r.rid)
            pending.remove(r)
    worker.join(timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wk.wkv6.launches
    decode_steps = eng.step_schedule.stats()["replays"]
    pe.stop_all()
    if errors:
        raise errors[0]
    check(not worker.is_alive(), "serve driver thread finished")
    check(not pending, f"{len(pending)} requests never completed")
    check(all(r.done and len(r.out_tokens) == 16 for r in reqs),
          f"every request has 16 tokens: {[len(r.out_tokens) for r in reqs]}")
    check(launches == cfg.n_layers * len(reqs), f"wkv6 launches {launches} == {cfg.n_layers} layers x {len(reqs)} prefills")
    check(len(decode_launches) > 0 and sum(decode_launches) == 0, f"no wkv6 launch in {len(decode_launches)} decode steps")
    toks = sum(len(r.out_tokens) for r in reqs)
    lats = [done_at[r.rid] - submitted for r in reqs]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # one 448-token prompt: the kernel route against the default route and
    # a decode step after a 447-token prefill against the 448-token prefill,
    # in bf16 (reported, and every layer held on a shared input) and on an
    # fp32 copy of the same weights (held whole-model)
    p = prompts[2]
    check(len(p) == 448, "the third prompt has 448 tokens")
    bf16, l_default16 = rwkv_route_errors(torch, cfg, model, p)
    layer_errs = rwkv_layer_route_errors(torch, cfg, model, p)
    tol_layer = 2e-2  # the reference's kernel-vs-default bound (test_kernels.py:114)
    check(max(layer_errs) <= tol_layer, f"every layer's time-mix, kernel vs default route: {max(layer_errs)} <= {tol_layer}")
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model32 = R.RWKVLM(cfg32, "cuda")
    model32.load_state_dict(model.state_dict())  # same weights, widened
    fp32, l_default32 = rwkv_route_errors(torch, cfg32, model32, p)
    # the model's own bf16 rounding noise at this depth: the default route
    # in bf16 against the same route in fp32
    bf16["default_bf16_vs_fp32"] = max_err(l_default16, l_default32) / l_default32.abs().max().item()
    del model32
    torch.cuda.empty_cache()
    tol_route32 = 1e-3  # fp32 everywhere: only summation order differs
    tol_decode = 5e-2  # the reference's decode-vs-full bound (test_models_smoke.py:107)
    check(fp32["kernel_vs_default"] <= tol_route32,
          f"fp32 kernel vs default route, last logits: rel {fp32['kernel_vs_default']} <= {tol_route32}")
    check(fp32["decode_vs_prefill"] <= tol_decode,
          f"fp32 decode after 447 vs prefill of 448: rel {fp32['decode_vs_prefill']} <= {tol_decode}")

    # where the serve time goes: one 448-token prefill and one batched
    # decode step, each alone on the host clock between two syncs
    cache = api.init_cache(cfg, 4, 512, "cuda")
    step_tok = torch.zeros(4, dtype=torch.long, device="cuda")
    step_pos = torch.full((4,), 400, dtype=torch.long, device="cuda")
    prefill_ms = host_ms(torch, lambda: api.prefill(cfg, model, {"tokens": p[None]}, max_len=512))
    decode_ms = host_ms(torch, lambda: api.decode_step(cfg, model, cache, step_tok, step_pos))
    # a decode step reads every weight once and reads and writes the state
    state_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    param_bytes = sum(q.numel() * q.element_size() for q in model.parameters())
    decode_bound_ms = (param_bytes + 2 * state_bytes) / H100_BYTES_PER_S * 1e3
    del cache

    emit("serve_rwkv", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.d_model // 64,
         params=n_params, param_counts_total=cfg.param_counts()["total"], init_s=init_s, requests=len(reqs),
         prompt_lens=lens, max_new_tokens=16, max_batch=4, max_len=512, tokens=toks, wall_s=wall,
         tokens_per_s=toks / wall,
         latency_p50_ms=float(np.percentile(lats, 50) * 1e3), latency_p95_ms=float(np.percentile(lats, 95) * 1e3),
         completion_order=order, wkv6_launches=launches, wkv6_launches_in_decode=sum(decode_launches),
         prefills=len(reqs), decode_steps=decode_steps, prefill_448_host_ms=prefill_ms,
         decode_step_host_ms=decode_ms, decode_step_bound_ms=decode_bound_ms, peak_mem_gb=peak_gb,
         logits_bf16=bf16, logits_fp32=fp32, tol_fp32_kernel_vs_default=tol_route32,
         tol_decode_vs_prefill=tol_decode, layer_time_mix_rel_bf16=layer_errs, tol_layer=tol_layer,
         device=torch.cuda.get_device_name(0))
    return dict(launches=launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    regs, src = {}, None
    for ln in info["log"].splitlines():  # the first four register/spill lines of each source
        if ln.startswith("== "):
            src = ln[3:].strip()
            regs[src] = []
        elif src and len(regs[src]) < 4 and ("registers" in ln or "spill" in ln and " 0 bytes spill" not in ln):
            regs[src].append(ln.strip())
    emit("build", seconds=time.perf_counter() - t0, compiled=info["built"], library=str(Path(info["path"]).relative_to(ROOT)),
         ptxas=regs)

    timer = Timer(torch)
    kern = phase_kernels(torch, timer)
    eng, serve = phase_serve(torch)
    enq = phase_enqueue(torch, eng)
    del eng
    rwkv = phase_serve_rwkv(torch)

    ft = kern["flash_times"][-1]  # the longest served prompt, S = 384
    entries = [
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:75", launches=serve["flash_launches"],
             max_abs_err=kern["flash_err"], ms=ft["ms"], plain_ms=ft["plain_ms"], bound_ms=ft["bound_ms"],
             bound_by=ft["bound_by"], library_ms=ft["library_ms"]),
        dict(name="dt_pack", route="cuda", source="src/repro_torch/csrc/dt_pack.cu",
             replaces="src/repro/kernels/dt_pack.py:50", launches=enq["dt_pack"], max_abs_err=0.0,
             ms=kern["pack"]["ms"], plain_ms=kern["pack"]["plain_ms"], bound_ms=kern["pack"]["bound_ms"],
             bound_by="bytes", library_ms=kern["pack"]["library_ms"]),
        dict(name="dt_unpack", route="cuda", source="src/repro_torch/csrc/dt_pack.cu",
             replaces="src/repro/kernels/dt_pack.py:78", launches=enq["dt_unpack"], max_abs_err=0.0,
             ms=kern["unpack"]["ms"], plain_ms=kern["unpack"]["plain_ms"], bound_ms=kern["unpack"]["bound_ms"],
             bound_by="bytes", library_ms=kern["unpack"]["library_ms"]),
        dict(name="wkv6", route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
             replaces="src/repro/kernels/rwkv6_scan.py:81", launches=rwkv["launches"],
             max_abs_err=kern["wkv"]["max_abs_err"], ms=kern["wkv"]["ms"], plain_ms=kern["wkv"]["plain_ms"],
             bound_ms=kern["wkv"]["bound_ms"], bound_by=kern["wkv"]["bound_by"], library_ms=None),
    ]
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} launched on the main path")
        check(all(isinstance(e[k], (int, float)) and math.isfinite(e[k]) for k in ("ms", "plain_ms", "bound_ms")),
              f"{e['name']} timings measured")
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
