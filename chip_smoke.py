#!/usr/bin/env python3
"""End-to-end check of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --timer-ab   # only time the kernels under the timer's variants

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds every
kernel against its plain PyTorch version on the card (the decode attention
against an fp32 reference at phi-3's, granite's, gemma3's and the smoke
presets' decode shapes, with the cache rows past each slot's length set to
NaN, and its launches counted on every served decode step), serves requests with
the full-width ``qwen1.5-0.5b`` (random weights from a seed) through
``ServeEngine`` with the flash kernel on every prefill, runs an on-stream
datatype enqueue (MPIX stream → ``pack_send`` → ``dispatch_enqueue`` →
progress engine, then an ``OffloadWindow``) over a live KV leaf of the
served engine, serves 12 requests through the paged KV cache on the card
(``PagedServeEngine`` behind ``AdmissionFrontEnd`` and under the elastic
threadcomm loop with a killed rank, each held token for token against the
contiguous ``ServeEngine``, every page move a K1 launch), runs the
distributed layer on a mesh of thread-ranks, trains the full-width
``qwen1.5-0.5b`` (``Trainer``: asynchronous checkpoints restored byte-equal,
a resume, the windowed gradient path against the fused one, the elastic
kill-rank walk at 4 layers, and the trained model served with flash), runs
the second training path at full width (the windowed 1F1B pipeline forward
with flash on every layer, recorded and replayed; the pipelined loss and
its gradients; the sharded ZeRO-1 step on a ``(2, 2, 2)`` mesh of
thread-ranks with its checkpoint and a sharded restore), and
serves requests with the full-width ``rwkv6-7b``
(32 layers, d_model 4096, bf16, random weights from a seed) with the WKV-6
kernel on every prefill, and runs the rest of the transformer zoo at the
published widths (``zoo``: the MoE ``granite-moe-1b-a400m`` served with
flash at hd 64; ``gemma3-4b`` served with its local layers' ring caches
wrapping and flash at hd 256 on its global layers; ``phi-3-vision-4.2b``'s
image prefix with flash at hd 96; ``deepseek-v3-671b``'s MLA and 256-expert
MoE cut to 4 layers, decoding through the absorbed latent cache), and the
rest of the model zoo (``zoo2``: ``jamba-v0.1-52b`` cut to one period of 8
layers, served with its Mamba states in the engine's cache and flash at
hd 128 on its attention layer; ``whisper-tiny``'s 1500 stub frames and
decoder prompts through the api with flash at hd 64 on the decoder; the
``Trainer`` on whisper-tiny and on rwkv6-7b cut to 4 layers), runs the
sharded step for every family the card can hold twice against the
single-rank step (``sharded_zoo``: granite-moe-1b-a400m whole, with MoE
routing over the data-parallel groups, then an fp32 copy cut in depth and
the trained model's flash prefill; phi-3-vision and rwkv6-7b cut in depth;
whisper-tiny whole, hint-free and under each layout hint), serves through
the sharded prefill and decode steps (``sharded_serve``: qwen1.5-0.5b and
granite-moe-1b-a400m at full width and depth on a ``(2, 4)`` mesh of
thread-ranks, tensor-parallel over ``model``
with the flash kernel on every rank's heads and the decode
sequence-parallel over the cache, against the single-rank steps), runs
the port's five examples as a user does (``examples``: each
``examples/port/*.py`` in a process of its own on the card with its
defaults, ``train_lm.py`` trained and then resumed from its last save), and
last checks the launch cost tooling (``cost``: the served decode step, a
prefill and the train step counted on meta tensors beside their measured
times and hand-derived bounds, peak memory predicted on meta against the
card's allocator, and the ``qwen1.5-0.5b × train_4k`` dry-run cell, run in
a process of its own from the start). Each
phase prints one JSON line; any failure exits
non-zero before the last line. The last lines are the per-kernel summary (each
kernel's ``launches`` summed over the paths that run it, with each path's
count, taken from 0 just before it, under ``launches_by_path``), the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
Exits non-zero without a result when CUDA is unavailable or when the
repository's ``src/`` is missing. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100's data-sheet rates (HBM bytes/s, bf16 and fp32 FLOP/s), one set for the port
from repro_torch.launch.mesh import HW  # noqa: E402
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
# K4's checked shapes: (B, T, nq, nkv, hd, dtype, slot lengths (lo, hi) or
# explicit positions). longgen and docqa are phi-3's served decode (32 and
# 16 slots of the 4096-slot cache, the mixes' prompt lengths); granite's
# served decode (G = 2); gemma3's global-width ring (hd 256, T the window,
# positions before, at and past its wrap); an fp32 copy; llama3-405b's G of
# 16; the smoke presets' hd 16 with one split; qwen1.5-0.5b as the serve and
# serve_paged phases decode it (4 slots of a 512-slot cache, 16 KV heads of
# 64, G = 1, lengths from the shortest prompt's first decode step to the
# longest's last)
DECODE_CASES = {
    "longgen": (32, 4096, 32, 32, 96, "bfloat16", (1536, 3584)),
    "docqa": (16, 4096, 32, 32, 96, "bfloat16", (1536, 3584)),
    "granite": (4, 4096, 16, 8, 64, "bfloat16", (2048, 4000)),
    "gemma3_ring": (4, 1024, 8, 4, 256, "bfloat16", (100, 1023, 1300, 5000)),
    "longgen_fp32": (32, 4096, 32, 32, 96, "float32", (1536, 3584)),
    "gemma3_ring_fp32": (4, 1024, 8, 4, 256, "float32", (100, 1023, 1300, 5000)),
    "llama3_g16": (2, 1024, 128, 8, 128, "bfloat16", (1, 1024)),
    "smoke_hd16": (4, 64, 4, 2, 16, "bfloat16", (3, 40, 63, 100)),
    "smoke_hd16_fp32": (4, 64, 6, 2, 16, "float32", (1, 64)),
    "qwen_serve": (4, 512, 16, 16, 64, "bfloat16", (FLASH_SERVE_S[0] + 1, FLASH_SERVE_S[-1] + 15)),
}
DECODE_TIMED = ("longgen", "docqa")
# the paged serving phase: 12 requests, prompts cycling over the served
# lengths, 16 new tokens each, all offered at once; pages of 16 positions
PAGED_REQUESTS = 12
PAGE_SIZE = 16
# dt_unpack_into's timed shapes: (nseg, seg_bytes, stride_bytes) of a
# decode-step append (one position of 24 layers into a page block) and a
# full-page chunk of a gather (16 positions of 24 layers into a B=1 cache)
UNPACK_INTO_SHAPES = {
    "decode_step": (KV_LEAF[0], KV_LEAF[3] * 2, PAGE_SIZE * KV_LEAF[3] * 2),
    "page_chunk": (KV_LEAF[0], PAGE_SIZE * KV_LEAF[3] * 2, KV_LEAF[2] * KV_LEAF[3] * 2),
}
# device ms of the first designs at the main-path shapes (flash bf16 at
# S = 384, K3 at the served shape, the pack at the enqueue span), before the
# tensor-core, per-chunk and pack redesigns, as earlier versions of this
# script measured them on an NVIDIA H100 80GB HBM3 at 700.00 W with the
# Timer's earlier flush (zero_(), which leaves the L2 dirty); printed on a
# line of their own as recorded values, not measured in this run
FIRST_DESIGN_MS = {"flash_attention": 0.05554, "wkv6": 0.3134, "dt_pack": 0.01538}
# the pack's timed shapes: (buffer, nseg, seg_len, stride, start). "kv" is a
# full-width qwen1.5-0.5b K leaf (24, 4, 512, 16*64) bf16 flattened, "column"
# 2^24 fp32. served_span is the enqueue phase's layout (slot 1, position 128);
# page_span one 32 KiB page of it per layer; token_view one position per
# layer; vector_column an MPI vector type's 16-byte column; misaligned_span
# served_span one element later (2-byte alignment)
_KV_START = (1 * KV_LEAF[2] + 128) * KV_LEAF[3]
PACK_SHAPES = {
    "served_span": ("kv", KV_LEAF[0], KV_SPAN * KV_LEAF[3], KV_LEAF[1] * KV_LEAF[2] * KV_LEAF[3], _KV_START),
    "page_span": ("kv", KV_LEAF[0], 16 * KV_LEAF[3], KV_LEAF[1] * KV_LEAF[2] * KV_LEAF[3], _KV_START),
    "token_view": ("kv", KV_LEAF[0], KV_LEAF[3], KV_LEAF[1] * KV_LEAF[2] * KV_LEAF[3], _KV_START),
    "vector_column": ("column", 1 << 20, 4, 16, 0),
    "misaligned_span": ("kv", KV_LEAF[0], KV_SPAN * KV_LEAF[3], KV_LEAF[1] * KV_LEAF[2] * KV_LEAF[3], _KV_START + 1),
}
# device ms of the first-design pack at those shapes under the read flush: the
# mean of two runs of `chip_smoke.py --timer-ab` on the checkout before the
# pack redesign, in one call on an NVIDIA H100 80GB HBM3 at 700.00 W;
# recorded values, not measured in this run
FIRST_DESIGN_PACK_MS = {"served_span": 0.011744, "page_span": 0.006000, "token_view": 0.005768,
                        "vector_column": 0.028856, "misaligned_span": 0.020392}
# the dist phase: windowed ring sends of the served K span, the pipeline
# activation of one rank, and the device spin before each timed collective
# or send (~0.2 s at the H100's clocks: a few times the longest host time
# seen to enqueue one, 61 ms)
DIST_SENDS = 16
DIST_ACT = (4, 512, 1024)
DIST_SPIN_CYCLES = 400_000_000
# the train phase: full-width qwen1.5-0.5b for 8 steps with a checkpoint at
# step 4 (and the final one); the windowed-vs-fused steps; the elastic walk's
# steps and its depth cut (the widths stay the published ones)
TRAIN_STEPS = 8
TRAIN_CKPT_EVERY = 4
TRAIN_WINDOWED_STEPS = 2
TRAIN_ELASTIC_STEPS = 12
TRAIN_ELASTIC_LAYERS = 4
# the pipeline phase: (a) the windowed 1F1B forward, 4 stages of 6 layers,
# 8 microbatches of 1 x 384 tokens, window depth 2; (b) pipeline_loss_fn on
# a (4, 2) ("pipe", "dp") mesh, 4 x 128 tokens in 4 microbatches, fp32;
# (c) the sharded step on (2, 2, 2) ("pod", "data", "model"), 8 x 128 tokens
PIPE_STAGES = 4
PIPE_MICRO = (8, 1, 384)
PIPE_DEPTH = 2
PIPE_LOSS_BATCH = (4, 128)
SHARDED_BATCH = (8, 128)
SHARDED_LR = 1e-3
# (c) in bf16 the tensor-parallel step adds its partial sums in another
# order than one rank, which flips the first AdamW step's sign on
# near-zero gradients: the share of params beyond one bf16 step of the
# single-rank step's is bounded from the card's readings, and the sharded
# step's params may lie no farther from the fp32 step's than this many
# times the single-rank bf16 step's (PERF.md section 6, PR 24)
SHARDED_BF16_SHARE = 0.025
SHARDED_BF16_CONTROL = 1.5
# the zoo phase: (b) gemma3-4b's prompts (multiples of 128; 1152 > its
# 1024-token window, so its local rings wrap) and its engine's max_len;
# (c) phi-3-vision's text tokens after its 576 image rows and its decode
# steps; (d) deepseek-v3 cut to its 3 dense layers and 1 MoE layer, 2
# prompts of 128 tokens, 8 decode steps
ZOO_GEMMA_S = (1152, 640, 1152, 640)
ZOO_GEMMA_MAX_LEN = 1280
ZOO_PHI_TEXT = 192
ZOO_PHI_STEPS = 8
ZOO_DEEPSEEK_LAYERS = 4
ZOO_DEEPSEEK_BATCH = 2
ZOO_DEEPSEEK_S = 128
ZOO_DEEPSEEK_STEPS = 8
# flash at the zoo's new head dims, at their served shapes (B, S, nq, nkv):
# phi-3-vision's prefill (hd 96) and gemma3's global layers at its longest
# prompt (hd 256)
ZOO_FLASH = {96: (1, 768, 32, 32), 256: (1, 1152, 8, 4)}
# the zoo2 phase: (a) jamba-v0.1-52b cut to one period (8 of 32 layers),
# serve's traffic into ServeEngine(4, 512); (b) whisper-tiny at full depth:
# 4 requests of 1500 stub frames and these decoder prompts, 16 greedy steps
# each through the api; (c) Trainer steps on whisper-tiny and on rwkv6-7b
# cut to 4 of 32 layers, with the batches (B x S) they train on
ZOO2_JAMBA_LAYERS = 8
ZOO2_WHISPER_S = (128, 256, 384, 128)
ZOO2_NEW = 16
ZOO2_TRAIN_STEPS = 4
ZOO2_RWKV_LAYERS = 4
ZOO2_WHISPER_BATCH = (4, 256)
ZOO2_RWKV_BATCH = (8, 128)
# flash at the zoo2 paths' shapes (hd, (B, S, nq, nkv)), bf16: jamba's
# attention layer and whisper's decoder self-attention at the longest prompt
ZOO2_FLASH = {"jamba": (128, (1, 384, 32, 8)), "whisper": (64, (1, 384, 6, 6))}
# the sharded_zoo phase: the tensor-parallel sharded step on a (2, 2, 2)
# ("pod", "data", "model") mesh of thread-ranks against the single-rank step,
# each config's published training settings; each batch (B x S) is the
# smallest that splits into grad_accum microbatches of one row per dp group
# (dp = 4). Moments in bf16 for a bf16 model; granite keeps AdamW's fp32
# master (the reference's default), which ZeRO-1 on the layer-stacking dim
# makes fit (24 layers over dp 4: each dp rank holds 6 layers' moments and
# master). Depth cuts for memory (the widths stay the published ones):
# granite's fp32 copy (run hint-free and under each layout hint), phi-3-vision
# and rwkv6-7b; the trained granite serves one prefill of SZ_PREFILL_S tokens
# with flash; whisper-tiny (whole) runs hint-free and under each layout
# hint. The whole-layer route's host ms of each part's sharded step (every
# layer's weights gathered whole, one rank per dp group computing), its last
# reading before the tensor-parallel step replaced it, H100 80GB HBM3 at
# 700 W, stand beside this run's; for whisper also one rank's step then
SZ_MESH = ((2, 2, 2), ("pod", "data", "model"))
SZ_LR = 1e-3
SZ_GRANITE_BATCH = (16, 128)
SZ_GRANITE_FP32_LAYERS = 8
SZ_PREFILL_S = 384
SZ_PHI_LAYERS = 8
SZ_PHI_BATCH = (32, 128)
SZ_RWKV_LAYERS = 2
SZ_RWKV_BATCH = (32, 128)
SZ_WHISPER_BATCH = (8, 128)
SZ_WHOLE_LAYER_MS = {"granite": 21020, "phi3": 6613, "rwkv6": 12341, "whisper": 2737}
SZ_WHISPER_SINGLE_MS_THEN = 357
# the peak PR 23 measured for granite's bf16 sharded step with its moments
# held 4 times over dp and no master, and the reckoning for this layout:
# 12 B a parameter of moments saved, 4 B a parameter of fp32 master added
SZ_GRANITE_PEAK_GB_PR23 = 72.26
# the sharded_serve phase: the sharded prefill and SS_STEPS greedy sharded
# decode steps on a (2, 4) ("data", "model") mesh of thread-ranks against the
# single-rank steps; SS_BATCH prompts of SS_PROMPT tokens into a cache of
# SS_MAX_LEN slots (T / model = 128 slots a rank: the first decode step's
# rows cross from rank 2's span into rank 3's); full width and depth
SS_MESH = ((2, 4), ("data", "model"))
SS_MESH_SIZE = 8
SS_BATCH = 8
SS_PROMPT = 384
SS_MAX_LEN = 512
SS_STEPS = 16
# the largest k-th/(k+1)-th router probability gap at which an fp32 expert
# choice may differ from the single-rank run's: the row-parallel sums'
# order moves the router's inputs by rounding (about 1e-6 of scale), so a
# choice flips only at such a tie; beyond it a flip is a fault
SS_TIE_GAP = 1e-6
# the fp32 cache's bound, of each leaf's scale: qwen's at 1e-5; granite's
# summation-order noise (the expert-parallel combine and reduce, 24 layers
# deep) reached its cache at 1.44e-5 and its logits at 1.5e-5 on an H100,
# five times qwen's, so its cache is held at 5e-5
SS_CACHE_TOL = {"qwen": 1e-5, "granite": 5e-5}
# a bf16 token may differ from the single-rank run's only at a top-2 margin
# within this many bf16 steps of the top logit: the widest margin at which
# any forced step flipped over weight seeds 0-3, with the single-rank decode
# in the einsum's arithmetic (bf16 logits and probabilities) and in the
# decode kernel's (fp32) alike, on an H100: qwen 2 (43 flips), granite 9 and
# 10 (160 flips). Flips at 2 steps come before any decode step too (the
# prefill's logits, both models); the fp32 copies flip nowhere
SS_FLIP_STEPS = {"qwen": 2, "granite": 10}
# the examples phase: each port example run as its users run it, in a
# process of its own on the card with the defaults, each bounded by its own
# timeout (seconds); train_lm runs EX_TRAIN_STEPS[0] steps, crossing its
# periodic save at step 50, then EX_TRAIN_STEPS[1] more resumed from the last
# save in the same --ckpt-dir. A save holds the bf16 params and the fp32
# moments and master: 14 bytes a parameter, three saves kept
EX_TIMEOUT_S = {"quickstart": 60, "serve_lm": 90, "train_lm": 180, "train_lm_resume": 120,
                "pipeline_train": 120, "streams_overlap": 90}
EX_TRAIN_STEPS = (60, 10)
EX_SAVE_BYTES_A_PARAM = 14
EX_SAVES_KEPT = 3
# the cost phase: the served decode step (slots, max_len) and prefill length
# it counts on meta tensors beside serve's measured times; the tolerances of
# its checks; the dry-run cell it runs, in a process of its own started
# before the first phase (256 thread-ranks on meta tensors take minutes of
# host time) and its longest wait for that process in the phase
COST_DECODE = (4, 512)
COST_PREFILL_S = 384
COST_DECODE_TOL = 0.25
COST_TRAIN_MAX = 1.5
COST_MEM_TOL = 0.20
COST_DRYRUN = ("qwen1.5-0.5b", "train_4k")
COST_DRYRUN_WAIT_S = 45


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
    launch (the serving path finds these operands cold). The flush reads a
    256 MB buffer, so the L2 is left holding clean lines: a write flush
    (``ZeroFlushTimer``, the earlier timer) leaves up to 50 MB of dirty lines
    whose write-backs fall inside the next timed launch. A short device
    spin after the flush keeps the card busy while the host enqueues the
    call, so the events time the device's work and not the host's."""

    SPIN_CYCLES = 200_000  # ~0.1 ms at the H100's clocks, longer than a wrapper's host time

    def __init__(self, torch, spin: bool = True):
        self.torch = torch
        self.spin_cycles = self.SPIN_CYCLES if spin else 0
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def flush_l2(self) -> None:
        self.flush.view(self.torch.int64).sum()

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(TIMED_REPS):
            self.flush_l2()
            if self.spin_cycles:
                torch.cuda._sleep(self.spin_cycles)
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
    return a.shape == b.shape and torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                                              b.contiguous().reshape(-1).view(torch.uint8))


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def pack_plan_of(dp, buf, out, nseg, seg, stride, start) -> dict:
    """The pack's plan for these tensors."""
    item = buf.element_size()
    return dp.pack_plan(nseg, seg * item, stride * item, buf.data_ptr() + start * item, out.data_ptr())._asdict()


def pack_buffers(torch, gen) -> dict:
    """The buffers of PACK_SHAPES, random from ``gen``."""
    return dict(kv=torch.randn(math.prod(KV_LEAF), generator=gen, device="cuda").to(torch.bfloat16),
                column=torch.randn(1 << 24, generator=gen, device="cuda"))


def pack_shape_rows(torch, timer, bufs, check_exact: bool) -> dict:
    """The pack at each of PACK_SHAPES: its time, a dense ``copy_`` of the
    same byte count and the strided view's ``.contiguous()`` timed the same
    way, and the bytes bound (each packed byte read once and written once)."""
    from repro_torch.kernels import dt_pack as dp

    rows = {}
    for name, (which, nseg, seg, stride, start) in PACK_SHAPES.items():
        buf = bufs[which]
        item = buf.element_size()
        out = dp.dt_pack(buf, nseg=nseg, seg_len=seg, stride=stride, start=start)
        torch.cuda.synchronize()
        if check_exact:
            check(bytes_equal(torch, out, dp.dt_pack_plain(buf, nseg, seg, stride, start)),
                  f"dt_pack byte-exact at {name}")
        a, b = torch.empty_like(out), torch.empty_like(out)
        nbytes = 2 * nseg * seg * item
        ms = timer(lambda: dp.dt_pack(buf, nseg=nseg, seg_len=seg, stride=stride, start=start))
        bound_ms = nbytes / HW.HBM_BW * 1e3
        rows[name] = dict(
            nseg=nseg, seg_len=seg, stride=stride, start=start, dtype=str(buf.dtype).split(".")[-1],
            ms=ms, bytes=nbytes, bound_ms=bound_ms, bound_by="bytes", share_of_bound=bound_ms / ms,
            library_ms=timer(lambda: buf.as_strided((nseg, seg), (stride, 1), start).contiguous()),
            dense_copy_ms=timer(lambda: b.copy_(a)),
        )
        rows[name]["ms_over_dense_copy"] = ms / rows[name]["dense_copy_ms"]
        del out, a, b
    return rows


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
        (1, 256, 16, 16, 64, torch.bfloat16, False, 2e-2),  # tensor cores, non-causal
        (1, 512, 16, 16, 64, torch.bfloat16, True, 2e-2),  # the engine's max_len
        (1, 256, 16, 4, 64, torch.bfloat16, True, 2e-2),  # GQA 16:4 at hd 64
        (1, 256, 8, 8, 128, torch.bfloat16, False, 2e-2),  # hd 128, every K/V tile
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
        t_bytes, t_ops = nbytes / HW.HBM_BW * 1e3, flops / HW.PEAK_FLOPS_BF16 * 1e3
        flash_times.append(dict(S=S, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ms_over_library=ms / lib_ms,
                                bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                                bound_by="bytes" if t_bytes >= t_ops else "operations"))
    # the zoo's head dims at their served shapes, bf16 (served) and fp32
    zoo_rows = []
    for hd, (B, S, nq, nkv) in ZOO_FLASH.items():
        for dtype in (torch.bfloat16, torch.float32):
            bf16 = dtype == torch.bfloat16
            tol = 2e-2 if bf16 else (2e-5 if nq == nkv else 3e-5)
            q, k, v = qkv(B, S, nq, nkv, hd, dtype)
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v)
            row = dict(B=B, S=S, nq=nq, nkv=nkv, hd=hd, dtype=str(dtype).split(".")[-1], causal=True, tol=tol,
                       max_abs_err=max_err(out, ref), ok=within(out, ref, tol))
            check(row["ok"], f"flash_attention vs plain within {tol}: {row}")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, k, v read once, out written once
            flops = 4 * B * nq * hd * S * (S + 1) // 2  # QK^T and PV over the causal triangle
            t_bytes = nbytes / HW.HBM_BW * 1e3
            t_ops = flops / (HW.PEAK_FLOPS_BF16 if bf16 else HW.PEAK_FLOPS_FP32) * 1e3
            row.update(ms=timer(lambda: fa.flash_attention(q, k, v)), plain_ms=timer(lambda: fa.flash_attention_plain(q, k, v)),
                       library_ms=timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                               enable_gqa=nq != nkv)),
                       bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            zoo_rows.append(row)
            del q, k, v, qt, kt, vt, out, ref
    for part, (hd, (B, S, nq, nkv)) in ZOO2_FLASH.items():
        q, k, v = qkv(B, S, nq, nkv, hd, torch.bfloat16)
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v)
        row = dict(part=part, B=B, S=S, nq=nq, nkv=nkv, hd=hd, dtype="bfloat16", causal=True, tol=2e-2,
                   max_abs_err=max_err(out, ref), ok=within(out, ref, 2e-2))
        check(row["ok"], f"flash_attention vs plain within 2e-2: {row}")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q, k, v read once, out written once
        flops = 4 * B * nq * hd * S * (S + 1) // 2  # QK^T and PV over the causal triangle
        t_bytes, t_ops = nbytes / HW.HBM_BW * 1e3, flops / HW.PEAK_FLOPS_BF16 * 1e3
        row.update(ms=timer(lambda: fa.flash_attention(q, k, v)), plain_ms=timer(lambda: fa.flash_attention_plain(q, k, v)),
                   library_ms=timer(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                           enable_gqa=nq != nkv)),
                   bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        zoo_rows.append(row)
        del q, k, v, qt, kt, vt, out, ref
    emit("kernels", kernel="flash_attention", cases=flash_rows, timings=flash_times, zoo_head_dims=zoo_rows)

    # dt_pack / dt_unpack: byte-exact over the reference sweep shapes, the
    # enqueue phase's KV span (start = slot 1, position 128) and edge layouts
    sweep = [(64, 8, 16, torch.float32, 0), (128, 16, 64, torch.float32, 0), (256, 4, 8, torch.bfloat16, 0),
             (32, 32, 32, torch.float32, 0), (61, 8, 16, torch.float32, 0), (300, 16, 4096, torch.float32, 0),
             (61, 8, 16, torch.float32, 3), (256, 4, 8, torch.bfloat16, 1)]
    served = PACK_SHAPES["served_span"]
    sweep.append((*served[1:4], torch.bfloat16, served[4]))
    step = 8192  # bf16 elements: 16 KiB, several of the plan's span units
    sweep += [
        (1, 150000, 150000, torch.float32, 0),  # one segment
        (1, 5 * step, 5 * step, torch.bfloat16, 0),  # one segment of several block steps
        (3, 2 * step + 24, 3 * step, torch.bfloat16, 0),  # segments that are not whole steps
        (5, 8001, 10000, torch.bfloat16, 0),  # 16k + 2 bytes per segment
        (4, 4 * step, 8 * step, torch.bfloat16, 1),  # src 2 bytes off 16
        (4, 2 * step, 4 * step, torch.float32, 1),  # src 4 bytes off 16
        (4, 2 * step, 4 * step, torch.float32, 2),  # src 8 bytes off 16
        (9, 4099, 5003, torch.uint8, 1),  # a uint8 buffer: 1-byte accesses
        (4, 65536, 1 << 29, torch.uint8, 16),  # byte offsets past 2 GiB
        (4, 16385, 1 << 29, torch.uint8, 0),  # vector indices past 2^31: 64-bit index
    ]
    pack_rows = []
    for nseg, seg, stride, dtype, start in sweep:
        n = start + nseg * stride
        if dtype == torch.uint8:
            buf = torch.randint(0, 256, (n,), generator=gen, device="cuda", dtype=torch.uint8)
        else:
            buf = torch.randn(n, generator=gen, device="cuda").to(dtype)
        out = dp.dt_pack(buf, nseg=nseg, seg_len=seg, stride=stride, start=start)
        back = dp.dt_unpack(out, nseg=nseg, seg_len=seg, stride=stride, start=start, out_len=n)
        torch.cuda.synchronize()
        ok_pack = bytes_equal(torch, out, dp.dt_pack_plain(buf, nseg, seg, stride, start))
        ok_unpack = bytes_equal(torch, back, dp.dt_unpack_plain(out, nseg, seg, stride, start, n))
        row = dict(nseg=nseg, seg_len=seg, stride=stride, start=start, dtype=str(dtype).split(".")[-1],
                   plan=pack_plan_of(dp, buf, out, nseg, seg, stride, start),
                   pack_byte_exact=ok_pack, unpack_byte_exact=ok_unpack)
        pack_rows.append(row)
        check(ok_pack and ok_unpack, f"dt_pack/dt_unpack byte-exact: {row}")
        del buf, out, back
    torch.cuda.empty_cache()

    bufs = pack_buffers(torch, gen)
    shapes = pack_shape_rows(torch, timer, bufs, check_exact=True)
    for name, (which, nseg, seg, stride, start) in PACK_SHAPES.items():
        out = torch.empty(nseg * seg, dtype=bufs[which].dtype, device="cuda")
        shapes[name]["plan"] = pack_plan_of(dp, bufs[which], out, nseg, seg, stride, start)
        del out
    kv, nseg, seg, stride, start = bufs["kv"], *served[1:]
    out_len = kv.numel()
    packed = dp.dt_pack(kv, nseg=nseg, seg_len=seg, stride=stride, start=start)
    zeros = torch.zeros(out_len, dtype=torch.bfloat16, device="cuda")
    pack_t = dict(shapes["served_span"], plain_ms=timer(lambda: dp.dt_pack_plain(kv, nseg, seg, stride, start)))
    unpack_bytes = nseg * seg * 2 + out_len * 2
    unpack_t = dict(
        ms=timer(lambda: dp.dt_unpack(packed, nseg=nseg, seg_len=seg, stride=stride, start=start, out_len=out_len)),
        plain_ms=timer(lambda: dp.dt_unpack_plain(packed, nseg, seg, stride, start, out_len)),
        library_ms=timer(lambda: torch.as_strided_scatter(zeros, packed.view(nseg, seg), (nseg, seg), (stride, 1), start)),
        bytes=unpack_bytes, bound_ms=unpack_bytes / HW.HBM_BW * 1e3, bound_by="bytes",
    )
    # the timer's floor: an empty kernel between the two events
    floor_ms = timer(lambda: torch.cuda._sleep(1))
    emit("kernels", kernel="dt_pack", cases=pack_rows, shape=dict(nseg=nseg, seg_len=seg, stride=stride, start=start,
         out_len=out_len, dtype="bfloat16"), shapes=shapes, pack=pack_t, unpack=unpack_t, timer_floor_ms=floor_ms)
    del bufs, kv, packed, zeros
    torch.cuda.empty_cache()
    wkv = wkv6_kernel_rows(torch, timer, gen)
    decode = decode_attention_rows(torch, timer, gen)
    return dict(flash_times=flash_times, flash_err=serve_err, flash_zoo=zoo_rows, pack=pack_t, unpack=unpack_t,
                wkv=wkv, decode=decode)


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
    t = dict(bytes=nbytes / HW.HBM_BW * 1e3, fp32=flops / HW.PEAK_FLOPS_FP32 * 1e3, sfu=sfu / H100_SFU_PER_S * 1e3)
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

    # more (batch, head) pairs than SMs, and one chunk entered from state0
    for B, S, H in ((4, 448, 64), (1, 64, 64)):
        args = inputs(B, S, H)
        y, st = wk.wkv6(*args, chunk=64)
        torch.cuda.synchronize()
        yp, sp = wk.wkv6_plain(*args, chunk=64)
        row = dict(B=B, S=S, H=H, chunk=64, tol=5e-4, max_abs_err=max(max_err(y, yp), max_err(st, sp)),
                   ok=within(y, yp, 5e-4) and within(st, sp, 5e-4))
        rows.append(row)
        check(row["ok"], f"wkv6 vs plain within 5e-4: {row}")

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


def decode_attention_rows(torch, timer, gen) -> dict:
    """K4 against an fp32 reference (its plain version on fp32 copies of the
    inputs) at the shapes of DECODE_CASES, with every cache row at or past a
    slot's length set to NaN (a row read that should not be would show),
    and the bf16 plain version's own gap to that reference beside it. Timed
    at the longgen and docqa shapes beside the bytes bound, the plain
    version and SDPA."""
    from repro_torch.kernels import decode_attention as da

    F = torch.nn.functional
    rows, timed = [], {}
    for name, (B, T, nq, nkv, hd, dtype, pos_spec) in DECODE_CASES.items():
        dt = getattr(torch, dtype)
        if len(pos_spec) == 2:  # slot lengths drawn from [lo, hi]
            lo, hi = pos_spec
            pos = torch.randint(lo - 1, hi, (B,), generator=gen, device="cuda", dtype=torch.int32)
        else:  # explicit positions (ring caches: some past T)
            pos = torch.tensor(pos_spec, device="cuda", dtype=torch.int64)
        q = (torch.randn(B, nq, hd, generator=gen, device="cuda") * 2).to(dt)
        if name.startswith("granite"):  # K and V as views of one (B, T, 2 nkv, hd) buffer
            kv = torch.randn(B, T, 2 * nkv, hd, generator=gen, device="cuda").to(dt)
            k, v = kv[:, :, :nkv], kv[:, :, nkv:]
        else:
            k = torch.randn(B, T, nkv, hd, generator=gen, device="cuda").to(dt)
            v = torch.randn(B, T, nkv, hd, generator=gen, device="cuda").to(dt)
        ref = da.decode_attention_plain(q.float(), k.float(), v.float(), pos)
        plain = da.decode_attention_plain(q, k, v, pos)
        n_b = torch.clamp(pos + 1, max=T)
        past = torch.arange(T, device="cuda")[None, :] >= n_b[:, None]
        k[past], v[past] = float("nan"), float("nan")
        launches = da.decode_attention.launches
        out = da.decode_attention(q, k, v, pos)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        # bf16: K4 rounds once, at its fp32 output, so it lies within half a bf16
        # step of the reference (2^-8 of a value, at most 2^-8 of the largest);
        # the plain version rounds the logits and the probabilities to bf16
        # besides. fp32: only the order of the sums differs (chunks merged last)
        tol = 2 ** -8 if dt == torch.bfloat16 else 2e-5
        chunk, splits = da.split_plan(B, nkv, T, da._sm_count(q.device))
        row = dict(case=name, B=B, T=T, nq=nq, nkv=nkv, hd=hd, dtype=dtype, pos_dtype=str(pos.dtype).split(".")[-1],
                   lengths=[int(n_b.min()), int(n_b.max())], chunk=chunk, splits=splits,
                   launched=da.decode_attention.launches - launches, finite=bool(torch.isfinite(out).all()),
                   max_abs_err=max_err(out, ref), plain_max_abs_err=max_err(plain, ref), out_scale=scale,
                   tol_rel=tol)
        row["ok"] = row["finite"] and row["launched"] == 1 and row["max_abs_err"] <= tol * scale
        rows.append(row)
        check(row["ok"], f"decode_attention vs the fp32 reference within {tol} of the output's scale: {row}")
        if name in DECODE_TIMED:
            k[past], v[past] = 0.0, 0.0
            nbytes = int(n_b.sum()) * nkv * hd * 2 * k.element_size() + 2 * q.numel() * q.element_size()
            q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            mask = ~past[:, None, None, :]
            timed[name] = dict(row, ms=timer(lambda: da.decode_attention(q, k, v, pos)),
                               plain_ms=timer(lambda: da.decode_attention_plain(q, k, v, pos)),
                               library_ms=timer(lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask)),
                               library="F.scaled_dot_product_attention, boolean mask", bytes=nbytes,
                               bound_ms=nbytes / HW.HBM_BW * 1e3, bound_by="bytes")
            timed[name]["roofline_share"] = timed[name]["bound_ms"] / timed[name]["ms"]
        del q, k, v, ref, plain, out
        torch.cuda.empty_cache()
    emit("kernels", kernel="decode_attention", cases=rows, timed=timed)
    return dict(rows=rows, timed=timed)


def phase_serve(torch):
    """Full-width qwen1.5-0.5b behind ServeEngine, flash on every prefill."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.kernels import decode_attention as da
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
    fa.flash_attention.launches = da.decode_attention.launches = 0  # count the main path only
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
    k4_launches = da.decode_attention.launches
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
    check(decode_steps > 0 and k4_launches == cfg.n_layers * decode_steps,
          f"decode_attention launches {k4_launches} == {cfg.n_layers} layers x {decode_steps} decode steps")
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
    decode_bound_ms = (param_bytes + kv_bytes) / HW.HBM_BW * 1e3
    del cache

    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params,
         init_s=init_s, requests=len(reqs), prompt_lens=lens, max_new_tokens=16, max_batch=4, max_len=512,
         tokens=toks, wall_s=wall, tokens_per_s=toks / wall,
         latency_p50_ms=float(np.percentile(lats, 50) * 1e3), latency_p95_ms=float(np.percentile(lats, 95) * 1e3),
         completion_order=order, flash_launches=flash_launches, prefills=n_prefills, decode_steps=decode_steps,
         decode_attention_launches=k4_launches,
         prefill_384_host_ms=prefill_ms, decode_step_host_ms=decode_ms, decode_step_bound_ms=decode_bound_ms,
         peak_mem_gb=peak_gb, prefill_logits_rel_err_bf16=rel_bf16, tol_bf16=tol_bf16,
         prefill_logits_rel_err_fp32=rel_fp32, tol_fp32=tol_fp32, device=torch.cuda.get_device_name(0))
    return eng, dict(flash_launches=flash_launches, decode_attention_launches=k4_launches,
                     prefill_384_host_ms=prefill_ms, decode_step_host_ms=decode_ms,
                     decode_step_bound_ms=decode_bound_ms)


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
    decode_bound_ms = (param_bytes + 2 * state_bytes) / HW.HBM_BW * 1e3
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


def serve_paged_runs(torch, cfg, model, prompts, max_new: int, page_size: int, max_len: int = 512,
                     max_batch: int = 4, sync_timeout: float = 2.0) -> dict:
    """The same requests through (a) the contiguous ``ServeEngine``, (b)
    ``PagedServeEngine`` behind ``AdmissionFrontEnd`` and (c)
    ``PagedServeEngine`` under ``run_until_done_elastic(n_threads=3)`` with
    rank 1 killed at virtual time 0 (the survivors see the death when
    their ``sync_timeout`` runs out, so it bounds one step of rank 0's
    work: its first admission, up to a dozen prefills and their spills, is
    the longest, a few tenths of a second). Every run gets a
    ``ProgressEngine``, ``max_batch``, ``max_len``; both paged runs
    ``page_size``, the default pool and ``spill_parked=True``. Returns each
    run's tokens, latencies (s, from the moment all requests were offered),
    wall time and stats, its prefills and flash launches, and the K1
    launches and page moves of (b) and (c)."""
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.ft.faultinject import FaultEvent, FaultInjector, FaultPlan, VirtualClock
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dt_pack as dp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.admission import AdmissionFrontEnd, make_offer
    from repro_torch.serving.engine import PagedServeEngine, ServeEngine

    sync = torch.cuda.synchronize
    paged_kw = dict(page_size=page_size, spill_parked=True)
    out = {}

    def stamped(reqs, t0):
        done_at = {}
        for r in reqs:
            r.grequest.add_done_callback(lambda _g, rid=r.rid: done_at.setdefault(rid, time.perf_counter()))
        return lambda: [done_at[r.rid] - t0 for r in reqs]

    def paged_engine():
        """A paged engine whose prefills are counted, with the flash count
        set to 0: each prefill must launch flash once per layer."""
        eng = PagedServeEngine(cfg, model, max_batch=max_batch, max_len=max_len, progress_engine=pe, **paged_kw)
        inner, inner_decode, count, lock = eng._prefill, eng._decode, [0, 0], threading.Lock()

        def prefill(params, batch):
            with lock:
                count[0] += 1
            return inner(params, batch)

        def decode(*args):
            with lock:
                count[1] += 1
            return inner_decode(*args)

        eng._prefill, eng._decode = prefill, decode
        fa.flash_attention.launches = da.decode_attention.launches = 0
        return eng, count

    # (a) the oracle: contiguous engine, one driver
    pe = ProgressEngine()
    eng = ServeEngine(cfg, model, max_batch=max_batch, max_len=max_len, progress_engine=pe)
    sync()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    lats = stamped(reqs, t0)
    eng.run_until_done()
    sync()
    out["contiguous"] = dict(tokens=[list(r.out_tokens) for r in reqs], wall_s=time.perf_counter() - t0,
                             latencies_s=lats())
    pe.stop_all()
    del eng

    dp.dt_pack.launches = dp.dt_unpack_into.launches = 0  # count the paged runs only
    moves, leaves = 0, None

    # (b) paged, behind the admission front end (all offers at once)
    pe = ProgressEngine()
    eng, prefills = paged_engine()
    sync()
    t0 = time.perf_counter()
    fe = AdmissionFrontEnd(eng, clock=time.perf_counter)
    cs = fe.serve([make_offer(p, max_new_tokens=max_new) for p in prompts], sync_timeout=sync_timeout)
    sync()
    wall = time.perf_counter() - t0
    cs = sorted(cs, key=lambda c: c.rid)
    check(len(cs) == len(prompts) and not fe.rejected, f"front end completed {len(cs)} of {len(prompts)}")
    pm = eng.kv.page_moves()
    moves += pm["append_chunks"] + pm["gather_chunks"]
    leaves = eng.kv.leaf_count
    out["admission"] = dict(tokens=[list(c.req.out_tokens) for c in cs], wall_s=wall,
                            latencies_s=[c.t_done - t0 for c in cs], steps=fe.steps, page_moves=pm,
                            max_concurrent=eng.max_concurrent, kv=eng.stats()["kv"], prefills=prefills[0],
                            flash_launches=fa.flash_attention.launches, decode_steps=prefills[1],
                            decode_attention_launches=da.decode_attention.launches)
    pe.stop_all()
    del eng

    # (c) paged, elastic threadcomm loop, rank 1 killed at virtual time 0
    pe = ProgressEngine()
    eng, prefills = paged_engine()
    sync()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    lats = stamped(reqs, t0)
    with FaultInjector(FaultPlan([FaultEvent(0.0, "kill_rank", 1)]), clock=VirtualClock()) as inject:
        summary = eng.run_until_done_elastic(n_threads=3, fault_injector=inject, sync_timeout=sync_timeout)
    sync()
    wall = time.perf_counter() - t0
    check(all(r.done for r in reqs), "every request of the elastic run finished")
    pm = eng.kv.page_moves()
    moves += pm["append_chunks"] + pm["gather_chunks"]
    out["elastic"] = dict(tokens=[list(r.out_tokens) for r in reqs], wall_s=wall, latencies_s=lats(),
                          summary=summary, page_moves=pm, max_concurrent=eng.max_concurrent,
                          kv=eng.stats()["kv"], prefills=prefills[0], flash_launches=fa.flash_attention.launches,
                          decode_steps=prefills[1], decode_attention_launches=da.decode_attention.launches)
    pe.stop_all()
    del eng
    out["k1"] = dict(dt_pack=dp.dt_pack.launches, dt_unpack_into=dp.dt_unpack_into.launches,
                     page_moves=moves, leaves=leaves)
    return out


def check_serve_paged(runs: dict, n: int, max_new: int, n_layers: int) -> None:
    """The serve_paged phase's checks on :func:`serve_paged_runs`' result."""
    want = runs["contiguous"]["tokens"]
    check(len(want) == n and all(len(t) == max_new for t in want),
          f"every oracle request has {max_new} tokens: {[len(t) for t in want]}")
    for name in ("admission", "elastic"):
        got = runs[name]["tokens"]
        check(got == want, f"{name} run emits the contiguous engine's tokens, request for request")
        kv = runs[name]["kv"]
        check(kv["spilled_pages"] == kv["reloaded_pages"] > 0,
              f"{name}: spilled {kv['spilled_pages']} == reloaded {kv['reloaded_pages']} > 0")
        check(kv["pages_in_use"] == 0 and kv["cold_pages"] == 0, f"{name}: pool empty at the end: {kv}")
        run = runs[name]
        check(run["prefills"] >= n and run["flash_launches"] == n_layers * run["prefills"],
              f"{name}: flash launches {run['flash_launches']} == {n_layers} layers x {run['prefills']} prefills")
        check(run["decode_steps"] > 0 and run["decode_attention_launches"] == n_layers * run["decode_steps"],
              f"{name}: decode_attention launches {run['decode_attention_launches']} == {n_layers} layers x "
              f"{run['decode_steps']} decode steps")
    summary = runs["elastic"]["summary"]
    check(summary["dead_ranks"] == [1] and summary["epochs"] >= 2, f"elastic summary {summary}")
    k1 = runs["k1"]
    per_kernel = k1["leaves"] * k1["page_moves"]
    check(k1["page_moves"] > 0 and k1["dt_pack"] == per_kernel and k1["dt_unpack_into"] == per_kernel,
          f"K1 launches {k1} == leaves x page moves ({per_kernel}) each")


def unpack_into_rows(torch, timer, gen) -> dict:
    """``dt_unpack_into`` byte-exact against its plain version (every byte of
    ``out`` outside the segments must keep its value) at the main path's
    shapes and at edge layouts, and timed at UNPACK_INTO_SHAPES beside its
    bytes bound, its plain version and a strided-view ``copy_``."""
    from repro_torch.kernels import dt_pack as dp

    def exact(nseg, seg, stride, start, out_len):
        packed = torch.randint(0, 256, (nseg * seg,), generator=gen, device="cuda", dtype=torch.uint8)
        out = torch.randint(0, 256, (out_len,), generator=gen, device="cuda", dtype=torch.uint8)
        want = dp.dt_unpack_into_plain(packed, out.clone(), nseg, seg, stride, start)
        got = dp.dt_unpack_into(packed, out, nseg=nseg, seg_len=seg, stride=stride, start=start)
        torch.cuda.synchronize()
        ok = bytes_equal(torch, got, want)
        row = dict(nseg=nseg, seg_bytes=seg, stride_bytes=stride, start=start, out_bytes=out_len,
                   plan=pack_plan_of(dp, out, packed, nseg, seg, stride, start), byte_exact=ok)
        check(ok, f"dt_unpack_into byte-exact: {row}")
        return row

    cases = []
    for name, (nseg, seg, stride) in UNPACK_INTO_SHAPES.items():
        out_len = nseg * stride if name == "decode_step" else KV_LEAF[0] * KV_LEAF[2] * KV_LEAF[3] * 2
        cases.append(dict(exact(nseg, seg, stride, 5 * KV_LEAF[3] * 2, out_len), shape=name))
    for nseg, seg, stride, start, out_len in (
        (9, 4099, 5003, 1, 9 * 5003 + 7),  # odd bytes, 1-byte accesses, a tail after the last segment
        (24, 2048, 32768, 2, 24 * 32768 + 2),  # the decode-step layout 2 bytes off 16
        (1, 150000, 150000, 4, 150004),  # one segment
        (4, 16385, 1 << 29, 0, 3 * (1 << 29) + 16385),  # vector indices past 2^31: 64-bit index
    ):
        cases.append(exact(nseg, seg, stride, start, out_len))
        torch.cuda.empty_cache()

    timings = {}
    for name, (nseg, seg, stride) in UNPACK_INTO_SHAPES.items():
        out_len = nseg * stride if name == "decode_step" else KV_LEAF[0] * KV_LEAF[2] * KV_LEAF[3] * 2
        packed = torch.randint(0, 256, (nseg * seg,), generator=gen, device="cuda", dtype=torch.uint8)
        out = torch.zeros(out_len, dtype=torch.uint8, device="cuda")
        view = out.as_strided((nseg, seg), (stride, 1), 0)
        nbytes = 2 * nseg * seg
        bound_ms = nbytes / HW.HBM_BW * 1e3
        ms = timer(lambda: dp.dt_unpack_into(packed, out, nseg=nseg, seg_len=seg, stride=stride))
        timings[name] = dict(
            nseg=nseg, seg_bytes=seg, stride_bytes=stride, ms=ms, bytes=nbytes, bound_ms=bound_ms,
            bound_by="bytes", share_of_bound=bound_ms / ms,
            plain_ms=timer(lambda: dp.dt_unpack_into_plain(packed, out, nseg, seg, stride, 0)),
            library_ms=timer(lambda: view.copy_(packed.view(nseg, seg))),
        )
        del packed, out, view
    return dict(cases=cases, timings=timings)


def paged_step_host_ms(torch, cfg, model, rounds: int = 8) -> dict:
    """Host ms, between two syncs, of one batched decode step over 4 slots at
    position 400 alone, of the same step followed by the 4 page appends a
    paged step makes (each slot's new position, one K1 pack and one
    dt_unpack_into per leaf), and of the 4 appends alone; measured in turns
    (contiguous, paged, paged, contiguous) so that the host's drift falls on
    both alike. Medians, with the K1 launches of one paged step."""
    from repro_torch.kernels import dt_pack as dp
    from repro_torch.models import api
    from repro_torch.serving.paged_kv import PagedKVCache

    B, pos = 4, 400
    cache = api.init_cache(cfg, B, 512, "cuda")
    kv = PagedKVCache(cache, 512, page_size=PAGE_SIZE, num_pages=B * 512 // PAGE_SIZE)
    for i in range(B):
        kv.alloc(i)
        kv.append(i, cache, i, 0, pos + 1)  # positions [0, 401) stored; the step re-writes 400
    tok = torch.zeros(B, dtype=torch.long, device="cuda")
    at = torch.full((B,), pos, dtype=torch.long, device="cuda")

    def appends():
        for i in range(B):
            kv.append(i, cache, i, pos, 1)

    def contiguous_step():
        api.decode_step(cfg, model, cache, tok, at)

    def paged_step():
        contiguous_step()
        appends()

    times = {"contiguous": [], "paged": [], "appends": []}
    for _ in range(rounds):
        for name, fn in (("contiguous", contiguous_step), ("paged", paged_step), ("appends", appends),
                         ("appends", appends), ("paged", paged_step), ("contiguous", contiguous_step)):
            times[name].append(host_ms(torch, fn, reps=1))
    before = dp.dt_pack.launches + dp.dt_unpack_into.launches
    paged_step()
    launches = dp.dt_pack.launches + dp.dt_unpack_into.launches - before
    torch.cuda.synchronize()
    med = {name: statistics.median(v) for name, v in times.items()}
    return dict(decode_step_host_ms=med["contiguous"], paged_decode_step_host_ms=med["paged"],
                appends_host_ms=med["appends"], samples=2 * rounds, k1_launches_per_decode_step=launches)


def phase_serve_paged(torch, timer, model) -> dict:
    """Full-width qwen1.5-0.5b (the serve phase's weights) through the paged
    KV cache on the card: the three runs of :func:`serve_paged_runs`, their
    checks, dt_unpack_into against its plain version, and the paged decode
    step's host time."""
    import numpy as np

    from repro_torch.configs import get_config

    cfg = get_config("qwen1.5-0.5b").replace(attn_impl="flash")
    rng = np.random.default_rng(1)
    lens = [FLASH_SERVE_S[i % len(FLASH_SERVE_S)] for i in range(PAGED_REQUESTS)]
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in lens]
    gen = torch.Generator(device="cuda").manual_seed(12)
    unpack = unpack_into_rows(torch, timer, gen)  # compare launches stay outside the counted runs
    runs = serve_paged_runs(torch, cfg, model, prompts, 16, PAGE_SIZE)
    check_serve_paged(runs, PAGED_REQUESTS, 16, cfg.n_layers)
    step = paged_step_host_ms(torch, cfg, model)
    rows = {}
    for name, run in runs.items():
        if name == "k1":
            continue
        toks = sum(len(t) for t in run["tokens"])
        lat = np.asarray(run["latencies_s"]) * 1e3
        rows[name] = dict(tokens=toks, wall_s=run["wall_s"], tokens_per_s=toks / run["wall_s"],
                          latency_p50_ms=float(np.percentile(lat, 50)),
                          latency_p95_ms=float(np.percentile(lat, 95)))
        for key in ("steps", "page_moves", "max_concurrent", "summary", "kv", "prefills", "flash_launches",
                    "decode_steps", "decode_attention_launches"):
            if key in run:
                rows[name][key] = run[key]
    pool = runs["admission"]["kv"]
    emit("serve_paged", arch=cfg.name, requests=PAGED_REQUESTS, prompt_lens=lens, max_new_tokens=16, max_batch=4,
         max_len=512, page_size=PAGE_SIZE, pool_pages=pool["num_pages"], page_bytes=pool["page_bytes"],
         token_bytes=pool["token_bytes"], pool_mb=pool["num_pages"] * pool["page_bytes"] / 1e6, runs=rows,
         k1=runs["k1"], step=step, dt_unpack_into=unpack, device=torch.cuda.get_device_name(0))
    flash = sum(runs[name]["flash_launches"] for name in ("admission", "elastic"))
    k4 = sum(runs[name]["decode_attention_launches"] for name in ("admission", "elastic"))
    return dict(launches=runs["k1"]["dt_unpack_into"], pack_launches=runs["k1"]["dt_pack"], flash_launches=flash,
                decode_attention_launches=k4, unpack=unpack)


def device_ms(torch, fn, reps: int = 3) -> tuple:
    """Median device ms of ``fn`` (work that ends on the current stream or
    on a stream ``fn`` returns), timed from an event after a device spin to
    an event after the work; the median host ms of the call; and the
    spin's ms. The device span holds no host time while the host ms stays
    below the spin's. Returns (device_ms, host_ms, spin_ms)."""
    dev, host, spin = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        es, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        es.record()
        torch.cuda._sleep(DIST_SPIN_CYCLES)
        e0.record()
        t = time.perf_counter()
        stream = fn()
        host.append((time.perf_counter() - t) * 1e3)
        e1.record(stream or torch.cuda.current_stream())
        torch.cuda.synchronize()
        dev.append(e0.elapsed_time(e1))
        spin.append(es.elapsed_time(e0))
    return statistics.median(dev), statistics.median(host), min(spin)


def dist_allreduce(torch, n_params: int) -> dict:
    """(a) The gradient all-reduce of the full-width model on a (2, 4)
    ("pod", "data") mesh of thread-ranks: every rank's fp32 vector as long
    as the parameter tree, integers in [-4, 4] (sums exact in any order),
    through the flat, hierarchical and 4-stream schedules in a
    ``ThreadComm.run``; each rank's result byte-equal to ``torch.sum`` over
    the stacked inputs, each schedule's device ms (median of 3) beside the
    bytes bound (8 inputs read once, 8 outputs written once)."""
    from repro_torch.core import collectives as col
    from repro_torch.core.hierarchical import flat_all_reduce, hierarchical_all_reduce
    from repro_torch.core.mesh import P, make_mesh
    from repro_torch.core.streams import stream_comm_create, stream_create, stream_free
    from repro_torch.core.threadcomm import threadcomm_init

    mesh = make_mesh((2, 4), ("pod", "data"))
    tc = threadcomm_init(mesh, ("pod", "data"))
    check(n_params % 4 == 0, f"{n_params} parameters split over the 4 data ranks and 4 streams")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-4, 5, (mesh.size, n_params), generator=gen, device="cuda", dtype=torch.float32)
    ref = x.sum(0)
    streams = [stream_create(name=f"grad{i}") for i in range(4)]
    comms = [stream_comm_create(mesh, ("pod", "data"), s) for s in streams]
    schedules = {
        "flat": lambda xs: flat_all_reduce(xs, tc)[0],
        "hierarchical": lambda xs: hierarchical_all_reduce(xs, tc, axis=1)[0],
        "multi_stream_4": lambda xs: col.multi_stream_all_reduce(xs, comms, axis=1)[0],
    }
    nbytes = 2 * x.numel() * 4
    bound_ms = nbytes / HW.HBM_BW * 1e3
    rows = {}
    try:
        for name, schedule in schedules.items():
            equal = tc.run(lambda xs: torch.tensor([torch.equal(schedule(xs)[0], ref)]), x,
                           in_specs=P(("pod", "data")), out_specs=P(("pod", "data")))
            check(bool(equal.all()), f"{name} all-reduce: every rank byte-equal to torch.sum ({equal.tolist()})")
            def run_once():  # ends on the current stream: shard_map joins every rank to it
                tc.run(lambda xs: schedule(xs)[:, :1], x, in_specs=P(("pod", "data")), out_specs=P())

            ms, wall_ms, spin_ms = device_ms(torch, run_once)
            rows[name] = dict(ranks_byte_equal=int(equal.sum()), ms=ms, host_ms=wall_ms, spin_ms=spin_ms,
                              ms_over_bound=ms / bound_ms)
            torch.cuda.empty_cache()
    finally:
        for s in streams:
            stream_free(s)
    return dict(mesh=mesh.shape, payload_elems=n_params, payload_gb_per_rank=n_params * 4 / 1e9, bytes=nbytes,
                bound_ms=bound_ms, bound_by="bytes", schedules=rows)


def dist_ring_sends(torch) -> dict:
    """(b) 16 windowed ``isend_enqueue`` calls of the served K span over the
    "data" ring of 4: each rank's row a live-shape K leaf, the datatype the
    enqueue phase's subarray, an OffloadWindow of depth 2 on a cudaStream_t
    offload stream comm. Every received row byte-equal to the host engine's
    pack of its source row; the window's counts; one K1 launch per send (the
    4 rows form one uniform layout); the send's host and device ms."""
    from repro_torch.core import datatype as dtt
    from repro_torch.core.enqueue import OffloadWindow, _rowed_type, isend_enqueue
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.core.streams import stream_comm_create, stream_create, stream_free
    from repro_torch.kernels import dt_pack as dp

    L, Bs, T, W = KV_LEAF
    mesh = make_mesh((2, 4), ("pod", "data"))
    n = mesh.shape["data"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(n, L, Bs, T, W, generator=gen, device="cuda").to(torch.bfloat16)
    host = x.cpu()
    span = lambda i: dtt.subarray(KV_LEAF, (L, 1, KV_SPAN, W), (0, i % Bs, 128 * (i % 3), 0), dtt.BF16)
    pe = ProgressEngine()
    s = stream_create(info={"type": "cudaStream_t"}, name="ring-offload")
    try:
        comm = stream_comm_create(mesh, ("data",), s)
        uniform = _rowed_type(x, span(0), 1, n) is not None
        win = OffloadWindow(comm, depth=2, engine=pe, name="ring-sends")
        sent, issue_ms = [], []
        dp.dt_pack.launches = 0  # count the main path only
        for i in range(DIST_SENDS):
            t = time.perf_counter()
            y, _ = isend_enqueue(x, comm, 1 + i % (n - 1), datatype=span(i), window=win)
            issue_ms.append((time.perf_counter() - t) * 1e3)
            sent.append((i, y))
        slots = win.drain(timeout=120)
        launches = dp.dt_pack.launches
        wst = win.stats(engine=False)
        check(len(slots) == DIST_SENDS and wst["admitted"] == wst["reaped"] == DIST_SENDS
              and wst["max_depth_seen"] <= 2, f"ring-send window stats {wst}")
        want_launches = DIST_SENDS if uniform else DIST_SENDS * n
        check(uniform and launches == want_launches,
              f"K1 launches on the ring sends {launches} == {want_launches} (rows one uniform layout: {uniform})")
        for i, y in sent:
            off, dt = 1 + i % (n - 1), span(i)
            got = y.cpu()
            for r in range(n):
                want = torch.from_numpy(dtt.pack(host[r], dt)).view(torch.bfloat16)
                check(bytes_equal(torch, got[(r + off) % n], want), f"send {i}: row {r} lands in row {(r + off) % n}")
        del sent, y, got
        def send_once():  # ends on the offload stream's CUDA stream
            isend_enqueue(x, comm, 1, datatype=span(0), window=win)
            return s.torch_stream(x.device)

        ms, wall_ms, spin_ms = device_ms(torch, send_once, reps=5)
        win.drain(timeout=60)
        packed = n * dtt.type_size(span(0))
    finally:
        pe.stop_all()
        stream_free(s)
    nbytes = 2 * packed  # the span read once, the received rows written once
    return dict(ring=n, row_shape=[L, Bs, T, W], row_mb=L * Bs * T * W * 2 / 2 ** 20, sends=DIST_SENDS,
                packed_mb_per_send=packed / 2 ** 20, window=wst, k1_launches=launches, rows_one_layout=uniform,
                issue_host_ms_median=statistics.median(issue_ms), send_ms=ms, send_host_ms=wall_ms, spin_ms=spin_ms,
                bytes=nbytes,
                bound_ms=nbytes / HW.HBM_BW * 1e3, bound_by="bytes")


def dist_shift(torch) -> dict:
    """(c) ``shift_enqueue`` over the data axis inside shard_map: a pipeline
    activation (4, 512, 1024) bf16 per rank; the edge ranks receive zeros,
    every other rank its left neighbour's payload."""
    from repro_torch.core.enqueue import shift_enqueue
    from repro_torch.core.mesh import P, make_mesh, shard_map
    from repro_torch.core.streams import stream_comm_create, stream_create, stream_free

    mesh = make_mesh((2, 4), ("pod", "data"))
    gen = torch.Generator(device="cuda").manual_seed(14)
    act = torch.randn(mesh.size * DIST_ACT[0], *DIST_ACT[1:], generator=gen, device="cuda").to(torch.bfloat16)
    s = stream_create(info={"type": "cudaStream_t"}, name="pipe-offload")
    try:
        ec = stream_comm_create(mesh, ("data",), s)
        y = shard_map(lambda a: shift_enqueue(a, ec, shift=1)[0], mesh, P(("pod", "data")), P(("pod", "data")))(act)
        torch.cuda.synchronize()
    finally:
        stream_free(s)
    y, a = y.view(mesh.size, *DIST_ACT), act.view(mesh.size, *DIST_ACT)
    for r in range(mesh.size):
        want = torch.zeros_like(a[r]) if r % 4 == 0 else a[r - 1]
        check(bytes_equal(torch, y[r], want), f"shift_enqueue: rank {r} holds {'zeros' if r % 4 == 0 else 'rank %d' % (r - 1)}")
    return dict(activation=list(DIST_ACT), dtype="bfloat16", ranks=mesh.size, edge_ranks_zero=[0, 4])


def dist_hybrid(torch) -> dict:
    """(d) ``HybridThreadComm.allreduce_large``: 2 host threads x the 8 mesh
    positions, (8, 2**20) fp32 integers in [-4, 4] per thread, held against
    the numpy sum."""
    import numpy as np

    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.core.streams import StreamPool
    from repro_torch.core.threadcomm import HostThreadComm, threadcomm_init

    mesh = make_mesh((2, 4), ("pod", "data"))
    rng = np.random.default_rng(15)
    vals = [rng.integers(-4, 5, (mesh.size, 1 << 20)).astype(np.float32) for _ in range(2)]
    want = (vals[0] + vals[1]).sum(0)
    host = HostThreadComm(2, engine=ProgressEngine(), pool=StreamPool(), name="dist-hybrid")
    hybrid = threadcomm_init(mesh, ("pod", "data")).with_host_threads(host)
    out, errors = {}, []

    def worker(t):
        h = host.attach(rank=t)
        try:
            out[t] = hybrid.allreduce_large(h, vals[t], timeout=60.0)
        except BaseException as e:  # surfaced on the main thread below
            errors.append(e)
        finally:
            h.detach()

    t0 = time.perf_counter()
    host.start()
    try:
        threads = [threading.Thread(target=worker, args=(t,), name=f"hybrid-{t}") for t in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        check(not any(th.is_alive() for th in threads), "hybrid threads finished")
    finally:
        host.finish(timeout=10.0)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    for t in range(2):
        check(out[t].shape == want.shape and np.array_equal(out[t], want), f"hybrid allreduce_large, thread {t}")
    return dict(threads=2, mesh=mesh.shape, per_thread=[mesh.size, 1 << 20], wall_s=wall)


def phase_dist(torch, n_params: int) -> dict:
    """The distributed layer on the card, its mesh positions thread-ranks
    on one GPU: (a) the full-width gradient all-reduce, (b) windowed ring
    sends of the served K span through K1, (c) a pipeline shift, (d) the
    hybrid host x mesh allreduce."""
    allreduce = dist_allreduce(torch, n_params)
    torch.cuda.empty_cache()
    ring = dist_ring_sends(torch)
    torch.cuda.empty_cache()
    shift = dist_shift(torch)
    hybrid = dist_hybrid(torch)
    torch.cuda.empty_cache()
    emit("dist", allreduce=allreduce, ring_sends=ring, shift=shift, hybrid=hybrid,
         device=torch.cuda.get_device_name(0))
    return dict(launches=ring["k1_launches"])


# ----------------------------------------------------------------------
# the train phase
# ----------------------------------------------------------------------


def state_bytes_equal(torch, xs, ys) -> bool:
    """Two lists of tensors hold the same bytes, pairwise."""
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.detach().reshape(-1).view(torch.uint8), y.detach().reshape(-1).view(torch.uint8))
        for x, y in zip(xs, ys))


def need_disk(path: Path, nbytes: int, what: str) -> None:
    """Raise unless the disk under ``path`` has room for ``nbytes``."""
    free = shutil.disk_usage(path).free
    check(free >= nbytes, f"{what}: {free / 1e9:.2f} GB free under {path}, {nbytes / 1e9:.2f} GB needed")


def train_step_flops(cfg, batch: int, seq: int, n_params: int) -> float:
    """Least operations of one training step: 6·N·tokens for the weight
    matmuls (forward and the two backward products) plus attention: QK^T and
    PV are 2·B·S²·(nq·hd) each in the forward, causal keeps half, and the
    backward is twice the forward, so 6·B·S²·nq·hd per layer."""
    attn = 6 * batch * seq * seq * cfg.n_heads * cfg.resolved_head_dim * cfg.n_layers
    return 6.0 * n_params * batch * seq + attn


def profiled_kernel_ms(torch, fn):
    """Device ms of the kernels and copies ``fn`` runs, summed over
    torch.profiler's CUDA events (None when the profiler records none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 if total_us > 0 else None


def train_full_width(torch, base: Path) -> dict:
    """(a) Trainer at full-width qwen1.5-0.5b for TRAIN_STEPS steps, with a
    checkpoint saved mid-run, restored and held byte-equal to the state at
    its step boundary, and a fresh Trainer resuming from the last one; then
    (d) the trained model served through make_prefill_step."""
    import numpy as np

    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.train import Trainer, make_prefill_step
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config("qwen1.5-0.5b")
    check(cfg.n_layers == 24 and cfg.grad_accum == 2 and cfg.remat == "full" and cfg.param_dtype == "bfloat16",
          "the published qwen1.5-0.5b training config: 24 layers, grad_accum 2, remat full, bf16 params")
    opt, data = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS), DataConfig(batch=8, seq=128)
    mid = TRAIN_CKPT_EVERY
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, opt, data, ckpt_dir=str(base / "a"), ckpt_every=mid, ckpt_keep=1, grad_overlap="jit", seed=0)
    n_params = sum(p.numel() for p in tr.params.parameters())
    ckpt_bytes = sum(t.numel() * t.element_size() for t in store.tree_tensors(tr.state_tree()))
    need_disk(base, int(2.5 * ckpt_bytes), "train phase checkpoints")
    boundary, mid_check = {}, {}
    save_async = tr.ckpt.save_async

    def save_spy(step, tree, extra=None):
        if step == mid:  # the state at the step boundary, copied on the card before the save
            boundary["state"] = [t.detach().clone() for t in store.tree_tensors(tree)]
        elif "state" in boundary and not mid_check:  # before keep=1 retires the mid-run save
            check(tr.ckpt.wait_for_pending(), f"the step-{mid} save is written")
            loaded, step_read = tr.ckpt.restore_step(mid, tree)
            mid_check["step"] = step_read
            mid_check["equal"] = state_bytes_equal(torch, store.tree_tensors(loaded), boundary.pop("state"))
            del loaded
        return save_async(step, tree, extra)

    tr.ckpt.save_async = save_spy
    t0 = time.perf_counter()
    hist = tr.run(TRAIN_STEPS, log_every=1)
    wall = time.perf_counter() - t0
    check(len(hist) == TRAIN_STEPS and all(math.isfinite(l) for l in hist), f"finite losses: {hist}")
    check(hist[-1] < hist[0], f"the last loss is below the first: {hist[0]} -> {hist[-1]}")
    check(mid_check.get("step") == mid and mid_check.get("equal") is True,
          f"the step-{mid} checkpoint, saved asynchronously mid-run, restores byte-equal to its boundary: {mid_check}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tr.last_progress_stats is not None and tr.last_progress_stats["completions"] > 0,
          "the progress engine completed the run's requests")
    snaps = tr.ckpt.snapshot_times()
    check([s["step"] for s in snaps] == [mid, TRAIN_STEPS - 1], f"saves at steps {[s['step'] for s in snaps]}")
    for s in snaps:
        s["gb_per_s"] = s["bytes"] / (s["ms"] * 1e6)

    tr2 = Trainer(cfg, opt, data, ckpt_dir=str(base / "a"), ckpt_every=mid, ckpt_keep=1, seed=1)
    tr2.maybe_restore()
    check(tr2.start_step == TRAIN_STEPS, f"the fresh trainer resumes at step {TRAIN_STEPS}: {tr2.start_step}")
    check(state_bytes_equal(torch, store.tree_tensors(tr2.state_tree()), store.tree_tensors(tr.state_tree())),
          "the restored state is byte-equal to the first trainer's final state")
    tr2.close()
    del tr2
    torch.cuda.empty_cache()

    # (d) serve the trained model: one 384-token prompt, flash on every layer
    prompt = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab, (1, FLASH_SERVE_S[-1])).astype(np.int32)}
    fa.flash_attention.launches = 0  # count the train path's prefill only
    l_flash, _ = make_prefill_step(cfg.replace(attn_impl="flash"))(tr.params, prompt)
    torch.cuda.synchronize()
    flash_launches = fa.flash_attention.launches
    l_ein, _ = make_prefill_step(cfg.replace(attn_impl="einsum"))(tr.params, prompt)
    rel = max_err(l_flash, l_ein) / l_ein.abs().max().item()
    check(flash_launches == cfg.n_layers, f"flash launches {flash_launches} == {cfg.n_layers} layers")
    check(bool(torch.isfinite(l_flash).all()) and l_flash.shape == (1, cfg.vocab), "finite (1, vocab) logits")
    check(rel <= 5e-2, f"trained-model prefill, flash vs einsum: rel {rel} <= 5e-2 (the serve phase's bf16 bound)")

    # where a step goes: the grad step and the AdamW update alone on the host
    # clock, and one whole step's kernel time (this mutates the state, so it
    # comes after every check on it)
    from repro_torch.launch.train import make_grad_step
    from repro_torch.optim.adamw import adamw_update

    b = {k: torch.as_tensor(v).to(tr.device) for k, v in tr.pipeline.build_batch(TRAIN_STEPS).items()}
    grad_step = make_grad_step(cfg)
    grad_ms = host_ms(torch, lambda: grad_step(tr.params, b), reps=3)
    grads, _ = grad_step(tr.params, b)
    update_ms = host_ms(torch, lambda: adamw_update(opt, grads, tr.opt_state, tr._named), reps=3)
    del grads
    step_again_ms = host_ms(torch, lambda: tr.step(b), reps=3)
    kernel_ms = profiled_kernel_ms(torch, lambda: tr.step(b))

    step_s = statistics.median(tr.step_seconds[1:])
    tokens = data.batch * data.seq
    flops = train_step_flops(cfg, data.batch, data.seq, n_params)
    st = tr.last_progress_stats
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, params=n_params, steps=TRAIN_STEPS, batch=data.batch,
               seq=data.seq, grad_accum=cfg.grad_accum, remat=cfg.remat, losses=hist, wall_s=wall,
               step_host_ms=step_s * 1e3, step_host_ms_all=[s * 1e3 for s in tr.step_seconds],
               step_flops=flops, step_bound_ms=flops / HW.PEAK_FLOPS_BF16 * 1e3, tokens_per_s=tokens / step_s,
               peak_mem_gb=peak_gb, ckpt_bytes=ckpt_bytes, saves=snaps, mid_ckpt_restored_equal=True,
               resumed_at=TRAIN_STEPS, progress=dict((k, st[k]) for k in ("completions", "polls", "parks", "wakes")),
               prefill_flash_launches=flash_launches, prefill_rel_err_bf16=rel,
               breakdown=dict(grad_step_host_ms=grad_ms, adamw_update_host_ms=update_ms,
                              step_host_ms=step_again_ms, step_kernel_ms=kernel_ms,
                              device_busy_share=None if kernel_ms is None else kernel_ms / step_again_ms))
    tr.close()
    return out


def train_windowed(torch) -> dict:
    """(b) grad_overlap="windowed" against the fused step for
    TRAIN_WINDOWED_STEPS steps from the same initial state: every state
    tensor byte-equal after each step."""
    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config("qwen1.5-0.5b")
    opt, data = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS), DataConfig(batch=8, seq=128)
    fused = Trainer(cfg, opt, data, grad_overlap="jit", seed=0)
    windowed = Trainer(cfg, opt, data, grad_overlap="windowed", seed=0)
    try:
        check(state_bytes_equal(torch, store.tree_tensors(fused.state_tree()), store.tree_tensors(windowed.state_tree())),
              "the two trainers start from the same state")
        equal, host_ms = [], {"jit": [], "windowed": []}
        for step in range(TRAIN_WINDOWED_STEPS):
            batch = fused.pipeline.build_batch(step)
            for name, tr in (("jit", fused), ("windowed", windowed)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.step(batch)
                torch.cuda.synchronize()
                host_ms[name].append((time.perf_counter() - t0) * 1e3)
            equal.append(state_bytes_equal(torch, store.tree_tensors(fused.state_tree()),
                                           store.tree_tensors(windowed.state_tree())))
        check(all(equal), f"windowed params, master, m and v byte-equal to the fused step after each step: {equal}")
        st = windowed._grad_window.stats(engine=False)
        check(st["admitted"] == st["reaped"] == TRAIN_WINDOWED_STEPS * windowed._grad_plan.n_buckets,
              f"every bucket's reduce-scatter went through the window: {st}")
        return dict(steps=TRAIN_WINDOWED_STEPS, byte_equal_after_each_step=equal, buckets=windowed._grad_plan.n_buckets,
                    window=dict((k, st[k]) for k in ("admitted", "reaped", "depth")), step_host_ms=host_ms)
    finally:
        fused.close()
        windowed.close()


def train_elastic(torch, base: Path) -> dict:
    """(c) The kill-rank walk of tests/test_fault_injection.py:501-570 at the
    published widths cut to TRAIN_ELASTIC_LAYERS layers: rank 1 dies at t=1 on
    a virtual clock, the heartbeat detects it, the mesh shrinks, the latest
    checkpoint's largest leaf is resharded through a window and training
    resumes. The recovery's shards are held against a clean reshard of the
    same checkpoint, and against its .bin, at the recovery (keep=2 retires
    that checkpoint before the run ends)."""
    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.ft.faultinject import FaultEvent, FaultInjector, FaultPlan, VirtualClock
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.adamw import AdamWConfig

    class CheckedTrainer(Trainer):
        def recover(self, failed_ranks, reshard_depth: int = 4):
            plan = super().recover(failed_ranks, reshard_depth)
            rec = self.recoveries[-1]
            d = self.ckpt._dir_for(rec["ckpt_step"])
            clean, _ = self._reshard_checkpoint(d, rec["plan"])
            rec["clean_equal"] = clean["shards"] == rec["shards"]["shards"]
            with open(store.manifest_path(d)) as f:
                leaf = json.load(f)["leaves"][rec["shards"]["leaf"]]
            raw = (Path(d) / leaf["file"]).read_bytes()
            shards = rec["shards"]["shards"]
            rec["bin_equal"] = b"".join(shards[c] for c in sorted(shards)) == raw
            rec["leaf_bytes"] = len(raw)
            return plan

    steps = TRAIN_ELASTIC_STEPS
    cfg = get_config("qwen1.5-0.5b").replace(n_layers=TRAIN_ELASTIC_LAYERS)
    clock = VirtualClock()
    with FaultInjector(FaultPlan([FaultEvent(1.0, "kill_rank", 1)]), clock=clock) as inject:
        tr = CheckedTrainer(cfg, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=steps),
                            DataConfig(batch=4, seq=64, seed=7), ckpt_dir=str(base / "c"), ckpt_every=2, ckpt_keep=2,
                            autotune=False, mesh_shape=(2, 2, 2), mesh_axes=("pod", "data", "model"),
                            ranks=(0, 1, 2, 3), hb_timeout=2.0, hb_clock=clock, hb_tick=0.5, fault_injector=inject)
        try:
            ckpt_bytes = sum(t.numel() * t.element_size() for t in store.tree_tensors(tr.state_tree()))
            need_disk(base, 3 * ckpt_bytes, "elastic checkpoints (two kept, one being written)")
            inject.attach_heartbeat(tr.heartbeat)
            hist = tr.run(steps, log_every=100)
        finally:
            tr.close()
    check(len(tr.recoveries) == 1, f"exactly one recovery: {len(tr.recoveries)}")
    rec = tr.recoveries[0]
    check(rec["failed"] == [1], f"failed == [1]: {rec['failed']}")
    check(rec["plan"].shape == (1, 2, 2), f"plan (1, 2, 2): {rec['plan'].shape}")
    st = rec["reshard_stats"]
    check(st is not None and st["admitted"] == st["reaped"], f"reshard window admitted == reaped: {st}")
    check(rec["clean_equal"], "the recovery's shards equal a clean reshard of the same checkpoint")
    check(rec["bin_equal"], "the shards concatenate to the leaf's .bin bytes")
    check(len(hist) == steps and all(math.isfinite(l) for l in hist), f"{steps} finite losses: {hist}")
    return dict(cut=f"{TRAIN_ELASTIC_LAYERS} of 24 layers, published widths", steps=steps, losses=hist,
                failed=rec["failed"], plan=list(rec["plan"].shape), ckpt_step=rec["ckpt_step"],
                leaf=rec["shards"]["leaf"], leaf_bytes=rec["leaf_bytes"], grid=list(rec["shards"]["grid"]),
                window=dict((k, st[k]) for k in ("admitted", "reaped")), ckpt_bytes=ckpt_bytes)


def phase_train(torch) -> dict:
    """The training path on the card: (a) full-width training with
    asynchronous checkpoints and a resume, (d) the trained model served with
    flash, (b) the windowed gradient path against the fused one, (c) the
    elastic kill-rank recovery. Checkpoints go to a directory under the
    checkout's build/, removed at the end."""
    (ROOT / "build").mkdir(exist_ok=True)
    base = Path(tempfile.mkdtemp(prefix="train-ckpt-", dir=ROOT / "build"))
    try:
        full = train_full_width(torch, base)
        torch.cuda.empty_cache()
        windowed = train_windowed(torch)
        torch.cuda.empty_cache()
        elastic = train_elastic(torch, base)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit("train", full=full, windowed=windowed, elastic=elastic, device=torch.cuda.get_device_name(0))
    return dict(flash_launches=full["prefill_flash_launches"], step_host_ms=full["step_host_ms"],
                n_params=full["params"], batch=full["batch"], seq=full["seq"])


# ----------------------------------------------------------------------
# the pipeline phase
# ----------------------------------------------------------------------


def pipeline_host(torch) -> dict:
    """(a) gpipe_forward_host at full width: flash on every layer of every
    tick (bubble ticks run their stage too), the boundary sends through an
    OffloadWindow of depth PIPE_DEPTH on a cudaStream_t MPIX stream; held
    against the sequential einsum forward on the same weights, then
    recorded and replayed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import P, make_mesh, shard_map
    from repro_torch.core.progress import ProgressEngine
    from repro_torch.core.schedule import Schedule
    from repro_torch.core.streams import stream_comm_create, stream_create, stream_free
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.common import embed
    from repro_torch.parallel.pipeline import gpipe_forward_host, split_stages

    cfg = get_config("qwen1.5-0.5b").replace(attn_impl="flash")
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_micro, mb, S = PIPE_MICRO
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (n_micro * mb, S))).cuda()
    positions = torch.arange(S, device="cuda").expand(mb, S)
    layers = model.groups[0]
    stages = split_stages(layers, PIPE_STAGES)
    per_stage = len(layers) // PIPE_STAGES
    ticks = n_micro + PIPE_STAGES - 1

    def stage_fn(stage, x):
        for layer in stage:
            x, _ = layer.forward_full(cfg, x, positions)
        return x

    off = stream_create(info={"type": "cudaStream_t"}, name="pipe-1f1b")
    try:
        comm = stream_comm_create(make_mesh((PIPE_STAGES,), ("pipe",)), ("pipe",), off)
        eng = ProgressEngine()
        with torch.no_grad():
            x = embed(cfg, model.embed, tokens).reshape(n_micro, mb, S, cfg.d_model)
            gpipe_forward_host(stage_fn, stages, x, comm, depth=PIPE_DEPTH, engine=eng)  # warm-up
            torch.cuda.synchronize()
            fa.flash_attention.launches = 0  # the main path's run only
            t0 = time.perf_counter()
            outs, win = gpipe_forward_host(stage_fn, stages, x, comm, depth=PIPE_DEPTH, engine=eng)
            torch.cuda.synchronize()
            eager_ms = (time.perf_counter() - t0) * 1e3
            launches = fa.flash_attention.launches
            st = win.stats(engine=False)
            ein = cfg.replace(attn_impl="einsum")
            seq = []
            for m in range(n_micro):
                y = x[m]
                for layer in layers:
                    y, _ = layer.forward_full(ein, y, positions)
                seq.append(y)
            seq = torch.stack(seq)
            rel = max_err(outs, seq) / seq.float().abs().max().item()
            sched = Schedule(engine=eng, name="pipe-1f1b")
            recorded, rec_win = gpipe_forward_host(stage_fn, stages, x, comm, depth=PIPE_DEPTH, engine=eng,
                                                   schedule=sched)
            before = fa.flash_attention.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replayed, win2 = gpipe_forward_host(stage_fn, stages, x, comm, schedule=sched)
            torch.cuda.synchronize()
            replay_ms = (time.perf_counter() - t0) * 1e3
            replay_launches = fa.flash_attention.launches - before
            # where a tick's host time goes: a region of PIPE_STAGES threads
            # doing nothing, and one stage's layers alone on this thread
            empty_region_ms = host_ms(torch, lambda: shard_map(lambda: None, comm.mesh, (), P())())
            one_stage_ms = host_ms(torch, lambda: stage_fn(stages[0], x[0]))
    finally:
        stream_free(off)
    want = ticks * PIPE_STAGES * per_stage
    check(outs.shape == (n_micro, mb, S, cfg.d_model) and bool(torch.isfinite(outs).all()), "finite pipeline outputs")
    check(launches == want, f"flash launches {launches} == {ticks} ticks x {PIPE_STAGES} stages x {per_stage} layers")
    check(st["admitted"] == st["reaped"] == ticks and st["max_depth_seen"] <= PIPE_DEPTH and st["in_flight"] == 0,
          f"window admitted == reaped == {ticks}, depth <= {PIPE_DEPTH}: {st}")
    check(rel <= 5e-2, f"pipeline (flash) vs the sequential einsum forward: rel {rel} <= 5e-2 (the serve phase's bound)")
    check(win2 is rec_win and replay_launches == want, f"the replay launched flash {replay_launches} times")
    check(bytes_equal(torch, recorded, outs) and bytes_equal(torch, replayed, outs),
          "the recorded and the replayed runs are byte-equal to the eager run")
    return dict(stages=PIPE_STAGES, layers_per_stage=per_stage, micro=list(PIPE_MICRO), ticks=ticks,
                depth=PIPE_DEPTH, flash_launches=launches, window=dict((k, st[k]) for k in
                                                                   ("admitted", "reaped", "max_depth_seen")),
                rel_err_vs_sequential_einsum=rel, eager_host_ms=eager_ms, replay_host_ms=replay_ms,
                replay_byte_equal=True, tick_host_ms=eager_ms / ticks, empty_region_host_ms=empty_region_ms,
                one_stage_alone_host_ms=one_stage_ms)


def pipeline_loss(torch) -> dict:
    """(b) pipeline_loss_fn on a (4, 2) ("pipe", "dp") mesh at full width,
    einsum, fp32: the loss and every gradient against the single-rank
    lm_loss on the same batch."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.models.common import apply_norm, embed, logits_out, next_token_xent
    from repro_torch.models.transformer import lm_loss
    from repro_torch.parallel.pipeline import pipeline_loss_fn, split_stages

    cfg = get_config("qwen1.5-0.5b").replace(attn_impl="einsum", param_dtype="float32", compute_dtype="float32")
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda").requires_grad_(True)
    B, S = PIPE_LOSS_BATCH
    n_micro = PIPE_STAGES
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, S))).cuda()
    positions = torch.arange(S, device="cuda").expand(B // n_micro, S)

    def stage_fn(stage, x):
        for layer in stage:
            x, _ = layer.forward_full(cfg, x, positions)
        return x

    def head_loss(head, x, toks):
        return next_token_xent(logits_out(cfg, head["embed"], apply_norm(cfg, head["norm"], x)), toks)

    mesh = make_mesh((PIPE_STAGES, 2), ("pipe", "dp"))
    loss_fn = pipeline_loss_fn(cfg, mesh, "pipe", n_micro, lambda p, t: embed(cfg, p, t), stage_fn, head_loss)
    params = {"embed": model.embed, "stages": split_stages(model.groups[0], PIPE_STAGES),
              "head": {"embed": model.embed, "norm": model.final_norm}}
    ps = list(model.parameters())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp = loss_fn(params, {"tokens": tokens})
    gp = torch.autograd.grad(lp, ps)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    ls, _ = lm_loss(cfg, model, {"tokens": tokens})
    gs = torch.autograd.grad(ls, ps)
    loss_rel = abs(lp.item() - ls.item()) / abs(ls.item())
    grad_rel = max(max_err(a, b) / max(b.abs().max().item(), 1e-30) for a, b in zip(gp, gs))
    check(math.isfinite(lp.item()) and loss_rel <= 1e-4, f"pipelined loss vs lm_loss: rel {loss_rel} <= 1e-4")
    check(grad_rel <= 1e-4, f"every gradient, pipelined vs lm_loss: max |diff| / max |grad| {grad_rel} <= 1e-4")
    return dict(mesh=mesh.shape, batch=[B, S], n_micro=n_micro, loss=lp.item(), loss_rel_err=loss_rel,
                grad_rel_err=grad_rel, leaves=len(ps), pipe_fwd_bwd_host_ms=pipe_ms)


def sharded_step(torch, base: Path) -> dict:
    """(c) the sharded step (params under param_specs, moments under
    opt_state_specs, ZeRO-1: on the layer-stacking dim, 24 layers over dp
    4) against the single-rank make_train_step; a checkpoint of the
    sharded state against the unsharded one's files; a restore with
    shardings= read block by block. The loss is held in bf16. The updated
    params are held on an fp32 copy of the same weights (within one bf16
    step of one rank's but 1%) and in bf16: the step is tensor-parallel,
    and in bf16 its other summation order flips the first AdamW step's
    sign on near-zero gradients, so there every element stays within 2 lr
    plus a step, the share beyond one step is bounded
    (``SHARDED_BF16_SHARE``), and the sharded step's params lie no farther
    from the fp32 step's than one rank's bf16 params do, up to
    ``SHARDED_BF16_CONTROL``. Each bf16 step runs twice from the same state
    and the repeats are compared bit for bit."""
    import numpy as np

    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import ShardedTensor, device_put, make_mesh
    from repro_torch.launch.train import make_grad_step, make_train_step, named, train_shardings
    from repro_torch.models import api
    from repro_torch.models.convert import shardings_tree, state_tree
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import dp_axes

    cfg = get_config("qwen1.5-0.5b")
    check(cfg.grad_accum == 2 and cfg.param_dtype == "bfloat16", "the published training config: grad_accum 2, bf16")
    opt_cfg = AdamWConfig(lr=SHARDED_LR, warmup_steps=0, total_steps=10)
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    B, S = SHARDED_BATCH
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (B, S))).cuda()}
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    meta = TransformerLM(cfg, torch.device("meta"))
    pspecs, ospecs, _, _ = train_shardings(cfg, opt_cfg, mesh, meta, batch)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt0 = adamw_init(opt_cfg, start)
    params, opt = device_put(start, named(mesh, pspecs)), device_put(opt0, named(mesh, ospecs))

    def tree(p, o):
        t = {k: state_tree(cfg, meta, o[k]) for k in ("m", "v", "master")}
        t["count"] = o["count"]
        return {"params": state_tree(cfg, meta, p), "opt": t}

    unsharded_bytes = sum(t.numel() * t.element_size() for t in store.tree_tensors(tree(start, opt0)))
    need_disk(base, 2 * unsharded_bytes + (1 << 30), "sharded and unsharded checkpoints")
    resident = [sum(st.resident_bytes(slot) for t in (params, opt["m"], opt["v"], opt["master"]) for st in t.values())
                for slot in range(mesh.size)]
    CheckpointManager(str(base / "sharded")).save_sync(0, tree(params, opt))
    store.save_pytree(str(base / "unsharded"), tree(start, opt0), step=0)
    files = sorted(p.name for p in (base / "unsharded").iterdir())
    ckpt_equal = sorted(p.name for p in (base / "sharded" / "step_00000000").iterdir()) == files and all(
        (base / "sharded" / "step_00000000" / f).read_bytes() == (base / "unsharded" / f).read_bytes() for f in files)
    check(ckpt_equal, "the checkpoint of the sharded state is byte-equal to the unsharded state's")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, m = make_train_step(cfg, opt_cfg, dp=dp_axes(mesh))(params, opt, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grad_ms = host_ms(torch, lambda: make_grad_step(cfg, dp=dp_axes(mesh))(params, batch), reps=1)
    tp_bf16 = {n: st.gather() for n, st in params.items()}
    # the same step again from the same state, bit for bit
    p2, o2 = device_put(start, named(mesh, pspecs)), device_put(opt0, named(mesh, ospecs))
    make_train_step(cfg, opt_cfg, dp=dp_axes(mesh))(p2, o2, batch)
    tp_repeat_equal = all(torch.equal(p2[n].gather(), w) for n, w in tp_bf16.items())
    del p2, o2
    single = model.requires_grad_(True)
    _, _, m1 = make_train_step(cfg, opt_cfg)(single, adamw_init(opt_cfg, dict(single.named_parameters())), batch)
    loss_single = m1["loss"].item()
    loss_rel = abs(m["loss"].item() - loss_single) / abs(loss_single)
    check(math.isfinite(m["loss"].item()) and loss_rel <= 1e-4, f"sharded vs single-rank loss: rel {loss_rel} <= 1e-4")
    one_bf16 = {n: p.detach().clone() for n, p in single.named_parameters()}
    again = api.model_class(cfg)(cfg, torch.device("cuda"))
    with torch.no_grad():
        for n, q in again.named_parameters():
            q.copy_(start[n])
    again.requires_grad_(True)
    make_train_step(cfg, opt_cfg)(again, adamw_init(opt_cfg, dict(again.named_parameters())), batch)
    single_repeat_equal = all(torch.equal(q.detach(), one_bf16[n]) for n, q in again.named_parameters())
    del again

    shardings = {"params": shardings_tree(cfg, meta, {n: st.sharding for n, st in params.items()}),
                 "opt": {**{k: shardings_tree(cfg, meta, {n: st.sharding for n, st in opt[k].items()})
                            for k in ("m", "v", "master")}, "count": opt["count"].sharding}}
    t0 = time.perf_counter()
    loaded, step_read = CheckpointManager(str(base / "sharded")).restore_latest(tree(params, opt), shardings=shardings)
    restore_s = time.perf_counter() - t0
    got, want = store.leaf_names(loaded), store.leaf_names(tree(start, opt0))
    blocks = 0
    for name, leaf in got.items():
        rows = leaf.rows if isinstance(leaf, store.StackedLeaf) else [leaf]
        full = want[name].rows if isinstance(want[name], store.StackedLeaf) else [want[name]]
        for r, g in zip(rows, full):
            check(isinstance(r, ShardedTensor), f"{name} restored sharded")
            for slot, b in enumerate(r.blocks):
                check((b is None) != r.sharding.holds(slot), f"{name}: position {slot} holds a block as its spec says")
                if b is not None:
                    check(bytes_equal(torch, b, g[r.index(slot)]), f"{name}: position {slot}'s restored block")
                    blocks += 1
    check(step_read == 0, "restored step 0")
    del loaded, single, model, params, opt, opt0, m1
    release(torch)

    # the same weights widened to fp32: the step's math without bf16's roundings
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    w32 = {n: w.float() for n, w in start.items()}
    del start
    p32, o32 = device_put(w32, named(mesh, pspecs)), device_put(adamw_init(opt_cfg, w32), named(mesh, ospecs))
    make_train_step(c32, opt_cfg, dp=dp_axes(mesh))(p32, o32, batch)
    del o32
    single = api.model_class(c32)(c32, torch.device("cuda"))
    with torch.no_grad():
        for n, q in single.named_parameters():
            q.copy_(w32[n])
    del w32
    single.requires_grad_(True)
    make_train_step(c32, opt_cfg)(single, adamw_init(opt_cfg, dict(single.named_parameters())), batch)
    one32 = dict(single.named_parameters())
    off32, total, wild32 = beyond_a_step(torch, ((p32[n].gather(), p.detach()) for n, p in one32.items()), SHARDED_LR)
    # bf16: the TP step against one rank's, and each against the fp32 step
    # (one rank's own distance from it is the control)
    off, _, wild = beyond_a_step(torch, ((tp_bf16[n], one_bf16[n]) for n in one_bf16), SHARDED_LR)
    off_tp32, _, wild_tp32 = beyond_a_step(torch, ((tp_bf16[n], p.detach()) for n, p in one32.items()), SHARDED_LR)
    off_one32, _, wild_one32 = beyond_a_step(torch, ((one_bf16[n], p.detach()) for n, p in one32.items()),
                                             SHARDED_LR)
    del single, one32, p32, tp_bf16, one_bf16
    release(torch)
    check(off32 <= 0.01 * total and wild32 == 0,
          f"fp32 copy: params beyond one bf16 step of the single-rank step's: {off32} of {total} (<= 1%), "
          f"{wild32} beyond 2 lr")
    check(off <= SHARDED_BF16_SHARE * total and wild == 0,
          f"bf16: params beyond one bf16 step of the single-rank step's: {off} of {total} "
          f"(<= {SHARDED_BF16_SHARE}), {wild} beyond 2 lr")
    check(off_tp32 <= SHARDED_BF16_CONTROL * off_one32 and wild_tp32 == 0 and wild_one32 == 0,
          f"bf16 against the fp32 step: the sharded step's params beyond one bf16 step {off_tp32}, the single-rank "
          f"step's {off_one32} (<= {SHARDED_BF16_CONTROL}x), {wild_tp32} / {wild_one32} beyond 2 lr")
    return dict(mesh=mesh.shape, batch=[B, S], grad_accum=cfg.grad_accum, loss=m["loss"].item(),
                loss_single=loss_single, loss_rel_err=loss_rel, params_total=total,
                params_beyond_one_bf16_step_fp32_copy=off32, params_beyond_one_bf16_step_bf16=off,
                bf16_vs_fp32_step_beyond=dict(sharded=off_tp32, single=off_one32),
                repeat_bit_equal=dict(sharded=tp_repeat_equal, single=single_repeat_equal),
                step_host_ms=step_ms, grad_step_alone_host_ms=grad_ms, step_peak_mem_gb=step_peak_gb,
                ckpt_byte_equal=ckpt_equal, ckpt_bytes=unsharded_bytes, restore_s=restore_s, restored_blocks=blocks,
                resident_bytes_per_rank=resident, unsharded_state_bytes=unsharded_bytes)


def phase_pipeline(torch, smi: str) -> dict:
    """The second training path on the card: (a) the windowed 1F1B
    pipeline forward, (b) the pipelined loss and its gradients, (c) the
    sharded step and sharded checkpoints. Checkpoints go to a directory
    under the checkout's build/, removed at the end."""
    (ROOT / "build").mkdir(exist_ok=True)
    base = Path(tempfile.mkdtemp(prefix="pipeline-ckpt-", dir=ROOT / "build"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        host = pipeline_host(torch)
        torch.cuda.empty_cache()
        loss = pipeline_loss(torch)
        torch.cuda.empty_cache()
        sharded = sharded_step(torch, base)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(base, ignore_errors=True)
    emit("pipeline", host=host, loss=loss, sharded=sharded, phase_host_s=time.perf_counter() - t0,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return dict(flash_launches=host["flash_launches"])


def bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def rel_err(a, b) -> float:
    """max |a - b| over max |b|: a relative error at the tensor's scale."""
    return max_err(a, b) / b.float().abs().max().item()


def beyond_a_step(torch, pairs, lr: float) -> tuple:
    """Two steps' params, leaf by leaf over ``(got, want)`` pairs: (elements
    more than one bf16 step apart at the larger magnitude, total, elements
    more than 2 lr plus that step apart). AdamW's first step moves an
    element by at most lr, so even a flipped sign stays within 2 lr."""
    off = total = wild = 0
    for got, want in pairs:
        got, want = got.to("cuda").float(), want.to("cuda").float()
        top = torch.clamp(torch.maximum(got.abs(), want.abs()), min=2.0 ** -126)
        step = torch.exp2(torch.floor(torch.log2(top)) - 7)
        diff = (got - want).abs()
        beyond = diff > step
        off += int(beyond.sum().item())
        wild += int((diff[beyond] > 2 * lr + step[beyond]).sum().item())
        total += want.numel()
    return off, total, wild


def release(torch) -> None:
    """Collect what nothing references any more and hand the allocator's
    cached blocks back to the card, so the next model finds them free."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def zoo_bytes(torch, cfg) -> dict:
    """The weights' bytes of ``cfg``, reckoned on a meta model, beside the
    card's free memory; raises when they would not fit."""
    from repro_torch.models.api import model_class

    meta = model_class(cfg)(cfg, torch.device("meta"))
    n = sum(q.numel() for q in meta.parameters())
    nbytes = sum(q.numel() * q.element_size() for q in meta.parameters())
    free, total = torch.cuda.mem_get_info()
    check(nbytes < free, f"{cfg.name}: {nbytes / 1e9:.2f} GB of weights fit in {free / 1e9:.2f} GB free")
    return dict(params=n, weight_bytes=nbytes, free_bytes_before=free)


def zoo_serve(torch, cfg, model, prompts, max_batch: int, max_len: int, max_new: int) -> dict:
    """``ServeEngine`` (recorded decode step, progress engine) over
    ``prompts``, all submitted at once; flash launches counted from 0 just
    before the run and read just after."""
    import numpy as np

    from repro_torch.core.progress import ProgressEngine
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.engine import ServeEngine

    pe = ProgressEngine()
    eng = ServeEngine(cfg, model, max_batch=max_batch, max_len=max_len, progress_engine=pe, step_schedule=True)
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    done_at = {}
    for _ in range(10_000):
        if all(r.done for r in reqs):
            break
        eng.step()
        for r in reqs:
            if r.done and r.rid not in done_at:
                done_at[r.rid] = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    steps = eng.step_schedule.stats()["replays"]
    pe.stop_all()
    check(all(r.done and len(r.out_tokens) == max_new for r in reqs),
          f"{cfg.name}: every request has {max_new} tokens: {[len(r.out_tokens) for r in reqs]}")
    toks = sum(len(r.out_tokens) for r in reqs)
    lats = [done_at[r.rid] - t0 for r in reqs]
    return dict(reqs=reqs, launches=launches, stats=dict(
        requests=len(reqs), prompt_lens=[len(p) for p in prompts], max_new_tokens=max_new, max_batch=max_batch,
        max_len=max_len, tokens=toks, wall_s=wall, tokens_per_s=toks / wall, decode_steps=steps,
        latency_p50_ms=float(np.percentile(lats, 50) * 1e3), latency_p95_ms=float(np.percentile(lats, 95) * 1e3)))


def greedy_alone(torch, cfg, model, prompt, n: int, max_len: int):
    """One request decoded alone (batch of one): its ``n`` greedy tokens and,
    per token, the top-2 logit margin and the top logit."""
    from repro_torch.models import api

    logits, cache = api.prefill(cfg, model, {"tokens": prompt[None]}, max_len=max_len)
    toks, margins = [], []
    for i in range(n):
        top = torch.topk(logits[0].float(), 2).values
        toks.append(int(torch.argmax(logits[0])))
        margins.append(((top[0] - top[1]).item(), top[0].item()))
        if i + 1 < n:
            tok = torch.tensor([toks[-1]], device="cuda")
            logits, cache = api.decode_step(cfg, model, cache, tok, torch.tensor([len(prompt) + i], device="cuda"))
    return toks, margins


class MoERoutes:
    """The MoE routers' top-k choices over a forward. While the context is
    open ``torch.topk``, which inside a model's forward only ``moe_apply``
    calls, is wrapped: without ``impose`` every call's choices ``(N, k)``
    and the gap between its k-th and (k+1)-th probability are recorded in
    ``calls`` and ``gaps``, in call order; with it, call ``i`` takes the
    experts ``impose(i)`` instead, at its own router's probabilities."""

    def __init__(self, torch, impose=None):
        self.torch, self.impose, self.calls, self.gaps = torch, impose, [], []

    def __enter__(self):
        orig = self.orig = self.torch.topk

        def topk(probs, k, dim=-1):
            if self.impose is not None:
                idx = self.impose(len(self.calls))
                self.calls.append(idx)
                return probs.gather(-1, idx), idx
            v, idx = orig(probs, k, dim=dim)
            top = orig(probs, k + 1, dim=dim).values
            self.calls.append(idx)
            self.gaps.append(top[:, k - 1] - top[:, k])
            return v, idx

        self.torch.topk = topk
        return self

    def __exit__(self, *exc):
        self.torch.topk = self.orig


def route_flips(torch, a: MoERoutes, b_calls: list) -> dict:
    """How many (layer, token) top-k expert sets of run ``a`` differ from
    those of ``b_calls``, matched call by call; the largest k-th/(k+1)-th
    probability gap of ``a`` among them, beside the median over all."""
    flipped, gaps = [], []
    for x, y, g in zip(a.calls, b_calls, a.gaps):
        f = (x.sort(-1).values != y.sort(-1).values).any(-1)
        flipped.append(int(f.sum()))
        gaps.append(g[f])
    flip_gaps = torch.cat(gaps)
    return dict(flipped=sum(flipped), choices=sum(x.shape[0] for x in a.calls), flipped_per_call=flipped,
                flipped_gap_max=flip_gaps.max().item() if flip_gaps.numel() else None,
                gap_median=torch.cat(a.gaps).median().item())


@contextlib.contextmanager
def fp32_attention(torch):
    """While open, the full forward's einsum attention (``models.common.attend``)
    takes its logits, softmax and P·V in fp32 and rounds its output once to
    q's dtype: the decode-attention kernel's arithmetic (and flash's plain
    version's), so a full forward run under it is the like-for-like oracle of
    a bf16 decode through that kernel."""
    from repro_torch.models import common

    einsum_attend = common.attend

    def attend(q, k, v, mask, scale):
        return einsum_attend(q.float(), k.float(), v.float(), mask, scale).to(q.dtype)

    common.attend = attend
    try:
        yield
    finally:
        common.attend = einsum_attend


def decode_vs_full(torch, cfg, model, batch, n_prefix: int, steps: int, routes: dict | None = None,
                   fp32_oracle: bool = False) -> float:
    """Prefill the first ``n_prefix`` tokens of ``batch``, decode the next
    ``steps`` tokens of it through the cache, and hold each step's logits
    against the full forward (``lm_forward``, or ``jamba_forward`` for
    Jamba) of the whole sequence at the same position; the
    largest relative error over the steps. With ``routes`` (a MoE model),
    the routing's part in that error is put into it: how the cached path's
    top-k choices differ from the full forward's (:func:`route_flips`), and
    the largest error again with the full forward's choices imposed on the
    cached path (``rel_shared``). With ``fp32_oracle`` the full forward's
    attention runs the decode kernel's fp32 arithmetic (:func:`fp32_attention`,
    einsum route): in bf16 the decode (K4) and the bf16 einsum forward round
    the attention at different places, and a random-weight MoE turns that
    into whole-model differences, as it does flash against einsum
    (``residual_rels``). Granite with shared routes, six random prompts on an
    H100: a decode against the forward of its own arithmetic reads 0.041-0.055
    (einsum decode, bf16 einsum forward) and 0.043-0.061 (K4, this oracle);
    crossed, 0.077-0.093 either way."""
    from repro_torch.models import api
    from repro_torch.models.jamba import jamba_forward
    from repro_torch.models.transformer import lm_forward

    tokens = torch.as_tensor(batch["tokens"], device="cuda").long()
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    n_img = cfg.n_img_tokens if "img_embeds" in extra else 0
    B, T, k = tokens.shape[0], n_img + tokens.shape[1], cfg.moe.top_k
    forward = jamba_forward if api.family(cfg) == "jamba" else lambda *a: lm_forward(*a)[:1]
    oracle = fp32_attention(torch) if fp32_oracle else contextlib.nullcontext()
    full_cfg = cfg.replace(attn_impl="einsum") if fp32_oracle else cfg
    with torch.no_grad(), MoERoutes(torch) as full_routes, oracle:
        full = forward(full_cfg, model, {"tokens": tokens, **extra})[0]

    def full_choice(i):  # the full forward's choices for the cached path's i-th call
        n = len(full_routes.calls)
        at = slice(0, n_img + n_prefix) if i < n else slice(n_img + n_prefix + i // n - 1, n_img + n_prefix + i // n)
        return full_routes.calls[i % n].view(B, T, k)[:, at].reshape(-1, k)

    def cached(hook) -> float:
        with hook:
            _, cache = api.prefill(cfg, model, {"tokens": tokens[:, :n_prefix], **extra}, max_len=T)
            worst = 0.0
            for i in range(steps):
                p = n_prefix + i
                pos = torch.full((B,), n_img + p, device="cuda")
                logits, cache = api.decode_step(cfg, model, cache, tokens[:, p], pos)
                worst = max(worst, rel_err(logits, full[:, n_img + p]))
        return worst

    own = MoERoutes(torch)
    worst = cached(own)
    if routes is not None:
        routes.update(route_flips(torch, own, [full_choice(i) for i in range(len(own.calls))]))
        routes["rel_shared"] = cached(MoERoutes(torch, impose=full_choice))
    del full
    return worst


def layer_attn_rels(torch, cfg, model, batch) -> list:
    """Each full-attention layer's attention output (``wo`` included), the
    flash route against the einsum route on the same input: the layer
    inputs of one einsum forward. Returns the relative errors in order."""
    from repro_torch.models.common import apply_norm, gqa_attention_full
    from repro_torch.models.transformer import _embed_inputs

    ein = cfg.replace(attn_impl="einsum")
    rels = []
    with torch.no_grad():
        x, positions, _, _ = _embed_inputs(ein, model, batch)
        for layers in model.groups:
            for layer in layers:
                if layer.spec.attn == "gqa" and layer.spec.window == 0:
                    h = apply_norm(ein, layer.ln1, x)
                    a_f, _ = gqa_attention_full(cfg, layer.attn, h, positions, theta=layer.spec.theta)
                    a_e, _ = gqa_attention_full(ein, layer.attn, h, positions, theta=layer.spec.theta)
                    rels.append(rel_err(a_f, a_e))
                x, _ = layer.forward_full(ein, x, positions)
    return rels


def residual_rels(torch, cfg, model, batch) -> list:
    """The residual stream after each layer, the flash route against the
    einsum route with the einsum run's expert choices imposed on the flash
    run: ``||a - b|| / ||b||`` per layer, in order. How a per-layer
    rounding difference grows with depth, routing aside."""
    from repro_torch.models.transformer import _embed_inputs

    def walk(c, hook) -> list:
        xs = []
        with torch.no_grad(), hook:
            x, positions, _, _ = _embed_inputs(c, model, batch)
            for layers in model.groups:
                for layer in layers:
                    x, _ = layer.forward_full(c, x, positions)
                    xs.append(x.float())
        return xs

    ein = MoERoutes(torch)
    xe = walk(cfg.replace(attn_impl="einsum"), ein)
    xf = walk(cfg, MoERoutes(torch, impose=lambda i: ein.calls[i]))
    return [((a - b).norm() / b.norm()).item() for a, b in zip(xf, xe)]


def route_checks(torch, cfg, model, batch, decode_batch, n_prefix: int, steps: int, max_len: int,
                 model32=None, hold_bf16: bool = False) -> tuple:
    """Does flash change the model, and does the decode match the full
    forward? In bf16 (the served dtype): every full-attention layer's
    output, flash vs einsum on a shared input (held within 2e-2, the
    reference's kernel bound, ``tests/test_kernels.py``); the whole model's
    last logits both ways and its decode vs the full forward (held within
    5e-2, the reference's decode-vs-full bound, ``tests/test_models_smoke.py
    :107``, where ``hold_bf16``; else reported: a random-weight MoE's
    routing turns bf16 rounding into whole-model differences, see
    ``PERF.md``). For a MoE model, both again with one run's expert choices
    imposed on the other, beside how many choices differ: the decode held
    within 5e-2, the prefill reported with its residual stream's growth
    over the layers (:func:`residual_rels`) in bf16 and on the fp32 copy.
    The bf16 decode runs the decode-attention kernel (fp32 logits, softmax
    and P·V), so its held oracle is the full forward with that arithmetic
    (``fp32_oracle``); its gap to the bf16 einsum forward is reported.
    On ``model32``, an fp32 copy of the same weights: the whole model's last
    logits flash vs einsum (held within 1e-3: only summation order differs),
    its decode vs the full forward (held within 5e-2), and the model's own
    bf16 rounding (einsum bf16 vs fp32), reported; and the fp32 kernel's
    launches in that flash prefill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api

    ein = cfg.replace(attn_impl="einsum")
    out, checks = {}, []
    layer = layer_attn_rels(torch, cfg, model, batch)
    out["layer_attn_rel_bf16_max"] = max(layer)
    checks.append((max(layer) <= 2e-2, f"every layer's attention, flash vs einsum in bf16: {layer}"))
    with MoERoutes(torch) as r_flash:
        l_flash, _ = api.prefill(cfg, model, batch, max_len=max_len)
    with MoERoutes(torch) as r_ein:
        l_ein16, _ = api.prefill(ein, model, batch, max_len=max_len)
    out["prefill_flash_vs_einsum_rel_bf16"] = rel_err(l_flash, l_ein16)
    dec_routes = {} if cfg.moe.enabled else None
    out["decode_vs_full_rel_bf16"] = decode_vs_full(torch, cfg, model, decode_batch, n_prefix, steps, dec_routes,
                                                    fp32_oracle=True)
    # the same decode against the bf16 einsum forward, reported: the attention rounded at other places
    ein_routes = {} if cfg.moe.enabled else None
    out["decode_vs_einsum_full_rel_bf16"] = decode_vs_full(torch, cfg, model, decode_batch, n_prefix, steps,
                                                           ein_routes)
    if ein_routes is not None:
        out["decode_vs_einsum_full_rel_bf16_shared_routes"] = ein_routes["rel_shared"]
    if hold_bf16:
        for k in ("prefill_flash_vs_einsum_rel_bf16", "decode_vs_full_rel_bf16"):
            checks.append((out[k] <= 5e-2, f"{k}: {out[k]} <= 5e-2"))
    if cfg.moe.enabled:  # the routing's part: the same checks with one run's expert choices imposed on the other
        out["prefill_routes_flash_vs_einsum_bf16"] = route_flips(torch, r_flash, r_ein.calls)
        with MoERoutes(torch, impose=lambda i: r_ein.calls[i]):
            l_shared, _ = api.prefill(cfg, model, batch, max_len=max_len)
        out["prefill_flash_vs_einsum_rel_bf16_shared_routes"] = rel_err(l_shared, l_ein16)
        out["residual_rel_bf16_shared_routes"] = residual_rels(torch, cfg, model, batch)
        out["decode_routes_vs_full_bf16"] = dec_routes
        out["decode_vs_full_rel_bf16_shared_routes"] = dec_routes["rel_shared"]
        k = "decode_vs_full_rel_bf16_shared_routes"
        checks.append((out[k] <= 5e-2, f"{k}: {out[k]} <= 5e-2"))
    if model32 is not None:
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        fa.flash_attention.launches = 0  # the fp32 kernel's launches in one prefill, for the kernels line
        l32_flash, _ = api.prefill(cfg32, model32, batch, max_len=max_len)
        out["fp32_prefill_flash_launches"] = fa.flash_attention.launches
        l32_ein, _ = api.prefill(cfg32.replace(attn_impl="einsum"), model32, batch, max_len=max_len)
        out["prefill_flash_vs_einsum_rel_fp32"] = rel_err(l32_flash, l32_ein)
        out["model_bf16_vs_fp32_rel"] = rel_err(l_ein16, l32_ein)
        out["decode_vs_full_rel_fp32"] = decode_vs_full(torch, cfg32, model32, decode_batch, n_prefix, steps)
        if cfg.moe.enabled:
            out["residual_rel_fp32_shared_routes"] = residual_rels(torch, cfg32, model32, batch)
        checks.append((out["prefill_flash_vs_einsum_rel_fp32"] <= 1e-3,
                       f"fp32 copy, flash vs einsum last logits: {out['prefill_flash_vs_einsum_rel_fp32']} <= 1e-3"))
        checks.append((out["decode_vs_full_rel_fp32"] <= 5e-2,
                       f"fp32 copy, decode vs the full forward: {out['decode_vs_full_rel_fp32']} <= 5e-2"))
    return out, checks


def batch_route_flips(torch, cfg, model, a, b, max_len: int) -> dict:
    """Prompt ``a`` prefilled alone and beside ``b`` (of its length) in a
    batch of two: how many of ``a``'s top-k choices differ between the two
    (:func:`route_flips`), its last logits' relative difference, and that
    difference again with each prompt's lone choices imposed on the batch."""
    import numpy as np

    from repro_torch.models import api

    lone = {}
    for name, p in (("a", a), ("b", b)):
        with MoERoutes(torch) as lone[name]:
            logits, _ = api.prefill(cfg, model, {"tokens": p[None]}, max_len=max_len)
        if name == "a":
            l_alone = logits
    pair = {"tokens": torch.as_tensor(np.stack([a, b]), device="cuda")}
    with MoERoutes(torch) as batched:
        l_pair, _ = api.prefill(cfg, model, pair, max_len=max_len)
    n = len(a)
    mine = MoERoutes(torch)
    mine.calls, mine.gaps = [c[:n] for c in batched.calls], [g[:n] for g in batched.gaps]
    both = lambda i: torch.cat([lone["a"].calls[i], lone["b"].calls[i]])
    with MoERoutes(torch, impose=both):
        l_shared, _ = api.prefill(cfg, model, pair, max_len=max_len)
    return dict(route_flips(torch, mine, lone["a"].calls), rel=rel_err(l_pair[:1], l_alone),
                rel_shared=rel_err(l_shared[:1], l_alone))


def alone_divergences(torch, cfg, model, reqs, max_len: int) -> list:
    """Each served request decoded alone (batch of one): where its greedy
    tokens first leave the batched engine's, with the lone run's top-2
    margin there and one bf16 step of its top logit."""
    out = []
    for r in reqs:
        alone, margins = greedy_alone(torch, cfg, model, r.prompt, len(r.out_tokens), max_len)
        i = next((j for j, (a, b) in enumerate(zip(alone, r.out_tokens)) if a != b), None)
        if i is not None:
            out.append(dict(rid=r.rid, step=i, margin=margins[i][0], bf16_step=bf16_step(margins[i][1])))
    return out


def zoo_granite(torch, smi: str) -> tuple:
    """(a) full-width granite-moe-1b-a400m behind ServeEngine: the serve
    phase's traffic, flash on every prefill; then the same traffic on an
    fp32 copy of the weights (the fp32 kernel on every prefill) for the
    batch-independence check."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("granite-moe-1b-a400m").replace(attn_impl="flash")
    sizes = zoo_bytes(torch, cfg)
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (FLASH_SERVE_S[i % len(FLASH_SERVE_S)],)) for i in range(8)]
    for p in prompts[: len(FLASH_SERVE_S)]:  # warm-up outside the counted run
        api.prefill(cfg, model, {"tokens": p[None]}, max_len=512)
    run = zoo_serve(torch, cfg, model, prompts, max_batch=4, max_len=512, max_new=16)
    checks = [(run["launches"] == len(prompts) * cfg.n_layers,
               f"granite: flash launches {run['launches']} == {len(prompts)} prefills x {cfg.n_layers} layers")]

    model32 = copy.deepcopy(model).float()  # the same weights, widened
    r0 = run["reqs"][2]  # 384 tokens
    seq = np.concatenate([r0.prompt, np.asarray(r0.out_tokens[:8])])[None]
    routes, more = route_checks(torch, cfg, model, {"tokens": r0.prompt[None]}, {"tokens": seq}, len(r0.prompt), 8,
                                512, model32=model32)
    checks += more

    # dropless eval capacity: a token's output does not depend on its batch,
    # so each request served alone gives the batched engine's tokens, up to
    # a top-2 tie within one bf16 step. Held on the fp32 copy; in bf16 the
    # batch size changes the products' rounding, which can flip a routed
    # expert (reported, with a prompt's choices alone and in a batch of two)
    div16 = alone_divergences(torch, cfg, model, run["reqs"], 512)
    batch_routes = batch_route_flips(torch, cfg, model, prompts[2], prompts[5], 512)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    run32 = zoo_serve(torch, cfg32, model32, prompts, max_batch=4, max_len=512, max_new=16)
    div32 = alone_divergences(torch, cfg32, model32, run32["reqs"], 512)
    checks += [(d["margin"] <= d["bf16_step"], f"granite fp32: a request leaves its lone run at a clear margin: {d}")
               for d in div32]

    cache = api.init_cache(cfg, 4, 512, "cuda")
    tok = torch.zeros(4, dtype=torch.long, device="cuda")
    pos = torch.full((4,), 400, dtype=torch.long, device="cuda")
    decode_ms = host_ms(torch, lambda: api.decode_step(cfg, model, cache, tok, pos))
    kv_bytes = sum(t.numel() * t.element_size() for g in cache for e in g for t in e)
    decode_bound_ms = (sizes["weight_bytes"] + kv_bytes) / HW.HBM_BW * 1e3  # dropless: every expert is read
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, experts=cfg.moe.n_experts,
               top_k=cfg.moe.top_k, **sizes, **run["stats"], flash_launches=run["launches"], **routes,
               alone_divergences_bf16=div16, batch_routes_bf16=batch_routes, alone_divergences_fp32=div32, fp32_run=run32["stats"],
               fp32_flash_launches=run32["launches"], decode_step_host_ms=decode_ms,
               decode_step_bound_ms=decode_bound_ms, nvidia_smi=smi)
    return out, checks


def zoo_gemma3(torch, smi: str) -> tuple:
    """(b) full-width gemma3-4b behind ServeEngine: 1152- and 640-token
    prompts, the 1152-token ones wrapping the local layers' 1024-slot
    rings; flash (hd 256) on the global layers' prefills only."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.transformer import layer_groups

    cfg = get_config("gemma3-4b").replace(attn_impl="flash")
    n_global = sum(reps * sum(s.window == 0 for s in pat) for pat, reps in layer_groups(cfg))
    checks = [(n_global == 5 and cfg.resolved_head_dim == 256, f"gemma3: 5 global layers of hd 256, got {n_global}")]
    sizes = zoo_bytes(torch, cfg)
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)) for n in ZOO_GEMMA_S]
    fa.flash_attention.launches = 0
    api.prefill(cfg, model, {"tokens": prompts[0][None]}, max_len=ZOO_GEMMA_MAX_LEN)  # also the warm-up
    torch.cuda.synchronize()
    per_prefill = fa.flash_attention.launches
    checks.append((per_prefill == n_global, f"gemma3: {per_prefill} flash launches in one prefill == {n_global}"))
    run = zoo_serve(torch, cfg, model, prompts, max_batch=2, max_len=ZOO_GEMMA_MAX_LEN, max_new=16)
    checks.append((run["launches"] == n_global * len(prompts),
                   f"gemma3: flash launches {run['launches']} == {len(prompts)} prefills x {n_global} global layers"))
    r0 = run["reqs"][0]
    checks.append((len(r0.prompt) > cfg.sliding_window, "gemma3: the first prompt wraps the local rings"))
    seq = np.concatenate([r0.prompt, np.asarray(r0.out_tokens[:8])])[None]
    model32 = copy.deepcopy(model).float()  # the same weights, widened
    routes, more = route_checks(torch, cfg, model, {"tokens": r0.prompt[None]}, {"tokens": seq}, len(r0.prompt), 8,
                                ZOO_GEMMA_MAX_LEN, model32=model32, hold_bf16=True)
    checks += more
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, head_dim=cfg.resolved_head_dim,
               window=cfg.sliding_window, global_layers=n_global, **sizes, **run["stats"],
               flash_launches=run["launches"], flash_launches_per_prefill=per_prefill, **routes, nvidia_smi=smi)
    return out, checks


def zoo_phi3(torch, smi: str) -> tuple:
    """(c) full-width phi-3-vision-4.2b through ``api.prefill`` and
    ``api.decode_step``: 576 image rows (seeded normal) + 192 text tokens,
    flash (hd 96) on every layer of the prefill, then 8 greedy decode steps."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api

    cfg = get_config("phi-3-vision-4.2b").replace(attn_impl="flash")
    n_img, n_text, steps = cfg.n_img_tokens, ZOO_PHI_TEXT, ZOO_PHI_STEPS
    sizes = zoo_bytes(torch, cfg)
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((1, n_img, cfg.d_model)).astype(np.float32)).cuda()
    text = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n_text))).cuda()
    batch = {"tokens": text, "img_embeds": img}
    max_len = n_img + n_text + steps
    api.prefill(cfg, model, batch, max_len=max_len)  # warm-up
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, model, batch, max_len=max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    checks = [(launches == cfg.n_layers, f"phi-3: flash launches {launches} == {cfg.n_layers} layers")]
    gen = []
    t0 = time.perf_counter()
    for i in range(steps):
        gen.append(int(torch.argmax(logits[0])))
        pos = torch.tensor([n_img + n_text + i], device="cuda")
        logits, cache = api.decode_step(cfg, model, cache, torch.tensor([gen[-1]], device="cuda"), pos)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    checks.append((bool(torch.isfinite(logits).all()) and logits.shape == (1, cfg.vocab),
                   "phi-3: finite (1, vocab) logits"))
    del cache
    seq = torch.cat([text, torch.tensor([gen], device="cuda")], dim=1)
    model32 = copy.deepcopy(model).float()  # the same weights, widened
    routes, more = route_checks(torch, cfg, model, batch, {"tokens": seq, "img_embeds": img}, n_text, steps, max_len,
                                model32=model32, hold_bf16=True)
    checks += more
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, head_dim=cfg.resolved_head_dim,
               img_tokens=n_img, text_tokens=n_text, decode_steps=steps, **sizes, flash_launches=launches,
               prefill_host_s=prefill_s, decode_host_s=decode_s, **routes, nvidia_smi=smi)
    return out, checks


def zoo_deepseek(torch, smi: str) -> tuple:
    """(d) deepseek-v3-671b at the published widths, cut to 4 layers (its 3
    dense layers and 1 MoE layer of 256 experts) and no MTP module: two
    128-token prompts, then 8 decode steps through the absorbed latent cache."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("deepseek-v3-671b").replace(n_layers=ZOO_DEEPSEEK_LAYERS, mtp_depth=0)
    sizes = zoo_bytes(torch, cfg)
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    B, S, steps = ZOO_DEEPSEEK_BATCH, ZOO_DEEPSEEK_S, ZOO_DEEPSEEK_STEPS
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + steps))).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, model, {"tokens": tokens[:, :S]}, max_len=S + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    checks = [(tuple(cache[0][0][0].shape) == (cfg.moe.first_k_dense, B, S + steps, cfg.mla.kv_lora_rank),
               "deepseek: the dense layers' latent cache rows"),
              (bool(torch.isfinite(logits).all()), "deepseek: finite prefill logits")]
    del logits, cache
    routes = {}
    dec16 = decode_vs_full(torch, cfg, model, {"tokens": tokens}, S, steps, routes)  # reported (see route_checks)
    checks.append((routes["rel_shared"] <= 5e-2, f"deepseek bf16, absorbed decode vs the full forward with the "
                   f"full forward's expert choices imposed: rel {routes['rel_shared']} <= 5e-2"))
    cache = api.init_cache(cfg, B, S + steps, "cuda")
    tok = torch.zeros(B, dtype=torch.long, device="cuda")
    pos = torch.full((B,), S, dtype=torch.long, device="cuda")
    decode_ms = host_ms(torch, lambda: api.decode_step(cfg, model, cache, tok, pos), reps=3)
    kv_bytes = sum(t.numel() * t.element_size() for g in cache for e in g for t in e)
    del cache
    # the same weights widened to fp32 in place, one tensor at a time (60 GB:
    # a copy beside the bf16 model would not fit), for the held check
    for q in model.parameters():
        q.data = q.data.float()
        release(torch)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    dec32 = decode_vs_full(torch, cfg32, model, {"tokens": tokens}, S, steps)
    tol = 5e-2
    checks.append((dec32 <= tol, f"deepseek fp32 copy, absorbed decode vs the full forward: rel {dec32} <= {tol}"))
    out = dict(arch=cfg.name, reduced=dict(n_layers=f"61 -> {cfg.n_layers}", mtp_depth="1 -> 0"),
               n_layers=cfg.n_layers, d_model=cfg.d_model, heads=cfg.n_heads, experts=cfg.moe.n_experts, **sizes,
               batch=B, prompt_len=S, decode_steps=steps, prefill_host_s=prefill_s, decode_vs_full_rel_bf16=dec16,
               decode_routes_vs_full_bf16=routes, decode_vs_full_rel_fp32=dec32, tol=tol, decode_step_host_ms=decode_ms,
               decode_step_bound_ms=(sizes["weight_bytes"] + kv_bytes) / HW.HBM_BW * 1e3,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)
    return out, checks


def phase_zoo(torch, smi: str) -> dict:
    """The rest of the transformer zoo at published widths, one model at a
    time: (a) granite MoE served, (b) gemma3 local/global served, (c) the
    phi-3 VLM prefix, (d) deepseek MLA + MoE at 4 layers. Each part's line
    is printed before its checks are applied."""
    t0 = time.perf_counter()
    parts, failed = {}, []
    for name, fn in (("granite", zoo_granite), ("gemma3", zoo_gemma3), ("phi3", zoo_phi3), ("deepseek", zoo_deepseek)):
        release(torch)  # the previous model went with its part's frame
        t = time.perf_counter()
        parts[name], checks = fn(torch, smi)
        parts[name]["part_host_s"] = time.perf_counter() - t
        emit("zoo", part=name, **parts[name], checks_failed=[w for ok, w in checks if not ok])
        failed += [f"{name}: {w}" for ok, w in checks if not ok]
    launches = {k: parts[k]["flash_launches"] for k in ("granite", "gemma3", "phi3")}
    launches["granite_fp32"] = parts["granite"]["fp32_flash_launches"]
    fp32_check = {k: parts[k]["fp32_prefill_flash_launches"] for k in ("phi3", "gemma3")}
    emit("zoo", part="summary", flash_launches=launches, fp32_check_prefill_flash_launches=fp32_check,
         phase_host_s=time.perf_counter() - t0, nvidia_smi=smi)
    check(not failed, f"zoo: {failed}")
    return dict(flash_launches=launches, fp32_check_launches=fp32_check)


def jamba_attn_rel(torch, cfg, model, batch) -> float:
    """The attention layer's output (``wo`` included), flash against einsum
    on the same input: the layer input of one einsum forward of the layers
    before it."""
    from repro_torch.models.common import apply_norm, embed, gqa_attention_full

    ein = cfg.replace(attn_impl="einsum")
    with torch.no_grad():
        tokens = torch.as_tensor(batch["tokens"], device="cuda").long()
        x = embed(ein, model.embed, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device="cuda").expand(B, S)
        for layer in model.blocks[0]:
            if layer.kind[0] == "attn":
                h = apply_norm(ein, layer.ln1, x)
                a_f, _ = gqa_attention_full(cfg, layer.mixer, h, positions, theta=cfg.rope_theta)
                a_e, _ = gqa_attention_full(ein, layer.mixer, h, positions, theta=cfg.rope_theta)
                return rel_err(a_f, a_e)
            x, _, _ = layer.apply_full(ein, x, positions, None)
    raise AssertionError("no attention layer in the first period")


def zoo2_jamba(torch, smi: str) -> tuple:
    """(a) jamba-v0.1-52b at its published widths cut to one period (7
    Mamba + 1 attention layers, 4 MoE + 4 dense FFNs) behind ServeEngine:
    serve's traffic, flash on the attention layer of every prefill. Then
    the same weights widened to fp32 in place (the bf16 model goes tensor by
    tensor: the two together would not fit) for the held whole-model checks
    and the same traffic again, each request against its lone run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.jamba import block_layout
    from repro_torch.serving.paged_kv import cache_leaves

    cfg = get_config("jamba-v0.1-52b").replace(n_layers=ZOO2_JAMBA_LAYERS, attn_impl="flash")
    layout = block_layout(cfg)
    n_attn = sum(m == "attn" for m, _ in layout)
    checks = [(n_attn == 1 and sum(f == "moe" for _, f in layout) == 4 and cfg.resolved_head_dim == 128,
               f"jamba: one period of 1 attention layer (hd 128) and 4 MoE layers: {layout}")]
    sizes = zoo_bytes(torch, cfg)
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (FLASH_SERVE_S[i % len(FLASH_SERVE_S)],)) for i in range(8)]
    for p in prompts[: len(FLASH_SERVE_S)]:  # warm-up outside the counted run
        api.prefill(cfg, model, {"tokens": p[None]}, max_len=512)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.prefill(cfg, model, {"tokens": prompts[2][None]}, max_len=512)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    run = zoo_serve(torch, cfg, model, prompts, max_batch=4, max_len=512, max_new=ZOO2_NEW)
    checks.append((run["launches"] == len(prompts) * n_attn,
                   f"jamba: flash launches {run['launches']} == {len(prompts)} prefills x {n_attn} attention layer"))
    r0 = run["reqs"][2]  # 384 tokens
    batch = {"tokens": r0.prompt[None]}
    seq = {"tokens": np.concatenate([r0.prompt, np.asarray(r0.out_tokens[:8])])[None]}
    out = {"layer_attn_rel_bf16": jamba_attn_rel(torch, cfg, model, batch)}
    checks.append((out["layer_attn_rel_bf16"] <= 2e-2,
                   f"jamba: the attention layer, flash vs einsum in bf16: {out['layer_attn_rel_bf16']} <= 2e-2"))
    # bf16 whole-model readings, reported: a random router's near-uniform
    # choices flip under bf16 rounding (PERF.md section 6)
    ein = cfg.replace(attn_impl="einsum")
    with MoERoutes(torch) as r_flash:
        l_flash, _ = api.prefill(cfg, model, batch, max_len=512)
    with MoERoutes(torch) as r_ein:
        l_ein, _ = api.prefill(ein, model, batch, max_len=512)
    with MoERoutes(torch, impose=lambda i: r_ein.calls[i]):
        l_shared, _ = api.prefill(cfg, model, batch, max_len=512)
    out.update(prefill_flash_vs_einsum_rel_bf16=rel_err(l_flash, l_ein),
               prefill_routes_flash_vs_einsum_bf16=route_flips(torch, r_flash, r_ein.calls),
               prefill_flash_vs_einsum_rel_bf16_shared_routes=rel_err(l_shared, l_ein))
    dec_routes = {}
    out["decode_vs_full_rel_bf16"] = decode_vs_full(torch, cfg, model, seq, len(r0.prompt), 8, dec_routes)
    out["decode_routes_vs_full_bf16"] = dec_routes
    del l_flash, l_ein, l_shared
    cache = api.init_cache(cfg, 4, 512, "cuda")
    tok = torch.zeros(4, dtype=torch.long, device="cuda")
    pos = torch.full((4,), 400, dtype=torch.long, device="cuda")
    decode_ms = host_ms(torch, lambda: api.decode_step(cfg, model, cache, tok, pos))
    state_bytes = sum(t.numel() * t.element_size() for t in cache_leaves(cache))
    decode_bound_ms = (sizes["weight_bytes"] + state_bytes) / HW.HBM_BW * 1e3  # dropless: every expert is read
    del cache

    # the same weights widened to fp32 in place, one tensor at a time
    for q in model.parameters():
        q.data = q.data.float()
        release(torch)
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    l32_flash, _ = api.prefill(cfg32, model, batch, max_len=512)
    l32_ein, _ = api.prefill(cfg32.replace(attn_impl="einsum"), model, batch, max_len=512)
    out["prefill_flash_vs_einsum_rel_fp32"] = rel_err(l32_flash, l32_ein)
    out["decode_vs_full_rel_fp32"] = decode_vs_full(torch, cfg32, model, seq, len(r0.prompt), 8)
    checks.append((out["prefill_flash_vs_einsum_rel_fp32"] <= 1e-3,
                   f"jamba fp32 copy, flash vs einsum last logits: {out['prefill_flash_vs_einsum_rel_fp32']} <= 1e-3"))
    checks.append((out["decode_vs_full_rel_fp32"] <= 5e-2,
                   f"jamba fp32 copy, decode vs the full forward: {out['decode_vs_full_rel_fp32']} <= 5e-2"))
    run32 = zoo_serve(torch, cfg32, model, prompts, max_batch=4, max_len=512, max_new=ZOO2_NEW)
    div32 = alone_divergences(torch, cfg32, model, run32["reqs"], 512)
    checks += [(d["margin"] <= d["bf16_step"], f"jamba fp32: a request leaves its lone run at a clear margin: {d}")
               for d in div32]
    out = dict(arch=cfg.name, reduced=dict(n_layers=f"32 -> {cfg.n_layers}"), n_layers=cfg.n_layers,
               d_model=cfg.d_model, heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
               experts=cfg.moe.n_experts, top_k=cfg.moe.top_k, d_inner=cfg.ssm.d_inner(cfg.d_model), **sizes,
               **run["stats"], flash_launches=run["launches"], prefill_384_host_s=prefill_s, **out,
               alone_divergences_fp32=div32, fp32_run=run32["stats"], fp32_flash_launches=run32["launches"],
               decode_step_host_ms=decode_ms, decode_step_bound_ms=decode_bound_ms,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)
    return out, checks


def whisper_serve(torch, cfg, model, reqs, steps: int) -> tuple:
    """Each request (tokens (1, S), enc_frames (1, 1500, d)) prefilled and
    decoded ``steps - 1`` greedy steps through the api: its tokens, the
    logits of each decode step, and the host seconds."""
    from repro_torch.models import api

    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in reqs:
        S = batch["tokens"].shape[1]
        logits, cache = api.prefill(cfg, model, batch, max_len=S + steps)
        toks, step_logits = [int(torch.argmax(logits[0]))], []
        for i in range(steps - 1):
            pos = torch.tensor([S + i], device="cuda")
            logits, cache = api.decode_step(cfg, model, cache, torch.tensor([toks[-1]], device="cuda"), pos)
            step_logits.append(logits)
            toks.append(int(torch.argmax(logits[0])))
        outs.append((toks, torch.cat(step_logits)))
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def zoo2_whisper(torch, smi: str) -> tuple:
    """(b) whisper-tiny at its published widths (4 + 4 layers, d 384):
    4 requests, each of 1500 seeded-normal frames (the stub front end) and
    a decoder prompt, prefilled with flash (hd 64) on the decoder's
    self-attention and decoded through the api; each decode step held
    against the teacher-forced decoder over the same tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.common import logits_out
    from repro_torch.models.whisper import decode_full, encode
    from repro_torch.serving.paged_kv import cache_leaves

    cfg = get_config("whisper-tiny").replace(attn_impl="flash")
    sizes = zoo_bytes(torch, cfg)
    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    reqs = [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (1, n))).cuda(),
             "enc_frames": torch.from_numpy(rng.standard_normal((1, cfg.n_audio_ctx, cfg.d_model),
                                                                dtype=np.float32)).cuda()}
            for n in ZOO2_WHISPER_S]
    api.prefill(cfg, model, reqs[0], max_len=ZOO2_WHISPER_S[0] + ZOO2_NEW)  # warm-up
    torch.cuda.synchronize()
    fa.flash_attention.launches = 0
    outs, serve_s = whisper_serve(torch, cfg, model, reqs, ZOO2_NEW)
    launches = fa.flash_attention.launches
    checks = [(launches == len(reqs) * cfg.n_layers,
               f"whisper: flash launches {launches} == {len(reqs)} prefills x {cfg.n_layers} decoder layers"),
              (all(len(t) == ZOO2_NEW for t, _ in outs), f"whisper: every request has {ZOO2_NEW} tokens")]
    # each decode step against the teacher-forced decoder over prompt + the
    # tokens fed so far (einsum: S + 15 is not a multiple of 128)
    dvf = []
    with torch.no_grad():
        for batch, (toks, step_logits) in zip(reqs, outs):
            S = batch["tokens"].shape[1]
            seq = torch.cat([batch["tokens"], torch.tensor([toks[:-1]], device="cuda")], dim=1)
            x, _ = decode_full(cfg, model, seq, encode(cfg, model, batch["enc_frames"]))
            full = logits_out(cfg, model.embed, x[0, S:])
            dvf.append(rel_err(step_logits, full))
    checks.append((max(dvf) <= 5e-2, f"whisper bf16, decode vs the teacher-forced decoder: {dvf} <= 5e-2"))
    long = reqs[ZOO2_WHISPER_S.index(max(ZOO2_WHISPER_S))]
    ein = cfg.replace(attn_impl="einsum")
    l_flash, _ = api.prefill(cfg, model, long)
    l_ein, _ = api.prefill(ein, model, long)
    model32 = copy.deepcopy(model).float()
    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    l32_flash, _ = api.prefill(cfg32, model32, long)
    l32_ein, _ = api.prefill(cfg32.replace(attn_impl="einsum"), model32, long)
    rel16, rel32 = rel_err(l_flash, l_ein), rel_err(l32_flash, l32_ein)
    checks += [(rel16 <= 5e-2, f"whisper bf16, flash vs einsum last logits: {rel16} <= 5e-2"),
               (rel32 <= 1e-3, f"whisper fp32 copy, flash vs einsum last logits: {rel32} <= 1e-3")]
    checks.append((all(bool(torch.isfinite(sl).all()) for _, sl in outs), "whisper: finite decode logits"))
    S = max(ZOO2_WHISPER_S)
    _, cache = api.prefill(cfg, model, long, max_len=S + ZOO2_NEW)
    tok, pos = torch.tensor([0], device="cuda"), torch.tensor([S], device="cuda")
    decode_ms = host_ms(torch, lambda: api.decode_step(cfg, model, cache, tok, pos))
    state_bytes = sum(t.numel() * t.element_size() for t in cache_leaves(cache))
    out = dict(arch=cfg.name, enc_layers=cfg.n_enc_layers, dec_layers=cfg.n_layers, d_model=cfg.d_model,
               heads=cfg.n_heads, head_dim=cfg.resolved_head_dim, frames=cfg.n_audio_ctx, **sizes,
               requests=len(reqs), prompt_lens=list(ZOO2_WHISPER_S), new_tokens=ZOO2_NEW, serve_host_s=serve_s,
               tokens_per_s=len(reqs) * ZOO2_NEW / serve_s, flash_launches=launches, decode_vs_full_rel_bf16=dvf,
               prefill_flash_vs_einsum_rel_bf16=rel16, prefill_flash_vs_einsum_rel_fp32=rel32,
               decode_step_host_ms=decode_ms,
               decode_step_bound_ms=(sizes["weight_bytes"] + state_bytes) / HW.HBM_BW * 1e3, nvidia_smi=smi)
    return out, checks


def zoo2_train_one(torch, cfg, data_shape, lr: float) -> tuple:
    """``Trainer`` on ``cfg`` for ZOO2_TRAIN_STEPS steps: its losses, step
    host ms, peak memory, and the flash and WKV kernel launches in the run
    (none: training takes the einsum and per-token routes, as the
    reference's loss does)."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.adamw import AdamWConfig

    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, AdamWConfig(lr=lr, warmup_steps=1, total_steps=ZOO2_TRAIN_STEPS),
                 DataConfig(batch=data_shape[0], seq=data_shape[1]), autotune=False, seed=0)
    try:
        n_params = sum(p.numel() for p in tr.params.parameters())
        fa.flash_attention.launches = wk.wkv6.launches = 0
        t0 = time.perf_counter()
        hist = tr.run(ZOO2_TRAIN_STEPS, log_every=1)
        wall = time.perf_counter() - t0
        out = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params, batch=data_shape[0],
                   seq=data_shape[1], grad_accum=cfg.grad_accum, remat=cfg.remat, attn_impl=cfg.attn_impl,
                   losses=[float(l) for l in hist], wall_s=wall,
                   step_host_ms=statistics.median(tr.step_seconds[1:]) * 1e3,
                   flash_launches=fa.flash_attention.launches, wkv6_launches=wk.wkv6.launches,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        tr.close()
    name = cfg.name
    checks = [(len(hist) == ZOO2_TRAIN_STEPS and all(math.isfinite(l) for l in out["losses"]),
               f"{name}: finite losses {out['losses']}"),
              (out["losses"][-1] < out["losses"][0], f"{name}: the last loss is below the first: {out['losses']}"),
              (out["wkv6_launches"] == 0 and out["flash_launches"] == 0,
               f"{name}: no K2 or K3 launch under autograd: {out['flash_launches']}, {out['wkv6_launches']}")]
    return out, checks


def zoo2_train(torch, smi: str) -> tuple:
    """(c) training: whisper-tiny at its published widths and depth, and
    rwkv6-7b at its published widths cut to 4 of 32 layers (its fp32 master
    and AdamW moments at full depth would not fit one card), through
    ``Trainer``. rwkv6 trains with ``attn_impl="flash"``, so its K3 count
    shows that the loss takes the per-token route."""
    from repro_torch.configs import get_config

    whisper, c1 = zoo2_train_one(torch, get_config("whisper-tiny"), ZOO2_WHISPER_BATCH, 1e-3)
    release(torch)
    rcfg = get_config("rwkv6-7b").replace(n_layers=ZOO2_RWKV_LAYERS, attn_impl="flash")
    rwkv, c2 = zoo2_train_one(torch, rcfg, ZOO2_RWKV_BATCH, 1e-3)
    rwkv["reduced"] = dict(n_layers=f"32 -> {rcfg.n_layers}")
    return dict(whisper=whisper, rwkv=rwkv, nvidia_smi=smi), c1 + c2


def phase_zoo2(torch, smi: str) -> dict:
    """The rest of the model zoo at published widths, one model at a time:
    (a) jamba served at one period, (b) whisper-tiny through the api, (c)
    whisper-tiny and rwkv6-7b (4 layers) trained. Each part's line is
    printed before its checks are applied."""
    t0 = time.perf_counter()
    parts, failed = {}, []
    for name, fn in (("jamba", zoo2_jamba), ("whisper", zoo2_whisper), ("train", zoo2_train)):
        release(torch)  # the previous model went with its part's frame
        t = time.perf_counter()
        parts[name], checks = fn(torch, smi)
        parts[name]["part_host_s"] = time.perf_counter() - t
        emit("zoo2", part=name, **parts[name], checks_failed=[w for ok, w in checks if not ok])
        failed += [f"{name}: {w}" for ok, w in checks if not ok]
    launches = dict(jamba=parts["jamba"]["flash_launches"], jamba_fp32=parts["jamba"]["fp32_flash_launches"],
                    whisper=parts["whisper"]["flash_launches"])
    emit("zoo2", part="summary", flash_launches=launches, phase_host_s=time.perf_counter() - t0, nvidia_smi=smi)
    check(not failed, f"zoo2: {failed}")
    return dict(flash_launches=launches)


# ----------------------------------------------------------------------
# the sharded_zoo phase
# ----------------------------------------------------------------------


class RankRoutes:
    """Records the expert choices ``torch.topk`` makes inside a mesh
    region, per mesh position in call order (a ``remat`` recompute runs
    outside the region and is not recorded)."""

    def __init__(self, torch):
        self.torch, self.calls = torch, {}

    def __enter__(self):
        from repro_torch.core.mesh import current_region

        orig = self.orig = self.torch.topk

        def topk(probs, k, dim=-1):
            v, idx = orig(probs, k, dim=dim)
            region = current_region()
            if region is not None:  # kept on the card: a host copy would sync the rank
                self.calls.setdefault(region.slot, []).append(idx.detach())
            return v, idx

        self.torch.topk = topk
        return self

    def __exit__(self, *exc):
        self.torch.topk = self.orig


class LogBytes:
    """While open, tallies the bytes of the collective results that the
    remat policy's logs keep alive for the recompute (``models.tp.remat``):
    each layer's log, summed over the ranks and the microbatches. The
    reference's ``"full"`` policy re-runs its collectives instead."""

    def __init__(self):
        self.total, self._lock = 0, threading.Lock()

    def __enter__(self):
        from repro_torch.core.collectives import CollectiveLog
        from repro_torch.core.mesh import current_region
        from repro_torch.models import tp

        tally = self

        class Tallied(CollectiveLog):
            @contextlib.contextmanager
            def scope(self):
                recording = current_region() is not None
                with super().scope():
                    yield self
                if recording:
                    n = sum(r.numel() * r.element_size() for r in self.results)
                    with tally._lock:
                        tally.total += n

        self.tp, self.orig = tp, tp.CollectiveLog
        tp.CollectiveLog = Tallied
        return self

    def __exit__(self, *exc):
        self.tp.CollectiveLog = self.orig


def sz_microbatches(cfg, batch):
    return [{k: v[i * len(v) // cfg.grad_accum:(i + 1) * len(v) // cfg.grad_accum] for k, v in batch.items()}
            for i in range(cfg.grad_accum)]


def sz_single_routing(torch, cfg, model, batch) -> dict:
    """The single-rank loss's routing, microbatch by microbatch, without
    grad (nothing recomputed): per MoE layer the choices (host), the
    dropped choices summed over the microbatches, and the mean aux."""
    from repro_torch.models import api, moe

    drops, aux = [], []
    moe.observers.append(lambda d: drops.append(int(d)))
    with torch.no_grad(), MoERoutes(torch) as routes:
        try:
            for mb in sz_microbatches(cfg, batch):
                aux.append(api.loss_fn(cfg, model, mb)[1]["aux"].item())
        finally:
            moe.observers.pop()
    calls = [c.cpu() for c in routes.calls]
    per_mb = len(calls) // cfg.grad_accum
    dropped = [sum(drops[m * per_mb + l] for m in range(cfg.grad_accum)) for l in range(per_mb)]
    return dict(calls=calls, dropped=dropped, aux=sum(aux) / len(aux))


def sz_flips(single_calls: list, ranks: RankRoutes, mesh, n_layers: int) -> list:
    """Per MoE layer, the (token, choice set)s of the single-rank run that
    differ from the sharded run's, summed over the microbatches: the
    sharded run's computing ranks' calls put back in row order."""
    computing = sorted(s for s in ranks.calls if all(c == 0 for a, c in mesh.coords(s).items()
                                                     if a not in ("pod", "data")))
    flips = [0] * n_layers
    for i, one in enumerate(single_calls):
        got = ranks.torch.cat([ranks.calls[s][i].cpu() for s in computing])
        flips[i % n_layers] += int((got.sort(-1).values != one.sort(-1).values).any(-1).sum())
    return flips


def sz_state(torch, cfg, opt_cfg, mesh, weights: dict, batch):
    """The sharded params and AdamW state of ``weights`` (name → tensor),
    laid out by train_shardings."""
    from repro_torch.core.mesh import device_put
    from repro_torch.launch.train import named, train_shardings
    from repro_torch.models import api
    from repro_torch.optim.adamw import adamw_init

    pspecs, ospecs, _, _ = train_shardings(cfg, opt_cfg, mesh, api.abstract_params(cfg), batch)
    start = {n: w.to("cuda") for n, w in weights.items()}
    params = device_put(start, named(mesh, pspecs))
    opt = device_put(adamw_init(opt_cfg, start), named(mesh, ospecs))
    return params, opt


def sz_opt_cfg(cfg, master: bool = False):
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(lr=SZ_LR, warmup_steps=0, total_steps=10, master=master,
                       moments_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else "float32")


def sz_single(torch, cfg, weights: dict, batch, master: bool = False) -> dict:
    """The single-rank train step (and, with MoE, its routing), its results
    kept on the host and its state released: the loss, host ms, peak and
    the updated params."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import api
    from repro_torch.optim.adamw import adamw_init

    opt_cfg = sz_opt_cfg(cfg, master)
    out = {}
    model = api.model_class(cfg)(cfg, torch.device("cuda"))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    model.requires_grad_(True)
    if cfg.moe.enabled:
        out["single_routing"] = sz_single_routing(torch, cfg, model, batch)
    state = adamw_init(opt_cfg, dict(model.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, m1 = make_train_step(cfg, opt_cfg)(model, state, batch)
    torch.cuda.synchronize()
    out.update(single_loss=m1["loss"].item(), single_step_host_ms=(time.perf_counter() - t0) * 1e3,
               single_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               single_params={n: p.detach().cpu() for n, p in model.named_parameters()})
    del model, state, m1
    release(torch)
    return out


def sz_collectives(by_axes: dict) -> dict:
    """A step's collectives of mesh position 0 by kind and comm axes."""
    return {f"{op}@{','.join(axes)}": n for (op, axes), n in sorted(by_axes.items())}


def sz_predicted(cfg, pspecs: dict, counts_dispatch: bool) -> dict:
    """The design's count of the step's collectives over ``model`` (and
    ``moe_dispatch_sharding``'s over ``data``) at mesh position 0, per
    microbatch from the loss and its transposes (``models.tp``: each
    layer's attention and FFN outputs all-reduced, or under
    ``seq_shard_acts`` reduce-scattered with their inputs and the trunk's
    output all-gathered along S; the embedding's and the cross-entropy's
    all-reduces; the cross-entropy's maxima gathered; two all-to-alls a MoE
    layer under the dispatch hint, each with its transpose), plus the
    update's all-reduce of each leaf replicated over ``model``. Whisper's
    layers have two sublayers in the encoder and three in the decoder (its
    cross-attention), and neither hint changes it."""
    L, mb = cfg.n_layers, max(1, cfg.grad_accum)
    seq = cfg.seq_shard_acts and not cfg.encdec
    subs = 2 * cfg.n_enc_layers + 3 * L if cfg.encdec else 2 * L
    per = ({"all-gather": 2 * subs + 2, "reduce-scatter": 2 * subs + 1, "all-reduce": 4} if seq
           else {"all-gather": 1, "all-reduce": 2 * subs + 4})
    out = {f"{k}@model": mb * v for k, v in per.items()}
    out["all-reduce@model"] += sum(1 for spec in pspecs.values() if "model" not in spec.axes)
    if counts_dispatch:
        out["all-to-all@data"] = mb * 4 * (L if cfg.moe.enabled else 0)
    return out


def sz_sharded(torch, cfg, weights: dict, batch, routes: RankRoutes | None = None, master: bool = False,
               count: bool = False) -> dict:
    """The sharded step from ``weights``: the loss, metrics, host ms, peak
    memory, bytes per rank (params, and moments with master) and, with
    ``count``, its collectives by kind and axes; the sharded params left
    on the card."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.train import make_train_step
    from repro_torch.parallel.sharding import dp_axes

    opt_cfg = sz_opt_cfg(cfg, master)
    mesh = make_mesh(*SZ_MESH)
    params, opt = sz_state(torch, cfg, opt_cfg, mesh, weights, batch)
    release(torch)
    keys = [k for k in ("m", "v", "master") if k in opt]
    resident = [sum(st.resident_bytes(slot) for st in params.values()) for slot in range(mesh.size)]
    moments = [sum(st.resident_bytes(slot) for k in keys for st in opt[k].values()) for slot in range(mesh.size)]
    # the moments' bytes a rank had their stacking-dim layers been held by every dp rank (PR 22-23's layout)
    dropped = sum(next(b.numel() * b.element_size() for b in st.blocks if b is not None)
                  for k in keys for st in opt[k].values())
    step = make_train_step(cfg, opt_cfg, dp=dp_axes(mesh))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if routes is not None:
            stack.enter_context(routes)
        coll = stack.enter_context(rl.count_collectives()) if count else None
        logs = stack.enter_context(LogBytes())
        _, _, m = step(params, opt, batch)
        torch.cuda.synchronize()
    out = dict(opt=dict(moments_dtype=opt_cfg.moments_dtype, master=opt_cfg.master),
               loss=m["loss"].item(), step_host_ms=(time.perf_counter() - t0) * 1e3,
               step_peak_gb=torch.cuda.max_memory_allocated() / 1e9, param_bytes_per_rank=resident,
               moment_bytes_per_rank=moments, moment_bytes_per_rank_if_every_dp_rank_held_every_layer=dropped,
               remat_log_bytes_per_microbatch=logs.total // max(1, cfg.grad_accum),
               metrics={k: (v.tolist() if v.dim() else v.item()) for k, v in m.items()
                        if k in ("xent", "aux", "mtp", "moe_dropped")},
               params=params, mesh=mesh)
    if coll is not None:
        out["collectives"] = sz_collectives(coll.by_axes.get(0, {}))
    del opt
    return out


def sz_run(torch, cfg, weights: dict, batch, routes: RankRoutes | None = None, master: bool = False) -> dict:
    """The single-rank step, then the sharded step from the same weights
    (:func:`sz_single`, :func:`sz_sharded`), and the losses' gap."""
    out = sz_single(torch, cfg, weights, batch, master)
    out.update(sz_sharded(torch, cfg, weights, batch, routes, master))
    out["loss_rel_err"] = abs(out["loss"] - out["single_loss"]) / abs(out["single_loss"])
    return out


def sz_params_beyond_a_step(torch, sharded: dict, single: dict) -> tuple:
    """The sharded step's params against the single-rank step's, as the
    pipeline phase's (c) holds them (:func:`beyond_a_step`)."""
    return beyond_a_step(torch, ((sharded[n].gather(), w) for n, w in single.items()), SZ_LR)


def sz_batch(torch, cfg, shape, seed: int) -> dict:
    import numpy as np

    rng = np.random.default_rng(seed)
    B, S = shape
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))).cuda()}
    if cfg.vlm:
        batch["img_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model), dtype=np.float32)).cuda()
    if cfg.encdec:
        batch["enc_frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_audio_ctx, cfg.d_model), dtype=np.float32)).cuda()
    return batch


def sz_weights(torch, cfg, seed: int = 0) -> dict:
    """Random weights (the family's init, from a seed), on the host."""
    from repro_torch.models import api

    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    weights = {n: p.detach().cpu() for n, p in model.named_parameters()}
    del model
    release(torch)
    return weights


def sz_granite(torch, smi: str) -> tuple:
    """(a) granite-moe-1b-a400m at its published width, depth and training
    settings (bf16, grad_accum 4, remat full, capacity factor 1.25), AdamW
    with its fp32 master: the tensor-parallel sharded step against the
    single-rank step, its choice flips and drops, its peak beside the
    reckoning and its moments' bytes a rank beside the layout that held
    every layer's moments on every dp rank; the trained model's prefill
    with flash; then (a') the exact check on an fp32 copy of the same
    weights cut to SZ_GRANITE_FP32_LAYERS layers, run hint-free and under
    each layout hint, with one step's collectives by kind and axes beside
    the design's count."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.parallel.sharding import param_specs

    cfg = get_config("granite-moe-1b-a400m")
    weights = sz_weights(torch, cfg)
    n_params = sum(w.numel() for w in weights.values())
    batch = sz_batch(torch, cfg, SZ_GRANITE_BATCH, 11)
    routes = RankRoutes(torch)
    bf = sz_run(torch, cfg, weights, batch, routes, master=True)
    sr = bf.pop("single_routing")
    flips = sz_flips(sr["calls"], routes, bf["mesh"], cfg.n_layers)
    bf_off, bf_total, _ = sz_params_beyond_a_step(torch, bf["params"], bf.pop("single_params"))
    gb = 1e9
    reckoning = dict(pr23_peak_gb=SZ_GRANITE_PEAK_GB_PR23, moments_saved_gb=12 * n_params / gb,
                     master_added_gb=4 * n_params / gb,
                     expected_peak_gb=SZ_GRANITE_PEAK_GB_PR23 - 12 * n_params / gb + 4 * n_params / gb)
    # bf16: the loss only; the params' gap is printed, not held (a random
    # router's bf16 choices flip and the flips cascade, PERF.md §6, so half
    # the choice sets differ and the first AdamW step's signs with them);
    # the params are held on the fp32 copy below
    checks = [(math.isfinite(bf["loss"]) and bf["loss_rel_err"] <= 5e-2,
               f"granite bf16: sharded vs single-rank loss rel {bf['loss_rel_err']} <= 5e-2")]

    # the trained, gathered params serve one prefill with flash
    trained = TransformerLM(cfg, torch.device("cuda"))
    with torch.no_grad():
        for n, p in trained.named_parameters():
            p.copy_(bf["params"][n].gather())
    for k in ("params", "mesh"):
        bf.pop(k)
    release(torch)
    fcfg = cfg.replace(attn_impl="flash")
    import numpy as np

    pbatch = {"tokens": torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab, (1, SZ_PREFILL_S))).cuda()}
    fa.flash_attention.launches = 0
    logits, _ = api.prefill(fcfg, trained, pbatch)
    launches = fa.flash_attention.launches
    rels = layer_attn_rels(torch, fcfg, trained, pbatch)
    checks += [(launches == cfg.n_layers, f"granite trained prefill: flash launches {launches} == {cfg.n_layers}"),
               (bool(torch.isfinite(logits).all()), "granite trained prefill: finite logits"),
               (max(rels) <= 2e-2, f"granite trained prefill: every layer's attention flash vs einsum <= 2e-2: {rels}")]
    del trained, logits
    release(torch)

    # (a') the exact check: an fp32 copy of the same weights, cut in depth,
    # hint-free and under each layout hint
    c32 = cfg.replace(n_layers=SZ_GRANITE_FP32_LAYERS, param_dtype="float32", compute_dtype="float32")
    keep = {n for n, _ in api.abstract_params(c32).named_parameters()}
    w32 = {n: w.float() for n, w in weights.items() if n in keep}
    del weights
    single = sz_single(torch, c32, w32, batch)
    sr32 = single.pop("single_routing")
    pspecs = param_specs(c32, api.abstract_params(c32), make_mesh(*SZ_MESH))
    runs = {}
    for hint in ("none", "seq_shard_acts", "moe_dispatch_sharding"):
        c = c32 if hint == "none" else c32.replace(**{hint: True})
        r = sz_sharded(torch, c, w32, batch, count=True)
        if hint == "none":
            off, total, wild = sz_params_beyond_a_step(torch, r["params"], single["single_params"])
        r.pop("params")
        r.pop("mesh")
        release(torch)
        r["loss_rel_err"] = abs(r["loss"] - single["single_loss"]) / abs(single["single_loss"])
        r["predicted_collectives"] = sz_predicted(c, pspecs, hint == "moe_dispatch_sharding")
        runs[hint] = r
    single.pop("single_params")
    base = runs["none"]["loss"]
    for hint, r in runs.items():
        drops = r["metrics"]["moe_dropped"]
        aux_err = abs(r["metrics"]["aux"] - sr32["aux"])
        checks += [(math.isfinite(r["loss"]) and r["loss_rel_err"] <= 1e-4,
                    f"granite fp32 {hint}: sharded vs single-rank loss rel {r['loss_rel_err']} <= 1e-4"),
                   ([int(d) for d in drops] == sr32["dropped"] and sum(sr32["dropped"]) > 0,
                    f"granite fp32 {hint}: dropped choices per layer {drops} == single-rank {sr32['dropped']}, > 0"),
                   (aux_err <= 1e-6,
                    f"granite fp32 {hint}: aux {r['metrics']['aux']} vs {sr32['aux']}: {aux_err} <= 1e-6"),
                   (all(r["collectives"].get(k, 0) == v for k, v in r["predicted_collectives"].items()),
                    f"granite fp32 {hint}: collectives {r['collectives']} hold the design's "
                    f"{r['predicted_collectives']}")]
        if hint != "none":
            rel = abs(r["loss"] - base) / abs(base)
            r["loss_rel_to_hint_free"] = rel
            checks.append((rel <= 1e-6, f"granite fp32 {hint}: loss rel {rel} to the hint-free TP step <= 1e-6"))
    checks += [(off <= 0.01 * total and wild == 0,
                f"granite fp32: params beyond one bf16 step {off} of {total} (<= 1%), {wild} beyond 2 lr")]
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=n_params, batch=list(SZ_GRANITE_BATCH),
               grad_accum=cfg.grad_accum, remat=cfg.remat, capacity_factor=cfg.moe.capacity_factor, route="tp",
               bf16=dict(bf, params_beyond_one_bf16_step=bf_off, params_total=bf_total,
                         whole_layer_route_step_host_ms=SZ_WHOLE_LAYER_MS["granite"]),
               reckoning=reckoning, bf16_flips_per_layer=flips, bf16_flips=sum(flips),
               bf16_choices=sum(c.numel() for c in sr["calls"]) // cfg.moe.top_k,
               bf16_single_dropped=sr["dropped"], bf16_single_aux=sr["aux"],
               prefill=dict(S=SZ_PREFILL_S, flash_launches=launches, layer_attn_rels=rels),
               fp32=dict(single, n_layers=c32.n_layers, single_dropped=sr32["dropped"], single_aux=sr32["aux"],
                         runs=runs, params_beyond_one_bf16_step=off, params_total=total),
               reduced=dict(fp32_n_layers=f"24 -> {c32.n_layers}"), nvidia_smi=smi)
    return out, checks, launches


def sz_other(torch, name: str, cfg, shape, seed: int, smi: str) -> tuple:
    """(b) one more family: the tensor-parallel sharded step against the
    single-rank step (loss 1e-4), with the K2 and K3 launches of the run
    (none: training takes the einsum and per-token routes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk

    weights = sz_weights(torch, cfg, seed)
    batch = sz_batch(torch, cfg, shape, seed)
    fa.flash_attention.launches = wk.wkv6.launches = 0
    r = sz_run(torch, cfg, weights, batch)
    k2, k3 = fa.flash_attention.launches, wk.wkv6.launches
    for k in ("params", "single_params", "mesh"):
        r.pop(k)
    release(torch)
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, params=sum(w.numel() for w in weights.values()),
               batch=list(shape), grad_accum=cfg.grad_accum, remat=cfg.remat, attn_impl=cfg.attn_impl,
               route="tp", **r,
               whole_layer_route_step_host_ms=SZ_WHOLE_LAYER_MS[name], flash_launches=k2, wkv6_launches=k3,
               nvidia_smi=smi)
    checks = [(math.isfinite(r["loss"]) and r["loss_rel_err"] <= 1e-4,
               f"{name}: sharded vs single-rank loss rel {r['loss_rel_err']} <= 1e-4"),
              (k2 == 0 and k3 == 0, f"{name}: no K2 or K3 launch under autograd: {k2}, {k3}")]
    return out, checks


def sz_whisper(torch, smi: str) -> tuple:
    """(b) whisper-tiny whole at its published widths and training settings
    (4 + 4 layers, d 384, 6 heads, 1500 frames, bf16, grad_accum 2, remat
    full): the tensor-parallel sharded step hint-free and under each layout
    hint against the single-rank step (loss 1e-4; each hinted loss 1e-6 of
    the hint-free one, as neither hint changes Whisper), each step's
    collectives by kind and axes equal to the design's
    (:func:`sz_predicted`), no K2 or K3 launch; its host ms beside the
    gathered route's."""
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as wk
    from repro_torch.models import api
    from repro_torch.parallel.sharding import param_specs

    cfg = get_config("whisper-tiny")
    weights = sz_weights(torch, cfg, 23)
    batch = sz_batch(torch, cfg, SZ_WHISPER_BATCH, 23)
    pspecs = param_specs(cfg, api.abstract_params(cfg), make_mesh(*SZ_MESH))
    fa.flash_attention.launches = wk.wkv6.launches = 0
    single = sz_single(torch, cfg, weights, batch)
    single.pop("single_params")
    runs = {}
    for hint in ("none", "seq_shard_acts", "moe_dispatch_sharding"):
        c = cfg if hint == "none" else cfg.replace(**{hint: True})
        r = sz_sharded(torch, c, weights, batch, count=True)
        for k in ("params", "mesh"):
            r.pop(k)
        release(torch)
        r["loss_rel_err"] = abs(r["loss"] - single["single_loss"]) / abs(single["single_loss"])
        r["predicted_collectives"] = sz_predicted(c, pspecs, hint == "moe_dispatch_sharding")
        runs[hint] = r
    k2, k3 = fa.flash_attention.launches, wk.wkv6.launches
    base = runs["none"]["loss"]
    checks = [(k2 == 0 and k3 == 0, f"whisper: no K2 or K3 launch under autograd: {k2}, {k3}")]
    for hint, r in runs.items():
        checks += [(math.isfinite(r["loss"]) and r["loss_rel_err"] <= 1e-4,
                    f"whisper {hint}: sharded vs single-rank loss rel {r['loss_rel_err']} <= 1e-4"),
                   (all(r["collectives"].get(k, 0) == v for k, v in r["predicted_collectives"].items()),
                    f"whisper {hint}: collectives {r['collectives']} hold the design's "
                    f"{r['predicted_collectives']}")]
        if hint != "none":
            rel = abs(r["loss"] - base) / abs(base)
            r["loss_rel_to_hint_free"] = rel
            checks.append((rel <= 1e-6, f"whisper {hint}: loss rel {rel} to the hint-free TP step <= 1e-6"))
    out = dict(arch=cfg.name, n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers, d_model=cfg.d_model,
               params=sum(w.numel() for w in weights.values()), batch=list(SZ_WHISPER_BATCH),
               grad_accum=cfg.grad_accum, remat=cfg.remat, attn_impl=cfg.attn_impl, route="tp", **single,
               runs=runs, whole_layer_route_step_host_ms=SZ_WHOLE_LAYER_MS["whisper"],
               whole_layer_route_single_step_host_ms=SZ_WHISPER_SINGLE_MS_THEN, flash_launches=k2, wkv6_launches=k3,
               nvidia_smi=smi)
    return out, checks


def phase_sharded_zoo(torch, smi: str) -> dict:
    """The tensor-parallel sharded step for every family the card can hold
    twice: (a) granite-moe-1b-a400m whole with its fp32 master (its fp32
    copy cut in depth, hint-free and under each layout hint), (b)
    phi-3-vision, rwkv6-7b (cut in depth) and whisper-tiny (whole,
    hint-free and under each layout hint). deepseek-v3 and jamba stay on the CPU tests (their smallest
    slice at published width does not fit two training states). Each
    part's line is printed before its checks are applied."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    failed = []

    def done(name: str, out: dict, checks: list, t: float) -> None:
        out["part_host_s"] = time.perf_counter() - t
        emit("sharded_zoo", part=name, **out, checks_failed=[w for ok, w in checks if not ok])
        failed.extend(f"{name}: {w}" for ok, w in checks if not ok)

    release(torch)
    t = time.perf_counter()
    out, checks, launches = sz_granite(torch, smi)
    done("granite", out, checks, t)
    for name, arch, over, shape, seed in (("phi3", "phi-3-vision-4.2b", dict(n_layers=SZ_PHI_LAYERS), SZ_PHI_BATCH, 21),
                                          ("rwkv6", "rwkv6-7b", dict(n_layers=SZ_RWKV_LAYERS, attn_impl="flash"),
                                           SZ_RWKV_BATCH, 22)):
        release(torch)
        t = time.perf_counter()
        cfg = get_config(arch).replace(**over)
        out, checks = sz_other(torch, name, cfg, shape, seed, smi)
        if "n_layers" in over:
            out["reduced"] = dict(n_layers=f"{get_config(arch).n_layers} -> {cfg.n_layers}")
        done(name, out, checks, t)
    release(torch)
    t = time.perf_counter()
    out, checks = sz_whisper(torch, smi)
    done("whisper", out, checks, t)
    emit("sharded_zoo", part="summary", flash_launches=launches, phase_host_s=time.perf_counter() - t0,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)
    check(not failed, f"sharded_zoo: {failed}")
    return dict(flash_launches=launches)


# ----------------------------------------------------------------------
# the sharded_serve phase
# ----------------------------------------------------------------------


class ShardRoutes:
    """The MoE routers' top-k choices inside the sharded serve step's
    regions, held against the single-rank run's ``single`` calls (a
    :class:`MoERoutes` run over the same rows and steps): while open,
    ``torch.topk`` inside a region takes the rank's ``i``-th call as the
    single-rank run's ``i``-th, cut to the rank's dp rows. Per call, the
    (token, choice set)s that differ are counted on the ``model`` index 0
    ranks (every ``model`` rank routes alike), with the probability gap at
    each; with ``impose`` the rank takes the single-rank choices instead of
    its own."""

    def __init__(self, torch, mesh, B: int, single: list, impose: bool = False):
        self.torch, self.mesh, self.B, self.single, self.impose = torch, mesh, B, single, impose
        self.count, self.diffs, self.gaps = {}, {}, []

    def __enter__(self):
        from repro_torch.core.mesh import current_region
        from repro_torch.parallel.sharding import dp_axes

        orig = self.orig = self.torch.topk
        dp = dp_axes(self.mesh)
        n_dp = math.prod(self.mesh.shape[a] for a in dp)

        def topk(probs, k, dim=-1):
            region = current_region()
            if region is None:
                return orig(probs, k, dim=dim)
            v, idx = orig(probs, k, dim=dim)
            di = 0
            for a in dp:
                di = di * self.mesh.shape[a] + region.coords[a]
            i = self.count.get(region.slot, 0)
            self.count[region.slot] = i + 1
            rows = self.B // n_dp
            want = self.single[i].view(self.B, -1, k)[di * rows:(di + 1) * rows].reshape(-1, k)
            if region.coords["model"] == 0:
                flip = (idx.sort(-1).values != want.sort(-1).values).any(-1)
                top = orig(probs, k + 1, dim=dim).values
                self.diffs.setdefault(i, []).append(flip.sum())
                self.gaps.append(self.torch.where(flip, top[:, k - 1] - top[:, k], self.torch.zeros_like(top[:, k])).max())
            if self.impose:
                return probs.gather(-1, want), want
            return v, idx

        self.torch.topk = topk
        return self

    def __exit__(self, *exc):
        self.torch.topk = self.orig

    def flips(self) -> list:
        """The differing (token, choice set)s per call, summed over the ranks."""
        return [int(sum(int(d) for d in self.diffs[i])) for i in sorted(self.diffs)]

    def flipped_gap_max(self) -> float:
        """The largest gap between the k-th and (k+1)-th router probability
        of the rank's own choices where they differ from the single-rank
        run's (0 without a flip): how near a tie every flip was."""
        return max([g.item() for g in self.gaps], default=0.0)


def ss_single(torch, cfg, model, batch: dict, steps: int, routes: bool):
    """The single-rank oracle: make_prefill_step then ``steps`` greedy
    make_serve_step calls on ``model``; per step the logits, their top-2
    values and the token (host), the final cache (host), host ms of the
    prefill and the median decode step, and the routers' choices (kept on
    the card) with ``routes``."""
    from repro_torch.launch.train import make_prefill_step, make_serve_step

    serve = make_serve_step(cfg)
    hook = MoERoutes(torch) if routes else contextlib.nullcontext()
    out = dict(logits=[], top2=[], tokens=[])
    B, S = batch["tokens"].shape
    with torch.no_grad(), hook:
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = make_prefill_step(cfg)(model, batch, SS_MAX_LEN)
        torch.cuda.synchronize()
        out["prefill_host_ms"] = (time.perf_counter() - t) * 1e3
        times = []
        for i in range(steps + 1):
            out["logits"].append(logits.float().cpu())
            out["top2"].append(logits.float().topk(2).values.cpu())  # the method: MoERoutes wraps torch.topk
            tok = torch.argmax(logits, -1)
            out["tokens"].append(tok.cpu())
            if i == steps:
                break
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = serve(model, cache, tok, torch.full((B,), S + i, device="cuda"))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    out["decode_host_ms"] = statistics.median(times)
    out["cache"] = [t.cpu() for g in cache for e in g for t in e]
    out["calls"] = hook.calls if routes else None
    return out


def ss_weights(torch, cfg) -> dict:
    """Random weights of ``cfg`` from seed 0, on the card (name → tensor)."""
    from repro_torch.models import api

    model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    return {n: p.detach() for n, p in model.named_parameters()}


def ss_model(torch, cfg, weights: dict):
    from repro_torch.models import api

    model = api.model_class(cfg)(cfg, torch.device("cuda"))
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])
    return model


def ss_sharded(torch, cfg, weights: dict, batch: dict, steps: int, forced=None, routes=None) -> dict:
    """The sharded prefill and ``steps`` sharded decode steps on the (2, 4)
    mesh, greedy on their own tokens, or on ``forced`` (the single-rank
    run's) when given: per step the logits and tokens (host), the K2
    launches of the prefill and of the decode steps, host ms, the
    collectives of one decode step by kind (busiest rank), per-rank param
    and cache bytes, the block shapes against ``cache_specs`` and the
    cache (the ShardedTensors)."""
    from repro_torch.core.mesh import NamedSharding, device_put, make_mesh
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.train import make_prefill_step, make_serve_step, named
    from repro_torch.models import api
    from repro_torch.parallel import sharding as shd

    mesh = make_mesh(*SS_MESH)
    params = device_put(weights, named(mesh, shd.param_specs(cfg, api.abstract_params(cfg), mesh)))
    serve = make_serve_step(cfg)
    B, S = batch["tokens"].shape
    out = dict(logits=[], tokens=[])
    hook = routes if routes is not None else contextlib.nullcontext()
    with hook:
        torch.cuda.synchronize()
        fa.flash_attention.launches = 0
        t = time.perf_counter()
        logits, cache = make_prefill_step(cfg)(params, batch, SS_MAX_LEN)
        torch.cuda.synchronize()
        out["prefill_host_ms"] = (time.perf_counter() - t) * 1e3
        out["prefill_k2_launches"] = fa.flash_attention.launches
        fa.flash_attention.launches = 0
        times, coll = [], None
        for i in range(steps + 1):
            out["logits"].append(logits.float().cpu())
            tok = torch.argmax(logits, -1)
            out["tokens"].append(tok.cpu())
            if i == steps:
                break
            feed = forced[i].cuda() if forced is not None else tok
            pos = torch.full((B,), S + i, device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i == 1:
                with rl.count_collectives() as c:
                    logits, cache = serve(params, cache, feed, pos)
                coll = c.per_chip().per_op_count
            else:
                logits, cache = serve(params, cache, feed, pos)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out["decode_k2_launches"] = fa.flash_attention.launches
    leaves = [t for g in cache for e in g for t in e]
    cspecs = shd.cache_specs(cfg, api.init_cache(cfg, B, SS_MAX_LEN, device="meta"), mesh)
    want = [NamedSharding(mesh, s) for g in cspecs for e in g for s in e]
    out.update(decode_host_ms=statistics.median(times), decode_collectives={k: int(v) for k, v in coll.items()},
               param_bytes_per_rank=sum(st.resident_bytes(0) for st in params.values()),
               cache_bytes_per_rank=sum(st.resident_bytes(0) for st in leaves),
               block_shapes_ok=all(tuple(b.shape) == tuple(s.stop - s.start for s in ws.index(slot, st.shape))
                                   for st, ws in zip(leaves, want) for slot, b in enumerate(st.blocks)),
               block_shape=list(leaves[0].blocks[0].shape), cache=leaves, params=params, mesh=mesh)
    return out


def ss_layer_rels(torch, cfg, params, mesh, batch) -> list:
    """Every rank's every layer, its attention on its head slice (``wo``'s
    rows included, before the reduce) by the flash route against the
    einsum route on a shared input: the layer inputs of one sharded einsum
    forward. Returns the relative errors, (rank, layer) in order."""
    from repro_torch.core.mesh import P, current_region, shard_map
    from repro_torch.launch.train import rows_spec
    from repro_torch.models import tp
    from repro_torch.models.common import attend, causal_mask
    from repro_torch.kernels.ops import gqa_flash_attention
    from repro_torch.models.transformer import _tp_ffn, _tp_layers

    ein = cfg.replace(attn_impl="einsum")
    specs = {n: st.sharding.spec for n, st in params.items()}
    rels = {}

    def body(tokens):
        slot = current_region().slot
        w = tp.RankWeights({n: st.blocks[slot] for n, st in params.items()}, specs, mesh)
        x = tp.embed(ein, w, tokens)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        mine = []
        for _, _, _, pre, spec in _tp_layers(ein):
            h = tp.norm(ein, w, pre + "ln1.", x)
            q, k, v, kv_local = tp.qkv(ein, w, pre + "attn.", h, positions, spec.theta)
            ks, vs = tp.read_heads(ein, w, k, v, kv_local)
            wo = w.part(pre + "attn.wo", 0, cfg.n_heads).to(cfg.cdtype)
            a_f = gqa_flash_attention(q, ks, vs, causal=True).reshape(B, S, -1) @ wo
            a_e = attend(q, ks, vs, causal_mask(S, S, device=x.device), 1.0 / math.sqrt(q.shape[-1])).reshape(B, S, -1) @ wo
            mine.append(rel_err(a_f, a_e))
            x = x + tp.attention_full(ein, w, pre + "attn.", h, positions, theta=spec.theta)[0]
            x = x + _tp_ffn(ein, w, pre, spec, tp.norm(ein, w, pre + "ln2.", x))
        rels[slot] = mine

    with torch.no_grad():
        shard_map(body, mesh, rows_spec(mesh, batch["tokens"].shape[0]), P(), turns=True)(batch["tokens"])
    return [r for slot in sorted(rels) for r in rels[slot]]


def ss_compare(torch, single: dict, sharded: dict, tol: float) -> dict:
    """Per-step relative logit errors, token equality, the first argmax
    divergence with the single-rank top-2 margin there, and every
    divergence's margin in bf16 steps of its row's top logit (the bf16
    steps are forced on the single-rank tokens, so each is a sample)."""
    rels = [rel_err(a, b) for a, b in zip(sharded["logits"], single["logits"])]
    flips = []
    for i, (a, b) in enumerate(zip(sharded["tokens"], single["tokens"])):
        for r in (a != b).nonzero()[:, 0].tolist():
            top = single["top2"][i][r]
            flips.append(dict(step=i, row=r, margin=(top[0] - top[1]).item(), bf16_step=bf16_step(top[0].item())))
    return dict(logit_rels=rels, max_rel=max(rels), tokens_equal=not flips, first_divergence=flips[0] if flips else None,
                flip_margins_bf16_steps=[f["margin"] / f["bf16_step"] for f in flips], tol=tol)


def ss_collectives_predicted(cfg) -> dict:
    """The design's count of one decode step's collectives per rank: per
    layer, all-gathers of q, of the new K/V row and of the attention
    partials, all-reduces of ``wo`` and of the FFN; the embedding's
    all-reduce and the logits' all-gather once."""
    return {"all-gather": 3 * cfg.n_layers + 1, "all-reduce": 2 * cfg.n_layers + 1}


def ss_one(torch, name: str, cfg, smi: str) -> tuple:
    """One model: the fp32 copy (exact checks) and the bf16 model."""
    import numpy as np

    from repro_torch.core.mesh import make_mesh

    moe = cfg.moe.enabled
    rng = np.random.default_rng(31)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (SS_BATCH, SS_PROMPT))).cuda()}
    w16 = ss_weights(torch, cfg)
    n_params = sum(w.numel() for w in w16.values())
    checks, out = [], dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads, vocab=cfg.vocab, params=n_params, mesh=list(SS_MESH[0]),
                           batch=SS_BATCH, prompt=SS_PROMPT, max_len=SS_MAX_LEN, steps=SS_STEPS, nvidia_smi=smi)
    launches, fp32_last = 0, None
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(param_dtype=dtype, compute_dtype=dtype, attn_impl="flash")
        weights = {n: w.float() for n, w in w16.items()} if dtype == "float32" else w16
        model = ss_model(torch, c, weights)
        single = ss_single(torch, c, model, batch, SS_STEPS, routes=moe)
        del model
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        routes = None
        if moe:  # both dtypes: a choice at a tie flips with the sums' order (the fp32 flips are printed)
            routes = ShardRoutes(torch, make_mesh(*SS_MESH), SS_BATCH, single["calls"], impose=True)
        forced = single["tokens"][:-1] if dtype == "bfloat16" else None
        sh = ss_sharded(torch, c, weights, batch, SS_STEPS, forced=forced, routes=routes)
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches += sh["prefill_k2_launches"]
        r = dict(ss_compare(torch, single, sh, 1e-4 if dtype == "float32" else 5e-2), peak_mem_gb=peak,
                 single_prefill_host_ms=single["prefill_host_ms"], single_decode_host_ms=single["decode_host_ms"],
                 **{k: sh[k] for k in ("prefill_host_ms", "decode_host_ms", "prefill_k2_launches", "decode_k2_launches",
                                      "decode_collectives", "param_bytes_per_rank", "cache_bytes_per_rank",
                                      "block_shape", "block_shapes_ok")})
        r["decode_collectives_predicted"] = ss_collectives_predicted(c)
        want_k2 = SS_MESH_SIZE * cfg.n_layers
        checks += [(sh["prefill_k2_launches"] == want_k2 and sh["decode_k2_launches"] == 0,
                    f"{name} {dtype}: K2 launches {sh['prefill_k2_launches']} == {want_k2} a prefill, "
                    f"{sh['decode_k2_launches']} == 0 in decode"),
                   (sh["block_shapes_ok"], f"{name} {dtype}: every rank's cache block is cache_specs' block"),
                   (r["decode_collectives"] == r["decode_collectives_predicted"],
                    f"{name} {dtype}: one decode step's collectives {r['decode_collectives']} == "
                    f"{r['decode_collectives_predicted']}")]
        if routes is not None:
            r["choice_flips_per_call"] = routes.flips()
            r["choice_flips"] = sum(r["choice_flips_per_call"])
            r["choice_flipped_gap_max"] = routes.flipped_gap_max()
            r["choices"] = sum(int(x.shape[0]) for x in single["calls"])
        if dtype == "float32":
            cache_err = max(rel_err(a.gather(), b.to("cuda")) for a, b in zip(sh["cache"], single["cache"]))
            r["cache_rel_err"] = cache_err
            checks += [(r["max_rel"] <= 1e-4, f"{name} fp32: every step's logits rel {r['max_rel']} <= 1e-4"),
                       (r["tokens_equal"], f"{name} fp32: the {SS_STEPS} tokens of every request equal"),
                       (cache_err <= SS_CACHE_TOL[name], f"{name} fp32: the gathered cache within "
                                                         f"{SS_CACHE_TOL[name]} of each leaf's scale: {cache_err}")]
            fp32_last = single["logits"][0]
            if moe:
                checks.append((r["choice_flipped_gap_max"] <= SS_TIE_GAP,
                               f"{name} fp32: route choices equal the single-rank run's but at ties (gap <= "
                               f"{SS_TIE_GAP}): {r['choice_flips']} flips, largest gap {r['choice_flipped_gap_max']}"))
        else:
            fd = r["first_divergence"]
            # how far each bf16 run's last logits sit from the fp32 copy's (same weights, own routing)
            r["single_last_vs_fp32_rel"] = rel_err(single["logits"][0], fp32_last)
            r["sharded_last_vs_fp32_rel"] = rel_err(sh["logits"][0], fp32_last)
            checks += [(r["logit_rels"][0] <= 5e-2, f"{name} bf16: last logits rel {r['logit_rels'][0]} <= 5e-2"),
                       (fd is None or fd["margin"] <= SS_FLIP_STEPS[name] * fd["bf16_step"],
                        f"{name} bf16: tokens equal or first divergence at a top-2 margin <= "
                        f"{SS_FLIP_STEPS[name]} bf16 steps: {fd}")]
            rels = ss_layer_rels(torch, c, sh["params"], sh["mesh"], batch)
            r["layer_attn_rels_max"] = max(rels)
            checks.append((max(rels) <= 2e-2 and len(rels) == want_k2,
                           f"{name} bf16: every rank's layer flash vs einsum <= 2e-2 ({len(rels)}): {max(rels)}"))
        out[dtype] = r
        del sh, single, weights
        release(torch)
    return out, checks, launches


def phase_sharded_serve(torch, smi: str, parts=(("qwen", "qwen1.5-0.5b"), ("granite", "granite-moe-1b-a400m"))) -> dict:
    """The sharded serve steps (``make_prefill_step``/``make_serve_step`` on
    params under ``param_specs`` and caches under ``cache_specs``) on a
    (2, 4) ("data", "model") mesh of 8 thread-ranks on ``cuda:0``, against
    the single-rank steps on the same weights (run first, results on the
    host): qwen1.5-0.5b and granite-moe-1b-a400m at published width and
    depth, each on an fp32 copy (exact checks) and in bf16. Each part's
    line is printed before its checks are applied."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    failed, launches = [], 0
    for name, arch in parts:
        release(torch)
        t = time.perf_counter()
        out, checks, n = ss_one(torch, name, get_config(arch), smi)
        launches += n
        out["part_host_s"] = time.perf_counter() - t
        emit("sharded_serve", part=name, **out, checks_failed=[w for ok, w in checks if not ok])
        failed.extend(f"{name}: {w}" for ok, w in checks if not ok)
    emit("sharded_serve", part="summary", flash_launches=launches, phase_host_s=time.perf_counter() - t0,
         nvidia_smi=smi)
    check(not failed, f"sharded_serve: {failed}")
    return dict(flash_launches=launches)


# ----------------------------------------------------------------------
# the examples phase
# ----------------------------------------------------------------------


def run_example(name: str, timeout: float, *args: str) -> tuple:
    """``python examples/port/<name>.py *args`` with ``PYTHONPATH=src``, as
    the README runs it: (stdout, wall seconds). A non-zero exit or running
    past ``timeout`` seconds (which kills the process) fails the phase."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / "port" / f"{name}.py"), *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    seconds = time.perf_counter() - t
    check(proc.returncode == 0, f"examples/port/{name}.py {' '.join(args)} exited {proc.returncode}:\n"
                                f"{proc.stderr[-3000:]}")
    return proc.stdout, seconds


def example_lines(out: str, prefix: str) -> list:
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def train_lm_run(out: str) -> dict:
    """A train_lm run's logged losses, its step-time line's numbers, the
    step it restored and its final loss line."""
    import re

    logged = [(int(m[1]), float(m[2])) for m in
              (re.match(r"\[trainer\] step (\d+) loss (\S+) ", ln) for ln in example_lines(out, "[trainer] step "))]
    timing = re.match(r"\[train_lm\] steps (\d+)\.\.(\d+): (\S+) ms a step .*, (\S+) tokens/s",
                      example_lines(out, "[train_lm] steps ")[-1])
    restored = example_lines(out, "[trainer] restored step ")
    final = re.match(r"\[train_lm\] loss (\S+) -> (\S+) over (\d+) steps", out.splitlines()[-1])
    check(final is not None, f"train_lm ends with its loss line: {out.splitlines()[-1:]}")
    return dict(first_step=int(timing[1]), last_step=int(timing[2]), ms_a_step=float(timing[3]),
                tokens_per_s=float(timing[4]), logged=logged,
                restored=int(restored[0].split()[-1]) if restored else None,
                loss_first=float(final[1]), loss_last=float(final[2]), steps=int(final[3]))


def phase_examples(torch, smi: str) -> dict:
    """The five port examples (``examples/port/``) on the card, each in a
    process of its own with its defaults: quickstart, serve_lm,
    pipeline_train and streams_overlap must end with ``OK`` (the reference's
    asserts hold inside each); train_lm trains the 95.2M-parameter preset
    for EX_TRAIN_STEPS[0] steps, then resumes for EX_TRAIN_STEPS[1] more from
    its last save, its losses finite and falling. Checkpoints go to a
    directory under the checkout's build/, removed at the end."""
    import importlib.util

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the examples' processes share the card with this one
    seconds, out = {}, {}
    for name in ("quickstart", "serve_lm"):
        out[name], seconds[name] = run_example(name, EX_TIMEOUT_S[name])
        check(out[name].splitlines()[-1:] == ["OK"], f"{name} ends with OK")
    check(len(example_lines(out["quickstart"], "[grequest] completed after 3 polls")) == 1,
          "quickstart's generalized request completed after 3 polls")
    check("owns torch.cuda.Stream" in out["quickstart"], "quickstart's offload stream owns a torch.cuda.Stream")
    check(len(example_lines(out["serve_lm"], "[serve] 6 requests, 72 tokens")) == 1, "serve_lm served 6 x 12 tokens")

    spec = importlib.util.spec_from_file_location("port_train_lm", ROOT / "examples" / "port" / "train_lm.py")
    train_lm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(train_lm)
    n_params = train_lm.model_100m().param_counts()["total"]
    (ROOT / "build").mkdir(exist_ok=True)
    base = Path(tempfile.mkdtemp(prefix="examples-ckpt-", dir=ROOT / "build"))
    try:
        need_disk(base, EX_SAVES_KEPT * EX_SAVE_BYTES_A_PARAM * n_params, "train_lm's checkpoints")
        first, resumed = EX_TRAIN_STEPS
        for key, steps in (("train_lm", first), ("train_lm_resume", resumed)):
            out[key], seconds[key] = run_example("train_lm", EX_TIMEOUT_S[key], "--steps", str(steps),
                                                 "--ckpt-dir", str(base))
        saves = sorted(p.name for p in base.iterdir() if p.name.startswith("step_"))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    tl, tr = train_lm_run(out["train_lm"]), train_lm_run(out["train_lm_resume"])
    check(tl["restored"] is None and (tl["first_step"], tl["last_step"], tl["steps"]) == (0, first - 1, first),
          f"train_lm ran steps 0..{first - 1} from scratch: {tl}")
    check(tr["restored"] == first - 1 and (tr["first_step"], tr["last_step"], tr["steps"]) == (first, first + resumed - 1,
                                                                                           resumed),
          f"the resumed train_lm restored step {first - 1} and ran from step {first}: {tr}")
    check(saves == [f"step_{s:08d}" for s in (50, first - 1, first + resumed - 1)], f"train_lm's saves: {saves}")
    losses = [l for _, l in tl["logged"] + tr["logged"]] + [tl["loss_last"], tr["loss_first"], tr["loss_last"]]
    check(all(math.isfinite(l) for l in losses), f"train_lm's losses finite: {losses}")
    check(tl["loss_last"] < tl["loss_first"] and tr["loss_last"] < tl["loss_first"] and tr["loss_first"] < tl["loss_first"],
          f"train_lm's losses fall: {tl['loss_first']} -> {tl['loss_last']}, resumed {tr['loss_first']} -> "
          f"{tr['loss_last']}")

    for name in ("pipeline_train", "streams_overlap"):
        out[name], seconds[name] = run_example(name, EX_TIMEOUT_S[name])
        check(out[name].splitlines()[-1:] == ["OK"], f"{name} ends with OK")
    pipe = example_lines(out["pipeline_train"], "[pipeline] ")
    pipe_first, pipe_last = float(pipe[0].split()[-1]), float(example_lines(out["pipeline_train"],
                                                                          "[pipeline] final loss")[0].split()[3])
    check(pipe_last < 2.0 and pipe_last < pipe_first, f"pipeline_train's loss {pipe_first} -> {pipe_last}, below 2.0")
    streams = example_lines(out["streams_overlap"], "[streams] part (b) ran on ")
    n_streams = int(streams[0].split()[5]) if streams else 0
    check(n_streams == 4 * 8, f"streams_overlap's part (b) ran on 4 CUDA streams a rank x 8 ranks: {streams}")

    res = dict(seconds=seconds, phase_s=time.perf_counter() - t0,
               train_lm=dict(params=n_params, batch=4, seq=128, steps=[first, resumed],
                             ms_a_step=tl["ms_a_step"], tokens_per_s=tl["tokens_per_s"],
                             resumed_ms_a_step=tr["ms_a_step"], resumed_tokens_per_s=tr["tokens_per_s"],
                             restored_step=tr["restored"], logged=tl["logged"] + tr["logged"],
                             loss=[tl["loss_first"], tl["loss_last"], tr["loss_first"], tr["loss_last"]], saves=saves),
               pipeline_train=dict(first_loss=pipe_first, last_loss=pipe_last),
               streams_overlap=dict(cuda_streams=n_streams),
               quickstart=example_lines(out["quickstart"], "[streams]"),
               nvidia_smi=smi, device=torch.cuda.get_device_name(0))
    emit("examples", **res)
    return res


def phase_timer_ab(torch) -> None:
    """The timer's variants, each in turns so that a change of timer can be
    told from noise, and the pack's timed shapes under the default timer.

    - flush: the pack at the served span, the unpack, a dense ``copy_`` of
      the same bytes, flash (bf16, S = 384), K3 (the served shape) and an
      empty kernel with the L2 flushed by a read and by ``zero_()`` (zero,
      read, read, zero);
    - spin: flash and K3 with and without the device spin (spin, none, none,
      spin);
    - pack_shapes: every pack shape with its dense copy and library call.

    Run as ``chip_smoke.py --timer-ab``; copied beside another checkout's
    ``src/``, it times that checkout's kernels."""
    from repro_torch.kernels import dt_pack as dp, flash_attention as fa, rwkv6_scan as wk

    gen = torch.Generator(device="cuda").manual_seed(0)
    n = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    q, k, v = (n(1, FLASH_SERVE_S[-1], 16, 64).to(torch.bfloat16) for _ in range(3))
    B, S, H = WKV_SERVE
    wkv_args = (torch.sigmoid(n(B, S, H, 64)) * 0.5 + 0.45, n(B, S, H, 64), n(B, S, H, 64), n(B, S, H, 64),
                n(H, 64) * 0.1, n(B, H, 64, 64) * 0.1)
    bufs = pack_buffers(torch, gen)
    kv, (_, nseg, seg, stride, start) = bufs["kv"], PACK_SHAPES["served_span"]
    packed = dp.dt_pack(kv, nseg=nseg, seg_len=seg, stride=stride, start=start)
    a, b = torch.empty_like(packed), torch.empty_like(packed)
    rows = {
        "dt_pack": lambda: dp.dt_pack(kv, nseg=nseg, seg_len=seg, stride=stride, start=start),
        "dt_unpack": lambda: dp.dt_unpack(packed, nseg=nseg, seg_len=seg, stride=stride, start=start,
                                          out_len=kv.numel()),
        "dense_copy": lambda: b.copy_(a),
        "flash_attention": lambda: fa.flash_attention(q, k, v),
        "wkv6": lambda: wk.wkv6(*wkv_args, chunk=64),
        "empty_kernel": lambda: torch.cuda._sleep(1),  # the timer's floor
    }
    class ZeroFlushTimer(Timer):  # the timer before the read flush
        def flush_l2(self) -> None:
            self.flush.zero_()

    flushes = {"zero": ZeroFlushTimer(torch), "read": Timer(torch)}
    flush = {}
    for name, fn in rows.items():
        flush[name] = {key: [] for key in flushes}
        for key in ("zero", "read", "read", "zero"):
            flush[name][key].append(flushes[key](fn))
    spins = {"spin": flushes["read"], "no_spin": Timer(torch, spin=False)}
    spin = {}
    for name in ("flash_attention", "wkv6"):
        spin[name] = {key: [] for key in spins}
        for key in ("spin", "no_spin", "no_spin", "spin"):
            spin[name][key].append(spins[key](rows[name]))
    emit("timer_ab", flush=flush, spin=spin, pack_shapes=pack_shape_rows(torch, flushes["read"], bufs, check_exact=False))


# ----------------------------------------------------------------------
# the cost phase
# ----------------------------------------------------------------------


def start_dryrun() -> dict:
    """Start the cost phase's dry-run cell (``python -m
    repro_torch.launch.dryrun``) in a process of its own that sees no card:
    it runs on meta tensors. Its row goes to a file under build/."""
    (ROOT / "build").mkdir(exist_ok=True)
    out = ROOT / "build" / "cost-dryrun.json"
    log = ROOT / "build" / "cost-dryrun.log"
    out.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", COST_DRYRUN[0], "--shape", COST_DRYRUN[1],
           "--out", str(out)]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    return dict(proc=proc, out=out, log=log, t0=time.perf_counter())


def stop_dryrun(dry: dict) -> None:
    if dry["proc"].poll() is None:
        dry["proc"].kill()
        dry["proc"].wait()


def cost_row(rl, c, shape, cfg, measured_ms: float) -> dict:
    """A counted step's roofline row beside its measured host ms."""
    terms = rl.RooflineTerms(c.cost.flops, c.cost.bytes, 0.0, 1, rl.model_step_flops(cfg, shape))
    row = terms.row()
    row.update(bound_ms=terms.t_bound * 1e3, measured_ms=measured_ms, measured_over_bound=measured_ms / (terms.t_bound * 1e3))
    return row


def cost_counts(torch, serve: dict, train: dict) -> tuple:
    """(a) The full-width qwen1.5-0.5b served decode step, a 384-token
    prefill and the train phase's step counted on meta tensors beside
    their measured times, held against the hand-derived bounds; returns
    (rows, the meta train step's predicted peak bytes and args bytes)."""
    from repro_torch.checkpoint import iovec_store as store
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.train import make_serve_step, make_train_step
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = get_config("qwen1.5-0.5b")  # einsum attention: the kernel wrappers raise on meta tensors
    model = api.abstract_params(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == train["n_params"], f"the meta model has the trained model's {train['n_params']} params")
    slots, max_len = COST_DECODE
    cache = api.init_cache(cfg, slots, max_len, device="meta")
    tok = torch.zeros(slots, dtype=torch.long, device="meta")
    with OpCounter() as c:
        make_serve_step(cfg)(model, cache, tok, tok)
    decode = cost_row(rl, c, ShapeSpec("serve_decode", max_len, slots, "decode"), cfg, serve["decode_step_host_ms"])
    hand_ms = serve["decode_step_bound_ms"]
    ratio = decode["t_memory_s"] * 1e3 / hand_ms
    check(abs(ratio - 1) <= COST_DECODE_TOL,
          f"counted decode bytes bound {decode['t_memory_s'] * 1e3} ms within {COST_DECODE_TOL} of the hand-derived {hand_ms} ms")
    decode.update(hand_bound_ms=hand_ms, counted_over_hand=ratio, by_op=c.top(6))

    batch = {"tokens": torch.zeros((1, COST_PREFILL_S), dtype=torch.int32, device="meta")}
    with OpCounter() as c:
        api.prefill(cfg, model, batch, max_len=max_len)
    prefill = cost_row(rl, c, ShapeSpec("serve_prefill", COST_PREFILL_S, 1, "prefill"), cfg, serve["prefill_384_host_ms"])
    prefill.update(measured_with="flash", counted_with="einsum", by_op=c.top(6))

    B, S = train["batch"], train["seq"]
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    model.requires_grad_(True)
    opt_state = adamw_init(opt, dict(model.named_parameters()))
    tbatch = {"tokens": torch.zeros((B, S), dtype=torch.int32, device="meta")}
    with OpCounter(track_memory=True) as c:
        make_train_step(cfg, opt)(model, opt_state, tbatch)
    step = cost_row(rl, c, ShapeSpec("train_step", S, B, "train"), cfg, train["step_host_ms"])
    hand = train_step_flops(cfg, B, S, n_params)
    ratio = c.cost.flops / hand
    check(1.0 <= ratio <= COST_TRAIN_MAX,
          f"counted train FLOPs {c.cost.flops} between 1x and {COST_TRAIN_MAX}x the hand count {hand}: {ratio}")
    # the gap by op family: the products beyond 6·N·tokens (remat recomputes
    # each layer's forward; the embedding lookup is no product), attention
    # beyond its causal half (einsum computes every score, recomputed too),
    # and every other op (elementwise, reductions, AdamW), none in the hand count
    fam = {k: v.flops for k, v in c.by_op.items()}
    products = fam.get("mm", 0) + fam.get("addmm", 0)
    attn_hand = train_step_flops(cfg, B, S, 0)
    gap = {"mm+addmm beyond 6·N·tokens": products - 6.0 * n_params * B * S,
           "bmm beyond the causal attention count": fam.get("bmm", 0) - attn_hand,
           "every other op": c.cost.flops - products - fam.get("bmm", 0)}
    step.update(hand_flops=hand, counted_over_hand=ratio, gap_flops=c.cost.flops - hand, gap_by_family=gap,
                by_op=c.top(8))
    args = sum(t.numel() * t.element_size() for t in store.tree_tensors({"params": dict(model.named_parameters()),
                                                                         "opt": opt_state, "batch": tbatch}))
    return dict(decode_step=decode, prefill_384=prefill, train_step=step), c.peak_bytes, args


def cost_memory(torch, train: dict, train_temp: int, train_args: int) -> dict:
    """(b) Peak memory predicted by the live-bytes tracker (the inputs'
    bytes plus the peak of the storages a step creates, on meta tensors)
    against ``torch.cuda.max_memory_allocated()`` for a real 384-token
    prefill (einsum, as counted) and a real train step at the train phase's
    batch, each on a fresh model; the card's allocations before the model
    are subtracted from the peak."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.op_cost import OpCounter
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    cfg = get_config("qwen1.5-0.5b")
    meta = api.abstract_params(cfg)
    param_bytes = sum(p.numel() * p.element_size() for p in meta.parameters())
    with torch.no_grad(), OpCounter(track_memory=True) as c:
        api.prefill(cfg, meta, {"tokens": torch.zeros((1, COST_PREFILL_S), dtype=torch.int32, device="meta")},
                    max_len=COST_DECODE[1])
    predicted = {"prefill_384": param_bytes + COST_PREFILL_S * 4 + c.peak_bytes, "train_step": train_args + train_temp}

    rng = np.random.default_rng(2)
    out = {}
    for name in ("prefill_384", "train_step"):
        release(torch)
        base = torch.cuda.memory_allocated()
        model = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        if name == "prefill_384":
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, COST_PREFILL_S)), dtype=torch.int32, device="cuda")
            run = lambda: api.prefill(cfg, model, {"tokens": toks}, max_len=COST_DECODE[1])  # noqa: E731
        else:
            opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
            model.requires_grad_(True)
            state = adamw_init(opt, dict(model.named_parameters()))
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (train["batch"], train["seq"])), dtype=torch.int32,
                                   device="cuda")
            step = make_train_step(cfg, opt)
            run = lambda: step(model, state, {"tokens": toks})  # noqa: E731
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.set_grad_enabled(name == "train_step"):
            run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        measured = peak - base
        ratio = measured / predicted[name]
        check(abs(ratio - 1) <= COST_MEM_TOL,
              f"{name}: max_memory_allocated {peak} less {base} before = {measured} within {COST_MEM_TOL} of the predicted {predicted[name]}")
        out[name] = dict(predicted_bytes=predicted[name], max_memory_allocated=peak, allocated_before=base,
                         measured_bytes=measured, measured_over_predicted=ratio)
        del model, run
    release(torch)
    return out


def cost_dryrun(dry: dict) -> dict:
    """(c) The dry-run cell started before the first phase: its row and
    seconds (waited for at most COST_DRYRUN_WAIT_S here)."""
    proc = dry["proc"]
    try:
        proc.wait(timeout=COST_DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        check(False, f"the dry-run cell {COST_DRYRUN} finished within {COST_DRYRUN_WAIT_S} s of the cost phase "
                     f"({time.perf_counter() - dry['t0']:.1f} s after it started)")
    wall = time.perf_counter() - dry["t0"]
    log = dry["log"].read_text()
    check(proc.returncode == 0 and dry["out"].exists(), f"the dry-run cell exited {proc.returncode}: {log[-2000:]}")
    row = json.loads(dry["out"].read_text())[0]
    check("error" not in row, f"the dry-run cell raised: {row.get('error')}")
    check(row["n_chips"] == 256 and row["collectives"] is not None and row["memory"]["temp_bytes"],
          f"the dry-run cell counted its collectives and temp bytes on the 16x16 mesh: {row}")
    return dict(row=row, seconds=row["lower_s"] + row["sharded_s"], wall_s_at_most=wall)


def phase_cost(torch, smi: str, serve: dict, train: dict, dry: dict) -> None:
    """The launch cost tooling on the card's own numbers: (a) counted
    bounds beside measured times, (b) predicted against measured peak
    memory, (c) one dry-run cell, (d) the card's memory beside HW."""
    from repro_torch.launch.mesh import HW

    t0 = time.perf_counter()
    rows, train_temp, train_args = cost_counts(torch, serve, train)
    memory = cost_memory(torch, train, train_temp, train_args)
    dryrun = cost_dryrun(dry)
    total = torch.cuda.get_device_properties(0).total_memory
    emit("cost", counted=rows, peak_memory=memory, dryrun=dryrun,
         card_memory=dict(total_memory=total, hw_hbm_bytes=HW.HBM_BYTES, ratio=total / HW.HBM_BYTES),
         seconds=time.perf_counter() - t0, nvidia_smi=smi, device=torch.cuda.get_device_name(0))


def zoo_launches(zoo: dict, zoo2: dict, row: dict) -> dict:
    """The zoo's K2 launches at a kernels-line row's head dim and dtype:
    the served bf16 run of the model with that head dim, or its fp32
    copy's one flash prefill (a check), and which run it was."""
    if "part" in row:  # a zoo2 shape
        return dict(launches=zoo2["flash_launches"][row["part"]], launches_in=f"zoo2 {row['part']}: the bf16 run")
    part = {96: "phi3", 256: "gemma3"}[row["hd"]]
    if row["dtype"] == "bfloat16":
        return dict(launches=zoo["flash_launches"][part], launches_in=f"zoo {part}: the bf16 run")
    return dict(launches=zoo["fp32_check_launches"][part], launches_in=f"zoo {part}: the fp32 copy's flash prefill")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timer-ab", action="store_true",
                    help="only build and time the kernels under the Timer's flushes and spin, and the pack's shapes")
    args = ap.parse_args()

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
    for ln in info["log"].splitlines():  # every kernel's registers, shared memory and spills
        if ln.startswith("== "):
            src = ln[3:].strip()
            regs[src] = []
        elif src and "Compiling entry function" in ln:
            regs[src].append(ln.split("'")[1])
        elif src and ("registers" in ln or "spill" in ln):
            regs[src].append(ln.split(":", 1)[-1].strip())
    emit("build", seconds=time.perf_counter() - t0, compiled=info["built"], library=str(Path(info["path"]).relative_to(ROOT)),
         ptxas=regs)

    if args.timer_ab:
        phase_timer_ab(torch)
        return 0
    dry = start_dryrun()
    try:
        return run_phases(torch, smi, dry)
    finally:
        stop_dryrun(dry)


def run_phases(torch, smi: str, dry: dict) -> int:
    timer = Timer(torch)
    kern = phase_kernels(torch, timer)
    eng, serve = phase_serve(torch)
    enq = phase_enqueue(torch, eng)
    model = eng.params
    del eng
    torch.cuda.empty_cache()
    paged = phase_serve_paged(torch, timer, model)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    dist = phase_dist(torch, n_params)
    train = phase_train(torch)
    pipe = phase_pipeline(torch, smi)
    rwkv = phase_serve_rwkv(torch)
    zoo = phase_zoo(torch, smi)
    zoo2 = phase_zoo2(torch, smi)
    sharded = phase_sharded_zoo(torch, smi)
    sserve = phase_sharded_serve(torch, smi)
    phase_examples(torch, smi)
    phase_cost(torch, smi, serve, train, dry)

    ft = kern["flash_times"][-1]  # the longest served prompt, S = 384
    ut = paged["unpack"]["timings"]["decode_step"]  # the paged path's most frequent move
    entries = [
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:75",
             launches=serve["flash_launches"] + paged["flash_launches"] + train["flash_launches"]
             + pipe["flash_launches"] + sum(zoo["flash_launches"].values()) + sum(zoo2["flash_launches"].values())
             + sharded["flash_launches"] + sserve["flash_launches"],
             launches_by_path=dict(serve=serve["flash_launches"], serve_paged=paged["flash_launches"],
                                   train=train["flash_launches"], pipeline=pipe["flash_launches"],
                                   **{f"zoo_{k}": n for k, n in zoo["flash_launches"].items()},
                                   **{f"zoo_{k}": n for k, n in zoo2["flash_launches"].items()},
                                   sharded_zoo=sharded["flash_launches"], sharded_serve=sserve["flash_launches"]),
             max_abs_err=kern["flash_err"], ms=ft["ms"], plain_ms=ft["plain_ms"], bound_ms=ft["bound_ms"],
             bound_by=ft["bound_by"], library_ms=ft["library_ms"],
             by_head_dim=[dict({k: r[k] for k in ("hd", "dtype", "B", "S", "nq", "nkv", "max_abs_err", "ms", "plain_ms",
                                                  "bound_ms", "bound_by", "library_ms")},
                               **zoo_launches(zoo, zoo2, r))
                          for r in kern["flash_zoo"]]),
        dict(name="dt_pack", route="cuda", source="src/repro_torch/csrc/dt_pack.cu",
             replaces="src/repro/kernels/dt_pack.py:50",
             launches=enq["dt_pack"] + paged["pack_launches"] + dist["launches"],
             launches_by_path=dict(enqueue=enq["dt_pack"], serve_paged=paged["pack_launches"], dist=dist["launches"]),
             max_abs_err=0.0,
             ms=kern["pack"]["ms"], plain_ms=kern["pack"]["plain_ms"], bound_ms=kern["pack"]["bound_ms"],
             bound_by="bytes", library_ms=kern["pack"]["library_ms"]),
        dict(name="dt_unpack", route="cuda", source="src/repro_torch/csrc/dt_pack.cu",
             replaces="src/repro/kernels/dt_pack.py:78", launches=enq["dt_unpack"], max_abs_err=0.0,
             ms=kern["unpack"]["ms"], plain_ms=kern["unpack"]["plain_ms"], bound_ms=kern["unpack"]["bound_ms"],
             bound_by="bytes", library_ms=kern["unpack"]["library_ms"]),
        dict(name="dt_unpack_into", route="cuda", source="src/repro_torch/csrc/dt_pack.cu",
             replaces="src/repro/serving/paged_kv.py:289", launches=paged["launches"], max_abs_err=0.0,
             ms=ut["ms"], plain_ms=ut["plain_ms"], bound_ms=ut["bound_ms"], bound_by="bytes",
             library_ms=ut["library_ms"]),
        dict(name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
             replaces=None, replaces_note="no TPU kernel: the reference's decode attention is an einsum under "
             "decode_mask (src/repro/models/common.py), which XLA fuses",
             launches=serve["decode_attention_launches"] + paged["decode_attention_launches"],
             launches_by_path=dict(serve=serve["decode_attention_launches"],
                                   serve_paged=paged["decode_attention_launches"]),
             max_abs_err=max(r["max_abs_err"] for r in kern["decode"]["rows"]),
             **{k: kern["decode"]["timed"]["longgen"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                                    "library_ms")},
             by_shape=[{k: r[k] for k in ("case", "B", "T", "nq", "nkv", "hd", "lengths", "chunk", "splits", "ms",
                                          "plain_ms", "library_ms", "bound_ms", "roofline_share")}
                       for r in kern["decode"]["timed"].values()]),
        dict(name="wkv6", route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
             replaces="src/repro/kernels/rwkv6_scan.py:81", launches=rwkv["launches"],
             max_abs_err=kern["wkv"]["max_abs_err"], ms=kern["wkv"]["ms"], plain_ms=kern["wkv"]["plain_ms"],
             bound_ms=kern["wkv"]["bound_ms"], bound_by=kern["wkv"]["bound_by"], library_ms=None),
    ]
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} launched on the main path")
        check(all(isinstance(e[k], (int, float)) and math.isfinite(e[k]) for k in ("ms", "plain_ms", "bound_ms")),
              f"{e['name']} timings measured")
    emit("first_design", measured_in_this_run=False, flush="zero", ms=FIRST_DESIGN_MS,
         pack_shapes_read_flush_ms=FIRST_DESIGN_PACK_MS)
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
