"""The decode-attention kernel's wrapper (K4) on the CPU.

On the CPU ``kernels.decode_attention`` runs its plain version, which must be
the einsum decode the port ran before the kernel existed (``attend`` under
the decode mask, fp32 logits and softmax, the probabilities cast to V's
dtype), bit for bit: the tests that hold the port against the JAX package
then see the same numbers. The CUDA kernel itself is checked on the card by
``chip_smoke.py`` (``decode_attention_rows``); here its input checks and its
split plan, which are plain Python, are held too.
"""

import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.models import common

T = 24


def _inputs(seed, B, nq, nkv, hd, dtype):
    g = torch.Generator().manual_seed(seed)
    q = (torch.randn(B, nq, hd, generator=g) * 2).to(dtype)
    k = torch.randn(B, T, nkv, hd, generator=g).to(dtype)
    v = torch.randn(B, T, nkv, hd, generator=g).to(dtype)
    return q, k, v


def _decode_mask(T_, pos, ring):
    """The JAX package's ``decode_mask``: slots ``<= pos`` valid, and every
    slot of a ring cache once ``pos + 1 >= T``; (B, 1, 1, 1, T)."""
    m = torch.arange(T_)[None, :] <= pos[:, None]
    if ring:
        m = m | (pos[:, None] + 1 >= T_)
    return m[:, None, None, None]


def _mask_and_attend(q, k, v, pos, ring):
    """The decode attention as ``gqa_attention_decode`` computed it before
    K4: ``attend`` over the whole cache under the decode mask."""
    B, nq, hd = q.shape
    mask = _decode_mask(k.shape[1], pos, ring)
    return common.attend(q[:, None], k, v, mask, 1.0 / math.sqrt(hd)).reshape(B, nq, hd)


#: slot positions: a full cache's lengths 1, mid and T; a ring's mid, T - 1
#: (just full) and past T (wrapped)
_POS = {"full": (0, T // 2 - 1, T - 1), "ring": (T // 2, T - 1, 3 * T + 5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cache", ["full", "ring"])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_plain_is_mask_and_attend_bit_for_bit(G, hd, cache, dtype):
    nkv = 2
    q, k, v = _inputs(G * 1000 + hd, 3, G * nkv, nkv, hd, dtype)
    pos = torch.tensor(_POS[cache], dtype=torch.int32)
    want = _mask_and_attend(q, k, v, pos, ring=cache == "ring")
    got = da.decode_attention_plain(q, k, v, pos)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(ops.decode_attention(q, k, v, pos), want)
    assert da.decode_attention.launches == 0  # CPU: the plain version


def _old_gqa_attention_decode(cfg, p, x, cache_kv, pos, window=0, theta=10_000.0):
    """``gqa_attention_decode`` as it was before K4 (the einsum decode)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k_new, v_new = common.gqa_qkv(cfg, p, x, pos[:, None], theta)
    K, V = cache_kv
    T_ = K.shape[1]
    slot = pos % max(T_, 1) if window > 0 else pos
    bidx = torch.arange(B)
    K.index_put_((bidx, slot), k_new[:, 0].to(K.dtype))
    V.index_put_((bidx, slot), v_new[:, 0].to(V.dtype))
    mask = _decode_mask(T_, pos, window > 0)
    out = common.attend(q, K.to(cfg.cdtype), V.to(cfg.cdtype), mask, 1.0 / math.sqrt(hd))
    return out.reshape(B, 1, cfg.n_heads * hd) @ p["wo"].to(cfg.cdtype), (K, V)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 16])
def test_gqa_attention_decode_unchanged_on_cpu(window, dtype):
    cfg = get_config("llama3-405b", smoke=True).replace(param_dtype=dtype, compute_dtype=dtype)
    hd, d = cfg.resolved_head_dim, cfg.d_model
    g = torch.Generator().manual_seed(7)
    w = lambda *s: (torch.randn(*s, generator=g) / math.sqrt(s[0])).to(cfg.cdtype)
    p = {"wq": w(d, cfg.n_heads * hd), "wk": w(d, cfg.n_kv_heads * hd), "wv": w(d, cfg.n_kv_heads * hd),
         "wo": w(cfg.n_heads * hd, d)}
    B, T_ = 3, 16 if window else 40
    x = torch.randn(B, 1, d, generator=g).to(cfg.cdtype)
    cache = [torch.randn(B, T_, cfg.n_kv_heads, hd, generator=g).to(cfg.cdtype) for _ in range(2)]
    pos = torch.tensor([0, 9, 35])
    old_cache = [c.clone() for c in cache]
    want, (wK, wV) = _old_gqa_attention_decode(cfg, p, x, old_cache, pos, window=window)
    got, (gK, gV) = common.gqa_attention_decode(cfg, p, x, cache, pos, window=window)
    assert gK is cache[0] and gV is cache[1]  # written in place
    assert torch.equal(got, want) and torch.equal(gK, wK) and torch.equal(gV, wV)


def _bad(kind):
    bf, f32 = torch.bfloat16, torch.float32
    q, k, v = torch.zeros(2, 4, 64, dtype=bf), torch.zeros(2, 8, 2, 64, dtype=bf), torch.zeros(2, 8, 2, 64, dtype=bf)
    pos = torch.zeros(2, dtype=torch.int32)
    if kind == "hd":
        q = torch.zeros(2, 4, 80, dtype=bf)
        k, v = torch.zeros(2, 8, 2, 80, dtype=bf), torch.zeros(2, 8, 2, 80, dtype=bf)
    elif kind == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif kind == "mixed_dtype":
        k = k.to(f32)
    elif kind == "pos_dtype":
        pos = pos.float()
    elif kind == "pos_stride":
        pos = torch.zeros(4, dtype=torch.int32)[::2]
    elif kind == "pos_expanded":
        pos = torch.tensor(3, dtype=torch.int32).expand(2)
    elif kind == "group":
        q = torch.zeros(2, 34, 64, dtype=bf)  # G = 17
    elif kind == "hd_stride":
        k = torch.zeros(2, 8, 2, 128, dtype=bf)[..., ::2]
    elif kind == "misaligned":
        k = torch.zeros(2, 8, 2, 65, dtype=bf)[..., 1:]
    return q, k, v, pos


@pytest.mark.parametrize("kind,match", [
    ("hd", "hd in"),
    ("fp16", "float32 or bfloat16"),
    ("mixed_dtype", "float32 or bfloat16"),
    ("pos_dtype", "int32 or int64"),
    ("pos_stride", "pos at unit stride"),
    ("pos_expanded", "pos at unit stride"),
    ("group", "at most 16"),
    ("hd_stride", "unit stride"),
    ("misaligned", "16-byte aligned k"),
])
def test_kernel_refuses_what_it_does_not_take(kind, match):
    """What the CUDA kernel does not take raises (no fallback on the card);
    the same inputs on the CPU run the plain version."""
    q, k, v, pos = _bad(kind)
    with pytest.raises(ValueError, match=match):
        da.check_kernel_inputs(q, k, v, pos)
    if kind not in ("hd", "group", "hd_stride", "misaligned", "pos_stride", "pos_expanded"):
        return
    assert da.decode_attention(q, k, v, pos).shape == q.shape


def test_kernel_takes_the_served_layouts():
    """The serving cache's layer slices and K/V views of one buffer pass the
    checks at every head dim the kernel is built for."""
    for hd in da.DECODE_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            stacked = torch.zeros(2, 3, 8, 4, hd, dtype=dtype)  # (L, B, T, nkv, hd)
            kv = torch.zeros(3, 8, 8, hd, dtype=dtype)  # K and V heads side by side
            q = torch.zeros(3, 8, hd, dtype=dtype)
            da.check_kernel_inputs(q, stacked[1], stacked[0], torch.zeros(3, dtype=torch.int64))
            da.check_kernel_inputs(q, kv[:, :, :4], kv[:, :, 4:], torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("args,match", [
    (lambda: (torch.zeros(2, 3, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2)), "multiple"),
    (lambda: (torch.zeros(2, 4, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2, 9, 2, 64), torch.zeros(2)),
     "do not match"),
    (lambda: (torch.zeros(2, 4, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2, 8, 2, 64), torch.zeros(3)),
     "do not match"),
    (lambda: (torch.zeros(2, 1, 4, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2)),
     r"q \(B,nq,hd\)"),
    (lambda: (torch.zeros(2, 4, 64), torch.zeros(2, 8, 2, 64, device="meta"), torch.zeros(2, 8, 2, 64),
              torch.zeros(2)), "different devices"),
    (lambda: (torch.zeros(2, 4, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2, 8, 2, 64),
              torch.zeros(2, device="meta")), "different devices"),
])
def test_wrapper_validates_shapes_and_devices(args, match):
    with pytest.raises(ValueError, match=match):
        da.decode_attention(*args())


def test_meta_tensors_run_the_plain_shapes():
    """Shape-only tensors (the launch cost tooling's) take the plain path."""
    q = torch.zeros(2, 8, 64, device="meta", dtype=torch.bfloat16)
    k = torch.zeros(2, 16, 4, 64, device="meta", dtype=torch.bfloat16)
    out = da.decode_attention(q, k, k, torch.zeros(2, device="meta", dtype=torch.int32))
    assert out.shape == (2, 8, 64) and out.device.type == "meta"


@pytest.mark.parametrize("B,nkv,T_,want", [
    (32, 32, 4096, (1024, 4)),  # phi-3 longgen
    (16, 32, 4096, (1024, 4)),  # phi-3 docqa
    (4, 8, 4096, (256, 16)),  # granite's decode
    (4, 4, 1024, (256, 4)),  # gemma3's window ring
    (4, 2, 64, (64, 1)),  # a smoke cache: one split, the block writes the output
    (1, 1, 100_000, (1600, 63)),  # a long cache: at most MAX_SPLITS
])
def test_split_plan(B, nkv, T_, want):
    chunk, splits = da.split_plan(B, nkv, T_, 132)
    assert (chunk, splits) == want
    assert chunk % da.CHUNK_UNIT == 0 and splits == -(-T_ // chunk) and 1 <= splits <= da.MAX_SPLITS
