"""The port's kernels against the JAX package's Pallas kernels.

The same inputs, made with numpy from a seed, go through the JAX kernel in
interpret mode and through the port's wrapper. On the CPU each wrapper runs
its kernel's plain PyTorch version, so these tests hold the plain versions
(the arithmetic the CUDA kernels are checked against on the card) to the
reference. Tolerances are the reference suite's: flash attention 2e-5 in
fp32 and 3e-5 for GQA (summation order differs between the blocked online
softmax and one full softmax), 2e-2 in bf16 (the output is rounded to bf16);
pack and unpack move bytes and are compared byte for byte.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import datatype as jdt  # noqa: E402
from repro.kernels import dt_pack as jdtp  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import datatype as tdt  # noqa: E402
from repro_torch.kernels import dt_pack as tdtp  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

_TORCH = {np.float32: torch.float32, "bfloat16": torch.bfloat16}
_JAX = {np.float32: jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _np(x) -> np.ndarray:
    """float32 numpy of a JAX array or a torch tensor (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _fold(x):
    """(BH, S, d) numpy → the port's (1, S, BH, d) tensor layout."""
    return torch.from_numpy(x).permute(1, 0, 2)[None]


# ------------------------------------------------------------ flash attn


@pytest.mark.parametrize("S,hd,dtype", [
    (128, 64, np.float32),
    (256, 64, np.float32),
    (128, 128, np.float32),
    (256, 64, "bfloat16"),
])
@pytest.mark.parametrize("blocks", [(64, 64), (128, 64)])
def test_flash_attention_sweep_matches_pallas(S, hd, dtype, blocks):
    bq, bk = blocks
    q, k, v = _normal(S + hd, *[(2, S, hd)] * 3)
    jq, jk, jv = (jnp.asarray(a).astype(_JAX[dtype]) for a in (q, k, v))
    o_jax = jfa.flash_attention(jq, jk, jv, block_q=bq, block_k=bk, interpret=True)
    tq, tk, tv = (_fold(a).to(_TORCH[dtype]) for a in (q, k, v))
    o_port = tfa.flash_attention(tq, tk, tv)
    assert o_port.dtype == _TORCH[dtype] and tfa.flash_attention.launches == 0
    tol = 2e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(_np(o_port)[0].transpose(1, 0, 2), _np(o_jax), atol=tol, rtol=tol)


@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (8, 1)])
def test_gqa_flash_attention_matches_pallas(nq, nkv):
    B, S, hd = 1, 128, 64
    q, k, v = _normal(nq * 10 + nkv, (B, S, nq, hd), (B, S, nkv, hd), (B, S, nkv, hd))
    o_jax = jops.gqa_flash_attention(*map(jnp.asarray, (q, k, v)), block_q=64, block_k=64)
    o_port = tops.gqa_flash_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(_np(o_port), _np(o_jax), atol=3e-5, rtol=3e-5)


def test_flash_attention_noncausal_matches_pallas():
    q, k, v = _normal(3, *[(1, 128, 64)] * 3)
    o_jax = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), causal=False, block_q=64, block_k=64)
    o_port = tfa.flash_attention(_fold(q), _fold(k), _fold(v), causal=False)
    np.testing.assert_allclose(_np(o_port)[0].transpose(1, 0, 2), _np(o_jax), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference_oracle(causal):
    q, k, v = _normal(4, *[(3, 64, 16)] * 3)
    a = tref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    b = jref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=2e-5)


def test_flash_attention_refuses_autograd():
    q, k, v = (torch.zeros(1, 128, 2, 64, requires_grad=True) for _ in range(3))
    with pytest.raises(NotImplementedError, match="backward"):
        tfa.flash_attention(q, k, v)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).shape == (1, 128, 2, 64)


@pytest.mark.parametrize("bad,match", [
    (lambda: (torch.zeros(1, 128, 3, 64), torch.zeros(1, 128, 2, 64)), "multiple"),
    (lambda: (torch.zeros(1, 128, 2, 64), torch.zeros(1, 64, 2, 64)), "does not match"),
    (lambda: (torch.zeros(128, 2, 64), torch.zeros(128, 2, 64)), r"\(B,S,n,hd\)"),
])
def test_flash_attention_validates_shapes(bad, match):
    q, k = bad()
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, k)


@pytest.mark.parametrize("ptrs,strides,match", [
    ((0, 4096, 8192), ((384 * 1024, 1024, 64),) * 3, None),  # the served layout
    ((0, 4096, 8192), ((0, 3072, 64), (0, 3072, 64), (0, 1024, 128)), None),  # views of a fused qkv
    ((8, 4096, 8192), ((384 * 1024, 1024, 64),) * 3, "16-byte aligned q"),
    ((0, 4098, 8192), ((384 * 1024, 1024, 64),) * 3, "16-byte aligned k"),
    ((0, 4096, 8192), ((384 * 1024, 1024, 64), (384 * 1024, 1020, 64), (384 * 1024, 1024, 64)), "k strides"),
    ((0, 4096, 8192), ((384 * 1024, 1024, 64), (384 * 1024, 1024, 64), (384 * 1024, 1024, 66)), "v strides"),
    ((0, 4096, 8192), ((5, 1024, 64), (384 * 1024, 1024, 64), (384 * 1024, 1024, 64)), "q strides"),
])
def test_flash_attention_tensor_core_layout(ptrs, strides, match):
    err = tfa.tensor_core_layout_error(ptrs, strides)
    if match is None:
        assert err is None
    else:
        assert err is not None and match in err


@pytest.mark.parametrize("ptr,ok", [
    (0, True), (16, True), (64 * 64 * 4 * 3, True), (0x7F0000001000, True),  # slices of a (L, B, H, 64, 64) state
    (4, False), (8, False), (12, False), (0x7F0000001004, False),
])
def test_wkv6_state_alignment(ptr, ok):
    from repro_torch.kernels import rwkv6_scan as twkv

    err = twkv.state_alignment_error(ptr)
    if ok:
        assert err is None
    else:
        assert err is not None and "16-byte aligned state0" in err


# ------------------------------------------------------------ dt_pack


@pytest.mark.parametrize("nseg,seg,stride,dtype", [
    (64, 8, 16, np.float32),
    (128, 16, 64, np.float32),
    (256, 4, 8, "bfloat16"),
    (32, 32, 32, np.float32),  # dense: seg == stride
    (61, 8, 16, np.float32),   # odd nseg
    (300, 16, 4096, np.float32),  # the reference's main + tail block path
])
def test_dt_pack_sweep_byte_exact(nseg, seg, stride, dtype):
    (src,) = _normal(nseg + seg, (nseg, stride))
    jsrc = jnp.asarray(src).astype(_JAX[dtype])
    tsrc = torch.from_numpy(src).to(_TORCH[dtype]).reshape(-1)
    assert np.array_equal(_bytes(tsrc), _bytes(jsrc))  # same inputs, bit for bit

    j_out = jdtp.dt_pack(jsrc, seg, interpret=True)
    t_out = tdtp.dt_pack(tsrc, nseg=nseg, seg_len=seg, stride=stride)
    np.testing.assert_array_equal(_bytes(t_out), _bytes(j_out))
    np.testing.assert_array_equal(_bytes(tref.pack_ref(tsrc.reshape(nseg, stride), seg)), _bytes(j_out))

    j_back = jdtp.dt_unpack(j_out, stride, interpret=True)
    t_back = tdtp.dt_unpack(t_out, nseg=nseg, seg_len=seg, stride=stride, out_len=nseg * stride)
    np.testing.assert_array_equal(_bytes(t_back), _bytes(j_back))
    np.testing.assert_array_equal(_bytes(tref.unpack_ref(t_out.reshape(nseg, seg), stride)), _bytes(j_back))
    assert tdtp.dt_pack.launches == 0 and tdtp.dt_unpack.launches == 0  # CPU: plain versions


@pytest.mark.parametrize("call,match", [
    (lambda b: tdtp.dt_pack(b, nseg=4, seg_len=8, stride=4), "overlapping"),
    (lambda b: tdtp.dt_pack(b, nseg=4, seg_len=4, stride=8, start=9), "buffer holds 32"),
    (lambda b: tdtp.dt_pack(b.reshape(4, 8), nseg=4, seg_len=4, stride=8), "1-D"),
    (lambda b: tdtp.dt_unpack(b, nseg=4, seg_len=4, stride=8, out_len=32), "packed holds 32"),
])
def test_dt_pack_rejects_layouts_outside_the_buffer(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(32))


# ------------------------------------------------------- dt_pack's plan

_BASE, _OUT = 1 << 32, 1 << 33  # 256-byte aligned stand-ins for the two pointers
_CHUNK = 16 << 10  # bytes: several of the plan's span units
# (nseg, seg_bytes, stride_bytes, src_addr): chip_smoke.py's byte-exact sweep,
# the five timed shapes at small nseg, and edge layouts
_PLAN_CASES = {
    "sweep_64x8f32": (64, 32, 64, _BASE),
    "sweep_128x16f32": (128, 64, 256, _BASE),
    "sweep_256x4bf16": (256, 8, 16, _BASE),
    "sweep_dense": (32, 128, 128, _BASE),
    "sweep_odd_nseg": (61, 32, 64, _BASE),
    "sweep_tail_block": (300, 64, 16384, _BASE),
    "sweep_start3_f32": (61, 32, 64, _BASE + 12),
    "sweep_start1_bf16": (256, 8, 16, _BASE + 2),
    "served_span": (24, 524288, 4194304, _BASE + 1310720),
    "served_span_small": (3, 524288, 4194304, _BASE + 1310720),
    "page_span_small": (3, 32768, 4194304, _BASE + 1310720),
    "token_view_small": (3, 2048, 4194304, _BASE + 1310720),
    "vector_column_small": (4096, 16, 64, _BASE),
    "misaligned_span_small": (3, 524288, 4194304, _BASE + 1310722),
    "one_segment": (1, 300000, 0, _BASE),
    "one_segment_of_steps": (1, 5 * _CHUNK, 5 * _CHUNK, _BASE),
    "segment_not_whole_steps": (3, 2 * _CHUNK + 48, 3 * _CHUNK, _BASE),
    "seg_16k_plus_2": (5, 16 * 1000 + 2, 20000, _BASE),
    "src_off_by_2": (4, 4 * _CHUNK, 8 * _CHUNK, _BASE + 2),
    "src_off_by_4": (4, 4 * _CHUNK, 8 * _CHUNK, _BASE + 4),
    "src_off_by_8": (4, 4 * _CHUNK, 8 * _CHUNK, _BASE + 8),
    "uint8_odd": (9, 4099, 5003, _BASE + 1),
    "offsets_past_2GiB": (4, 65536, 1 << 29, _BASE + 16),
    "indices_past_2G_uint8": (4, 16385, 1 << 29, _BASE),
}


def _pack_runs(plan, nseg, seg_bytes, stride_bytes):
    """``(src_offset, dst_offset, nbytes)`` of every contiguous run the pack
    kernel moves under ``plan``, block by block in its order
    (csrc/dt_pack.cu, ``pack_kernel``), a block's span cut where a segment
    ends."""
    if nseg <= 1:
        stride_bytes = seg_bytes
    total = nseg * seg_bytes
    for b in range(plan.grid):
        pos, end = b * plan.span_bytes, min(total, (b + 1) * plan.span_bytes)
        while pos < end:
            seg, off = divmod(pos, seg_bytes)
            n = min(seg_bytes - off, end - pos)
            yield seg * stride_bytes + off, pos, n
            pos += n


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("name", sorted(_PLAN_CASES))
def test_pack_plan_tiles_the_layout(name, sms):
    nseg, seg, stride, src = _PLAN_CASES[name]
    plan = tdtp.pack_plan(nseg, seg, stride, src, _OUT, sms=sms)
    assert plan == tdtp.pack_plan(nseg, seg, stride, src, _OUT, sms=sms)  # a pure function
    eff_stride = stride if nseg > 1 else seg
    quantities = (src, _OUT, seg, eff_stride)
    w = plan.width
    # the widest access all four allow: 16 bytes only when every 16-byte condition holds
    assert all(q % w == 0 for q in quantities)
    assert w == 16 or any(q % (2 * w) for q in quantities)
    total = nseg * seg
    assert 1 <= plan.grid <= sms * tdtp.BLOCKS_PER_SM
    assert (plan.grid - 1) * plan.span_bytes < total <= plan.grid * plan.span_bytes  # no empty block
    assert plan.span_bytes % tdtp.SPAN_UNIT == 0 and plan.span_bytes % w == 0

    pos = 0
    for src_off, dst_off, n in _pack_runs(plan, nseg, seg, stride):
        assert dst_off == pos and 0 < n <= plan.span_bytes  # in order, each byte once
        i, off = divmod(dst_off, seg)
        assert off + n <= seg and src_off == i * eff_stride + off  # inside segment i
        assert dst_off // plan.span_bytes == (dst_off + n - 1) // plan.span_bytes  # inside one block
        assert (src + src_off) % w == 0 and (_OUT + dst_off) % w == 0 and n % w == 0
        pos += n
    assert pos == total


@pytest.mark.parametrize("name,width,grid", [
    ("served_span", 16, 1024),
    ("page_span", 16, 192),
    ("token_view", 16, 12),
    ("vector_column", 16, 1024),
    ("misaligned_span", 2, 1024),
])
def test_pack_plan_of_the_timed_shapes(name, width, grid):
    # chip_smoke.py's five pack shapes at full size (bf16 KV leaf; fp32 column)
    layouts = {
        "served_span": (24, 262144 * 2, 2097152 * 2, 655360 * 2),
        "page_span": (24, 16384 * 2, 2097152 * 2, 655360 * 2),
        "token_view": (24, 1024 * 2, 2097152 * 2, 655360 * 2),
        "vector_column": (1048576, 16, 64, 0),
        "misaligned_span": (24, 262144 * 2, 2097152 * 2, 655361 * 2),
    }
    nseg, seg, stride, disp = layouts[name]
    plan = tdtp.pack_plan(nseg, seg, stride, _BASE + disp, _OUT)
    assert (plan.width, plan.grid) == (width, grid)
    assert plan.grid * plan.span_bytes >= nseg * seg


@pytest.mark.parametrize("name,nseg,seg,stride,dtype,start", [
    ("vector_column", 512, 4, 16, np.float32, 0),  # an MPI vector column: 16-byte segments, 64 apart
    ("misaligned_span", 3, 256, 2048, "bfloat16", 641),  # a KV span one element off: 2-byte alignment
])
def test_dt_pack_small_timed_shapes_match_reference(name, nseg, seg, stride, dtype, start):
    (src,) = _normal(nseg + seg + start, (start + nseg * stride,))
    jbuf = jnp.asarray(src).astype(_JAX[dtype])
    tbuf = torch.from_numpy(src).to(_TORCH[dtype])
    assert np.array_equal(_bytes(tbuf), _bytes(jbuf))
    # the reference's window: the (nseg, stride) rows from `start`
    j_out = jdtp.dt_pack(jbuf[start:start + nseg * stride].reshape(nseg, stride), seg, interpret=True)
    t_out = tdtp.dt_pack(tbuf, nseg=nseg, seg_len=seg, stride=stride, start=start)
    np.testing.assert_array_equal(_bytes(t_out), _bytes(j_out))
    assert tdtp.dt_pack.launches == 0  # CPU: the plain version


# ------------------------------------------------- pack_datatype / unpack


def _both(build):
    """The same descriptor built in the reference's and the port's engine."""
    return build(jdt), build(tdt)


_UNIFORM = {
    "vector": lambda m: m.vector(32, 5, 9, m.predefined(4)),
    "subarray": lambda m: m.subarray((6, 10), (3, 4), (2, 5), m.predefined(4)),
    "one_segment": lambda m: m.hindexed([7], [12], m.predefined(4)),
    "hvector_bf16": lambda m: m.hvector(16, 3, 20, m.predefined(2)),
}


@pytest.mark.parametrize("name", sorted(_UNIFORM))
def test_pack_and_unpack_datatype_match_reference_and_host_engine(name):
    jd, td = _both(_UNIFORM[name])
    item = 2 if name.endswith("bf16") else 4
    n = 32 * 9 + 7
    buf = np.random.default_rng(5).integers(1, 1 << 15, n).astype(np.int16 if item == 2 else np.float32)
    jbuf = jnp.asarray(buf.view(jnp.bfloat16) if item == 2 else buf)
    tbuf = torch.from_numpy(buf).view(torch.bfloat16) if item == 2 else torch.from_numpy(buf)
    assert tdt.pack_info(td) == jdt.pack_info(jd) is not None

    j_packed = jops.pack_datatype(jbuf, jd)
    t_packed = tops.pack_datatype(tbuf, td)
    assert t_packed.dtype == tbuf.dtype
    np.testing.assert_array_equal(_bytes(t_packed), _bytes(j_packed))
    np.testing.assert_array_equal(_bytes(t_packed), tdt.pack(tbuf, td))
    np.testing.assert_array_equal(_bytes(t_packed), jdt.pack(buf.view(np.uint8), jd))

    j_back = jops.unpack_datatype(j_packed, jd, n)
    t_back = tops.unpack_datatype(t_packed, td, n)
    np.testing.assert_array_equal(_bytes(t_back), _bytes(j_back))
    host = torch.zeros(n, dtype=tbuf.dtype)
    tdt.unpack(t_packed, td, host)
    np.testing.assert_array_equal(_bytes(t_back), _bytes(host))


_REJECTED = {
    "irregular": lambda m: m.indexed([1, 2, 1], [0, 3, 9], m.predefined(4)),
    # regression of the reference: first/middle/last segments affine,
    # segment 2 off-grid; the exact proof must refuse it
    "adversarial_affine": lambda m: m.hindexed([1] * 6, [0, 40, 100, 120, 160, 200], m.predefined(8)),
    "overlapping_stride": lambda m: m.hvector(3, 2, 4, m.predefined(4)),
    "negative_disp": lambda m: m.hindexed([2], [-8], m.predefined(4)),
    "not_element_aligned": lambda m: m.vector(4, 1, 3, m.predefined(2)),
}


@pytest.mark.parametrize("name", sorted(_REJECTED))
def test_pack_datatype_rejections_match_reference(name):
    jd, td = _both(_REJECTED[name])
    with pytest.raises(ValueError) as j_err:
        jops.pack_datatype(jnp.zeros(64, jnp.float32), jd)
    with pytest.raises(ValueError) as t_err:
        tops.pack_datatype(torch.zeros(64), td)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError) as tu_err:
        tops.unpack_datatype(torch.zeros(4), td, 64)
    assert str(tu_err.value) == str(j_err.value)


def test_pack_datatype_accepts_precomputed_info():
    td = tdt.vector(8, 2, 4, tdt.predefined(4))
    buf = torch.arange(8 * 4, dtype=torch.float32)
    info = tdt.pack_info(td)
    assert torch.equal(tops.pack_datatype(buf, td, info=info), tops.pack_datatype(buf, td))
