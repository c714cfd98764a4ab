"""The port's datatype engine against the JAX package's, on seeded random
descriptor trees: the same tree built in both engines must give the same
iovec algebra, the same ``pack_info`` proof, and byte-identical pack and
unpack, for numpy buffers and for CPU torch tensors (bf16 included)."""

import random

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core.datatype as jdt  # noqa: E402
import repro_torch.core.datatype as tdt  # noqa: E402


def _random_datatype(m, rng: random.Random, depth: int):
    """A vector/hvector/indexed/struct/subarray/resized composition built
    with the engine ``m`` (lb >= 0, non-overlapping segments)."""
    if depth == 0:
        return m.predefined(rng.choice([1, 2, 4, 8]))
    kind = rng.choice(["contig", "vector", "hvector", "indexed", "hindexed", "struct", "subarray", "resized"])
    if kind == "subarray":
        ndims = rng.randint(1, 3)
        sizes, subsizes, starts = [], [], []
        for _ in range(ndims):
            sub, start = rng.randint(1, 3), rng.randint(0, 2)
            sizes.append(start + sub + rng.randint(0, 2))
            subsizes.append(sub)
            starts.append(start)
        return m.subarray(sizes, subsizes, starts, m.predefined(rng.choice([1, 4])))
    inner = _random_datatype(m, rng, depth - 1)
    if kind == "contig":
        return m.contiguous(rng.randint(1, 4), inner)
    if kind == "vector":
        bl = rng.randint(1, 3)
        return m.vector(rng.randint(1, 4), bl, bl + rng.randint(0, 3), inner)
    if kind == "hvector":
        bl = rng.randint(1, 3)
        return m.hvector(rng.randint(1, 4), bl, bl * inner.extent + rng.randint(0, 16), inner)
    if kind in ("indexed", "hindexed"):
        lens, displs, off = [], [], 0
        for _ in range(rng.randint(1, 3)):
            c = rng.randint(1, 2)
            displs.append(off)
            lens.append(c)
            if kind == "indexed":
                off += c + rng.randint(0, 2)
            else:
                off += c * inner.extent + max(inner.lb, 0) + rng.randint(0, 8)
        return (m.indexed if kind == "indexed" else m.hindexed)(lens, displs, inner)
    if kind == "struct":
        b = _random_datatype(m, rng, depth - 1)
        ca, cb = rng.randint(1, 2), rng.randint(1, 2)
        return m.struct([ca, cb], [0, ca * inner.extent + inner.extent + rng.randint(0, 8)], [inner, b])
    return m.resized(inner, 0, inner.lb + inner.extent + rng.choice([0, 0, 3, 8]))


def _pair(seed):
    depth = random.Random(seed).randint(1, 3)
    j = _random_datatype(jdt, random.Random(seed * 7919 + 1), depth)
    t = _random_datatype(tdt, random.Random(seed * 7919 + 1), depth)
    return j, t


@pytest.mark.parametrize("seed", range(40))
def test_random_trees_pack_unpack_byte_exact(seed):
    jd, td = _pair(seed)
    rng = random.Random(seed)
    count = rng.randint(1, 3)
    assert (td.size, td.extent, td.lb) == (jd.size, jd.extent, jd.lb)
    assert [(s.offset, s.length) for s in td.iovs()] == [(s.offset, s.length) for s in jd.iovs()]
    assert tdt.pack_info(td) == jdt.pack_info(jd)
    assert tdt.type_iov_len(td, -1) == jdt.type_iov_len(jd, -1)
    assert [(r.offset, r.length) for r in tdt.coalesced_iovs(td, count)] == [
        (r.offset, r.length) for r in jdt.coalesced_iovs(jd, count)
    ]

    segs = jd.iovs()
    need = (count - 1) * jd.extent + max(s.offset + s.length for s in segs)
    buf = np.frombuffer(rng.randbytes(max(need, 1)), dtype=np.uint8).copy()
    expect = jdt.pack(buf, jd, count)
    np.testing.assert_array_equal(tdt.pack(buf, td, count), expect)
    np.testing.assert_array_equal(tdt.pack(torch.from_numpy(buf), td, count), expect)
    np.testing.assert_array_equal(tdt.pack_naive(buf, td, count), expect)

    j_out = np.zeros_like(buf)
    jdt.unpack(expect, jd, j_out, count)
    t_out = torch.zeros(buf.size, dtype=torch.uint8)
    tdt.unpack(torch.from_numpy(expect), td, t_out, count)
    np.testing.assert_array_equal(t_out.numpy(), j_out)


@pytest.mark.parametrize("seed", range(4))
def test_bf16_tensor_buffer_packs_its_bytes(seed):
    """bf16 has no numpy type: the host engine views the tensor as bytes."""
    jd, td = _pair(seed)
    n = (jd.extent * 2 + 15) // 2 + 8
    vals = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    raw = vals.view(torch.uint8).numpy().copy()
    if jd.lb + jd.extent > raw.size:
        pytest.fail("buffer too small for the drawn datatype")
    np.testing.assert_array_equal(tdt.pack(vals, td), jdt.pack(raw, jd))


def test_host_engine_refuses_device_tensors():
    td = tdt.contiguous(4, tdt.predefined(4))
    with pytest.raises(ValueError, match="host datatype engine"):
        tdt.pack(torch.zeros(4, device="meta"), td)
    with pytest.raises(ValueError, match="contiguous CPU tensor"):
        tdt.unpack(np.zeros(16, np.uint8), td, torch.zeros(8, 2).t())
