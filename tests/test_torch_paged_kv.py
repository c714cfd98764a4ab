"""The port's device-resident ``PagedKVCache`` against the JAX package's
host-pool one, and ``dt_unpack_into``'s plain version against the host
datatype engine.

Both stores get the same seeded numpy caches (a two-leaf tree of mixed
shapes) and the same sequence of operations — the sequences of the
reference's own unit tests. After each sequence the pool bytes must be
equal byte for byte (the reference's ``_pool`` against the port's pool as
numpy), and so must the page tables, the free list, ``stats()`` and every
gathered cache. On the CPU every page move runs K1's plain versions; the
launch counters stay 0."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import datatype as jdt  # noqa: E402
from repro.core.progress import ProgressEngine as JProgressEngine  # noqa: E402
from repro.serving.paged_kv import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.serving.paged_kv import PagedKVError as JPagedKVError  # noqa: E402
from repro.serving.paged_kv import PoolExhausted as JPoolExhausted  # noqa: E402
from repro_torch.core import datatype as tdt  # noqa: E402
from repro_torch.core.progress import ProgressEngine as TProgressEngine  # noqa: E402
from repro_torch.kernels import dt_pack as tdtp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving.paged_kv import PagedKVCache as TPagedKVCache  # noqa: E402
from repro_torch.serving.paged_kv import PagedKVError as TPagedKVError  # noqa: E402
from repro_torch.serving.paged_kv import PoolExhausted as TPoolExhausted  # noqa: E402
from repro_torch.serving.paged_kv import cache_leaves, cache_rebuild  # noqa: E402


class _Side:
    """One package's store and its copy of the seeded caches."""

    def __init__(self, pkg, max_len=16, batch=3, seed=0, num_pages=8, page_size=4, engine=False):
        rng = np.random.default_rng(seed)
        k = rng.standard_normal((2, batch, max_len, 4)).astype(np.float32)
        v = rng.standard_normal((1, batch, max_len, 2, 2)).astype(np.float32)
        self.pkg = pkg
        self.engine = (JProgressEngine() if pkg == "jax" else TProgressEngine()) if engine else None
        if pkg == "jax":
            template = {"k": jnp.zeros(k.shape, jnp.float32), "v": jnp.zeros(v.shape, jnp.float32)}
            self.filled = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
            cls = JPagedKVCache
        else:
            template = {"k": torch.zeros(k.shape), "v": torch.zeros(v.shape)}
            self.filled = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
            cls = TPagedKVCache
        self.kv = cls(template, max_len=max_len, page_size=page_size, num_pages=num_pages, engine=self.engine)

    def pool(self) -> np.ndarray:
        p = self.kv._pool
        return np.asarray(p) if self.pkg == "jax" else p.numpy()

    def gather(self, rid):
        got = self.kv.gather(rid)
        return {key: np.asarray(got[key]) for key in ("k", "v")}

    def close(self):
        if self.engine is not None:
            self.engine.stop_all()


def _both(**kw):
    return _Side("jax", **kw), _Side("torch", **kw)


def _stats(kv):
    """``stats()`` without the window counters that depend on thread timing
    (the reference copies on threads, the port inline on the CPU)."""
    st = dict(kv.stats())
    win = st.pop("spill_window", None)
    if win is not None:
        st["spill_window"] = {k: win[k] for k in ("depth", "admitted", "reaped", "in_flight", "completed_unreaped")}
    return st


def _assert_same(j, t, rids=()):
    np.testing.assert_array_equal(t.pool(), j.pool())  # byte for byte
    assert t.kv._free == j.kv._free
    assert _stats(t.kv) == _stats(j.kv)
    for rid in rids:
        assert t.kv.page_table(rid) == j.kv.page_table(rid)
        assert t.kv.length(rid) == j.kv.length(rid)


def _assert_gathers_same(j, t, rid, slot, upto):
    jg, tg = j.gather(rid), t.gather(rid)
    for key in ("k", "v"):
        np.testing.assert_array_equal(tg[key], jg[key])
        np.testing.assert_array_equal(tg[key][:, :, :upto], np.asarray(j.filled[key])[:, slot : slot + 1, :upto])
        assert not tg[key][:, :, upto:].any()


def test_append_gather_roundtrip_matches_reference():
    j, t = _both()
    for s in (j, t):
        s.kv.alloc(7)
        s.kv.append(7, s.filled, slot=1, pos0=0, ntok=6)  # prefill: straddles a page
    _assert_same(j, t, [7])
    for s in (j, t):
        s.kv.append(7, s.filled, slot=1, pos0=6, ntok=1)  # decode-step page views
        s.kv.append(7, s.filled, slot=1, pos0=7, ntok=1)
    _assert_same(j, t, [7])
    assert t.kv.length(7) == 8 and t.kv.pages_in_use == 2
    _assert_gathers_same(j, t, 7, slot=1, upto=8)
    for s in (j, t):
        s.kv.release(7)
    _assert_same(j, t)
    assert t.kv.free_pages == 8
    assert tdtp.dt_pack.launches == 0 and tdtp.dt_unpack_into.launches == 0  # CPU: plain versions
    assert t.kv.page_moves() == {"append_chunks": 4, "gather_chunks": 2}


def test_reappend_is_idempotent_and_errors_match_reference():
    j, t = _both()
    for s in (j, t):
        s.kv.alloc(1)
        s.kv.append(1, s.filled, slot=0, pos0=0, ntok=5)
    before = t.pool().copy()
    for s in (j, t):
        s.kv.append(1, s.filled, slot=0, pos0=4, ntok=1)  # elastic repair replay
    np.testing.assert_array_equal(t.pool(), before)  # overwritten byte for byte
    _assert_same(j, t, [1])
    _assert_gathers_same(j, t, 1, slot=0, upto=5)
    for call in (
        lambda s: s.kv.append(1, s.filled, slot=0, pos0=7, ntok=1),  # past stored length
        lambda s: s.kv.append(1, s.filled, slot=0, pos0=4, ntok=3),  # straddles
    ):
        with pytest.raises(JPagedKVError) as j_err:
            call(j)
        with pytest.raises(TPagedKVError) as t_err:
            call(t)
        assert str(t_err.value) == str(j_err.value)
    _assert_same(j, t, [1])


@pytest.mark.parametrize("case", ["not_positional", "pool_too_small"])
def test_non_positional_layouts_rejected_like_reference(case):
    if case == "not_positional":
        j_args = ({"k": jnp.zeros((2, 1, 8, 4))}, 16, 4)
        t_args = ({"k": torch.zeros((2, 1, 8, 4))}, 16, 4)
        kw = {}
    else:
        j_args = ({"k": jnp.zeros((2, 3, 16, 4))}, 16, 4)
        t_args = ({"k": torch.zeros((2, 3, 16, 4))}, 16, 4)
        kw = {"num_pages": 2}
    with pytest.raises(JPagedKVError) as j_err:
        JPagedKVCache(*j_args, **kw)
    with pytest.raises(TPagedKVError) as t_err:
        TPagedKVCache(*t_args, **kw)
    assert str(t_err.value) == str(j_err.value)


def test_rwkv_state_is_rejected():
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("rwkv6-7b", smoke=True)
    with pytest.raises(TPagedKVError, match="position-indexed"):
        TPagedKVCache(api.init_cache(cfg, 2, 16, device="cpu"), 16, 4)


def test_pool_exhaustion_and_release_match_reference():
    j, t = _both(num_pages=4)
    for s in (j, t):
        s.kv.alloc(1)
        s.kv.append(1, s.filled, slot=0, pos0=0, ntok=16)  # takes the whole pool
        s.kv.alloc(2)
    with pytest.raises(JPoolExhausted) as j_err:
        j.kv.append(2, j.filled, slot=1, pos0=0, ntok=1)
    with pytest.raises(TPoolExhausted) as t_err:
        t.kv.append(2, t.filled, slot=1, pos0=0, ntok=1)
    assert str(t_err.value) == str(j_err.value)
    _assert_same(j, t, [1, 2])
    for s in (j, t):
        s.kv.release(1)
        s.kv.append(2, s.filled, slot=1, pos0=0, ntok=3)
    _assert_same(j, t, [2])
    _assert_gathers_same(j, t, 2, slot=1, upto=3)


def test_defrag_matches_reference():
    j, t = _both()
    for s in (j, t):
        for rid, slot in ((1, 0), (2, 1), (3, 2)):
            s.kv.alloc(rid)
            s.kv.append(rid, s.filled, slot=slot, pos0=0, ntok=8)
        s.kv.release(2)  # punch a 2-page hole in the middle
    _assert_same(j, t, [1, 3])
    out = [s.kv.defrag() for s in (j, t)]
    assert out[1] == out[0] == {"live_pages": 4, "moves": 2}
    _assert_same(j, t, [1, 3])
    assert sorted(t.kv.page_table(1) + t.kv.page_table(3)) == [0, 1, 2, 3]
    _assert_gathers_same(j, t, 1, slot=0, upto=8)
    _assert_gathers_same(j, t, 3, slot=2, upto=8)


@pytest.mark.parametrize("engine", [True, False], ids=["window", "inline"])
def test_spill_reload_matches_reference(engine):
    j, t = _both(num_pages=5, engine=engine)
    try:
        for s in (j, t):
            s.kv.alloc(1)
            s.kv.append(1, s.filled, slot=0, pos0=0, ntok=10)  # 2 full pages + tail
        assert t.kv.spillable(1) == j.kv.spillable(1) == 2
        assert [s.kv.spill_prefix(1) for s in (j, t)] == [2, 2]
        for s in (j, t):
            s.kv.reclaim(wait=True)
        _assert_same(j, t, [1])
        assert t.kv.free_pages == 4 and t.kv.page_table(1)[:2] == [None, None]
        for s in (j, t):  # the cold store holds the page bytes
            cold = {key: (np.asarray(v) if s.pkg == "jax" else v.numpy()) for key, v in s.kv._cold.items()}
            s.cold = cold
        assert sorted(t.cold) == sorted(j.cold)
        for key in t.cold:
            np.testing.assert_array_equal(t.cold[key], j.cold[key])
        # gather reloads the cold prefix and the bytes survive the round trip
        _assert_gathers_same(j, t, 1, slot=0, upto=10)
        _assert_same(j, t, [1])
        st = t.kv.stats()
        assert st["spilled_pages"] == 2 and st["reloaded_pages"] == 2 and st["cold_pages"] == 0
    finally:
        j.close()
        t.close()


def test_gather_keeps_the_template_nesting():
    template = {"b": [torch.zeros(1, 2, 8, 3), (torch.zeros(2, 2, 8, 1, 2),)], "a": torch.zeros(1, 2, 8)}
    rng = np.random.default_rng(3)
    filled = cache_rebuild(template, [torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32))
                                      for x in cache_leaves(template)])
    kv = TPagedKVCache(template, max_len=8, page_size=4, num_pages=4)
    kv.alloc(0)
    kv.append(0, filled, slot=1, pos0=0, ntok=6)
    got = kv.gather(0)
    assert list(got) == ["b", "a"] and isinstance(got["b"], list) and isinstance(got["b"][1], tuple)
    for g, f in zip(cache_leaves(got), cache_leaves(filled)):
        assert g.shape == (f.shape[0], 1) + tuple(f.shape[2:])
        assert torch.equal(g[:, 0, :6], f[:, 1, :6]) and not g[:, 0, 6:].any()


# ---------------------------------------------- dt_unpack_into, plain version


@pytest.mark.parametrize("nseg,seg,stride,item,start", [
    (64, 8, 16, 4, 0),
    (128, 16, 64, 4, 0),
    (256, 4, 8, 2, 0),
    (32, 32, 32, 4, 0),  # dense: seg == stride
    (61, 8, 16, 4, 3),   # odd nseg, an offset start
    (300, 16, 4096, 4, 0),
    (24, 1024, 16384, 2, 5 * 1024),  # a decode-step append into a page block
])
def test_dt_unpack_into_plain_matches_host_engine(nseg, seg, stride, item, start):
    """The segments land where the host engine's ``datatype.unpack`` puts
    them and every other byte keeps its value, through the wrapper and
    through ``ops.unpack_datatype_into`` with the descriptor."""
    rng = np.random.default_rng(nseg + seg)
    n = start + nseg * stride + 7  # a tail after the last segment
    dtype, tdtype = (np.float32, torch.float32) if item == 4 else (np.int16, torch.int16)
    packed = rng.integers(-1000, 1000, nseg * seg).astype(dtype)
    background = rng.integers(-1000, 1000, n).astype(dtype)
    descr_j = jdt.hvector(nseg, seg, stride * item, jdt.predefined(item))
    descr_j = jdt.hindexed([1], [start * item], descr_j)
    host = background.copy().view(np.uint8)
    jdt.unpack(packed.view(np.uint8), descr_j, host)

    out = torch.from_numpy(background.copy())
    got = tdtp.dt_unpack_into(torch.from_numpy(packed), out, nseg=nseg, seg_len=seg, stride=stride, start=start)
    assert got is out
    np.testing.assert_array_equal(out.numpy().view(np.uint8), host)

    descr_t = tdt.hindexed([1], [start * item], tdt.hvector(nseg, seg, stride * item, tdt.predefined(item)))
    assert tdt.pack_info(descr_t) == jdt.pack_info(descr_j)
    out2 = torch.from_numpy(background.copy())
    tops.unpack_datatype_into(torch.from_numpy(packed), descr_t, out2)
    np.testing.assert_array_equal(out2.numpy().view(np.uint8), host)
    assert tdtp.dt_unpack_into.launches == 0


@pytest.mark.parametrize("call,match", [
    (lambda p, o: tdtp.dt_unpack_into(p, o, nseg=4, seg_len=8, stride=4), "overlapping"),
    (lambda p, o: tdtp.dt_unpack_into(p, o, nseg=4, seg_len=8, stride=8, start=1), "buffer holds 32"),
    (lambda p, o: tdtp.dt_unpack_into(p[:8], o, nseg=4, seg_len=8, stride=8), "packed holds 8"),
    (lambda p, o: tdtp.dt_unpack_into(p, o.double(), nseg=4, seg_len=8, stride=8), "out is torch.float64"),
    (lambda p, o: tdtp.dt_unpack_into(p, o.reshape(4, 8), nseg=4, seg_len=8, stride=8), "1-D"),
])
def test_dt_unpack_into_rejects_bad_layouts(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.zeros(32), torch.zeros(32))
