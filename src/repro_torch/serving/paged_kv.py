"""Paged KV cache on the device: datatype-described page moves through K1
(paper ext. 2).

The JAX package's ``serving.paged_kv`` on PyTorch. The serving engine's
contiguous design reserves ``max_len`` cache positions per slot for the
whole lifetime of a request. This store splits the KV bytes into
fixed-size **pages** of ``page_size`` token positions, owned per request
through a page table, so memory scales with the tokens actually held and
admission is no longer bounded by ``max_batch`` (see
:class:`~repro_torch.serving.engine.PagedServeEngine`).

The page pool is one ``torch.uint8`` tensor ``(num_pages, page_bytes)`` on
the template's device. The reference keeps its pool in host memory and
copies each whole cache leaf to the host on every append and gather; here
the bytes stay on the card and every move of a token span is addressed by
the same ``core.datatype`` descriptors the reference builds, resolved by
``pack_info`` and run by the datatype kernel (K1):

* **token-span append/gather** — positions ``[p0, p0+n)`` of one batch
  slot are a ``subarray`` of each cache leaf viewed as ``(reps, B, T, K)``
  (``K`` = trailing elements per position); a page's interior is the
  matching ``(reps, page_size, K)`` subarray of its per-leaf block. Each
  (page chunk, leaf) is one K1 pack of the source span followed by one K1
  ``dt_unpack_into`` of the destination span: the in-place scatter, which
  leaves the page's other positions (and the cache's other rows) as they
  are. Both work on ``uint8`` views, so they are byte-exact for any dtype.
* **defrag** — live pages are compacted to the head of the pool with one
  row gather on the device (the reference's single ``hindexed`` pack; it
  runs outside any Pallas kernel there too).
* **eviction / reload** — cold pages spill to pinned host memory and come
  back. Each copy is a ``copy_(non_blocking=True)`` on the spill MPIX
  stream's CUDA stream (the store's launch stream for ``STREAM_NULL``),
  ordered after the pool's producers; its completion is a CUDA event,
  admitted through the spill :class:`~repro_torch.core.enqueue.OffloadWindow`
  as a generalized request whose ``poll_fn`` is ``event.query()`` (the
  paper's ``cudaEventQuery`` poll). A spilled row returns to the free list
  only in :meth:`PagedKVCache.reclaim`, after its event; a gather after a
  reload waits on the reload's event on the stream that launches it. On
  the CPU the copies run inline.

All device work is issued on the **launch stream**: the current CUDA stream
of the thread that built the store (the engine's). The current stream is
thread-local, so worker threads that append (the threaded and elastic
generation loops) still order their launches after rank 0's decode and
before the next one.

Layout of one page (``page_bytes = page_size * token_bytes``)::

    [ leaf0: (reps0, page_size, K0) | leaf1: (reps1, page_size, K1) | ... ]

Leaves follow the order ``jax.tree`` walks (dict keys sorted, sequences in
order); ``gather`` returns a B=1 cache with the template's nesting. Only
position-indexed caches are supported: every leaf must carry the full
``max_len`` on axis 2 (dense attention); RWKV's recurrent state is
rejected up front.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import datatype as dtt
from repro_torch.core.enqueue import OffloadWindow, _poll_dispatched, _wait_dispatched
from repro_torch.core.progress import ProgressEngine
from repro_torch.core.streams import MPIXStream, STREAM_NULL
from repro_torch.kernels import ops
from repro_torch.tracing import span

__all__ = ["PagedKVCache", "PagedKVError", "PoolExhausted", "cache_leaves", "cache_rebuild"]


class PagedKVError(ValueError):
    """Unsupported cache layout or a page-table contract violation."""


class PoolExhausted(PagedKVError):
    """No free page and nothing reclaimable — the caller must spill or
    shed load."""


def cache_leaves(cache) -> List[torch.Tensor]:
    """The tensors of a nested dict/list/tuple cache in a fixed order: dict
    keys sorted, sequences in order — the order ``jax.tree`` walks. That
    covers the transformer's groups → pattern → (K, V) and RWKV's
    ``{"wkv", "x_cm", "x_tm"}`` state."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    if isinstance(cache, dict):
        return [t for key in sorted(cache) for t in cache_leaves(cache[key])]
    if isinstance(cache, (list, tuple)):
        return [t for sub in cache for t in cache_leaves(sub)]
    raise TypeError(f"cache leaf of type {type(cache).__name__} is not a tensor")


def cache_rebuild(template, leaves):
    """A cache with ``template``'s nesting whose tensors are ``leaves``, in
    :func:`cache_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        raise TypeError(f"cache leaf of type {type(node).__name__} is not a tensor")

    return build(template)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s storage as a flat ``uint8`` tensor (a view: writes land in
    ``t``)."""
    if not t.is_contiguous():
        raise PagedKVError(f"paged KV moves need contiguous cache leaves, got strides {t.stride()}")
    return t.reshape(-1).view(torch.uint8)


@dataclass(frozen=True)
class _LeafSpec:
    """Static layout of one cache leaf inside the page format."""

    reps: int  # leaves stacked on axis 0 (layers per group)
    T: int  # positions (== max_len, checked)
    K: int  # trailing elems per position (n_kv * head_dim, or 1)
    tail: Tuple[int, ...]  # trailing dims, for reconstruction
    dtype: torch.dtype
    itemsize: int
    rec_bytes: int  # bytes of this leaf's share of one token record
    block_off: int  # byte offset of this leaf's block inside a page
    block_bytes: int  # page_size * rec_bytes


# -- descriptors (the only addressing in this module) ----------------------
# Built exactly as the reference builds them and resolved by ``pack_info``
# into the (nseg, seg_bytes, stride_bytes, disp) the kernel runs; memoized,
# since a serving run repeats a small set of spans.


def _resolved(descr: dtt.Datatype):
    return descr, dtt.pack_info(descr)


@functools.lru_cache(maxsize=4096)
def _cache_span_dt(spec: _LeafSpec, B: int, slot: int, p0: int, ntok: int):
    """Positions ``[p0, p0+ntok)`` of batch row ``slot`` inside a cache
    leaf viewed as ``(reps, B, T, K)``. Packed order (rep, pos, K)."""
    return _resolved(
        dtt.subarray(
            (spec.reps, B, spec.T, spec.K),
            (spec.reps, 1, ntok, spec.K),
            (0, slot, p0, 0),
            dtt.predefined(spec.itemsize),
        )
    )


@functools.lru_cache(maxsize=4096)
def _page_span_dt(spec: _LeafSpec, page_size: int, a: int, ntok: int):
    """The matching span inside a page's per-leaf ``(reps, page_size, K)``
    block, starting at page-relative position ``a``."""
    return _resolved(
        dtt.subarray(
            (spec.reps, page_size, spec.K),
            (spec.reps, ntok, spec.K),
            (0, a, 0),
            dtt.predefined(spec.itemsize),
        )
    )


def _move(src: torch.Tensor, src_dt, dst: torch.Tensor, dst_dt) -> None:
    """One K1 page move between two flat ``uint8`` buffers, each span a
    resolved ``(descriptor, pack_info)``: pack the source span, scatter it
    into the destination span in place."""
    packed = ops.pack_datatype(src, src_dt[0], info=src_dt[1])
    ops.unpack_datatype_into(packed, dst_dt[0], dst, info=dst_dt[1])


class PagedKVCache:
    """Fixed-size-page KV store with per-request page tables.

    ``template`` is a live cache (any batch size) used only to derive the
    per-leaf layout and the device; the pool itself is ``num_pages`` rows of
    ``page_bytes`` on that device. Requests ``alloc`` a table, ``append``
    token spans gathered from a batch cache, and ``gather`` back a B=1 cache
    for slot activation. Append and gather move bytes through
    ``core.datatype`` descriptors and K1 only.
    """

    def __init__(
        self,
        template,
        max_len: int,
        page_size: int = 16,
        num_pages: int = 64,
        engine: Optional[ProgressEngine] = None,
        spill_stream: MPIXStream = STREAM_NULL,
        spill_depth: int = 2,
    ):
        if page_size < 1:
            raise PagedKVError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 1:
            raise PagedKVError(f"num_pages must be >= 1, got {num_pages}")
        leaves = cache_leaves(template)
        if not leaves:
            raise PagedKVError("cache template has no leaves")
        specs: List[_LeafSpec] = []
        off = 0
        for leaf in leaves:
            if leaf.dim() < 3 or leaf.shape[2] != max_len:
                raise PagedKVError(
                    f"paged KV needs position-indexed leaves (axis 2 == max_len="
                    f"{max_len}); got shape {tuple(leaf.shape)} — ring-buffer windowed "
                    "or state-space caches are not pageable"
                )
            tail = tuple(int(d) for d in leaf.shape[3:])
            K = int(math.prod(tail)) if tail else 1
            item = leaf.element_size()
            rec = leaf.shape[0] * K * item
            specs.append(
                _LeafSpec(
                    reps=int(leaf.shape[0]),
                    T=max_len,
                    K=K,
                    tail=tail,
                    dtype=leaf.dtype,
                    itemsize=item,
                    rec_bytes=rec,
                    block_off=off,
                    block_bytes=page_size * rec,
                )
            )
            off += page_size * rec
        self._specs = specs
        # the template's nesting, without holding on to its tensors
        self._skeleton = cache_rebuild(template, [torch.empty(0) for _ in leaves])
        self.device = leaves[0].device
        self.max_len = max_len
        self.page_size = page_size
        self.num_pages = num_pages
        self.token_bytes = sum(s.rec_bytes for s in specs)
        self.page_bytes = off
        if num_pages < self.pages_for(max_len):
            raise PagedKVError(
                f"pool of {num_pages} pages cannot hold one max_len={max_len} "
                f"request ({self.pages_for(max_len)} pages)"
            )
        self._cuda = self.device.type == "cuda"
        # the launch stream (see the module doc) and the spill copies' stream
        self._stream = torch.cuda.current_stream(self.device) if self._cuda else None
        self._copy_stream = (spill_stream.torch_stream(self.device) or self._stream) if self._cuda else None
        self._pool = torch.zeros((num_pages, self.page_bytes), dtype=torch.uint8, device=self.device)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))  # pop() = lowest last
        self._tables: Dict[int, List[Optional[int]]] = {}  # rid -> physical page per logical idx (None = spilled)
        self._len: Dict[int, int] = {}  # rid -> tokens stored
        self._cold: Dict[Tuple[int, int], torch.Tensor] = {}  # (rid, logical idx) -> page bytes (host)
        self._lock = threading.RLock()
        self.engine = engine
        self._window = (
            OffloadWindow(spill_stream, depth=spill_depth, engine=engine, name="kv-spill")
            if engine is not None
            else None
        )
        self._spill_stream = spill_stream
        # counters
        self._appends = 0
        self._gathers = 0
        self._spilled_pages = 0
        self._reloaded_pages = 0
        self._defrag_moves = 0
        self._peak_pages = 0
        self._append_chunks = 0  # (page chunk) moves, each one K1 pack + unpack per leaf
        self._gather_chunks = 0

    # -- geometry ---------------------------------------------------------
    def pages_for(self, ntok: int) -> int:
        return -(-max(0, int(ntok)) // self.page_size)

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - self.free_pages

    @property
    def leaf_count(self) -> int:
        return len(self._specs)

    def length(self, rid: int) -> int:
        return self._len[rid]

    def page_table(self, rid: int) -> List[Optional[int]]:
        with self._lock:
            return list(self._tables[rid])

    def page_moves(self) -> dict:
        """Page chunks moved by :meth:`append` and :meth:`gather`; on the
        card each chunk is one K1 pack and one K1 ``dt_unpack_into`` per
        leaf."""
        with self._lock:
            return {"append_chunks": self._append_chunks, "gather_chunks": self._gather_chunks}

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._cuda else contextlib.nullcontext()

    def _leaf_block(self, pid: int, spec: _LeafSpec) -> torch.Tensor:
        return self._pool[pid, spec.block_off : spec.block_off + spec.block_bytes]

    def _chunks(self, p0: int, ntok: int):
        """Split ``[p0, p0+ntok)`` into page-aligned (logical_page, a, n)."""
        p = p0
        end = p0 + ntok
        while p < end:
            j, a = divmod(p, self.page_size)
            n = min(end - p, self.page_size - a)
            yield j, a, n
            p += n

    # -- allocation --------------------------------------------------------
    def alloc(self, rid: int) -> None:
        with self._lock:
            if rid in self._tables:
                raise PagedKVError(f"rid {rid} already allocated")
            self._tables[rid] = []
            self._len[rid] = 0

    def release(self, rid: int) -> None:
        with self._lock:
            table = self._tables.pop(rid, None)
            self._len.pop(rid, None)
            if table is None:
                return
            for j, pid in enumerate(table):
                if pid is not None:
                    self._free.append(pid)
                self._cold.pop((rid, j), None)

    def _alloc_page(self, rid: int) -> int:
        with self._lock:
            if not self._free:
                raise PoolExhausted(
                    f"KV pool exhausted ({self.num_pages} pages in use); spill "
                    "parked requests or grow the pool"
                )
            pid = self._free.pop()
            self._tables[rid].append(pid)
            self._peak_pages = max(self._peak_pages, self.num_pages - len(self._free))
            return pid

    # -- token-span write: prefill splice + decode-step page views ---------
    def append(self, rid: int, cache, slot: int, pos0: int, ntok: int) -> None:
        """Copy positions ``[pos0, pos0+ntok)`` of batch row ``slot`` of
        ``cache`` (any cache with this store's leaf layout; B=1 prefill
        caches and the full batch cache both work) into ``rid``'s pages.
        Append-only past the stored length; re-writing an already-stored
        span is allowed and overwrites it in place, byte for byte (the
        elastic loop's transactional step repair may replay a step)."""
        with self._lock, span("kv.append", rid=rid, k1=ops.k1_launches):
            cur = self._len[rid]
            if pos0 > cur:
                raise PagedKVError(f"append at {pos0} past stored length {cur}")
            if pos0 < cur and pos0 + ntok > cur:
                raise PagedKVError("span straddles the stored length")
            new_len = max(cur, pos0 + ntok)
            while len(self._tables[rid]) < self.pages_for(new_len):
                self._alloc_page(rid)
            table = self._tables[rid]
            leaves = cache_leaves(cache)
            if len(leaves) != len(self._specs):
                raise PagedKVError("cache tree does not match the paged template")
            srcs = [_bytes(leaf) for leaf in leaves]
            with self._on_stream():
                for j, a, n in self._chunks(pos0, ntok):
                    pid = table[j]
                    if pid is None:
                        raise PagedKVError(f"append into spilled page {j} of rid {rid}")
                    p = j * self.page_size + a  # absolute position of this chunk
                    for spec, leaf, src in zip(self._specs, leaves, srcs):
                        _move(
                            src, _cache_span_dt(spec, int(leaf.shape[1]), slot, p, n),
                            self._leaf_block(pid, spec), _page_span_dt(spec, self.page_size, a, n),
                        )
                    self._append_chunks += 1
            self._len[rid] = new_len
            self._appends += 1

    # -- token-span read: slot activation ----------------------------------
    def gather(self, rid: int):
        """Scatter ``rid``'s pages into a fresh B=1 cache with the
        template's nesting (positions past the stored length are zero,
        matching ``init_cache``). Reloads any spilled pages first."""
        with span("kv.gather", rid=rid, k1=ops.k1_launches):
            self.ensure_resident(rid)
            with self._lock:
                length = self._len[rid]
                table = self._tables[rid]
                with self._on_stream():
                    out = [
                        torch.zeros((spec.reps, 1, spec.T) + spec.tail, dtype=spec.dtype, device=self.device)
                        for spec in self._specs
                    ]
                    dsts = [_bytes(o) for o in out]
                    for j, a, n in self._chunks(0, length):
                        pid = table[j]
                        for spec, dst in zip(self._specs, dsts):
                            _move(
                                self._leaf_block(pid, spec), _page_span_dt(spec, self.page_size, a, n),
                                dst, _cache_span_dt(spec, 1, 0, j * self.page_size + a, n),
                            )
                        self._gather_chunks += 1
                self._gathers += 1
        return cache_rebuild(self._skeleton, out)

    # -- eviction: spill/reload through the offload window ------------------
    def _copy_page(self, dst: torch.Tensor, src: torch.Tensor, value):
        """Copy one page of bytes ``src`` → ``dst`` as a generalized request
        admitted through the spill window — bounded in-flight copies,
        completion-order reaping. On the card the copy is issued on the
        spill stream after the launch stream's work so far, and completes at
        a CUDA event the request polls; on the CPU it runs inline. Returns
        the event (None on the CPU)."""
        if self._cuda:
            side = self._copy_stream
            side.wait_stream(self._stream)
            with torch.cuda.stream(side):
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        else:
            dst.copy_(src)
            event = None
        if self._window is None:
            return event
        state = {"y": (dst, src), "event": event}
        with self._window.issue() as submit:
            g = self.engine.grequest_start(
                poll_fn=_poll_dispatched,
                wait_fn=_wait_dispatched,
                extra_state=state,
                stream=self._spill_stream,
                name="kv-spill",
            )
            submit(g, value=value, token=event)
        return event

    def spillable(self, rid: int) -> int:
        """Resident *full* pages of ``rid`` (the cold-prefix candidates —
        a partially filled tail page stays resident for appends)."""
        with self._lock:
            full = self._len[rid] // self.page_size
            return sum(1 for pid in self._tables[rid][:full] if pid is not None)

    def spill_prefix(self, rid: int, max_pages: Optional[int] = None) -> int:
        """Spill up to ``max_pages`` cold prefix pages (lowest logical
        index first) of ``rid`` to the host cold store, each copy through
        the offload window. Pool rows are freed by :meth:`reclaim` once
        the copies complete. Returns the number of spills submitted."""
        submitted = 0
        with span("kv.spill", rid=rid), self._lock:
            full = self._len[rid] // self.page_size
            table = self._tables[rid]
            for j in range(full):
                if max_pages is not None and submitted >= max_pages:
                    break
                pid = table[j]
                if pid is None:
                    continue
                # the pool row stays owned until reclaim() observes the
                # completed copy; the cold bytes are valid from then on
                dst = torch.empty(self.page_bytes, dtype=torch.uint8, pin_memory=self._cuda)
                self._cold[(rid, j)] = dst
                table[j] = None
                event = self._copy_page(dst, self._pool[pid], value=("spill", rid, j, pid))
                if self._window is None:
                    # nothing observes the copy on the host: the row is free
                    # at once, and the launch stream waits for the copy on
                    # the device before any later launch can reuse it
                    if event is not None:
                        self._stream.wait_event(event)
                    self._free.append(pid)
                submitted += 1
                self._spilled_pages += 1
        return submitted

    def reclaim(self, wait: bool = False) -> int:
        """Harvest completed spill copies, returning their pool rows to
        the free list. ``wait=True`` drains the window first."""
        if self._window is None:
            return 0
        with span("kv.reclaim"):
            slots = self._window.drain() if wait else self._window.reap()
            freed = 0
            with self._lock:
                for s in slots:
                    kind = s.value[0]
                    if kind == "spill":
                        _, _rid, _j, pid = s.value
                        self._free.append(pid)
                        freed += 1
        return freed

    def ensure_resident(self, rid: int) -> int:
        """Reload every spilled page of ``rid`` from the cold store into
        fresh pool rows (copies through the offload window, drained before
        returning; on the card the launch stream also waits on each copy's
        event, so the gather that follows is ordered after it). Returns
        pages reloaded."""
        self.reclaim(wait=self._window is not None and self._window.in_flight() > 0)
        reloaded = 0
        with self._lock:
            table = self._tables[rid]
            for j, pid in enumerate(table):
                if pid is not None:
                    continue
                new_pid = self._alloc_page_for(rid, j)
                data = self._cold.pop((rid, j))
                event = self._copy_page(self._pool[new_pid], data, value=("reload", rid, j, new_pid))
                if event is not None:
                    self._stream.wait_event(event)  # the gather that follows reads this row
                reloaded += 1
                self._reloaded_pages += 1
        if self._window is not None and reloaded:
            self._window.wait_all()
            self.reclaim()
        return reloaded

    def _alloc_page_for(self, rid: int, j: int) -> int:
        if not self._free:
            raise PoolExhausted(
                f"KV pool exhausted reloading rid {rid} page {j}; spill more "
                "parked requests or grow the pool"
            )
        pid = self._free.pop()
        self._tables[rid][j] = pid
        self._peak_pages = max(self._peak_pages, self.num_pages - len(self._free))
        return pid

    # -- defrag ------------------------------------------------------------
    def defrag(self) -> dict:
        """Compact every live page to the head of the pool, in (rid,
        logical-index) order, with one row gather on the launch stream.
        Page tables are rewritten; the free list becomes one dense tail
        run. Requires no spill copies in flight (drains the window)."""
        self.reclaim(wait=self._window is not None and self._window.in_flight() > 0)
        with self._lock:
            order: List[Tuple[int, int, int]] = []  # (rid, j, old pid)
            for rid in sorted(self._tables):
                for j, pid in enumerate(self._tables[rid]):
                    if pid is not None:
                        order.append((rid, j, pid))
            nlive = len(order)
            moves = sum(1 for new, (_r, _j, old) in enumerate(order) if new != old)
            if moves:
                rows = torch.tensor([pid for (_r, _j, pid) in order], dtype=torch.long)
                with self._on_stream():
                    self._pool[:nlive] = self._pool[rows.to(self.device)]
                for new, (rid, j, _old) in enumerate(order):
                    self._tables[rid][j] = new
            self._free = list(range(self.num_pages - 1, nlive - 1, -1))
            self._defrag_moves += moves
            return {"live_pages": nlive, "moves": moves}

    # -- instrumentation ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            out = {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "page_bytes": self.page_bytes,
                "token_bytes": self.token_bytes,
                "pages_in_use": self.num_pages - len(self._free),
                "peak_pages": self._peak_pages,
                "live_requests": len(self._tables),
                "appends": self._appends,
                "gathers": self._gathers,
                "spilled_pages": self._spilled_pages,
                "reloaded_pages": self._reloaded_pages,
                "defrag_moves": self._defrag_moves,
                "cold_pages": len(self._cold),
            }
        if self._window is not None:
            out["spill_window"] = self._window.stats(engine=False)
        return out
