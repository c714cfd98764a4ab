"""MPI-style derived datatypes with the MPICH iovec extension (paper ext. 2).

The paper's ``MPIX_Type_iov_len`` / ``MPIX_Type_iov`` let applications use
MPI datatypes as a *general-purpose data layout API*: an O(1)-size
descriptor for a non-contiguous layout, with random access to the i-th
contiguous segment (an "iovec") without enumerating all of them.

This module is a faithful port of that algebra:

* constructors mirror ``MPI_Type_contiguous / vector / create_hvector /
  indexed / create_hindexed / create_struct / create_subarray /
  create_resized`` — a descriptor is a small tree, independent of the
  number of segments it describes;
* ``type_iov_len(dt, max_iov_bytes)`` returns the number of whole segments
  within a byte budget (bisection, per the paper);
* ``type_iov(dt, iov_offset, max_iov_len)`` returns segments
  ``[iov_offset, iov_offset + max_iov_len)`` in O(depth + n), *not*
  O(total_segments).

On top of the segment algebra sits the host datatype *engine*:

* ``coalesced_iovs(dt, count)`` / ``iter_runs(dt, max_bytes, count)``
  merge adjacent gap-free segments into maximal contiguous runs (the
  unit consumed by the checkpoint writer — one seek+write per run — and
  the elastic reshard planner);
* ``pack_info(dt)`` is an *exact*, descriptor-derived uniform-layout
  probe: it returns ``(nseg, seg_bytes, stride_bytes, disp0)`` iff every
  segment ``i`` is ``Iov(disp0 + i*stride_bytes, seg_bytes)``, computed
  structurally from the descriptor tree (no sampling — the previous
  first/middle/last spot checks misclassified adversarial ``hindexed``
  layouts and corrupted dense-kernel packs);
* ``pack``/``unpack`` are vectorized: uniform layouts go through a
  ``np.lib.stride_tricks`` window copy, irregular ones through a single
  numpy gather/scatter index built from coalesced runs, and ``count > 1``
  replicates by extent shift without re-enumerating ``iovs()``.
  ``pack_naive``/``unpack_naive`` keep the per-segment reference loop as
  the test oracle and benchmark baseline.

Buffer-origin semantics: MPI lets a datatype address bytes *below* the
buffer pointer (``lb < 0``, e.g. negative ``hindexed`` displacements or a
``resized`` lower bound). A numpy buffer has no bytes below index 0, so
the engine rebases: **byte 0 of the buffer corresponds to the type's
lowest addressed byte** when that is negative (otherwise offsets are used
as-is). Out-of-range accesses raise ``ValueError`` instead of silently
wrapping to the buffer tail, which is what the pre-rebase engine did.

Consumers inside the framework: the sharded checkpoint store (each shard
is a ``subarray`` of the global array), the gradient bucketizer (a
``struct`` over flattened parameter groups), and the ``dt_pack`` CUDA
kernel (device-side pack of the uniform-stride fast path). Buffers may be
numpy arrays or CPU torch tensors of any dtype (viewed as bytes).

Offsets/lengths are plain Python ints (host metadata, never traced).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "Datatype",
    "Iov",
    "predefined",
    "contiguous",
    "vector",
    "hvector",
    "indexed",
    "hindexed",
    "struct",
    "subarray",
    "resized",
    "type_size",
    "type_extent",
    "type_iov_len",
    "type_iov",
    "coalesced_iovs",
    "iter_runs",
    "pack",
    "unpack",
    "pack_naive",
    "unpack_naive",
    "pack_info",
    "make_packer",
]


def _bytes(buf) -> np.ndarray:
    """Flat uint8 view of a host buffer: a numpy array or a CPU torch
    tensor (any dtype — bf16, which numpy lacks, is viewed through
    ``torch.uint8``). A CUDA tensor is refused: this is the host engine."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError(
                f"host datatype engine got a {buf.device} tensor: pack on the card "
                "with repro_torch.kernels.ops.pack_datatype, or copy to the CPU"
            )
        return buf.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)


def _bytes_out(out) -> np.ndarray:
    """Writable flat uint8 view of an unpack destination (numpy array or
    contiguous CPU tensor) sharing its memory."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("unpack destination must be a contiguous CPU tensor")
        return out.reshape(-1).view(torch.uint8).numpy()
    return out.view(np.uint8).reshape(-1)


@dataclass(frozen=True)
class Iov:
    """One contiguous segment: byte offset (from the type origin) + length.

    Mirrors ``MPIX_Iov`` (``iov_base``/``iov_len``); offsets are relative
    because there is no pointer arithmetic in host metadata land.
    """

    offset: int
    length: int

    def __iter__(self):  # allow tuple-unpacking
        yield self.offset
        yield self.length


class Datatype:
    """Base class. Subclasses are immutable descriptor nodes.

    Core protocol (all O(depth) or O(log segments)):
      * ``size``          — bytes of actual data
      * ``extent`` / ``lb`` — span including gaps (MPI semantics)
      * ``num_segments``  — number of maximal contiguous segments
      * ``segment(i)``    — the i-th segment as :class:`Iov`
      * ``cum_bytes(k)``  — total bytes of the first ``k`` segments
      * ``is_contiguous`` — True iff data is one gap-free run starting at 0
    """

    size: int
    lb: int
    extent: int

    # -- protocol -----------------------------------------------------
    @property
    def ub(self) -> int:
        return self.lb + self.extent

    @property
    def num_segments(self) -> int:
        raise NotImplementedError

    def segment(self, i: int) -> Iov:
        raise NotImplementedError

    def cum_bytes(self, k: int) -> int:
        raise NotImplementedError

    @property
    def is_contiguous(self) -> bool:
        return self.num_segments == 1 and self.segment(0) == Iov(self.lb, self.size) and self.lb == 0

    # -- sugar --------------------------------------------------------
    def iovs(self) -> List[Iov]:
        """Enumerate all segments (test/checkpoint use; O(num_segments))."""
        return type_iov(self, 0, self.num_segments)

    def __mul__(self, count: int) -> "Datatype":
        return contiguous(count, self)


# ----------------------------------------------------------------------
# Leaf + combinators
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class _Primitive(Datatype):
    size: int
    name: str = "byte"

    lb: int = field(default=0, init=False)

    @property
    def extent(self) -> int:  # type: ignore[override]
        return self.size

    @property
    def num_segments(self) -> int:
        return 1 if self.size > 0 else 0

    def segment(self, i: int) -> Iov:
        if i != 0 or self.size == 0:
            raise IndexError(i)
        return Iov(0, self.size)

    def cum_bytes(self, k: int) -> int:
        return self.size if k >= 1 else 0


def predefined(nbytes: int, name: str = "byte") -> Datatype:
    """A predefined/primitive type of ``nbytes`` (e.g. MPI_BYTE=1, MPI_FLOAT=4)."""
    if nbytes <= 0:
        raise ValueError("primitive size must be positive")
    return _Primitive(nbytes, name)


BYTE = _Primitive(1, "byte")
FLOAT = _Primitive(4, "float")
DOUBLE = _Primitive(8, "double")
BF16 = _Primitive(2, "bf16")
INT32 = _Primitive(4, "int32")


@dataclass(frozen=True)
class _HVector(Datatype):
    """count blocks of ``blocklength`` base elements, block i at byte
    ``i * stride_bytes``.  ``vector``/``contiguous`` normalize to this."""

    count: int
    blocklength: int
    stride_bytes: int
    base: Datatype

    def __post_init__(self):
        if self.count < 0 or self.blocklength < 0:
            raise ValueError("count/blocklength must be >= 0")

    # -- MPI size/extent ----------------------------------------------
    @property
    def size(self) -> int:  # type: ignore[override]
        return self.count * self.blocklength * self.base.size

    @property
    def lb(self) -> int:  # type: ignore[override]
        if self.count == 0 or self.blocklength == 0:
            return 0
        first = self.base.lb
        if self.stride_bytes < 0:
            return (self.count - 1) * self.stride_bytes + first
        return first

    @property
    def extent(self) -> int:  # type: ignore[override]
        if self.count == 0 or self.blocklength == 0:
            return 0
        block_span = (self.blocklength - 1) * self.base.extent + self.base.extent
        last_start = (self.count - 1) * abs(self.stride_bytes)
        return last_start + block_span

    # -- segment structure ---------------------------------------------
    @property
    def _base_dense(self) -> bool:
        """base packs back-to-back with no holes when tiled at its extent."""
        return self.base.is_contiguous and self.base.size == self.base.extent

    @property
    def _block_bytes(self) -> int:
        return self.blocklength * self.base.size

    @property
    def _segs_per_block(self) -> int:
        if self.blocklength == 0:
            return 0
        if self._base_dense:
            return 1
        return self.blocklength * self.base.num_segments

    @property
    def _fully_merged(self) -> bool:
        """blocks themselves merge into one run (gap-free stride)."""
        return (
            self._base_dense
            and (self.count <= 1 or self.stride_bytes == self._block_bytes)
        )

    @property
    def num_segments(self) -> int:
        if self.count == 0 or self.blocklength == 0 or self.base.size == 0:
            return 0
        if self._fully_merged:
            return 1
        return self.count * self._segs_per_block

    def segment(self, i: int) -> Iov:
        n = self.num_segments
        if not (0 <= i < n):
            raise IndexError(i)
        if self._fully_merged:
            return Iov(self.base.lb, self.size)
        spb = self._segs_per_block
        blk, r = divmod(i, spb)
        off = blk * self.stride_bytes
        if self._base_dense:
            return Iov(off + self.base.lb, self._block_bytes)
        rep, j = divmod(r, self.base.num_segments)
        inner = self.base.segment(j)
        return Iov(off + rep * self.base.extent + inner.offset, inner.length)

    def cum_bytes(self, k: int) -> int:
        k = min(max(k, 0), self.num_segments)
        if k == 0:
            return 0
        if self._fully_merged:
            return self.size
        spb = self._segs_per_block
        blocks, r = divmod(k, spb)
        total = blocks * self._block_bytes
        if r:
            if self._base_dense:  # spb == 1, r == 0 always; defensive
                total += self._block_bytes
            else:
                reps, j = divmod(r, self.base.num_segments)
                total += reps * self.base.size + self.base.cum_bytes(j)
        return total


@dataclass(frozen=True)
class _Blocks(Datatype):
    """Shared machinery for indexed/hindexed/struct: an explicit small list
    of (displacement_bytes, count, child) blocks with prefix sums."""

    displs: Tuple[int, ...]
    counts: Tuple[int, ...]
    children: Tuple[Datatype, ...]

    def __post_init__(self):
        if not (len(self.displs) == len(self.counts) == len(self.children)):
            raise ValueError("blocks must be parallel lists")
        seg_prefix = [0]
        byte_prefix = [0]
        lo = hi = None  # lb/ub computed in the same pass (O(1) properties:
        # the pack engine reads them per call, so recomputing per access
        # would cost O(blocks) on every pack)
        for d, c, ch in zip(self.displs, self.counts, self.children):
            rep = _HVector(c, 1, ch.extent, ch) if c != 1 else ch
            seg_prefix.append(seg_prefix[-1] + (rep.num_segments if c > 0 else 0))
            byte_prefix.append(byte_prefix[-1] + c * ch.size)
            if c > 0 and ch.size > 0:
                lo = d + rep.lb if lo is None else min(lo, d + rep.lb)
                hi = d + rep.ub if hi is None else max(hi, d + rep.ub)
        object.__setattr__(self, "_seg_prefix", tuple(seg_prefix))
        object.__setattr__(self, "_byte_prefix", tuple(byte_prefix))
        object.__setattr__(self, "_lb", 0 if lo is None else lo)
        object.__setattr__(self, "_ub", 0 if hi is None else hi)

    def _rep(self, b: int) -> Datatype:
        c, ch = self.counts[b], self.children[b]
        return _HVector(c, 1, ch.extent, ch) if c != 1 else ch

    @property
    def size(self) -> int:  # type: ignore[override]
        return self._byte_prefix[-1]

    @property
    def lb(self) -> int:  # type: ignore[override]
        return self._lb

    @property
    def extent(self) -> int:  # type: ignore[override]
        return self._ub - self._lb

    @property
    def num_segments(self) -> int:
        return self._seg_prefix[-1]

    def segment(self, i: int) -> Iov:
        if not (0 <= i < self.num_segments):
            raise IndexError(i)
        b = bisect.bisect_right(self._seg_prefix, i) - 1
        inner = self._rep(b).segment(i - self._seg_prefix[b])
        return Iov(self.displs[b] + inner.offset, inner.length)

    def cum_bytes(self, k: int) -> int:
        k = min(max(k, 0), self.num_segments)
        if k == 0:
            return 0
        b = bisect.bisect_right(self._seg_prefix, k - 1) - 1
        return self._byte_prefix[b] + self._rep(b).cum_bytes(k - self._seg_prefix[b])


@dataclass(frozen=True)
class _Resized(Datatype):
    base: Datatype
    new_lb: int
    new_extent: int

    @property
    def size(self) -> int:  # type: ignore[override]
        return self.base.size

    @property
    def lb(self) -> int:  # type: ignore[override]
        return self.new_lb

    @property
    def extent(self) -> int:  # type: ignore[override]
        return self.new_extent

    @property
    def num_segments(self) -> int:
        return self.base.num_segments

    def segment(self, i: int) -> Iov:
        return self.base.segment(i)

    def cum_bytes(self, k: int) -> int:
        return self.base.cum_bytes(k)

    @property
    def is_contiguous(self) -> bool:
        return self.base.is_contiguous and self.new_lb == 0 and self.new_extent == self.size


@dataclass(frozen=True)
class _Shifted(Datatype):
    """Internal: base displaced by ``disp`` bytes, with an overridden
    lb/extent window (used by subarray, which spans the *full* array)."""

    base: Datatype
    disp: int
    win_lb: int
    win_extent: int

    @property
    def size(self) -> int:  # type: ignore[override]
        return self.base.size

    @property
    def lb(self) -> int:  # type: ignore[override]
        return self.win_lb

    @property
    def extent(self) -> int:  # type: ignore[override]
        return self.win_extent

    @property
    def num_segments(self) -> int:
        return self.base.num_segments

    def segment(self, i: int) -> Iov:
        inner = self.base.segment(i)
        return Iov(self.disp + inner.offset, inner.length)

    def cum_bytes(self, k: int) -> int:
        return self.base.cum_bytes(k)


# ----------------------------------------------------------------------
# Public constructors (mirror MPI_Type_*)
# ----------------------------------------------------------------------


def contiguous(count: int, base: Datatype) -> Datatype:
    return _HVector(count, 1, base.extent, base)


def vector(count: int, blocklength: int, stride: int, base: Datatype) -> Datatype:
    """stride in *elements* of base (MPI_Type_vector)."""
    return _HVector(count, blocklength, stride * base.extent, base)


def hvector(count: int, blocklength: int, stride_bytes: int, base: Datatype) -> Datatype:
    return _HVector(count, blocklength, stride_bytes, base)


def indexed(blocklengths: Sequence[int], displacements: Sequence[int], base: Datatype) -> Datatype:
    """displacements in elements of base (MPI_Type_indexed)."""
    return _Blocks(
        tuple(int(d) * base.extent for d in displacements),
        tuple(int(c) for c in blocklengths),
        tuple(base for _ in blocklengths),
    )


def hindexed(blocklengths: Sequence[int], displacements_bytes: Sequence[int], base: Datatype) -> Datatype:
    return _Blocks(
        tuple(int(d) for d in displacements_bytes),
        tuple(int(c) for c in blocklengths),
        tuple(base for _ in blocklengths),
    )


def struct(
    blocklengths: Sequence[int],
    displacements_bytes: Sequence[int],
    types: Sequence[Datatype],
) -> Datatype:
    return _Blocks(
        tuple(int(d) for d in displacements_bytes),
        tuple(int(c) for c in blocklengths),
        tuple(types),
    )


def resized(base: Datatype, lb: int, extent: int) -> Datatype:
    return _Resized(base, lb, extent)


def subarray(
    sizes: Sequence[int],
    subsizes: Sequence[int],
    starts: Sequence[int],
    base: Datatype,
    order: str = "C",
) -> Datatype:
    """MPI_Type_create_subarray. ``base`` must be dense (size == extent).

    The paper's flagship example: the YZ surface of an Nx×Ny×Nz volume is
    Ny·Nz segments but an O(1) two-level nested-vector descriptor.
    """
    sizes, subsizes, starts = list(sizes), list(subsizes), list(starts)
    ndims = len(sizes)
    if not (len(subsizes) == len(starts) == ndims):
        raise ValueError("sizes/subsizes/starts rank mismatch")
    for d in range(ndims):
        if not (0 <= starts[d] and starts[d] + subsizes[d] <= sizes[d]):
            raise ValueError(f"subarray dim {d} out of bounds")
    if base.size != base.extent or not base.is_contiguous:
        raise ValueError("subarray base must be dense")
    if order not in ("C", "F"):
        raise ValueError("order must be 'C' or 'F'")
    if order == "F":
        sizes, subsizes, starts = sizes[::-1], subsizes[::-1], starts[::-1]

    e = base.extent
    # innermost (fastest-varying) dim is contiguous runs of base
    dt: Datatype = contiguous(subsizes[-1], base)
    row_elems = sizes[-1]
    for d in range(ndims - 2, -1, -1):
        stride_elems = math.prod(sizes[d + 1 :])
        dt = hvector(subsizes[d], 1, stride_elems * e, dt)
        row_elems *= sizes[d]
    disp = sum(starts[d] * math.prod(sizes[d + 1 :]) for d in range(ndims)) * e
    full_extent = math.prod(sizes) * e
    return _Shifted(dt, disp, 0, full_extent)


# ----------------------------------------------------------------------
# The MPIX iovec extension API
# ----------------------------------------------------------------------


def type_size(dt: Datatype) -> int:
    return dt.size


def type_extent(dt: Datatype) -> Tuple[int, int]:
    return dt.lb, dt.extent


def type_iov_len(dt: Datatype, max_iov_bytes: int) -> Tuple[int, int]:
    """``MPIX_Type_iov_len``: number of *whole* segments within
    ``max_iov_bytes`` and the bytes they cover.  ``-1`` (or anything >=
    type size) → all segments.  O(log segments · depth) by bisection on
    ``cum_bytes`` — the paper notes max_iov_bytes "can be used to bisect
    the byte offset of an arbitrary segment".
    """
    n = dt.num_segments
    if max_iov_bytes < 0 or max_iov_bytes >= dt.size:
        return n, dt.size
    lo, hi = 0, n  # invariant: cum_bytes(lo) <= max < cum_bytes(hi+..)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if dt.cum_bytes(mid) <= max_iov_bytes:
            lo = mid
        else:
            hi = mid - 1
    return lo, dt.cum_bytes(lo)


def type_iov(dt: Datatype, iov_offset: int, max_iov_len: int) -> List[Iov]:
    """``MPIX_Type_iov``: segments [iov_offset, iov_offset+max_iov_len)."""
    n = dt.num_segments
    if iov_offset < 0:
        raise ValueError("iov_offset must be >= 0")
    stop = min(n, iov_offset + max(0, max_iov_len))
    return [dt.segment(i) for i in range(iov_offset, stop)]


# ----------------------------------------------------------------------
# Exact uniform-layout analysis (descriptor-derived, no sampling)
# ----------------------------------------------------------------------


def _memo(dt: Datatype, key: str, fn):
    """Per-descriptor memoization (the engine analogue of MPICH caching a
    compiled dataloop on the type object).  Keyed by identity, not value:
    ``lru_cache`` would hash/compare the whole descriptor tree — O(blocks)
    per lookup — on every pack call."""
    cache = dt.__dict__.get("_engine_cache")
    if cache is None:
        cache = {}
        object.__setattr__(dt, "_engine_cache", cache)
    if key not in cache:
        cache[key] = fn()
    return cache[key]


def _uniform(dt: Datatype) -> Optional[Tuple[int, int, int, int]]:
    return _memo(dt, "uniform", lambda: _uniform_impl(dt))


def _uniform_impl(dt: Datatype) -> Optional[Tuple[int, int, int, int]]:
    """Exact structural uniformity: ``(n, seg_bytes, stride, disp0)`` iff
    segment ``i`` is ``Iov(disp0 + i*stride, seg_bytes)`` for all ``i``,
    else ``None``.  Mirrors each node's ``segment()`` decomposition, so it
    agrees with enumeration by construction — a non-affine layout can
    never slip through (the sampled predecessor probed only
    first/second/middle/last segments).
    """
    if isinstance(dt, _Primitive):
        return (1, dt.size, 0, 0) if dt.size > 0 else None
    if isinstance(dt, _Resized):
        return _uniform(dt.base)
    if isinstance(dt, _Shifted):
        u = _uniform(dt.base)
        if u is None:
            return None
        n, seg, stride, d0 = u
        return (n, seg, stride, d0 + dt.disp)
    if isinstance(dt, _HVector):
        if dt.count == 0 or dt.blocklength == 0 or dt.base.size == 0:
            return None
        if dt._fully_merged:
            return (1, dt.size, 0, dt.base.lb)
        if dt._base_dense:
            # one segment of _block_bytes per block, blocks at stride_bytes
            if dt.count == 1:  # defensive: count==1 implies _fully_merged
                return (1, dt._block_bytes, 0, dt.base.lb)
            return (dt.count, dt._block_bytes, dt.stride_bytes, dt.base.lb)
        u = _uniform(dt.base)
        if u is None:
            return None
        m, seg, s, d0 = u
        # segment (block b, rep j, inner i) sits at
        #   b*stride_bytes + j*base.extent + d0 + i*s
        # affine overall iff every boundary gap equals the inner stride
        need = []
        if m > 1:
            need.append(s)
        if dt.blocklength > 1:
            need.append(dt.base.extent - (m - 1) * s)
        if dt.count > 1:
            need.append(dt.stride_bytes - (dt.blocklength - 1) * dt.base.extent - (m - 1) * s)
        if not need:  # single segment overall
            return (1, seg, 0, d0)
        stride = need[0]
        if any(g != stride for g in need):
            return None
        return (dt.count * dt.blocklength * m, seg, stride, d0)
    if isinstance(dt, _Blocks):
        parts = []  # (displ, uniform-info) per non-empty block, list order
        for b in range(len(dt.displs)):
            if dt.counts[b] <= 0 or dt.children[b].size == 0:
                continue
            u = _uniform(dt._rep(b))
            if u is None:
                return None
            parts.append((dt.displs[b], u))
        if not parts:
            return None
        seg = parts[0][1][1]
        if any(u[1] != seg for _, u in parts):
            return None
        stride = None
        for _, (m, _seg, s, _d0) in parts:
            if m > 1:
                if stride is None:
                    stride = s
                elif s != stride:
                    return None
        for (dp, (mp, _sp, sp, d0p)), (dn, (_mn, _sn, _snn, d0n)) in zip(parts, parts[1:]):
            gap = (dn + d0n) - (dp + d0p + (mp - 1) * sp)
            if stride is None:
                stride = gap
            elif gap != stride:
                return None
        n = sum(m for _, (m, _seg2, _s2, _d2) in parts)
        d0 = parts[0][0] + parts[0][1][3]
        if n == 1:
            return (1, seg, 0, d0)
        return (n, seg, stride, d0)
    return None  # unknown subclass: conservatively irregular


def pack_info(dt: Datatype):
    """If ``dt`` is a *uniform strided* layout (all segments equal length,
    constant stride), return ``(nseg, seg_bytes, stride_bytes, disp0)`` so a
    device kernel can pack it without a segment list; else ``None``.

    Exact: derived structurally from the descriptor tree (see
    :func:`_uniform`), never sampled.  A returned tuple is a *proof* that
    segment ``i`` equals ``Iov(disp0 + i*stride_bytes, seg_bytes)``; the
    ``dt_pack`` CUDA kernel and ``ops.pack_datatype`` rely on that.
    Irregular layouts fall back to the host engine (:func:`pack`).
    """
    if dt.num_segments == 0:
        return None
    return _uniform(dt)


# ----------------------------------------------------------------------
# Contiguous-run coalescing (the unit of checkpoint I/O and replanning)
# ----------------------------------------------------------------------


def _runs_one(dt: Datatype) -> Tuple[Iov, ...]:
    """Maximal contiguous runs of ONE element of ``dt`` (adjacent gap-free
    segments merged), in pack order.  Memoized: descriptors are frozen."""
    return _memo(dt, "runs", lambda: _runs_one_impl(dt))


def _runs_one_impl(dt: Datatype) -> Tuple[Iov, ...]:
    u = _uniform(dt)
    if u is not None:
        n, seg, stride, d0 = u
        if n == 1 or stride == seg:  # touching segments: one run
            return (Iov(d0, n * seg),)
        if stride > seg:  # constant gap: nothing merges
            return tuple(Iov(d0 + i * stride, seg) for i in range(n))
    runs: List[Iov] = []
    end = None
    for i in range(dt.num_segments):
        s = dt.segment(i)
        if s.length == 0:
            continue
        if end is not None and s.offset == end:
            last = runs[-1]
            runs[-1] = Iov(last.offset, last.length + s.length)
        else:
            runs.append(s)
        end = runs[-1].offset + runs[-1].length
    return tuple(runs)


def iter_runs(
    dt: Datatype, max_bytes: Optional[int] = None, count: int = 1
) -> Iterator[Iov]:
    """Stream the maximal contiguous runs of ``count`` elements of ``dt``.

    Adjacent gap-free segments are merged — including across repetition
    boundaries (a dense type replicated at its extent yields ONE run of
    ``count * size`` bytes).  The single-element run structure is computed
    once and replayed shifted by ``rep * extent``; ``iovs()`` is never
    re-enumerated per repetition.  If ``max_bytes`` is given, runs longer
    than it are split so every yielded :class:`Iov` fits the budget
    (bounded staging buffers for the checkpoint writer).
    """
    if max_bytes is not None and max_bytes <= 0:
        raise ValueError("max_bytes must be positive")
    if count <= 0 or dt.size == 0:
        return
    base_runs = _runs_one(dt)
    pend_off = pend_len = 0
    have = False
    for rep in range(count):
        shift = rep * dt.extent
        for r in base_runs:
            off = r.offset + shift
            if have and off == pend_off + pend_len:
                pend_len += r.length
                continue
            if have:
                yield from _split_run(pend_off, pend_len, max_bytes)
            pend_off, pend_len, have = off, r.length, True
    if have:
        yield from _split_run(pend_off, pend_len, max_bytes)


def _split_run(off: int, ln: int, max_bytes: Optional[int]) -> Iterator[Iov]:
    if max_bytes is None or ln <= max_bytes:
        yield Iov(off, ln)
        return
    p = 0
    while p < ln:
        step = min(max_bytes, ln - p)
        yield Iov(off + p, step)
        p += step


def coalesced_iovs(dt: Datatype, count: int = 1) -> List[Iov]:
    """Maximal contiguous runs of ``count`` elements of ``dt`` (list form
    of :func:`iter_runs`).  Checkpoint writes and reshard plans operate on
    these instead of raw segments: one seek+write per run."""
    return list(iter_runs(dt, None, count))


# ----------------------------------------------------------------------
# Host-side pack/unpack (numpy) — the vectorized MPI datatype engine
# ----------------------------------------------------------------------


def _true_bounds(dt: Datatype) -> Tuple[int, int]:
    """(lowest, highest+1) byte actually addressed by one element — may
    differ from (lb, ub) under ``resized``, which can claim any window."""

    def compute():
        runs = _runs_one(dt)
        if not runs:
            return (0, 0)
        return (min(r.offset for r in runs), max(r.offset + r.length for r in runs))

    return _memo(dt, "bounds", compute)


def _origin_shift(dt: Datatype) -> int:
    """Rebase applied to all offsets: with a negative lower bound the
    buffer's byte 0 stands for the lowest addressed byte (MPI lets data
    live below the buffer pointer; numpy cannot index below 0)."""
    lo = min(dt.lb, _true_bounds(dt)[0])
    return -lo if lo < 0 else 0


def _check_bounds(dt: Datatype, count: int, shift: int, bufsize: int, op: str) -> None:
    t_lo, t_hi = _true_bounds(dt)
    step = (count - 1) * dt.extent
    lo = shift + t_lo + min(0, step)
    hi = shift + t_hi + max(0, step)
    if lo < 0 or hi > bufsize:
        raise ValueError(
            f"{op}: {count} element(s) of the datatype address bytes "
            f"[{lo - shift}, {hi - shift}) relative to the type origin, but the "
            f"buffer holds {bufsize} bytes (buffer byte 0 maps to offset "
            f"{-shift}; negative lower bounds are rebased to it). The old "
            f"engine silently wrapped such accesses to the buffer tail."
        )


# don't pin indices bigger than this on the descriptor: the index costs
# sizeof(intp) per packed byte, so a 100 MB layout would cache ~800 MB
_GATHER_MEMO_MAX_BYTES = 4 << 20


def _gather_index(dt: Datatype, shift: int) -> np.ndarray:
    """Byte gather index for one element, in pack order (built from
    coalesced runs: one ``arange`` per run, not per segment).  Memoized on
    the descriptor so repeated packs skip the index build — except for
    very large layouts, where the memory cost outweighs the rebuild."""

    def compute():
        idx = np.empty(dt.size, dtype=np.intp)
        p = 0
        for off, ln in _runs_one(dt):
            idx[p : p + ln] = np.arange(off + shift, off + shift + ln, dtype=np.intp)
            p += ln
        idx.setflags(write=False)
        return idx

    if dt.size > _GATHER_MEMO_MAX_BYTES:
        return compute()
    return _memo(dt, f"gather@{shift}", compute)


def pack(buf: np.ndarray, dt: Datatype, count: int = 1) -> np.ndarray:
    """Gather ``count`` elements of ``dt`` from byte-buffer ``buf`` into a
    contiguous uint8 array (MPI_Pack) — vectorized.

    Uniform layouts copy through a zero-copy strided window
    (``np.lib.stride_tricks``); irregular layouts build one gather index
    from the coalesced runs and fancy-index all ``count`` repetitions at
    once.  Reference path for the ``dt_pack`` CUDA kernel and the
    checkpoint writer; bounds are checked exactly (see module docstring
    for the negative-``lb`` rebase).
    """
    flat = _bytes(buf)
    out = np.empty(count * dt.size, dtype=np.uint8)
    if count <= 0 or dt.size == 0:
        return out
    shift = _origin_shift(dt)
    _check_bounds(dt, count, shift, flat.size, "pack")
    u = pack_info(dt)
    if u is not None:
        n, seg, stride, d0 = u
        if stride >= 0 and (count == 1 or dt.extent >= 0):
            window = np.lib.stride_tricks.as_strided(
                flat[shift + d0 :], shape=(count, n, seg), strides=(dt.extent, stride, 1)
            )
            out.reshape(count, n, seg)[...] = window
            return out
    idx = _gather_index(dt, shift)
    if count == 1:
        np.take(flat, idx, out=out)
    else:
        reps = np.arange(count, dtype=np.intp) * dt.extent
        out.reshape(count, dt.size)[...] = flat[idx[None, :] + reps[:, None]]
    return out


def make_packer(dt: Datatype, count: int = 1, *, nbytes: int):
    """Pre-resolve a pack program for record-once / replay-many callers
    (``core.schedule``): the :func:`pack_info` proof, origin rebase,
    bounds check, engine-branch dispatch and (for irregular layouts) the
    full ``count``-replicated gather index are all resolved NOW against a
    fixed source-buffer size; the returned closure does none of that
    per call — it is the descriptor-proof memoized into a recorded op.

    Returns ``(packer, proof)`` where ``packer(buf) -> np.uint8[count *
    dt.size]`` is byte-identical to ``pack(buf, dt, count)`` and
    ``proof`` is the :func:`pack_info` tuple (``None`` = irregular, host
    gather path). The buffer-size contract is enforced: a buffer whose
    flat byte size differs from ``nbytes`` raises ``ValueError`` —
    re-resolve (re-record) instead of silently re-deriving.
    """
    if nbytes < 0:
        raise ValueError("make_packer: nbytes must be >= 0")
    size = count * dt.size
    if count <= 0 or dt.size == 0:
        def packer_empty(buf: np.ndarray) -> np.ndarray:
            return np.empty(max(0, size), dtype=np.uint8)

        return packer_empty, pack_info(dt)
    shift = _origin_shift(dt)
    _check_bounds(dt, count, shift, nbytes, "pack")
    u = pack_info(dt)

    def _flat(buf: np.ndarray) -> np.ndarray:
        flat = _bytes(buf)
        if flat.size != nbytes:
            raise ValueError(
                f"make_packer: resolved for a {nbytes}-byte buffer, got "
                f"{flat.size} bytes — the layout changed; re-resolve"
            )
        return flat

    if u is not None:
        n, seg, stride, d0 = u
        if stride >= 0 and (count == 1 or dt.extent >= 0):
            extent = dt.extent
            base = shift + d0

            def packer_strided(buf: np.ndarray) -> np.ndarray:
                flat = _flat(buf)
                out = np.empty(size, dtype=np.uint8)
                window = np.lib.stride_tricks.as_strided(
                    flat[base:], shape=(count, n, seg), strides=(extent, stride, 1)
                )
                out.reshape(count, n, seg)[...] = window
                return out

            return packer_strided, u
    idx = _gather_index(dt, shift)
    if count == 1:

        def packer_gather(buf: np.ndarray) -> np.ndarray:
            out = np.empty(size, dtype=np.uint8)
            np.take(_flat(buf), idx, out=out)
            return out

        return packer_gather, u
    # replicate the per-element index across count up front (pack() pays
    # this add per call)
    reps = np.arange(count, dtype=np.intp) * dt.extent
    full_idx = (idx[None, :] + reps[:, None]).reshape(-1)
    full_idx.setflags(write=False)

    def packer_gather_n(buf: np.ndarray) -> np.ndarray:
        out = np.empty(size, dtype=np.uint8)
        np.take(_flat(buf), full_idx, out=out)
        return out

    return packer_gather_n, u


def unpack(packed: np.ndarray, dt: Datatype, out: np.ndarray, count: int = 1) -> np.ndarray:
    """Scatter a contiguous buffer back through the datatype (MPI_Unpack)
    — vectorized mirror of :func:`pack`.  ``out`` must be contiguous."""
    flat = _bytes_out(out)
    src = _bytes(packed)
    need = count * dt.size
    if src.size < need:
        raise ValueError(f"unpack: packed buffer holds {src.size} bytes, need {need}")
    if count <= 0 or dt.size == 0:
        return out
    shift = _origin_shift(dt)
    _check_bounds(dt, count, shift, flat.size, "unpack")
    u = pack_info(dt)
    if u is not None:
        n, seg, stride, d0 = u
        # strided-view writes need non-overlapping targets
        if stride >= seg and (count == 1 or dt.extent >= (n - 1) * stride + seg):
            window = np.lib.stride_tricks.as_strided(
                flat[shift + d0 :], shape=(count, n, seg), strides=(dt.extent, stride, 1)
            )
            window[...] = src[:need].reshape(count, n, seg)
            return out
    idx = _gather_index(dt, shift)
    if count == 1:
        flat[idx] = src[: dt.size]
    else:
        reps = np.arange(count, dtype=np.intp) * dt.extent
        flat[idx[None, :] + reps[:, None]] = src[:need].reshape(count, dt.size)
    return out


def pack_naive(buf: np.ndarray, dt: Datatype, count: int = 1) -> np.ndarray:
    """Per-segment reference loop (the pre-vectorization engine): the test
    oracle and the benchmark baseline.  Same rebase/bounds semantics."""
    flat = _bytes(buf)
    out = np.empty(count * dt.size, dtype=np.uint8)
    if count <= 0 or dt.size == 0:
        return out
    shift = _origin_shift(dt)
    _check_bounds(dt, count, shift, flat.size, "pack")
    segs = dt.iovs()
    pos = 0
    for rep in range(count):
        basedisp = rep * dt.extent + shift
        for off, ln in segs:
            out[pos : pos + ln] = flat[basedisp + off : basedisp + off + ln]
            pos += ln
    return out


def unpack_naive(packed: np.ndarray, dt: Datatype, out: np.ndarray, count: int = 1) -> np.ndarray:
    """Per-segment reference loop for :func:`unpack`."""
    flat = _bytes_out(out)
    src = _bytes(packed)
    if count <= 0 or dt.size == 0:
        return out
    shift = _origin_shift(dt)
    _check_bounds(dt, count, shift, flat.size, "unpack")
    segs = dt.iovs()
    pos = 0
    for rep in range(count):
        basedisp = rep * dt.extent + shift
        for off, ln in segs:
            flat[basedisp + off : basedisp + off + ln] = src[pos : pos + ln]
            pos += ln
    return out
