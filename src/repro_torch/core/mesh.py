"""The device mesh, partition specs and SPMD regions, with ranks as threads.

The JAX package takes these from JAX: ``jax.make_mesh``, ``Mesh.shape``,
``PartitionSpec``, ``lax.axis_index`` and ``shard_map``, where one
program runs per device of the mesh. The port keeps its own copy, built
on the paper's thread communicators (ext. 5): every mesh position is a
**thread-rank** inside one process, the ``MPIX_Threadcomm_start`` /
``finish`` bracket of :func:`shard_map` runs the per-rank code once per
position, each in its own thread, and the collectives of
:mod:`repro_torch.core.collectives` meet at an in-process rendezvous.

Each position has its own device slot (``Mesh.devices``) and, on a CUDA
device, its own CUDA stream (:meth:`Mesh.rank_stream`): the rank's code
runs with that stream current, so the ranks' device work is independent,
as one device queue per device is in the reference. Several positions
may share one card; the mesh keeps a device per position so that they
need not.

* :class:`Mesh` / :func:`make_mesh` — named axes, row-major positions;
* :class:`P` — partition specs as the reference writes them: one entry
  per leading dim, each ``None``, an axis or a tuple of axes;
* :class:`NamedSharding` / :class:`ShardedTensor` / :func:`device_put` —
  ``jax.sharding.NamedSharding`` and ``jax.device_put(tree, shardings)``:
  a global tensor held as each position's block;
* :func:`axis_index` / :func:`axis_size` — the calling rank's coordinate
  and an axis' size, valid inside a region only;
* :func:`shard_map` — run ``f`` per position: split the inputs by
  ``in_specs``, gather the outputs by ``out_specs``. A rank that raises
  fails the region: its peers blocked in a rendezvous wake with an error
  at once, every rendezvous wait is bounded (``RENDEZVOUS_TIMEOUT_S`` with
  no rank posting), and the first failure is re-raised to the caller.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _python_dispatch

from repro_torch.device import resolve_device

__all__ = [
    "Mesh",
    "make_mesh",
    "P",
    "NamedSharding",
    "ShardedTensor",
    "device_put",
    "axis_index",
    "axis_size",
    "current_region",
    "shard_map",
    "PeerFailed",
    "RENDEZVOUS_TIMEOUT_S",
]

#: Bound on every rendezvous wait of a region (seconds): a rank that has
#: waited this long with no rank of the region posting meanwhile fails it.
RENDEZVOUS_TIMEOUT_S = 10.0


class Mesh:
    """Named axes over a grid of positions, row-major (the last axis
    fastest), one device per position. ``shape`` maps axis name → size in
    axis order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], devices: Sequence):
        axis_names, shape = tuple(axis_names), tuple(int(s) for s in shape)
        if len(axis_names) != len(shape) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {axis_names} do not match shape {shape}")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} has an empty axis")
        devices = tuple(_indexed(torch.device(d)) for d in devices)
        if len(devices) != math.prod(shape):
            raise ValueError(f"{len(devices)} devices for {math.prod(shape)} mesh positions")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices = devices
        self._streams: Dict[int, torch.cuda.Stream] = {}
        self._lock = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, slot: int) -> Dict[str, int]:
        """Axis name → coordinate of position ``slot`` (row-major)."""
        out = {}
        for name in reversed(self.axis_names):
            slot, out[name] = divmod(slot, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_stream(self, slot: int) -> Optional[torch.cuda.Stream]:
        """Position ``slot``'s own CUDA stream, created on first use; None on
        the CPU."""
        dev = self.devices[slot]
        if dev.type != "cuda":
            return None
        with self._lock:
            s = self._streams.get(slot)
            if s is None:
                s = self._streams[slot] = torch.cuda.Stream(device=dev)
            return s

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices})})"


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` → ``cuda:<current device>``, so devices compare equal to
    the ``device`` of the tensors on them."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: Sequence[int], names: Sequence[str], device="cuda") -> Mesh:
    """``jax.make_mesh``: a mesh of ``shape`` named ``names``, every position
    on ``device`` (the card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return Mesh(names, shape, [dev] * math.prod(shape))


class P(tuple):
    """A partition spec, ``jax.sharding.PartitionSpec``: one entry per
    leading dim of the array, each ``None`` (not sharded), an axis name or
    a tuple of axis names (major → minor); dims past the entries are not
    sharded, and ``P()`` is replicated. An axis shards at most one dim."""

    def __new__(cls, *parts):
        parts = tuple(tuple(e) if isinstance(e, list) else e for e in parts)
        # ("data",) is "data", () is None
        parts = tuple(None if e == () else e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in parts)
        seen = []
        for e in parts:
            if e is None:
                continue
            axes = (e,) if isinstance(e, str) else e
            if not isinstance(axes, tuple) or not axes or not all(isinstance(a, str) for a in axes):
                raise ValueError(f"P{parts}: an entry is None, an axis name or a tuple of names")
            seen.extend(axes)
        if len(set(seen)) != len(seen):
            raise ValueError(f"P{parts}: an axis shards at most one dim")
        return super().__new__(cls, parts)

    def dim_axes(self, dim: int) -> Tuple[str, ...]:
        """The axes dim ``dim`` is sharded over (empty when it is not)."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else e

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis the spec shards over, in dim order."""
        return tuple(a for d in range(len(self)) for a in self.dim_axes(d))

    def __repr__(self) -> str:
        return f"P{tuple(self)}"


class NamedSharding:
    """``jax.sharding.NamedSharding``: ``spec`` laid over ``mesh``."""

    def __init__(self, mesh: "Mesh", spec: P):
        if not isinstance(spec, P):
            raise TypeError(f"NamedSharding takes a P, got {spec!r}")
        for a in spec.axes:
            if a not in mesh.shape:
                raise ValueError(f"{spec}: axis {a!r} not in mesh {mesh.shape}")
        self.mesh, self.spec = mesh, spec

    def index(self, slot: int, shape: Sequence[int]) -> Tuple[slice, ...]:
        """Position ``slot``'s block of a global array of ``shape``, one
        slice per dim."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than shape {tuple(shape)} has dims")
        out = []
        for d, n in enumerate(shape):
            index, count = _dim_block(self.mesh, self.spec, d, slot)
            if n % count:
                raise ValueError(f"{self.spec}: dim {d} of shape {tuple(shape)} does not split into {count} blocks")
            step = n // count
            out.append(slice(index * step, (index + 1) * step))
        return tuple(out)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and other.mesh is self.mesh and other.spec == self.spec

    __hash__ = None

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


def _index_key(index: Tuple[slice, ...]) -> tuple:
    return tuple((s.start, s.stop) for s in index)


def _assemble(sharding: NamedSharding, shape, blocks, device=None) -> torch.Tensor:
    """The global tensor of ``shape`` from the positions' ``blocks`` (each
    distinct block taken from the first position that holds it), on
    ``device`` (position 0's by default); autograd tracks the copies."""
    mesh = sharding.mesh
    device = mesh.devices[0] if device is None else device
    out = torch.empty(tuple(shape), dtype=blocks[0].dtype, device=device)
    seen = set()
    for slot, b in enumerate(blocks):
        idx = sharding.index(slot, shape)
        if _index_key(idx) not in seen:
            seen.add(_index_key(idx))
            out[idx] = b.to(device)
    return out


class ShardedTensor:
    """A global tensor of ``shape`` held as its blocks under ``sharding``:
    ``blocks[slot]`` is mesh position ``slot``'s block, on its device. Each
    position holds a tensor of its own, replicas included, as devices do."""

    def __init__(self, shape: Sequence[int], sharding: NamedSharding, blocks: Sequence[torch.Tensor]):
        self.shape = tuple(int(n) for n in shape)
        self.sharding = sharding
        self.blocks = list(blocks)
        if len(self.blocks) != sharding.mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for {sharding.mesh.size} mesh positions")
        for slot, b in enumerate(self.blocks):
            want = tuple(s.stop - s.start for s in self.index(slot))
            if tuple(b.shape) != want or b.dtype != self.blocks[0].dtype:
                raise ValueError(f"block {slot}: {tuple(b.shape)}/{b.dtype}, expected {want}/{self.blocks[0].dtype}")

    @property
    def dtype(self):
        return self.blocks[0].dtype

    @property
    def mesh(self) -> "Mesh":
        return self.sharding.mesh

    def index(self, slot: int) -> Tuple[slice, ...]:
        return self.sharding.index(slot, self.shape)

    def shards(self) -> List[Tuple[Tuple[slice, ...], torch.Tensor]]:
        """(global index, block) for each distinct block, held by the first
        position that holds it: every element exactly once."""
        seen, out = set(), []
        for slot, b in enumerate(self.blocks):
            idx = self.index(slot)
            if _index_key(idx) not in seen:
                seen.add(_index_key(idx))
                out.append((idx, b))
        return out

    def map(self, fn) -> "ShardedTensor":
        """The same layout with ``fn`` applied to each distinct block; the
        positions that hold one block share its result."""
        done = {}
        for slot in range(len(self.blocks)):
            key = _index_key(self.index(slot))
            if key not in done:
                done[key] = fn(self.blocks[slot])
        return ShardedTensor(self.shape, self.sharding, [done[_index_key(self.index(s))] for s in range(len(self.blocks))])

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor, assembled on ``device`` (position 0's by default)."""
        return _assemble(self.sharding, self.shape, [b.detach() for b in self.blocks], device)

    def resident_bytes(self, slot: int) -> int:
        b = self.blocks[slot]
        return b.numel() * b.element_size()

    def __repr__(self) -> str:
        return f"ShardedTensor({self.shape}, {self.dtype}, {self.sharding})"


def device_put(tree, shardings):
    """``jax.device_put(tree, shardings)``: every tensor of ``tree`` (dicts,
    lists and tuples of tensors) as a :class:`ShardedTensor`, each
    position's block copied onto its device. ``shardings`` is one
    :class:`NamedSharding` for every leaf or a tree matching ``tree``."""
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k] if isinstance(shardings, dict) else shardings) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        per = shardings if isinstance(shardings, (list, tuple)) else [shardings] * len(tree)
        return type(tree)(device_put(v, s) for v, s in zip(tree, per))
    if not isinstance(shardings, NamedSharding):
        raise TypeError(f"device_put: {shardings!r} is not a NamedSharding")
    x = torch.as_tensor(tree).detach()
    mesh = shardings.mesh
    blocks = [x[shardings.index(slot, x.shape)].to(mesh.devices[slot]).clone() for slot in range(mesh.size)]
    return ShardedTensor(x.shape, shardings, blocks)


# ----------------------------------------------------------------------
# Regions: the per-rank context and the rendezvous
# ----------------------------------------------------------------------


class PeerFailed(RuntimeError):
    """Raised in a rank whose region failed elsewhere (another rank raised
    or a rendezvous timed out)."""


class _Rendezvous:
    """Where the ranks of one region meet. ``exchange`` posts one rank's
    value under a key and blocks, bounded, until every rank of the key's
    group has posted; all get the values in group-rank order. The entry is
    dropped once every rank has taken it, so the posted values live exactly
    as long as some rank may still read them. Each entry has its own
    condition (on one shared lock), so a completed group wakes its own
    ranks only: with hundreds of thread-ranks, waking every waiter at each
    completion costs more than the region's work.

    With ``turns`` (a semaphore of one) the ranks take turns: a rank holds
    it while it runs and gives it up while it waits here, so the ranks run
    one at a time in the order they queue. A meta-device region takes
    turns: it has no device work to overlap, and hundreds of runnable
    threads contending for the GIL starve some of them past the wait bound."""

    def __init__(self, timeout: float, turns: Optional[threading.Semaphore] = None):
        self.timeout = timeout
        self.turns = turns
        self._lock = threading.Lock()
        self._posted_at = time.monotonic()  # the region's last post: a wait is bounded after it
        self._entries: Dict[tuple, list] = {}
        self.failure: Optional[BaseException] = None

    def fail(self, exc: BaseException) -> None:
        """Fail the region: every waiting and later exchange raises."""
        with self._lock:
            self._fail(exc)

    def _fail(self, exc: BaseException) -> None:
        if self.failure is None:
            self.failure = exc
        for entry in self._entries.values():
            entry[4].notify_all()

    def _check(self) -> None:
        if self.failure is not None:
            raise PeerFailed(f"region failed: {self.failure!r}")

    def take_turn(self) -> None:
        """Wait for the turn, bounded as a rendezvous wait is."""
        while not self.turns.acquire(timeout=self.timeout):
            if time.monotonic() - self._posted_at > self.timeout:
                err = TimeoutError(f"waited for a turn; no rank posted for {self.timeout} s")
                self.fail(err)
                raise err

    def exchange(self, key: tuple, index: int, size: int, value) -> list:
        yielded = False
        try:
            with self._lock:
                self._check()
                entry = self._entries.get(key)
                if entry is None:
                    entry = self._entries[key] = [[None] * size, [False] * size, 0, 0, threading.Condition(self._lock)]
                values, posted = entry[0], entry[1]
                if posted[index]:
                    raise RuntimeError(f"rank {index} posted twice under {key}")
                values[index], posted[index] = value, True
                entry[2] += 1
                self._posted_at = time.monotonic()
                if entry[2] == size:
                    entry[4].notify_all()
                elif self.turns is not None:
                    self.turns.release()  # the next rank in line runs while this one waits
                    yielded = True
                while entry[2] < size:
                    self._check()
                    remaining = self._posted_at + self.timeout - time.monotonic()
                    if remaining <= 0:
                        err = TimeoutError(
                            f"rendezvous {key}: {entry[2]} of {size} ranks arrived; no rank posted for {self.timeout} s"
                        )
                        self._fail(err)
                        raise err
                    entry[4].wait(remaining)
                entry[3] += 1
                if entry[3] == size:
                    del self._entries[key]
                return list(values)
        finally:
            if yielded:  # outside the lock: the rank holding the turn may need it to post
                self.take_turn()


class _Region:
    """One rank's view of an active region: its mesh position, the region's
    rendezvous and a sequence number per collective group."""

    def __init__(self, mesh: Mesh, slot: int, rendezvous: _Rendezvous):
        self.mesh = mesh
        self.slot = slot
        self.coords = mesh.coords(slot)
        self.device = mesh.devices[slot]
        self.rendezvous = rendezvous
        self._seq: Dict[Tuple[str, ...], int] = {}

    def group(self, axes: Sequence[str]) -> Tuple[tuple, int, int]:
        """The group of ranks that share this rank's coordinates on every
        axis outside ``axes``: its key, this rank's index in it (flattened
        over ``axes``, major → minor) and its size."""
        axes = tuple(axes)
        for a in axes:
            if a not in self.mesh.shape:
                raise ValueError(f"axis {a!r} not in mesh {self.mesh.shape}")
        index, size = 0, 1
        for a in axes:
            index = index * self.mesh.shape[a] + self.coords[a]
            size *= self.mesh.shape[a]
        others = tuple((a, c) for a, c in self.coords.items() if a not in axes)
        return (axes, others), index, size

    def exchange(self, axes: Sequence[str], value) -> Tuple[list, int]:
        """Post ``value`` to this rank's group over ``axes`` and return every
        member's value (group order) and this rank's index. The n-th
        exchange of a rank over ``axes`` meets the n-th of its peers."""
        key, index, size = self.group(axes)
        seq = self._seq.get(key[0], 0)
        self._seq[key[0]] = seq + 1
        return self.rendezvous.exchange(key + (seq,), index, size, value), index


_local = threading.local()


def current_region() -> Optional[_Region]:
    """The calling thread's region, or None outside :func:`shard_map`."""
    return getattr(_local, "region", None)


def _region(what: str) -> _Region:
    region = current_region()
    if region is None:
        raise RuntimeError(f"{what}: only valid inside a shard_map region")
    return region


def axis_index(name: str) -> int:
    """``lax.axis_index``: the calling rank's coordinate on axis ``name``."""
    region = _region("axis_index")
    if name not in region.coords:
        raise ValueError(f"axis {name!r} not in mesh {region.mesh.shape}")
    return region.coords[name]


def axis_size(name: str) -> int:
    """The size of mesh axis ``name`` (inside a region)."""
    region = _region("axis_size")
    if name not in region.mesh.shape:
        raise ValueError(f"axis {name!r} not in mesh {region.mesh.shape}")
    return region.mesh.shape[name]


# ----------------------------------------------------------------------
# shard_map
# ----------------------------------------------------------------------


def _dim_block(mesh: Mesh, spec: P, dim: int, slot: int) -> Tuple[int, int]:
    """(block index, block count) of position ``slot`` along ``dim`` under ``spec``."""
    coords, index, count = mesh.coords(slot), 0, 1
    for a in spec.dim_axes(dim):
        if a not in mesh.shape:
            raise ValueError(f"{spec}: axis {a!r} not in mesh {mesh.shape}")
        index, count = index * mesh.shape[a] + coords[a], count * mesh.shape[a]
    return index, count


def _split(x, spec, mesh: Mesh, slot: int):
    """Position ``slot``'s part of input ``x`` under ``spec``, on its device."""
    if not isinstance(spec, P):
        raise TypeError(f"in_specs entry {spec!r} is not a P")
    if not isinstance(x, torch.Tensor):
        if spec.axes:
            raise TypeError(f"{spec} shards a {type(x).__name__}; only tensors can be split")
        return x
    return x[NamedSharding(mesh, spec).index(slot, x.shape)].to(mesh.devices[slot])


def _gather(spec, outs: list, mesh: Mesh):
    """The global output under ``spec`` (a P or a tuple of them, matching
    the per-rank outputs' structure) from every position's output."""
    if isinstance(spec, P):
        if not spec.axes:
            return outs[0]
        if isinstance(outs[0], (tuple, list)):
            return type(outs[0])(_gather(spec, [p[i] for p in outs], mesh) for i in range(len(outs[0])))
        if not all(isinstance(o, torch.Tensor) and o.dim() >= len(spec) for o in outs):
            raise TypeError(f"{spec} gathers {len(spec)} dims: every rank must return a tensor of rank >= {len(spec)}")
        counts = [_dim_block(mesh, spec, d, 0)[1] for d in range(len(spec))]
        shape = [n * c for n, c in zip(outs[0].shape, counts)] + list(outs[0].shape[len(spec):])
        return _assemble(NamedSharding(mesh, spec), shape, outs)
    if isinstance(spec, (tuple, list)):
        if not all(isinstance(o, (tuple, list)) and len(o) == len(spec) for o in outs):
            raise ValueError(f"out_specs has {len(spec)} entries; every rank must return as many outputs")
        return tuple(_gather(s, [o[i] for o in outs], mesh) for i, s in enumerate(spec))
    raise TypeError(f"out_specs entry {spec!r} is not a P or a tuple of them")


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for item in tree for t in _tensors(item)]
    return []


def shard_map(f, mesh: Mesh, in_specs, out_specs):
    """``jax.shard_map``: returns ``mapped(*args)``, which runs ``f`` once per
    mesh position, each in its own thread with that position's region
    context (and, on the card, its own CUDA stream current), on the
    position's part of every argument, and gathers the outputs.

    ``in_specs`` is one :class:`P` for all arguments or a tuple with one per
    argument; ``out_specs`` one P or a tuple matching ``f``'s outputs. A
    sharded output is the concatenation of the ranks' outputs along dim 0,
    a replicated one position 0's. The ranks' device work starts after the
    caller's current stream and the caller's current stream waits for all
    of it, so the result is ordered like any op on that stream.

    The ranks run in the caller's grad mode and under its torch dispatch
    modes (``launch.op_cost.OpCounter`` counts them); a result that autograd tracks
    back into the ranks' work is differentiated by the caller, after the
    region (see :mod:`repro_torch.core.collectives`).

    If a rank raises, the region fails: peers in a rendezvous wake with
    :class:`PeerFailed` and the first failure is re-raised here. Every
    rendezvous wait is bounded by ``RENDEZVOUS_TIMEOUT_S`` seconds. On a
    mesh of meta devices the ranks take turns (:class:`_Rendezvous`)."""

    def mapped(*args):
        if current_region() is not None:
            raise RuntimeError("shard_map: regions do not nest")
        specs = (in_specs,) * len(args) if isinstance(in_specs, P) else tuple(in_specs)
        if len(specs) != len(args):
            raise ValueError(f"{len(specs)} in_specs for {len(args)} arguments")
        cuda = [d for d in mesh.devices if d.type == "cuda"]
        callers = {d: torch.cuda.current_stream(d) for d in set(cuda)}
        started = {}
        for d, s in callers.items():
            started[d] = torch.cuda.Event()
            started[d].record(s)
        turns = threading.Semaphore(1) if all(d.type == "meta" for d in mesh.devices) else None
        rendezvous = _Rendezvous(RENDEZVOUS_TIMEOUT_S, turns)
        grad = torch.is_grad_enabled()  # grad mode is per thread: the ranks take the caller's
        modes = _python_dispatch._get_current_dispatch_mode_stack()  # per thread too
        outs: list = [None] * mesh.size
        done: list = [None] * mesh.size
        errors: list = []

        def run(slot: int) -> None:
            stream = mesh.rank_stream(slot)
            _local.region = _Region(mesh, slot, rendezvous)
            for mode in modes:
                _python_dispatch._push_mode(mode)
            turn = False
            try:
                if turns is not None:
                    rendezvous.take_turn()
                    turn = True
                with torch.set_grad_enabled(grad):
                    if stream is None:
                        outs[slot] = f(*[_split(a, s, mesh, slot) for a, s in zip(args, specs)])
                        return
                    stream.wait_event(started[mesh.devices[slot]])
                    with torch.cuda.stream(stream):
                        outs[slot] = f(*[_split(a, s, mesh, slot) for a, s in zip(args, specs)])
            except BaseException as e:  # noqa: BLE001 — re-raised by the caller below
                errors.append(e)
                rendezvous.fail(e)
            finally:
                if turn:
                    turns.release()
                for _ in modes:
                    _python_dispatch._pop_mode()
                _local.region = None
                if stream is not None:  # the rank's work so far, failed or not
                    done[slot] = torch.cuda.Event()
                    done[slot].record(stream)

        threads = [threading.Thread(target=run, args=(slot,), name=f"mesh-rank-{slot}", daemon=True)
                   for slot in range(mesh.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for slot, ev in enumerate(done):
            if ev is not None:  # the inputs stay untouched until every rank's reads have run
                callers[mesh.devices[slot]].wait_event(ev)
        if errors:
            root = [e for e in errors if not isinstance(e, PeerFailed)]
            raise (root or errors)[0]
        for out in outs:
            for t in _tensors(out):
                if t.device in callers:  # allocated on a rank's stream, read on the caller's
                    t.record_stream(callers[t.device])
        return _gather(out_specs, outs, mesh)

    return mapped
