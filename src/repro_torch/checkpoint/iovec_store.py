"""Sharded checkpoint store built on the datatype/iovec extension.

Layout: one binary file per tree leaf holding the GLOBAL logical array;
every shard describes its slice as a ``subarray`` datatype of the global
shape and writes exactly its iovec runs at their global byte offsets —
adjacent gap-free segments are coalesced first (``dt.iter_runs``), so a
shard whose inner dims are dense issues ONE seek+write instead of one
per segment. No gather, no per-shard files to merge: the store knows
nothing about meshes or modules, only about iovecs.

The on-disk format is the JAX package's (``repro.checkpoint.iovec_store``),
byte for byte: the same leaf names (``a/b/0/c``, dict keys sorted, list
items by index), one ``<name with / as .>.bin`` per leaf, and the JSON
manifest — pytree structure, shapes, dtypes, step — written last as the
atomic completeness marker. Either package loads the other's checkpoints.

Trees are nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or :class:`StackedLeaf`. A :class:`StackedLeaf` is a global leaf
held as its rows — the port keeps one parameter per layer where the
reference stacks a layer group on a leading axis — and each row is written
as the shard ``(slice(l, l + 1), ...)`` of the global leaf, with no stacked
copy. numpy has no bfloat16 of its own, so a bf16 leaf goes to disk as its
raw 2-byte words; the manifest still says ``"bfloat16"``.

A sharded leaf — any leaf with ``.shards()``, such as a
:class:`~repro_torch.core.mesh.ShardedTensor` or a :class:`StackedLeaf` of
them — is written block by block, each block once, at its global offsets:
the files do not depend on the layout the state was saved from.
:func:`load_pytree` with ``shardings=`` reads each block of the requested
layout through its ``shard_subarray`` and nothing else of the file.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import datatype as dt

__all__ = [
    "StackedLeaf",
    "RowShardings",
    "save_pytree",
    "load_pytree",
    "leaf_names",
    "map_leaves",
    "tree_tensors",
    "shard_subarray",
    "manifest_path",
    "dtype_name",
]


class StackedLeaf:
    """A global leaf of shape ``(len(rows), *rows[0].shape)`` held as its
    rows: ``rows[l]`` is ``global[l]``. The rows share one shape, dtype and
    device."""

    def __init__(self, rows):
        rows = list(rows)
        if not rows:
            raise ValueError("a stacked leaf needs at least one row")
        first = rows[0]
        for r in rows[1:]:
            if tuple(r.shape) != tuple(first.shape) or r.dtype != first.dtype:
                raise ValueError(f"stacked rows differ: {tuple(r.shape)}/{r.dtype} vs {tuple(first.shape)}/{first.dtype}")
        self.rows = rows

    @property
    def shape(self) -> Tuple[int, ...]:
        return (len(self.rows),) + tuple(self.rows[0].shape)

    @property
    def dtype(self):
        return self.rows[0].dtype

    def shards(self) -> List[Tuple[Tuple[slice, ...], object]]:
        """(global index, data) per row, or per block of a sharded row."""
        out = []
        for l, r in enumerate(self.rows):
            row = (slice(l, l + 1),)
            out += [(row + idx, b) for idx, b in _shards(r)]
        return out


class RowShardings:
    """The ``shardings=`` leaf of a :class:`StackedLeaf` whose rows are laid
    out apart: ``rows[l]`` is row ``l``'s sharding (ZeRO-1's moments of one
    layer each, held by one dp rank: ``core.mesh.StackRow``)."""

    def __init__(self, rows):
        self.rows = list(rows)


def dtype_name(dtype) -> str:
    """The manifest's dtype string (numpy's name: ``float32``, ``bfloat16``...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _storage(name: str) -> np.dtype:
    """The numpy dtype a leaf of manifest dtype ``name`` is read as: its
    raw 16-bit words for bfloat16."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray)) or hasattr(x, "shards")


def leaf_names(tree) -> Dict[str, object]:
    """Stable flat names for tree leaves: 'a/b/0/c', in the JAX package's
    flattening order (dict keys sorted, sequences by index)."""
    out: Dict[str, object] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif _is_leaf(node):
            out["/".join(path)] = node
        else:
            raise TypeError(f"leaf {'/'.join(path)!r} is a {type(node).__name__}, not a tensor or array")

    walk(tree, ())
    return out


def map_leaves(fn, tree):
    """The tree with every tensor (and every row of a :class:`StackedLeaf`)
    replaced by ``fn(tensor)``."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    if isinstance(tree, StackedLeaf):
        return StackedLeaf([map_leaves(fn, r) for r in tree.rows])
    if hasattr(tree, "shards"):  # a sharded leaf: each distinct block once
        return tree.map(fn)
    return fn(tree)


def tree_tensors(tree) -> list:
    """Every tensor of the tree (the rows of a :class:`StackedLeaf` in row
    order), in :func:`map_leaves` order."""
    out: list = []

    def take(t):
        out.append(t)
        return t

    map_leaves(take, tree)
    return out


def shard_subarray(global_shape, index: Tuple[slice, ...], itemsize: int) -> dt.Datatype:
    """Datatype describing a shard (tuple of slices) of the global array."""
    sizes = list(global_shape)
    subsizes = []
    starts = []
    for dim, sl in zip(global_shape, index):
        start = sl.start or 0
        stop = sl.stop if sl.stop is not None else dim
        subsizes.append(stop - start)
        starts.append(start)
    if not sizes:  # scalar
        return dt.contiguous(1, dt.predefined(itemsize))
    return dt.subarray(sizes, subsizes, starts, dt.predefined(itemsize))


def manifest_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "manifest.json")


def _leaf_file(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, name.replace("/", ".") + ".bin")


def _raw(data) -> memoryview:
    """The C-order bytes of a host tensor or array, without a copy where it
    is contiguous (a device tensor is copied to the host first)."""
    if isinstance(data, torch.Tensor):
        t = data.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        return memoryview(t.contiguous().reshape(-1).view(torch.uint8).numpy())
    return memoryview(np.ascontiguousarray(data).reshape(-1).view(np.uint8))


def _shards(leaf) -> List[Tuple[Tuple[slice, ...], object]]:
    if hasattr(leaf, "shards"):
        return leaf.shards()
    return [(tuple(slice(0, s) for s in leaf.shape), leaf)]


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def save_pytree(ckpt_dir: str, tree, step: int = 0, extra: Optional[dict] = None) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = leaf_names(tree)
    meta = {}
    for name, leaf in leaves.items():
        global_shape = tuple(leaf.shape)
        itemsize = _itemsize(leaf.dtype)
        nbytes = int(np.prod(global_shape, dtype=np.int64)) * itemsize if global_shape else itemsize
        fpath = _leaf_file(ckpt_dir, name)
        with open(fpath, "wb") as f:
            f.truncate(max(nbytes, 1))
            for index, data in _shards(leaf):
                raw = _raw(data)  # C-order shard bytes
                dtt = shard_subarray(global_shape, index, itemsize)
                # shard bytes are contiguous in shard-local order == the
                # order coalesced runs enumerate the subarray; one
                # seek+write per maximal run (not per segment)
                pos = 0
                for off, ln in dt.iter_runs(dtt, max_bytes=64 << 20):
                    f.seek(off)
                    f.write(raw[pos : pos + ln])
                    pos += ln
        meta[name] = {
            "shape": list(global_shape),
            "dtype": dtype_name(leaf.dtype),
            "file": os.path.basename(fpath),
        }
    manifest = {"step": step, "leaves": meta, "extra": extra or {}, "complete": True}
    tmp = manifest_path(ckpt_dir) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, manifest_path(ckpt_dir))  # atomic completeness marker


def _leaf_device(leaf) -> Optional[torch.device]:
    if isinstance(leaf, StackedLeaf):
        leaf = leaf.rows[0]
    return leaf.device if isinstance(leaf, torch.Tensor) else None


def _flat_shardings(shardings, names) -> Dict[str, object]:
    """Leaf name → sharding of a shardings tree shaped like the template."""
    out: Dict[str, object] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = node

    walk(shardings, ())
    missing = set(names) - set(out)
    if missing:
        raise ValueError(f"shardings lack leaves {sorted(missing)[:4]}")
    return out


def _load_sharded(path: str, meta: dict, sharding, row: Optional[int]):
    """A :class:`~repro_torch.core.mesh.ShardedTensor` of the file's leaf
    (or of its row ``row``) under ``sharding``: each distinct block read
    once through its ``shard_subarray``, then copied to every position that
    holds it (``sharding.holds``)."""
    from repro_torch.core.mesh import ShardedTensor

    storage = _storage(meta["dtype"])
    gshape = tuple(meta["shape"])
    shape = gshape[1:] if row is not None else gshape
    mesh = sharding.mesh
    read: Dict[tuple, torch.Tensor] = {}
    blocks = []
    fd = os.open(path, os.O_RDONLY)
    try:
        for slot in range(mesh.size):
            if not sharding.holds(slot):
                blocks.append(None)
                continue
            idx = sharding.index(slot, shape)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in read:
                gidx = ((slice(row, row + 1),) + idx) if row is not None else idx
                block = np.empty(tuple(s.stop - s.start for s in idx), dtype=storage)
                buf, pos = memoryview(block.reshape(-1).view(np.uint8)), 0
                for off, ln in dt.iter_runs(shard_subarray(gshape, gidx, storage.itemsize), max_bytes=64 << 20):
                    if os.preadv(fd, [buf[pos:pos + ln]], off) != ln:  # one read per run, into place
                        raise IOError(f"{path}: short read of {ln} bytes at {off}")
                    pos += ln
                t = torch.from_numpy(block)
                read[key] = t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t
            blocks.append(read[key].to(mesh.devices[slot]).clone())
    finally:
        os.close(fd)
    return ShardedTensor(shape, sharding, blocks)


def load_pytree(ckpt_dir: str, template, shardings=None):
    """Restore into the template's structure: ``(tree, step)``. A tensor
    leaf comes back as a tensor on the template leaf's device, a
    :class:`StackedLeaf` as a stacked leaf whose rows are
    views of one loaded global tensor, a numpy leaf as a numpy array (a
    bf16 one as its 16-bit words). A leaf whose manifest shape or dtype
    differs from the template's raises.

    ``shardings``, a tree shaped like the template of
    :class:`~repro_torch.core.mesh.NamedSharding` (``jax.device_put``'s
    argument in the reference), restores each leaf as a ``ShardedTensor``
    whose positions hold only their blocks, read from the file block by
    block; a :class:`StackedLeaf` comes back as a stacked leaf of sharded
    rows, each row laid out by the leaf's sharding."""
    with open(manifest_path(ckpt_dir)) as f:
        manifest = json.load(f)
    if not manifest.get("complete"):
        raise RuntimeError(f"incomplete checkpoint at {ckpt_dir}")
    names = leaf_names(template)
    flat_shardings = None if shardings is None else _flat_shardings(shardings, names)
    out = {}
    for name, leaf in names.items():
        meta = manifest["leaves"][name]
        if list(leaf.shape) != list(meta["shape"]) or dtype_name(leaf.dtype) != meta["dtype"]:
            raise ValueError(
                f"{name}: checkpoint holds {meta['shape']} {meta['dtype']}, "
                f"template wants {list(leaf.shape)} {dtype_name(leaf.dtype)}"
            )
        path = os.path.join(ckpt_dir, meta["file"])
        if flat_shardings is not None:
            sh = flat_shardings[name]
            if isinstance(leaf, StackedLeaf):
                rows = sh.rows if isinstance(sh, RowShardings) else [sh] * leaf.shape[0]
                out[name] = StackedLeaf([_load_sharded(path, meta, r, l) for l, r in enumerate(rows)])
            else:
                out[name] = _load_sharded(path, meta, sh, None)
            continue
        raw = np.fromfile(path, dtype=_storage(meta["dtype"]))
        arr = raw.reshape(meta["shape"])
        place = _leaf_device(leaf)
        if place is None:
            out[name] = arr
            continue
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        t = t.to(place)
        out[name] = StackedLeaf(t.unbind(0)) if isinstance(leaf, StackedLeaf) else t
    order = iter(out[n] for n in names)
    return _rebuild(template, order), manifest["step"]


def _rebuild(node, leaves):
    """``node``'s structure with its leaves taken in :func:`leaf_names` order."""
    if isinstance(node, dict):
        rebuilt = {k: _rebuild(node[k], leaves) for k in sorted(node)}
        return {k: rebuilt[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, leaves) for v in node)
    return next(leaves)
