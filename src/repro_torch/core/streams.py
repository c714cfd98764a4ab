"""MPIX Streams on CUDA (paper ext. 3).

An :class:`MPIXStream` is an *explicit execution context*: a named, serial
communication context that the runtime maps onto a dedicated channel
("VCI" in MPICH terms), drawn from a finite pool (creation *fails* when
the pool is exhausted, giving predictable performance). "Offload" streams
(``info={'type': 'cudaStream_t'|'hipStream_t'|'tpu_stream'}``) may share
channels, as in the paper ("for streams representing GPU streams, MPICH
may reuse network endpoints") — their ordering comes from the device.

On the card the paper's mapping is direct: an offload stream whose info
says ``cudaStream_t`` owns a real :class:`torch.cuda.Stream`, created
lazily on first use (:meth:`MPIXStream.torch_stream`); on the CPU it has
none. The JAX package's dependency tokens (``optimization_barrier``) become
CUDA events: a token is an event recorded on a stream, joining tokens
collects their events, and serializing on a token makes the current stream
wait for it. On the CPU, where every op has completed when it returns,
tokens are ``None`` and all three are the identity.

Inside a :func:`~repro_torch.core.mesh.shard_map` region, where mesh
positions are thread-ranks, every non-NULL stream has its own CUDA stream
per (MPIX stream, mesh position): ops of one rank on one MPIX stream stay
serial, different ranks and different streams are independent — one
device queue per stream per device, as in the reference.

``StreamComm`` pairs a mesh + axis subset with attached streams,
mirroring ``MPIX_Stream_comm_create[_multiplex]``; the collectives of
:mod:`repro_torch.core.collectives` run over it.
"""

from __future__ import annotations

import itertools
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import mesh as _mesh
from repro_torch.device import resolve_device

__all__ = [
    "DEFAULT_NUM_CHANNELS",
    "MPIXStream",
    "STREAM_NULL",
    "StreamPool",
    "default_pool",
    "stream_create",
    "stream_free",
    "StreamComm",
    "stream_comm_create",
    "stream_comm_create_multiplex",
    "comm_get_stream",
    "axis_size",
    "new_token",
    "token_join",
    "serialize_on",
    "info_set_hex",
]


# ----------------------------------------------------------------------
# Streams & the finite channel (VCI) pool
# ----------------------------------------------------------------------

#: Width of the channel space. The progress engine sizes its lock-stripe
#: table to this, so with the default pool every compute stream's channel
#: maps 1:1 onto its own stripe (no false lock sharing between streams).
DEFAULT_NUM_CHANNELS = 64

_OFFLOAD_TYPES = ("cudaStream_t", "hipStream_t", "tpu_stream")
_torch_stream_lock = threading.Lock()


def axis_size(name: str) -> int:
    """Size of a mapped mesh axis inside a shard_map region."""
    return _mesh.axis_size(name)


@dataclass(frozen=True)
class MPIXStream:
    """A local serial execution context (thread, host task, device queue)."""

    sid: int
    name: str
    kind: str = "compute"  # "compute" | "offload" | "null"
    channel: int = -1  # VCI index; -1 = implicit/shared
    info: Tuple[Tuple[str, str], ...] = ()
    # the lazily created CUDA streams: per device index, and per (device
    # index, mesh position) inside a shard_map region
    _cuda: Dict[object, torch.cuda.Stream] = field(
        default_factory=dict, compare=False, repr=False, hash=False
    )

    @property
    def is_null(self) -> bool:
        return self.kind == "null"

    @property
    def is_offload(self) -> bool:
        return self.kind == "offload"

    @property
    def is_cuda_stream(self) -> bool:
        return self.is_offload and dict(self.info).get("type") == "cudaStream_t"

    def torch_stream(self, device) -> Optional[torch.cuda.Stream]:
        """The CUDA stream this MPIX stream stands for on ``device``, created
        on first use. Inside a shard_map region every non-NULL stream has
        one per (device, mesh position). Outside a region only a
        ``cudaStream_t`` offload stream has one (per device); compute and
        NULL streams return ``None`` and order work on the caller's current
        stream. The CPU has no streams."""
        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        region = _mesh.current_region()
        if region is not None and not self.is_null:
            key = (idx, region.slot)
        elif self.is_cuda_stream:
            key = idx
        else:
            return None
        with _torch_stream_lock:
            s = self._cuda.get(key)
            if s is None:
                s = self._cuda[key] = torch.cuda.Stream(device=idx)
            return s


STREAM_NULL = MPIXStream(sid=-1, name="MPIX_STREAM_NULL", kind="null", channel=-1)


class StreamPool:
    """Finite pool of communication channels (MPICH VCIs).

    MPICH "will try to allocate distinct network endpoints for each new
    stream and return failure if it runs out" — we reproduce that contract
    so applications get predictable channel isolation.
    """

    def __init__(self, max_channels: int = DEFAULT_NUM_CHANNELS):
        self.max_channels = max_channels
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._free_channels = list(range(max_channels))[::-1]
        self._offload_rr = 0  # offload streams round-robin over channels
        self.live: Dict[int, MPIXStream] = {}

    def create(self, info: Optional[dict] = None, name: Optional[str] = None) -> MPIXStream:
        info = dict(info or {})
        kind = "offload" if info.get("type") in _OFFLOAD_TYPES else "compute"
        with self._lock:
            sid = next(self._ids)
            if kind == "offload":
                # offload streams may share endpoints (async device ordering
                # makes isolation less critical — paper §Offloading)
                channel = self._offload_rr % self.max_channels
                self._offload_rr += 1
            else:
                if not self._free_channels:
                    raise RuntimeError(
                        "MPIX_Stream_create: out of communication channels "
                        f"(pool={self.max_channels}); free streams to reuse endpoints"
                    )
                channel = self._free_channels.pop()
            s = MPIXStream(
                sid=sid,
                name=name or f"stream{sid}",
                kind=kind,
                channel=channel,
                info=tuple(sorted((str(k), str(v)) for k, v in info.items())),
            )
            self.live[sid] = s
            return s

    def free(self, stream: MPIXStream) -> None:
        if stream.is_null:
            return
        with self._lock:
            if stream.sid not in self.live:
                raise RuntimeError("MPIX_Stream_free: stream already freed/unknown")
            del self.live[stream.sid]
            if stream.kind == "compute":
                self._free_channels.append(stream.channel)

    @property
    def n_live(self) -> int:
        return len(self.live)


_default_pool = StreamPool()


def default_pool() -> StreamPool:
    return _default_pool


def stream_create(info: Optional[dict] = None, name: Optional[str] = None, pool: Optional[StreamPool] = None) -> MPIXStream:
    """``MPIX_Stream_create``. ``info`` may carry an opaque device-stream
    handle set via :func:`info_set_hex`."""
    return (pool or _default_pool).create(info, name)


def stream_free(stream: MPIXStream, pool: Optional[StreamPool] = None) -> None:
    (pool or _default_pool).free(stream)


def info_set_hex(info: dict, key: str, value: bytes) -> dict:
    """``MPIX_Info_set_hex``: stash an opaque binary (e.g. a device-stream
    handle) into string-only info as hex."""
    info[key] = bytes(value).hex()
    return info


# ----------------------------------------------------------------------
# Stream communicators
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class StreamComm:
    """A communicator over a mesh-axis subset with local streams attached.

    ``axes`` is ordered major→minor; collectives over this comm flatten the
    axes (threadcomm-style). ``streams`` holds the attached local streams —
    one for single-stream comms, several for multiplex comms.
    """

    axes: Tuple[str, ...]
    streams: Tuple[MPIXStream, ...] = (STREAM_NULL,)
    mesh: object = None  # a core.mesh.Mesh; optional (axis names suffice inside shard_map)

    def __post_init__(self):
        if not self.axes:
            raise ValueError("StreamComm needs at least one mesh axis")
        if not self.streams:
            raise ValueError("StreamComm needs at least one (possibly NULL) stream")

    # -- stream accessors ------------------------------------------------
    @property
    def stream(self) -> MPIXStream:
        return self.streams[0]

    @property
    def is_multiplex(self) -> bool:
        return len(self.streams) > 1

    @property
    def channel(self) -> int:
        return self.stream.channel

    # -- communicator geometry -------------------------------------------
    def size(self) -> int:
        if self.mesh is None:
            raise ValueError("size() needs a bound mesh")
        return math.prod(self.mesh.shape[a] for a in self.axes)

    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.mesh.shape[a] for a in self.axes)

    def rank(self) -> int:
        """Flattened rank of the calling thread-rank inside a shard_map
        region."""
        r = _mesh.axis_index(self.axes[0])
        for a in self.axes[1:]:
            r = r * axis_size(a) + _mesh.axis_index(a)
        return r

    def with_axes(self, axes: Sequence[str]) -> "StreamComm":
        return StreamComm(tuple(axes), self.streams, self.mesh)


def stream_comm_create(mesh, axes: Sequence[str], stream: MPIXStream = STREAM_NULL) -> StreamComm:
    """``MPIX_Stream_comm_create``: collective over ``mesh[axes]`` with one
    local stream. A NULL stream reverts to conventional-communicator
    behaviour (implicit channel, the caller's current CUDA stream)."""
    if isinstance(axes, str):
        axes = (axes,)
    return StreamComm(tuple(axes), (stream,), mesh)


def stream_comm_create_multiplex(mesh, axes: Sequence[str], streams: Sequence[MPIXStream]) -> StreamComm:
    """``MPIX_Stream_comm_create_multiplex``: several local streams; p2p ops
    then take source/dest stream indices (see collectives.stream_send_recv)."""
    if isinstance(axes, str):
        axes = (axes,)
    return StreamComm(tuple(axes), tuple(streams), mesh)


def comm_get_stream(comm: StreamComm, idx: int = 0) -> MPIXStream:
    """``MPIX_Comm_get_stream``."""
    return comm.streams[idx]


# ----------------------------------------------------------------------
# Tokens: serial semantics within a stream, independence across streams
# ----------------------------------------------------------------------


def _events(token):
    if token is None:
        return ()
    if isinstance(token, tuple):
        return tuple(e for t in token for e in _events(t))
    return (token,)


def new_token(device="cuda", stream: MPIXStream = STREAM_NULL):
    """A fresh dependency token: a CUDA event recorded now on ``stream``'s
    CUDA stream (the current stream for compute/NULL streams), or ``None``
    on the CPU, where there is nothing to order. Asking for a CUDA token
    without CUDA raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return None
    ev = torch.cuda.Event()
    ev.record(stream.torch_stream(dev) or torch.cuda.current_stream(dev))
    return ev


def token_join(*tokens):
    """Merge tokens (e.g. before a joint synchronization point): the joined
    token completes when every input does."""
    evs = _events(tokens)
    if not evs:
        return None
    return evs[0] if len(evs) == 1 else evs


def serialize_on(token, *arrays):
    """Tie ``arrays`` to ``token``: work issued on the current stream after
    this call runs after the op that produced the token. Returns
    ``(new_token, arrays)``; on the CPU (``token is None``) the identity."""
    evs = _events(token)
    if not evs:
        return token, arrays
    s = torch.cuda.current_stream()
    for ev in evs:
        s.wait_event(ev)
    after = torch.cuda.Event()
    after.record(s)
    return after, arrays
