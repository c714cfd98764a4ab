"""Async checkpoint manager: saves are generalized requests (paper ext. 1).

``save_async`` snapshots the tree to host memory and hands the file
writes to a worker thread whose completion is tracked by a
``poll_fn``-backed generalized request on the checkpoint stream — the
training loop keeps stepping while the progress thread (ext. 6) retires
the I/O. ``wait_for_pending`` is the single ``MPI_Waitall`` that covers
checkpoint + data-prefetch + heartbeat requests together.

The snapshot is the reference's d2h barrier (``np.asarray``) made
asynchronous, as MPICH's ``poll_fn`` over ``cudaEventQuery`` is meant to
be used: device tensors are copied into pinned host buffers on the
checkpoint MPIX stream's CUDA stream, after the work issued so far on the
current stream, and the copies complete at a CUDA event that a
generalized request polls. Work that only reads the saved tensors (the
next step's forward and backward) runs beside the copies; the caller calls
:meth:`CheckpointManager.wait_snapshots` before its next in-place write to
them (the optimizer writes params, master, m and v in place), so a save
issued at step k holds step k's bytes. The writer thread waits on the
snapshot request before it reads the buffers. CPU tensors are copied at
once. The host buffers are allocated once per concurrently in-flight save
and reused by later saves of the same tree layout.

Waits on the card's copies are bounded by ``WAIT_TIMEOUT_S``. Waits on
file writes are bounded by ``WRITE_TIMEOUT_S``, which is longer: a
full-width save writes gigabytes, and the disk's rate sets how long that
takes. A wait that runs out raises ``TimeoutError``.

``max_inflight > 0`` bounds concurrent saves with an
:class:`~repro_torch.core.enqueue.OffloadWindow`: ``save_async``
backpressures (parks on the engine's stripe CV) before taking the
snapshot when the writer falls behind the step rate, which also bounds the
host buffers to ``max_inflight`` sets.

Fault-tolerance contract: a checkpoint directory is valid iff its
manifest exists and says ``complete`` (written atomically, last);
``restore_latest`` scans for the newest valid step, so a crash mid-save
falls back to the previous one. Retention keeps the newest ``keep``.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import torch

from repro_torch.checkpoint import iovec_store as store
from repro_torch.core.enqueue import OffloadWindow, _poll_dispatched, _wait_dispatched
from repro_torch.core.progress import (
    GeneralizedRequest,
    ProgressEngine,
    default_engine,
    join_thread_states,
)
from repro_torch.core.streams import MPIXStream, STREAM_NULL

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_ALIGN = 256  # byte alignment of each tensor inside a host buffer set
#: bound, in seconds, on a wait for a snapshot's copies on the card
WAIT_TIMEOUT_S = 10.0
#: bound, in seconds, on a wait for a save's file writes
WRITE_TIMEOUT_S = 600.0
#: the newest saves whose snapshot times :meth:`CheckpointManager.snapshot_times` reports
SNAPSHOT_LOG = 16


class _HostSet:
    """One set of host buffers matching a tree's tensors (in
    :func:`~repro_torch.checkpoint.iovec_store.map_leaves` order): views of
    one allocation, pinned when any source is on the card."""

    def __init__(self, layout):
        self.layout = layout
        sizes = [torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
                 for shape, dtype, _ in layout]
        offs, total = [], 0
        for n in sizes:
            offs.append(total)
            total += -(-max(n, 1) // _ALIGN) * _ALIGN
        pinned = any(dev.type == "cuda" for _, _, dev in layout)
        self.base = torch.empty((total,), dtype=torch.uint8, pin_memory=pinned)
        self.views = [self.base[off : off + n].view(dtype).view(shape)
                      for (shape, dtype, _), off, n in zip(layout, offs, sizes)]


class CheckpointManager:
    def __init__(
        self,
        base_dir: str,
        engine: Optional[ProgressEngine] = None,
        stream: MPIXStream = STREAM_NULL,
        keep: int = 3,
        max_inflight: int = 0,
    ):
        self.base_dir = base_dir
        self.engine = engine or default_engine()
        self.stream = stream
        self.keep = keep
        # 0 = unbounded (legacy); >0 = window-backpressured saves
        self._window = (
            OffloadWindow(stream, depth=max_inflight, engine=self.engine, name="ckpt")
            if max_inflight > 0
            else None
        )
        self._pending: List[GeneralizedRequest] = []
        self._sets_lock = threading.Lock()
        self._free_sets: List[_HostSet] = []
        # the newest SNAPSHOT_LOG saves: step, bytes, the snapshot request,
        # its timing events on the card and the write's seconds
        self._log: deque = deque(maxlen=SNAPSHOT_LOG)
        self._last_copy = None  # (device, event) of the newest snapshot on the card
        os.makedirs(base_dir, exist_ok=True)

    # -- paths ----------------------------------------------------------
    def _dir_for(self, step: int) -> str:
        return os.path.join(self.base_dir, f"step_{step:08d}")

    def available_steps(self) -> List[int]:
        steps = []
        for d in os.listdir(self.base_dir):
            m = _STEP_RE.match(d)
            if not m:
                continue
            man = store.manifest_path(os.path.join(self.base_dir, d))
            if os.path.exists(man):
                steps.append(int(m.group(1)))
        return sorted(steps)

    # -- host buffers -----------------------------------------------------
    def _take_set(self, layout) -> _HostSet:
        with self._sets_lock:
            for i, s in enumerate(self._free_sets):
                if s.layout == layout:
                    return self._free_sets.pop(i)
        return _HostSet(layout)

    def _give_set(self, hs: _HostSet) -> None:
        with self._sets_lock:
            self._free_sets.append(hs)

    def _snapshot(self, step: int, tree):
        """Copy ``tree``'s tensors into a free host buffer set. Returns
        (host tree, set, log entry); the entry's ``request`` completes when
        the copies have."""
        srcs = store.tree_tensors(tree)
        hs = self._take_set(tuple((tuple(t.shape), t.dtype, t.device) for t in srcs))
        cuda = [s for s in srcs if s.device.type == "cuda"]
        event = timing = None
        if cuda:
            dev = cuda[0].device
            cur = torch.cuda.current_stream(dev)
            side = self.stream.torch_stream(dev) or cur  # a cudaStream_t MPIX stream has its own
            if side is not cur:
                side.wait_stream(cur)  # after the work issued so far: step k's bytes
            start = torch.cuda.Event(enable_timing=True)
            event = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record(side)
                for dst, src in zip(hs.views, srcs):
                    dst.copy_(src.detach(), non_blocking=True)
                    if side is not cur and src.is_cuda:
                        src.record_stream(side)  # a tensor freed meanwhile keeps its memory until copied
                event.record(side)
            self._last_copy = (dev, event)
            timing = (start, event)
        else:
            for dst, src in zip(hs.views, srcs):
                dst.copy_(src.detach())
        snap = self.engine.grequest_start(
            poll_fn=_poll_dispatched,
            wait_fn=_wait_dispatched,
            extra_state={"y": hs.views, "event": event},
            stream=self.stream,
            name=f"ckpt-d2h-{step}",
        )
        entry = {"step": step, "bytes": sum(v.numel() * v.element_size() for v in hs.views),
                 "events": timing, "request": snap, "write_s": None}
        self._log.append(entry)
        it = iter(hs.views)
        host_tree = store.map_leaves(lambda _t: next(it), tree)
        return host_tree, hs, entry

    def wait_snapshots(self) -> None:
        """Make the current stream wait for the copies of every snapshot
        taken so far. Call it before writing in place to a tensor that was
        saved; until then the copies run beside the caller's work."""
        if self._last_copy is not None:
            dev, event = self._last_copy
            torch.cuda.current_stream(dev).wait_event(event)

    def snapshot_times(self) -> List[dict]:
        """For each of the newest ``SNAPSHOT_LOG`` saves: step, bytes, the
        snapshot copy's device ms (None for a CPU snapshot) and the file
        write's seconds (None until written). Waits for the copies."""
        out = []
        for s in self._log:
            if not self.engine.wait(s["request"], WAIT_TIMEOUT_S):
                raise TimeoutError(f"snapshot of step {s['step']} not copied after {WAIT_TIMEOUT_S} s")
            ms = None if s["events"] is None else s["events"][0].elapsed_time(s["events"][1])
            out.append({"step": s["step"], "bytes": s["bytes"], "ms": ms, "write_s": s["write_s"]})
        return out

    # -- save -------------------------------------------------------------
    def save_async(self, step: int, tree, extra: Optional[dict] = None) -> GeneralizedRequest:
        """Snapshot to host, then write asynchronously. With
        ``max_inflight`` set, blocks here — before taking the snapshot —
        until a save slot frees."""
        if self._window is None:
            req = self._dispatch_save(step, tree, extra)
        else:
            with self._window.issue(timeout=WRITE_TIMEOUT_S) as submit:
                req = self._dispatch_save(step, tree, extra)
                submit(req)
            self._window.reap()  # keep the completed-slot deque bounded
        self._pending.append(req)
        return req

    def _dispatch_save(self, step: int, tree, extra: Optional[dict]) -> GeneralizedRequest:
        host_tree, hs, entry = self._snapshot(step, tree)
        tmp_dir = self._dir_for(step) + ".tmp"
        final_dir = self._dir_for(step)
        state = {"error": None, "thread": None}

        def work():
            try:
                if not self.engine.wait(entry["request"], WAIT_TIMEOUT_S):  # the host buffers hold the snapshot
                    raise TimeoutError(f"snapshot of step {step} not copied after {WAIT_TIMEOUT_S} s")
                t0 = time.perf_counter()
                if os.path.exists(tmp_dir):
                    shutil.rmtree(tmp_dir)
                store.save_pytree(tmp_dir, host_tree, step=step, extra=extra)
                os.replace(tmp_dir, final_dir)
                entry["write_s"] = time.perf_counter() - t0
                self._retain()
            except Exception as e:  # surfaced via query_fn/status
                state["error"] = e
            finally:
                self._give_set(hs)

        t = threading.Thread(target=work, daemon=True, name=f"ckpt-{step}")
        state["thread"] = t
        t.start()

        def poll(st) -> bool:
            return not st["thread"].is_alive()

        def query(st):
            return st["error"]

        return self.engine.grequest_start(
            poll_fn=poll,
            wait_fn=join_thread_states,
            query_fn=query,
            extra_state=state,
            stream=self.stream,
            name=f"ckpt-{step}",
        )

    def save_sync(self, step: int, tree, extra: Optional[dict] = None) -> None:
        req = self.save_async(step, tree, extra)
        if not self.engine.wait(req, WRITE_TIMEOUT_S):
            raise TimeoutError(f"save of step {step} not written after {WRITE_TIMEOUT_S} s")
        if req.status() is not None:
            raise req.status()

    def _retain(self):
        steps = self.available_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._dir_for(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore_latest(self, template, shardings=None) -> Tuple[object, int]:
        """The newest complete checkpoint into ``template``'s structure;
        ``shardings=`` as in :func:`~repro_torch.checkpoint.iovec_store.load_pytree`."""
        steps = self.available_steps()
        if not steps:
            raise FileNotFoundError(f"no complete checkpoints under {self.base_dir}")
        return store.load_pytree(self._dir_for(steps[-1]), template, shardings)

    def restore_step(self, step: int, template, shardings=None):
        return store.load_pytree(self._dir_for(step), template, shardings)

    # -- progress integration -------------------------------------------------
    def wait_for_pending(self, timeout: Optional[float] = WRITE_TIMEOUT_S) -> bool:
        ok = self.engine.wait_all(self._pending, timeout)
        for r in self._pending:
            if r.status() is not None:
                raise r.status()
        self._pending = [r for r in self._pending if not r.done]
        return ok

    def wait_for_next(self, timeout: Optional[float] = WRITE_TIMEOUT_S) -> Optional[GeneralizedRequest]:
        """Block until the *first* of the pending saves finishes
        (``engine.wait_any``) — surfacing a failed writer as soon as it
        dies instead of only after the whole batch drains. Returns the
        completed request (dropped from the pending set), or None when
        nothing is pending / the timeout expires; re-raises the save's
        error if it failed."""
        if not self._pending:
            return None
        req = self.engine.wait_any(self._pending, timeout)
        if req is None:
            return None
        self._pending = [r for r in self._pending if r is not req]
        if req.status() is not None:
            raise req.status()
        return req
