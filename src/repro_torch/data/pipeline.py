"""Synthetic-token data pipeline with progress-engine prefetch.

Deterministic per-step batches (seeded Philox on the host, numpy) so
restarts reproduce the exact stream — the checkpoint/restart test depends
on it. The batches are the JAX package's (``repro.data.pipeline``), byte
for byte: the same generator, seeds and draws.

Two async modes, both completed by the ONE progress engine:

* **thread-per-prefetch** (default): ``prefetch(k)`` spawns a build
  thread tracked as a generalized request (paper ext. 1); the training
  loop's single ``engine.wait_all`` covers data readiness together with
  checkpoint I/O.
* **threadcomm loaders** (:meth:`SyntheticPipeline.start_workers`,
  paper ext. 5): persistent worker threads join a
  :class:`~repro_torch.core.threadcomm.HostThreadComm` as ranks 1..W (the
  trainer is rank 0), each pinned to its own VCI channel of the striped
  engine. ``prefetch(k)`` becomes a ``tc_send`` of the step number to a
  worker; the built batch comes back as a zero-copy ``tc_send`` to rank
  0 and ``get_batch`` is a ``tc_recv`` that parks on the trainer's own
  stripe CV. The prefetch handle stays a generalized request (completed
  externally by the worker), so the same ``engine.wait_all`` story holds.

The loader epoch is one bracket, :meth:`SyntheticPipeline.loader_epoch`:
``start()``, the rank-0 ``attach()`` and the workers open inside it and
close in its ``finally`` blocks, so the epoch cannot leak its channels.
``start_workers``/``stop_workers`` enter and leave that bracket across
methods (``Trainer.run`` closes it in its ``finally``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.progress import ProgressEngine, default_engine, join_thread_states
from repro_torch.core.streams import MPIXStream, STREAM_NULL
from repro_torch.models.config import ModelConfig

__all__ = ["DataConfig", "SyntheticPipeline"]

# sentinel step number: tells a threadcomm worker to detach and exit
_STOP = -1
#: bound (seconds) on every wait of the loader epoch: a batch receive, a
#: worker join, the epoch close
WAIT_TIMEOUT_S = 10.0


@dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq: int = 128
    seed: int = 0
    # >0: build batches on this many persistent threadcomm loader ranks
    # (trainer joins as rank 0) instead of a thread per prefetch
    loader_threads: int = 0


class SyntheticPipeline:
    """Deterministic synthetic LM batches, with optional async prefetch."""

    def __init__(
        self,
        cfg: ModelConfig,
        data: DataConfig,
        engine: Optional[ProgressEngine] = None,
        stream: MPIXStream = STREAM_NULL,
    ):
        self.cfg = cfg
        self.data = data
        self.engine = engine or default_engine()
        self.stream = stream
        self._ready: Dict[int, dict] = {}
        self._lock = threading.Lock()
        # threadcomm-loader state (inactive until start_workers)
        self._epoch: Optional[contextlib.ExitStack] = None
        self._tc = None
        self._rank0 = None
        self._workers: List[threading.Thread] = []
        self._assigned: Dict[int, int] = {}  # step -> worker rank
        # weighted prefetch split (straggler rebalance): worker rank ->
        # relative share, smooth-WRR credit, cumulative assignment count
        self._shares: Dict[int, float] = {}
        self._wrr_credit: Dict[int, float] = {}
        self.assignments: Dict[int, int] = {}
        if data.loader_threads > 0:
            self.start_workers(data.loader_threads)

    # -- deterministic batches -------------------------------------------
    def build_batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.data.seed << 32) | step)
        cfg, d = self.cfg, self.data
        # learnable synthetic stream: per-sequence affine progressions
        # tok[t] = (start + stride·t) mod V' — next-token is predictable,
        # so e2e loss curves actually measure learning, not noise.
        V = min(cfg.vocab, 128)
        start = rng.integers(0, V, (d.batch, 1))
        stride = rng.integers(1, 4, (d.batch, 1))
        t = np.arange(d.seq)[None, :]
        batch = {"tokens": ((start + stride * t) % V).astype(np.int32)}
        if cfg.vlm and cfg.n_img_tokens:
            batch["tokens"] = batch["tokens"][:, : d.seq - cfg.n_img_tokens]
            batch["img_embeds"] = rng.standard_normal(
                (d.batch, cfg.n_img_tokens, cfg.d_model), dtype=np.float32
            )
        if cfg.encdec:
            batch["enc_frames"] = rng.standard_normal(
                (d.batch, cfg.n_audio_ctx, cfg.d_model), dtype=np.float32
            )
        return batch

    # -- threadcomm loader ranks ------------------------------------------
    @contextlib.contextmanager
    def loader_epoch(self, n_workers: int):
        """The loader epoch: a host threadcomm of size n_workers+1 where the
        calling (trainer) thread is rank 0 and ``n_workers`` persistent
        loader ranks serve ``prefetch``/``get_batch`` over tc_send/tc_recv.
        Everything it opens closes on the way out, exception or not."""
        if self._tc is not None:
            raise RuntimeError("loader threadcomm already started")
        from repro_torch.core.threadcomm import HostThreadComm

        tc = HostThreadComm(n_workers + 1, engine=self.engine, name="loader-tc")
        tc.start()
        try:
            rank0 = tc.attach(rank=0)
            try:
                self._tc, self._rank0 = tc, rank0
                self._workers = [
                    threading.Thread(target=self._worker_loop, args=(w + 1,), daemon=True)
                    for w in range(n_workers)
                ]
                for t in self._workers:
                    t.start()
                yield self
            finally:
                for w in range(len(self._workers)):
                    rank0.send(w + 1, (_STOP, None))
                for t in self._workers:
                    t.join(timeout=WAIT_TIMEOUT_S)
                rank0.detach()
                self._tc = None
                self._rank0 = None
                self._workers = []
                self._assigned.clear()
        finally:
            tc.finish(timeout=WAIT_TIMEOUT_S, drain=True)

    def start_workers(self, n_workers: int) -> None:
        """Spin up ``n_workers`` persistent loader ranks (enter
        :meth:`loader_epoch`; :meth:`stop_workers` leaves it). Subsequent
        ``prefetch``/``get_batch`` ride tc_send/tc_recv."""
        if self._tc is not None:
            raise RuntimeError("loader threadcomm already started")
        with contextlib.ExitStack() as stack:
            stack.enter_context(self.loader_epoch(n_workers))
            self._epoch = stack.pop_all()

    def _worker_loop(self, rank: int) -> None:
        h = self._tc.attach(rank=rank)
        try:
            while True:
                try:
                    step, req = h.recv(src=0, timeout=WAIT_TIMEOUT_S)
                except TimeoutError:
                    continue  # idle: nothing asked of this loader yet
                if step == _STOP:
                    return
                # zero-copy handoff of the built batch to the trainer rank
                h.send(0, self.build_batch(step), tag=("batch", step))
                if req is not None:
                    req.complete()  # wakes any engine.wait_all parked on it
        finally:
            h.detach()

    def stop_workers(self) -> None:
        """Tear down the loader ranks (drains nothing: un-fetched batches
        are discarded with the epoch)."""
        epoch, self._epoch = self._epoch, None
        if epoch is not None:
            epoch.close()

    @property
    def threadcomm(self):
        """The loader threadcomm (None unless start_workers ran)."""
        return self._tc

    @property
    def n_workers(self) -> int:
        """Number of live loader ranks (0 in thread-per-prefetch mode)."""
        return len(self._workers)

    # -- weighted microbatch split (straggler rebalance) -----------------
    def set_shares(self, shares: Dict[int, float]) -> None:
        """Set per-worker prefetch weights (worker ranks 1..W). The map
        usually comes from ``StragglerMonitor.rebalance_shares`` via the
        trainer: a straggling stage's loader gets a smaller weight and
        therefore fewer microbatches from the next step on. Weights are
        relative; workers missing from the map default to 1; non-positive
        weights clamp to a tiny epsilon (starved, never deadlocked)."""
        if self._tc is None:
            raise RuntimeError("set_shares requires threadcomm loader workers")
        clean = {}
        for w in range(1, len(self._workers) + 1):
            v = float(shares.get(w, 1.0))
            clean[w] = v if v > 0 else 1e-6
        self._shares = clean
        self._wrr_credit = {w: 0.0 for w in clean}

    def _next_worker(self) -> int:
        """Smooth weighted round-robin over the loader ranks: every pick
        adds each worker's weight to its credit, takes the max-credit
        worker, and charges it the total weight. Equal weights reduce to
        the ``1 + step % W`` rotation; half the weight means half the
        assignments, interleaved rather than bunched."""
        if not self._shares:
            self.set_shares({})
        total = sum(self._shares.values())
        for w, wt in self._shares.items():
            self._wrr_credit[w] += wt
        best = max(self._wrr_credit, key=lambda w: (self._wrr_credit[w], -w))
        self._wrr_credit[best] -= total
        return best

    # -- async prefetch ----------------------------------------------------
    def prefetch(self, step: int):
        """Enqueue an async build of batch ``step``; returns the request."""
        if self._tc is not None:
            if step in self._assigned:
                return None  # already in flight
            w = self._next_worker()
            # externally-completed handle: no poll_fn, so a blocked
            # wait_all parks; the worker completes it after the tc_send
            req = self.engine.grequest_start(
                extra_state={"step": step, "worker": w},
                stream=self._rank0.stream,
                name=f"prefetch-{step}",
            )
            self._assigned[step] = w
            self.assignments[w] = self.assignments.get(w, 0) + 1
            self._rank0.send(w, (step, req))
            return req

        state = {"step": step, "thread": None}

        def work():
            b = self.build_batch(step)
            with self._lock:
                self._ready[step] = b

        t = threading.Thread(target=work, daemon=True)
        state["thread"] = t
        t.start()

        def poll(st) -> bool:
            return not st["thread"].is_alive()

        return self.engine.grequest_start(
            poll_fn=poll,
            wait_fn=join_thread_states,
            extra_state=state,
            stream=self.stream,
            name=f"prefetch-{step}",
        )

    def wait_first(self, reqs, timeout: Optional[float] = None):
        """Block until the *first* of several prefetch requests completes
        and return it (``engine.wait_any``). None on timeout/empty."""
        return self.engine.wait_any([r for r in reqs if r is not None], timeout)

    def get_batch(self, step: int) -> dict:
        if self._tc is not None and step in self._assigned:
            w = self._assigned.pop(step)
            # parks on rank 0's own VCI stripe until the worker's send lands
            return self._rank0.recv(src=w, tag=("batch", step), timeout=WAIT_TIMEOUT_S)
        with self._lock:
            if step in self._ready:
                return self._ready.pop(step)
        return self.build_batch(step)
