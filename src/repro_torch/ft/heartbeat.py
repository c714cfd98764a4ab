"""Failure detection: heartbeats as generalized requests.

Every worker (pod/host in a real deployment; simulated ranks here) pings
``record(rank)``; a detector generalized-request polls deadlines from the
progress engine (ext. 1/6) — no dedicated watchdog thread beyond the
engine's own progress thread, which the application spins up/down.
On a miss, the registered callback fires (launch/train wires it to the
elastic re-mesh planner + checkpoint restore path).

Thread-rank liveness rides the same detector: pass a monitor as
``HostThreadComm(..., heartbeat=monitor)`` and the threadcomm registers
each rank on :meth:`~HeartbeatMonitor.add_rank` at attach, pings it on
every mailbox op (send/recv/collective hop), and deregisters it on
detach — a thread-rank that stalls mid-epoch trips the identical
``on_failure`` path as a dead pod.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.progress import ProgressEngine, default_engine
from repro_torch.core.streams import MPIXStream, STREAM_NULL

__all__ = ["HeartbeatMonitor"]


def _wait_next_deadline(states, timeout) -> None:
    """Batched ``wait_fn``: sleep until the earliest point any monitored
    rank *could* time out (bounded by the engine's deadline budget) —
    waiting on a heartbeat never busy-polls deadlines that cannot have
    expired yet."""
    delays = []
    for mon in states:
        h = mon._next_deadline()
        if h is not None:
            delays.append(max(0.0, h - mon.clock()))
    delay = min(delays) if delays else 0.05
    if timeout is not None:
        delay = min(delay, max(0.0, timeout))
    if delay > 0:
        time.sleep(min(delay, 1.0))


class HeartbeatMonitor:
    def __init__(
        self,
        ranks: List[int],
        timeout: float = 5.0,
        engine: Optional[ProgressEngine] = None,
        stream: MPIXStream = STREAM_NULL,
        on_failure: Optional[Callable[[List[int]], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.timeout = timeout
        self.engine = engine or default_engine()
        self.stream = stream
        self.on_failure = on_failure
        self.clock = clock
        self._lock = threading.Lock()
        now = clock()
        self._last: Dict[int, float] = {r: now for r in ranks}
        self._failed: List[int] = []
        self._reported: set = set()
        self._req = self.engine.grequest_start(
            poll_fn=self._poll,
            wait_fn=_wait_next_deadline,
            extra_state=self,
            stream=stream,
            name="heartbeat",
        )

    def record(self, rank: int) -> None:
        with self._lock:
            if rank in self._last:
                self._last[rank] = self.clock()

    def add_rank(self, rank: int) -> None:
        """Start monitoring ``rank`` (threadcomm attach path). Idempotent;
        a re-added rank gets a fresh deadline and a clean failure slate."""
        with self._lock:
            self._last[rank] = self.clock()
            if rank in self._failed and rank not in self._reported:
                self._failed.remove(rank)

    def remove_rank(self, rank: int) -> None:
        """Stop monitoring ``rank`` (threadcomm detach path): a cleanly
        departed rank must not fail the detector later.

        Also retracts an unreported detection: the detector snapshots
        expired ranks under the lock but fires ``on_failure`` outside it
        (callback re-entrancy), so a rank deregistered between the
        deadline scan and the report window would otherwise be announced
        dead after it detached cleanly. ``_poll`` re-validates against
        ``_failed`` right before reporting, so dropping the rank here
        cancels the announcement."""
        with self._lock:
            self._last.pop(rank, None)
            if rank in self._failed and rank not in self._reported:
                self._failed.remove(rank)

    def _next_deadline(self) -> Optional[float]:
        """Earliest absolute time a monitored rank could miss its deadline."""
        with self._lock:
            if not self._last:
                return None
            return min(self._last.values()) + self.timeout

    def _poll(self, _state) -> bool:
        """Completes (only) when failures were detected and reported."""
        now = self.clock()
        with self._lock:
            newly = [r for r, t in self._last.items() if now - t > self.timeout and r not in self._failed]
            self._failed.extend(newly)
        if newly:
            # re-validate under the lock before announcing: a clean
            # remove_rank() in the gap since the scan retracts the rank
            # from _failed, and it must not reach on_failure.
            with self._lock:
                report = [r for r in newly if r in self._failed]
                self._reported.update(report)
            if report and self.on_failure is not None:
                self.on_failure(report)
        with self._lock:
            return bool(self._failed)

    @property
    def failed(self) -> List[int]:
        with self._lock:
            return list(self._failed)

    def check(self) -> List[int]:
        """Synchronous check (one progress visit)."""
        self.engine.progress(self.stream)
        return self.failed

    def stop(self) -> None:
        """Cancel the detector request (monitor shutdown): wakes any waiter
        parked on it and lets the engine sweep it from the queue."""
        self._req.cancel()
