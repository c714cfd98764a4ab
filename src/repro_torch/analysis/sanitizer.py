"""Runtime lock/park/leak sanitizer for :class:`ProgressEngine`.

Enabled with ``ProgressEngine(sanitize=True)``; the engine threads a
:class:`Sanitizer` through its stripe locks and request lifecycle and
exposes the result as ``engine.sanitizer_report()``. Four dynamic checks
mirror the static MPIX rules:

* **lock-order-cycle** — every stripe-lock acquisition taken while other
  stripe locks are held records a directed edge (held → acquired) into a
  cross-thread lock-order graph; a cycle in that graph is a potential
  deadlock even if this run got lucky with timing (the dynamic MPIX006).
* **park-while-locked** — a blocking park (``park_on_channel`` /
  ``wait`` / ``wait_all`` / ``wait_any``) entered while the calling
  thread already holds a stripe lock: the sleeper keeps the stripe
  pinned, so the completer that would satisfy the predicate can never
  run (the dynamic MPIX001).
* **request-leak** — requests started but neither completed nor
  cancelled by ``stop_all()`` (the dynamic MPIX004).
* **lost-wakeup** — a ``notify_channel`` that evaluated some waiter's
  predicate to True yet woke nobody; the wait-queue invariant says a
  true predicate always wakes its waiter.

The recorder is deliberately cheap — every hook is a None-check in the
fast path when disabled, and O(held locks) when enabled — so the stress
suite runs a full config with it on.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["Sanitizer"]


class Sanitizer:
    """Acquisition recorder + invariant checker wired into one engine.

    Thread-safe: per-thread held-lock state lives in a ``threading.local``;
    the shared graph/findings are guarded by ``_lock``.
    """

    def __init__(self, engine=None):
        self._engine = weakref.ref(engine) if engine is not None else None
        self._tls = threading.local()
        self._lock = threading.Lock()
        # directed lock-order graph over stripe indices: edges[(a, b)] =
        # count of "acquired b while holding a" observations
        self._edges: Dict[Tuple[int, int], int] = {}
        self._edge_sites: Dict[Tuple[int, int], str] = {}
        self._findings: List[dict] = []
        self._finding_keys: Set[Tuple] = set()  # dedupe repeated identical events
        # live request registry: id -> (weakref, name, channel)
        self._live: Dict[int, Tuple[weakref.ref, str, int]] = {}
        self._counts = {
            "acquires": 0,
            "edges_recorded": 0,
            "blocking_entries": 0,
            "notifies_checked": 0,
            "requests_tracked": 0,
            "requests_retired": 0,
        }

    # -- per-thread held-lock bookkeeping --------------------------------

    def _held(self) -> Dict[int, int]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = {}
        return held

    def on_acquire(self, stripe_index: int) -> None:
        held = self._held()
        depth = held.get(stripe_index, 0)
        held[stripe_index] = depth + 1
        if depth > 0:
            return  # re-entrant on the same stripe: no new edge
        others = [s for s in held if s != stripe_index]
        with self._lock:
            self._counts["acquires"] += 1
            for h in others:
                edge = (h, stripe_index)
                self._edges[edge] = self._edges.get(edge, 0) + 1
                self._counts["edges_recorded"] += 1
                if edge not in self._edge_sites:
                    self._edge_sites[edge] = threading.current_thread().name

    def on_release(self, stripe_index: int) -> None:
        held = self._held()
        depth = held.get(stripe_index, 0)
        if depth <= 1:
            held.pop(stripe_index, None)
        else:
            held[stripe_index] = depth - 1

    def held_stripes(self) -> List[int]:
        """Stripe indices the *calling thread* currently holds."""
        return sorted(self._held())

    # -- blocking-entry check (dynamic MPIX001) --------------------------

    def on_block(self, kind: str, stripe_index: Optional[int] = None) -> None:
        """Called at the entry of every blocking primitive, *before* it
        takes its own stripe lock; any stripe already held here will stay
        held across the sleep."""
        held = self._held()
        with self._lock:
            self._counts["blocking_entries"] += 1
        if not held:
            return
        self._add(
            kind="park-while-locked",
            detail=(
                f"{kind}() entered while thread "
                f"{threading.current_thread().name!r} holds stripe lock(s) "
                f"{sorted(held)} — the sleep pins the stripe and the waker "
                f"can deadlock behind it"
            ),
            dedupe=("park-while-locked", kind, tuple(sorted(held)), stripe_index),
            extra={"kind_entered": kind, "held_stripes": sorted(held), "stripe": stripe_index},
        )

    # -- notify invariant (no lost wakeups) ------------------------------

    def on_notify(self, channel: int, true_predicates: int, woken: int) -> None:
        with self._lock:
            self._counts["notifies_checked"] += 1
        if true_predicates > 0 and woken == 0:
            self._add(
                kind="lost-wakeup",
                detail=(
                    f"notify_channel({channel}) evaluated {true_predicates} "
                    f"waiter predicate(s) to True but woke 0 waiters"
                ),
                dedupe=None,  # every occurrence is a distinct bug event
                extra={"channel": channel, "true_predicates": true_predicates},
            )

    # -- request lifecycle (dynamic MPIX004) -----------------------------

    def on_request_start(self, request) -> None:
        with self._lock:
            self._counts["requests_tracked"] += 1
            self._live[id(request)] = (
                weakref.ref(request),
                getattr(request, "name", "") or "",
                getattr(getattr(request, "stream", None), "channel", -1),
            )

    def on_request_retired(self, request) -> None:
        with self._lock:
            if id(request) in self._live:
                self._counts["requests_retired"] += 1
                del self._live[id(request)]

    def on_stop_all(self) -> None:
        """Leak check at engine shutdown: anything started, still alive,
        and not done is a leaked request."""
        with self._lock:
            live = list(self._live.values())
        for ref, name, channel in live:
            req = ref()
            if req is None or getattr(req, "done", False):
                continue  # completed-but-unswept is not a leak
            self._add(
                kind="request-leak",
                detail=(
                    f"request {name or '<unnamed>'!s} (channel {channel}) was "
                    f"started but neither completed nor cancelled by stop_all()"
                ),
                dedupe=("request-leak", name, channel),
                extra={"name": name, "channel": channel},
            )

    # -- findings / report -----------------------------------------------

    def _add(self, kind: str, detail: str, dedupe, extra: dict) -> None:
        with self._lock:
            if dedupe is not None:
                if dedupe in self._finding_keys:
                    return
                self._finding_keys.add(dedupe)
            self._findings.append(
                {
                    "kind": kind,
                    "detail": detail,
                    "thread": threading.current_thread().name,
                    **extra,
                }
            )

    def _cycles(self) -> List[List[int]]:
        """Elementary cycles in the lock-order graph (DFS over the small
        stripe-index graph; computed on demand at report time)."""
        with self._lock:
            adj: Dict[int, List[int]] = {}
            for a, b in self._edges:
                adj.setdefault(a, []).append(b)
        cycles: List[List[int]] = []
        seen_cycles: Set[Tuple[int, ...]] = set()

        def dfs(start: int, node: int, path: List[int], on_path: Set[int]) -> None:
            for nxt in adj.get(node, ()):  # graph has ≤ n_stripes+1 nodes
                if nxt == start and len(path) > 1:
                    # canonicalize rotation so each cycle reports once
                    i = path.index(min(path))
                    canon = tuple(path[i:] + path[:i])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        cycles.append(list(canon))
                elif nxt not in on_path and nxt > start:
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return cycles

    def report(self) -> dict:
        """Structured findings. Lock-order cycles are recomputed from the
        graph on every call (they are a property of the whole run, not a
        point event)."""
        cycle_findings = [
            {
                "kind": "lock-order-cycle",
                "detail": (
                    f"stripe locks acquired in a cyclic order {cycle + [cycle[0]]} "
                    f"across threads — potential deadlock even if this run "
                    f"never interleaved fatally"
                ),
                "thread": "<graph>",
                "cycle": cycle,
            }
            for cycle in self._cycles()
        ]
        with self._lock:
            findings = list(self._findings) + cycle_findings
            counts: Dict[str, int] = dict(self._counts)
            live_now = len(self._live)
            edges = len(self._edges)
        by_kind: Dict[str, int] = {}
        for f in findings:
            by_kind[f["kind"]] = by_kind.get(f["kind"], 0) + 1
        return {
            "enabled": True,
            "findings": findings,
            "counts": {**counts, "by_kind": by_kind, "live_requests": live_now,
                       "lock_order_edges": edges},
        }
