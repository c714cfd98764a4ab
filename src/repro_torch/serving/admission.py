"""Request-admission front end for the serving engines (paper ext. 5 + 6).

Production traffic is an open-loop *stream* of requests, not a batch the
caller pre-loads into ``ServeEngine.queue``. :class:`AdmissionFrontEnd`
wires that stream through the runtime we already have:

- **Ingestion** rides a 2-rank :class:`~repro_torch.core.threadcomm.HostThreadComm`
  (trainer loader-rank style): a loader thread attaches as rank 1, pulls
  offers off the caller's (possibly wall-clock-paced) iterable, stamps each
  with its arrival time, and ``send``s it to rank 0 over the mailbox —
  bounded, parkable, and fault-injectable like every other threadcomm hop.
- **Scheduling** runs on the caller's thread as rank 0: a select loop that
  drains the ingest mailbox into :meth:`ServeEngine.submit`, ticks
  :meth:`ServeEngine.step` (continuous batching: slots join/leave every
  step), and streams finished requests back **in completion order** with
  ``engine.wait_any`` as the select primitive — a non-blocking completion
  poll against the generalized requests the engine completes at EOS.
- When there is nothing to decode and the loader is mid-gap, rank 0
  **parks** on the ingest mailbox (``probe(timeout=...)``) instead of
  spinning, so an idle front end costs no polling.

Over-length / malformed offers are rejected by ``submit()``'s validation
(``ValueError``) and recorded on :attr:`AdmissionFrontEnd.rejected` rather
than crashing the loop — admission is where bad requests must bounce.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

from repro_torch.core.threadcomm import HostThreadComm
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.tracing import span

__all__ = ["AdmissionFrontEnd", "Completion", "make_offer"]


def make_offer(prompt, max_new_tokens: int = 16, eos_id: int = -1) -> dict:
    """Build an offer dict for :meth:`AdmissionFrontEnd.serve`."""
    return {"prompt": prompt, "max_new_tokens": max_new_tokens, "eos_id": eos_id}


@dataclass
class Completion:
    """One finished request with its admission-path timestamps, all on the
    front end's clock (the engine stamps ``req.t_first`` on it too)."""

    req: Request
    t_arrival: float  # loader pulled the offer off the stream
    t_submit: float  # rank 0 admitted it into the engine queue
    t_done: float  # engine completed the grequest (EOS / limit)

    @property
    def rid(self) -> int:
        return self.req.rid

    @property
    def n_out(self) -> int:
        return len(self.req.out_tokens)

    @property
    def queue_wait_s(self) -> float:
        return self.t_submit - self.t_arrival

    @property
    def t_first(self) -> float:
        """The engine's stamp of the first token on the host (``Request.t_first``)."""
        return self.req.t_first

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def ttft_s(self) -> float:
        """Arrival to the first token on the host."""
        return self.t_first - self.t_arrival


class AdmissionFrontEnd:
    """Continuous-batching admission loop around a :class:`ServeEngine`.

    The engine must carry a ``progress_engine`` — completion streaming is
    ``engine.wait_any`` over the per-request generalized requests.
    """

    def __init__(
        self,
        engine: ServeEngine,
        clock: Callable[[], float] = time.perf_counter,
        idle_park_s: float = 0.02,
        name: str = "serve-admit",
    ):
        if engine.progress_engine is None:
            raise ValueError(
                "AdmissionFrontEnd needs a ServeEngine with a progress_engine "
                "(completion streaming uses engine.wait_any)"
            )
        self.engine = engine
        self.clock = engine.clock = clock  # the engine stamps first tokens on it too
        self.idle_park_s = idle_park_s
        self.name = name
        self.rejected: List[Dict[str, Any]] = []
        self.steps = 0

    # -- the select loop ---------------------------------------------------
    def serve(
        self,
        offers: Iterable[dict],
        max_steps: int = 1_000_000,
        on_complete: Optional[Callable[[Completion], None]] = None,
        sync_timeout: float = 300.0,
    ) -> List[Completion]:
        """Drive ``offers`` through the engine; return completions in
        **completion order** (not submission order).

        ``offers`` is any iterable of offer dicts (see :func:`make_offer`);
        an open-loop load generator simply sleeps between yields — arrival
        timestamps are taken on the loader rank as each offer is pulled.
        """
        eng = self.engine
        h = HostThreadComm(2, engine=eng.progress_engine, name=self.name)
        h.start()
        loader_errs: List[BaseException] = []

        def loader() -> None:
            lr = h.attach(rank=1)
            try:
                for off in offers:
                    lr.send(0, ("offer", self.clock(), off))
            except BaseException as e:  # noqa: BLE001 - re-raised on rank 0
                loader_errs.append(e)
            finally:
                lr.send(0, ("eof",))
                lr.detach()

        t = threading.Thread(target=loader, name=f"{self.name}-loader", daemon=True)
        t.start()

        r0 = h.attach(rank=0)
        completions: List[Completion] = []
        pending: List[Request] = []
        meta: Dict[int, tuple] = {}  # rid -> (t_arrival, t_submit)
        eof = False
        try:
            for _ in range(max_steps):
                # 1) drain the ingest mailbox into the engine queue
                while not eof and r0.iprobe(src=1) is not None:
                    msg = r0.recv(src=1)
                    if msg[0] == "eof":
                        eof = True
                        break
                    _, t_arr, off = msg
                    try:
                        req = eng.submit(
                            off["prompt"],
                            off.get("max_new_tokens", 16),
                            off.get("eos_id", -1),
                        )
                    except ValueError as e:
                        self.rejected.append(
                            {"offer": off, "error": str(e), "t_arrival": t_arr}
                        )
                        continue
                    meta[req.rid] = (t_arr, self.clock())
                    pending.append(req)

                # 2) one continuous-batching tick (admit + decode)
                if not eng._idle():
                    eng.step()
                    self.steps += 1

                # 3) stream completions as they finish (completion order)
                while pending:
                    done = eng.wait_any(pending, timeout=0.0)
                    if done is None:
                        break
                    pending.remove(done)
                    t_arr, t_sub = meta.pop(done.rid)
                    c = Completion(done, t_arr, t_sub, self.clock())
                    completions.append(c)
                    if on_complete is not None:
                        on_complete(c)

                if eof and not pending and eng._idle():
                    break
                if not eof and eng._idle():
                    # nothing to decode and the loader is mid-gap: park on
                    # the ingest mailbox instead of spinning
                    try:
                        with span("front.park"):
                            r0.probe(src=1, timeout=self.idle_park_s)
                    except TimeoutError:
                        pass  # re-check the loop (offers may still be coming)
            else:
                raise RuntimeError(
                    f"AdmissionFrontEnd.serve did not drain in {max_steps} steps"
                )
        finally:
            r0.detach()
            h.finish(timeout=sync_timeout)
            t.join(timeout=sync_timeout)
        if loader_errs:
            raise loader_errs[0]
        return completions
