"""Batched serving engine: continuous batching over a slotted KV cache
(or, for RWKV-6, a slotted recurrent state; for Jamba, both).

Requests are admitted into free slots; each ``step()`` decodes one token
for every active slot (a single ``decode_step`` over the whole batch —
per-slot positions are a (B,) vector, so ragged progress is native).
Prefill runs per-request and its cache rows are spliced into the batch
cache. Finished slots (EOS or max_new_tokens) are freed for the admission
queue. Host-side bookkeeping (admission, completion callbacks) rides the
progress engine like every other async task in the framework: pass
``progress_engine=`` and every submitted request carries a generalized
request that completes (externally — parked waiters wake via the stream
CV, zero polling) when decode finishes, so one ``engine.wait_all`` can
cover serving alongside other work.

This is the JAX package's ``ServeEngine`` on PyTorch: the model runs
eagerly where the reference jits it, the batch cache is updated in place
(the splice and the decode's K/V writes), and the recorded decode step's
completion is a CUDA event (``enqueue.dispatch_state``) polled with
``query()`` and waited in the replay's blocking assist — never a value
that counts as done the moment it is issued.

:class:`PagedServeEngine` keeps the authoritative KV bytes in the
device-resident page pool of :mod:`repro_torch.serving.paged_kv`, every
page move a K1 launch. :meth:`ServeEngine.run_until_done_threaded` and
:meth:`ServeEngine.run_until_done_elastic` shard the per-slot host
bookkeeping over host threadcomm ranks (paper ext. 5), the elastic loop
surviving a killed rank.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.core.enqueue import _poll_dispatched, _wait_dispatched, dispatch_state
from repro_torch.core.progress import GeneralizedRequest, ProgressEngine
from repro_torch.core.schedule import Schedule, ScheduleStale
from repro_torch.core.streams import MPIXStream, STREAM_NULL
from repro_torch.core.threadcomm import HostThreadComm
from repro_torch.ft.faultinject import RankKilled
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.serving.paged_kv import PagedKVCache, PoolExhausted
from repro_torch.serving.paged_kv import cache_leaves as _leaves
from repro_torch.tracing import span

__all__ = ["Request", "ServeEngine", "PagedServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1 = never
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    grequest: Optional[GeneralizedRequest] = None  # set when a progress engine is attached
    # stamps on the engine's clock: first token on the host, done
    t_first: Optional[float] = None
    t_done: Optional[float] = None


def _cache_signature(cache):
    return tuple((tuple(t.shape), str(t.dtype), str(t.device)) for t in _leaves(cache))


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_batch: int = 8,
        max_len: int = 512,
        progress_engine: Optional[ProgressEngine] = None,
        stream: MPIXStream = STREAM_NULL,
        step_schedule=False,
    ):
        if cfg.encdec:
            # the prefill takes the prompt alone; an encoder-decoder also
            # needs its enc_frames (the reference's engine cannot serve it
            # either): serve it through api.prefill / api.decode_step
            raise ValueError(f"{cfg.name}: ServeEngine serves decoder-only models; an encoder-decoder needs "
                             "enc_frames with each prompt — use models.api.prefill and decode_step")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.progress_engine = progress_engine
        self.stream = stream
        self.device = params.device
        # steady-state decode as a recorded schedule: step() always decodes
        # the full (max_batch,) vectors, so the op graph is one decode
        # dispatch whose shape never depends on the active set — recorded
        # once, replayed every step (see _decode_scheduled)
        if step_schedule is True:
            step_schedule = Schedule(
                engine=progress_engine, stream=stream, name="serve-step"
            )
        self.step_schedule: Optional[Schedule] = step_schedule or None
        self.cache = api.init_cache(cfg, max_batch, max_len, device=self.device)
        self.pos = np.zeros((max_batch,), np.int32)
        self.cur_tok = np.zeros((max_batch,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.queue: Deque[Request] = collections.deque()
        self._rid = itertools.count()
        # the clock of the requests' stamps; an AdmissionFrontEnd sets its own,
        # so that a Completion's stamps share one clock
        self.clock = time.perf_counter

    def _decode(self, params, cache, tokens, pos):
        return api.decode_step(self.cfg, params, cache, tokens, pos)

    def _prefill(self, params, batch):
        return api.prefill(self.cfg, params, batch, max_len=self.max_len)

    # -- admission ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16, eos_id: int = -1) -> Request:
        prompt = np.asarray(prompt, np.int32)
        # validate here, where the caller can still handle it — an
        # over-length prompt admitted into a slot lands pos at/past the
        # cache bound and silently truncates the request to <= 1 token
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            raise ValueError(f"prompt must be a non-empty 1-D token array, got shape {prompt.shape}")
        if prompt.shape[0] >= self.max_len:
            raise ValueError(
                f"prompt of {prompt.shape[0]} tokens does not fit max_len="
                f"{self.max_len} (need len(prompt) < max_len to decode at all)"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        req = Request(next(self._rid), prompt, max_new_tokens, eos_id)
        if self.progress_engine is not None:
            # completion handle: externally completed by step() at EOS — no
            # poll_fn, so a blocked wait_all parks on the CV instead of
            # polling decode state
            req.grequest = self.progress_engine.grequest_start(
                extra_state=req,
                stream=self.stream,
                name=f"serve-{req.rid}",
            )
        self.queue.append(req)
        return req

    def wait(self, req: Request, timeout: Optional[float] = None) -> bool:
        """Block until ``req`` finishes decoding, via the progress engine's
        parking wait. Requires ``progress_engine``."""
        if req.grequest is None:
            raise ValueError("ServeEngine has no progress_engine attached")
        return self.progress_engine.wait(req.grequest, timeout)

    def wait_any(self, reqs: List[Request], timeout: Optional[float] = None) -> Optional[Request]:
        """Block until the *first* of ``reqs`` finishes decoding and
        return it (``engine.wait_any`` — stream results to clients as
        they complete instead of draining the whole batch). None on
        timeout/empty. Requires ``progress_engine``."""
        gs = []
        for r in reqs:
            if r.grequest is None:
                raise ValueError("ServeEngine has no progress_engine attached")
            gs.append(r.grequest)
        g = self.progress_engine.wait_any(gs, timeout)
        # a request's grequest carries the Request itself as extra_state
        return None if g is None else g.extra_state

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _idle(self) -> bool:
        """No work left anywhere: the run loops exit when this holds."""
        return not self.queue and all(r is None for r in self.slot_req)

    def _prefill_request(self, req: Request):
        """Run the per-request prefill, record its token, and apply the
        admission-time termination check: the prefill-produced token IS
        the request's first output token, so EOS/limit are checked here.
        Returns ``(done, cache1)``; a done request must not occupy a
        slot."""
        with span("serve.prefill", rid=req.rid):
            last_logits, cache1 = self._prefill(self.params, {"tokens": req.prompt[None, :]})
            with span("serve.sync"):
                tok = int(torch.argmax(last_logits[0]))
            req.t_first = self.clock()
            req.out_tokens.append(tok)
            if tok == req.eos_id or len(req.out_tokens) >= req.max_new_tokens:
                self._finish(req)
                return True, cache1
            return False, cache1

    def _finish(self, req: Request) -> None:
        """Mark ``req`` done (EOS or limit), stamp it and wake its waiters."""
        req.done = True
        req.t_done = self.clock()
        if req.grequest is not None:
            req.grequest.complete()

    def _splice_in(self, slot: int, req: Request, cache1, pos: int) -> None:
        """Splice the single-row cache into ``slot`` (batch dim = axis 1 of
        every stacked (reps, B, T, ...) leaf), in place, and seat ``req``
        there to decode from position ``pos``."""
        with span("serve.splice", rid=req.rid):
            for full, one in zip(_leaves(self.cache), _leaves(cache1)):
                _splice(full, one, slot)
        self.slot_req[slot] = req
        self.pos[slot] = pos
        self.cur_tok[slot] = req.out_tokens[-1]

    def _admit(self) -> None:
        with span("serve.admit"):
            for slot in self._free_slots():
                while True:
                    if not self.queue:
                        return
                    req = self.queue.popleft()
                    done, cache1 = self._prefill_request(req)
                    if not done:
                        break
                    # finished at admission (EOS/limit on the prefill token):
                    # the slot stays free for the next queued request
                self._splice_in(slot, req, cache1, req.prompt.shape[0])

    # -- decode loop ----------------------------------------------------------
    def _step_inputs(self):
        return (
            torch.as_tensor(self.cur_tok, device=self.device),
            torch.as_tensor(self.pos, device=self.device),
        )

    def _decode_active(self):
        """One decode over the whole batch. Returns (active slot indices,
        next-token vector)."""
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return active, None
        with span("serve.decode"):
            if self.step_schedule is not None:
                logits = self._decode_scheduled()
            else:
                logits, self.cache = self._decode(self.params, self.cache, *self._step_inputs())
            with span("serve.sync"):
                return active, torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()

    def _decode_scheduled(self):
        """The recorded steady-state decode. First active step records and
        seals a one-op graph (the op reads the *live* ``cur_tok``/``pos``/
        ``cache`` at issue time, so membership churn never invalidates);
        every later step is a replay — one fused issue, one wait, no
        per-step request registration. Structure drift (a swapped params
        object, a resized batch or cache) raises :class:`ScheduleStale`
        internally; this engine owns the schedule, so it answers the raise
        the only correct way — a full re-record — rather than surfacing it
        to ``step()`` callers who never saw the schedule. The op runs the
        same decode on the same live state as the unscheduled path."""
        sched = self.step_schedule
        if sched.sealed:
            try:
                sched.check(
                    params_id=id(self.params),
                    max_batch=self.max_batch,
                    max_len=self.max_len,
                    cache_tree=_cache_signature(self.cache),
                )
                return sched.replay().outputs["logits"]
            except ScheduleStale:
                pass  # invalidated; fall through to re-record
        rec = sched.record()
        try:
            sched.fingerprint(
                params_id=id(self.params),
                max_batch=self.max_batch,
                max_len=self.max_len,
                cache_tree=_cache_signature(self.cache),
            )

            def issue(ctx):
                logits, cache = self._decode(self.params, self.cache, *self._step_inputs())
                self.cache = cache
                # completion = a CUDA event after the decode (None on CPU)
                state = dispatch_state(logits, self.stream)
                ctx.fused.part(poll_fn=_poll_dispatched, extra_state=state, name="serve-decode")
                # blocking completion assist (see ReplayContext.prewaits)
                ctx.prewaits.append(lambda: _wait_dispatched([state], None))
                ctx.outputs["logits"] = logits

            sched.add_op("serve_decode", issue, parts=1, label="decode-step")
            rec.seal()
        finally:
            rec.abort()
        # the freshly recorded graph replays immediately: recording is
        # cheap here (no eager twin to run — the op reads live state)
        return sched.replay().outputs["logits"]

    def _advance_slot(self, i: int, tok: int) -> None:
        """Per-slot host bookkeeping after a decode step: record the token,
        bump position, free the slot at EOS/limit. Safe to run concurrently
        for DISJOINT slots (each touches only index i)."""
        req = self.slot_req[i]
        req.out_tokens.append(tok)
        self.pos[i] += 1
        self.cur_tok[i] = tok
        if tok == req.eos_id or len(req.out_tokens) >= req.max_new_tokens or self.pos[i] >= self.max_len - 1:
            self._finish(req)
            self.slot_req[i] = None

    def step(self) -> int:
        """Admit + decode one token for all active slots. Returns #active."""
        with span("serve.step"):
            self._admit()
            active, next_tok = self._decode_active()
            with span("serve.advance"):
                for i in active:
                    self._advance_slot(i, int(next_tok[i]))
        return len(active)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self._idle():
                return
            self.step()

    # -- threadcomm generation loop (paper ext. 5 consumer) -----------------
    def run_until_done_threaded(
        self, n_threads: int = 2, max_steps: int = 10_000, sync_timeout: float = 300.0
    ) -> None:
        """``run_until_done`` with the host-side bookkeeping sharded over
        ``n_threads`` threadcomm ranks. Rank 0 drives admission and the
        batched decode; each generation step is then one **bcast** of the
        (active, next-token) payload — every worker updates its own slot
        shard (slot i belongs to rank i % n) — and an error-flag
        **allreduce** (a barrier that also carries abort state) before
        the next decode reads the advanced pos/cur_tok state. Blocked
        ranks park on their own VCI stripes between steps, so idle workers
        cost no polling (engine ``stats()`` shows parks, not polls). On the
        card, rank 0's ``_decode_active`` ends in a host copy of the next
        tokens, so the decode is complete before any worker's slot work.

        Failures cannot strand the loop: a rank-0 decode error is
        broadcast as an abort, a worker error raises the step's allreduce
        flag so every rank (rank 0 included) exits the loop, and every
        collective hop carries ``sync_timeout`` as a backstop — so the
        epoch always closes and the VCI channels always return to the
        pool; the first error re-raises after teardown."""
        if n_threads < 1:
            raise ValueError("run_until_done_threaded needs n_threads >= 1")
        engine = self.progress_engine
        comm = HostThreadComm(n_threads, engine=engine, name="serve-tc")
        comm.start()
        errors: List[BaseException] = []

        def worker(rank: int) -> None:
            h = comm.attach(rank=rank)
            try:
                for _ in range(max_steps):
                    if rank == 0:
                        try:
                            if self._idle():
                                payload = None
                            else:
                                self._admit()
                                payload = ("step", self._decode_active())
                        except BaseException as e:  # must still reach the other ranks
                            errors.append(e)
                            payload = ("abort",)
                        payload = h.bcast(payload, root=0, timeout=sync_timeout)
                    else:
                        payload = h.bcast(root=0, timeout=sync_timeout)
                    if payload is None or payload[0] == "abort":
                        return
                    failed = 0
                    try:
                        active, next_tok = payload[1]
                        for i in active:
                            if i % n_threads == rank:
                                self._advance_slot(i, int(next_tok[i]))
                    except BaseException as e:
                        errors.append(e)
                        failed = 1
                    # all shards advanced (or one failed) before the next
                    # decode reads them; a raised flag exits every rank
                    if int(h.allreduce(failed, op="max", timeout=sync_timeout)):
                        return
            except BaseException as e:  # collective timeout / unexpected failure
                errors.append(e)
            finally:
                h.detach()

        threads = [
            threading.Thread(target=worker, args=(r,), daemon=True, name=f"serve-tc-{r}")
            for r in range(1, n_threads)
        ]
        try:
            for t in threads:
                t.start()
            worker(0)
        finally:
            for t in threads:
                t.join(timeout=sync_timeout)
            comm.finish(timeout=30.0, drain=True)
        if errors:
            raise errors[0]

    # -- elastic threadcomm loop (fault-injected rank death survivable) ------
    def run_until_done_elastic(
        self,
        n_threads: int = 2,
        fault_injector=None,
        max_steps: int = 10_000,
        sync_timeout: float = 300.0,
    ) -> dict:
        """:meth:`run_until_done_threaded` that survives rank death.

        A killed worker (``ft.faultinject`` arming a ``kill_rank`` event:
        its mailbox ops raise :class:`~repro_torch.ft.faultinject.RankKilled`)
        trips the same abort protocol as the threaded loop — the epoch
        closes cleanly, every channel returns to the pool — but instead of
        re-raising, the dead rank is dropped and the loop re-opens a
        fresh epoch over the survivors, whose ``i % n`` shard map now
        covers the dead rank's slots.

        No token is lost and none is duplicated across the abort: all
        decode state lives in the engine (``pos``/``cur_tok``/``cache``/
        ``out_tokens``), not in the threads, and the interrupted step is
        repaired transactionally — rank 0 snapshots ``pos`` before each
        bcast, so after the epoch tears down it can tell exactly which
        active slots the dying epoch advanced (``pos`` moved) and
        advances only the ones it didn't. Returns a summary dict
        (``epochs``, ``dead_ranks``).
        """
        if n_threads < 1:
            raise ValueError("run_until_done_elastic needs n_threads >= 1")
        live = list(range(n_threads))
        dead: List[int] = []
        epochs = 0
        while True:
            epochs += 1
            killed = self._run_elastic_epoch(live, fault_injector, max_steps, sync_timeout)
            if killed is None:
                return {"epochs": epochs, "dead_ranks": dead}
            dead.append(killed)
            live = [r for r in live if r != killed]
            if not live:
                raise RankKilled(killed)

    def _run_elastic_epoch(
        self, live: List[int], fault_injector, max_steps: int, sync_timeout: float
    ) -> Optional[int]:
        """One threadcomm epoch over ``live`` (global) ranks. Returns the
        global rank the injector killed (the epoch aborted), or None (all
        requests drained). Any non-kill error re-raises."""
        n = len(live)
        hook = None
        if fault_injector is not None:
            # comm ranks renumber every epoch; the injector targets GLOBAL
            # ranks, so translate before checking
            def hook(site, rank=None, dst=None):
                fault_injector.check(
                    site,
                    rank=None if rank is None else live[rank],
                    dst=None if dst is None else live[dst],
                )

        comm = HostThreadComm(n, engine=self.progress_engine, fault_hook=hook, name="serve-tc-el")
        comm.start()
        errors: List[BaseException] = []
        # transactional step repair state: (active, next_tok, pos_before)
        inflight: List = [None]

        def worker(rank: int) -> None:
            h = comm.attach(rank=rank)
            try:
                for _ in range(max_steps):
                    if rank == 0:
                        try:
                            if self._idle():
                                payload = None
                            else:
                                self._admit()
                                active, next_tok = self._decode_active()
                                inflight[0] = (active, next_tok, self.pos.copy())
                                payload = ("step", (active, next_tok))
                        except BaseException as e:
                            errors.append(e)
                            payload = ("abort",)
                        payload = h.bcast(payload, root=0, timeout=sync_timeout)
                    else:
                        payload = h.bcast(root=0, timeout=sync_timeout)
                    if payload is None or payload[0] == "abort":
                        return
                    failed = 0
                    try:
                        active, next_tok = payload[1]
                        for i in active:
                            if i % n == rank:
                                self._advance_slot(i, int(next_tok[i]))
                    except BaseException as e:
                        errors.append(e)
                        failed = 1
                    if int(h.allreduce(failed, op="max", timeout=sync_timeout)):
                        return
                    if rank == 0:
                        inflight[0] = None  # step fully applied everywhere
            except BaseException as e:
                errors.append(e)
            finally:
                h.detach()

        threads = [
            threading.Thread(target=worker, args=(r,), daemon=True, name=f"serve-el-{r}")
            for r in range(1, n)
        ]
        try:
            for t in threads:
                t.start()
            worker(0)
        finally:
            for t in threads:
                t.join(timeout=sync_timeout)
            comm.finish(timeout=30.0, drain=True)

        kills = [e for e in errors if isinstance(e, RankKilled)]
        others = [e for e in errors if not isinstance(e, (RankKilled, TimeoutError))]
        if others:
            raise others[0]
        if not kills:
            if errors:  # timeouts without a kill: a real stall, surface it
                raise errors[0]
            return None
        # repair the interrupted step: advance exactly the active slots the
        # dying epoch did NOT get to (their pos never moved). Workers have
        # joined — no one else touches pos now.
        if inflight[0] is not None:
            active, next_tok, pos_before = inflight[0]
            for i in active:
                if self.slot_req[i] is not None and self.pos[i] == pos_before[i]:
                    self._advance_slot(i, int(next_tok[i]))
        return kills[0].rank



def _splice(full, one, slot: int) -> None:
    """Copy a B=1 cache row into the batch cache at ``slot``, in place.
    Caches are stacked per layer on axis 0 with batch at axis 1."""
    if full.dim() == one.dim() and one.shape[1] == 1:
        full[:, slot : slot + 1].copy_(one)
        return
    raise ValueError(f"unexpected cache leaf shapes {tuple(full.shape)} vs {tuple(one.shape)}")


class PagedServeEngine(ServeEngine):
    """:class:`ServeEngine` over a paged KV store (``serving.paged_kv``).

    The dense ``(max_batch, max_len)`` cache remains the decode working
    set — the batchwide ``decode_step`` is unchanged, so resident
    requests produce token-for-token the contiguous engine's stream —
    but the *authoritative* KV bytes live in fixed-size pages with a
    per-request page table:

    * admission is no longer bounded by ``max_batch``: a queued request
      is **prefilled ahead** into pages (actual prompt length, rounded
      up to one page) and parks awaiting a slot; activation scatters its
      pages into the freed slot row (a datatype-described gather, no
      re-prefill) and decode resumes where the prefill token left off.
    * every decode step appends the newly written position of each
      active slot to its pages (the decode-step page view), so a done
      request's release returns exactly its pages to the pool.
    * pool pressure spills cold prefix pages of parked requests (the
      youngest-parked first — it activates last) to the host cold store
      through the spill :class:`~repro_torch.core.enqueue.OffloadWindow`,
      and activation reloads them.

    On the card the pool lives on the device and every append and gather
    is K1 launches on the engine's stream (see ``serving.paged_kv``).

    FIFO order is preserved end to end (parked requests are by
    construction older than queued ones), which is what makes the
    paged-vs-contiguous token parity exact under identical traffic.
    Only position-indexed caches page (dense attention); the paged
    store's constructor rejects ring-buffer windowed layouts.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        max_batch: int = 8,
        max_len: int = 512,
        progress_engine: Optional[ProgressEngine] = None,
        stream: MPIXStream = STREAM_NULL,
        step_schedule=False,
        page_size: int = 16,
        pool_pages: Optional[int] = None,
        spill_parked: bool = False,
    ):
        super().__init__(
            cfg,
            params,
            max_batch=max_batch,
            max_len=max_len,
            progress_engine=progress_engine,
            stream=stream,
            step_schedule=step_schedule,
        )
        if pool_pages is None:
            # default: the bytes the contiguous engine would reserve
            pool_pages = max_batch * (-(-max_len // page_size))
        self.kv = PagedKVCache(
            self.cache,
            max_len,
            page_size=page_size,
            num_pages=pool_pages,
            engine=progress_engine,
            spill_stream=stream,
        )
        self.parked: Deque[Request] = collections.deque()
        self.spill_parked = spill_parked
        # growth headroom withheld from prefill-ahead admission: every
        # active slot may cross a page boundary at its next decode step
        self._page_reserve = max_batch
        self.max_concurrent = 0

    # -- pool pressure -----------------------------------------------------
    def _make_room(self, need: int) -> bool:
        """Free ``need`` pool pages by spilling cold prefix pages of parked
        requests, youngest first (the last to activate). Returns whether
        the pool now has ``need`` free pages."""
        if self.kv.free_pages >= need:
            return True
        with span("kv.make_room"):
            self.kv.reclaim(wait=True)
            for req in reversed(self.parked):
                if self.kv.free_pages >= need:
                    break
                short = need - self.kv.free_pages
                if self.kv.spillable(req.rid) and self.kv.spill_prefix(req.rid, max_pages=short):
                    self.kv.reclaim(wait=True)
            return self.kv.free_pages >= need

    # -- admission ---------------------------------------------------------
    def _activate(self, slot: int, req: Request) -> None:
        """Scatter a parked request's pages into ``slot`` and resume
        decode after its prefill token — no re-prefill."""
        try:
            cache1 = self.kv.gather(req.rid)
        except PoolExhausted:
            # reload may need pool rows for the spilled pages: make room
            # at the expense of younger parked requests and retry once
            self._make_room(sum(1 for p in self.kv.page_table(req.rid) if p is None))
            cache1 = self.kv.gather(req.rid)
        self._splice_in(slot, req, cache1, self.kv.length(req.rid))

    def _prefill_paged(self, req: Request) -> bool:
        """Prefill + write the prompt span into fresh pages. Returns False
        when the request finished at admission (EOS/limit on the prefill
        token — the same check the contiguous engine applies) and
        consumed no pages."""
        done, cache1 = self._prefill_request(req)
        if done:
            return False
        self.kv.alloc(req.rid)
        # prefill splice: the whole prompt span, one descriptor pack per
        # leaf per page chunk (B=1 source — slot 0 of the prefill cache)
        self.kv.append(req.rid, cache1, 0, 0, int(req.prompt.shape[0]))
        return True

    def _admit(self) -> None:
        with span("serve.admit"):
            self.kv.reclaim()  # harvest completed spill copies
            # keep decode growth safe: every active slot sitting on a page
            # boundary allocates at its next append
            crossing = sum(
                1
                for i, r in enumerate(self.slot_req)
                if r is not None and self.pos[i] % self.kv.page_size == 0
            )
            if crossing:
                self._make_room(crossing)
            for slot in self._free_slots():
                if self.parked:
                    self._activate(slot, self.parked.popleft())
                    continue
                admitted = False
                while self.queue:
                    nxt = self.queue[0]
                    need = self.kv.pages_for(int(nxt.prompt.shape[0]))
                    if self.kv.free_pages < need and not self._make_room(need):
                        break  # pool full even after spilling: stop admitting
                    req = self.queue.popleft()
                    if not self._prefill_paged(req):
                        continue  # done at admission; slot stays free
                    self._splice_in(slot, req, self.kv.gather(req.rid), req.prompt.shape[0])
                    admitted = True
                    break
                if not admitted and not self.parked:
                    break
            # prefill-ahead: park queued requests in pages while the pool has
            # room beyond the growth reserve — admission depth is now a page
            # budget (actual lengths), not a slot count (max_len reservations)
            while self.queue:
                nxt = self.queue[0]
                need = self.kv.pages_for(int(nxt.prompt.shape[0]))
                if self.kv.free_pages - self._page_reserve < need:
                    break
                req = self.queue.popleft()
                if not self._prefill_paged(req):
                    continue
                self.parked.append(req)
                if self.spill_parked:
                    # park cold: move the full prefix pages to the cold store
                    # right away, keeping only the partial tail resident
                    self.kv.spill_prefix(req.rid)
            concurrent = sum(1 for r in self.slot_req if r is not None) + len(self.parked)
            if concurrent > self.max_concurrent:
                self.max_concurrent = concurrent

    def _idle(self) -> bool:
        return not self.parked and super()._idle()

    # -- decode bookkeeping -------------------------------------------------
    def _advance_slot(self, i: int, tok: int) -> None:
        """Mirror the decode step's newly written position into the
        request's pages (the decode-step page view) before the base
        bookkeeping advances ``pos`` — the span ``[pos, pos+1)`` of slot
        ``i`` is exactly what the decode just wrote. Idempotent
        under the elastic loop's transactional repair (re-appending an
        already-stored span overwrites byte-identically)."""
        req = self.slot_req[i]
        try:
            self.kv.append(req.rid, self.cache, i, int(self.pos[i]), 1)
        except PoolExhausted:
            self._make_room(1)
            self.kv.append(req.rid, self.cache, i, int(self.pos[i]), 1)
        super()._advance_slot(i, tok)
        if req.done:
            self.kv.release(req.rid)

    def stats(self) -> dict:
        return {
            "max_concurrent": self.max_concurrent,
            "parked": len(self.parked),
            "active": sum(1 for r in self.slot_req if r is not None),
            "queued": len(self.queue),
            "kv": self.kv.stats(),
        }
