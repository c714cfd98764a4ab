"""Batched serving engine: continuous batching over a slotted KV cache
(or, for RWKV-6, a slotted recurrent state).

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
that counts as done the moment it is issued. The paged engine, the
threadcomm loop and the elastic loop come with later slices (ROADMAP).
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.core.enqueue import _poll_dispatched, _wait_dispatched, dispatch_state
from repro_torch.core.progress import GeneralizedRequest, ProgressEngine
from repro_torch.core.schedule import Schedule, ScheduleStale
from repro_torch.core.streams import MPIXStream, STREAM_NULL
from repro_torch.models import api
from repro_torch.models.config import ModelConfig

__all__ = ["Request", "ServeEngine"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1 = never
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    grequest: Optional[GeneralizedRequest] = None  # set when a progress engine is attached


def _leaves(cache):
    """The tensors of a nested dict/list/tuple cache in a fixed order: dict
    keys sorted, sequences in order — the order ``jax.tree`` walks. That
    covers the transformer's groups → pattern → (K, V) and RWKV's
    ``{"wkv", "x_cm", "x_tm"}`` state."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    if isinstance(cache, dict):
        return [t for key in sorted(cache) for t in _leaves(cache[key])]
    if isinstance(cache, (list, tuple)):
        return [t for sub in cache for t in _leaves(sub)]
    raise TypeError(f"cache leaf of type {type(cache).__name__} is not a tensor")


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
        last_logits, cache1 = self._prefill(self.params, {"tokens": req.prompt[None, :]})
        tok = int(torch.argmax(last_logits[0]))
        req.out_tokens.append(tok)
        if tok == req.eos_id or len(req.out_tokens) >= req.max_new_tokens:
            req.done = True
            if req.grequest is not None:
                req.grequest.complete()
            return True, cache1
        return False, cache1

    def _admit(self) -> None:
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
            # splice the single-row cache into this slot (batch dim = axis 1
            # of every stacked (reps, B, T, ...) leaf), in place
            for full, one in zip(_leaves(self.cache), _leaves(cache1)):
                _splice(full, one, slot)
            self.slot_req[slot] = req
            self.pos[slot] = req.prompt.shape[0]
            self.cur_tok[slot] = req.out_tokens[-1]

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
        if self.step_schedule is not None:
            logits = self._decode_scheduled()
        else:
            logits, self.cache = self._decode(self.params, self.cache, *self._step_inputs())
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
            req.done = True
            if req.grequest is not None:
                req.grequest.complete()  # wakes parked waiters
            self.slot_req[i] = None

    def step(self) -> int:
        """Admit + decode one token for all active slots. Returns #active."""
        self._admit()
        active, next_tok = self._decode_active()
        for i in active:
            self._advance_slot(i, int(next_tok[i]))
        return len(active)

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if self._idle():
                return
            self.step()


def _splice(full, one, slot: int) -> None:
    """Copy a B=1 cache row into the batch cache at ``slot``, in place.
    Caches are stacked per layer on axis 0 with batch at axis 1."""
    if full.dim() == one.dim() and one.shape[1] == 1:
        full[:, slot : slot + 1].copy_(one)
        return
    raise ValueError(f"unexpected cache leaf shapes {tuple(full.shape)} vs {tuple(one.shape)}")
