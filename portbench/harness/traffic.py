"""The one traffic generator: every mix is a data file of parameters.

A mix (``portbench/traffic/<name>.json``) gives the distributions of prompt
and output lengths, the arrival kind and the size of the request pool:

* ``"poisson"``: open loop. Offers are due at the cell's ``rate_per_s``,
  whether or not earlier requests have finished; the loader sleeps until
  each is due and sends it late when it runs behind.
* ``"closed"``: a backlog. ``outstanding`` requests are kept in the system
  (submitted and not finished): a finished one lets the next in.

Every seed serves the same pool of request sizes and the same set of gaps
between arrivals: lengths and gaps are the distribution's quantiles at
``(i + 0.5) / n``, at token granularity, so the seed never changes the
amount of work. A prompt length is paired with an output length by one
fixed permutation, the same for every seed.

An open loop's pool is exactly the requests due in the window,
``floor(rate * seconds)`` of them, with gaps whose mean is ``1 / rate``,
offered in one order drawn from a constant: every seed offers the same
sizes at the same times and only the token ids change, because a queue's
tail depends on which requests meet (an open loop near its knee read up to
12% apart from seed to seed on one order of work, against a few per cent
between two runs of one seed). A closed loop draws from a pool of ``pool``
requests in an order drawn from the seed, and starts it again in a new
order when it runs out. Where set-up fills the slots (``fill_slots``), it
draws in groups of the cell's ``max_batch`` instead: which requests make up
each group, and the order of the groups, come from a constant, and the
seed orders the requests within each group, so every seed puts the same
sizes into the slots at the same turn. Drawn whole from the seed, the
sizes in the slots, and so when they finish and refill, changed the work
of a long generation from seed to seed, and its rate with it (two runs of
one seed 0.45% apart, three seeds 10%).
"""

from __future__ import annotations

import math
import statistics
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["quantile_lengths", "TrafficPlan", "OfferStream"]

_NORMAL = statistics.NormalDist()


def _ppf(spec: dict, q: float) -> float:
    kind = spec.get("dist", "uniform")
    if kind == "uniform":
        return spec["min"] + q * (spec["max"] - spec["min"])
    if kind == "lognormal":
        return math.exp(math.log(spec["median"]) + spec["sigma"] * _NORMAL.inv_cdf(q))
    raise ValueError(f"unknown length distribution {kind!r}")


def quantile_lengths(spec: dict, n: int) -> List[int]:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of ``spec``'s
    distribution, rounded to whole tokens and clipped to ``[min, max]``."""
    lo, hi = int(spec["min"]), int(spec["max"])
    return [min(max(round(_ppf(spec, (i + 0.5) / n)), lo), hi) for i in range(n)]


#: the constant an open loop's order, and the groups of a closed loop that fills its slots, are drawn from
ORDER = 0x0DE5


class TrafficPlan:
    """The requests of one run, from a mix, the cell, a seed and the
    window's length (module doc).

    ``next_request()`` gives ``(prompt, max_new_tokens)`` in the run's
    order, or None when an open loop's pool is spent; ``next_gap()`` the
    seconds to the next due time (poisson only)."""

    def __init__(self, mix: dict, cell: dict, vocab: int, seed: int, seconds: float):
        self.mix, self.cell, self.vocab = mix, cell, int(vocab)
        self.arrivals = mix["arrivals"]
        if self.arrivals not in ("poisson", "closed"):
            raise ValueError(f"unknown arrivals {self.arrivals!r}")
        if self.arrivals == "poisson":
            rate = float(cell["rate_per_s"])
            n = max(1, int(rate * float(seconds)))
            gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
            scale = n / rate / sum(gaps)  # mean gap exactly 1 / rate
            self._gap_pool = [g * scale for g in gaps]
        else:
            n = int(mix["pool"])
        outputs = quantile_lengths(mix["output"], n)
        pairing = np.random.default_rng(0x5EED).permutation(n)  # the same for every seed
        self.pool: List[Tuple[int, int]] = [(p, outputs[j]) for p, j in zip(quantile_lengths(mix["prompt"], n), pairing)]
        self.rng = np.random.default_rng(int(seed))  # the token ids, and a closed loop's order
        self._order_rng = np.random.default_rng(ORDER)
        self._order: List[int] = self._new_order()
        self._gaps: List[float] = []
        if self.arrivals == "poisson":
            self._gaps = [self._gap_pool[i] for i in self._order_rng.permutation(n)]
        self.outstanding = int(mix.get("outstanding", 0))

    def _new_order(self) -> List[int]:
        """The pool's indices in the order of the next pass (module doc)."""
        n = len(self.pool)
        if self.arrivals == "poisson":
            return list(self._order_rng.permutation(n))
        if not self.mix.get("fill_slots"):
            return list(self.rng.permutation(n))
        base, k = self._order_rng.permutation(n), int(self.cell.get("max_batch") or n)
        return [int(i) for g in range(0, len(base), k) for i in self.rng.permutation(base[g:g + k])]

    @property
    def warm_lengths(self) -> List[int]:
        """The prompt lengths set-up sends through the prefill: the longest
        first (its blocks stay cached for the shorter ones), the
        shortest, and each length of the pool that is a multiple of 128 (the
        port's prefill takes its flash kernel only there). The eager prefill
        compiles nothing per length, so the other lengths need no warm-up."""
        lengths = sorted({p for p, _ in self.pool})
        return [lengths[-1], lengths[0]] + [p for p in lengths[1:-1] if p % 128 == 0]

    def next_request(self) -> Optional[Tuple[np.ndarray, int]]:
        if not self._order:
            if self.arrivals == "poisson":
                return None
            self._order = self._new_order()
        plen, nout = self.pool[self._order.pop(0)]
        prompt = self.rng.integers(0, self.vocab, size=plen, dtype=np.int64).astype(np.int32)
        return prompt, nout

    def next_gap(self) -> Optional[float]:
        return self._gaps.pop(0) if self._gaps else None


class OfferStream:
    """The iterable the admission front end's loader pulls offers from.

    Offers are made from ``plan`` from ``t_start`` until ``t_close`` (both
    on ``clock``), and each offer's due time is kept in ``due`` under the
    id of its prompt array, which the engine receives as is. A closed loop
    waits for ``release()`` (called once per finished request) before it
    offers beyond ``outstanding - held`` requests, ``held`` being what the
    run put into the engine itself before the window."""

    def __init__(self, plan: TrafficPlan, make_offer: Callable, clock: Callable[[], float],
                 t_start: float, t_close: float, held: int = 0):
        self.plan, self.make_offer, self.clock = plan, make_offer, clock
        self.t_start, self.t_close = t_start, t_close
        self.due: Dict[int, float] = {}
        self.offers: List[dict] = []  # keeps every prompt (and so its id) alive
        if plan.arrivals == "closed":
            self._slots = threading.Semaphore(max(0, plan.outstanding - held))
        self.late_s: List[float] = []  # how late the loader sent each offer

    def release(self) -> None:
        if self.plan.arrivals == "closed":
            self._slots.release()

    def _offer(self, due: float) -> Optional[dict]:
        nxt = self.plan.next_request()
        if nxt is None:
            return None
        prompt, nout = nxt
        off = self.make_offer(prompt, max_new_tokens=nout)
        self.due[id(prompt)] = due
        self.offers.append(off)
        return off

    def __iter__(self) -> Iterator[dict]:
        if self.plan.arrivals == "poisson":
            due = self.t_start
            while True:
                gap = self.plan.next_gap()
                if gap is None or due + gap >= self.t_close:
                    return
                due += gap
                wait = due - self.clock()
                if wait > 0:
                    time.sleep(wait)
                self.late_s.append(max(0.0, self.clock() - due))
                off = self._offer(due)
                if off is None:
                    return
                yield off
        else:
            while True:
                while not self._slots.acquire(timeout=0.01):
                    if self.clock() >= self.t_close:
                        return
                now = self.clock()
                if now >= self.t_close:
                    return
                yield self._offer(now)  # a closed loop's pool starts again: never None

    def lookup_due(self, prompt) -> Optional[float]:
        return self.due.get(id(prompt))
