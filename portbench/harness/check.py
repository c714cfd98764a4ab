"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests the window served, drawn from the seed and always holding the
longest, is run through the float32 reference of the configuration's
architecture (``architectures/<name>/reference.py``, which the caller hands
in): each prompt with its served tokens, once. At every position where the
program served a token, the reference's logits give the gap by which that
token lies below the reference's best. The cell's file names the readings it compares and
their limits: the widest gap over the sample, or the mean gap over every
token compared (:func:`gap_readings`). In a closed loop the requests still in flight at the close
count with the tokens they were served; an open loop has finished every
request it offered. Beside it, counts that must be zero: requests offered in the
window that never finished, finished requests with fewer tokens than they
asked for, and offers the front end refused.

:func:`control_gaps` reads the control on the same prompts and tokens: at
each position the token the fp8 reference puts first, and its gap under
the float32 reference.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

__all__ = ["sample_served", "served_gaps", "control_gaps", "gap_readings", "run_check"]


def sample_served(records, n: int, seed: int) -> list:
    """Up to ``n`` requests drawn from ``seed`` among those the window
    finished or, in a closed loop, cut at the close with the tokens served
    so far; the longest (prompt and served tokens) always among them."""
    done = [r for r in records if r.t_done is not None and r.req.out_tokens]
    if len(done) <= n:
        return done
    longest = max(done, key=lambda r: (r.prompt_len + len(r.req.out_tokens), r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.choice(len(rest), size=n - 1, replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def _sequence(rec):
    out = list(rec.req.out_tokens)
    tokens = list(map(int, rec.prompt)) + out[:-1]
    at = [rec.prompt_len - 1 + j for j in range(len(out))]
    return tokens, at, out


def served_gaps(ref, rec) -> torch.Tensor:
    """The gap of each served token below the reference's best logit."""
    tokens, at, out = _sequence(rec)
    logits = ref.logits(tokens, at)
    served = logits[torch.arange(len(out)), torch.as_tensor(out, device=logits.device)]
    return logits.max(dim=-1).values - served


def control_gaps(ref, ctrl, rec) -> torch.Tensor:
    """At each served position, the gap under ``ref`` of the token ``ctrl``
    puts first."""
    tokens, at, _ = _sequence(rec)
    logits = ref.logits(tokens, at)
    pick = ctrl.logits(tokens, at).argmax(dim=-1)
    return logits.max(dim=-1).values - logits[torch.arange(len(at)), pick]


def run_check(architecture, cfg: dict, seed: int, device, offered: list, held: list, rejected: int,
              limits: dict, sample: int, control: bool = False) -> dict:
    """Every compared number beside its limit, and ``correct``, judged by the
    reference of ``architecture`` (``arch.load``'s)."""
    t0 = time.perf_counter()
    finished_or_cut = [r for r in offered + held if r.t_done is not None]
    unfinished = sum(1 for r in offered if r.t_done is None)
    short = sum(1 for r in finished_or_cut if not r.cut and len(r.req.out_tokens) != r.max_new)
    picked = sample_served(offered + held, sample, seed)
    reference = architecture.reference
    dims = reference.Dims(cfg)
    weights = reference.draw_weights(dims, seed, device)
    ref = reference.Reference(dims, weights)
    gaps = [served_gaps(ref, rec) for rec in picked]
    readings = gap_readings(gaps)
    ctrl = None
    if control:
        fp8 = reference.Reference(dims, weights, linear="fp8")
        ctrl = gap_readings([control_gaps(ref, fp8, rec) for rec in picked])
    del weights, ref
    numbers: Dict[str, list] = {k: [readings[k], float(v)] for k, v in limits.items()}
    numbers.update(unfinished=[unfinished, 0], short=[short, 0], rejected=[rejected, 0])
    correct = bool(picked) and all(v <= lim for v, lim in numbers.values())
    out = {"correct": correct, "numbers": numbers, "readings": readings, "sampled": len(picked),
           "tokens_compared": readings["tokens"], "per_request_gap": [float(g.max()) for g in gaps],
           "seconds": time.perf_counter() - t0}
    if control:
        out["control"] = ctrl
    return out


def gap_readings(gaps: List[torch.Tensor]) -> dict:
    """The numbers a limit can be set on, from per-request gap vectors:
    ``widest_gap`` (the largest), ``mean_gap`` (over every token compared)
    and ``off_best`` (the share of tokens that are not the reference's best)."""
    flat = torch.cat([g.flatten() for g in gaps]) if gaps else torch.zeros(0)
    n = int(flat.numel())
    return {"widest_gap": float(flat.max()) if n else 0.0, "mean_gap": float(flat.mean()) if n else 0.0,
            "off_best": float((flat > 0).float().mean()) if n else 0.0, "tokens": n}
