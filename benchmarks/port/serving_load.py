"""Serving under Poisson open-loop load on the PyTorch port: contiguous vs
paged KV.

    python benchmarks/port/serving_load.py --device cpu --smoke
    python benchmarks/port/serving_load.py                 # on the card
    python benchmarks/port/serving_load.py --json chiprun_out/serving_load.json

The port of ``benchmarks/serving_load.py``: the same traffic, sizes and
sections, each asserted the same way, on ``repro_torch``. The paged KV cache
(``serving/paged_kv``) keeps its page pool on the device and moves every page
span through the datatype kernel (K1); the admission front end
(``serving/admission``) drives continuous batching with a threadcomm loader
rank and ``engine.wait_any`` as the select loop.

Sections:

* **load** — an open-loop Poisson arrival process (the loader rank sleeps
  exp(1/rate) between offers; arrival stamps taken there) over a mix of
  prompt/output lengths, per engine kind. Reports sustained requests/s over
  the arrival→last-completion span and p50/p99 time to first token
  (arrival→the engine's ``Request.t_first`` stamp, via ``Completion.t_first``).
* **parity** — the two load runs saw identical traffic; their token streams
  must match request for request. **Asserted.**
* **spill** — the same traffic prefix through a deliberately tight pool with
  ``spill_parked=True``: parked prefixes spill to pinned host memory through
  the OffloadWindow and reload on activation, still token-identical.
  **Asserted** (and spills must actually happen).
* **equal_memory** — the same token-slot budget both sides: contiguous
  ``max_batch`` slots × ``max_len`` vs a paged engine with half the dense
  slots plus the other half of the budget as pool pages. The paged engine
  must sustain a **deeper concurrent request set** than the contiguous
  engine has slots. **Asserted.**

Both modes serve the reference's small ``qwen1.5-0.5b`` preset
(``get_config(ARCH, smoke=True)``); ``--smoke`` only cuts the traffic
(10 requests of 3-8 prompt tokens at 40 req/s and ``max_len`` 32, against
32 requests of 4-24 tokens at 25 req/s and ``max_len`` 64). At these sizes
the requests/s follow the Poisson arrival rate and the latencies a toy
model's step, so the run is a functional check of the paged path (parity,
spill, equal memory), not a measure of the card; the full-width paged
numbers come from ``chip_smoke.py``'s ``serve_paged`` phase.

Runs on the card unless ``--device cpu`` is given; imports nothing of JAX.
Results are printed; ``--json PATH`` also writes them to ``PATH``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.progress import ProgressEngine  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.admission import AdmissionFrontEnd, make_offer  # noqa: E402
from repro_torch.serving.engine import PagedServeEngine, ServeEngine  # noqa: E402

ARCH = "qwen1.5-0.5b"


def _traffic(cfg, seed, n, prompt_lens, out_range):
    rng = np.random.default_rng(seed)
    offers = []
    for _ in range(n):
        plen = int(rng.choice(prompt_lens))
        offers.append(
            make_offer(
                rng.integers(1, cfg.vocab, size=plen).astype(np.int32),
                max_new_tokens=int(rng.integers(*out_range)),
            )
        )
    return offers


def _warmup(eng, prompt_lens):
    """One request per prompt length before the timed traffic, so first
    arrivals do not pay one-time set-up (library handles, the allocator's
    first blocks) inside their latency."""
    for plen in sorted(set(int(p) for p in prompt_lens)):
        eng.submit(np.arange(1, plen + 1, dtype=np.int32), max_new_tokens=1)
    eng.run_until_done(max_steps=200)


def _poisson(offers, rate_rps, seed):
    rng = np.random.default_rng(seed)
    for off in offers:
        time.sleep(float(rng.exponential(1.0 / rate_rps)))
        yield off


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_load(cfg, params, kind, offers, rate_rps, prompt_lens, *, max_batch, max_len, **paged_kw):
    pe = ProgressEngine()
    if kind == "paged":
        eng = PagedServeEngine(
            cfg, params, max_batch=max_batch, max_len=max_len,
            progress_engine=pe, **paged_kw,
        )
    else:
        eng = ServeEngine(cfg, params, max_batch=max_batch, max_len=max_len, progress_engine=pe)
    _warmup(eng, prompt_lens)
    fe = AdmissionFrontEnd(eng)
    cs = fe.serve(_poisson(offers, rate_rps, seed=99))
    _sync(params.device)
    assert len(cs) == len(offers) and not fe.rejected
    span = max(c.t_done for c in cs) - min(c.t_arrival for c in cs)
    ttft_ms = np.array([c.ttft_s * 1e3 for c in cs])
    row = {
        "requests_per_s": len(cs) / span,
        "p50_ttft_ms": float(np.quantile(ttft_ms, 0.50)),
        "p99_ttft_ms": float(np.quantile(ttft_ms, 0.99)),
        "completed": len(cs),
        "tokens_out": int(sum(c.n_out for c in cs)),
        "steps": fe.steps,
        "max_concurrent": int(getattr(eng, "max_concurrent", eng.max_batch)),
    }
    # token streams in submission (= arrival) order, for the parity section
    tokens = [c.req.out_tokens for c in sorted(cs, key=lambda c: c.rid)]
    kv = eng.stats()["kv"] if kind == "paged" else None
    pe.stop_all()
    return row, tokens, kv


def _run_direct(eng, offers, max_steps=3000):
    reqs = [eng.submit(o["prompt"], o["max_new_tokens"]) for o in offers]
    eng.run_until_done(max_steps=max_steps)
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs]


def bench(smoke: bool = False, device: str = "cuda") -> dict:
    if smoke:
        n, rate = 10, 40.0
        max_batch, max_len, page_size, pool_pages = 2, 32, 4, 24
        prompt_lens, out_range = (3, 5, 8), (1, 6)
        spill_cfg = dict(max_batch=2, page_size=4, pool_pages=9)
        em = dict(contig_slots=4, dense=2, page_size=4, pool_pages=16, n=10,
                  prompt_lens=(4, 6), out_range=(3, 6))
    else:
        n, rate = 32, 25.0
        max_batch, max_len, page_size, pool_pages = 4, 64, 8, 32
        prompt_lens, out_range = (4, 8, 12, 16, 24), (2, 12)
        spill_cfg = dict(max_batch=2, page_size=8, pool_pages=12)
        em = dict(contig_slots=8, dense=4, page_size=8, pool_pages=32, n=20,
                  prompt_lens=(4, 8, 12, 16), out_range=(4, 11))

    dev = resolve_device(device)
    cfg = get_config(ARCH, smoke=True)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    offers = _traffic(cfg, seed=42, n=n, prompt_lens=prompt_lens, out_range=out_range)

    data: dict = {
        "smoke": smoke,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "config": {
            "arch": ARCH,
            "n_requests": n,
            "rate_rps": rate,
            "max_batch": max_batch,
            "max_len": max_len,
            "page_size": page_size,
            "pool_pages": pool_pages,
            "prompt_lens": [int(p) for p in prompt_lens],
            "out_range": list(out_range),
            "seed": 42,
        },
    }

    # -- Poisson open-loop load, both engines over identical traffic ----
    contig_row, contig_tokens, _ = _run_load(
        cfg, params, "contiguous", offers, rate, prompt_lens,
        max_batch=max_batch, max_len=max_len,
    )
    paged_row, paged_tokens, kv = _run_load(
        cfg, params, "paged", offers, rate, prompt_lens,
        max_batch=max_batch, max_len=max_len,
        page_size=page_size, pool_pages=pool_pages,
    )
    data["load"] = {"contiguous": contig_row, "paged": paged_row}
    data["paged_kv"] = {
        k: kv[k]
        for k in ("appends", "gathers", "spilled_pages", "reloaded_pages",
                  "defrag_moves", "peak_pages", "pages_in_use")
    }

    # -- parity: identical traffic => identical token streams -----------
    token_equal = paged_tokens == contig_tokens
    data["parity"] = {"n_requests": n, "token_equal": token_equal}
    assert token_equal, "paged engine diverged from contiguous on identical traffic"
    # every page the load run touched came back (release on completion)
    assert kv["pages_in_use"] == 0 and kv["appends"] > 0 and kv["gathers"] > 0

    # -- spill: tight pool + cold-prefix spill, still token-identical ---
    k_spill = min(len(offers), 10)
    pe = ProgressEngine()
    spill_eng = PagedServeEngine(
        cfg, params, max_len=max_len, progress_engine=pe,
        spill_parked=True, **spill_cfg,
    )
    spill_tokens = _run_direct(spill_eng, offers[:k_spill])
    skv = spill_eng.stats()["kv"]
    pe.stop_all()
    spill_equal = spill_tokens == contig_tokens[:k_spill]
    data["spill"] = {
        "n_requests": k_spill,
        "pool_pages": spill_cfg["pool_pages"],
        "token_equal": spill_equal,
        "spilled_pages": skv["spilled_pages"],
        "reloaded_pages": skv["reloaded_pages"],
    }
    assert spill_equal, "spill/reload path diverged from contiguous"
    assert skv["spilled_pages"] > 0, "tight pool never spilled — config too loose"
    assert skv["reloaded_pages"] == skv["spilled_pages"]

    # -- equal memory: deeper concurrency than max_batch slots ----------
    em_eng = PagedServeEngine(
        cfg, params, max_batch=em["dense"], max_len=max_len,
        page_size=em["page_size"], pool_pages=em["pool_pages"],
    )
    kv_paged = (
        em_eng.kv.token_bytes * em["dense"] * max_len
        + em["pool_pages"] * em_eng.kv.page_bytes
    )
    kv_contig = em_eng.kv.token_bytes * em["contig_slots"] * max_len
    em_offers = _traffic(cfg, seed=7, n=em["n"], prompt_lens=em["prompt_lens"],
                         out_range=em["out_range"])
    t0 = time.monotonic()
    em_tokens = _run_direct(em_eng, em_offers)
    _sync(dev)
    em_wall = time.monotonic() - t0
    n_tok = sum(len(t) for t in em_tokens)
    data["equal_memory"] = {
        "contiguous_slots": em["contig_slots"],
        "paged_dense_slots": em["dense"],
        "pool_pages": em["pool_pages"],
        "kv_bytes_contiguous": int(kv_contig),
        "kv_bytes_paged": int(kv_paged),
        "max_concurrent_paged": int(em_eng.max_concurrent),
        "n_requests": em["n"],
        "wall_s": em_wall,
        "tokens": n_tok,
    }
    assert kv_paged == kv_contig, (kv_paged, kv_contig)
    assert em_eng.max_concurrent > em["contig_slots"], (
        f"paged admission reached only {em_eng.max_concurrent} concurrent "
        f"requests; the contiguous engine already holds {em['contig_slots']}"
    )
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="less traffic, for CI")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH", help="also write the results to PATH")
    args = ap.parse_args(argv)
    data = bench(smoke=args.smoke, device=args.device)
    for kind, row in data["load"].items():
        print(
            f"serving_load/{kind} on {data['device']}: {row['requests_per_s']:.1f} req/s, ttft "
            f"p50={row['p50_ttft_ms']:.1f}ms p99={row['p99_ttft_ms']:.1f}ms "
            f"({row['completed']} reqs, {row['tokens_out']} tokens, peak concurrent {row['max_concurrent']})"
        )
    em = data["equal_memory"]
    print(
        f"parity={data['parity']['token_equal']} spill={data['spill']['spilled_pages']}p "
        f"concurrent={em['max_concurrent_paged']}>{em['contiguous_slots']} slots at {em['kv_bytes_contiguous']} "
        "KV bytes"
    )
    print(json.dumps(data))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(data, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
