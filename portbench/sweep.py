"""The rate sweep that fixes an open-loop cell's arrival rate.

    python3 portbench/sweep.py --workload <cell> --rates 0.5,1,1.5 --seconds 30 --seed <n>

Runs the cell once per rate in this process, the cell's file otherwise as it
stands, and prints for each: the requests offered and finished, the
latency's median, 90th and 95th percentiles, the mean latency of the requests due
in the window's first and second halves (a backlog that grows shows as a
second half far above the first) and how long the drain took after the
close. The highest rate whose backlog does not grow is the knee; the cell's
``rate_per_s`` is set at about four fifths of it. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench.harness import cell as cell_mod
    from portbench.harness.readers import latency_ms, output_tokens_per_s, queue_wait_ms, ttft_ms

    if not torch.cuda.is_available():
        print("sweep: no card", file=sys.stderr)
        return 2
    base = cell_mod.Layout().cell(args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        t0 = time.perf_counter()
        check = {**base["check"], "sample": 1}
        out = cell_mod.run_cell(args.workload, args.seed, args.seconds, False, t_process=t0,
                                overrides={"rate_per_s": rate, "check": check})
        run = out["run"]
        half = run.t_start + args.seconds / 2
        first = [r.t_done - r.due for r in run.offered if r.t_done is not None and r.due < half]
        second = [r.t_done - r.due for r in run.offered if r.t_done is not None and r.due >= half]
        done = [r.t_done for r in run.offered if r.t_done is not None]
        print(json.dumps({
            "rate_per_s": rate, "offered": len(run.offered), "finished": len(done),
            "latency_p50_ms": latency_ms(run, 0.5), "latency_p90_ms": latency_ms(run, 0.9),
            "latency_p95_ms": latency_ms(run, 0.95), "ttft_p95_ms": ttft_ms(run, 0.95), "queue_wait_p50_ms": queue_wait_ms(run, 0.5),
            "first_half_mean_ms": 1e3 * sum(first) / max(1, len(first)),
            "second_half_mean_ms": 1e3 * sum(second) / max(1, len(second)),
            "drain_s": (max(done) - run.t_close) if done else None,
            "output_tok_s": output_tokens_per_s(run), "steps": len(run.steps), "late_s": run.late_s,
            "correct": out["correct"], "seconds": time.perf_counter() - t0}), flush=True)
        del out, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
