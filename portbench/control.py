"""Readings for the correctness limits: the program and its control, per seed.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 12

Runs the cell once per seed in this one process (set-up, a window at the
cell's own load, the check) and reads, on the same sample of served
requests, the program's gap readings and the control's: the float32
reference with every projection in fp8 (the architecture's
``reference.py``, ``linear="fp8"``), whose first token at each served
position is judged by the float32 reference. Prints one JSON line per seed. A cell's limit lies
between the largest reading of the program over a dozen seeds or more and
the smallest of the control's; ``PERF.md`` keeps the readings. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench.harness import cell as cell_mod

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell_mod.run_cell(args.workload, seed, args.seconds, False, t_process=t0, device=args.device,
                                control=True)
        chk = out["check"]
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "program": chk["readings"], "control": chk["control"],
                          "limits": {k: v[1] for k, v in chk["numbers"].items()},
                          "per_request_gap": chk["per_request_gap"], "sampled": chk["sampled"],
                          "attempted": out["attempted"], "check_s": chk["seconds"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        del out
    return 0


if __name__ == "__main__":
    sys.exit(main())
