"""Batched serving with continuous batching over a slotted KV cache, on the
PyTorch port. The counterpart of ``examples/serve_lm.py``, without JAX.

    PYTHONPATH=src python examples/port/serve_lm.py --arch qwen1.5-0.5b                # on the card
    PYTHONPATH=src python examples/port/serve_lm.py --arch qwen1.5-0.5b --device cpu   # anywhere
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.engine import ServeEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="continuous batching on the PyTorch port")
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def serve(cfg, params, args):
    """Submit ``args.requests`` seeded prompts of 4 + i % 5 tokens, step the
    engine until every request is done, and return the requests."""
    engine = ServeEngine(cfg, params, max_batch=args.max_batch, max_len=128)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    reqs = [
        engine.submit(rng.integers(0, cfg.vocab, (4 + i % 5,)), max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]
    steps = 0
    while any(not r.done for r in reqs):
        engine.step()
        steps += 1
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {toks} tokens in {steps} engine steps ({dt:.1f}s)")
    for r in reqs[:3]:
        print(f"[serve] req{r.rid}: prompt={list(r.prompt[:4])}… out={r.out_tokens}")
    assert all(len(r.out_tokens) == args.max_new for r in reqs)
    return reqs


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = api.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    reqs = serve(cfg, params, args)
    print("OK")
    return reqs


if __name__ == "__main__":
    main()
