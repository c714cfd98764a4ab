"""Serving driver: continuous-batching engine + request-level stats.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke --attn-impl flash
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --no-smoke \
        --attn-impl flash --prompt-lens 128,256,448 --max-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu

``--arch`` takes every architecture (``repro_torch.configs.list_archs``):
the dense, MoE, MLA, local/global and VLM transformers, RWKV-6 and the
Jamba hybrid are served; a VLM on text prompts alone, as the JAX
package's serve CLI serves it. Whisper's encoder-decoder needs audio
frames with each prompt, which ``ServeEngine`` does not take (nor does
the reference's): it raises, pointing at ``models.api``.

Runs on the card by default (``--device cpu`` for the plain path). The
JAX driver's ``--smoke`` flag cannot be switched off; here it is
``--smoke/--no-smoke``. ``--prompt-lens`` sets the prompt lengths the
requests cycle over (default: the JAX driver's 4..10 token prompts).
``--attn-impl flash`` selects the sequence mixer's kernel: for the
transformer and Jamba's attention layers, the flash kernel on prefills
whose length is a multiple of 128; for RWKV-6, the WKV-6 kernel on prefills whose length is a multiple
of 64. Other prefills and every decode step take the plain path.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.progress import ProgressEngine
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--attn-impl", choices=("einsum", "flash"), default=None,
                    help="override the config's sequence-mixer implementation: flash selects the "
                         "flash kernel (transformer, prefill length %% 128 == 0) or the WKV-6 "
                         "kernel (rwkv6, prefill length %% 64 == 0)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prompt-lens", default=None,
                    help="comma-separated prompt lengths to cycle over (default 4+i%%7)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.attn_impl is not None:
        cfg = cfg.replace(attn_impl=args.attn_impl)
    gen = torch.Generator(device=device).manual_seed(0)
    params = api.init_params(cfg, gen, device)
    pe = ProgressEngine()
    eng = ServeEngine(cfg, params, max_batch=args.max_batch, max_len=args.max_len, progress_engine=pe)

    lens = [int(x) for x in args.prompt_lens.split(",")] if args.prompt_lens else None
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    reqs = []
    for i in range(args.requests):
        n = lens[i % len(lens)] if lens else 4 + i % 7
        reqs.append(eng.submit(rng.integers(0, cfg.vocab, (n,)), max_new_tokens=args.max_new))

    steps = 0
    while any(not r.done for r in reqs):
        eng.step()
        steps += 1
    wall = time.perf_counter() - t0
    pe.stop_all()

    toks = sum(len(r.out_tokens) for r in reqs)
    # from the submission of the batch to the engine's stamps (its clock is time.perf_counter)
    lats = [r.t_done - t0 for r in reqs]
    ttfts = [r.t_first - t0 for r in reqs]
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"[serve] arch={args.arch} smoke={args.smoke} attn={cfg.attn_impl} device={where} "
        f"requests={len(reqs)} tokens={toks} steps={steps} wall={wall:.2f}s "
        f"throughput={toks/wall:.1f} tok/s"
    )
    print(
        f"[serve] latency p50={np.percentile(lats,50)*1e3:.0f}ms "
        f"p95={np.percentile(lats,95)*1e3:.0f}ms "
        f"ttft p50={np.percentile(ttfts,50)*1e3:.0f}ms p95={np.percentile(ttfts,95)*1e3:.0f}ms max_batch={args.max_batch} "
        f"(continuous batching over {args.max_batch} "
        f"{ {'rwkv': 'recurrent-state', 'jamba': 'KV + Mamba-state'}.get(api.family(cfg), 'KV')} slots)"
    )


if __name__ == "__main__":
    main()
