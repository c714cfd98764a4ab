"""End-to-end training on the PyTorch port: train a ~100M-param LM for a few
hundred steps with the full substrate stack (prefetch, async iovec
checkpoints, heartbeat, straggler monitor). The counterpart of
``examples/train_lm.py``, without JAX.

    PYTHONPATH=src python examples/port/train_lm.py --steps 200           # ~100M params, on the card
    PYTHONPATH=src python examples/port/train_lm.py --preset tiny --steps 30 --device cpu

Checkpoints go to ``--ckpt-dir`` (default ``/tmp/repro_torch_train_lm``):
a second run on the same directory resumes after the last saved step. The
two packages' checkpoints are byte-compatible, so the default differs from
the JAX example's, which would otherwise resume this one's run.
"""

import argparse
import statistics

from repro_torch.data.pipeline import DataConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import Trainer
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig


def model_100m() -> ModelConfig:
    # ~105M params: tied 16k vocab emb (12.6M) + 12 layers × 7.7M
    return ModelConfig(
        name="lm-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_ff=2304,
        vocab=16384,
        tie_embeddings=True,
        remat="none",
        grad_accum=1,
    )


def model_tiny() -> ModelConfig:
    return ModelConfig(
        name="lm-tiny", n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
        d_ff=768, vocab=2048, tie_embeddings=True, remat="none",
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="train a ~100M-param LM on the PyTorch port")
    ap.add_argument("--preset", choices=["100m", "tiny"], default="100m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument(
        "--loader-threads", type=int, default=2,
        help="persistent threadcomm loader ranks (0 = thread-per-prefetch)",
    )
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def step_time_line(tr: Trainer, batch: int, seq: int) -> str:
    """The run's steps, and the median host time of a step after the first
    (which pays the allocator's and the kernels' warm-up) with its tokens a
    second."""
    secs = tr.step_seconds[1:] or tr.step_seconds
    ms = statistics.median(secs) * 1e3
    first, last = tr.start_step, tr.start_step + len(tr.step_seconds) - 1
    return (f"[train_lm] steps {first}..{last}: {ms:.4f} ms a step (median after the first), "
            f"{batch * seq / ms * 1e3:.1f} tokens/s")


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)

    cfg = model_100m() if args.preset == "100m" else model_tiny()
    n = cfg.param_counts()["total"]
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps")
    tr = Trainer(
        cfg,
        AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps, clip_norm=1.0),
        DataConfig(batch=args.batch, seq=args.seq, seed=0, loader_threads=args.loader_threads),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=50,
        device=device,
    )
    try:
        tr.maybe_restore()
        hist = tr.run(args.steps, log_every=10)
    finally:
        tr.close()
    print(step_time_line(tr, args.batch, args.seq))
    print(f"[train_lm] loss {hist[0]:.4f} -> {hist[-1]:.4f} over {len(hist)} steps")
    return hist


if __name__ == "__main__":
    main()
