"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device this process cannot
    use: asking for the card without one raises, it never falls back.
    ``"meta"`` gives shapes and dtypes with no storage, the port's
    counterpart of ``jax.eval_shape``: a model, cache or mesh of any size
    built there allocates nothing."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: the port runs on 'cuda' or 'cpu' (shapes only: 'meta')")
    return dev
