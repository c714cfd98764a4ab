"""llama3-405b [arXiv:2407.21783; unverified]
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
from repro_torch.models.config import ModelConfig

ARCH = "llama3-405b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=126, d_model=16384, n_heads=128,
        n_kv_heads=8, head_dim=128, d_ff=53248, vocab=128256,
        rope_theta=500_000.0, grad_accum=16,
        accum_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, remat="none", grad_accum=1,
    )
