"""gemma3-4b [hf:google/gemma-3-*; unverified]
34L d_model=2560 8H (GQA kv=4, head_dim 256) d_ff=10240 vocab=262144,
5 local (sliding 1024, theta 1e4) : 1 global (theta 1e6)."""
from repro_torch.models.config import ModelConfig

ARCH = "gemma3-4b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=34, d_model=2560, n_heads=8,
        n_kv_heads=4, head_dim=256, d_ff=10240, vocab=262144,
        local_global_pattern=5, sliding_window=1024,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        tie_embeddings=True, grad_accum=8,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, sliding_window=8, remat="none", grad_accum=1,
    )
