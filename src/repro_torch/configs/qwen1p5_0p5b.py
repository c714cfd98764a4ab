"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B; hf]
24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936, QKV bias."""
from repro_torch.models.config import ModelConfig

ARCH = "qwen1.5-0.5b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, head_dim=64, d_ff=2816, vocab=151936, qkv_bias=True,
        tie_embeddings=True, grad_accum=2,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, remat="none", grad_accum=1,
    )
