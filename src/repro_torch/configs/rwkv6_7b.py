"""rwkv6-7b "Finch" [arXiv:2404.05892; hf]
32L d_model=4096 (attn-free, head_size 64) d_ff=14336 vocab=65536."""
from repro_torch.models.config import ModelConfig

ARCH = "rwkv6-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="ssm_rwkv", n_layers=32, d_model=4096,
        n_heads=64, n_kv_heads=64, head_dim=64, d_ff=14336, vocab=65536,
        grad_accum=8,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab=256, remat="none", grad_accum=1,
    )
