"""internlm2-20b [arXiv:2403.17297; hf]
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544."""
from repro_torch.models.config import ModelConfig

ARCH = "internlm2-20b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92544,
        rope_theta=1_000_000.0, grad_accum=8,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=256, remat="none", grad_accum=1,
    )
