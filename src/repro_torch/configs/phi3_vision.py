"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct; hf]
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064; CLIP frontend STUB —
input_specs feeds 576 precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

ARCH = "phi-3-vision-4.2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm", vlm=True, n_img_tokens=576, n_layers=32,
        d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96, d_ff=8192,
        vocab=32064, grad_accum=8,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, n_img_tokens=4, remat="none", grad_accum=1,
    )
