"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE 32e top-8, d_expert=512."""
from repro_torch.models.config import ModelConfig, MoEConfig

ARCH = "granite-moe-1b-a400m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=8, head_dim=64, d_ff=512, vocab=49155, tie_embeddings=True,
        moe=MoEConfig(n_experts=32, top_k=8, d_expert=512), grad_accum=4,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32,
        vocab=256, moe=MoEConfig(n_experts=4, top_k=2, d_expert=32),
        remat="none", grad_accum=1,
    )
