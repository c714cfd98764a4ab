"""jamba-v0.1-52b [arXiv:2403.19887; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=14336, Mamba:attn 7:1 (period 8,
attn at pos 4), MoE 16e top-2 every 2nd layer, vocab=65536."""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

ARCH = "jamba-v0.1-52b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=65536,
        hybrid_period=8, hybrid_attn_pos=4, hybrid_moe_every=2,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2), grad_accum=16,
        accum_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
        remat="none", grad_accum=1,
    )
