"""deepseek-v3-671b [arXiv:2412.19437; hf]
61L d_model=7168 128H, MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 /
v 128), MoE 1 shared + 256 routed top-8 d_expert=2048, first 3 layers dense
(d_ff 18432), vocab=129280, MTP depth 1."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

ARCH = "deepseek-v3-671b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="mla_moe", n_layers=61, d_model=7168, n_heads=128,
        n_kv_heads=128, d_ff=2048, vocab=129280,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      first_k_dense=3, dense_d_ff=18432),
        mtp_depth=1, grad_accum=16, accum_dtype="bfloat16",
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32, vocab=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32, n_shared=1,
                      first_k_dense=1, dense_d_ff=64),
        mtp_depth=1, remat="none", grad_accum=1,
    )
