"""whisper-tiny [arXiv:2212.04356; unverified]
4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865; conv frontend STUB
— input_specs feeds 1500 precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

ARCH = "whisper-tiny"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", encdec=True, n_layers=4, n_enc_layers=4,
        d_model=384, n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536,
        vocab=51865, norm="layernorm", qkv_bias=True, n_audio_ctx=1500,
        grad_accum=2,
    )


def smoke() -> ModelConfig:
    return full().replace(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256, n_audio_ctx=16, remat="none",
        grad_accum=1,
    )
