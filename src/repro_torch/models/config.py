"""Model configuration schema shared by the whole zoo.

One :class:`ModelConfig` describes any of the 10 assigned architectures
(dense / MoE / MLA / local-global / VLM / SSM / hybrid / enc-dec). Arch
files in :mod:`repro_torch.configs` instantiate it with the exact
published numbers plus a reduced ``smoke()`` variant for CPU tests. The
schema is the JAX package's, field for field; only the dtype properties
map the dtype names to torch dtypes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name used in :class:`ModelConfig`."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}; known: {sorted(_TORCH_DTYPES)}") from None


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert FFN hidden
    n_shared: int = 0            # always-on shared experts (DeepSeek)
    d_shared: int = 0            # shared-expert hidden (defaults to d_expert)
    # Expert capacity at TRAIN time: C = N·top_k·capacity_factor / n_experts
    # (tokens past an expert's capacity are dropped — the standard
    # static-shape efficiency trade, kept rare by the aux balance loss).
    capacity_factor: float = 1.25
    # Expert capacity at EVAL time (forward/prefill/decode). None = dropless:
    # capacity covers the worst-case per-expert load so a token's output
    # never depends on which other tokens share the batch — the invariant
    # that makes decode-from-cache match the full forward exactly.
    eval_capacity_factor: Optional[float] = None
    router_aux_weight: float = 0.01
    first_k_dense: int = 0       # leading dense layers (DeepSeek: 3)
    dense_d_ff: int = 0          # FFN width of those dense layers

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 block (Jamba) / RWKV6 sizing."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model/16)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class ModelConfig:
    # identity ---------------------------------------------------------
    name: str = "model"
    family: str = "dense"  # dense | moe | mla_moe | vlm | ssm_rwkv | hybrid | encdec
    # backbone ---------------------------------------------------------
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0              # 0 → d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    tie_embeddings: bool = False
    # local/global attention (Gemma-3) ----------------------------------
    local_global_pattern: int = 0  # k → k local layers per 1 global
    sliding_window: int = 1024
    # MoE / MLA / SSM ----------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Jamba): period & which position inside the period is attention
    hybrid_period: int = 0         # 8 for Jamba
    hybrid_attn_pos: int = 4
    hybrid_moe_every: int = 2      # MoE at odd positions
    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3
    # enc-dec (Whisper) ---------------------------------------------------
    encdec: bool = False
    n_enc_layers: int = 0
    n_audio_ctx: int = 1500
    # VLM (Phi-3-vision) --------------------------------------------------
    vlm: bool = False
    n_img_tokens: int = 0
    # numerics ------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logit_dtype: str = "float32"
    # training-time knobs (shape-independent) ------------------------------
    remat: str = "full"            # none | full | dots | save_acts
    scan_layers: bool = True
    grad_accum: int = 1            # microbatch accumulation factor
    accum_dtype: str = "float32"   # grad-accumulator dtype (bf16 for giants)
    fsdp: bool = False             # shard params over the DP axes too (ZeRO-3)
    # ---- hillclimb knobs (§Perf; defaults = paper-faithful baseline) ----
    tp_strategy: str = "full"      # full | ep_only (replicate dense, EP experts)
    seq_shard_acts: bool = False   # sequence-parallel activation constraints
    moe_dispatch_sharding: bool = False  # constrain (E,C,d) dispatch tensors
    moe_scatter_combine: bool = False    # 1 scatter-add instead of k gathers
    attn_impl: str = "einsum"      # einsum | flash (CUDA kernel on the card,
    #                                its plain version on CPU — full-seq
    #                                causal self-attention paths, and the
    #                                RWKV-6 WKV in prefills of S % 64 == 0)
    fsdp_gather_layers: bool = False  # explicit per-layer weight gather to
    #                                TP-only layout inside the scan (fixes
    #                                GSPMD's partial-AR choice under fsdp)

    # -- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def ldtype(self) -> torch.dtype:
        """The torch dtype of ``logit_dtype``."""
        return torch_dtype(self.logit_dtype)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm_rwkv"

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic memory at 500k decode: SSM/hybrid/local-global."""
        return self.family in ("ssm_rwkv", "hybrid") or self.local_global_pattern > 0

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for MODEL_FLOPS = 6·N·D) -------------------------
    def param_counts(self) -> dict:
        """Returns {'total': .., 'active': ..} parameter counts (embedding
        included in total, excluded from per-token matmul FLOPs by the
        standard 6ND convention is a wash — we count all matmul params)."""
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)

        def attn_params():
            if self.mla is not None:
                m = self.mla
                q = d * m.q_lora_rank + m.q_lora_rank * nq * m.qk_head_dim
                kv = d * (m.kv_lora_rank + m.qk_rope_head_dim) + m.kv_lora_rank * nq * (
                    m.qk_nope_head_dim + m.v_head_dim
                )
                o = nq * m.v_head_dim * d
                return q + kv + o
            qkv = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
            if self.qkv_bias:
                qkv += (nq + 2 * nkv) * hd
            return qkv

        def mlp_params(width):
            return 3 * d * width  # SwiGLU gate/up/down

        def moe_layer_params():
            m = self.moe
            routed = m.n_experts * 3 * d * m.d_expert
            shared = m.n_shared * 3 * d * (m.d_shared or m.d_expert)
            router = d * m.n_experts
            return routed + shared + router

        def moe_layer_active():
            m = self.moe
            routed = m.top_k * 3 * d * m.d_expert
            shared = m.n_shared * 3 * d * (m.d_shared or m.d_expert)
            return routed + shared + d * m.n_experts

        def ssm_params():
            s = self.ssm
            di = s.d_inner(d)
            dtr = s.resolved_dt_rank(d)
            return d * 2 * di + di * s.d_conv + di * (dtr + 2 * s.d_state) + dtr * di + di * d + di * s.d_state

        def rwkv_params():
            # time-mix: r,k,v,g,o (5·d²) + maa/decay loras; channel-mix:
            # k (d→ff), v (ff→d), r (d→d)
            lora = d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * d
            return 5 * d * d + lora + 2 * d * self.d_ff + d * d

        total = active = emb
        if self.family == "ssm_rwkv":
            per = rwkv_params()
            total += self.n_layers * per
            active = total
        elif self.family == "hybrid":
            period, attn_pos = self.hybrid_period, self.hybrid_attn_pos
            for i in range(self.n_layers):
                mixer = attn_params() if (i % period) == attn_pos else ssm_params()
                is_moe = self.moe.enabled and (i % self.hybrid_moe_every == 1)
                total += mixer + (moe_layer_params() if is_moe else mlp_params(self.d_ff))
                active += mixer + (moe_layer_active() if is_moe else mlp_params(self.d_ff))
        else:
            for i in range(self.n_layers):
                is_dense = (not self.moe.enabled) or i < self.moe.first_k_dense
                width = self.moe.dense_d_ff or self.d_ff if is_dense else self.d_ff
                ffn_t = mlp_params(width) if is_dense else moe_layer_params()
                ffn_a = mlp_params(width) if is_dense else moe_layer_active()
                total += attn_params() + ffn_t
                active += attn_params() + ffn_a
            if self.encdec:
                # encoder self-attn + MLP + decoder cross-attn
                total += self.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
                total += self.n_layers * attn_params()
                active = total
            if self.mtp_depth:
                total += self.mtp_depth * (attn_params() + moe_layer_params() + 2 * d * d)
                active += self.mtp_depth * (attn_params() + moe_layer_active() + 2 * d * d)
        if self.family in ("dense", "vlm"):
            active = total
        return {"total": int(total), "active": int(active)}
