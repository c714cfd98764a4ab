"""The benchmark's count of one GQA transformer: its parameters, the
operations and bytes of a prefill, a decode step and a page move, from the
configuration file's sizes alone (see ``portbench/harness/counts.py`` for
what a count must and must not hold)."""

from __future__ import annotations

from typing import Iterable

from portbench.harness.counts import attention_cost

__all__ = ["Model"]


class Model:
    """Counts for one configuration file (a dict)."""

    def __init__(self, cfg: dict):
        self.d = int(cfg["hidden_size"])
        self.L = int(cfg["num_hidden_layers"])
        self.nq = int(cfg["num_attention_heads"])
        self.nkv = int(cfg["num_key_value_heads"])
        self.hd = int(cfg.get("head_dim") or self.d // self.nq)
        self.d_ff = int(cfg["intermediate_size"])
        self.vocab = int(cfg["vocab_size"])
        self.E = int(cfg.get("num_local_experts") or 0)
        self.k = int(cfg.get("num_experts_per_tok") or 0)
        self.elem = {"bfloat16": 2, "float32": 4}[cfg["torch_dtype"]]

    # -- parameters ---------------------------------------------------------
    @property
    def attn_params(self) -> int:
        """q, k, v and output projections of one layer."""
        return self.d * self.hd * (2 * self.nq + 2 * self.nkv)

    @property
    def ffn_active_params(self) -> int:
        """The feed-forward weights one token multiplies through in one
        layer: the router and its ``k`` experts, or the dense SwiGLU."""
        if self.E:
            return self.d * self.E + self.k * 3 * self.d * self.d_ff
        return 3 * self.d * self.d_ff

    @property
    def ffn_params(self) -> int:
        if self.E:
            return self.d * self.E + self.E * 3 * self.d * self.d_ff
        return 3 * self.d * self.d_ff

    @property
    def head_params(self) -> int:
        return self.d * self.vocab

    @property
    def kv_bytes_per_position(self) -> int:
        """K and V of one position over every layer."""
        return 2 * self.L * self.nkv * self.hd * self.elem

    # -- FLOPs ----------------------------------------------------------------
    def prefill_flops(self, S: int) -> int:
        """A prompt of ``S`` tokens: every layer's projections and active
        feed-forward for each token, causal attention, and the output head
        at the last position (the only logits a prefill needs)."""
        per_token = 2 * self.L * (self.attn_params + self.ffn_active_params)
        attn = self.L * attention_cost(S, self.nq, self.nkv, self.hd)["flops"]
        return S * per_token + attn + 2 * self.head_params

    def decode_flops(self, positions: Iterable[int]) -> int:
        """One decode step; ``positions`` the cache length of each decoded
        slot after the step (the new token attends to that many)."""
        total = 0
        per_token = 2 * self.L * (self.attn_params + self.ffn_active_params) + 2 * self.head_params
        for n in positions:
            total += per_token + self.L * 2 * 2 * self.nq * self.hd * n
        return total

    # -- bytes ------------------------------------------------------------------
    def decode_bytes(self, positions: Iterable[int]) -> int:
        """One decode step over the slots whose cache lengths after the step
        are ``positions``: every weight it multiplies through read once
        (embedding rows apart: a row per token), the K/V positions in use
        read once and the new row written once."""
        positions = list(positions)
        B = len(positions)
        if not B:
            return 0
        norms = (2 * self.L + 1) * self.d
        if self.E:
            # which experts a step's tokens choose is not observed here: count
            # the fewest a step can need, the k experts of one token
            ffn = self.L * (self.k * 3 * self.d * self.d_ff + self.d * self.E)
        else:
            ffn = self.L * self.ffn_params
        weights = self.L * self.attn_params + ffn + norms + self.head_params + B * self.d
        kv = sum(positions) * self.kv_bytes_per_position
        return weights * self.elem + kv + B * self.kv_bytes_per_position

    def page_move_bytes(self, tokens: int) -> int:
        """K1 bytes of moving ``tokens`` positions between the cache and the
        pages: a pack kernel reads the span and writes the packed buffer, an
        unpack kernel reads that and writes the destination, each once."""
        return 4 * tokens * self.kv_bytes_per_position
