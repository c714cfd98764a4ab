"""The plain reference of the benchmark's configurations, in float32.

One decoder-only transformer forward, written from the configuration file
alone: RMSNorm, rotary embeddings, grouped-query causal attention, a SwiGLU
feed-forward or a dropless top-k mixture of experts, and a tied or untied
output head. No cache, no batching, no kernels: every product is a plain
``torch`` operation in float32 with TF32 off.

Its weights are :func:`draw_weights`' draws from the seed, which the harness
also loads into the program; the reference draws them again itself and
never reads the program's tensors. The weights are drawn in the type they
are served in (bfloat16, the router in float32) and widened to float32 one
layer at a time.

Departures from the published models, shared with the program it checks:

* RMSNorm scales by ``1 + w`` with ``eps`` from the file (the published
  models scale by ``w``; the draws centre ``w`` on 0, so ``1 + w`` plays
  the published weight's part).
* Rotary embeddings rotate split halves at ``rope_theta``, with no
  ``rope_scaling``: phi-3-vision's LongRoPE factors are not applied.
* Granite's embedding, attention, residual and logit multipliers are not
  applied: attention scales by ``1/sqrt(head_dim)``, the residual adds each
  sublayer whole, and the logits are the final state times the tied
  embedding.
* The router's top-k weights are renormalised to sum to 1 over the chosen
  experts, and routing is dropless (every token reaches its k experts).
* Phi-3-vision is served text-only: its image encoder and projection are
  not part of the forward.

``linear="fp8"`` is the control of the correctness check: every projection
(attention, feed-forward, experts, output head; not the router) quantises
its input per row and its weight per output column to float8 e4m3 and
multiplies the dequantised values in float32, as an fp8 GEMM would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Dims", "weight_specs", "draw_weights", "Reference"]

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Dims:
    """The sizes the forward needs, read from a configuration file."""

    def __init__(self, cfg: dict):
        self.d = int(cfg["hidden_size"])
        self.n_layers = int(cfg["num_hidden_layers"])
        self.nq = int(cfg["num_attention_heads"])
        self.nkv = int(cfg["num_key_value_heads"])
        self.hd = int(cfg.get("head_dim") or self.d // self.nq)
        self.d_ff = int(cfg["intermediate_size"])
        self.vocab = int(cfg["vocab_size"])
        self.tied = bool(cfg["tie_word_embeddings"])
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        self.n_experts = int(cfg.get("num_local_experts") or 0)
        self.top_k = int(cfg.get("num_experts_per_tok") or 0)
        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["torch_dtype"]]

    @property
    def moe(self) -> bool:
        return self.n_experts > 0


def weight_specs(dims: Dims) -> List[Tuple[str, tuple, torch.dtype, float]]:
    """Every weight as ``(name, shape, dtype, scale)``, stacked over layers,
    in the order :func:`draw_weights` draws them. Projections are drawn at
    ``1/sqrt(fan_in)``, the embedding at 0.02 and the norm weights (used as
    ``1 + w``) at 0.1."""
    L, d, q, kv = dims.n_layers, dims.d, dims.nq * dims.hd, dims.nkv * dims.hd
    dt = dims.dtype
    specs = [("tok", (dims.vocab, d), dt, 0.02)]
    if not dims.tied:
        specs.append(("out", (d, dims.vocab), dt, d ** -0.5))
    specs += [
        ("final_norm", (d,), dt, 0.1),
        ("ln1", (L, d), dt, 0.1),
        ("ln2", (L, d), dt, 0.1),
        ("wq", (L, d, q), dt, d ** -0.5),
        ("wk", (L, d, kv), dt, d ** -0.5),
        ("wv", (L, d, kv), dt, d ** -0.5),
        ("wo", (L, q, d), dt, q ** -0.5),
    ]
    if dims.moe:
        E, f = dims.n_experts, dims.d_ff
        specs += [
            ("router", (L, d, E), torch.float32, d ** -0.5),
            ("we_gate", (L, E, d, f), dt, d ** -0.5),
            ("we_up", (L, E, d, f), dt, d ** -0.5),
            ("we_down", (L, E, f, d), dt, f ** -0.5),
        ]
    else:
        f = dims.d_ff
        specs += [
            ("w_gate", (L, d, f), dt, d ** -0.5),
            ("w_up", (L, d, f), dt, d ** -0.5),
            ("w_down", (L, f, d), dt, f ** -0.5),
        ]
    return specs


@torch.no_grad()
def draw_weights(dims: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    """All weights from ``seed``: one normal draw per stacked leaf, on
    ``device`` with a generator there, in the leaf's served dtype, scaled
    in place. The same seed on the same kind of device gives the same
    tensors."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, shape, dtype, scale in weight_specs(dims):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        out[name] = t.mul_(scale)
    return out


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def _rope(x, positions, theta):
    """x (S, n, hd); rotate the split halves by ``positions`` (S,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = positions.float()[:, None] * freqs  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _fp8(t, dim):
    """``t`` rounded through float8 e4m3 with one scale per slice along
    ``dim`` (its absolute maximum maps to the format's largest value)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The float32 forward over one sequence, layer by layer.

    ``weights`` is :func:`draw_weights`' dict (any dtype: each layer's
    slices are widened to float32 when used). ``linear`` is ``"fp32"`` or
    ``"fp8"`` (the control, see the module docstring)."""

    def __init__(self, dims: Dims, weights: Dict[str, torch.Tensor], linear: str = "fp32",
                 query_block: int = 1024):
        if linear not in ("fp32", "fp8"):
            raise ValueError(f"linear must be 'fp32' or 'fp8', got {linear!r}")
        self.dims, self.w, self.linear, self.query_block = dims, weights, linear, query_block

    def _mm(self, x, w):
        w = w.float()
        if self.linear == "fp8":
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def _attention(self, x, layer, positions):
        dm, w = self.dims, self.w
        S = x.shape[0]
        q = self._mm(x, w["wq"][layer]).view(S, dm.nq, dm.hd)
        k = self._mm(x, w["wk"][layer]).view(S, dm.nkv, dm.hd)
        v = self._mm(x, w["wv"][layer]).view(S, dm.nkv, dm.hd)
        q, k = _rope(q, positions, dm.theta), _rope(k, positions, dm.theta)
        group = dm.nq // dm.nkv
        k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # (nq, S, hd)
        v = v.repeat_interleave(group, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(dm.hd)
        for a in range(0, S, self.query_block):
            b = min(S, a + self.query_block)
            s = (q[:, a:b] @ k[:, :b].transpose(1, 2)) * scale  # (nq, b-a, b)
            causal = torch.arange(b, device=x.device)[None, :] <= torch.arange(a, b, device=x.device)[:, None]
            s = s.masked_fill(~causal, float("-inf"))
            out[:, a:b] = torch.softmax(s, dim=-1) @ v[:, :b]
        return self._mm(out.transpose(0, 1).reshape(S, dm.nq * dm.hd), w["wo"][layer])

    def _swiglu(self, x, gate, up, down):
        return self._mm(F.silu(self._mm(x, gate)) * self._mm(x, up), down)

    def _ffn(self, x, layer):
        dm, w = self.dims, self.w
        if not dm.moe:
            return self._swiglu(x, w["w_gate"][layer], w["w_up"][layer], w["w_down"][layer])
        probs = torch.softmax(x @ w["router"][layer].float(), dim=-1)
        topv, topi = torch.topk(probs, dm.top_k, dim=-1)
        gates = topv / topv.sum(-1, keepdim=True)
        # every (token, choice) pair grouped by expert: one host read a layer
        order = torch.argsort(topi.reshape(-1), stable=True)
        rows = order // dm.top_k
        counts = torch.bincount(topi.reshape(-1), minlength=dm.n_experts).tolist()
        xs, ys, a = x[rows], [], 0
        for e, c in enumerate(counts):
            if c:
                ys.append(self._swiglu(xs[a:a + c], w["we_gate"][layer, e], w["we_up"][layer, e],
                                       w["we_down"][layer, e]))
            a += c
        y = torch.cat(ys) * gates.reshape(-1)[order, None]
        return torch.zeros_like(x).index_add_(0, rows, y)

    @torch.no_grad()
    def logits(self, tokens: Sequence[int], at: Sequence[int]) -> torch.Tensor:
        """float32 logits ``(len(at), vocab)`` of the full causal forward
        over ``tokens`` at the positions ``at``."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            dm, w = self.dims, self.w
            dev = w["tok"].device
            ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
            positions = torch.arange(ids.numel(), device=dev)
            x = w["tok"][ids].float()
            for layer in range(dm.n_layers):
                x = x + self._attention(_rms(x, w["ln1"][layer].float(), dm.eps), layer, positions)
                x = x + self._ffn(_rms(x, w["ln2"][layer].float(), dm.eps), layer)
            h = _rms(x[torch.as_tensor(list(at), dtype=torch.long, device=dev)], w["final_norm"].float(), dm.eps)
            head = w["tok"].t() if dm.tied else w["out"]
            return self._mm(h, head)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
