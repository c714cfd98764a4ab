"""The benchmark's FLOP and byte counts against hand reckonings of both
configurations, written out from the published sizes."""

import json
from pathlib import Path

import pytest

from portbench.architectures.gqa.counts import Model
from portbench.harness.counts import attention_cost, roofline_s

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def model(name):
    return Model(json.loads((CONFIGS / f"{name}.json").read_text()))


def test_phi3_parameters_and_kv():
    m = model("phi-3-vision-4.2b")
    # q, k, v, o: 4 · 3072²; SwiGLU: 3 · 3072 · 8192
    assert m.attn_params == 4 * 3072 * 3072 == 37_748_736
    assert m.ffn_active_params == m.ffn_params == 3 * 3072 * 8192 == 75_497_472
    total = 32 * (37_748_736 + 75_497_472) + 2 * 32064 * 3072 + (2 * 32 + 1) * 3072
    assert total == 3_821_079_552  # 3.82B in the language model
    assert m.kv_bytes_per_position == 2 * 32 * 32 * 96 * 2 == 384 * 1024


def test_granite_parameters_and_kv():
    m = model("granite-moe-1b-a400m")
    assert m.attn_params == 1024 * 64 * (2 * 16 + 2 * 8) == 3_145_728
    # the router and 8 of 32 experts of width 512
    assert m.ffn_active_params == 1024 * 32 + 8 * 3 * 1024 * 512 == 12_615_680
    total = 24 * (3_145_728 + 1024 * 32 + 32 * 3 * 1024 * 512) + 49155 * 1024 + (2 * 24 + 1) * 1024
    assert total == 1_334_628_352  # the port's own count of the whole model
    assert m.kv_bytes_per_position == 2 * 24 * 8 * 64 * 2 == 49_152


@pytest.mark.parametrize("name,S", [("phi-3-vision-4.2b", 2048), ("granite-moe-1b-a400m", 3968)])
def test_prefill_flops_by_hand(name, S):
    m = model(name)
    if name.startswith("phi"):
        per_token = 2 * 32 * (37_748_736 + 75_497_472)
        attn = 32 * 2 * 2 * 32 * 96 * S * (S + 1) // 2
        head = 2 * 3072 * 32064
    else:
        per_token = 2 * 24 * (3_145_728 + 12_615_680)
        attn = 24 * 2 * 2 * 16 * 64 * S * (S + 1) // 2
        head = 2 * 1024 * 49155
    assert m.prefill_flops(S) == S * per_token + attn + head


def test_decode_flops_and_bytes_by_hand():
    m = model("phi-3-vision-4.2b")
    positions = [100, 4000]
    per_token = 2 * 32 * (37_748_736 + 75_497_472) + 2 * 3072 * 32064
    attn = sum(32 * 2 * 2 * 32 * 96 * n for n in positions)
    assert m.decode_flops(positions) == 2 * per_token + attn
    weights = 32 * (37_748_736 + 75_497_472) + (2 * 32 + 1) * 3072 + 3072 * 32064 + 2 * 3072
    kv = (100 + 4000) * 393_216 + 2 * 393_216
    assert m.decode_bytes(positions) == 2 * weights + kv
    assert m.decode_bytes([]) == 0


def test_attention_cost_and_roofline():
    c = attention_cost(2048, 32, 32, 96)
    assert c["flops"] == 4 * 32 * 96 * 2048 * 2049 // 2
    assert c["bytes"] == 2 * 2048 * 96 * (2 * 32 + 2 * 32)
    # 2048 positions at hd 96: bound by the operations
    assert roofline_s(c["flops"], c["bytes"]) == pytest.approx(c["flops"] / 989e12)
    small = attention_cost(128, 16, 8, 64)
    assert roofline_s(small["flops"], small["bytes"]) == max(small["flops"] / 989e12, small["bytes"] / 3.35e12)


def test_page_move_bytes():
    m = model("phi-3-vision-4.2b")
    # a pack and an unpack, each reading and writing the span once
    assert m.page_move_bytes(16) == 4 * 16 * 393_216
