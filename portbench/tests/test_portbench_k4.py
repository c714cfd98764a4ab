"""``k4_roofline.longgen`` on synthetic traced records: the K/V positions in
use at the memory's peak over the device time of every kernel named
``decode_attention`` (the chunk merge included), and nothing read without a
trace or without such a kernel (a program without K4)."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.architectures.gqa.counts import Model
from portbench.harness import readers
from portbench.harness.counts import PEAK
from portbench.harness.engine import StepRecord
from portbench.harness.trace import reduce_trace

PB = Path(__file__).resolve().parents[1]
MS = 1_000_000


def _reader():
    path = PB / "metrics" / "k4_roofline.longgen.py"
    spec = importlib.util.spec_from_file_location("k4_roofline_longgen", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(events, positions):
    cfg = json.loads((PB / "configs" / "phi-3-vision-4.2b.json").read_text())
    steps = [StepRecord(0.0, 0.03, decoded=len(p), decode_positions=p) for p in positions]
    return SimpleNamespace(cfg=cfg, model=Model(cfg), trace=reduce_trace(events), trace_steps=steps, steps=steps)


def _events(k4_ms):
    ev = [("pb.window", False, 0, 100 * MS), ("pb.step", False, 0, 90 * MS),
          ("ampere_bf16_s16816gemm_bf16_128x64", True, 1 * MS, 4 * MS)]
    t = 10 * MS
    for name, ms in k4_ms:
        ev.append((name, True, t, t + int(ms * MS)))
        t += int(ms * MS) + MS
    return ev


def test_share_is_positions_in_use_at_peak_over_k4_time():
    positions = [[2000] * 32, [2001] * 32]
    k4 = [("void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16, 96>(...)", 12.0),
          ("void (anonymous namespace)::decode_attention_combine_kernel<__nv_bfloat16>(...)", 0.5)]
    run = _run(_events(k4), positions)
    nbytes = sum(map(sum, positions)) * run.model.kv_bytes_per_position
    assert run.model.kv_bytes_per_position == 2 * 32 * 32 * 96 * 2  # K and V, 32 layers, bf16
    want = 100.0 * nbytes / PEAK["hbm_bytes_per_s"] / 0.0125
    assert _reader()(run) == pytest.approx(want)
    assert readers.kernel_launches_per_step(run, "decode_attention") == 1.0  # two launches, two steps


@pytest.mark.parametrize("case", ["untraced", "no_k4", "no_decode"])
def test_reads_nothing_without_k4_or_decode(case):
    k4 = [("void (anonymous namespace)::decode_attention_kernel<__nv_bfloat16, 96>(...)", 12.0)]
    if case == "no_k4":  # the parent's decode: whole-cache copies, no K4
        k4 = [("void at::native::elementwise_kernel<128, 4>(direct_copy_kernel_cuda)", 60.0)]
    run = _run(_events(k4), [] if case == "no_decode" else [[2000] * 32])
    if case == "untraced":
        run.trace = None
    assert _reader()(run) is None
