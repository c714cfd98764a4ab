"""The control of the correctness check: the reference in fp8 in the
program's place must come out as not correct. At smoke size on the CPU
here; at each cell's own size on the card (``card`` marker)."""

import time
from pathlib import Path

import pytest

from portbench.harness import cell as cell_mod

PB = Path(__file__).resolve().parents[1]
DATA = PB / "tests" / "data"

#: seeds at smoke size on which the fp8 control's reading is known, per cell
SMOKE_SEEDS = {"smoke-docqa-paged": (2, 3, 5), "smoke-longgen": (1, 3, 6), "smoke-score": (1, 2, 6)}


def _readings(name, seed, layout, device, seconds):
    out = cell_mod.run_cell(name, seed, seconds, False, t_process=time.perf_counter(), device=device,
                            layout=layout, control=True)
    chk = out["check"]
    limits = {k: v[1] for k, v in chk["numbers"].items() if k in chk["readings"]}
    return out, chk, limits


@pytest.mark.parametrize("name,seed", [(n, s) for n, ss in sorted(SMOKE_SEEDS.items()) for s in ss])
def test_control_fails_at_smoke_size(name, seed):
    out, chk, limits = _readings(name, seed, cell_mod.Layout(DATA), "cpu", 2.0)
    assert out["correct"], chk["numbers"]  # the program in bf16 passes
    assert any(chk["control"][k] > lim for k, lim in limits.items()), (chk["control"], limits)


#: the benchmark's cells with the window the control readings used
CELLS = {"phi3-docqa-paged": 12.0, "granite-score": 8.0, "phi3-longgen": 40.0}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_at_cell_size(card, name):
    for seed in (11, 12, 13):
        out, chk, limits = _readings(name, seed, cell_mod.Layout(), "cuda", CELLS[name])
        assert out["correct"], chk["numbers"]
        assert any(chk["control"][k] > lim for k, lim in limits.items()), (seed, chk["control"], limits)
