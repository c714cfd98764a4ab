"""The harness end to end at smoke size on the CPU, through the kernels'
plain versions: each cell's kind of run is correct, its metrics read, and
every fault that kind of cell can have breaks the timed path underneath and
turns ``correct`` false. The look for a card is the command's (``run.py``),
which these tests skip; they drive the rest of a run."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.architectures.gqa import program
from portbench.architectures.gqa.reference import Dims, draw_weights
from portbench.harness import cell as cell_mod
from portbench.tests.faults import faulty_engine_class

PB = Path(__file__).resolve().parents[1]
DATA = PB / "tests" / "data"
BENCH = json.loads((PB.parent / "BENCHMARK.json").read_text())
#: each smoke cell and the benchmark cell whose kind of run it stands for
SMOKE = {"smoke-docqa-paged": "phi3-docqa-paged", "smoke-score": "granite-score", "smoke-longgen": "phi3-longgen"}
#: the faults each kind of cell can have (one chip: no exchange between chips)
FAULTS = {
    "smoke-docqa-paged": ("token", "half_prompt", "stale_state", "half_batch", "page_rows"),
    "smoke-longgen": ("token", "half_prompt", "stale_state", "half_batch"),
    "smoke-score": ("token", "half_prompt"),
}


def run(name, seed=2**31 + 5, fault=None, control=False, seconds=2.0):
    kw = {} if fault is None else {"engine_class": faulty_engine_class(fault)}
    return cell_mod.run_cell(name, seed, seconds, False, t_process=time.perf_counter(), device="cpu",
                             layout=cell_mod.Layout(DATA), control=control, **kw)


def _metric_names(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    per = [m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    return e2e, per


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_cell_runs_correct_and_reads_its_metrics(name):
    out = run(name)
    assert out["correct"], out["check"]["numbers"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["check"]["sampled"] > 0 and out["check"]["tokens_compared"] > 0
    e2e, per = _metric_names(SMOKE[name])
    values = cell_mod.metric_values(out["run"], e2e + per, PB / "metrics")
    for m in e2e:
        assert values[m] > 0, m  # every end-to-end metric reads, and none is 0
    # without a device trace the trace's metrics are left out, never 0
    for m in per:
        if any(k in m for k in ("roofline", "idle_share", "launches")):
            assert m not in values


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in sorted(FAULTS.items()) for f in fs])
def test_a_broken_timed_path_is_not_correct(name, fault):
    out = run(name, fault=fault)
    assert not out["correct"], (fault, out["check"]["numbers"])


def test_closed_loop_cuts_at_the_close_and_checks_what_was_served():
    out = run("smoke-longgen")
    r = out["run"]
    cut = [x for x in r.offered + r.held if x.cut]
    assert cut and all(x.req.out_tokens for x in cut if x.t_first is not None)
    assert all(s.t0 < r.t_close for s in r.steps)


def test_weights_are_the_seeds_and_the_program_holds_them():
    cfg = json.loads((DATA / "configs" / "granite-smoke.json").read_text())
    dims = Dims(cfg)
    a, b = draw_weights(dims, 2**31 + 9, "cpu"), draw_weights(dims, 2**31 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], draw_weights(dims, 3, "cpu")["wq"])
    model = program.build_model(program.model_config(cfg), a, "cpu")
    params = dict(model.named_parameters())
    assert torch.equal(params["groups.0.1.ffn.we_up"], a["we_up"][1])
    assert torch.equal(params["embed.tok"], a["tok"])
    assert params["groups.0.0.ffn.router"].dtype == torch.float32


def test_the_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "granite-score", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
                       cwd=PB.parent)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_the_jax_check_names_what_it_finds(monkeypatch):
    sys.path.insert(0, str(PB))
    try:
        import run as run_mod
    finally:
        sys.path.remove(str(PB))
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "repro.models", object())
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert run_mod.forbidden_modules() == ["jaxlib", "repro"]
