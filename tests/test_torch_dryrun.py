"""The port's dry run and hillclimb (``repro_torch.launch.{dryrun,hillclimb}``)
on the meta device, against the JAX package's.

``lower_cell`` runs the smoke configs on a ``(2, 2)`` meta mesh (the
production mesh is monkeypatched; 256 thread-ranks are the command line's
business, not a test's): its row has the reference's keys, its argument
bytes equal a reckoning from the port's specs, its collectives are
counted, a train cell of every family counts the sharded step, a prefill
and a decode cell count the sharded serve steps, and a train cell under
either layout hint counts its step too: no row is null. ``run_cells``'
skips follow the reference's
applicability, and every hillclimb variant sets the same config fields on
the port's config as on the reference's. All exact.
"""

import dataclasses
import math
import os

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import registry as jreg  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.mesh import NamedSharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as lmesh  # noqa: E402
from repro_torch.launch.hillclimb import VARIANTS  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

#: the row keys of the reference's lower_cell (src/repro/launch/dryrun.py:139-160)
ROW_KEYS = {"arch", "variant", "shape", "mesh", "multi_pod", "n_chips", "lower_s", "compile_s", "memory",
            "collectives", "roofline", "xla_cost_raw"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes_per_device"}


@pytest.fixture
def small(monkeypatch):
    """The smoke configs on a (2, 2) meta mesh (a train cell's step on its
    folded twin)."""
    mesh = lmesh.make_host_mesh((2, 2), device="meta")
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod=False, fold=():
                        lmesh.make_host_mesh((2, 2), device="meta", fold=fold) if fold else mesh)
    monkeypatch.setattr(treg, "get_config", lambda arch, smoke=False, get=treg.get_config: get(arch, smoke=True))
    return mesh


def _block_numel(shape, spec, mesh):
    n = math.prod(shape)
    for a in spec.axes:
        n //= mesh.shape[a]
    return n


def test_lower_cell_train_row(small):
    row = dryrun.lower_cell("qwen1.5-0.5b", "train_4k", verbose=False)
    assert ROW_KEYS <= set(row) and set(row["memory"]) == MEMORY_KEYS
    assert set(row["roofline"]) == set(jrl.RooflineTerms(1.0, 1.0, 1.0, 1).row())
    assert row["mesh"] == [2, 2] and row["n_chips"] == 4 and "reason" not in row

    cfg = treg.get_config("qwen1.5-0.5b")
    model = tapi.abstract_params(cfg)
    params = dict(model.named_parameters())
    pspecs = shd.param_specs(cfg, model, small)
    ospecs = shd.opt_state_specs(cfg, pspecs, model, small)
    shape = treg.get_shape("train_4k")
    want = 0
    for n, p in params.items():
        want += _block_numel(p.shape, pspecs[n], small) * p.element_size()
        if NamedSharding(small, ospecs[n]).holds(0):  # a layer's ZeRO-1 moments live on one dp rank
            want += 3 * _block_numel(p.shape, ospecs[n], small) * 4  # m, v and the fp32 master
    want += 4  # the int32 step count
    want += shape.global_batch // 2 * shape.seq_len * 4  # int32 tokens over the data axis
    assert row["memory"]["argument_bytes"] == want

    coll = row["collectives"]
    assert coll is not None and coll["all-gather"] > 0 and coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    assert row["memory"]["temp_bytes"] > 0
    assert row["memory"]["peak_bytes_per_device"] == want + row["memory"]["temp_bytes"]
    assert row["roofline"]["hlo_flops"] > 0 and row["roofline"]["t_collective_s"] > 0


@pytest.mark.parametrize("arch,shape", [("granite-moe-1b-a400m", "prefill_32k"), ("qwen1.5-0.5b", "decode_32k"),
                                        ("granite-moe-1b-a400m", "train_4k")])
def test_lower_cell_null_with_reason(small, arch, shape):
    """No cell is null any more (the name is the one the test had when a
    cell under a refused layout hint was): a serve cell counts its sharded
    prefill or decode step's collectives and temp bytes; the train cell
    here, run under ``moe_dispatch_sharding``, counts its step's too."""
    hint = shape == "train_4k"
    row = dryrun.lower_cell(arch, shape, verbose=False,
                            cfg_transform=(lambda c: c.replace(moe_dispatch_sharding=True)) if hint else None)
    assert row["roofline"]["hlo_flops"] > 0 and row["roofline"]["t_memory_s"] > 0
    assert row["memory"]["argument_bytes"] > 0
    coll = row["collectives"]
    assert coll is not None and coll["all-reduce"] > 0 and "reason" not in row
    if hint:
        assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    elif shape.startswith("decode"):
        assert coll["all-gather"] > 0  # q, the new K/V row and the attention partials
    else:
        assert coll["all-to-all"] > 0  # the prefill's K/V into the T-over-model cache
    assert row["memory"]["temp_bytes"] > 0 and row["roofline"]["t_collective_s"] > 0
    assert row["memory"]["peak_bytes_per_device"] == row["memory"]["argument_bytes"] + row["memory"]["temp_bytes"]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-tiny"])
def test_lower_cell_train_row_of_every_family(small, arch):
    """A train cell of a MoE family (and of the encoder-decoder) counts the
    sharded step: collectives, temp bytes and the peak, no reason."""
    row = dryrun.lower_cell(arch, "train_4k", verbose=False)
    coll = row["collectives"]
    assert coll is not None and coll["all-gather"] > 0 and coll["reduce-scatter"] > 0 and coll["all-reduce"] > 0
    assert row["memory"]["temp_bytes"] > 0 and "reason" not in row
    assert row["memory"]["peak_bytes_per_device"] == row["memory"]["argument_bytes"] + row["memory"]["temp_bytes"]
    assert row["roofline"]["t_collective_s"] > 0


@pytest.mark.parametrize("knob", ["seq_shard_acts", "moe_dispatch_sharding"])
def test_lower_cell_names_a_refused_knob(small, knob):
    """A ``granite × train_4k`` row under either layout hint (once refused,
    hence the name) has its collectives and temp bytes and no reason; under
    ``seq_shard_acts`` the step reduce-scatters the sublayer outputs over
    ``model``, where the hint-free step all-reduces them."""
    row = dryrun.lower_cell("granite-moe-1b-a400m", "train_4k", verbose=False,
                            cfg_transform=lambda c: c.replace(**{knob: True}))
    coll = row["collectives"]
    assert coll is not None and row["memory"]["temp_bytes"] > 0 and "reason" not in row
    assert row["roofline"]["hlo_flops"] > 0 and row["roofline"]["t_collective_s"] > 0
    if knob == "seq_shard_acts":
        base = dryrun.lower_cell("granite-moe-1b-a400m", "train_4k", verbose=False)["collectives"]
        assert coll["reduce-scatter"] > base["reduce-scatter"] and coll["all-reduce"] < base["all-reduce"]


@pytest.mark.parametrize("knob", ["seq_shard_acts", "moe_dispatch_sharding"])
def test_lower_cell_whisper_train_under_a_hint(small, knob):
    """``whisper-tiny × train_4k`` under either layout hint counts its
    folded tensor-parallel step, with no reason: the collectives of the
    hint-free row, as neither hint changes Whisper (the reference tags no
    activation of it, and it has no MoE)."""
    row = dryrun.lower_cell("whisper-tiny", "train_4k", verbose=False,
                            cfg_transform=lambda c: c.replace(**{knob: True}))
    assert "reason" not in row and row["memory"]["temp_bytes"] > 0 and row["roofline"]["t_collective_s"] > 0
    assert row["collectives"] == dryrun.lower_cell("whisper-tiny", "train_4k", verbose=False)["collectives"]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-1b-a400m", "whisper-tiny"])
def test_folded_train_cell_counts_the_full_mesh(arch):
    """A train cell's step run with the dp axes folded (one rank per
    ``model`` index standing for its dp peers) counts exactly the
    collectives of the step run on every rank of a ``(2, 2, 2)`` meta mesh;
    its temp bytes, the region's peak over the ranks that ran, are at
    least the unfolded count's (the one op running at a time is spread
    over fewer ranks) and within 20% of it (1.06–1.13 times it on meshes of
    2–16 × 2, ``dryrun --fold-check``)."""
    r = dryrun.fold_check(arch, (2, 2, 2), ("pod", "data", "model"))
    full, folded = r["unfolded"], r["folded"]
    assert folded["collectives"] == full["collectives"] and full["collectives"]["all-reduce"] > 0
    assert full["temp_bytes"] <= folded["temp_bytes"] <= 1.2 * full["temp_bytes"]


def test_run_cells_skips_follow_reference(monkeypatch):
    monkeypatch.setattr(dryrun, "lower_cell", lambda arch, shape, multi_pod=False: {"arch": arch, "shape": shape})
    rows = dryrun.run_cells(treg.list_archs(), treg.list_shapes(), [False])
    skipped = {(r["arch"], r["shape"]) for r in rows if r.get("skipped")}
    want = {(a, s) for a in jreg.list_archs() for s in jreg.list_shapes()
            if s not in jreg.applicable_shapes(jreg.get_config(a))}
    assert skipped == want and len(rows) == 40


@pytest.fixture
def ref_variants():
    """The reference's VARIANTS; its modules set XLA_FLAGS on import, which
    is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.hillclimb import VARIANTS as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def _changed(base, cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(base)
            if getattr(cfg, f.name) != getattr(base, f.name)}


def test_variants_set_the_reference_fields(ref_variants):
    assert list(VARIANTS) == list(ref_variants)
    for cell, spec in VARIANTS.items():
        ref = ref_variants[cell]
        assert (spec["arch"], spec["shape"]) == (ref["arch"], ref["shape"])
        assert [t for t, _, _ in spec["steps"]] == [t for t, _, _ in ref["steps"]]
        jbase, tbase = jreg.get_config(spec["arch"]), treg.get_config(spec["arch"])
        for (tag, _, tf), (_, _, jf) in zip(spec["steps"], ref["steps"]):
            assert _changed(tbase, tf(tbase)) == _changed(jbase, jf(jbase)), (cell, tag)


def test_dryrun_refuses_bench_names(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "qwen1.5-0.5b", "--out", "BENCH_dryrun.json"])
    with pytest.raises(SystemExit):
        dryrun.main()
    assert "BENCH_" in capsys.readouterr().err
    assert torch.device("meta") == lmesh.make_production_mesh().devices[0]
