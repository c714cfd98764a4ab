"""The architecture seam (``portbench/harness/arch.py``) at smoke size on the
CPU: an architecture added as files alone runs a cell and is checked by its
own reference; a broken program mapping and a missing piece fail loudly at
set-up, naming the file or the parameter; and the GQA architecture computes
what it computed before it moved into ``architectures/gqa/``."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import arch
from portbench.harness import cell as cell_mod

PB = Path(__file__).resolve().parents[1]
DATA = PB / "tests" / "data"
GQA = PB / "architectures" / "gqa"
CELL = "smoke-docqa-paged"  # its configuration is phi3-smoke
SEED = 2**31 + 5


def copy_tree(tmp_path, edits=None, files=tuple(arch.EXPORTS), architecture="gqa_copy"):
    """A cell tree of the smoke data whose ``phi3-smoke`` names
    ``architecture``, with ``architectures/gqa_copy/`` holding ``files``
    copied from ``architectures/gqa/``; ``edits`` maps a file to the
    ``(old, new)`` replacements made in its copy."""
    base = tmp_path / "tree"
    shutil.copytree(DATA, base)
    dst = base / "architectures" / "gqa_copy"
    dst.mkdir(parents=True)
    for f in files:
        text = (GQA / f"{f}.py").read_text()
        for old, new in (edits or {}).get(f, ()):
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        (dst / f"{f}.py").write_text(text)
    cfg_file = base / "configs" / "phi3-smoke.json"
    cfg = json.loads(cfg_file.read_text())
    if architecture is None:
        del cfg["architecture"]
    else:
        cfg["architecture"] = architecture
    cfg_file.write_text(json.dumps(cfg))
    return cell_mod.Layout(base)


def run(layout, control=False):
    return cell_mod.run_cell(CELL, SEED, 2.0, False, t_process=time.perf_counter(), device="cpu", layout=layout,
                             control=control)


def test_an_architecture_added_as_files_runs_and_is_checked(tmp_path):
    layout = copy_tree(tmp_path)
    out, base = run(layout, control=True), run(cell_mod.Layout(DATA), control=True)
    assert out["correct"], out["check"]["numbers"]
    # the copy's files did the work: its counts are on the run record
    assert type(out["run"].model).__module__.endswith(".gqa_copy.counts")
    assert type(base["run"].model).__module__ == "portbench.architectures.gqa.counts"
    # the same readings as the architecture it copies, the fp8 control's too
    for key in ("readings", "control", "sampled", "tokens_compared", "per_request_gap"):
        assert out["check"][key] == base["check"][key], key
    assert out["check"]["control"]["widest_gap"] > 0


def test_each_file_is_loaded_once(tmp_path):
    layout = copy_tree(tmp_path)
    cfg = layout.config("phi3-smoke")
    a = arch.load(cfg, layout, "phi3-smoke.json")
    b = arch.load(cfg, layout, "phi3-smoke.json")
    assert a.name == "gqa_copy" and all(x is y for x, y in zip(a[1:], b[1:]))
    assert Path(a.reference.__file__).parent == layout.base / "architectures" / "gqa_copy"


def test_portbench_architectures_load_as_their_package():
    # one module a file: the harness's load and a test's import meet
    from portbench.architectures.gqa import counts, program, reference

    layout = cell_mod.Layout(DATA)
    a = arch.load(layout.config("phi3-smoke"), layout, "phi3-smoke.json")
    assert (a.reference, a.counts, a.program) == (reference, counts, program)


#: a dataclass under ``from __future__ import annotations``, as the
#: harness's own modules declare them: it needs its module in ``sys.modules``
DATACLASS = "\n\nimport dataclasses\n\n\n@dataclasses.dataclass\nclass Extra:\n    width: int = 0\n"


def test_architecture_files_may_declare_dataclasses(tmp_path):
    layout = copy_tree(tmp_path, {f: [("__all__ = [", DATACLASS + "\n__all__ = [")] for f in arch.EXPORTS})
    out = run(layout)
    assert out["correct"], out["check"]["numbers"]
    a = arch.load(layout.config("phi3-smoke"), layout, "phi3-smoke.json")
    assert all(m.Extra(3).width == 3 for m in a[1:])


def test_the_check_uses_the_architectures_own_reference(tmp_path):
    theta = 'self.theta = float(cfg["rope_theta"])'
    layout = copy_tree(tmp_path, {"reference": [(theta, theta.replace("float(", "2 * float("))]})
    out = run(layout)
    assert not out["correct"], out["check"]["numbers"]
    assert out["check"]["readings"]["widest_gap"] > 10 * out["check"]["numbers"]["widest_gap"][1]


@pytest.mark.parametrize("edit,named", [
    # a weight the mapping lets fall: its parameters are left unfilled
    (("    for name, stacked in weights.items():", "    for name, stacked in list(weights.items())[:-1]:"),
     "groups.0.0.ffn.w_down"),
    # a leaf gone from the mapping
    ((' "wo": "attn.wo",', ""), "'wo'"),
    # a leaf mapped onto a parameter the port does not have
    (('"wo": "attn.wo"', '"wo": "attn.w_o"'), "groups.0.0.attn.w_o"),
], ids=["weight_dropped", "leaf_unmapped", "leaf_misnamed"])
def test_a_broken_program_mapping_fails_loudly(tmp_path, edit, named):
    layout = copy_tree(tmp_path, {"program": [edit]})
    with pytest.raises(KeyError) as err:
        run(layout)
    assert named in str(err.value)


@pytest.mark.parametrize("kind", ["no_key", "unknown_name", "missing_file", "missing_export"])
def test_the_loader_names_the_file_at_fault(tmp_path, kind):
    where = "configs/phi3-smoke.json"
    if kind == "no_key":
        layout, error = copy_tree(tmp_path, architecture=None), KeyError
    elif kind == "unknown_name":
        layout, error = copy_tree(tmp_path, architecture="no_such"), FileNotFoundError
    elif kind == "missing_file":
        layout, error = copy_tree(tmp_path, files=("reference", "counts")), FileNotFoundError
        where = "architectures/gqa_copy/program.py"
    else:
        layout, error = copy_tree(tmp_path, {"counts": [("class Model:", "class Counts:")]}), AttributeError
        where = "architectures/gqa_copy/counts.py"
    with pytest.raises(error) as err:
        run(layout)
    assert str(layout.base / where) in str(err.value)


#: digests of the weights and of the fp32 and fp8 logits, computed with
#: ``portbench/reference/model.py`` before it moved to ``architectures/gqa/``
PINS = {
    "phi3-smoke": {
        "weights": "92d201a47fda1be69d6bea52f79c35bcf9631855a1ed31b487e9eaee6e8784fa",
        "names": ["tok", "out", "final_norm", "ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"],
        "fp32": "ffedb428ec4c5b9796ea5a39dc5145aefa42bd9d08f862a88656c9d4df2adbd6",
        "fp8": "17ddbac938cff07c97ca67066e4b580e5fa5633a6ee2a5031f501a19b8ba0c4f",
    },
    "granite-smoke": {
        "weights": "6057af57b60902d05d462ba2119d05871b155248517604c9af75d80df7b079f7",
        "names": ["tok", "final_norm", "ln1", "ln2", "wq", "wk", "wv", "wo", "router", "we_gate", "we_up", "we_down"],
        "fp32": "269fa172b00321dc6f85157255f7fddb5e114872fa9939a9641e30eea7c30aaf",
        "fp8": "cd5d9ef875160e16f157adc2a7e93ba496bf8413ce368aa04ac0e2ed6cd21813",
    },
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINS))
def test_gqa_computes_what_it_did_before_the_move(name):
    layout = cell_mod.Layout(DATA)
    cfg = layout.config(name)
    ref = arch.load(cfg, layout, layout.config_file(name)).reference
    dims = ref.Dims(cfg)
    w = ref.draw_weights(dims, 2**31 + 11, "cpu")
    tokens, at = [(37 * i + 5) % dims.vocab for i in range(48)], [0, 17, 47]
    got = {"weights": _digest(w.values()), "names": list(w),
           "fp32": _digest([ref.Reference(dims, w).logits(tokens, at)]),
           "fp8": _digest([ref.Reference(dims, w, linear="fp8").logits(tokens, at)])}
    assert got == PINS[name]
