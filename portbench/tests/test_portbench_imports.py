"""No module under ``portbench/`` imports JAX, Flax, the JAX package
``repro`` or the old ``benchmarks/``; the plain reference imports nothing
of the port either. Names are compared whole at their top level (the part
before the first dot), since ``repro_torch`` begins with ``repro``."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(PB)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not (top_level_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names and not (names & FORBIDDEN)
    # nor the harness, which holds the program's side
    text = path.read_text()
    assert "portbench.harness" not in text


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's, and is not it
    assert "repro_torch".split(".")[0] not in FORBIDDEN
