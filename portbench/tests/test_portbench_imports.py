"""No module under ``portbench/`` imports JAX, Flax, the JAX package
``repro`` or the old ``benchmarks/``; each architecture's plain reference
imports ``torch`` and the standard library alone, and its counts import
neither the port nor that reference. Names are compared whole at their top
level (the part before the first dot), since ``repro_torch`` begins with
``repro``."""

import ast
import sys
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


def full_imports(path: Path) -> set:
    """Every absolute module name imported, whole (``a.b.c``)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{a.name}" for a in node.names)
    return names


def relative_imports(path: Path) -> set:
    return {"." * n.level + (n.module or "") for n in ast.walk(ast.parse(path.read_text(), str(path)))
            if isinstance(n, ast.ImportFrom) and n.level > 0}


FILES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(PB)) for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not (top_level_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize("path", sorted(PB.glob("architectures/*/reference.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names and not (names & FORBIDDEN)
    # nor the harness, which holds the program's side, nor its architecture's other files
    assert names - set(sys.stdlib_module_names) == {"torch"}, names
    assert not relative_imports(path)


@pytest.mark.parametrize("path", sorted(PB.glob("architectures/*/counts.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_counts_import_neither_the_port_nor_the_reference(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names and not (names & FORBIDDEN)
    modules = full_imports(path) | relative_imports(path)
    assert not any(m.split(".")[-1] == "reference" or m.startswith("portbench.architectures") for m in modules), modules


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's, and is not it
    assert "repro_torch".split(".")[0] not in FORBIDDEN
