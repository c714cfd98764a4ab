"""A configuration's architecture: its reference, its counts and its program
mapping, found by the name the configuration file gives.

A configuration file names its architecture (``"architecture": "<name>"``).
The directory ``architectures/<name>/`` holds three files:

* ``reference.py``: the plain float32 forward and its weight draws
  (``Dims``, ``weight_specs``, ``draw_weights``, ``Reference``); it imports
  ``torch`` alone;
* ``counts.py``: the benchmark's own count (``Model``);
* ``program.py``: the port's model configuration and the port's module
  filled with the reference's weights (``model_config``, ``build_model``).

The directory is looked up under the cell's tree (``Layout.base``) first,
then under ``portbench/``, so a test's tree can bring an architecture of
its own. Each file is loaded once a process, and is registered in
``sys.modules`` before it runs (as ``dataclasses`` and ``typing`` expect):
``portbench/``'s own under their package name, so a test that imports one
gets the same module, any other tree's under a name made from its directory.
A new architecture is a new directory: nothing here names one.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

__all__ = ["EXPORTS", "Architecture", "load"]

PORTBENCH = Path(__file__).resolve().parents[1]

#: what each file of an architecture must define
EXPORTS = {
    "reference": ("Dims", "weight_specs", "draw_weights", "Reference"),
    "counts": ("Model",),
    "program": ("model_config", "build_model"),
}


class Architecture(NamedTuple):
    name: str
    reference: ModuleType
    counts: ModuleType
    program: ModuleType


def _module_name(path: Path) -> str:
    try:
        return ".".join(("portbench",) + path.relative_to(PORTBENCH).with_suffix("").parts)
    except ValueError:
        digest = hashlib.sha256(str(path.parent).encode()).hexdigest()[:16]
        return f"portbench_arch_{digest}.{path.parent.name}.{path.stem}"


@functools.cache
def _load_file(path: Path, exports: tuple) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no such file (an architecture needs {', '.join(EXPORTS)})")
    name = _module_name(path)
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    missing = [e for e in exports if not hasattr(mod, e)]
    if missing:
        raise AttributeError(f"{path} defines no {', '.join(missing)}")
    return mod


def load(cfg: dict, layout, source) -> Architecture:
    """The architecture that the configuration ``cfg``, read from the file
    ``source``, names. Raises, naming the file at fault, where the
    configuration names none or its directory lacks a file or an export."""
    name = cfg.get("architecture")
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise KeyError(f"{source} names no architecture: its \"architecture\" key, {name!r}, is not the name "
                       f"of a directory under architectures/")
    for base in (Path(layout.base), PORTBENCH):
        where = (base / "architectures" / name).resolve()
        if where.is_dir():
            break
    else:
        raise FileNotFoundError(f"{source} names the architecture {name!r}, which has no directory "
                                f"architectures/{name}/ under {layout.base} or {PORTBENCH}")
    mods = {f: _load_file(where / f"{f}.py", exports) for f, exports in EXPORTS.items()}
    return Architecture(name, **mods)
