"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one compiler
process per source, all started together), linked into one shared library
with a plain C interface, and loaded with :mod:`ctypes`. The library lives
at ``build/repro_torch/<hash of sources and flags>/libkernels.so`` under the
repository root, so an edited source rebuilds and an unchanged one loads at
once. Nothing is compiled at import: the first kernel launch calls
:func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load", "build_info", "SOURCES"]

_PKG = Path(__file__).resolve().parents[1]
_ROOT = _PKG.parents[1]
SOURCES = tuple(sorted((_PKG / "csrc").glob("*.cu")))
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_info: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out_dir: Path) -> str:
    """Compile every source in parallel into ``out_dir``, link, and return
    the compilers' combined output (``-Xptxas -v`` register/spill report)."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            procs.append(
                subprocess.Popen(
                    [nvcc, *_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                )
            )
        logs = []
        failed = []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, *_FLAGS, "-shared", "-o", str(tmp_so), *objs],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out_dir / "libkernels.so")  # atomic: concurrent builds agree
    return "\n".join(logs)


def _declare(lib: ctypes.CDLL) -> None:
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.repro_flash_attention_fwd.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, p64, p64, p64, i32, vp]
    lib.repro_flash_attention_fwd.restype = i32
    lib.repro_dt_pack.argtypes = [vp, vp, i64, i64, i64, vp]
    lib.repro_dt_pack.restype = i32
    lib.repro_dt_unpack.argtypes = [vp, vp, i64, i64, i64, i64, i64, vp]
    lib.repro_dt_unpack.restype = i32
    lib.repro_wkv6_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, p64, vp]
    lib.repro_wkv6_fwd.restype = i32


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out_dir = _ROOT / "build" / "repro_torch" / _digest()
        so = out_dir / "libkernels.so"
        log = ""
        built = not so.exists()
        if built:
            out_dir.mkdir(parents=True, exist_ok=True)
            log = _compile(out_dir)
            (out_dir / "build.log").write_text(log)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _info.update(path=str(so), built=built, seconds=time.perf_counter() - t0, log=log)
        _lib = lib
        return lib


def build_info() -> dict:
    """Where the library is, whether this process compiled it, how long
    :func:`load` took, and the compiler's register/spill report."""
    with _lock:
        return dict(_info)
