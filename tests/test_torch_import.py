"""The PyTorch port stands alone: it imports without JAX, never imports the
JAX package, and asking for the card without one raises instead of
falling back to the CPU. The port's benchmarks (``benchmarks/port/``) are
held to the same rules."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_BENCH = REPO / "benchmarks" / "port"


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([str(PORT)], prefix="repro_torch.")
        if not m.name.endswith("__main__")
    )


def _port_bench_files():
    return sorted(PORT_BENCH.glob("*.py"))


def test_every_port_module_imports_without_jax():
    mods = ["repro_torch"] + _port_modules()
    assert "repro_torch.serving.engine" in mods and "repro_torch.kernels._build" in mods
    assert "repro_torch.serving.paged_kv" in mods and "repro_torch.core.threadcomm" in mods
    for sub in ("checkpoint.iovec_store", "checkpoint.manager", "data.pipeline", "optim.adamw", "optim.compression",
                "optim.grad_overlap", "ft.heartbeat", "ft.straggler", "ft.elastic", "launch.train",
                "parallel.pipeline", "parallel.sharding", "launch.mesh", "launch.op_cost", "launch.roofline",
                "launch.dryrun", "launch.hillclimb"):
        assert f"repro_torch.{sub}" in mods, sub
    benches = [str(p) for p in _port_bench_files()]
    assert any(b.endswith("serving_load.py") for b in benches)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises ImportError
        "sys.modules['ml_dtypes'] = None\n"  # numpy's bfloat16 comes with JAX, not with the port
        "import importlib, importlib.util\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({benches!r}):\n"  # the port's benchmarks, imported as modules
        "    spec = importlib.util.spec_from_file_location(f'port_bench_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "assert not any(k == 'repro' or k.startswith('repro.') for k in sys.modules), "
        "sorted(k for k in sys.modules if k.startswith('repro.'))\n"
        "print('IMPORTED', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "HOME": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
    assert "IMPORTED" in proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in PORT.rglob("*.py"))
    + sorted(p.relative_to(REPO).as_posix() for p in PORT_BENCH.glob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_or_reference_imports(path):
    bad = [
        m for m in _imports(REPO / path)
        if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")
        or m.startswith("jaxlib") or m.startswith("flax") or m.startswith("ml_dtypes")
    ]
    assert not bad, f"{path} imports {bad}"


def _entry_points():
    from repro_torch.configs import get_config
    from repro_torch.core.mesh import make_mesh
    from repro_torch.core.streams import new_token
    from repro_torch.device import resolve_device
    from repro_torch.models import api

    cfg = get_config("qwen1.5-0.5b", smoke=True)
    return {
        "resolve_device": lambda: resolve_device("cuda"),
        "init_params": lambda: api.init_params(cfg, torch.Generator().manual_seed(0)),
        "init_cache": lambda: api.init_cache(cfg, 2, 16),
        "new_token": lambda: new_token("cuda"),
        "make_mesh": lambda: make_mesh((2, 4), ("pod", "data")),
        "serve_cli": lambda: __import__("repro_torch.launch.serve", fromlist=["main"]).main(["--requests", "1"]),
        "train_cli": lambda: __import__("repro_torch.launch.train", fromlist=["main"]).main(["--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_params", "init_cache", "new_token", "make_mesh", "serve_cli",
                                  "train_cli"])
def test_cuda_requested_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-card refusal cannot be observed here")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()


def test_unported_configs_raise_with_roadmap_pointer():
    """All ten architectures of the reference's registry are the port's; an
    unknown name raises ``KeyError``."""
    from repro_torch.configs import get_config, list_archs

    assert list_archs() == ["qwen1.5-0.5b", "rwkv6-7b", "granite-moe-1b-a400m", "deepseek-v3-671b", "llama3-405b",
                            "internlm2-20b", "gemma3-4b", "phi-3-vision-4.2b", "jamba-v0.1-52b", "whisper-tiny"]
    for arch in ("jamba-v0.1-52b", "whisper-tiny"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def _all_names(path: Path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            return {ast.literal_eval(e) for e in node.value.elts}
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("module", ["parallel/pipeline.py", "parallel/sharding.py", "launch/train.py"])
def test_port_exports_the_reference_names(module):
    """Every public name of the reference module has the port's counterpart
    (``repro.parallel`` and the sharded-step helpers of ``launch/train``)."""
    ref = _all_names(REPO / "src" / "repro" / module)
    if module == "launch/train.py":
        ref |= {"named", "train_shardings"}  # public in the reference, outside its __all__
    assert ref <= _all_names(PORT / module), sorted(ref - _all_names(PORT / module))
