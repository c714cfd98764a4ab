"""The port's shape registry and abstract params against the JAX package's
(``repro.configs.registry``, ``repro.models.api.abstract_params``), for all
ten archs at their published widths, with nothing allocated: the port
builds on ``torch.device("meta")`` what the reference builds with
``jax.eval_shape``.

Covered: ``list_shapes``/``get_shape``/``applicable_shapes``; every
applicable (arch × shape)'s ``input_specs`` shapes and dtypes; the params'
total elements and bytes; the decode caches' total bytes at ``decode_32k``
and, where it applies, ``long_500k``; ``resolve_device("meta")``. All
exact.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import registry as jreg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402

ARCHS = jreg.list_archs()


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_shape_registry_matches_reference():
    assert sorted(treg.list_archs()) == sorted(ARCHS) and len(ARCHS) == 10
    assert treg.list_shapes() == jreg.list_shapes()
    for name in jreg.list_shapes():
        assert treg.get_shape(name).__dict__ == jreg.get_shape(name).__dict__
    for arch in ARCHS:
        assert treg.applicable_shapes(treg.get_config(arch)) == jreg.applicable_shapes(jreg.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name in jreg.applicable_shapes(jcfg):
        want = jreg.input_specs(jcfg, jreg.get_shape(name))
        got = treg.input_specs(tcfg, treg.get_shape(name))
        assert sorted(got) == sorted(want), (arch, name)
        for k, spec in want.items():
            t = got[k]
            assert t.is_meta and tuple(t.shape) == tuple(spec.shape), (arch, name, k)
            assert str(t.dtype).removeprefix("torch.") == np.dtype(spec.dtype).name, (arch, name, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    want = _leaves(japi.abstract_params(jcfg))
    model = tapi.abstract_params(tcfg)
    got = list(model.parameters())
    assert all(p.is_meta for p in got)
    assert sum(p.numel() for p in got) == sum(math.prod(a.shape) for a in want)
    assert sum(p.numel() * p.element_size() for p in got) == sum(math.prod(a.shape) * a.dtype.itemsize for a in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_specs_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        if name not in jreg.applicable_shapes(jcfg):
            continue
        want = _leaves(jreg.decode_cache_specs(jcfg, jreg.get_shape(name)))
        got = [t for t in jax.tree_util.tree_leaves(treg.decode_cache_specs(tcfg, treg.get_shape(name)))
               if isinstance(t, torch.Tensor)]
        assert all(t.is_meta for t in got)
        assert (sum(t.numel() * t.element_size() for t in got)
                == sum(math.prod(a.shape) * a.dtype.itemsize for a in want)), (arch, name)


def test_resolve_device_meta_and_no_fallback():
    assert resolve_device("meta") == torch.device("meta")
    assert tapi.init_cache(treg.get_config("qwen1.5-0.5b", smoke=True), 2, 16, device="meta")[0][0][0].is_meta
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
