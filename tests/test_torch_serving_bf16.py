"""Served greedy tokens in bf16, the configs as published, against the JAX
package: the smoke ``qwen1.5-0.5b`` and ``rwkv6-7b`` with the same weights
(carried over with ``params_from_numpy``) and the same seeded prompts, each
served by both packages' ``ServeEngine``.

bf16 rounds every matmul output, and the two packages accumulate in other
orders, so two logits within one bf16 step of each other may rank either
way. So the tokens must be equal up to the first divergence, and a
divergence is allowed only where the reference's top-2 logit margin at that
step is at most one bf16 step of its top logit (``2**(floor(log2|top|) - 7)``).
The margins come from a batch-of-one greedy decode (``prefill`` then
``decode_step``) teacher-forced along the reference's tokens. A divergence
at a clear margin is a fault of the port. The first divergence of each
request, if any, is printed.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServeEngine as TServeEngine  # noqa: E402

CASES = {
    "qwen1.5-0.5b": dict(lens=(5, 7, 5, 9, 7, 12), max_new=8, max_len=32),
    "rwkv6-7b": dict(lens=(16, 23, 30), max_new=8, max_len=48),
}


def bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``|x|`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def _teacher_forced_margins(jcfg, jp, prompt, tokens):
    """The reference's top-2 margin and top logit at each output step, with
    B = 1 along ``tokens``: step 0 from the prefill of ``prompt``, step i
    from the decode of ``tokens[i - 1]`` at position ``len(prompt) + i - 1``."""
    n = len(prompt)
    logits, cache = japi.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt[None])}, max_len=n + len(tokens))
    out = []
    for i in range(len(tokens)):
        if i:
            logits, cache = japi.decode_step(jcfg, jp, cache, jnp.asarray([tokens[i - 1]], jnp.int32),
                                             jnp.asarray([n + i - 1], jnp.int32))
        row = np.asarray(logits[0], np.float32)
        top2 = np.sort(row)[-2:]
        out.append((float(top2[1] - top2[0]), float(top2[1]), int(np.argmax(row))))
    return out


@pytest.mark.parametrize("arch", sorted(CASES))
def test_bf16_served_tokens_match_reference(arch):
    case = CASES[arch]
    jcfg, tcfg = j_get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    assert jcfg.param_dtype == tcfg.param_dtype == "bfloat16" and jcfg.compute_dtype == "bfloat16"
    jp = japi.init_params(jcfg, jax.random.key(0))
    model = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, (n,)).astype(np.int32) for n in case["lens"]]

    served = {}
    for pkg, eng in (("jax", JServeEngine(jcfg, jp, max_batch=2, max_len=case["max_len"])),
                     ("torch", TServeEngine(tcfg, model, max_batch=2, max_len=case["max_len"]))):
        reqs = [eng.submit(p, max_new_tokens=case["max_new"]) for p in prompts]
        eng.run_until_done(max_steps=400)
        assert all(r.done and len(r.out_tokens) == case["max_new"] for r in reqs), pkg
        served[pkg] = [list(r.out_tokens) for r in reqs]

    faults, equal = [], 0
    for k, (prompt, want, got) in enumerate(zip(prompts, served["jax"], served["torch"])):
        i = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
        if i is None:
            equal += 1
            continue
        margin, top, argmax = _teacher_forced_margins(jcfg, jp, prompt, want)[i]
        step = bf16_step(top)
        print(f"[bf16 {arch}] request {k}: first divergence at output {i}: reference {want[i]}, "
              f"port {got[i]}; reference top-2 margin {margin:.6g}, bf16 step {step:.6g}")
        assert argmax == want[i], "the B=1 decode disagrees with the reference engine's own pick"
        if margin > step:
            faults.append((k, i, want[i], got[i], margin, step))
    assert not faults, f"{arch}: tokens diverge at a clear margin (request, step, ref, port, margin, step): {faults}"
    assert equal >= 1, f"{arch}: every request diverged"
