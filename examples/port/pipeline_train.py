"""Pipeline-parallel training over the enqueue extension (paper ext. 4) on
the PyTorch port: a GPipe schedule on a 4-stage pipe axis, whose backward
is one autograd pass back through the ranks' device-ordered sends. Runs on
a (4, 2) ("pipe", "dp") mesh of 8 thread-ranks on one device. The
counterpart of ``examples/pipeline_train.py``, without JAX; the step runs
eagerly where the JAX example jits it.

    PYTHONPATH=src python examples/port/pipeline_train.py                # on the card
    PYTHONPATH=src python examples/port/pipeline_train.py --device cpu   # anywhere
"""

import argparse

import numpy as np
import torch

from repro_torch.core.collectives import all_reduce
from repro_torch.core.mesh import P, axis_index, make_mesh, shard_map
from repro_torch.core.streams import stream_comm_create
from repro_torch.device import resolve_device
from repro_torch.parallel.pipeline import gpipe_forward, split_stages

N_STAGES, LAYERS, D, MB, N_MICRO, VOCAB = 4, 8, 64, 4, 4, 512
ITERS, LR, SEQ = 30, 0.5, 32


def init(generator: torch.Generator, device):
    """The embedding, the (N_STAGES, LAYERS / N_STAGES, D, D) stage stack
    and the head, drawn from ``generator`` (on ``device``)."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {
        "embed": normal(VOCAB, D) * 0.02,
        "stages": split_stages(normal(LAYERS, D, D) * 0.2, N_STAGES),
        "head": normal(D, VOCAB) * 0.02,
    }


def stage_fn(stage_params, x):
    for w in stage_params:  # this stage's layers
        x = torch.tanh(x @ w)
    return x


def loss_fn(params, tokens, mesh):
    """The next-token loss of the pipelined model, computed on the last
    stage and summed over ``pipe`` (every rank of a pipe group gets it)."""
    pipe = stream_comm_create(mesh, ("pipe",))

    def inner(sp, toks):
        rank = axis_index("pipe")
        x = params["embed"][toks]  # embed replicated on every stage
        B = x.shape[0]
        xm = x.reshape(N_MICRO, B // N_MICRO, *x.shape[1:])
        outs = gpipe_forward(stage_fn, sp[0], xm, "pipe")  # enqueue transport
        if rank == N_STAGES - 1:  # only the last stage's outputs are the model's
            outs = outs.reshape(B, -1, D)
            logits = outs @ params["head"]
            lp = torch.log_softmax(logits[:, :-1], dim=-1)
            ll = torch.gather(lp, -1, toks[:, 1:, None])[..., 0]
            l = -ll.mean()
        else:
            l = torch.zeros((), dtype=torch.float32, device=x.device)
        return all_reduce(l, pipe)[0]

    return shard_map(inner, mesh, in_specs=(P("pipe"), P()), out_specs=P())(params["stages"], tokens)


def step(params, tokens, mesh, lr=LR):
    """One SGD step: the loss at ``params`` and the updated params. The one
    ``backward`` runs after the region, from the caller, through every
    rank's sends."""
    params = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    l = loss_fn(params, tokens, mesh)
    l.backward()
    with torch.no_grad():
        params = {k: p - lr * p.grad for k, p in params.items()}
    return params, l.detach()


def batch(rng: np.random.Generator, device) -> torch.Tensor:
    """(MB * N_MICRO, SEQ) runs of consecutive tokens mod 64, each from a
    seeded start."""
    start = rng.integers(0, 64, (MB * N_MICRO, 1))
    return torch.from_numpy((start + np.arange(SEQ)[None, :]) % 64).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPipe training over the enqueue extension on the PyTorch port")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mesh = make_mesh((N_STAGES, 2), ("pipe", "dp"), device=device)
    params = init(torch.Generator(device=device).manual_seed(0), device)

    rng = np.random.default_rng(0)
    losses = []
    for it in range(ITERS):
        params, l = step(params, batch(rng, device), mesh)
        losses.append(float(l))
        if it % 5 == 0:
            print(f"[pipeline] iter {it}: loss {float(l):.4f}")
    print(f"[pipeline] final loss {float(l):.4f} ({N_STAGES}-stage GPipe, {N_MICRO} microbatches)")
    assert float(l) < 2.0
    print("OK")
    return losses


if __name__ == "__main__":
    main()
