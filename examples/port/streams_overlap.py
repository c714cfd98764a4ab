"""The paper's technique on a device mesh, on the PyTorch port:
stream-tagged, bucketed gradient synchronization (multi-VCI) vs one
serialized channel, plus the hierarchical multi-pod all-reduce. Runs on a
(2, 4) ("pod", "data") mesh of 8 thread-ranks on one device; on the card
each rank's stream communicators run on CUDA streams of their own. The
counterpart of ``examples/streams_overlap.py``, without JAX.

    PYTHONPATH=src python examples/port/streams_overlap.py                # on the card
    PYTHONPATH=src python examples/port/streams_overlap.py --device cpu   # anywhere
"""

import argparse
import threading

import numpy as np
import torch

import repro_torch.core as C
from repro_torch.core.collectives import all_reduce, multi_stream_all_reduce
from repro_torch.core.hierarchical import hierarchical_all_reduce, hierarchical_collective_bytes
from repro_torch.device import resolve_device
from repro_torch.optim.grad_overlap import build_buckets, bucketed_all_reduce

RANKS = C.P(("pod", "data"))  # one row of the gradients per thread-rank


def make_grads(device) -> torch.Tensor:
    return torch.arange(8 * 4096, dtype=torch.float32, device=device).reshape(8, 4096) / 1e4


def serialized(tc, mesh, grads) -> torch.Tensor:
    """(a) one implicit channel: a single serialized all-reduce chain."""
    single = C.stream_comm_create(mesh, ("pod", "data"))

    def body(g):
        tok = C.new_token(g.device)
        out = []
        for chunk in torch.chunk(g.reshape(-1), 4):
            y, tok = all_reduce(chunk, single, tok)  # same stream ⇒ chained
            out.append(y)
        return torch.cat(out)

    return tc.run(body, grads, in_specs=RANKS, out_specs=C.P())


def streamed(tc, comms, grads, seen=None) -> torch.Tensor:
    """(b) explicit streams: one chunk on each comm, no false dependency.
    ``seen`` (a set) collects the CUDA streams the comms ran on, every rank's."""
    lock = threading.Lock()

    def body(g):
        y, _ = multi_stream_all_reduce(g.reshape(-1), comms, axis=0)
        if seen is not None:
            with lock:
                seen.update(c.stream.torch_stream(g.device) for c in comms)
        return y

    return tc.run(body, grads, in_specs=RANKS, out_specs=C.P())


def bucket_plan():
    """The bucket plan of three leaves at 4096-byte buckets."""
    params_shape = {
        "wq": torch.empty((1024,), dtype=torch.float32, device="meta"),
        "wo": torch.empty((2048,), dtype=torch.float32, device="meta"),
        "mlp": torch.empty((1024,), dtype=torch.float32, device="meta"),
    }
    return build_buckets(params_shape, bucket_bytes=4096)


def bucketed(tc, plan, comms, grads) -> torch.Tensor:
    """(c) bucketed grad sync through the datatype layer, the buckets on
    round-robin streams."""

    def body(g):
        y, _ = bucketed_all_reduce(g.reshape(-1), plan, comms)
        return y

    return tc.run(body, grads, in_specs=RANKS, out_specs=C.P())


def hierarchical(tc, grads) -> torch.Tensor:
    """(d) the hierarchical multi-pod schedule: reduce-scatter in the pod,
    all-reduce across pods, all-gather in the pod."""

    def body(g):
        y, _ = hierarchical_all_reduce(g, tc, axis=1)
        return y

    return tc.run(body, grads, in_specs=RANKS, out_specs=C.P())


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-stream gradient sync on a mesh of thread-ranks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    mesh = C.make_mesh((2, 4), ("pod", "data"), device=device)
    tc = C.threadcomm_init(mesh, ("pod", "data"))
    print(f"[mesh] {dict(mesh.shape)} — threadcomm size {tc.size()}")

    grads = make_grads(device)
    streams = [C.stream_create(name=f"vci{i}") for i in range(4)]
    try:
        comms = [C.stream_comm_create(mesh, ("pod", "data"), s) for s in streams]
        seen = set()
        ys = serialized(tc, mesh, grads)
        ym = streamed(tc, comms, grads, seen)
        assert np.allclose(ys.cpu().numpy(), ym.cpu().numpy())
        print("[streams] serialized chain == 4-stream concurrent result ✓ "
              "(one chained stream vs four independent ones)")
        n_cuda = len(seen - {None})
        print(f"[streams] part (b) ran on {n_cuda} distinct CUDA streams "
              f"({len(comms)} comms × {mesh.size} thread-ranks)")

        plan = bucket_plan()
        print(f"[buckets] {plan.n_buckets} buckets over {plan.total_elems} elems: {plan.bucket_slices}")
        yb = bucketed(tc, plan, comms, grads)
        assert np.allclose(yb.cpu().numpy(), ys.cpu().numpy())
        print("[buckets] bucketed round-robin-stream all-reduce ✓")

        yh = hierarchical(tc, grads)
        assert np.allclose(yh.cpu().numpy().sum(), ys.cpu().numpy().sum(), rtol=1e-5)
        m = hierarchical_collective_bytes(1 << 30, n_outer=2, n_inner=256)
        print(f"[hier] 1GiB all-reduce cross-pod bytes: flat={m['flat']['outer_bytes']/2**20:.0f}MiB "
              f"→ hier={m['hierarchical']['outer_bytes']/2**20:.0f}MiB")
    finally:
        for s in streams:
            C.stream_free(s)
    print("OK")


if __name__ == "__main__":
    main()
