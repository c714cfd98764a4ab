"""Quickstart on the PyTorch port: the six MPIX extensions in 60 seconds
(no mesh). The counterpart of ``examples/quickstart.py``, without JAX.

    PYTHONPATH=src python examples/port/quickstart.py                # on the card
    PYTHONPATH=src python examples/port/quickstart.py --device cpu   # anywhere
"""

import argparse

import repro_torch.core as C
from repro_torch.checkpoint.iovec_store import shard_subarray
from repro_torch.device import resolve_device


def grequest_demo() -> None:
    """A generalized request polled by a progress thread on an explicit
    stream until its third visit."""
    # 1+6. Generalized requests + general progress --------------------------
    engine = C.ProgressEngine()
    stream = C.stream_create(name="io")  # 3. an explicit execution context
    state = {"ticks": 0}

    def poll_fn(st):  # completes after 3 progress visits
        st["ticks"] += 1
        return st["ticks"] >= 3

    try:
        req = engine.grequest_start(poll_fn=poll_fn, extra_state=state, stream=stream)
        engine.start_progress_thread(stream, interval=0.001)  # spin-up (ext. 6)
        try:
            # one waitall for MPI and non-MPI work (ext. 1)
            if not engine.wait_all([req], timeout=30.0):
                raise TimeoutError("the generalized request did not complete in 30 s")
        finally:
            engine.stop_progress_thread(stream)  # spin-down
        print(f"[grequest] completed after {state['ticks']} polls on {stream.name!r}")
    finally:
        C.stream_free(stream)


def datatype_demo() -> None:
    """The paper's subarray as a layout API, and a checkpoint shard's layout."""
    # 2. Datatypes as a layout API (the paper's subarray example) ----------
    value = C.predefined(16, "struct value")
    volume = C.subarray([1000, 1000, 1000], [100, 100, 100], [300, 300, 300], value)
    n, nbytes = C.type_iov_len(volume, -1)
    iovs = C.type_iov(volume, 0, 4)
    print(f"[datatype] iov_len = {n}, iov_bytes = {nbytes}")
    for i, iov in enumerate(iovs):
        print(f"[datatype] iov[{i}]: offset={iov.offset} len={iov.length}")

    # ... and as the checkpoint shard layout:
    shard = shard_subarray((8, 8), (slice(0, 4), slice(0, 8)), itemsize=4)
    print(f"[datatype] checkpoint shard = {shard.num_segments} contiguous run(s)")


def streams_demo(device) -> None:
    """An offload stream standing for a CUDA stream, and a stream
    communicator over it."""
    # 3/4. Stream communicators + enqueue semantics -------------------------
    info = {"type": "cudaStream_t"}
    C.info_set_hex(info, "value", (0xDEADBEEF).to_bytes(8, "little"))
    offload = C.stream_create(info=info, name="device-queue")
    try:
        comm = C.stream_comm_create(None, ("data",), offload)
        line = f"[streams] offload stream on channel {offload.channel}, comm axes {comm.axes}"
        cuda = offload.torch_stream(device)  # None on the CPU
        if cuda is not None:
            line += f"; it owns torch.cuda.Stream {cuda.cuda_stream:#x} on {device}"
        print(line)
    finally:
        C.stream_free(offload)


def main(argv=None):
    ap = argparse.ArgumentParser(description="the six MPIX extensions on the PyTorch port")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    grequest_demo()
    datatype_demo()
    streams_demo(device)

    # 5. Thread communicators: one communicator across hierarchy levels ----
    # (mesh positions as thread-ranks: see examples/port/streams_overlap.py)
    print("[threadcomm] see examples/port/streams_overlap.py for the mesh demo")
    print("OK")


if __name__ == "__main__":
    main()
