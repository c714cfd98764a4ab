"""Time the pack's bulk-copy (TMA) design against the port's pack kernel.

    PYTHONPATH=src python3 -m repro_torch.tools.pack_bulk_ab

Needs one NVIDIA Hopper GPU and ``nvcc``. Builds ``tools/pack_bulk.cu`` into
``build/pack_bulk/<hash>/``, checks it byte-exact against
:func:`~repro_torch.kernels.dt_pack.dt_pack_plain` at each of
``chip_smoke.py``'s pack shapes whose layout is 16-byte aligned throughout,
then times the port's :func:`~repro_torch.kernels.dt_pack.dt_pack`, the bulk
kernel at each of ``CONFIGS`` and a dense ``copy_`` of the same bytes under
``chip_smoke.py``'s ``Timer``, twice, in turns (forward, then reversed).
Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import json
import subprocess
from pathlib import Path

from repro_torch.kernels import _build
from repro_torch.kernels import dt_pack as dp

ROOT = Path(__file__).resolve().parents[3]
SOURCE = Path(__file__).resolve().parent / "pack_bulk.cu"
# (chunk bytes, ring stages, blocks per SM): the ring fills at most 128 KB of an SM's shared memory
CONFIGS = ((8 << 10, 4, 4), (16 << 10, 4, 2), (16 << 10, 4, 3), (32 << 10, 4, 1))


def build() -> ctypes.CDLL:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(_build._FLAGS).encode()).hexdigest()[:16]
    so = ROOT / "build" / "pack_bulk" / digest / "libpackbulk.so"
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", str(SOURCE), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.pack_bulk.argtypes = [vp, vp, i64, i64, i64, i64, i32, i64, vp]
    lib.pack_bulk.restype = i32
    return lib


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    import torch

    smoke = _smoke()
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(smoke.nvidia_smi_line(), flush=True)
    timer = smoke.Timer(torch)
    bufs = smoke.pack_buffers(torch, torch.Generator(device="cuda").manual_seed(0))
    for name, (which, nseg, seg, stride, start) in smoke.PACK_SHAPES.items():
        buf = bufs[which]
        item = buf.element_size()
        src = buf.data_ptr() + start * item
        if (src | seg * item | stride * item) % 16:
            print(json.dumps({"shape": name, "bulk": "not 16-byte aligned"}), flush=True)
            continue
        want = dp.dt_pack_plain(buf, nseg, seg, stride, start)
        out, a, b = torch.empty_like(want), torch.empty_like(want), torch.empty_like(want)

        def bulk(chunk, stages, per_sm):
            rc = lib.pack_bulk(src, out.data_ptr(), nseg, seg * item, stride * item, chunk, stages, sms * per_sm,
                               torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"pack_bulk launch failed: cudaError {rc}")

        runs = {"port": lambda: dp.dt_pack(buf, nseg=nseg, seg_len=seg, stride=stride, start=start),
                "dense_copy": lambda: b.copy_(a)}
        for cfg in CONFIGS:
            out.zero_()
            bulk(*cfg)
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.uint8), want.view(torch.uint8)):
                raise RuntimeError(f"pack_bulk not byte-exact at {name}, config {cfg}")
            runs["bulk_c%dk_s%d_b%d" % (cfg[0] >> 10, cfg[1], cfg[2])] = lambda cfg=cfg: bulk(*cfg)
        order = list(runs)
        times = {key: [] for key in order}
        for key in order + order[::-1]:
            times[key].append(timer(runs[key]))
        print(json.dumps({"shape": name, "bytes": 2 * nseg * seg * item, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
