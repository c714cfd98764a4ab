"""Production mesh construction and the H100's roofline constants.

Single pod: (16, 16) = ("data", "model") — 256 positions.
Multi-pod:  (2, 16, 16) = ("pod", "data", "model") — 512 positions; DP
spans ("pod", "data"), as in ``repro.launch.mesh``.

The port's mesh positions are thread-ranks (``core/mesh``). The production
meshes are built on ``torch.device("meta")`` by default: the dry run takes
every cell on meta blocks and never touches a card. Functions, not
module-level constants, as in the reference.
"""

from __future__ import annotations

from repro_torch.core.mesh import make_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "HW"]


def make_production_mesh(*, multi_pod: bool = False, device="meta", fold=()):
    """The production mesh; ``fold`` names axes whose positions a region
    mirrors instead of running (``core.mesh.Mesh``, meta only)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device, fold=fold)


def make_host_mesh(shape=(2, 2), axes=("data", "model"), device="cuda", fold=()):
    """A small mesh of thread-ranks (on the card unless the caller asks
    for the CPU or meta; ``fold`` as :func:`make_production_mesh`'s)."""
    return make_mesh(shape, axes, device=device, fold=fold)


class HW:
    """NVIDIA H100 SXM5 80 GB per-chip roofline constants (the data sheet's
    figures; a card set below 700 W runs slower under load)."""

    PEAK_FLOPS_BF16 = 989e12  # FLOP/s: dense bf16 tensor-core peak, H100 SXM data sheet
    PEAK_FLOPS_FP32 = 67e12  # FLOP/s: fp32 outside the tensor cores, H100 SXM data sheet
    HBM_BW = 3.35e12  # B/s: HBM3, H100 SXM data sheet
    NVLINK_BW = 450e9  # B/s per direction: NVLink 4, 900 GB/s total, H100 SXM data sheet
    HBM_BYTES = 80 * 1024**3  # 80 GB HBM3, H100 SXM data sheet
