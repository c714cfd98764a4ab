"""repro_torch — the MPIX extensions runtime and its serving path in PyTorch.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core``, ``kernels``, ``models``, ``configs``, ``serving``,
``launch``, ``analysis``) and replaces every Pallas TPU kernel on its path
with a hand-written CUDA kernel for Hopper (``csrc/``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU each kernel
wrapper runs its plain PyTorch version.
"""
