"""PyTorch/CUDA port of the LC-EMD engines for one NVIDIA Hopper GPU.

The JAX package ``repro`` is the reference; this package mirrors its
layout and names (``core.lc``, ``kernels.ops``, ``api.EmdIndex`` ...) so
each module's counterpart is easy to find, and holds itself to the same
numeric contracts. It imports ``torch`` and nothing of JAX or ``repro``.

Kernels are hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, built
with ``nvcc`` at first use (``kernels._build``) and bound with ``ctypes``.
"""
