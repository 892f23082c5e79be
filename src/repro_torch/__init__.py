"""PyTorch/CUDA port of the SRDS package (``repro``), for NVIDIA Hopper.

Mirrors ``repro``'s module names (``repro_torch.core.engine`` is the
counterpart of ``repro.core.engine``).  Imports ``torch`` only: no JAX and
nothing of the ``repro`` package.  Kernels live in
:mod:`repro_torch.kernels`; a CUDA tensor always launches the hand-written
kernel (or raises), a CPU tensor takes the kernel's plain PyTorch version.
"""
