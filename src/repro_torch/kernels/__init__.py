"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``, under ``csrc/``)
and their plain PyTorch versions; :mod:`repro_torch.kernels.ops` is the
entry point."""
