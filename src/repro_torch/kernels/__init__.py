"""Hand-written Hopper kernels (CUDA C++ and Triton) and their plain
PyTorch versions; :mod:`repro_torch.kernels.ops` is the entry point."""
