"""Collectives and sharding specs (counterpart of ``repro.parallel``)."""
from .collectives import (BACKENDS, all_gather_dim, check_backend,
                          compressed_psum_mean, lse_combine)
from .sharding import (Spec, denoiser_spec, gather_spec, mesh_shape,
                       microbatch_spec, slice_spec)

__all__ = ["BACKENDS", "Spec", "all_gather_dim", "check_backend",
           "compressed_psum_mean", "denoiser_spec", "gather_spec",
           "lse_combine", "mesh_shape", "microbatch_spec", "slice_spec"]
