"""Collectives, sharding specs and tensor parallelism (counterpart of
``repro.parallel``)."""
from .collectives import (BACKENDS, CALLS, all_gather_dim, check_backend,
                          compressed_psum_mean, copy_to, gather_seq,
                          gather_split, heads_to_seq, joined, lse_combine,
                          reduce_from, reset_calls, scatter_seq, split)
from .sharding import (HALVES, Spec, batch_shardings, cache_shardings,
                       denoiser_spec, full_tensor, gather_spec, local_part,
                       mesh_shape, microbatch_spec, opt_state_shardings,
                       param_shardings, slice_spec)
from .tensor_parallel import HeadShare, TensorParallel

__all__ = ["BACKENDS", "CALLS", "HALVES", "HeadShare", "Spec",
           "TensorParallel", "all_gather_dim", "batch_shardings",
           "cache_shardings", "check_backend", "compressed_psum_mean",
           "copy_to", "denoiser_spec", "full_tensor", "gather_seq",
           "gather_spec", "gather_split", "heads_to_seq", "joined",
           "local_part", "lse_combine", "mesh_shape", "microbatch_spec",
           "opt_state_shardings", "param_shardings", "reduce_from", "reset_calls", "scatter_seq", "slice_spec",
           "split"]
