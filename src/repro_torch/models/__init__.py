"""Model layers, the DiT denoiser and the language-model backbone
(counterpart of ``repro.models``)."""
from .transformer import (LOCAL, ParallelCtx, TransformerLM, decode_step,
                          forward_hidden, forward_train, init_params,
                          load_jax_params, make_dense_cache, prefill)

__all__ = ["LOCAL", "ParallelCtx", "TransformerLM", "decode_step",
           "forward_hidden", "forward_train", "init_params",
           "load_jax_params", "make_dense_cache", "prefill"]
