"""Serving models of the port: the Llama family, its KV caches, the
single-stream ``ServeEngine`` and the JAX weight bridge."""

from tpuslo_torch.models.llama import (
    GREEDY,
    LlamaConfig,
    SamplingConfig,
    decode_chunk,
    decode_step,
    forward,
    init_kv_cache,
    init_params,
    llama3_8b,
    llama3_70b,
    llama32_1b,
    llama32_3b,
    llama_tiny,
    prefill,
    quantize_params,
    sample_from_logits,
    verify_chunk,
)
from tpuslo_torch.models.serve import ServeEngine, TokenEvent

__all__ = [
    "GREEDY",
    "LlamaConfig",
    "SamplingConfig",
    "ServeEngine",
    "TokenEvent",
    "decode_chunk",
    "decode_step",
    "forward",
    "init_kv_cache",
    "init_params",
    "llama3_8b",
    "llama3_70b",
    "llama32_1b",
    "llama32_3b",
    "llama_tiny",
    "prefill",
    "quantize_params",
    "sample_from_logits",
    "verify_chunk",
]
