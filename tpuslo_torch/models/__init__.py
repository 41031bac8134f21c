"""Serving models of the port: the Llama family, its KV caches, the
single-stream ``ServeEngine``, the continuous-batching engines (dense
and paged), speculative decoding, the SLO-aware front door, the router
over replicated front doors, long-context serving over a
sequence-parallel mesh (``longserve``), and the JAX weight bridge."""

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
from tpuslo_torch.models.batching import ContinuousBatchingEngine
from tpuslo_torch.models.paged_kv import PagedBatchingEngine
from tpuslo_torch.models.speculative import SpeculativeEngine
from tpuslo_torch.models.frontdoor import FrontDoorEngine, FrontDoorObserver
from tpuslo_torch.models.router import SLORouter
from tpuslo_torch.models import longserve

__all__ = [
    "GREEDY",
    "ContinuousBatchingEngine",
    "FrontDoorEngine",
    "FrontDoorObserver",
    "LlamaConfig",
    "PagedBatchingEngine",
    "SLORouter",
    "SamplingConfig",
    "ServeEngine",
    "SpeculativeEngine",
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
    "longserve",
    "prefill",
    "quantize_params",
    "sample_from_logits",
    "verify_chunk",
]
