"""Serving models of the port: the Llama family, its KV caches, the
single-stream ``ServeEngine``, the continuous-batching engines (dense
and paged), speculative decoding, the SLO-aware front door, the router
over replicated front doors, long-context serving over a
sequence-parallel mesh (``longserve``), the JAX weight bridge, and
training (``train``, ``trainer``): on one device, over a dp/fsdp/tp mesh
(``build_sharded_train_step``) or, for the MoE family, a dp x ep one
(``mixtral.build_moe_train_step``)."""

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
from tpuslo_torch.models.train import build_sharded_train_step

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
    "build_sharded_train_step",
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
