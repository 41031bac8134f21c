"""Deterministic fault-sample replay (the port's own copy of
``tpuslo/faultreplay/generator.py``) and the per-host slice streams
(:mod:`.slice_streams`, a copy of ``tpuslo/faultreplay/slice_streams.py``)."""

from tpuslo_torch.faultreplay.generator import (
    MULTI_FAULT_PAIRS,
    TPU_MULTI_FAULT_PAIRS,
    generate_fault_samples,
    supported_scenarios,
)

__all__ = [
    "MULTI_FAULT_PAIRS",
    "TPU_MULTI_FAULT_PAIRS",
    "generate_fault_samples",
    "supported_scenarios",
]
