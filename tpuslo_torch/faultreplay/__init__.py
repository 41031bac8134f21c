"""Deterministic fault-sample replay (the port's own copy of
``tpuslo/faultreplay/generator.py``; the JAX package's slice-stream
synthesizer is not ported)."""

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
