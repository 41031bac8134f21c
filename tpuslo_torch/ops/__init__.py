"""Kernels of the port: each a hand-written Hopper kernel with its plain
PyTorch version beside it (attention here; the batch-invariant RMSNorm in
:mod:`tpuslo_torch.ops.rms_norm`), plus the dense cache read as K2's
lanes and the ring attention of sequence parallelism (plain PyTorch, as
JAX's is outside any Pallas kernel)."""

from tpuslo_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_eligible,
)
from tpuslo_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)
from tpuslo_torch.ops.dense_lanes import dense_lane_attention
from tpuslo_torch.ops.ring_attention import ring_attention, ring_attention_sharded

__all__ = [
    "dense_lane_attention",
    "flash_attention",
    "flash_attention_reference",
    "flash_eligible",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "ring_attention",
    "ring_attention_sharded",
]
