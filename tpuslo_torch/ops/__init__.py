"""Attention kernels of the port: each a hand-written Hopper kernel with
its plain PyTorch version beside it."""

from tpuslo_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_eligible,
)

__all__ = ["flash_attention", "flash_attention_reference", "flash_eligible"]
