"""The port's process-wide counters: rejections by (stage, reason) and
the contract validator's fast-path tallies.  The Prometheus registry
(``tpuslo/metrics/registry.py``) comes with the agent process."""

from tpuslo_torch.metrics.rejections import REJECTION_COUNTERS, RejectionCounters
from tpuslo_torch.schema.fastpath import VALIDATION_COUNTERS, ValidationCounters

__all__ = [
    "REJECTION_COUNTERS",
    "RejectionCounters",
    "VALIDATION_COUNTERS",
    "ValidationCounters",
]
