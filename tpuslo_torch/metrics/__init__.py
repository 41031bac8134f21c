"""The port's process-wide counters (rejections by (stage, reason), the
contract validator's fast-path tallies) and the agent's Prometheus
registry, readiness checks and metrics server (its own copy of
``tpuslo/metrics/registry.py``)."""

from tpuslo_torch.metrics.registry import (
    AgentMetrics,
    Readiness,
    start_metrics_server,
)
from tpuslo_torch.metrics.rejections import REJECTION_COUNTERS, RejectionCounters
from tpuslo_torch.schema.fastpath import VALIDATION_COUNTERS, ValidationCounters

__all__ = [
    "AgentMetrics",
    "Readiness",
    "start_metrics_server",
    "REJECTION_COUNTERS",
    "RejectionCounters",
    "VALIDATION_COUNTERS",
    "ValidationCounters",
]
