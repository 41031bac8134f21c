from tpuslo_torch.slo.calculator import (
    Percentiles,
    RetrievalBreakdown,
    Snapshot,
    Timing,
    aggregate,
    calculate,
    quantile,
    tokens_per_second,
    total_retrieval_ms,
    ttft_ms,
)

__all__ = [
    "Percentiles",
    "RetrievalBreakdown",
    "Snapshot",
    "Timing",
    "aggregate",
    "calculate",
    "quantile",
    "tokens_per_second",
    "total_retrieval_ms",
    "ttft_ms",
]
