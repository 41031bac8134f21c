"""L5 correlation: the tiered span-signal matcher and the multi-host
slice joiner (:mod:`.multihost`).  The quality gates (``evaluator.py``)
and the retry-storm detector of ``tpuslo/correlation/`` are not ported
yet."""

from tpuslo_torch.correlation.matcher import (
    DEFAULT_ENRICHMENT_THRESHOLD,
    DEFAULT_WINDOW_MS,
    MISSING_TS_CONFIDENCE,
    TIER_CONFIDENCE,
    TIER_POD_CONN,
    TIER_POD_PID,
    TIER_SERVICE_NODE,
    TIER_SLICE_HOST,
    TIER_TRACE_ID,
    TIER_XLA_LAUNCH,
    BatchMatch,
    Decision,
    SignalRef,
    SpanRef,
    enrich_dns,
    match,
    match_batch,
)

__all__ = [
    "DEFAULT_ENRICHMENT_THRESHOLD",
    "DEFAULT_WINDOW_MS",
    "MISSING_TS_CONFIDENCE",
    "TIER_CONFIDENCE",
    "TIER_POD_CONN",
    "TIER_POD_PID",
    "TIER_SERVICE_NODE",
    "TIER_SLICE_HOST",
    "TIER_TRACE_ID",
    "TIER_XLA_LAUNCH",
    "BatchMatch",
    "Decision",
    "SignalRef",
    "SpanRef",
    "enrich_dns",
    "match",
    "match_batch",
]
