"""Raw-sample → SLOEvent normalization.

Reference: ``pkg/collector/pipeline.go:28-86`` — each raw request sample
fans out into four first-class SLO events with fixed SLI thresholds
(ttft 500/1000 ms, latency 700/1500 ms, throughput 30/10 tps inverse,
error-rate 0.02/0.05).

The port's own copy of ``tpuslo/collector/pipeline.py``.
"""

from __future__ import annotations

from tpuslo_torch.collector.synthetic import RawSample
from tpuslo_torch.schema import SLOEvent

# (warning, breach) thresholds per SLI; throughput is inverse (lower=worse).
TTFT_THRESHOLDS = (500.0, 1000.0)
LATENCY_THRESHOLDS = (700.0, 1500.0)
THROUGHPUT_THRESHOLDS = (30.0, 10.0)
ERROR_RATE_THRESHOLDS = (0.02, 0.05)


def threshold_status(value: float, warning: float, breach: float) -> str:
    if value >= breach:
        return "breach"
    if value >= warning:
        return "warning"
    return "ok"


def inverse_threshold_status(value: float, warning: float, breach: float) -> str:
    if value <= breach:
        return "breach"
    if value <= warning:
        return "warning"
    return "ok"


def normalize_sample(sample: RawSample) -> list[SLOEvent]:
    """Convert one raw sample into four schema-validated SLO events."""
    rows = (
        ("ttft_ms", sample.ttft_ms, "ms",
         threshold_status(sample.ttft_ms, *TTFT_THRESHOLDS)),
        ("request_latency_ms", sample.request_latency_ms, "ms",
         threshold_status(sample.request_latency_ms, *LATENCY_THRESHOLDS)),
        ("token_throughput_tps", sample.token_throughput_tps, "tps",
         inverse_threshold_status(sample.token_throughput_tps, *THROUGHPUT_THRESHOLDS)),
        ("error_rate", sample.error_rate, "ratio",
         threshold_status(sample.error_rate, *ERROR_RATE_THRESHOLDS)),
    )
    labels = {"source": "synthetic"}
    if sample.node:
        labels["node"] = sample.node
    if sample.fault_label:
        labels["fault_label"] = sample.fault_label

    return [
        SLOEvent(
            event_id=f"{sample.request_id}-{sli}",
            timestamp=sample.timestamp,
            cluster=sample.cluster,
            namespace=sample.namespace,
            workload=sample.workload,
            service=sample.service,
            request_id=sample.request_id,
            trace_id=sample.trace_id,
            sli_name=sli,
            sli_value=value,
            unit=unit,
            status=status,
            labels=dict(labels),
        )
        for sli, value, unit, status in rows
    ]
