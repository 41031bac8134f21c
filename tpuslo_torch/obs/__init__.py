"""Self-observability of the port: the recording ``SelfTracer`` (tail
sampling, the overhead gate) and the null cycle the untraced serving
step runs under (the port's own copy of ``tpuslo/obs/tracer.py``), and
the incident provenance log the remediation engine appends to (its copy
of ``tpuslo/obs/provenance.py``)."""

from tpuslo_torch.obs.provenance import (
    EvidenceEvent,
    ProvenanceLog,
    ProvenanceRecord,
    format_chain,
    load_records,
    probe_event_id,
)
from tpuslo_torch.obs.tracer import (
    CYCLE_STAGES,
    DROPPED,
    KEPT_ERROR,
    KEPT_FORCED,
    KEPT_PROBABILISTIC,
    KEPT_SLOW,
    CycleTrace,
    SelfTracer,
    Span,
    TraceObserver,
    TracerConfig,
    new_span_id,
    new_trace_id,
)

__all__ = [
    "CYCLE_STAGES",
    "DROPPED",
    "KEPT_ERROR",
    "KEPT_FORCED",
    "KEPT_PROBABILISTIC",
    "KEPT_SLOW",
    "CycleTrace",
    "EvidenceEvent",
    "ProvenanceLog",
    "ProvenanceRecord",
    "SelfTracer",
    "Span",
    "TraceObserver",
    "TracerConfig",
    "format_chain",
    "load_records",
    "new_span_id",
    "new_trace_id",
    "probe_event_id",
]
