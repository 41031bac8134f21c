"""Self-observability of the port: the recording ``SelfTracer`` (tail
sampling, the overhead gate) and the null cycle the untraced serving
step runs under (the port's own copy of ``tpuslo/obs/tracer.py``)."""

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
    "SelfTracer",
    "Span",
    "TraceObserver",
    "TracerConfig",
    "new_span_id",
    "new_trace_id",
]
