"""Batch span-enrichment processor: joins probe signals onto serving spans
(the port's own copy of ``tpuslo/otel/processor/correlator.py``, over the
port's semconv and matcher).

Reference: ``pkg/otel/processor/ebpfcorrelator/{correlator,processor}.go``
— confidence filter, join-fanout cap 3, signal→semconv attribute
mapping, retrieval decomposition, and per-batch debug stats.  The
TPU-native build adds TPU signal attributes and a device-side
decomposition (``llm.tpu.kernel_attributed_ms``) that tells operators
what fraction of a generation span is attributable to TPU-observable
stalls.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime

from tpuslo_torch import semconv
from tpuslo_torch.correlation.matcher import (
    DEFAULT_ENRICHMENT_THRESHOLD,
    DEFAULT_WINDOW_MS,
    Decision,
    SignalRef,
    SpanRef,
    match,
)

DEFAULT_MAX_JOIN_FANOUT = 3


@dataclass
class DebugStats:
    """Non-enriched correlation outcomes, for diagnostics."""

    unmatched: int = 0
    low_confidence: int = 0
    fanout_dropped: int = 0
    unsupported_type: int = 0

    def merge(self, other: "DebugStats") -> "DebugStats":
        return DebugStats(
            unmatched=self.unmatched + other.unmatched,
            low_confidence=self.low_confidence + other.low_confidence,
            fanout_dropped=self.fanout_dropped + other.fanout_dropped,
            unsupported_type=self.unsupported_type + other.unsupported_type,
        )


@dataclass
class Candidate:
    signal: SignalRef
    decision: Decision


@dataclass
class EnrichmentResult:
    attributes: dict[str, float]
    candidates: list[Candidate]
    debug: DebugStats


@dataclass
class SpanRecord:
    """Lightweight span representation for batch correlation."""

    trace_id: str = ""
    span_id: str = ""
    service: str = ""
    node: str = ""
    pod: str = ""
    pid: int = 0
    conn_tuple: str = ""
    timestamp: datetime | None = None
    slice_id: str = ""
    host_index: int = -1
    program_id: str = ""
    launch_id: int = -1
    attributes: dict[str, float] = field(default_factory=dict)

    def to_span_ref(self) -> SpanRef:
        return SpanRef(
            timestamp=self.timestamp,
            trace_id=self.trace_id,
            service=self.service,
            node=self.node,
            pod=self.pod,
            pid=self.pid,
            conn_tuple=self.conn_tuple,
            slice_id=self.slice_id,
            host_index=self.host_index,
            program_id=self.program_id,
            launch_id=self.launch_id,
        )


@dataclass
class ProcessedBatch:
    spans: list[SpanRecord]
    debug: DebugStats


class Correlator:
    """Span enrichment with confidence filtering and fanout capping."""

    def __init__(
        self,
        window_ms: int = DEFAULT_WINDOW_MS,
        enrichment_threshold: float = DEFAULT_ENRICHMENT_THRESHOLD,
        max_join_fanout: int = DEFAULT_MAX_JOIN_FANOUT,
    ):
        self.window_ms = window_ms
        self.enrichment_threshold = enrichment_threshold
        self.max_join_fanout = max_join_fanout

    def enrich_attributes(
        self,
        base: dict[str, float] | None,
        span: SpanRef,
        signals: list[SignalRef],
    ) -> EnrichmentResult:
        """Enrich one span from a signal set."""
        threshold = (
            self.enrichment_threshold
            if self.enrichment_threshold > 0
            else DEFAULT_ENRICHMENT_THRESHOLD
        )
        fanout = self.max_join_fanout if self.max_join_fanout > 0 else 3

        out = dict(base or {})
        debug = DebugStats()
        candidates: list[Candidate] = []

        for signal in signals:
            if signal.signal not in semconv.SIGNAL_ATTR_KEYS:
                debug.unsupported_type += 1
                continue
            decision = match(span, signal, self.window_ms)
            if not decision.matched:
                debug.unmatched += 1
                continue
            if decision.confidence < threshold:
                debug.low_confidence += 1
                continue
            candidates.append(Candidate(signal, decision))

        def sort_key(c: Candidate):
            distance = (
                abs((span.timestamp - c.signal.timestamp).total_seconds())
                if span.timestamp and c.signal.timestamp
                else float("inf")
            )
            return (-c.decision.confidence, distance)

        candidates.sort(key=sort_key)
        if len(candidates) > fanout:
            debug.fanout_dropped = len(candidates) - fanout
            candidates = candidates[:fanout]

        max_confidence = 0.0
        best_tier = ""
        for candidate in candidates:
            attr = semconv.SIGNAL_ATTR_KEYS[candidate.signal.signal]
            if attr not in out or candidate.signal.value > out[attr]:
                out[attr] = candidate.signal.value
            if candidate.decision.confidence > max_confidence:
                max_confidence = candidate.decision.confidence
                best_tier = candidate.decision.tier
        if max_confidence > 0:
            out[semconv.ATTR_CORRELATION_CONF] = max_confidence
            _ = best_tier  # tier exposed via candidates; attrs stay numeric

        return EnrichmentResult(out, candidates, debug)

    def enrich_dns_attributes(
        self,
        base: dict[str, float] | None,
        span: SpanRef,
        signal: SignalRef,
    ) -> tuple[dict[str, float], Decision]:
        """Single-signal convenience wrapper used by the demo service."""
        result = self.enrich_attributes(base, span, [signal])
        if not result.candidates:
            return result.attributes, Decision()
        return result.attributes, result.candidates[0].decision

    def process_batch(
        self, spans: list[SpanRecord], signals: list[SignalRef]
    ) -> ProcessedBatch:
        """Apply enrichment + decompositions over a span batch."""
        out = ProcessedBatch(spans=[], debug=DebugStats())
        for record in spans:
            enriched = self.enrich_attributes(
                record.attributes, record.to_span_ref(), signals
            )
            decompose_retrieval(enriched.attributes)
            decompose_tpu(enriched.attributes)
            record.attributes = enriched.attributes
            out.spans.append(record)
            out.debug = out.debug.merge(enriched.debug)
        return out


def decompose_retrieval(attrs: dict[str, float]) -> float:
    """Sum kernel-attributed retrieval components (DNS+connect+TLS).

    Reference: ``ebpfcorrelator/correlator.go:179-194``.
    """
    total = sum(
        attrs.get(key, 0.0)
        for key in (
            semconv.ATTR_DNS_LATENCY_MS,
            semconv.ATTR_CONNECT_LATENCY_MS,
            semconv.ATTR_TLS_HANDSHAKE_MS,
        )
    )
    if total > 0:
        attrs[semconv.ATTR_RETRIEVAL_KERNEL_MS] = total
    return total


def decompose_tpu(attrs: dict[str, float]) -> float:
    """Sum TPU-attributed generation stall components.

    Compile wait + HBM allocation stall + collective latency + host
    offload stall — the device-side analogue of retrieval
    decomposition for the generation span.
    """
    total = sum(
        attrs.get(key, 0.0)
        for key in (
            semconv.ATTR_XLA_COMPILE_MS,
            semconv.ATTR_HBM_ALLOC_STALL_MS,
            semconv.ATTR_ICI_COLLECTIVE_MS,
            semconv.ATTR_HOST_OFFLOAD_STALL_MS,
        )
    )
    if total > 0:
        attrs[semconv.ATTR_TPU_KERNEL_MS] = total
    return total
