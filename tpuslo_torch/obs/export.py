"""OTLP/HTTP traces exporter for the agent's own cycle spans.

Same hand-rolled style as the logs exporters (no OTel SDK): spans are
serialized to OTLP JSON ``resourceSpans`` and POSTed to a ``/v1/traces``
endpoint.  ``SpanExporter`` keeps the ``post_records`` contract of
``_BaseExporter``, so the existing :class:`OTLPRecordSink` adapter can
route the agent's own telemetry through a DeliveryChannel — spool,
breaker, and retry semantics apply to self-traces exactly as they do to
probe events.

The port's own copy of ``tpuslo/obs/export.py``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any

from tpuslo_torch.obs.tracer import STATUS_ERROR, Span
from tpuslo_torch.otel.exporters import (
    DEFAULT_SERVICE_NAME,
    DEFAULT_TIMEOUT_S,
    _BaseExporter,
    _str_attr,
)

# OTLP enums (trace.proto): SPAN_KIND_INTERNAL and STATUS_CODE_{OK,ERROR}.
SPAN_KIND_INTERNAL = 1
STATUS_CODE_OK = 1
STATUS_CODE_ERROR = 2


def trace_endpoint_from_logs(logs_endpoint: str) -> str:
    """Derive the sibling ``/v1/traces`` endpoint from a logs endpoint."""
    if not logs_endpoint:
        return ""
    if logs_endpoint.endswith("/v1/logs"):
        return logs_endpoint[: -len("/v1/logs")] + "/v1/traces"
    return logs_endpoint.rstrip("/") + "/v1/traces"


def _attr(key: str, value: Any) -> dict:
    """OTLP attribute with the value type inferred from the Python type."""
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def span_to_record(span: Span) -> dict:
    """One tracer span → one OTLP JSON span record."""
    record: dict[str, Any] = {
        "traceId": span.trace_id,
        "spanId": span.span_id,
        "name": span.name,
        "kind": SPAN_KIND_INTERNAL,
        "startTimeUnixNano": str(span.start_unix_nano),
        "endTimeUnixNano": str(span.end_unix_nano),
        "attributes": [_attr(k, v) for k, v in span.attributes.items()],
        "status": {
            "code": (
                STATUS_CODE_ERROR
                if span.status == STATUS_ERROR
                else STATUS_CODE_OK
            )
        },
    }
    if span.parent_span_id:
        record["parentSpanId"] = span.parent_span_id
    return record


class SpanExporter(_BaseExporter):
    """Batch exporter for self-tracing spans (OTLP/HTTP ``/v1/traces``)."""

    def __init__(
        self,
        endpoint: str,
        service_name: str = DEFAULT_SERVICE_NAME,
        scope_name: str = "tpuslo/obs",
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ):
        super().__init__(endpoint, service_name, scope_name, timeout_s)

    def _envelope(self, records: list[dict]) -> dict:
        return {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            _str_attr("service.name", self.service_name)
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": self.scope_name},
                            "spans": records,
                        }
                    ],
                }
            ]
        }

    def to_records(self, spans: list[Span]) -> list[dict]:
        return [span_to_record(s) for s in spans]

    def export_batch(self, spans: list[Span]) -> None:
        self._post(self.to_records(spans))


class BackgroundSpanPoster:
    """Non-blocking direct export for trace records when no
    DeliveryChannel exists (no spool dir configured).

    A synchronous HTTP POST inside the cycle's finish path would stall
    the agent loop for up to the exporter timeout per kept cycle when
    the traces endpoint is slow or down — self-telemetry must never
    block the loop it observes.  One daemon worker drains a bounded
    queue; when the queue is full the OLDEST batch is dropped (and
    counted): fresh traces beat stale ones, and self-traces are
    explicitly best-effort on this path (the channel path is the
    loss-free one).
    """

    def __init__(self, exporter: SpanExporter, queue_max: int = 64):
        self._exporter = exporter
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, queue_max))
        self._stop = object()
        self.stats = {"posted": 0, "dropped": 0, "errors": 0}
        self._thread = threading.Thread(
            target=self._run, name="obs-trace-poster", daemon=True
        )
        self._thread.start()

    def submit(self, records: list[dict]) -> None:
        """Enqueue one batch; never blocks the caller."""
        while True:
            try:
                self._queue.put_nowait(records)
                return
            except queue.Full:
                try:
                    self._queue.get_nowait()
                    self.stats["dropped"] += 1
                except queue.Empty:
                    pass

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is self._stop:
                return
            try:
                self._exporter.post_records(item)
                self.stats["posted"] += 1
            except Exception:  # noqa: BLE001 — worker must survive
                self.stats["errors"] += 1

    def close(self, timeout_s: float = 5.0) -> None:
        """Signal the worker and wait (bounded) for the queue to drain."""
        self.submit(self._stop)  # type: ignore[arg-type]
        self._thread.join(timeout=timeout_s)
