"""Hand-rolled OTLP/HTTP logs exporters (no OTel SDK on the export path).

Reference: ``pkg/otel/{slo_event_exporter,probe_event_exporter}.go`` —
the agent ships JSON OTLP logs payloads directly to keep the export
path dependency-light; the demo workload is where full OTel tracing
lives.  Probe events additionally carry conn-tuple / errno / confidence
and (TPU-native) accelerator-identity attributes.

The port's own copy of ``tpuslo/otel/exporters.py``.
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.request

from tpuslo_torch.schema import ProbeEventV1, SLOEvent

DEFAULT_SERVICE_NAME = "tpuslo"
DEFAULT_TIMEOUT_S = 5.0


class ExportError(RuntimeError):
    """OTLP export failure; ``retryable`` feeds the delivery layer's
    retry / dead-letter verdict (4xx = poison payload, never retried)."""

    def __init__(self, message: str, retryable: bool = True):
        super().__init__(message)
        self.retryable = retryable


def _str_attr(key: str, value: str) -> dict:
    return {"key": key, "value": {"stringValue": value}}


def _double_attr(key: str, value: float) -> dict:
    return {"key": key, "value": {"doubleValue": float(value)}}


def _int_attr(key: str, value: int) -> dict:
    return {"key": key, "value": {"intValue": str(int(value))}}


def _severity(status: str) -> str:
    if status in ("breach", "error"):
        return "ERROR"
    if status == "warning":
        return "WARN"
    return "INFO"


class _BaseExporter:
    def __init__(
        self,
        endpoint: str,
        service_name: str = DEFAULT_SERVICE_NAME,
        scope_name: str = "",
        timeout_s: float = DEFAULT_TIMEOUT_S,
    ):
        self.endpoint = endpoint
        self.service_name = service_name or DEFAULT_SERVICE_NAME
        self.scope_name = scope_name
        self.timeout_s = timeout_s if timeout_s > 0 else DEFAULT_TIMEOUT_S

    def _envelope(self, records: list[dict]) -> dict:
        """OTLP envelope around pre-built records; subclasses that ship
        a different signal (traces) override only this."""
        return {
            "resourceLogs": [
                {
                    "resource": {
                        "attributes": [_str_attr("service.name", self.service_name)]
                    },
                    "scopeLogs": [
                        {
                            "scope": {"name": self.scope_name},
                            "logRecords": records,
                        }
                    ],
                }
            ]
        }

    def _post(self, records: list[dict]) -> None:
        if not records:
            return
        if not self.endpoint:
            raise ExportError("otlp endpoint is required", retryable=False)
        body = json.dumps(self._envelope(records)).encode()
        req = urllib.request.Request(
            self.endpoint,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                if not 200 <= resp.status < 300:
                    raise ExportError(f"otlp endpoint returned status {resp.status}")
        except urllib.error.HTTPError as exc:
            # 4xx = the payload itself is rejected; resending the same
            # bytes can never succeed, so mark it non-retryable — except
            # 429/408, which the OTLP/HTTP spec defines as retryable
            # (rate limiting / request timeout, not poison).
            raise ExportError(
                f"otlp endpoint returned status {exc.code}",
                retryable=(
                    not 400 <= exc.code < 500 or exc.code in (408, 429)
                ),
            ) from exc
        except TimeoutError as exc:
            raise ExportError(
                f"otlp post timed out after {self.timeout_s:.1f}s"
            ) from exc
        except urllib.error.URLError as exc:
            raise ExportError(f"otlp post failed: {exc.reason}") from exc
        except (http.client.HTTPException, OSError) as exc:
            # e.g. BadStatusLine / RemoteDisconnected when the endpoint
            # drops the connection mid-exchange: an outage, not poison.
            raise ExportError(f"otlp post failed: {exc!r}") from exc

    def post_records(self, records: list[dict]) -> None:
        """Ship pre-built OTLP log records (the delivery-channel path:
        records are built at submit time, spooled as plain JSON, and
        posted verbatim on delivery/replay)."""
        self._post(records)

    def close(self) -> None:
        """Stateless HTTP exporter: nothing pending, present for the
        EventWriters close contract."""


class SLOEventExporter(_BaseExporter):
    """Batch exporter for normalized SLO events."""

    def __init__(self, endpoint: str, service_name: str = DEFAULT_SERVICE_NAME,
                 scope_name: str = "tpuslo/collector", timeout_s: float = DEFAULT_TIMEOUT_S):
        super().__init__(endpoint, service_name, scope_name, timeout_s)

    def to_records(self, events: list[SLOEvent]) -> list[dict]:
        # One observation timestamp per batch: the whole batch is
        # observed by this call, and it keeps the hot loop clock-free.
        now_ns = time.time_ns()
        return [self._record(e, now_ns) for e in events]

    def export_batch(self, events: list[SLOEvent]) -> None:
        self._post(self.to_records(events))

    def _record(self, event: SLOEvent, now_ns: int | None = None) -> dict:
        now_ns = now_ns if now_ns is not None else time.time_ns()
        ts_ns = int(event.timestamp.timestamp() * 1e9) if event.timestamp else now_ns
        attrs = [
            _str_attr("event.id", event.event_id),
            _str_attr("cluster", event.cluster),
            _str_attr("namespace", event.namespace),
            _str_attr("workload", event.workload),
            _str_attr("service", event.service),
            _str_attr("request.id", event.request_id),
            _str_attr("trace.id", event.trace_id),
            _str_attr("sli.name", event.sli_name),
            _double_attr("sli.value", event.sli_value),
            _str_attr("sli.unit", event.unit),
            _str_attr("sli.status", event.status),
        ]
        attrs.extend(
            _str_attr(f"label.{key}", value) for key, value in event.labels.items()
        )
        return {
            "timeUnixNano": str(ts_ns),
            "observedTimeUnixNano": str(now_ns),
            "severityText": _severity(event.status),
            "body": {
                "stringValue": (
                    f"sli={event.sli_name} value={event.sli_value:.6f} "
                    f"status={event.status} service={event.service}"
                )
            },
            "attributes": attrs,
        }


class ProbeEventExporter(_BaseExporter):
    """Batch exporter for probe events (kernel + TPU signals)."""

    def __init__(self, endpoint: str, service_name: str = DEFAULT_SERVICE_NAME,
                 scope_name: str = "tpuslo/agent", timeout_s: float = DEFAULT_TIMEOUT_S):
        super().__init__(endpoint, service_name, scope_name, timeout_s)

    def to_records(self, events: list[ProbeEventV1]) -> list[dict]:
        now_ns = time.time_ns()
        return [self._record(e, now_ns) for e in events]

    def export_batch(self, events: list[ProbeEventV1]) -> None:
        self._post(self.to_records(events))

    def _record(self, event: ProbeEventV1, now_ns: int | None = None) -> dict:
        now_ns = now_ns if now_ns is not None else time.time_ns()
        attrs = [
            _str_attr("signal", event.signal),
            _str_attr("node", event.node),
            _str_attr("namespace", event.namespace),
            _str_attr("pod", event.pod),
            _str_attr("container", event.container),
            _int_attr("pid", event.pid),
            _int_attr("tid", event.tid),
            _double_attr("value", event.value),
            _str_attr("unit", event.unit),
            _str_attr("status", event.status),
        ]
        if event.trace_id:
            attrs.append(_str_attr("trace.id", event.trace_id))
        if event.span_id:
            attrs.append(_str_attr("span.id", event.span_id))
        if event.conn_tuple is not None:
            attrs.append(_str_attr("conn.tuple", event.conn_tuple.key()))
        if event.errno is not None:
            attrs.append(_int_attr("errno", event.errno))
        if event.confidence is not None:
            attrs.append(_double_attr("correlation.confidence", event.confidence))
        if event.tpu is not None:
            tpu = event.tpu
            if tpu.chip:
                attrs.append(_str_attr("tpu.chip", tpu.chip))
            if tpu.slice_id:
                attrs.append(_str_attr("tpu.slice_id", tpu.slice_id))
            if tpu.host_index >= 0:
                attrs.append(_int_attr("tpu.host_index", tpu.host_index))
            if tpu.ici_link >= 0:
                attrs.append(_int_attr("tpu.ici_link", tpu.ici_link))
            if tpu.program_id:
                attrs.append(_str_attr("tpu.xla.program_id", tpu.program_id))
            if tpu.launch_id >= 0:
                attrs.append(_int_attr("tpu.xla.launch_id", tpu.launch_id))
        return {
            "timeUnixNano": str(event.ts_unix_nano),
            "observedTimeUnixNano": str(now_ns),
            "severityText": _severity(event.status),
            "body": {
                "stringValue": (
                    f"signal={event.signal} value={event.value:.6f} "
                    f"status={event.status} node={event.node}"
                )
            },
            "attributes": attrs,
        }
