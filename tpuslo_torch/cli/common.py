"""Shared CLI plumbing: event sinks and config resolution.

The port's own copy of ``tpuslo/cli/common.py``.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import IO, Any, Callable

from tpuslo_torch.config import ToolkitConfig, default_config, load_config
from tpuslo_torch.delivery import DeliveryChannel, DeliveryObserver, DeliveryOptions
from tpuslo_torch.otel.exporters import ProbeEventExporter, SLOEventExporter
from tpuslo_torch.schema import (
    SCHEMA_SLO_EVENT,
    ProbeEventV1,
    SLOEvent,
    SchemaValidationError,
    validate,
    validate_probe_event,
)

OUTPUT_STDOUT = "stdout"
OUTPUT_JSONL = "jsonl"
OUTPUT_OTLP = "otlp"


class EventWriters:
    """Multiplexed event sink: stdout JSON, JSONL file, or OTLP/HTTP.

    Reference: ``cmd/agent/main.go:68-135`` (outputWriters).
    Thread-safe for the agent's concurrent emit paths.

    With ``delivery`` enabled (a spool dir is configured), the OTLP
    network sinks route through per-sink :class:`DeliveryChannel`\\ s:
    ``emit_*`` becomes non-blocking and loss-free (queue → retry →
    breaker → disk spool → replay) instead of raising on sink failure.
    Local sinks (stdout/JSONL) stay synchronous — they fail only with
    the node itself.
    """

    def __init__(
        self,
        output: str = OUTPUT_STDOUT,
        jsonl_path: str = "",
        otlp_endpoint: str = "",
        stream: IO[str] | None = None,
        delivery: DeliveryOptions | None = None,
        observer_factory: Callable[[str], DeliveryObserver] | None = None,
    ):
        self.output = output
        self._lock = threading.Lock()
        self._stream = stream or sys.stdout
        self._jsonl: IO[str] | None = None
        self._slo_exporter: SLOEventExporter | None = None
        self._probe_exporter: ProbeEventExporter | None = None
        self._slo_channel: DeliveryChannel | None = None
        self._probe_channel: DeliveryChannel | None = None
        self._closed = False
        self.jsonl_repaired_bytes = 0
        if output == OUTPUT_JSONL:
            if not jsonl_path:
                raise ValueError("jsonl output requires --jsonl-path")
            # A previous incarnation killed mid-write leaves a torn
            # final line; appending to it would weld two records into
            # one corrupt mid-file line.  Truncate the tear first.
            from tpuslo_torch.runtime import repair_jsonl_tail

            self.jsonl_repaired_bytes = repair_jsonl_tail(jsonl_path)
            self._jsonl = open(jsonl_path, "a", encoding="utf-8")
        elif output == OUTPUT_OTLP:
            if not otlp_endpoint:
                raise ValueError("otlp output requires an endpoint")
            self._slo_exporter = SLOEventExporter(otlp_endpoint)
            self._probe_exporter = ProbeEventExporter(otlp_endpoint)
            if delivery is not None and delivery.enabled:
                from tpuslo_torch.delivery.sinks import OTLPRecordSink

                observer_factory = observer_factory or (
                    lambda name: DeliveryObserver()
                )
                self._slo_channel = delivery.build_channel(
                    "otlp-slo",
                    OTLPRecordSink(self._slo_exporter),
                    observer=observer_factory("otlp-slo"),
                )
                self._probe_channel = delivery.build_channel(
                    "otlp-probe",
                    OTLPRecordSink(self._probe_exporter),
                    observer=observer_factory("otlp-probe"),
                )
        elif output != OUTPUT_STDOUT:
            raise ValueError(f"unsupported output {output!r}")

    def _write_line(self, payload: dict[str, Any]) -> None:
        self._write_batch([payload])

    def _write_batch(self, payloads: list[dict[str, Any]]) -> None:
        """Serialize once per payload, then one buffered write + flush.

        Per-event write/flush under the lock was the export-side
        bottleneck on the probe spine; a flush per *batch* keeps the
        durability contract at the emit-cycle granularity the agent
        actually operates at.
        """
        if not payloads:
            return
        dumps = json.dumps
        block = "".join(
            dumps(payload, separators=(",", ":")) + "\n" for payload in payloads
        )
        with self._lock:
            sink = self._jsonl if self._jsonl is not None else self._stream
            sink.write(block)
            sink.flush()

    def emit_slo(self, events: list[SLOEvent]) -> None:
        if self._slo_channel is not None:
            if events:
                self._slo_channel.submit(
                    "slo", self._slo_exporter.to_records(events)
                )
            return
        if self._slo_exporter is not None:
            self._slo_exporter.export_batch(events)
            return
        self._write_batch([{"kind": "slo", **event.to_dict()} for event in events])

    def emit_probe(self, events: list[ProbeEventV1]) -> None:
        if self._probe_channel is not None:
            if events:
                self._probe_channel.submit(
                    "probe", self._probe_exporter.to_records(events)
                )
            return
        if self._probe_exporter is not None:
            self._probe_exporter.export_batch(events)
            return
        self._write_batch(
            [{"kind": "probe", **event.to_dict()} for event in events]
        )

    def write_probe_block(self, block: str) -> bool:
        """Emit a pre-serialized JSONL block (columnar fast path).

        The columnar spine serializes whole batches without building
        per-event dicts (``tpuslo.columnar.serialize``); local sinks
        take the block as-is with the usual one-write-one-flush
        contract.  Returns False when the active sink is OTLP — those
        exporters need typed records, so the caller must fall back to
        the ``to_rows`` adapter + :meth:`emit_probe`.
        """
        if self._probe_channel is not None or self._probe_exporter is not None:
            return False
        if not block:
            return True
        with self._lock:
            sink = self._jsonl if self._jsonl is not None else self._stream
            sink.write(block)
            sink.flush()
        return True

    @property
    def delivery_channels(self) -> list[DeliveryChannel]:
        return [c for c in (self._slo_channel, self._probe_channel) if c]

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Drain delivery queues and flush the active local stream."""
        ok = True
        for channel in self.delivery_channels:
            ok = channel.flush(timeout_s) and ok
        with self._lock:
            sink = self._jsonl if self._jsonl is not None else self._stream
            if not sink.closed:
                sink.flush()
        return ok

    def close(self, flush_timeout_s: float = 10.0) -> None:
        """Flush then release every sink; safe to call more than once.

        ``flush_timeout_s`` bounds the final flush of ALL delivery
        channels together (one deadline, not one per channel — the
        drain path shares it with the rest of shutdown); batches still
        queued when it expires are spilled to the spool, never
        dropped.
        """
        if self._closed:
            return
        self._closed = True
        deadline = time.monotonic() + flush_timeout_s
        for channel in self.delivery_channels:
            channel.close(
                flush_timeout_s=max(0.0, deadline - time.monotonic())
            )
        for exporter in (self._slo_exporter, self._probe_exporter):
            if exporter is not None:
                exporter.close()
        if self._jsonl is not None:
            self._jsonl.flush()
            self._jsonl.close()
        elif self._stream is not sys.stdout and not self._stream.closed:
            self._stream.flush()


def resolve_config(path: str) -> ToolkitConfig:
    """Config-file layer of the CLI > config > defaults precedence."""
    if path:
        return load_config(path)
    return default_config()


def validate_slo(event: SLOEvent) -> bool:
    try:
        validate(event.to_dict(), SCHEMA_SLO_EVENT)
        return True
    except SchemaValidationError:
        return False


def validate_probe(event: ProbeEventV1) -> bool:
    # Structural fast path on the known ProbeEventV1 shape; precompiled
    # jsonschema fallback keeps the answer exactly contract-equal (see
    # tpuslo/schema/fastpath.py and tests/test_validator_fastpath.py).
    return validate_probe_event(event)
