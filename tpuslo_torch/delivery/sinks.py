"""Adapters from the toolkit's exporters to the delivery Sink protocol.

Kept out of ``tpuslo.delivery.__init__`` on purpose: the webhook
exporter imports the delivery package for its jitter helper, so this
module (which imports the exporters back) must only be pulled in by the
CLI wiring layer.

The port's own copy of ``tpuslo/delivery/sinks.py``.
"""

from __future__ import annotations

import json

from tpuslo_torch.delivery.channel import SinkError
from tpuslo_torch.otel.exporters import ExportError, _BaseExporter
from tpuslo_torch.webhook.exporter import Exporter as WebhookExporter
from tpuslo_torch.webhook.exporter import WebhookError


class OTLPRecordSink:
    """Posts pre-built OTLP log records through a logs exporter."""

    def __init__(self, exporter: _BaseExporter):
        self.exporter = exporter

    def send(self, kind: str, payloads: list[dict]) -> None:
        try:
            self.exporter.post_records(payloads)
        except ExportError as exc:
            raise SinkError(str(exc), retryable=exc.retryable) from exc


class WebhookSink:
    """Posts pre-built (already formatted) webhook payload dicts.

    The channel spools payloads as JSON, so the HMAC signature is
    computed at post time over the re-serialized bytes — replayed
    incidents stay verifiable.
    """

    def __init__(self, exporter: WebhookExporter):
        self.exporter = exporter

    def send(self, kind: str, payloads: list[dict]) -> None:
        for payload in payloads:
            body = json.dumps(payload).encode()
            try:
                self.exporter.post_payload(body)
            except WebhookError as exc:
                raise SinkError(str(exc), retryable=exc.retryable) from exc
