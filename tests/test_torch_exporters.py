"""``tests/test_exporters.py`` run on the port's OTLP exporters and webhook
(``tpuslo_torch/otel/exporters.py``, ``tpuslo_torch/webhook``): the same
cases, importing ``tpuslo_torch`` where the JAX package's tests import
``tpuslo``.

The JAX package's test says:

OTLP exporter + webhook delivery tests against a local HTTP stub.

Reference model: pkg/otel/*_test.go and pkg/webhook/exporter_test.go
(httptest servers with HMAC verification).
"""

import json
import threading
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from tpuslo_torch import schema, webhook
from tpuslo_torch.otel.exporters import ExportError, ProbeEventExporter, SLOEventExporter

TS = datetime(2026, 7, 29, 12, 0, 0, tzinfo=timezone.utc)


class StubHandler(BaseHTTPRequestHandler):
    status_code = 202

    def do_POST(self):
        if self.server.hang_s:
            import time

            time.sleep(self.server.hang_s)
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        self.server.requests.append(
            {"path": self.path, "headers": dict(self.headers), "body": body}
        )
        code = self.server.status_codes.pop(0) if self.server.status_codes else self.server.default_status
        self.send_response(code)
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *args):
        pass


@pytest.fixture
def stub_server():
    server = HTTPServer(("127.0.0.1", 0), StubHandler)
    server.requests = []
    server.status_codes = []
    server.default_status = 202
    server.hang_s = 0.0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server
    server.shutdown()
    server.server_close()


def make_slo_event():
    return schema.SLOEvent(
        event_id="req-1-ttft_ms",
        timestamp=TS,
        cluster="c",
        namespace="n",
        workload="w",
        service="s",
        request_id="req-1",
        sli_name="ttft_ms",
        sli_value=340.0,
        unit="ms",
        status="breach",
        labels={"fault_label": "dns_latency"},
    )


def make_probe_event():
    return schema.ProbeEventV1(
        ts_unix_nano=int(TS.timestamp() * 1e9),
        signal="hbm_alloc_stall_ms",
        node="tpu-vm-0",
        namespace="llm",
        pod="rag",
        container="rag",
        pid=1,
        tid=1,
        value=60.0,
        unit="ms",
        status="error",
        tpu=schema.TPURef(chip="accel0", slice_id="s0", host_index=0, launch_id=7),
    )


def make_attr():
    return schema.IncidentAttribution(
        incident_id="inc-1",
        timestamp=TS,
        cluster="c",
        service="s",
        predicted_fault_domain="tpu_hbm",
        confidence=0.93,
        evidence=[schema.Evidence("hbm_alloc_stall_ms", 60.0, "libtpu")],
        slo_impact=schema.SLOImpact("ttft_ms", 3.5, 5),
    )


class TestSLOEventExporter:
    def test_export_batch_payload_shape(self, stub_server):
        exporter = SLOEventExporter(
            f"http://127.0.0.1:{stub_server.server_port}/v1/logs"
        )
        exporter.export_batch([make_slo_event()])
        assert len(stub_server.requests) == 1
        payload = json.loads(stub_server.requests[0]["body"])
        record = payload["resourceLogs"][0]["scopeLogs"][0]["logRecords"][0]
        assert record["severityText"] == "ERROR"
        attrs = {a["key"]: a["value"] for a in record["attributes"]}
        assert attrs["sli.name"]["stringValue"] == "ttft_ms"
        assert attrs["sli.value"]["doubleValue"] == 340.0
        assert attrs["label.fault_label"]["stringValue"] == "dns_latency"

    def test_empty_batch_no_post(self, stub_server):
        exporter = SLOEventExporter(
            f"http://127.0.0.1:{stub_server.server_port}/v1/logs"
        )
        exporter.export_batch([])
        assert stub_server.requests == []

    def test_server_error_raises(self, stub_server):
        stub_server.status_codes = [500]
        exporter = SLOEventExporter(
            f"http://127.0.0.1:{stub_server.server_port}/v1/logs"
        )
        with pytest.raises(ExportError):
            exporter.export_batch([make_slo_event()])

    def test_missing_endpoint_raises(self):
        with pytest.raises(ExportError):
            SLOEventExporter("").export_batch([make_slo_event()])

    def test_retryability_classification(self, stub_server):
        exporter = SLOEventExporter(
            f"http://127.0.0.1:{stub_server.server_port}/v1/logs"
        )
        # 429 (rate limiting) is retryable per OTLP/HTTP; 400 is poison.
        for code, retryable in ((429, True), (408, True), (400, False),
                                (500, True)):
            stub_server.status_codes = [code]
            with pytest.raises(ExportError) as err:
                exporter.export_batch([make_slo_event()])
            assert err.value.retryable is retryable, code


class TestProbeEventExporter:
    def test_tpu_attributes_exported(self, stub_server):
        exporter = ProbeEventExporter(
            f"http://127.0.0.1:{stub_server.server_port}/v1/logs"
        )
        exporter.export_batch([make_probe_event()])
        payload = json.loads(stub_server.requests[0]["body"])
        record = payload["resourceLogs"][0]["scopeLogs"][0]["logRecords"][0]
        attrs = {a["key"]: a["value"] for a in record["attributes"]}
        assert attrs["tpu.chip"]["stringValue"] == "accel0"
        assert attrs["tpu.xla.launch_id"]["intValue"] == "7"
        assert attrs["signal"]["stringValue"] == "hbm_alloc_stall_ms"
        assert record["timeUnixNano"] == str(int(TS.timestamp() * 1e9))


class TestWebhook:
    def test_generic_delivery_with_hmac(self, stub_server):
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook",
            secret="s3cret",
        )
        exporter.send(make_attr())
        req = stub_server.requests[0]
        signature = req["headers"]["X-Webhook-Signature"]
        assert signature.startswith("sha256=")
        assert webhook.verify_hmac(req["body"], "s3cret", signature)
        assert not webhook.verify_hmac(req["body"], "wrong", signature)
        body = json.loads(req["body"])
        assert body["predicted_fault_domain"] == "tpu_hbm"

    def test_retry_on_5xx_then_success(self, stub_server):
        stub_server.status_codes = [500, 202]
        sleeps = []
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook",
            sleep=sleeps.append,
            rng=lambda: 1.0,  # pin full jitter to its upper bound
        )
        exporter.send(make_attr())
        assert len(stub_server.requests) == 2
        assert sleeps == [1.0]

    def test_backoff_jitter_and_cap(self, stub_server):
        # 5 attempts with rng pinned high: un-capped exponential would
        # sleep [1, 2, 4, 8]; the default 8s cap must clamp the tail,
        # and jitter must scale the whole delay.
        stub_server.status_codes = [500] * 5
        sleeps = []
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook",
            max_retry=5,
            max_delay_s=4.0,
            sleep=sleeps.append,
            rng=lambda: 0.5,
        )
        with pytest.raises(webhook.WebhookError, match="after 5 attempts"):
            exporter.send(make_attr())
        assert sleeps == [0.5, 1.0, 2.0, 2.0]  # 0.5 * min(4, 2^n)

    def test_timeout_is_retryable(self, stub_server):
        # A hang past the client timeout must classify as an explicitly
        # retryable WebhookError, not an opaque URLError string.
        stub_server.hang_s = 0.5
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook",
            timeout_ms=100,
            max_retry=1,
            sleep=lambda _: None,
        )
        with pytest.raises(webhook.WebhookError, match="timed out"):
            exporter.send(make_attr())

    def test_429_is_retryable(self, stub_server):
        stub_server.status_codes = [429, 202]
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook",
            sleep=lambda _: None,
        )
        exporter.send(make_attr())  # throttled once, then delivered
        assert len(stub_server.requests) == 2

    def test_4xx_not_retried(self, stub_server):
        stub_server.status_codes = [400]
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook", sleep=lambda _: None
        )
        with pytest.raises(webhook.WebhookError) as err:
            exporter.send(make_attr())
        assert not err.value.retryable
        assert len(stub_server.requests) == 1

    def test_exhausted_retries_raise(self, stub_server):
        stub_server.status_codes = [500, 500, 500]
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook", sleep=lambda _: None
        )
        with pytest.raises(webhook.WebhookError, match="after 3 attempts"):
            exporter.send(make_attr())

    def test_pagerduty_payload(self):
        payload = json.loads(webhook.build_pagerduty_payload(make_attr()))
        assert payload["payload"]["severity"] == "critical"  # conf 0.93 >= 0.8
        assert "tpu_hbm" in payload["payload"]["summary"]
        assert payload["payload"]["custom_details"]["burn_rate"] == "3.50"

    def test_opsgenie_priority_p1_on_high_burn(self):
        payload = json.loads(webhook.build_opsgenie_payload(make_attr()))
        assert payload["priority"] == "P1"  # burn 3.5 >= 3.0
        assert payload["entity"] == "s"

    def test_opsgenie_priority_p2_p3(self):
        attr = make_attr()
        attr.slo_impact.burn_rate = 1.0
        assert json.loads(webhook.build_opsgenie_payload(attr))["priority"] == "P2"
        attr.confidence = 0.5
        assert json.loads(webhook.build_opsgenie_payload(attr))["priority"] == "P3"

    def test_severity_escalates_on_fast_burn(self):
        # A low-confidence incident still pages critical/P1 while a
        # fast-burn budget alert is active: budget exhaustion outranks
        # classifier certainty.
        attr = make_attr()
        attr.confidence = 0.5
        attr.slo_impact.burn_rate = 1.0
        attr.slo_burn = {
            "evaluated_at": "2026-07-29T12:00:00Z",
            "max_burn_rate": 25.0,
            "alerting": [
                {
                    "tenant": "gold",
                    "objective": "availability",
                    "state": "fast_burn",
                    "burn_rates": {"1h": 25.0, "5m": 30.0},
                    "budget_remaining": 0.1,
                }
            ],
        }
        pd = json.loads(webhook.build_pagerduty_payload(attr))
        assert pd["payload"]["severity"] == "critical"
        assert pd["payload"]["custom_details"]["burning_budgets"] == [
            "gold/availability=fast_burn"
        ]
        og = json.loads(webhook.build_opsgenie_payload(attr))
        assert og["priority"] == "P1"
        assert "gold/availability=fast_burn" in og["details"]["burning_budgets"]

    def test_slow_burn_alone_does_not_escalate_pagerduty(self):
        attr = make_attr()
        attr.confidence = 0.5
        attr.slo_impact.burn_rate = 1.0
        attr.slo_burn = {
            "alerting": [
                {
                    "tenant": "gold",
                    "objective": "availability",
                    "state": "slow_burn",
                    "burn_rates": {"6h": 8.0, "30m": 8.0},
                    "budget_remaining": 0.6,
                }
            ],
        }
        pd = json.loads(webhook.build_pagerduty_payload(attr))
        assert pd["payload"]["severity"] == "warning"

    def test_slo_burn_rides_generic_payload_and_contract(self):
        from tpuslo_torch.schema import SCHEMA_INCIDENT_ATTRIBUTION, validate

        attr = make_attr()
        attr.slo_burn = {
            "evaluated_at": "2026-07-29T12:00:00Z",
            "max_burn_rate": 25.0,
            "alerting": [
                {
                    "tenant": "gold",
                    "objective": "ttft",
                    "state": "fast_burn",
                    "burn_rates": {"1h": 25.0},
                    "budget_remaining": 0.0,
                }
            ],
        }
        payload = attr.to_dict()
        validate(payload, SCHEMA_INCIDENT_ATTRIBUTION)
        assert payload["slo_burn"]["alerting"][0]["tenant"] == "gold"
        # Absent burn context stays absent (optional field).
        bare = make_attr().to_dict()
        assert "slo_burn" not in bare
        validate(bare, SCHEMA_INCIDENT_ATTRIBUTION)

    def test_pagerduty_format_sent_via_exporter(self, stub_server):
        exporter = webhook.Exporter(
            f"http://127.0.0.1:{stub_server.server_port}/hook",
            format=webhook.FORMAT_PAGERDUTY,
        )
        exporter.send(make_attr())
        body = json.loads(stub_server.requests[0]["body"])
        assert body["event_action"] == "trigger"
