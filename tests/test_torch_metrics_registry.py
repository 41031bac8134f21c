"""``tests/test_metrics_server.py`` run on the port's Prometheus registry,
readiness and metrics server (``tpuslo_torch/metrics/registry.py``): the
same cases, importing ``tpuslo_torch`` where the JAX package's tests import
``tpuslo``.

The JAX package's test says:

Metrics HTTP server tests: /metrics //healthz //readyz status codes,
content types, concurrent scrapes, and the readiness aggregation —
previously the server shipped untested and /readyz returned an
unconditional 200.
"""

import threading
import urllib.error
import urllib.request

import pytest

from tpuslo_torch.metrics import AgentMetrics, Readiness, start_metrics_server


@pytest.fixture
def server_env():
    metrics = AgentMetrics()
    readiness = Readiness()
    server = start_metrics_server(
        metrics, 0, host="127.0.0.1", readiness=readiness
    )
    port = server.server_address[1]
    yield metrics, readiness, f"http://127.0.0.1:{port}"
    server.shutdown()
    server.server_close()


def fetch(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


class TestEndpoints:
    def test_metrics_endpoint(self, server_env):
        metrics, _, base = server_env
        metrics.up.set(1)
        status, headers, body = fetch(base + "/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        assert b"llm_slo_agent_up 1.0" in body
        assert b"llm_slo_agent_cycle_stage_ms" in body

    def test_healthz(self, server_env):
        _, _, base = server_env
        status, headers, body = fetch(base + "/healthz")
        assert status == 200
        assert body == b"ok\n"
        assert headers["Content-Type"].startswith("text/plain")

    def test_readyz_ok_with_no_checks(self, server_env):
        _, _, base = server_env
        status, _, body = fetch(base + "/readyz")
        assert status == 200
        assert body == b"ok\n"

    def test_readyz_without_readiness_object_stays_200(self):
        metrics = AgentMetrics()
        server = start_metrics_server(metrics, 0, host="127.0.0.1")
        try:
            port = server.server_address[1]
            status, _, body = fetch(f"http://127.0.0.1:{port}/readyz")
            assert status == 200 and body == b"ok\n"
        finally:
            server.shutdown()
            server.server_close()

    def test_unknown_path_404(self, server_env):
        _, _, base = server_env
        status, _, _ = fetch(base + "/nope")
        assert status == 404


class TestReadiness:
    def test_failing_check_returns_503_with_reason(self, server_env):
        _, readiness, base = server_env
        state = {"draining": True}
        readiness.add_check(
            "drain",
            lambda: (not state["draining"], "drain in progress"),
        )
        status, _, body = fetch(base + "/readyz")
        assert status == 503
        assert b"drain: drain in progress" in body
        # Recovery flips it back without restarting the server.
        state["draining"] = False
        status, _, body = fetch(base + "/readyz")
        assert status == 200 and body == b"ok\n"

    def test_multiple_failures_all_reported(self, server_env):
        _, readiness, base = server_env
        readiness.add_check("breakers", lambda: (False, "all open"))
        readiness.add_check("snapshot", lambda: (False, "stale (400s)"))
        status, _, body = fetch(base + "/readyz")
        assert status == 503
        assert b"breakers: all open" in body
        assert b"snapshot: stale (400s)" in body

    def test_raising_check_is_not_ready(self, server_env):
        _, readiness, base = server_env

        def broken():
            raise RuntimeError("boom")

        readiness.add_check("broken", broken)
        status, _, body = fetch(base + "/readyz")
        assert status == 503
        assert b"broken: check raised" in body

    def test_evaluate_directly(self):
        readiness = Readiness()
        assert readiness.evaluate() == (True, "ok")
        readiness.add_check("a", lambda: (True, "ok"))
        readiness.add_check("b", lambda: (False, "nope"))
        ready, reason = readiness.evaluate()
        assert not ready and reason == "b: nope"


class TestConcurrentScrapes:
    def test_parallel_scrapes_all_succeed(self, server_env):
        metrics, _, base = server_env
        metrics.up.set(1)
        results: list[int] = []
        errors: list[Exception] = []
        lock = threading.Lock()

        def scrape():
            try:
                for _ in range(5):
                    status, _, body = fetch(base + "/metrics")
                    with lock:
                        results.append(status)
                    assert b"llm_slo_agent_up" in body
            except Exception as exc:  # noqa: BLE001
                with lock:
                    errors.append(exc)

        threads = [threading.Thread(target=scrape) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        assert len(results) == 40
        assert set(results) == {200}


class TestStageQuantiles:
    def test_quantiles_from_histogram_buckets(self):
        metrics = AgentMetrics()
        # 100 observations at ~2ms, 1 at ~40ms: p50 in the (1, 2.5]
        # bucket, p99 well above it.
        for _ in range(100):
            metrics.cycle_stage_ms.labels(stage="generate").observe(2.0)
        metrics.cycle_stage_ms.labels(stage="generate").observe(40.0)
        est = metrics.stage_quantiles()
        assert "generate" in est
        gen = est["generate"]
        assert gen["count"] == 101
        assert 1.0 <= gen["p50"] <= 2.5
        assert gen["p99"] > gen["p50"]

    def test_empty_histograms_yield_nothing(self):
        assert AgentMetrics().stage_quantiles() == {}

    def test_mark_cycle_with_duration_feeds_cycle_histogram(self):
        metrics = AgentMetrics()
        metrics.mark_cycle(duration_ms=12.5)
        samples = {
            s.name: s.value
            for m in metrics.cycle_ms.collect()
            for s in m.samples
        }
        assert samples["llm_slo_agent_cycle_ms_count"] == 1
        assert samples["llm_slo_agent_cycle_ms_sum"] == 12.5


class TestSLOBurnSeries:
    """The burn engine's slo_* series: registration, observer bridge,
    and a real scrape carrying every series the error-budget dashboard
    references."""

    def test_slo_series_registered_on_agent_metrics(self):
        metrics = AgentMetrics()
        for attr in (
            "slo_request_outcomes",
            "slo_budget_remaining",
            "slo_burn_rate",
            "slo_alert_state",
            "slo_alert_transitions",
        ):
            assert hasattr(metrics, attr)

    def test_observer_bridges_engine_callbacks(self):
        metrics = AgentMetrics()
        observer = metrics.slo_observer()
        observer.outcome("gold", "ok")
        observer.outcome("gold", "ok")
        observer.outcome("gold", "error")
        observer.burn_rate("gold", "availability", "5m", 16.2)
        observer.budget_remaining("gold", "availability", 0.25)
        observer.alert_state("gold", "availability", 2)
        observer.transition("gold", "availability", "page")
        samples = {
            (s.name, tuple(sorted(s.labels.items()))): s.value
            for metric in metrics.registry.collect()
            for s in metric.samples
        }
        assert samples[(
            "llm_slo_agent_slo_request_outcomes_total",
            (("status", "ok"), ("tenant", "gold")),
        )] == 2
        assert samples[(
            "llm_slo_agent_slo_burn_rate",
            (("objective", "availability"), ("tenant", "gold"),
             ("window", "5m")),
        )] == 16.2
        assert samples[(
            "llm_slo_agent_slo_budget_remaining",
            (("objective", "availability"), ("tenant", "gold")),
        )] == 0.25
        assert samples[(
            "llm_slo_agent_slo_alert_state",
            (("objective", "availability"), ("tenant", "gold")),
        )] == 2
        assert samples[(
            "llm_slo_agent_slo_alert_transitions_total",
            (("objective", "availability"), ("severity", "page"),
             ("tenant", "gold")),
        )] == 1

    def test_scrape_exposes_burn_series(self, server_env):
        metrics, _, base = server_env
        from tpuslo_torch.sloengine import (
            BurnEngine,
            EngineConfig,
            RequestOutcome,
        )

        engine = BurnEngine(
            EngineConfig(), observer=metrics.slo_observer()
        )
        t0 = 1_700_000_000
        for i in range(720):
            engine.record(
                RequestOutcome(
                    tenant="gold",
                    ts_unix_nano=(t0 + i * 5) * 1_000_000_000,
                    ttft_ms=100.0,
                    tpot_ms=30.0,
                    tokens=64,
                    status="error",
                )
            )
        engine.evaluate(t0 + 3600)
        status, _, body = fetch(base + "/metrics")
        assert status == 200
        text = body.decode()
        for series in (
            'llm_slo_agent_slo_request_outcomes_total{status="error",tenant="gold"}',
            'llm_slo_agent_slo_budget_remaining{objective="availability",tenant="gold"}',
            'llm_slo_agent_slo_burn_rate{objective="availability",tenant="gold",window="1h"}',
            'llm_slo_agent_slo_alert_state{objective="availability",tenant="gold"} 2.0',
            'llm_slo_agent_slo_alert_transitions_total{objective="availability",severity="page",tenant="gold"}',
        ):
            assert series in text, series
