"""``tests/test_delivery.py`` run on the port's delivery layer
(``tpuslo_torch/delivery``): the same cases, importing ``tpuslo_torch``
where the JAX package's tests import ``tpuslo``.

The JAX package's test says:

Resilient-delivery unit tests: breaker, spool, channel, fault sinks,
EventWriters wiring, and emit-failure drop accounting.

Everything here is deterministic (injected clocks/rng, worker-less
channels); the end-to-end outage/replay scenarios against a real HTTP
fault sink live in tests/test_chaos_delivery.py under the ``chaos``
marker.
"""

from __future__ import annotations

import json
import socket
from datetime import datetime, timezone

import pytest

from tpuslo_torch.delivery import (
    STATE_CLOSED,
    STATE_HALF_OPEN,
    STATE_OPEN,
    CircuitBreaker,
    DeliveryChannel,
    DeliveryOptions,
    DiskSpool,
    SinkError,
    full_jitter_delay,
)
from tpuslo_torch.delivery.faultsink import FaultSchedule, FlakySink, parse_schedule


class FakeClock:
    def __init__(self, start: float = 0.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


# ---- breaker ----------------------------------------------------------


class TestCircuitBreaker:
    def test_opens_after_consecutive_failures(self):
        clock = FakeClock()
        b = CircuitBreaker(failure_threshold=3, open_duration_s=5, clock=clock)
        for _ in range(2):
            b.record_failure()
        assert b.state == STATE_CLOSED
        b.record_failure()
        assert b.state == STATE_OPEN
        assert not b.allow()

    def test_success_resets_failure_streak(self):
        b = CircuitBreaker(failure_threshold=2)
        b.record_failure()
        b.record_success()
        b.record_failure()
        assert b.state == STATE_CLOSED

    def test_half_open_probe_then_close(self):
        clock = FakeClock()
        b = CircuitBreaker(failure_threshold=1, open_duration_s=5, clock=clock)
        b.record_failure()
        assert b.state == STATE_OPEN
        clock.advance(5.0)
        assert b.state == STATE_HALF_OPEN
        assert b.allow()          # the single probe slot
        assert not b.allow()      # no second concurrent probe
        b.record_success()
        assert b.state == STATE_CLOSED
        assert b.allow()

    def test_half_open_probe_failure_rearms_cooldown(self):
        clock = FakeClock()
        b = CircuitBreaker(failure_threshold=1, open_duration_s=5, clock=clock)
        b.record_failure()
        clock.advance(5.0)
        assert b.allow()
        b.record_failure()
        assert b.state == STATE_OPEN
        clock.advance(4.9)
        assert not b.allow()
        clock.advance(0.2)
        assert b.allow()

    def test_release_probe_frees_the_half_open_slot(self):
        clock = FakeClock()
        b = CircuitBreaker(failure_threshold=1, open_duration_s=1, clock=clock)
        b.record_failure()
        clock.advance(1.0)
        assert b.allow()
        b.release_probe()  # probe produced no verdict
        assert b.allow()   # the slot is available again

    def test_transition_log_records_lifecycle(self):
        clock = FakeClock()
        b = CircuitBreaker(failure_threshold=1, open_duration_s=1, clock=clock)
        b.record_failure()
        clock.advance(1.0)
        b.allow()
        b.record_success()
        assert [s for s, _ in b.transitions] == [
            STATE_CLOSED, STATE_OPEN, STATE_HALF_OPEN, STATE_CLOSED,
        ]


# ---- spool ------------------------------------------------------------


class TestDiskSpool:
    def test_append_drain_roundtrip(self, tmp_path):
        spool = DiskSpool(tmp_path / "s")
        for i in range(5):
            spool.append({"kind": "probe", "payloads": [{"i": i}]})
        assert spool.pending_bytes() > 0
        got = []
        assert spool.drain(got.append) == 5
        assert [r["payloads"][0]["i"] for r in got] == [0, 1, 2, 3, 4]
        assert spool.pending_bytes() == 0
        assert spool.pending_batches() == 0

    def test_segments_roll_and_drain_in_order(self, tmp_path):
        spool = DiskSpool(tmp_path / "s", segment_max_bytes=4096)
        big = "x" * 600
        for i in range(20):
            spool.append({"i": i, "pad": big})
        assert len(list((tmp_path / "s").glob("seg-*.jsonl"))) > 1
        got = []
        spool.drain(got.append)
        assert [r["i"] for r in got] == list(range(20))

    def test_drain_abort_preserves_remaining(self, tmp_path):
        spool = DiskSpool(tmp_path / "s")
        for i in range(4):
            spool.append({"i": i})

        def handler(record):
            if record["i"] == 2:
                raise SinkError("sink died again")

        with pytest.raises(SinkError):
            spool.drain(handler)
        # Segment not fully handled: everything still replayable
        # (at-least-once, never at-most-once).
        assert spool.pending_batches() == 4

    def test_size_cap_drops_oldest_segments(self, tmp_path):
        dropped = []
        spool = DiskSpool(
            tmp_path / "s",
            segment_max_bytes=4096,
            max_bytes=9000,
            on_truncate=dropped.append,
        )
        pad = "y" * 700
        for i in range(40):
            spool.append({"i": i, "pad": pad})
        assert spool.pending_bytes() <= 9000 + 4096  # caps sealed history
        assert sum(dropped) > 0
        got = []
        spool.drain(got.append)
        # Newest records survive; the evicted prefix is the oldest.
        assert got[-1]["i"] == 39
        assert got[0]["i"] > 0

    def test_age_cap_drops_stale_segments(self, tmp_path):
        dropped = []
        clock = FakeClock(1000.0)
        spool = DiskSpool(
            tmp_path / "s",
            segment_max_bytes=4096,
            max_age_s=60.0,
            walltime=clock,
            on_truncate=dropped.append,
        )
        spool.append({"i": 0})
        spool.seal()
        clock.advance(3600.0)  # the sealed segment is now an hour stale
        spool.append({"i": 1})
        got = []
        spool.drain(got.append)
        assert [r["i"] for r in got] == [1]
        assert sum(dropped) == 1

    def test_torn_final_line_is_skipped(self, tmp_path):
        spool = DiskSpool(tmp_path / "s")
        spool.append({"i": 0})
        spool.seal()
        seg = next((tmp_path / "s").glob("seg-*.jsonl"))
        with open(seg, "a", encoding="utf-8") as fh:
            fh.write('{"i": 1, "trunc')  # crash mid-append
        got = []
        spool.drain(got.append)
        assert [r["i"] for r in got] == [0]


# ---- fault sinks ------------------------------------------------------


class TestFaultSchedule:
    def test_parse(self):
        phases = parse_schedule("ok:3, refuse:2,500,4xx:1,hang,flap:4")
        assert [(p.behavior, p.count) for p in phases] == [
            ("ok", 3), ("refuse", 2), ("5xx", 1), ("4xx", 1),
            ("hang", 1), ("flap", 4),
        ]

    def test_parse_rejects_unknown(self):
        with pytest.raises(ValueError):
            parse_schedule("ok:2,explode:1")
        with pytest.raises(ValueError):
            parse_schedule("")

    def test_cursor_exhausts_to_ok(self):
        sched = FaultSchedule("5xx:2,flap:2")
        assert [sched.next_behavior() for _ in range(6)] == [
            "5xx", "5xx", "ok", "5xx", "ok", "ok",
        ]

    def test_flaky_sink_records_only_ok(self):
        sink = FlakySink("ok:1,4xx:1,ok", sleep=lambda _: None)
        sink.send("probe", [{"i": 0}])
        with pytest.raises(SinkError) as err:
            sink.send("probe", [{"i": 1}])
        assert not err.value.retryable
        sink.send("probe", [{"i": 2}])
        assert [p["i"] for p in sink.received_payloads()] == [0, 2]


# ---- channel ----------------------------------------------------------


def make_channel(tmp_path, sink, **overrides):
    """Deterministic worker-less channel: submit() pumps inline."""
    defaults = dict(
        queue_max=8,
        max_attempts=3,
        base_delay_s=0.0,
        max_delay_s=0.0,
        breaker=overrides.pop(
            "breaker",
            CircuitBreaker(failure_threshold=3, open_duration_s=10.0),
        ),
        sleep=lambda _: None,
        rng=lambda: 1.0,
        start_worker=False,
    )
    defaults.update(overrides)
    return DeliveryChannel("test", sink, tmp_path / "spool", **defaults)


class TestDeliveryChannel:
    def test_happy_path_delivers(self, tmp_path):
        sink = FlakySink("ok")
        ch = make_channel(tmp_path, sink)
        ch.submit("probe", [{"i": 0}, {"i": 1}])
        assert ch.snapshot()["delivered_events"] == 2
        assert sink.received_payloads() == [{"i": 0}, {"i": 1}]
        ch.close()

    def test_retry_then_success(self, tmp_path):
        sink = FlakySink("5xx:2,ok")
        ch = make_channel(tmp_path, sink)
        ch.submit("probe", [{"i": 0}])
        snap = ch.snapshot()
        assert snap["delivered_events"] == 1
        assert snap["retries"] == 2
        assert snap["spooled_events"] == 0
        ch.close()

    def test_retries_exhausted_spools_not_drops(self, tmp_path):
        sink = FlakySink("5xx:20")
        ch = make_channel(tmp_path, sink)
        ch.submit("probe", [{"i": 0}])
        snap = ch.snapshot()
        assert snap["spooled_events"] == 1
        assert snap["dead_lettered_events"] == 0
        assert snap["spool_bytes"] > 0
        ch.close()

    def test_spool_replays_after_recovery(self, tmp_path):
        clock = FakeClock()
        breaker = CircuitBreaker(
            failure_threshold=2, open_duration_s=5.0, clock=clock
        )
        sink = FlakySink("refuse:3,ok")
        ch = make_channel(tmp_path, sink, breaker=breaker)
        # Two failed attempts trip the breaker; the third attempt finds
        # it open and spools instead of hammering the dead sink.
        ch.submit("probe", [{"i": 0}])
        assert breaker.state == STATE_OPEN
        assert sink.calls == 2
        ch.submit("probe", [{"i": 1}])   # breaker open -> straight to spool
        snap = ch.snapshot()
        assert snap["spooled_events"] == 2
        assert sink.calls == 2           # open breaker attempted nothing
        clock.advance(5.0)               # cooldown elapses -> half-open
        ch.submit("probe", [{"i": 2}])   # half-open probe: refusal #3 re-opens
        assert breaker.state == STATE_OPEN
        assert ch.snapshot()["spooled_events"] == 3
        clock.advance(5.0)
        ch.submit("probe", [{"i": 3}])   # sink healthy now: deliver + replay
        snap = ch.snapshot()
        assert snap["breaker"] == STATE_CLOSED
        delivered = [p["i"] for p in sink.received_payloads()]
        assert sorted(delivered) == [0, 1, 2, 3]
        assert snap["replayed_events"] == 3
        assert snap["delivered_events"] == 4  # 1 live + 3 replayed
        assert snap["dead_lettered_events"] == 0
        ch.close()

    def test_non_retryable_dead_letters_with_reason(self, tmp_path):
        sink = FlakySink("4xx:1")
        ch = make_channel(tmp_path, sink)
        ch.submit("probe", [{"i": 0}, {"i": 1}])
        snap = ch.snapshot()
        assert snap["dead_lettered_events"] == 2
        assert snap["spooled_events"] == 0
        dl_file = tmp_path / "spool" / "test-dead-letter.jsonl"
        records = [json.loads(l) for l in dl_file.read_text().splitlines()]
        assert records[0]["reason"] == "non_retryable"
        assert "400" in records[0]["detail"]
        assert len(records[0]["payloads"]) == 2
        ch.close()

    def test_4xx_does_not_trip_the_breaker(self, tmp_path):
        # The breaker guards availability; a responding-but-rejecting
        # sink (4xx) must not open it and block healthy traffic.
        breaker = CircuitBreaker(failure_threshold=2, open_duration_s=5.0)
        sink = FlakySink("4xx:3,ok")
        ch = make_channel(tmp_path, sink, breaker=breaker)
        for i in range(3):
            ch.submit("probe", [{"i": i}])
        assert breaker.state == STATE_CLOSED
        ch.submit("probe", [{"i": 3}])
        assert [p["i"] for p in sink.received_payloads()] == [3]
        ch.close()

    def test_sink_exception_is_poison_not_crash(self, tmp_path):
        class BuggySink:
            def send(self, kind, payloads):
                raise ValueError("boom")

        ch = make_channel(tmp_path, BuggySink())
        ch.submit("probe", [{"i": 0}])
        snap = ch.snapshot()
        assert snap["dead_lettered_events"] == 1
        ch.close()

    def test_queue_overflow_spills_to_spool(self, tmp_path):
        sink = FlakySink("ok")
        # Worker thread mode with a tiny queue: pre-load the queue by
        # never letting the worker run (start_worker=False but don't
        # pump) — submit with a full queue must spill to disk.
        ch = DeliveryChannel(
            "test", sink, tmp_path / "spool",
            queue_max=2, start_worker=False, sleep=lambda _: None,
        )
        # Worker-less channels pump inline, so simulate the backlog
        # directly: stuff the queue beyond queue_max.
        ch._worker = object()  # pretend a worker owns the queue
        for i in range(4):
            ch.submit("probe", [{"i": i}])
        assert ch.snapshot()["spooled_events"] == 2  # i=2,3 spilled
        ch._worker = None
        ch.pump()
        snap = ch.snapshot()
        # Queue batches delivered live; the spilled ones replayed from
        # disk right behind them — nothing lost, nothing dropped.
        assert snap["delivered_events"] == 4
        assert snap["replayed_events"] == 2
        assert sorted(p["i"] for p in sink.received_payloads()) == [0, 1, 2, 3]

    def test_worker_thread_drains_and_idle_replays(self, tmp_path):
        sink = FlakySink("5xx:3,ok")
        ch = DeliveryChannel(
            "test", sink, tmp_path / "spool",
            max_attempts=1,  # first failure spools immediately
            breaker=CircuitBreaker(failure_threshold=5, open_duration_s=0.05),
            base_delay_s=0.0, max_delay_s=0.0,
            replay_interval_s=0.05,
            start_worker=True,
        )
        ch.submit("probe", [{"i": 0}])  # fails once -> spooled
        assert ch.flush(5.0)
        deadline = 50
        while ch.snapshot()["replayed_events"] < 1 and deadline:
            import time as time_mod

            time_mod.sleep(0.05)
            deadline -= 1
        snap = ch.snapshot()
        assert snap["replayed_events"] == 1  # idle worker replayed it
        assert [p["i"] for p in sink.received_payloads()] == [0]
        ch.close()
        assert ch.snapshot()["spool_bytes"] == 0

    def test_close_is_idempotent_and_final_replay(self, tmp_path):
        sink = FlakySink("5xx:3,ok")
        # Breaker threshold above max_attempts: retries exhaust and
        # spool while the breaker stays closed, so close() may replay.
        ch = make_channel(
            tmp_path, sink, max_attempts=3,
            breaker=CircuitBreaker(failure_threshold=5, open_duration_s=10.0),
        )
        ch.submit("probe", [{"i": 0}])  # exhausts retries -> spool
        assert ch.snapshot()["spooled_events"] == 1
        ch.close()  # final replay: sink healthy now
        assert ch.snapshot()["spool_bytes"] == 0
        assert [p["i"] for p in sink.received_payloads()] == [0]
        ch.close()  # second close is a no-op
        with pytest.raises(RuntimeError):
            ch.submit("probe", [{"i": 1}])

    def test_spool_write_failure_dead_letters_instead_of_crashing(
        self, tmp_path, monkeypatch
    ):
        sink = FlakySink("5xx:20")
        ch = make_channel(tmp_path, sink, max_attempts=1)

        def broken_append(record):
            raise OSError("No space left on device")

        monkeypatch.setattr(ch._spool, "append", broken_append)
        ch.submit("probe", [{"i": 0}])  # retry exhausts -> spool fails
        snap = ch.snapshot()
        assert snap["dead_lettered_events"] == 1
        dl_file = tmp_path / "spool" / "test-dead-letter.jsonl"
        record = json.loads(dl_file.read_text())
        assert record["reason"] == "spool_error"

    def test_worker_survives_unexpected_processing_error(self, tmp_path):
        sink = FlakySink("ok")
        ch = DeliveryChannel(
            "test", sink, tmp_path / "spool", start_worker=True,
        )
        original_process = ch._process
        calls = []

        def flaky_process(kind, payloads):
            calls.append(payloads)
            if len(calls) == 1:
                raise RuntimeError("unexpected bug in processing")
            original_process(kind, payloads)

        ch._process = flaky_process
        ch.submit("probe", [{"i": 0}])  # worker hits the bug
        ch.submit("probe", [{"i": 1}])  # worker must still be alive
        assert ch.flush(5.0)
        snap = ch.snapshot()
        assert snap["worker_errors"] == 1
        assert snap["delivered_events"] == 1
        ch.close()

    def test_close_spills_unflushed_queue_to_spool(self, tmp_path):
        import threading

        release = threading.Event()

        class HangingSink:
            def send(self, kind, payloads):
                release.wait(timeout=30)
                raise SinkError("gave up")

        ch = DeliveryChannel(
            "test", HangingSink(), tmp_path / "spool",
            queue_max=8, start_worker=True,
        )
        for i in range(3):
            ch.submit("probe", [{"i": i}])
        # The worker is stuck inside the first send; a short close must
        # not strand the two queued batches in the dying process.
        ch.close(flush_timeout_s=0.2)
        assert ch._spool.pending_batches() >= 2
        release.set()

    def test_full_jitter_delay_bounds(self):
        assert full_jitter_delay(0, 1.0, 8.0, rng=lambda: 1.0) == 1.0
        assert full_jitter_delay(3, 1.0, 8.0, rng=lambda: 1.0) == 8.0
        assert full_jitter_delay(3, 1.0, 8.0, rng=lambda: 0.0) == 0.0


# ---- EventWriters wiring ---------------------------------------------


def free_refused_port() -> int:
    """A port that is (almost certainly) refusing connections."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_agent(tmp_path, extra_args, metrics=None):
    from tpuslo_torch.cli import agent
    from tpuslo_torch.metrics import AgentMetrics

    metrics = metrics or AgentMetrics()
    rc = agent.main(
        [
            "--scenario", "dns_latency",
            "--count", "3",
            "--interval-s", "0.01",
            "--capability-mode", "bcc_degraded",
            "--metrics-port", "0",
            "--max-overhead-pct", "1000",
            *extra_args,
        ],
        metrics=metrics,
    )
    assert rc == 0
    return metrics


def sample_value(metrics, name, **labels):
    value = metrics.registry.get_sample_value(name, labels or None)
    return 0.0 if value is None else value


class TestEmitFailureAccounting:
    def test_sync_otlp_failure_counts_drops_by_batch_size(self, tmp_path):
        port = free_refused_port()
        metrics = run_agent(
            tmp_path,
            [
                "--event-kind", "both",
                "--output", "otlp",
                "--otlp-endpoint", f"http://127.0.0.1:{port}/v1/logs",
            ],
        )
        # 3 cycles x 4 SLIs dropped on the SLO path, 3 x 2 signals
        # (bcc_degraded) on the probe path — every event is accounted.
        dropped = sample_value(
            metrics, "llm_slo_agent_events_dropped_total", reason="emit"
        )
        assert dropped == 3 * 4 + 3 * 2
        assert sample_value(metrics, "llm_slo_agent_slo_events_total") == 0

    def test_spooled_events_are_not_drops(self, tmp_path):
        port = free_refused_port()
        metrics = run_agent(
            tmp_path,
            [
                "--event-kind", "both",
                "--output", "otlp",
                "--otlp-endpoint", f"http://127.0.0.1:{port}/v1/logs",
                "--spool-dir", str(tmp_path / "spool"),
            ],
        )
        dropped = sample_value(
            metrics, "llm_slo_agent_events_dropped_total", reason="emit"
        )
        assert dropped == 0
        spooled = sample_value(
            metrics, "llm_slo_agent_delivery_spooled_events_total",
            sink="otlp-slo",
        ) + sample_value(
            metrics, "llm_slo_agent_delivery_spooled_events_total",
            sink="otlp-probe",
        )
        assert spooled == 3 * 4 + 3 * 2
        # The spooled evidence is really on disk, per sink.
        spool_root = tmp_path / "spool"
        assert list((spool_root / "otlp-slo").glob("seg-*.jsonl"))
        assert list((spool_root / "otlp-probe").glob("seg-*.jsonl"))


class TestShedRestoreLifecycle:
    def test_agent_sheds_then_restores_after_under_budget_cycles(
        self, tmp_path, capsys, monkeypatch
    ):
        """Degradation is two-way at the agent level: one over-budget
        guard cycle sheds the costliest probe; sustained under-budget
        cycles bring it back, with the restore visible in metrics."""
        from tpuslo_torch.cli import agent as agent_mod
        from tpuslo_torch.safety import OverheadResult

        # Scripted guard: prime, breach once, then run comfortably cold.
        script = iter(
            [
                OverheadResult(0.0, 3.0, False, valid=False),
                OverheadResult(9.0, 3.0, True, valid=True),
            ]
        )

        class ScriptedGuard:
            def __init__(self, *a, **k):
                pass

            def evaluate(self):
                return next(
                    script, OverheadResult(1.0, 3.0, False, valid=True)
                )

        monkeypatch.setattr(agent_mod, "OverheadGuard", ScriptedGuard)
        metrics = run_agent(
            tmp_path,
            [
                "--output", "jsonl",
                "--jsonl-path", str(tmp_path / "out.jsonl"),
                "--event-kind", "probe",
                "--capability-mode", "tpu_full",
                "--count", "6",
                "--restore-after-cycles", "2",
            ],
        )
        err = capsys.readouterr().err
        # The shed order's new head: the device-plane
        # ledger signals shed before the probe-backed TPU signals.
        assert "disabled device_idle_gap_ms" in err
        assert "re-enabled device_idle_gap_ms" in err
        assert sample_value(
            metrics,
            "llm_slo_agent_signals_restored_total",
            signal="device_idle_gap_ms",
        ) == 1
        # The signal is enabled again at the end of the run.
        assert sample_value(
            metrics,
            "llm_slo_agent_signal_enabled",
            signal="device_idle_gap_ms",
        ) == 1


class TestEventWritersClose:
    def test_close_idempotent_jsonl(self, tmp_path):
        from tpuslo_torch.cli.common import EventWriters

        path = tmp_path / "out.jsonl"
        w = EventWriters(output="jsonl", jsonl_path=str(path))
        w.close()
        w.close()  # must not raise on the already-closed stream

    def test_close_flushes_stream(self, tmp_path):
        import io

        from tpuslo_torch.cli.common import EventWriters
        from tpuslo_torch.schema import ProbeEventV1

        stream = io.StringIO()
        w = EventWriters(output="stdout", stream=stream)
        event = ProbeEventV1(
            ts_unix_nano=1, signal="dns_latency_ms", node="n",
            namespace="llm", pod="p", container="c", pid=1, tid=1,
            value=1.0, unit="ms", status="ok",
        )
        w.emit_probe([event])
        w.close()
        w.close()
        assert "dns_latency_ms" in stream.getvalue()

    def test_close_flushes_delivery_channels(self, tmp_path):
        from tpuslo_torch.cli.common import EventWriters
        from tpuslo_torch.delivery import DeliveryOptions
        from tpuslo_torch.schema import SLOEvent

        srv_port = free_refused_port()
        w = EventWriters(
            output="otlp",
            otlp_endpoint=f"http://127.0.0.1:{srv_port}/v1/logs",
            delivery=DeliveryOptions(
                spool_dir=str(tmp_path / "spool"),
                max_attempts=1,
                base_delay_s=0.0,
                max_delay_s=0.0,
            ),
        )
        event = SLOEvent(
            event_id="e-1",
            timestamp=datetime(2026, 8, 3, tzinfo=timezone.utc),
            cluster="c", namespace="n", workload="w", service="s",
            request_id="r-1", sli_name="ttft_ms", sli_value=1.0,
            unit="ms", status="ok",
        )
        w.emit_slo([event])
        w.close()
        w.close()
        # The batch survived close: spooled, not lost.
        assert list((tmp_path / "spool" / "otlp-slo").glob("seg-*.jsonl"))
