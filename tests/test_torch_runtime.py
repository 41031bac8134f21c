"""Crash-safe runtime: ``tpuslo_torch.runtime`` against ``tpuslo.runtime``.

The cases of ``tests/test_runtime_state.py`` (state store, agent
runtime, rate-limiter state, torn-line repair), ``test_runtime_drain.py``
(drain controller, SIGTERM handler) and ``test_runtime_supervisor.py``
(all of it) are written once, as functions of a *side* (one package's
``runtime`` and ``safety``), run on the JAX package's and on the port's,
and must observe the same values on both; the JAX tests' own
assertions hold on each.  A snapshot file written by one package's
``StateStore`` must restore through the other's, both ways.
"""

from __future__ import annotations

import json
import os
import signal
import threading
from types import SimpleNamespace

import pytest

from tpuslo import runtime as jruntime
from tpuslo import safety as jsafety
from tpuslo.runtime import drain as jdrain
from tpuslo.runtime import supervisor as jsupervisor
from tpuslo_torch import runtime as truntime
from tpuslo_torch import safety as tsafety
from tpuslo_torch.runtime import drain as tdrain
from tpuslo_torch.runtime import supervisor as tsupervisor

J = SimpleNamespace(name="jax", runtime=jruntime, drain=jdrain,
                    supervisor=jsupervisor, safety=jsafety)
T = SimpleNamespace(name="port", runtime=truntime, drain=tdrain,
                    supervisor=tsupervisor, safety=tsafety)


def both(scenario, tmp_path=None):
    """Run ``scenario`` on both sides (each in its own directory when
    ``tmp_path`` is given), require equal observations, return the
    port's."""
    def on(side):
        if tmp_path is None:
            return scenario(side)
        where = tmp_path / side.name
        where.mkdir()
        return scenario(side, where)

    want, got = on(J), on(T)
    assert got == want
    return got


def test_the_port_exports_the_same_names():
    assert truntime.__all__ == jruntime.__all__


class FakeClock:
    def __init__(self, now: float = 1000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


# ---- StateStore --------------------------------------------------------


class TestStateStore:
    def test_save_load_roundtrip(self, tmp_path):
        def run(s, where):
            store = s.runtime.StateStore(where / "state.json")
            assert store.save({"a": {"x": 1}, "b": [1, 2]})
            outcome, components, age = store.load()
            assert outcome == s.runtime.RESTORE_RESTORED
            assert components == {"a": {"x": 1}, "b": [1, 2]}
            assert age >= 0.0
            return outcome, components

        both(run, tmp_path)

    def test_missing_snapshot_is_cold(self, tmp_path):
        def run(s, where):
            outcome, components, _ = s.runtime.StateStore(where / "state.json").load()
            assert outcome == s.runtime.RESTORE_COLD
            assert components == {}
            return outcome

        both(run, tmp_path)

    def test_corrupt_snapshot(self, tmp_path):
        def run(s, where):
            path = where / "state.json"
            path.write_text('{"schema_version": 1, "saved_at": 12')
            outcome, components, _ = s.runtime.StateStore(path).load()
            assert outcome == s.runtime.RESTORE_CORRUPT
            assert components == {}
            return outcome

        both(run, tmp_path)

    def test_version_mismatch(self, tmp_path):
        def run(s, where):
            path = where / "state.json"
            path.write_text(json.dumps(
                {"schema_version": 999, "saved_at": 1.0, "components": {}}))
            outcome, _, _ = s.runtime.StateStore(path).load()
            assert outcome == s.runtime.RESTORE_VERSION
            return outcome

        both(run, tmp_path)

    def test_stale_snapshot(self, tmp_path):
        def run(s, where):
            clock = FakeClock()
            store = s.runtime.StateStore(where / "state.json", max_age_s=60.0,
                                         walltime=clock)
            store.save({"a": 1})
            clock.advance(61.0)
            outcome, components, age = store.load()
            assert outcome == s.runtime.RESTORE_STALE
            assert components == {}
            assert age > 60.0
            return outcome, age

        both(run, tmp_path)

    def test_atomic_write_leaves_no_temp_files(self, tmp_path):
        def run(s, where):
            store = s.runtime.StateStore(where / "state.json")
            for i in range(5):
                store.save({"i": i})
            leftovers = [name for name in os.listdir(where) if name != "state.json"]
            assert leftovers == []
            return store.load()[1]

        both(run, tmp_path)

    def test_maybe_save_respects_interval(self, tmp_path):
        def run(s, where):
            clock = FakeClock()
            store = s.runtime.StateStore(where / "state.json", interval_s=10.0,
                                         walltime=clock)
            saved = [store.maybe_save(lambda: {"n": 1}),
                     store.maybe_save(lambda: {"n": 2})]
            clock.advance(10.0)
            saved.append(store.maybe_save(lambda: {"n": 3}))
            assert saved == [True, False, True]
            assert store.load()[1] == {"n": 3}
            return saved

        both(run, tmp_path)

    def test_interval_zero_saves_every_call(self, tmp_path):
        def run(s, where):
            store = s.runtime.StateStore(where / "state.json", interval_s=0.0)
            assert store.maybe_save(lambda: {"n": 1})
            assert store.maybe_save(lambda: {"n": 2})
            assert store.saves == 2
            return store.saves

        both(run, tmp_path)

    def test_unserializable_state_is_counted_not_raised(self, tmp_path):
        def run(s, where):
            store = s.runtime.StateStore(where / "state.json")
            assert not store.save({"bad": object()})
            assert store.save_errors == 1
            return store.save_errors

        both(run, tmp_path)

    def test_the_snapshot_file_is_the_same_document(self, tmp_path):
        """Both stores write the same JSON document for the same
        components at the same wall time (``schema_version`` 1,
        ``saved_at``, ``components``)."""
        def run(s, where):
            store = s.runtime.StateStore(where / "state.json", walltime=FakeClock(5.0))
            store.save({"progress": {"next_cycle": 3}, "burn": {"v": [1, 2]}})
            return json.loads((where / "state.json").read_text())

        doc = both(run, tmp_path)
        assert doc["schema_version"] == 1 and doc["saved_at"] == 5.0

    @pytest.mark.parametrize("src,dst", [(J, T), (T, J)], ids=["jax-to-port", "port-to-jax"])
    def test_a_snapshot_crosses_the_packages(self, tmp_path, src, dst):
        """A state file one package's runtime writes is restored by the
        other's, component for component."""
        path = tmp_path / "state.json"
        state = {"progress": {"next_cycle": 60, "prefed": True}, "x": [1.5, "a"]}
        runtime = src.runtime.AgentRuntime(src.runtime.StateStore(path))
        for name, value in state.items():
            runtime.register(name, lambda v=value: v, lambda _: None)
        assert runtime.snapshot_now()
        got = {}
        runtime2 = dst.runtime.AgentRuntime(dst.runtime.StateStore(path))
        for name in state:
            runtime2.register(name, dict, lambda v, n=name: got.__setitem__(n, v))
        assert runtime2.restore() == dst.runtime.RESTORE_RESTORED
        assert got == state
        assert sorted(runtime2.restored_components) == sorted(state)


# ---- AgentRuntime ------------------------------------------------------


class TestAgentRuntime:
    def test_export_restore_roundtrip(self, tmp_path):
        def run(s, where):
            runtime = s.runtime.AgentRuntime(s.runtime.StateStore(where / "state.json"))
            state = {"value": 7}
            runtime.register("comp", lambda: dict(state), lambda st: state.update(st))
            runtime.snapshot_now()

            state2 = {"value": 0}
            runtime2 = s.runtime.AgentRuntime(s.runtime.StateStore(where / "state.json"))
            runtime2.register("comp", lambda: dict(state2), lambda st: state2.update(st))
            assert runtime2.restore() == s.runtime.RESTORE_RESTORED
            assert state2 == {"value": 7}
            assert runtime2.restored_components == ["comp"]
            return state2

        both(run, tmp_path)

    def test_late_registration_applies_pending_state(self, tmp_path):
        def run(s, where):
            store = s.runtime.StateStore(where / "state.json")
            s.runtime.AgentRuntime(store).store.save({"late": {"v": 3}})
            runtime = s.runtime.AgentRuntime(s.runtime.StateStore(where / "state.json"))
            assert runtime.restore() == s.runtime.RESTORE_RESTORED
            assert runtime.restored_components == []
            seen = {}
            runtime.register("late", lambda: seen, lambda st: seen.update(st))
            assert seen == {"v": 3}
            assert runtime.restored_components == ["late"]
            return seen

        both(run, tmp_path)

    def test_restore_isolates_component_failures(self, tmp_path):
        def run(s, where):
            s.runtime.StateStore(where / "state.json").save(
                {"good": {"v": 1}, "bad": {"v": 2}})
            runtime = s.runtime.AgentRuntime(s.runtime.StateStore(where / "state.json"))
            good = {}

            def explode(state):
                raise RuntimeError("boom")

            runtime.register("bad", lambda: {}, explode)
            runtime.register("good", lambda: good, lambda st: good.update(st))
            assert runtime.restore() == s.runtime.RESTORE_RESTORED
            assert good == {"v": 1}
            assert runtime.restore_errors == ["bad"]
            return good, runtime.restore_errors

        both(run, tmp_path)

    def test_cold_start_flag_skips_restore(self, tmp_path):
        def run(s, where):
            s.runtime.StateStore(where / "state.json").save({"c": {"v": 1}})
            runtime = s.runtime.AgentRuntime(s.runtime.StateStore(where / "state.json"))
            target = {}
            runtime.register("c", lambda: target, lambda st: target.update(st))
            outcome = runtime.restore(cold_start=True)
            assert outcome == "forced_cold"
            assert target == {}
            return outcome

        both(run, tmp_path)

    def test_disabled_runtime_is_cold(self):
        def run(s):
            runtime = s.runtime.AgentRuntime(None)
            outcome = runtime.restore()
            assert outcome == s.runtime.RESTORE_COLD
            assert not runtime.maybe_snapshot()
            assert not runtime.snapshot_now()
            return outcome

        both(run)

    def test_export_isolates_exporter_failures(self, tmp_path):
        def run(s, where):
            runtime = s.runtime.AgentRuntime(s.runtime.StateStore(where / "state.json"))
            runtime.register("ok", lambda: {"v": 1}, lambda st: None)

            def explode():
                raise RuntimeError("export boom")

            runtime.register("broken", explode, lambda st: None)
            assert runtime.snapshot_now()
            _, components, _ = runtime.store.load()
            assert components == {"ok": {"v": 1}}
            return components

        both(run, tmp_path)


# ---- component snapshot hooks -----------------------------------------


class TestRateLimiterState:
    def test_budget_survives_restart(self):
        def run(s):
            clock = FakeClock()
            limiter = s.safety.RateLimiter(10, burst=10, clock=clock)
            for _ in range(7):
                assert limiter.allow()
            exported = limiter.export_state()
            limiter2 = s.safety.RateLimiter(10, burst=10, clock=clock)
            limiter2.restore_state(exported)
            assert limiter2.tokens == limiter.tokens
            return exported

        both(run)

    def test_restore_clamps_to_capacity(self):
        def run(s):
            limiter = s.safety.RateLimiter(10, burst=10, clock=FakeClock())
            seen = []
            for raw in (99999.0, -5, "junk"):  # junk: ignored, no raise
                limiter.restore_state({"tokens": raw})
                seen.append(limiter.tokens)
            assert seen == [10.0, 0.0, 0.0]
            return seen

        both(run)


# ---- torn-line repair --------------------------------------------------


class TestTornLineRepair:
    def test_torn_tail_is_truncated_once(self, tmp_path):
        def run(s, where):
            path = where / "events.jsonl"
            path.write_text('{"a": 1}\n{"b": 2}\n{"torn": ')
            trimmed = s.runtime.repair_jsonl_tail(path)
            assert trimmed == len('{"torn": ')
            assert path.read_text() == '{"a": 1}\n{"b": 2}\n'
            assert s.runtime.repair_jsonl_tail(path) == 0  # idempotent
            return trimmed, path.read_bytes()

        both(run, tmp_path)

    def test_clean_missing_and_empty_files(self, tmp_path):
        def run(s, where):
            clean = where / "clean.jsonl"
            clean.write_text('{"a": 1}\n')
            empty = where / "empty.jsonl"
            empty.write_text("")
            trimmed = [s.runtime.repair_jsonl_tail(p)
                       for p in (clean, where / "missing.jsonl", empty)]
            assert trimmed == [0, 0, 0]
            return trimmed

        both(run, tmp_path)

    def test_torn_single_line_file_truncates_to_empty(self, tmp_path):
        def run(s, where):
            path = where / "one.jsonl"
            path.write_text('{"only": ')
            trimmed = s.runtime.repair_jsonl_tail(path)
            assert trimmed == len('{"only": ')
            assert path.read_text() == ""
            return trimmed

        both(run, tmp_path)

    def test_a_torn_status_row_is_repaired(self, tmp_path):
        """The front door's status file after a kill mid-write: the
        torn row goes, every surviving row parses."""
        def run(s, where):
            path = where / "status.jsonl"
            row = '{"ts":1.0,"cycle":%d,"burn_state":"fast_burn"}\n'
            path.write_text(row % 0 + row % 1 + (row % 2)[:17])
            trimmed = s.runtime.repair_jsonl_tail(path)
            rows = [json.loads(line) for line in path.read_text().splitlines()]
            assert [r["cycle"] for r in rows] == [0, 1]
            return trimmed, rows

        both(run, tmp_path)


# ---- drain -------------------------------------------------------------


class TestDrainController:
    @staticmethod
    def _report(report) -> dict:
        return {"outcome": report.outcome, "summary": report.summary(),
                "steps": [(st.name, st.ok, st.detail) for st in report.steps]}

    def test_clean_drain_runs_every_step_in_order(self):
        def run(s):
            drain = s.runtime.DrainController("test", deadline_s=10.0, clock=FakeClock(0.0))
            ran = []
            drain.step("a", lambda budget: ran.append(("a", budget)) or True)
            drain.step("b", lambda budget: ran.append(("b", budget)) or True)
            report = drain.finish()
            assert report.outcome == s.drain.DRAIN_CLEAN
            assert [name for name, _ in ran] == ["a", "b"]
            assert all(budget == 10.0 for _, budget in ran)
            assert all(step.ok for step in report.steps)
            return ran, self._report(report)

        both(run)

    def test_slow_step_eats_only_its_own_budget(self):
        def run(s):
            clock = FakeClock(0.0)
            drain = s.runtime.DrainController("test", deadline_s=10.0, clock=clock)

            def slow(budget):
                clock.advance(8.0)
                return True

            drain.step("slow", slow)
            budgets = []
            drain.step("next", lambda budget: budgets.append(budget) or True)
            report = drain.finish()
            assert budgets == [2.0]  # deadline is shared, not per-step
            assert report.outcome == s.drain.DRAIN_CLEAN
            return budgets, self._report(report)

        both(run)

    def test_exhausted_deadline_still_runs_steps_with_zero_budget(self):
        def run(s):
            clock = FakeClock(0.0)
            drain = s.runtime.DrainController("test", deadline_s=1.0, clock=clock)
            drain.step("eats-it", lambda budget: clock.advance(2.0) or True)
            ran = []
            drain.step("starved", lambda budget: ran.append(budget) or True)
            report = drain.finish()
            assert ran == [0.0]
            assert report.outcome == s.drain.DRAIN_DEADLINE_EXCEEDED
            assert report.steps[-1].ok
            return ran, self._report(report)

        both(run)

    def test_raising_step_is_recorded_and_drain_continues(self):
        def run(s):
            drain = s.runtime.DrainController("test", deadline_s=10.0, clock=FakeClock(0.0))

            def explode(budget):
                raise RuntimeError("boom")

            ran = []
            drain.step("explodes", explode)
            drain.step("after", lambda budget: ran.append(1) or True)
            report = drain.finish()
            assert ran == [1]
            assert report.outcome == s.drain.DRAIN_STEP_ERROR
            assert "boom" in report.steps[0].detail
            return self._report(report)

        both(run)

    def test_none_return_counts_as_success(self):
        def run(s):
            drain = s.runtime.DrainController("test", deadline_s=10.0, clock=FakeClock(0.0))
            drain.step("returns-none", lambda budget: None)
            report = drain.finish()
            assert report.outcome == s.drain.DRAIN_CLEAN
            return self._report(report)

        both(run)

    def test_summary_is_greppable(self):
        def run(s):
            drain = s.runtime.DrainController("sigterm", deadline_s=5.0, clock=FakeClock(0.0))
            drain.step("flush", lambda budget: True)
            summary = drain.finish().summary()
            assert "reason=sigterm" in summary
            assert "outcome=clean" in summary
            assert "flush=ok" in summary
            return summary

        both(run)


class TestInstallDrainHandler:
    @pytest.mark.parametrize("side", [J, T], ids=["jax", "port"])
    def test_handler_raises_drain_signal_and_restores(self, side):
        """The handler turns SIGTERM into ``DrainSignal`` and the
        returned callable puts the previous handler back.  The signal
        is raised in this thread (``signal.raise_signal``), so the
        Python handler runs before the next statement."""
        assert threading.current_thread() is threading.main_thread()
        previous = signal.getsignal(signal.SIGTERM)
        restore = side.runtime.install_drain_handler()
        try:
            with pytest.raises(side.runtime.DrainSignal) as caught:
                signal.raise_signal(signal.SIGTERM)
            assert caught.value.signum == signal.SIGTERM
        finally:
            restore()
        assert signal.getsignal(signal.SIGTERM) is previous

    @pytest.mark.parametrize("side", [J, T], ids=["jax", "port"])
    def test_off_main_thread_install_is_a_noop(self, side):
        previous = signal.getsignal(signal.SIGTERM)
        outcome = {}

        def worker():
            restore = side.runtime.install_drain_handler()
            restore()
            outcome["ok"] = True

        thread = threading.Thread(target=worker)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
        assert outcome == {"ok": True}
        assert signal.getsignal(signal.SIGTERM) is previous


# ---- supervisor --------------------------------------------------------


def make_supervisor(s, clock, restart_ok=True, heartbeat_timeout_s=10.0,
                    flap_restarts=3, flap_window_s=100.0, flap_holddown_s=300.0):
    calls = {"restarts": [], "sheds": []}

    def restart(signal):
        calls["restarts"].append(signal)
        return restart_ok

    def shed(signal, reason):
        calls["sheds"].append((signal, reason))

    supervisor = s.runtime.ProbeSupervisor(
        config=s.runtime.SupervisorConfig(
            heartbeat_timeout_s=heartbeat_timeout_s,
            restart_backoff_base_s=1.0,
            restart_backoff_cap_s=60.0,
            flap_restarts=flap_restarts,
            flap_window_s=flap_window_s,
            flap_holddown_s=flap_holddown_s,
        ),
        restart=restart,
        shed=shed,
        clock=clock,
    )
    return supervisor, calls


def _actions(events) -> list[str]:
    return [e.action for e in events]


class TestHeartbeat:
    def test_fresh_heartbeat_means_no_action(self):
        def run(s):
            clock = FakeClock()
            supervisor, calls = make_supervisor(s, clock)
            supervisor.watch(["dns_latency_ms"])
            clock.advance(5.0)
            supervisor.beat("dns_latency_ms")
            clock.advance(5.0)
            assert supervisor.evaluate() == []
            assert calls["restarts"] == []
            assert supervisor.heartbeat_age_s("dns_latency_ms") == 5.0
            return supervisor.snapshot()

        both(run)

    def test_beat_on_unwatched_signal_is_ignored(self):
        def run(s):
            supervisor, _ = make_supervisor(s, FakeClock())
            supervisor.beat("never_watched")  # no raise
            assert supervisor.heartbeat_age_s("never_watched") == 0.0
            return supervisor.snapshot()

        both(run)

    def test_dead_probe_is_restarted(self):
        def run(s):
            clock = FakeClock()
            supervisor, calls = make_supervisor(s, clock)
            supervisor.watch(["dns_latency_ms", "tcp_retransmits_total"])
            supervisor.beat("dns_latency_ms")  # proven alive once
            clock.advance(11.0)
            supervisor.beat("tcp_retransmits_total")
            events = supervisor.evaluate()
            assert _actions(events) == [s.supervisor.ACTION_RESTARTED]
            assert calls["restarts"] == ["dns_latency_ms"]
            # A successful restart grants a fresh heartbeat window.
            assert supervisor.evaluate() == []
            return _actions(events), calls, supervisor.export_state()

        both(run)

    def test_unproven_quiet_probe_is_never_restarted(self):
        def run(s):
            clock = FakeClock()
            supervisor, calls = make_supervisor(s, clock)
            supervisor.watch(["tcp_retransmits_total"])
            for _ in range(50):
                clock.advance(60.0)
                assert supervisor.evaluate() == []
            assert calls == {"restarts": [], "sheds": []}
            return calls

        both(run)


class TestBackoff:
    def test_failed_restarts_back_off_exponentially(self):
        def run(s):
            clock = FakeClock()
            supervisor, calls = make_supervisor(s, clock, restart_ok=False)
            supervisor.watch(["dns_latency_ms"])
            supervisor.beat("dns_latency_ms")
            seen = []
            for dt in (11.0, 0.0, 1.0, 1.0, 1.0):
                clock.advance(dt)
                seen.append(_actions(supervisor.evaluate()))
            failed = [s.supervisor.ACTION_RESTART_FAILED]
            # inside the 1 s backoff, then doubled to 2 s
            assert seen == [failed, [], failed, [], failed]
            assert len(calls["restarts"]) == 3
            assert supervisor.restarts_total == 3
            return seen, supervisor.export_state()

        both(run)


def _flap_shed(clock, supervisor):
    supervisor.watch(["dns_latency_ms"])
    supervisor.beat("dns_latency_ms")
    for _ in range(3):
        clock.advance(11.0)
        supervisor.evaluate()
    clock.advance(11.0)
    return supervisor.evaluate()


class TestFlapShed:
    def test_k_restarts_in_window_sheds_with_reason(self):
        def run(s):
            clock = FakeClock()
            supervisor, calls = make_supervisor(s, clock, restart_ok=True)
            supervisor.watch(["dns_latency_ms"])
            supervisor.beat("dns_latency_ms")
            # The probe "recovers" after each restart, then dies again.
            for _ in range(3):
                clock.advance(11.0)
                events = supervisor.evaluate()
                assert _actions(events) == [s.supervisor.ACTION_RESTARTED]
            clock.advance(11.0)
            events = supervisor.evaluate()
            assert _actions(events) == [s.supervisor.ACTION_FLAP_SHED]
            assert calls["sheds"] == [("dns_latency_ms", s.supervisor.REASON_FLAPPING)]
            assert supervisor.shed_reasons == {"dns_latency_ms": s.supervisor.REASON_FLAPPING}
            assert supervisor.flap_sheds_total == 1
            # Shed probes are no longer supervised (no restart storms).
            clock.advance(50.0)
            assert supervisor.evaluate() == []
            return calls, supervisor.export_state()

        both(run)

    def test_old_restarts_age_out_of_the_window(self):
        def run(s):
            clock = FakeClock()
            supervisor, calls = make_supervisor(s, clock, restart_ok=True, flap_window_s=30.0)
            supervisor.watch(["dns_latency_ms"])
            supervisor.beat("dns_latency_ms")
            for _ in range(6):
                clock.advance(40.0)  # each restart falls out of the window
                assert _actions(supervisor.evaluate()) == [s.supervisor.ACTION_RESTARTED]
            assert calls["sheds"] == []
            return calls

        both(run)


class TestHoldDown:
    def test_may_restore_blocks_until_holddown_expires(self):
        def run(s):
            clock = FakeClock()
            supervisor, _ = make_supervisor(s, clock, flap_holddown_s=300.0)
            _flap_shed(clock, supervisor)
            seen = [supervisor.may_restore("dns_latency_ms")]
            for dt in (299.0, 2.0):
                clock.advance(dt)
                seen.append(supervisor.may_restore("dns_latency_ms"))
            assert seen == [False, False, True]
            assert supervisor.shed_reasons == {}  # hold-down cleared
            return seen

        both(run)

    def test_unheld_signals_are_always_restorable(self):
        both(lambda s: make_supervisor(s, FakeClock())[0].may_restore("anything") is True)

    def test_note_restored_resumes_supervision(self):
        def run(s):
            clock = FakeClock()
            supervisor, _ = make_supervisor(s, clock)
            _flap_shed(clock, supervisor)
            clock.advance(301.0)
            supervisor.note_restored("dns_latency_ms")
            assert "dns_latency_ms" in supervisor.snapshot()["watched"]
            return supervisor.snapshot()

        both(run)

    def test_holddown_survives_snapshot_restore(self):
        def run(s):
            clock = FakeClock()
            supervisor, _ = make_supervisor(s, clock, flap_holddown_s=300.0)
            _flap_shed(clock, supervisor)
            clock.advance(100.0)
            exported = supervisor.export_state()
            clock2 = FakeClock(90_000.0)  # a different monotonic epoch
            restored, _ = make_supervisor(s, clock2, flap_holddown_s=300.0)
            restored.restore_state(exported)
            assert not restored.may_restore("dns_latency_ms")
            assert restored.shed_reasons == {"dns_latency_ms": s.supervisor.REASON_FLAPPING}
            clock2.advance(201.0)  # 100 s already served before the crash
            assert restored.may_restore("dns_latency_ms")
            return exported

        both(run)

    def test_holddown_crosses_the_packages(self):
        """A hold-down exported by one package's supervisor is honoured
        by the other's, both ways."""
        for src, dst in ((J, T), (T, J)):
            clock = FakeClock()
            supervisor, _ = make_supervisor(src, clock, flap_holddown_s=300.0)
            _flap_shed(clock, supervisor)
            clock.advance(100.0)
            clock2 = FakeClock(90_000.0)
            restored, _ = make_supervisor(dst, clock2, flap_holddown_s=300.0)
            restored.restore_state(json.loads(json.dumps(supervisor.export_state())))
            assert not restored.may_restore("dns_latency_ms")
            clock2.advance(201.0)
            assert restored.may_restore("dns_latency_ms")


class TestRecoveryPolicyInterplay:
    """Flap hold-down outranks the overhead-guard recovery streak."""

    @staticmethod
    def _under_budget(s):
        return s.safety.OverheadResult(valid=True, cpu_pct=0.5, budget_pct=3.0,
                                       over_budget=False)

    def _restore_loop(self, s, clock, supervisor, recovery, shed_list, restored_order):
        for _ in range(40):
            clock.advance(1.0)
            if not recovery.note(self._under_budget(s)):
                continue
            candidate = shed_list[-1] if shed_list else None
            if candidate is None:
                continue
            if not supervisor.may_restore(candidate):
                continue  # held down: the streak is spent, not the shed
            restored_order.append(shed_list.pop())
            supervisor.note_restored(candidate)

    def test_flap_shed_is_not_restored_by_recovery_streak(self):
        def run(s):
            clock = FakeClock()
            supervisor, _ = make_supervisor(s, clock, flap_holddown_s=300.0)
            # A fake shed list, cheap to costly: [syscall (guard), dns
            # (flap), tcp (guard)]; restore pops the tail.
            shed_list = ["syscall_latency_ms"]
            supervisor._shed = lambda signal, reason: shed_list.append(signal)
            _flap_shed(clock, supervisor)
            shed_list.append("tcp_retransmits_total")  # later guard shed
            assert shed_list == ["syscall_latency_ms", "dns_latency_ms",
                                 "tcp_retransmits_total"]
            recovery = s.safety.ShedRecoveryPolicy(cycles=2)
            restored_order = []
            self._restore_loop(s, clock, supervisor, recovery, shed_list, restored_order)
            # tcp restores at once; dns is held and blocks syscall.
            assert restored_order == ["tcp_retransmits_total"]
            assert shed_list == ["syscall_latency_ms", "dns_latency_ms"]
            clock.advance(400.0)  # hold-down expiry releases the rest
            self._restore_loop(s, clock, supervisor, recovery, shed_list, restored_order)
            assert restored_order == ["tcp_retransmits_total", "dns_latency_ms",
                                      "syscall_latency_ms"]
            return restored_order

        both(run)

    def test_recovery_streak_is_consumed_by_a_held_candidate(self):
        def run(s):
            clock = FakeClock()
            supervisor, _ = make_supervisor(s, clock, flap_holddown_s=300.0)
            _flap_shed(clock, supervisor)
            recovery = s.safety.ShedRecoveryPolicy(cycles=3)
            authorized = 0
            for _ in range(9):
                if recovery.note(self._under_budget(s)):
                    authorized += 1
                    assert not supervisor.may_restore("dns_latency_ms")
            assert authorized == 3
            assert recovery.streak == 0
            return authorized

        both(run)
