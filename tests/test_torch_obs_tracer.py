"""The port's recording self-tracer (``tpuslo_torch.obs.tracer``) against
the JAX package's: span trees, tail sampling, forced keeps and the
overhead gate (the tracer cases of ``tests/test_obs_tracer.py``; the OTLP
exporter, the background poster and the provenance log live in other
JAX modules and are not ported).

Keep decisions are held to JAX's: both tracers draw from a
``random.Random`` of one seed, and their per-cycle verdicts must be
equal.
"""

from __future__ import annotations

import random

import pytest

from tpuslo.obs import tracer as jt
from tpuslo_torch.obs import (
    CYCLE_STAGES,
    DROPPED,
    KEPT_ERROR,
    KEPT_FORCED,
    KEPT_PROBABILISTIC,
    KEPT_SLOW,
    SelfTracer,
    Span,
    TracerConfig,
    new_span_id,
    new_trace_id,
)
from tpuslo_torch.obs import tracer as tt


def run_cycle(tracer, stages=CYCLE_STAGES, fail_stage=None, **attrs):
    with tracer.cycle("agent.cycle", **attrs) as tr:
        for name in stages:
            with tr.stage(name, stage_attr=name) as sp:
                if name == fail_stage:
                    raise RuntimeError("stage boom")
                sp.set(batch=3)
    return tr


class Verdicts(tt.TraceObserver):
    def __init__(self):
        self.seen = []

    def cycle_complete(self, root, stage_spans, verdict, observe_stages=True):
        self.seen.append((root.name, [s.name for s in stage_spans], verdict))


def test_constants_equal_jax():
    assert CYCLE_STAGES == jt.CYCLE_STAGES
    assert (KEPT_SLOW, KEPT_ERROR, KEPT_FORCED, KEPT_PROBABILISTIC, DROPPED) == (
        jt.KEPT_SLOW, jt.KEPT_ERROR, jt.KEPT_FORCED, jt.KEPT_PROBABILISTIC, jt.DROPPED)
    assert TracerConfig() == TracerConfig(**vars(jt.TracerConfig()))


@pytest.mark.parametrize("seed", [0, 7, 1337])
@pytest.mark.parametrize("sample_rate", [0.05, 0.3, 0.9])
def test_keep_decisions_equal_jax_at_one_seed(seed, sample_rate):
    """200 cycles, some failing, some force-kept: the same seeded RNG
    makes the same verdict at every cycle in both tracers."""
    observed = []
    for mod in (jt, tt):
        obs = Verdicts()
        tracer = mod.SelfTracer(
            mod.TracerConfig(sample_rate=sample_rate, slow_cycle_ms=1e9,
                             max_overhead_pct=1e9),
            observer=obs, rng=random.Random(seed).random,
        )
        for i in range(200):
            if i % 17 == 5:
                with pytest.raises(RuntimeError):
                    run_cycle(tracer, fail_stage="correlate")
            elif i % 23 == 11:
                with tracer.cycle("agent.cycle") as tr:
                    with tr.stage("attribute"):
                        tr.mark_keep()
            else:
                run_cycle(tracer)
        observed.append((obs.seen, dict(tracer.stats)))
    assert observed[1] == observed[0]
    stats = observed[1][1]
    assert stats[KEPT_PROBABILISTIC] > 0 and stats[DROPPED] > 0
    assert stats[KEPT_ERROR] == 12 and stats[KEPT_FORCED] == 9


class TestTracerSpans:
    def test_ids_are_hex_and_unique(self):
        tids = {new_trace_id() for _ in range(64)}
        sids = {new_span_id() for _ in range(64)}
        assert len(tids) == 64 and len(sids) == 64
        assert all(len(t) == 32 and int(t, 16) >= 0 for t in tids)
        assert all(len(s) == 16 and int(s, 16) >= 0 for s in sids)

    def test_cycle_builds_root_plus_stage_children(self):
        exported = []
        tracer = SelfTracer(
            TracerConfig(enabled=True, sample_rate=1.0), on_export=exported.append
        )
        run_cycle(tracer, cycle=7)
        assert len(exported) == 1
        root, children = exported[0][0], exported[0][1:]
        assert isinstance(root, Span)
        assert root.name == "agent.cycle"
        assert root.attributes["cycle"] == 7
        assert [s.name for s in children] == list(CYCLE_STAGES)
        for child in children:
            assert child.trace_id == root.trace_id
            assert child.parent_span_id == root.span_id
            assert child.span_id and child.span_id != root.span_id
            assert child.end_unix_nano >= child.start_unix_nano
            assert child.attributes["batch"] == 3
        assert root.end_unix_nano >= children[-1].end_unix_nano

    def test_disabled_tracer_records_nothing(self):
        exported = []
        tracer = SelfTracer(TracerConfig(enabled=False), on_export=exported.append)
        tr = run_cycle(tracer)
        assert exported == []
        assert tracer.stats["cycles"] == 0
        assert tr.trace_id == ""  # the shared null cycle
        assert tr is tt._NULL_CYCLE

    def test_stage_timings_are_ordered(self):
        exported = []
        tracer = SelfTracer(
            TracerConfig(enabled=True, sample_rate=1.0), on_export=exported.append
        )
        run_cycle(tracer)
        starts = [s.start_unix_nano for s in exported[0][1:]]
        assert starts == sorted(starts)


class TestTailSampling:
    def test_slow_cycles_always_kept(self):
        exported = []
        tracer = SelfTracer(
            TracerConfig(enabled=True, sample_rate=0.0, slow_cycle_ms=0.0),
            on_export=exported.append,
        )
        for _ in range(5):
            run_cycle(tracer)
        assert tracer.stats[KEPT_SLOW] == 5
        assert len(exported) == 5

    def test_error_cycles_always_kept_and_marked(self):
        exported = []
        tracer = SelfTracer(
            TracerConfig(enabled=True, sample_rate=0.0, slow_cycle_ms=1e9),
            on_export=exported.append,
        )
        with pytest.raises(RuntimeError):
            run_cycle(tracer, fail_stage="validate")
        assert tracer.stats[KEPT_ERROR] == 1
        assert exported[0][0].status == "error"
        failed = [s for s in exported[0][1:] if s.name == "validate"]
        assert failed and failed[0].status == "error"

    def test_probabilistic_sampling_uses_rng(self):
        cfg = dict(enabled=True, sample_rate=0.5, slow_cycle_ms=1e9)
        kept = SelfTracer(TracerConfig(**cfg), rng=lambda: 0.4)
        dropped = SelfTracer(TracerConfig(**cfg), rng=lambda: 0.6)
        run_cycle(kept)
        run_cycle(dropped)
        assert kept.stats[KEPT_PROBABILISTIC] == 1
        assert dropped.stats[DROPPED] == 1

    def test_dropped_cycles_skip_span_ids_and_export(self):
        exported = []
        tracer = SelfTracer(
            TracerConfig(enabled=True, sample_rate=0.0, slow_cycle_ms=1e9),
            on_export=exported.append,
        )
        tr = run_cycle(tracer)
        assert exported == []
        assert all(not getattr(s, "span_id", "") for s in tr.spans)
        assert all(s.duration_ms >= 0 for s in tr.spans)

    def test_export_failure_is_counted_not_raised(self):
        def boom(spans):
            raise OSError("sink down")

        tracer = SelfTracer(TracerConfig(enabled=True, sample_rate=1.0), on_export=boom)
        run_cycle(tracer)
        assert tracer.stats["export_errors"] == 1


class TestForcedKeep:
    def test_mark_keep_forces_sampling(self):
        exported = []
        tracer = SelfTracer(
            TracerConfig(enabled=True, sample_rate=0.0, slow_cycle_ms=1e9),
            on_export=exported.append,
        )
        with tracer.cycle("agent.cycle") as tr:
            with tr.stage("attribute"):
                tr.mark_keep()
        assert tracer.stats[KEPT_FORCED] == 1
        assert len(exported) == 1
        assert all(s.span_id for s in exported[0])

    def test_null_cycle_mark_keep_is_noop(self):
        tracer = SelfTracer(TracerConfig(enabled=False))
        with tracer.cycle("agent.cycle") as tr:
            tr.mark_keep()
        assert tracer.stats["cycles"] == 0

    def test_no_export_callback_counts_nothing_exported(self):
        tracer = SelfTracer(TracerConfig(enabled=True, sample_rate=1.0))
        run_cycle(tracer)
        assert tracer.stats["spans_exported"] == 0


class TestOverheadGate:
    def _overloaded_tracer(self, **overrides):
        cfg = dict(enabled=True, sample_rate=0.0, slow_cycle_ms=1e9,
                   max_overhead_pct=0.000001, overhead_grace_cycles=3)
        cfg.update(overrides)
        return SelfTracer(TracerConfig(**cfg))

    def test_sustained_overhead_degrades_to_metrics_only(self):
        tracer = self._overloaded_tracer()
        for _ in range(10):
            run_cycle(tracer)
        assert tracer.degraded
        assert tracer.enabled
        before = tracer.stats["cycles"]
        run_cycle(tracer)
        assert tracer.stats["cycles"] == before + 1
        assert tracer.stats[DROPPED] >= 1

    def test_degraded_tracer_still_keeps_error_cycles(self):
        exported = []
        tracer = self._overloaded_tracer()
        tracer._on_export = exported.append
        for _ in range(10):
            run_cycle(tracer)
        assert tracer.degraded
        exported.clear()
        with pytest.raises(RuntimeError):
            run_cycle(tracer, fail_stage="deliver")
        assert len(exported) == 1

    def test_degraded_tracer_still_keeps_forced_incident_cycles(self):
        exported = []
        tracer = self._overloaded_tracer()
        tracer._on_export = exported.append
        for _ in range(10):
            run_cycle(tracer)
        assert tracer.degraded
        exported.clear()
        with tracer.cycle("agent.cycle") as tr:
            with tr.stage("attribute"):
                tr.mark_keep()
        assert len(exported) == 1

    def test_degradation_heals_when_overhead_recovers(self):
        import time as time_mod

        tracer = self._overloaded_tracer(overhead_grace_cycles=2)
        for _ in range(5):
            run_cycle(tracer)
        assert tracer.degraded
        tracer.config.max_overhead_pct = 1e9
        for _ in range(10):
            with tracer.cycle("agent.cycle") as tr:
                with tr.stage("generate"):
                    time_mod.sleep(0.001)
        assert not tracer.degraded

    def test_healthy_overhead_does_not_degrade(self):
        tracer = SelfTracer(
            TracerConfig(enabled=True, sample_rate=0.0, max_overhead_pct=1e9)
        )
        for _ in range(20):
            run_cycle(tracer)
        assert not tracer.degraded
        snap = tracer.snapshot()
        assert snap["overhead_pct"] >= 0.0
        assert set(snap) == set(jt.SelfTracer(jt.TracerConfig()).snapshot())
