"""Self-tracing: the toolkit observing its own loops (the port's own copy
of ``tpuslo/obs/tracer.py``).

Each cycle of a loop (an agent cycle; here, a front-door ``step``) runs
under a root span with one child span per stage, in the same
dependency-light style as the JAX package: no OTel SDK, plain
dataclasses, a single-threaded hot path (the only cross-thread handoff is
the export callback).

Sampling is tail-based: the keep/drop decision is taken at cycle *end*,
when the duration and error status are known — slow cycles (past the
configured budget) and cycles containing an error span are always
kept; the rest are sampled with the injected ``rng``, so the same seeded
RNG makes the same keep decisions as the JAX tracer.  Stage timings feed
the metrics observer on every cycle regardless of the sampling verdict.

A measured-overhead gate keeps the tracer honest about its own cost: it
times its bookkeeping against the cycle wall time, and if the EMA of
that ratio exceeds the configured budget the tracer degrades to
metrics-only (span sampling/export stops) rather than taxing the loop
it exists to observe.  The gate heals itself once the ratio recovers.

``self_tracer=`` stays a duck-typed argument of the engines: any object
with ``cycle(name, **attrs)`` returning a context manager whose value has
``stage(name)`` works; without one, a step runs under
:data:`_NULL_CYCLE`, whose stages record nothing.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable

STATUS_OK = "ok"
STATUS_ERROR = "error"

#: Canonical stage order of the agent's synthetic loop; the ring loop
#: uses a subset.  Kept here so dashboards/tests share one source.
CYCLE_STAGES = (
    "generate",
    "ingest_gate",
    "validate",
    "correlate",
    "attribute",
    "deliver",
    "snapshot",
)

# Sampling verdicts (bounded set: metric label values).
KEPT_SLOW = "kept_slow"
KEPT_ERROR = "kept_error"
KEPT_FORCED = "kept_forced"
KEPT_PROBABILISTIC = "kept_probabilistic"
DROPPED = "dropped"


# Non-cryptographic id source, seeded from the OS: os.urandom costs
# ~10µs per call on older kernels, which at nine ids per cycle would be
# the tracer's single biggest tax.  Trace ids need uniqueness, not
# unpredictability.
_ID_RNG = random.Random(int.from_bytes(os.urandom(8), "big"))


def new_trace_id() -> str:
    """128-bit lowercase-hex W3C trace id."""
    return f"{_ID_RNG.getrandbits(128):032x}"


def new_span_id() -> str:
    """64-bit lowercase-hex W3C span id."""
    return f"{_ID_RNG.getrandbits(64):016x}"


@dataclass(slots=True)
class Span:
    """One finished (or in-flight) span of the agent's own pipeline."""

    name: str
    trace_id: str
    span_id: str
    parent_span_id: str = ""
    start_unix_nano: int = 0
    end_unix_nano: int = 0
    status: str = STATUS_OK
    attributes: dict[str, Any] = field(default_factory=dict)

    def set(self, **attrs: Any) -> None:
        """Attach attributes (batch size, rejects, breaker state, …)."""
        self.attributes.update(attrs)

    @property
    def duration_ms(self) -> float:
        return max(0, self.end_unix_nano - self.start_unix_nano) / 1e6


class _NullSpan:
    """Attribute sink for the disabled tracer: every call is a no-op."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _StageCM:
    """Hand-rolled stage context manager that IS the stage record.

    Two costs drove this shape: ``contextlib.contextmanager`` burns
    ~2-3µs per use in generator machinery, and a separate ``Span``
    dataclass per stage costs another microsecond of 8-kwarg
    construction — at eight managed blocks per cycle that was the
    tracer's largest tax.  One slotted object serves as context
    manager, attribute sink, and timing record; real :class:`Span`
    objects (ids, wall-clock anchoring) are materialized at cycle end
    for kept cycles only.  Timestamps are raw ``perf_counter_ns``.
    """

    __slots__ = (
        "_trace",
        "name",
        "start_unix_nano",
        "end_unix_nano",
        "status",
        "attributes",
    )

    def __init__(self, trace: "CycleTrace", name: str, attrs: dict):
        self._trace = trace
        self.name = name
        self.attributes = attrs
        self.status = STATUS_OK
        self.end_unix_nano = 0
        self.start_unix_nano = time.perf_counter_ns()

    def set(self, **attrs: Any) -> None:
        """Attach attributes (batch size, rejects, breaker state, …)."""
        self.attributes.update(attrs)

    @property
    def duration_ms(self) -> float:
        return max(0, self.end_unix_nano - self.start_unix_nano) / 1e6

    def __enter__(self) -> "_StageCM":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        trace = self._trace
        self.end_unix_nano = time.perf_counter_ns()
        if exc_type is not None:
            self.status = STATUS_ERROR
            trace.error = True
        trace.spans.append(self)
        return False


class TraceObserver:
    """Metrics seam — no-op base so the tracer stays prometheus-free.

    One callback per cycle (not per stage): the prometheus observes are
    the tracer's dominant cost, so they are batched at cycle end where
    the sampling verdict is already known (exemplars attach only to
    kept cycles).
    """

    def cycle_complete(
        self,
        root: "Span",
        stage_spans: list["Span"],
        verdict: str,
        observe_stages: bool = True,
    ) -> None: ...

    def spans_exported(self, count: int) -> None: ...

    def overhead_pct(self, pct: float) -> None: ...


@dataclass
class TracerConfig:
    """Knobs for the self-tracer (config ``observability:`` section)."""

    enabled: bool = True
    #: Probability of keeping a fast, error-free cycle.
    sample_rate: float = 0.05
    #: Cycles at or past this duration are always kept (the p99 budget
    #: from config — "slow" by the operator's own definition).
    slow_cycle_ms: float = 250.0
    #: Measured tracer-overhead budget as percent of cycle wall time;
    #: a sustained breach degrades the tracer to metrics-only.
    max_overhead_pct: float = 5.0
    #: EMA smoothing for the overhead estimate.
    overhead_ema_alpha: float = 0.1
    #: Consecutive over-budget cycles before degrading.
    overhead_grace_cycles: int = 10
    #: Feed the stage/cycle histograms every Nth cycle (strictly
    #: periodic, so the decimation is duration-independent and the
    #: p50/p99 stay unbiased).  The prometheus observes are the
    #: tracer's single largest per-cycle cost; at a 1 Hz cadence a
    #: stride of 4 still lands ~900 samples per stage per hour.  The
    #: sampling-verdict counter is fed every cycle regardless.
    metrics_stride: int = 4


class CycleTrace:
    """One agent cycle: a root span plus its per-stage children."""

    __slots__ = (
        "trace_id",
        "root",
        "spans",
        "error",
        "keep",
        "_tracer",
        "_anchor_ns",
        "_mono0",
        "_self_ns",
    )

    def __init__(self, tracer: "SelfTracer", name: str, attrs: dict[str, Any]):
        t0 = time.perf_counter_ns()
        self._tracer = tracer
        self._anchor_ns = time.time_ns()
        self._mono0 = t0
        self.trace_id = new_trace_id()
        self.error = False
        self.keep = False
        self._self_ns = 0
        self.root = Span(
            name=name,
            trace_id=self.trace_id,
            span_id=new_span_id(),
            start_unix_nano=self._anchor_ns,
            attributes=attrs,
        )
        self.spans: list[Span] = []
        self._self_ns += time.perf_counter_ns() - t0

    def _now_ns(self) -> int:
        return self._anchor_ns + (time.perf_counter_ns() - self._mono0)

    def stage(self, name: str, **attrs: Any) -> _StageCM:
        """Time one pipeline stage as a child span of the cycle root.

        An exception marks the span (and the cycle) as error and
        propagates — tail sampling then keeps the cycle.  Stage
        records carry RAW ``perf_counter_ns`` timestamps until the
        cycle ends: durations need only the difference, and span ids /
        parent linkage / wall-clock conversion are paid at cycle end
        by kept cycles only — dropped cycles never pay for what they
        don't ship.
        """
        return _StageCM(self, name, attrs)

    def mark_keep(self) -> None:
        """Force tail sampling to keep this cycle (e.g. it produced an
        incident: the provenance record's trace pointer must resolve
        to an actually-exported trace)."""
        self.keep = True

    def finish(self) -> list[Span]:
        """Close the root span; returns root + children in start order."""
        self.root.end_unix_nano = self._now_ns()
        if self.error:
            self.root.status = STATUS_ERROR
        return [self.root, *self.spans]


class _NullStageCM:
    """Shared no-op stage context manager for the disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_STAGE_CM = _NullStageCM()


class _NullCycle:
    """Disabled-tracer cycle: ``stage`` costs well under a microsecond,
    nothing is recorded.  Shared instance — it holds no state."""

    __slots__ = ()

    trace_id = ""
    root = None
    error = False

    def stage(self, name: str, **attrs: Any) -> _NullStageCM:
        return _NULL_STAGE_CM

    def mark_keep(self) -> None:
        pass


_NULL_CYCLE = _NullCycle()


class _NullCycleCM:
    """Shared no-op cycle context manager for the disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> _NullCycle:
        return _NULL_CYCLE

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_CYCLE_CM = _NullCycleCM()


class _CycleCM:
    """Hand-rolled cycle context manager (see :class:`_StageCM`)."""

    __slots__ = ("_tracer", "_trace")

    def __init__(self, tracer: "SelfTracer", trace: "CycleTrace"):
        self._tracer = tracer
        self._trace = trace

    def __enter__(self) -> "CycleTrace":
        return self._trace

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            # An exception between stages still marks the cycle: tail
            # sampling must keep every error cycle.
            self._trace.error = True
        self._tracer._finish_cycle(self._trace)
        return False


class SelfTracer:
    """Factory + sampler + overhead gate for cycle traces.

    ``on_export`` receives the finished span list (root first) for
    every cycle the tail sampler keeps.  The callback runs on the loop
    thread; route it into a DeliveryChannel for non-blocking export.
    """

    def __init__(
        self,
        config: TracerConfig | None = None,
        observer: TraceObserver | None = None,
        on_export: Callable[[list[Span]], None] | None = None,
        rng: Callable[[], float] = random.random,
        log: Callable[[str], None] | None = None,
    ):
        self.config = config or TracerConfig()
        self._observer = observer or TraceObserver()
        self._on_export = on_export
        self._rng = rng
        self._log = log or (lambda msg: None)
        self.degraded = False
        self._overhead_ema = 0.0
        self._over_budget_streak = 0
        self.stats = {
            KEPT_SLOW: 0,
            KEPT_ERROR: 0,
            KEPT_FORCED: 0,
            KEPT_PROBABILISTIC: 0,
            DROPPED: 0,
            "cycles": 0,
            "spans_exported": 0,
            "export_errors": 0,
        }
        # Per-stage bookkeeping cost, calibrated once: the stage CMs
        # deliberately carry no self-timing (the timers would BE the
        # overhead), so the gate charges each recorded span this
        # measured constant instead.
        self._stage_cost_ns = (
            self._calibrate_stage_cost() if self.config.enabled else 0
        )

    def _calibrate_stage_cost(
        self, batches: int = 8, per_batch: int = 32
    ) -> int:
        """Min-of-batches: one scheduler stall inside a single timing
        loop would inflate the per-stage estimate by orders of
        magnitude and falsely trip the overhead gate; the minimum
        batch is the one the OS left alone."""
        trace = CycleTrace(self, "calibrate", {})
        best = None
        for _ in range(batches):
            t0 = time.perf_counter_ns()
            for _ in range(per_batch):
                with trace.stage("calibrate"):
                    pass
            elapsed = time.perf_counter_ns() - t0
            if best is None or elapsed < best:
                best = elapsed
        return (best or 0) // per_batch

    @property
    def enabled(self) -> bool:
        """Whether cycles are being traced at all (metrics included).

        Degradation does NOT flip this off: a degraded tracer keeps
        timing stages and feeding histograms (metrics-only mode) — it
        only stops sampling/exporting spans.  Histograms freezing at
        exactly the moment the loop is under pressure would be the
        opposite of observability.
        """
        return self.config.enabled

    @property
    def overhead_pct(self) -> float:
        return self._overhead_ema

    def cycle(
        self, name: str = "agent.cycle", **attrs: Any
    ) -> _CycleCM | _NullCycleCM:
        """Wrap one agent cycle; spans flow to sampling/export on exit.

        The context manager itself never raises on export problems —
        the loop being traced must not die of its own telemetry."""
        if not self.enabled:
            return _NULL_CYCLE_CM
        return _CycleCM(self, CycleTrace(self, name, attrs))

    def _finish_cycle(self, trace: CycleTrace) -> None:
        b0 = time.perf_counter_ns()
        duration_ms = trace.finish()[0].duration_ms
        verdict = self._verdict(trace, duration_ms)
        kept = verdict != DROPPED
        observe_stages = (
            self.stats["cycles"] % max(1, self.config.metrics_stride) == 0
        )
        self.stats["cycles"] += 1
        self.stats[verdict] += 1
        export_spans: list[Span] | None = None
        if kept:
            # Materialize real Spans — ids, parent linkage, wall-clock
            # anchoring — only for cycles that actually ship (stage
            # records hold raw perf_counter_ns until here).
            root_id = trace.root.span_id
            offset = trace._anchor_ns - trace._mono0
            export_spans = [
                Span(
                    name=rec.name,
                    trace_id=trace.trace_id,
                    span_id=new_span_id(),
                    parent_span_id=root_id,
                    start_unix_nano=rec.start_unix_nano + offset,
                    end_unix_nano=rec.end_unix_nano + offset,
                    status=rec.status,
                    attributes=rec.attributes,
                )
                for rec in trace.spans
            ]
        self._observer.cycle_complete(
            trace.root, trace.spans, verdict, observe_stages
        )
        if kept and self._on_export is not None:
            trace.root.set(
                sampling=verdict,
                self_overhead_ms=round(trace._self_ns / 1e6, 4),
            )
            try:
                self._on_export([trace.root, *export_spans])
                self.stats["spans_exported"] += 1 + len(export_spans)
                self._observer.spans_exported(1 + len(export_spans))
            except Exception as exc:  # noqa: BLE001 — never kill the loop
                self.stats["export_errors"] += 1
                self._log(f"trace export failed: {exc}")
        self._note_overhead(
            trace._self_ns
            + len(trace.spans) * self._stage_cost_ns
            + (time.perf_counter_ns() - b0),
            trace.root.end_unix_nano - trace.root.start_unix_nano,
            publish=observe_stages,
        )

    def _verdict(self, trace: CycleTrace, duration_ms: float) -> str:
        if self.degraded:
            # Metrics-only mode: histograms keep filling upstream and
            # only the rare, highest-value cycles still export — errors
            # and force-kept incident cycles (whose provenance records
            # embed the trace pointer; dropping them would dangle it).
            if trace.error:
                return KEPT_ERROR
            if trace.keep:
                return KEPT_FORCED
            return DROPPED
        if trace.error:
            return KEPT_ERROR
        if trace.keep:
            return KEPT_FORCED
        if duration_ms >= self.config.slow_cycle_ms:
            return KEPT_SLOW
        if self._rng() < self.config.sample_rate:
            return KEPT_PROBABILISTIC
        return DROPPED

    def _note_overhead(
        self, self_ns: int, cycle_ns: int, publish: bool = True
    ) -> None:
        """Measured-overhead gate: degrade rather than tax the loop.

        Degradation is metrics-only, and it heals: the EMA keeps being
        measured in degraded mode, and once it falls back under half
        the budget for a full grace window, span sampling re-arms.
        ``publish`` decimates only the gauge write; the EMA itself
        updates every cycle.
        """
        if cycle_ns <= 0:
            return
        pct = 100.0 * self_ns / cycle_ns
        alpha = self.config.overhead_ema_alpha
        self._overhead_ema = (1 - alpha) * self._overhead_ema + alpha * pct
        if publish:
            self._observer.overhead_pct(self._overhead_ema)
        if not self.degraded:
            if self._overhead_ema > self.config.max_overhead_pct:
                self._over_budget_streak += 1
                if (
                    self._over_budget_streak
                    >= self.config.overhead_grace_cycles
                ):
                    self.degraded = True
                    self._over_budget_streak = 0
                    self._log(
                        f"self-tracing overhead {self._overhead_ema:.2f}% "
                        f"> {self.config.max_overhead_pct:.2f}% budget; "
                        "degrading to metrics-only (histograms stay "
                        "live, span export off)"
                    )
            else:
                self._over_budget_streak = 0
        else:
            if self._overhead_ema < self.config.max_overhead_pct * 0.5:
                self._over_budget_streak += 1
                if (
                    self._over_budget_streak
                    >= self.config.overhead_grace_cycles
                ):
                    self.degraded = False
                    self._over_budget_streak = 0
                    self._log(
                        f"self-tracing overhead back to "
                        f"{self._overhead_ema:.2f}%; span export re-armed"
                    )
            else:
                self._over_budget_streak = 0

    def snapshot(self) -> dict[str, Any]:
        """Point-in-time stats for logs and tests."""
        return {
            **self.stats,
            "overhead_pct": round(self._overhead_ema, 3),
            "degraded": self.degraded,
        }
