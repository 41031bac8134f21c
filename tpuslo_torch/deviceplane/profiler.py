"""Continuous device profiler: sampled capture windows on a live process
(the port's counterpart of ``tpuslo/deviceplane/profiler.py``).

* **capture** — short periodic windows on a stride of cycles.  Two
  lanes share ONE parse path (``xla_spans.parse_trace_events``): the
  ``"torch"`` lane brackets a workload callable with
  :class:`tpuslo_torch.otel.xla_spans.capture` (``torch.profiler``; the
  JAX module's ``"xprof"`` lane), and the seeded
  ``synthetic.synthesize_xprof_trace`` lane is the platform-independent
  feed.
* **fold** — each window runs the full ``build_ledger`` join ladder,
  with the capture's compile events folded in (eager PyTorch compiles
  nothing, so the ``"torch"`` lane has none).
* **emit** — the window's deltas become contract-valid probe payloads
  (``device_idle_gap_ms``, ``device_eviction_events_total``,
  ``device_unexplained_share``, ``device_mfu_pct``) shaped exactly like
  ``xla_spans._launch_signal_events`` output.  A roofline verdict
  (``verdict_from_ledger``, against the card's roofs: given, or read
  from the card with ``card_peaks``) rides on the window record.
* **govern** — an EMA of capture+parse cost against the cycle budget,
  amortised over the stride.  Past the 3% budget for a grace streak the
  stride doubles (capped); sustained headroom below half budget
  re-engages the base stride.  A pending eviction notice FORCES the
  next capture even while degraded.

Every window carries BOTH the raw exact-identity join rate and the
tiered substantive rate, read straight off the window's ledger.
:func:`run_profiler_sweep` is the JAX module's seeded sweep gate (five
lanes over the synthetic source, the preemption lane through the port's
own ``BayesianAttributor``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from tpuslo_torch.deviceplane.ledger import build_ledger, dispatch_count
from tpuslo_torch.deviceplane.roofline import (
    card_peaks,
    decode_step_cost,
    verdict_from_ledger,
)
from tpuslo_torch.deviceplane.synthetic import (
    STEP_FINGERPRINT,
    synthesize_xprof_trace,
)
from tpuslo_torch.otel.xla_spans import parse_trace_events
from tpuslo_torch.signals import constants as sig

#: Wall-clock source bound at module import so hot methods hold a
#: reference instead of reading the clock primitive inline (hot-path
#: manifest rule); ``perf_counter_ns`` times the capture itself.
_CLOCK_NS = time.time_ns
_PERF_NS = time.perf_counter_ns

#: Overhead budget the governor defends: capture+parse may cost at most
#: this share of the serving loop's cycle budget, amortised over the
#: capture stride.
DEFAULT_OVERHEAD_BUDGET_PCT = 3.0


def seeded_cost_model(
    batch: int = 8, *, peak_bw: float
) -> tuple[float, float, tuple[float, float]]:
    """(bytes/step, FLOPs/step, decode-realistic ``step_dur_us`` bounds)
    for the seeded lane — llama32_1b at ``batch``, the serving lanes'
    operating point, with a step at ~30-40% of the ``peak_bw`` HBM roof
    (memory-bound verdicts)."""
    from tpuslo_torch.models.llama import kv_cache_bytes, llama32_1b, param_count

    cfg = llama32_1b(max_seq_len=1024)
    n_params = param_count(cfg)
    step_bytes, step_flops = decode_step_cost(
        n_params, kv_cache_bytes(cfg, batch), batch=batch
    )
    decode_ms = step_bytes / (0.35 * peak_bw) * 1e3
    return step_bytes, step_flops, (decode_ms * 900.0, decode_ms * 1150.0)


def concat_window_docs(
    docs: Sequence[dict[str, Any]],
    compile_event_lists: Sequence[Sequence[dict[str, Any]]] = (),
) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """Splice per-window trace docs into one contiguous capture.

    Each window's events are shifted so its first span starts exactly
    where the previous window's last span ended — the device timeline
    a single long capture would have produced (no artificial
    inter-window idle).  Compile-event ``end_us`` shifts with its
    window.  This is the parity fixture: per-window ledger buckets must
    sum to the one big ``build_ledger`` over the splice.
    """
    out_events: list[dict[str, Any]] = []
    out_compiles: list[dict[str, Any]] = []
    cursor = 0.0
    first = True
    for i, doc in enumerate(docs):
        events = doc.get("traceEvents", [])
        xs = [e for e in events if e.get("ph") == "X"]
        if not xs:
            continue
        lo = min(float(e["ts"]) for e in xs)
        hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in xs)
        offset = 0.0 if first else cursor - lo
        for e in events:
            if e.get("ph") == "X":
                shifted = dict(e)
                shifted["ts"] = float(e["ts"]) + offset
                out_events.append(shifted)
            elif first:
                out_events.append(e)  # lane metadata once
        if i < len(compile_event_lists):
            for ce in compile_event_lists[i]:
                shifted_ce = dict(ce)
                shifted_ce["end_us"] = float(ce.get("end_us", 0.0)) + offset
                out_compiles.append(shifted_ce)
        cursor = hi + offset
        first = False
    return {"traceEvents": out_events}, out_compiles


@dataclass(slots=True)
class ProfilerWindow:
    """One capture window's ledger deltas — the unit the spine sees."""

    index: int
    cycle: int
    ts_unix_nano: int
    window_ms: float
    idle_gap_ms: float
    eviction_events: int
    unexplained_share: float
    #: Roofline MFU for the window's serving program; -1.0 when the
    #: ledger joined nothing (no denominator — never invent one).
    mfu_pct: float
    #: Roofline verdict ("memory_bound"/"compute_bound", "" when none).
    verdict: str
    #: Raw exact-identity join rate over ALL launches (reported next to
    #: the tiered rate — the 0.556 lesson), straight off the ledger.
    raw_join_rate: float
    #: Tiered substantive rate — the one gates hold at >= 0.9.
    substantive_join_rate: float
    launches: int
    #: Compile fingerprints first seen in this window (live compile-tier
    #: feed: a burst here is a recompile storm reaching the chip).
    new_compilations: int
    capture_cost_ms: float
    stride_cycles: int
    degraded: bool
    #: True when a pending eviction notice forced this capture ahead of
    #: the stride (degradation never drops an eviction window).
    forced: bool
    verdict_detail: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "index": self.index,
            "cycle": self.cycle,
            "ts_unix_nano": self.ts_unix_nano,
            "window_ms": round(self.window_ms, 3),
            "idle_gap_ms": round(self.idle_gap_ms, 4),
            "eviction_events": self.eviction_events,
            "unexplained_share": round(self.unexplained_share, 4),
            "mfu_pct": round(self.mfu_pct, 2),
            "verdict": self.verdict,
            "raw_join_rate": round(self.raw_join_rate, 4),
            "substantive_join_rate": round(self.substantive_join_rate, 4),
            "launches": self.launches,
            "new_compilations": self.new_compilations,
            "capture_cost_ms": round(self.capture_cost_ms, 3),
            "stride_cycles": self.stride_cycles,
            "degraded": self.degraded,
            "forced": self.forced,
            "verdict_detail": self.verdict_detail,
        }


class ContinuousProfiler:
    """Stride-gated capture windows under a measured-overhead governor.

    ``tick()`` once per cycle; it returns a
    :class:`ProfilerWindow` on capture cycles and ``None`` otherwise.
    ``probe_payloads(window)`` turns a window into the four
    contract-valid probe payload dicts for the columnar loop.
    """

    def __init__(
        self,
        source: str = "synthetic",
        seed: int = 1337,
        cycle_budget_ms: float = 1000.0,
        overhead_budget_pct: float = DEFAULT_OVERHEAD_BUDGET_PCT,
        ema_alpha: float = 0.1,
        grace_cycles: int = 3,
        stride_cycles: int = 5,
        max_stride_cycles: int = 40,
        window_steps: int = 8,
        history: int = 32,
        bytes_per_step: float = 0.0,
        flops_per_step: float = 0.0,
        program_id: str = STEP_FINGERPRINT,
        node: str = "",
        namespace: str = "llm-slo",
        pod: str = "",
        chip: str = "accel0",
        slice_id: str = "",
        host_index: int = -1,
        log_dir: str = "",
        work_fn: Callable[[], None] | None = None,
        synthetic_preempt_window: int = -1,
        synthetic_preempt_gap_ms: float = 250.0,
        synthetic_orphan_helpers: int = 2,
        synthetic_warmups: int = 1,
        synthetic_lane_split_every: int = 5,
        synthetic_helpers_per_step: int = 1,
        step_dur_us: tuple[float, float] = (1800.0, 2600.0),
        capture_fn: Callable[[int], tuple[list[Any], list[Any]]] | None = None,
        cost_fn: Callable[[float], float] | None = None,
        observer: Any | None = None,
        peak_bw: float | None = None,
        peak_flops: float | None = None,
    ):
        if source not in ("synthetic", "torch"):
            raise ValueError(f"unknown profiler source: {source!r}")
        if source == "torch" and capture_fn is None:
            if not log_dir:
                raise ValueError("torch source needs a log_dir")
            if work_fn is None:
                raise ValueError(
                    "torch source needs a work_fn to bracket (the "
                    "capture window must contain device work)"
                )
        self.source = source
        self.seed = int(seed)
        self.cycle_budget_ms = float(cycle_budget_ms)
        self.overhead_budget_pct = float(overhead_budget_pct)
        self.ema_alpha = float(ema_alpha)
        self.grace_cycles = max(int(grace_cycles), 1)
        self.base_stride_cycles = max(int(stride_cycles), 1)
        self.max_stride_cycles = max(
            int(max_stride_cycles), self.base_stride_cycles
        )
        self.window_steps = max(int(window_steps), 2)
        self.history = max(int(history), 1)
        self.bytes_per_step = float(bytes_per_step)
        self.flops_per_step = float(flops_per_step)
        self.program_id = program_id
        self.node = node
        self.namespace = namespace
        self.pod = pod or node
        self.chip = chip
        self.slice_id = slice_id
        self.host_index = int(host_index)
        self.log_dir = log_dir
        self._work_fn = work_fn
        self.synthetic_preempt_window = int(synthetic_preempt_window)
        self.synthetic_preempt_gap_ms = float(synthetic_preempt_gap_ms)
        self.synthetic_orphan_helpers = int(synthetic_orphan_helpers)
        self.synthetic_warmups = int(synthetic_warmups)
        self.synthetic_lane_split_every = int(synthetic_lane_split_every)
        self.synthetic_helpers_per_step = int(synthetic_helpers_per_step)
        self.step_dur_us = (float(step_dur_us[0]), float(step_dur_us[1]))
        self._capture_fn = capture_fn
        self._cost_fn = cost_fn
        self._observer = observer
        if (peak_bw is None or peak_flops is None) and (
            self.bytes_per_step > 0.0 and self.flops_per_step > 0.0
        ):
            # A cost model needs roofs: the card's own, never a default.
            peak_bw, peak_flops = card_peaks()
        self.peak_bw = float(peak_bw or 0.0)
        self.peak_flops = float(peak_flops or 0.0)

        # Governor state.
        self.stride_cycles = self.base_stride_cycles
        self.degraded = False
        self.overhead_ema_pct = 0.0
        self._ema_primed = False
        self._streak_hot = 0
        self._streak_cool = 0

        # Loop state.
        self._cycle = 0
        self._last_capture_cycle = 0
        self._pending_evictions = 0
        self._window_index = 0
        self._seen_fingerprints: set[str] = set()
        self._windows: list[ProfilerWindow] = []
        #: Full roofline verdict dicts by window index — the window
        #: record keeps the compact verdict/MFU/detail triple; the
        #: provenance chain wants the whole block (achieved GB/s, roof
        #: percentages).  Trimmed alongside the window ring.
        self._roofline_by_index: dict[int, dict[str, Any]] = {}

        # Counters (observable: metrics + sloctl read these).
        self.windows_captured = 0
        self.windows_forced = 0
        self.degradations = 0
        self.reengagements = 0
        self.eviction_windows = 0

    # ---- eviction notices -------------------------------------------

    def notice_eviction(self, count: int = 1) -> None:
        """Runtime eviction/preemption notice: forces the next capture
        (even while degraded) and rides the window's event count."""
        self._pending_evictions += max(int(count), 0)

    # ---- capture lanes ----------------------------------------------

    def window_trace_doc(
        self, index: int
    ) -> tuple[dict[str, Any], list[dict[str, Any]]]:
        """The synthetic lane's deterministic per-window trace: window
        ``index`` always yields the same document (parity fixtures
        regenerate windows from indexes alone)."""
        gap_ms = (
            self.synthetic_preempt_gap_ms
            if index == self.synthetic_preempt_window
            else 0.0
        )
        doc, compiles, _truth = synthesize_xprof_trace(
            seed=self.seed + index,
            steps=self.window_steps,
            lane_split_every=self.synthetic_lane_split_every,
            helpers_per_step=self.synthetic_helpers_per_step,
            orphan_helpers=self.synthetic_orphan_helpers,
            warmup_launches=self.synthetic_warmups,
            preemption_gap_ms=gap_ms,
            step_dur_us=self.step_dur_us,
        )
        return doc, compiles

    def _capture(self, index: int) -> tuple[list[Any], list[Any]]:
        if self._capture_fn is not None:
            return self._capture_fn(index)
        if self.source == "torch":
            from tpuslo_torch.otel.xla_spans import capture as torch_capture

            with torch_capture(self.log_dir, include_ops=True) as cap:
                self._work_fn()
            return cap.spans, []
        doc, compiles = self.window_trace_doc(index)
        return parse_trace_events(doc, include_ops=True), compiles

    # ---- the governor (as in the self-tracer) -----------------------

    def _note_overhead(self, cost_ms: float) -> None:
        # Cost is paid once per stride cycles: amortise before
        # comparing against the budget, so degrading the stride
        # genuinely buys headroom.
        pct = 100.0 * cost_ms / (self.cycle_budget_ms * self.stride_cycles)
        if not self._ema_primed:
            self.overhead_ema_pct = pct
            self._ema_primed = True
        else:
            self.overhead_ema_pct = (
                self.ema_alpha * pct
                + (1.0 - self.ema_alpha) * self.overhead_ema_pct
            )
        if self.overhead_ema_pct > self.overhead_budget_pct:
            self._streak_cool = 0
            self._streak_hot += 1
            if (
                self._streak_hot >= self.grace_cycles
                and self.stride_cycles < self.max_stride_cycles
            ):
                self.stride_cycles = min(
                    self.stride_cycles * 2, self.max_stride_cycles
                )
                self.degraded = True
                self.degradations += 1
                self._streak_hot = 0
                if self._observer is not None:
                    self._observer.degraded(self.stride_cycles)
        elif (
            self.degraded
            and self.overhead_ema_pct < self.overhead_budget_pct * 0.5
        ):
            self._streak_hot = 0
            self._streak_cool += 1
            if self._streak_cool >= self.grace_cycles:
                self.stride_cycles = self.base_stride_cycles
                self.degraded = False
                self.reengagements += 1
                self._streak_cool = 0
                if self._observer is not None:
                    self._observer.reengaged(self.stride_cycles)
        else:
            self._streak_hot = 0
            self._streak_cool = 0

    # ---- the loop ----------------------------------------------------

    def tick(self) -> ProfilerWindow | None:
        """One agent cycle.  Captures when the stride elapses or an
        eviction notice is pending; returns the folded window then."""
        self._cycle += 1
        due = (self._cycle - self._last_capture_cycle) >= self.stride_cycles
        forced = self._pending_evictions > 0 and not due
        if not due and not forced:
            return None
        return self._capture_window(forced=forced)

    def _capture_window(self, forced: bool) -> ProfilerWindow:
        index = self._window_index
        t0 = _PERF_NS()
        spans, compiles = self._capture(index)
        ledger = build_ledger(spans, compiles)
        cost_ms = (_PERF_NS() - t0) / 1e6
        if self._cost_fn is not None:
            cost_ms = float(self._cost_fn(cost_ms))

        evictions = self._pending_evictions
        if (
            self.source == "synthetic"
            and self._capture_fn is None
            and index == self.synthetic_preempt_window
        ):
            # The injected preemption gap comes with its runtime
            # eviction notice, like a real maintenance event would.
            evictions += 1
        self._pending_evictions = 0

        new_fps = 0
        for ce in compiles:
            fp = str(
                ce.get("program_id", "")
                if isinstance(ce, dict)
                else getattr(ce, "program_id", "")
            )
            if fp and fp not in self._seen_fingerprints:
                self._seen_fingerprints.add(fp)
                new_fps += 1

        mfu_pct = -1.0
        verdict = ""
        verdict_detail = ""
        if self.bytes_per_step > 0.0 and self.flops_per_step > 0.0:
            rv = verdict_from_ledger(
                ledger,
                self.bytes_per_step,
                self.flops_per_step,
                program_id=self.program_id,
                peak_bw=self.peak_bw,
                peak_flops=self.peak_flops,
            )
            if rv is not None:
                mfu_pct = float(rv["mfu_pct"])
                verdict = rv["verdict"]
                verdict_detail = rv["detail"]
                self._roofline_by_index[index] = rv

        window = ProfilerWindow(
            index=index,
            cycle=self._cycle,
            ts_unix_nano=_CLOCK_NS(),
            window_ms=ledger.total_us / 1000.0,
            idle_gap_ms=ledger.idle_gap_ms(),
            eviction_events=evictions,
            unexplained_share=ledger.unexplained_share,
            mfu_pct=mfu_pct,
            verdict=verdict,
            raw_join_rate=ledger.raw_join_rate,
            substantive_join_rate=ledger.substantive_join_rate,
            launches=dispatch_count(ledger),
            new_compilations=new_fps,
            capture_cost_ms=cost_ms,
            stride_cycles=self.stride_cycles,
            degraded=self.degraded,
            forced=forced,
            verdict_detail=verdict_detail,
        )
        self._window_index += 1
        self._last_capture_cycle = self._cycle
        self.windows_captured += 1
        if forced:
            self.windows_forced += 1
        if evictions > 0:
            self.eviction_windows += 1
        self._windows.append(window)
        if len(self._windows) > self.history:
            del self._windows[: len(self._windows) - self.history]
        live = {w.index for w in self._windows}
        for stale in [
            k for k in self._roofline_by_index if k not in live
        ]:
            del self._roofline_by_index[stale]
        self._note_overhead(cost_ms)
        if self._observer is not None:
            self._observer.window(window, self.overhead_ema_pct)
        return window

    # ---- emission -----------------------------------------------------

    def probe_payloads(self, window: ProfilerWindow) -> list[dict[str, Any]]:
        """The window's four device signals as contract-valid probe
        payload dicts (``xla_spans._launch_signal_events`` shape) for
        ``columnar.from_payloads``."""
        from tpuslo_torch.signals.generator import signal_status

        tpu: dict[str, Any] = {"chip": self.chip}
        if self.slice_id:
            tpu["slice_id"] = self.slice_id
        if self.host_index >= 0:
            tpu["host_index"] = self.host_index
        if self.program_id:
            tpu["program_id"] = self.program_id
        values = (
            (sig.SIGNAL_DEVICE_IDLE_GAP_MS, window.idle_gap_ms, "ms"),
            (
                sig.SIGNAL_DEVICE_EVICTION_EVENTS,
                float(window.eviction_events),
                "count",
            ),
            (
                sig.SIGNAL_DEVICE_UNEXPLAINED_SHARE,
                window.unexplained_share,
                "ratio",
            ),
            (sig.SIGNAL_DEVICE_MFU_PCT, max(window.mfu_pct, 0.0), "pct"),
        )
        out: list[dict[str, Any]] = []
        for name, value, unit in values:
            out.append(
                {
                    "ts_unix_nano": window.ts_unix_nano,
                    "signal": name,
                    "node": self.node,
                    "namespace": self.namespace,
                    "pod": self.pod or self.node,
                    "container": "xprof",
                    "pid": 0,
                    "tid": 0,
                    "value": round(float(value), 4),
                    "unit": unit,
                    "status": signal_status(name, value),
                    "tpu": dict(tpu),
                }
            )
        return out

    def window_signal_values(
        self, window: ProfilerWindow
    ) -> dict[str, float]:
        """signal→value map for the attribution engine (same values the
        probe payloads carry — one source)."""
        return {
            sig.SIGNAL_DEVICE_IDLE_GAP_MS: window.idle_gap_ms,
            sig.SIGNAL_DEVICE_EVICTION_EVENTS: float(
                window.eviction_events
            ),
            sig.SIGNAL_DEVICE_UNEXPLAINED_SHARE: window.unexplained_share,
            sig.SIGNAL_DEVICE_MFU_PCT: max(window.mfu_pct, 0.0),
        }

    # ---- state / introspection ---------------------------------------

    def windows(self) -> list[ProfilerWindow]:
        return list(self._windows)

    def window_roofline(self, index: int) -> dict[str, Any]:
        """The full roofline verdict block for a retained window
        (empty when the window carried no cost model or has aged out
        of the ring)."""
        return dict(self._roofline_by_index.get(index, {}))

    def stats(self) -> dict[str, Any]:
        return {
            "source": self.source,
            "cycle": self._cycle,
            "windows_captured": self.windows_captured,
            "windows_forced": self.windows_forced,
            "eviction_windows": self.eviction_windows,
            "degradations": self.degradations,
            "reengagements": self.reengagements,
            "degraded": self.degraded,
            "stride_cycles": self.stride_cycles,
            "base_stride_cycles": self.base_stride_cycles,
            "overhead_ema_pct": round(self.overhead_ema_pct, 4),
            "overhead_budget_pct": self.overhead_budget_pct,
        }

    def export_state(self) -> dict[str, Any]:
        return {
            **self.stats(),
            "last_capture_cycle": self._last_capture_cycle,
            "window_index": self._window_index,
            "pending_evictions": self._pending_evictions,
            "seen_fingerprints": sorted(self._seen_fingerprints),
            "windows": [w.to_dict() for w in self._windows],
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        if not isinstance(state, dict):
            return
        self._cycle = int(state.get("cycle", 0))
        self._last_capture_cycle = int(state.get("last_capture_cycle", 0))
        self._window_index = int(state.get("window_index", 0))
        self._pending_evictions = int(state.get("pending_evictions", 0))
        self.windows_captured = int(state.get("windows_captured", 0))
        self.windows_forced = int(state.get("windows_forced", 0))
        self.eviction_windows = int(state.get("eviction_windows", 0))
        self.degradations = int(state.get("degradations", 0))
        self.reengagements = int(state.get("reengagements", 0))
        self.degraded = bool(state.get("degraded", False))
        self.stride_cycles = max(
            int(state.get("stride_cycles", self.base_stride_cycles)), 1
        )
        self.overhead_ema_pct = float(state.get("overhead_ema_pct", 0.0))
        self._ema_primed = self.windows_captured > 0
        self._seen_fingerprints = {
            str(fp) for fp in state.get("seen_fingerprints", ())
        }
        restored: list[ProfilerWindow] = []
        for raw in state.get("windows", ()):
            try:
                restored.append(
                    ProfilerWindow(
                        index=int(raw["index"]),
                        cycle=int(raw["cycle"]),
                        ts_unix_nano=int(raw["ts_unix_nano"]),
                        window_ms=float(raw["window_ms"]),
                        idle_gap_ms=float(raw["idle_gap_ms"]),
                        eviction_events=int(raw["eviction_events"]),
                        unexplained_share=float(raw["unexplained_share"]),
                        mfu_pct=float(raw["mfu_pct"]),
                        verdict=str(raw.get("verdict", "")),
                        raw_join_rate=float(raw["raw_join_rate"]),
                        substantive_join_rate=float(
                            raw["substantive_join_rate"]
                        ),
                        launches=int(raw["launches"]),
                        new_compilations=int(
                            raw.get("new_compilations", 0)
                        ),
                        capture_cost_ms=float(raw["capture_cost_ms"]),
                        stride_cycles=int(raw["stride_cycles"]),
                        degraded=bool(raw["degraded"]),
                        forced=bool(raw.get("forced", False)),
                        verdict_detail=str(raw.get("verdict_detail", "")),
                    )
                )
            except (KeyError, TypeError, ValueError):
                continue
        if restored:
            self._windows = restored[-self.history:]


# ---- seeded sweep gate ------------------------------------------------

#: Gate floors (bench digest + m5gate hold these).
MAX_OVERHEAD_PCT = 3.0
MIN_WINDOW_SUBSTANTIVE_JOIN = 0.9
MAX_PARITY_DRIFT_US = 0.5


@dataclass
class ProfilerReport:
    """One profiler sweep's evidence (m5gate/bench digest shape)."""

    seed: int
    overhead: dict[str, Any] = field(default_factory=dict)
    governor: dict[str, Any] = field(default_factory=dict)
    joins: dict[str, Any] = field(default_factory=dict)
    parity: dict[str, Any] = field(default_factory=dict)
    preemption: dict[str, Any] = field(default_factory=dict)
    failures: list[str] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict[str, Any]:
        return {
            "seed": self.seed,
            "passed": self.passed,
            "overhead": self.overhead,
            "governor": self.governor,
            "joins": self.joins,
            "parity": self.parity,
            "preemption": self.preemption,
            "failures": list(self.failures),
        }


def _sweep_profiler(
    seed: int, cycles: int, roofs: tuple[float, float], **kwargs: Any
) -> ContinuousProfiler:
    peak_bw, peak_flops = roofs
    step_bytes, step_flops, step_dur = seeded_cost_model(peak_bw=peak_bw)
    defaults: dict[str, Any] = dict(
        source="synthetic",
        seed=seed,
        cycle_budget_ms=1000.0,
        stride_cycles=2,
        grace_cycles=2,
        window_steps=8,
        history=max(cycles, 8),
        bytes_per_step=step_bytes,
        flops_per_step=step_flops,
        step_dur_us=step_dur,
        node="sweep-host",
        peak_bw=peak_bw,
        peak_flops=peak_flops,
    )
    defaults.update(kwargs)
    return ContinuousProfiler(**defaults)


def _overhead_lane(
    report: ProfilerReport, seed: int, cycles: int, roofs: tuple[float, float]
) -> None:
    prof = _sweep_profiler(seed, cycles, roofs)
    windows = [w for _ in range(cycles) if (w := prof.tick()) is not None]
    report.overhead = {
        "cycles": cycles,
        "windows": len(windows),
        "overhead_ema_pct": round(prof.overhead_ema_pct, 4),
        "budget_pct": prof.overhead_budget_pct,
        "mean_capture_cost_ms": round(
            sum(w.capture_cost_ms for w in windows) / max(len(windows), 1),
            3,
        ),
        "degradations": prof.degradations,
    }
    if not windows:
        report.failures.append("overhead: no windows captured")
        return
    if prof.overhead_ema_pct > MAX_OVERHEAD_PCT:
        report.failures.append(
            f"overhead: EMA {prof.overhead_ema_pct:.3f}% > "
            f"{MAX_OVERHEAD_PCT}% budget"
        )


def _governor_lane(report: ProfilerReport, seed: int, roofs: tuple[float, float]) -> None:
    # Forced-slow captures (cost_fn pins the measured cost far over
    # budget) must degrade the stride; restoring headroom must
    # re-engage; an eviction notice must force a capture mid-stride
    # even while degraded.
    slow = {"cost_ms": 400.0}
    prof = _sweep_profiler(
        seed + 1, 64, roofs, cost_fn=lambda _ms: slow["cost_ms"],
        stride_cycles=2, max_stride_cycles=16, grace_cycles=2,
    )
    degraded_at = -1
    for cycle in range(64):
        prof.tick()
        if prof.degraded and degraded_at < 0:
            degraded_at = cycle + 1
        if prof.degraded:
            break
    stride_after_degrade = prof.stride_cycles
    if not prof.degraded:
        report.failures.append("governor: forced-slow capture never degraded")
    if stride_after_degrade <= prof.base_stride_cycles:
        report.failures.append(
            "governor: degradation did not lengthen the stride"
        )

    # Eviction notice while degraded: next tick must capture.
    prof.notice_eviction()
    forced_window = prof.tick()
    if forced_window is None or forced_window.eviction_events < 1:
        report.failures.append(
            "governor: eviction notice did not force a capture while "
            "degraded"
        )

    # Sustained headroom: EMA decays below half budget -> re-engage.
    slow["cost_ms"] = 1.0
    reengaged_at = -1
    for cycle in range(400):
        prof.tick()
        if not prof.degraded:
            reengaged_at = cycle + 1
            break
    if reengaged_at < 0:
        report.failures.append(
            "governor: sustained headroom never re-engaged the stride"
        )
    report.governor = {
        "degraded_at_cycle": degraded_at,
        "stride_after_degrade": stride_after_degrade,
        "forced_capture_evictions": (
            forced_window.eviction_events if forced_window else 0
        ),
        "reengaged_after_cycles": reengaged_at,
        "degradations": prof.degradations,
        "reengagements": prof.reengagements,
    }


def _join_lane(
    report: ProfilerReport, seed: int, cycles: int, roofs: tuple[float, float]
) -> None:
    prof = _sweep_profiler(seed + 2, cycles, roofs, stride_cycles=1)
    windows = [w for _ in range(cycles) if (w := prof.tick()) is not None]
    worst = min((w.substantive_join_rate for w in windows), default=0.0)
    raw = [w.raw_join_rate for w in windows]
    report.joins = {
        "windows": len(windows),
        "min_substantive_join_rate": round(worst, 4),
        "floor": MIN_WINDOW_SUBSTANTIVE_JOIN,
        "mean_raw_join_rate": round(sum(raw) / max(len(raw), 1), 4),
    }
    if worst < MIN_WINDOW_SUBSTANTIVE_JOIN:
        report.failures.append(
            f"joins: window substantive join {worst:.4f} < "
            f"{MIN_WINDOW_SUBSTANTIVE_JOIN}"
        )
    # The raw rate must be REPORTED strictly below the tiered rate on
    # the seeded lane (helpers/warmups carry no exact identity): if the
    # two ever collapse together the single-sourcing broke.
    if windows and not all(
        w.raw_join_rate < w.substantive_join_rate for w in windows
    ):
        report.failures.append(
            "joins: raw exact-identity rate not distinct from the "
            "tiered substantive rate"
        )


def _parity_lane(
    report: ProfilerReport, seed: int, n_windows: int, roofs: tuple[float, float]
) -> None:
    # Per-window ledger buckets must sum to one big build_ledger over
    # the spliced capture.  Orphan helpers stay out of this lane: in a
    # spliced trace a later window's head-of-trace orphans sit after
    # earlier step frames and the frame tier legitimately claims them —
    # a real cross-window recovery, not an accounting error.
    prof = _sweep_profiler(
        seed + 3, n_windows, roofs, stride_cycles=1, synthetic_orphan_helpers=0
    )
    docs: list[dict[str, Any]] = []
    compile_lists: list[list[dict[str, Any]]] = []
    per_window: dict[str, float] = {}
    windows_total_us = 0.0
    for _ in range(n_windows):
        w = prof.tick()
        assert w is not None
        doc, compiles = prof.window_trace_doc(w.index)
        docs.append(doc)
        compile_lists.append(compiles)
        ledger = build_ledger(parse_trace_events(doc, include_ops=True), compiles)
        for bucket, us in ledger.buckets_us.items():
            per_window[bucket] = per_window.get(bucket, 0.0) + us
        windows_total_us += ledger.total_us
    spliced_doc, spliced_compiles = concat_window_docs(docs, compile_lists)
    full = build_ledger(
        parse_trace_events(spliced_doc, include_ops=True), spliced_compiles
    )
    drift = {
        bucket: abs(per_window.get(bucket, 0.0) - us)
        for bucket, us in full.buckets_us.items()
    }
    worst_bucket, worst_us = max(
        drift.items(), key=lambda kv: kv[1], default=("", 0.0)
    )
    report.parity = {
        "windows": n_windows,
        "window_bucket_sums_ms": {
            b: round(us / 1000.0, 3) for b, us in sorted(per_window.items())
        },
        "full_capture_buckets_ms": {
            b: round(us / 1000.0, 3)
            for b, us in sorted(full.buckets_us.items())
        },
        "worst_bucket_drift_us": round(worst_us, 3),
        "worst_bucket": worst_bucket,
        "total_drift_us": round(abs(windows_total_us - full.total_us), 3),
    }
    if worst_us > MAX_PARITY_DRIFT_US:
        report.failures.append(
            f"parity: bucket {worst_bucket} drifts {worst_us:.3f}us "
            f"between per-window and spliced ledgers"
        )
    if abs(windows_total_us - full.total_us) > MAX_PARITY_DRIFT_US:
        report.failures.append(
            "parity: window totals do not sum to the spliced capture"
        )


def _preemption_lane(report: ProfilerReport, seed: int, roofs: tuple[float, float]) -> None:
    # The injected preemption window must surface as a tpu_preemption
    # attribution from the window's own signal values — the live e2e
    # the acceptance criterion drives through the agent.
    from tpuslo_torch.attribution.bayesian import BayesianAttributor

    prof = _sweep_profiler(
        seed + 4, 8, roofs, stride_cycles=1,
        synthetic_preempt_window=3, synthetic_preempt_gap_ms=300.0,
    )
    windows = [w for _ in range(8) if (w := prof.tick()) is not None]
    hit = next((w for w in windows if w.eviction_events > 0), None)
    clean = [w for w in windows if w.eviction_events == 0]
    if hit is None:
        report.failures.append("preemption: injected window never captured")
        report.preemption = {"windows": len(windows)}
        return
    attributor = BayesianAttributor()
    posteriors = attributor.attribute(prof.window_signal_values(hit))
    top = posteriors[0]
    baseline_gap = max((w.idle_gap_ms for w in clean), default=0.0)
    report.preemption = {
        "window_index": hit.index,
        "idle_gap_ms": round(hit.idle_gap_ms, 3),
        "baseline_max_idle_gap_ms": round(baseline_gap, 3),
        "eviction_events": hit.eviction_events,
        "top_domain": top.domain,
        "posterior": round(top.posterior, 4),
        "verdict": hit.verdict,
    }
    if top.domain != "tpu_preemption":
        report.failures.append(
            f"preemption: window attributed to {top.domain}, not "
            "tpu_preemption"
        )
    if hit.idle_gap_ms <= baseline_gap + 100.0:
        report.failures.append(
            "preemption: injected gap did not dominate the idle-gap "
            "signal"
        )


def run_profiler_sweep(
    seed: int = 1337,
    cycles: int = 24,
    parity_windows: int = 5,
    *,
    peak_bw: float | None = None,
    peak_flops: float | None = None,
) -> ProfilerReport:
    """The profiler's seeded CI gate: overhead, governor, per-window
    joins, window/full-capture parity, and the preemption e2e.

    The seeded captures' step durations and roofline verdicts are drawn
    against ``peak_bw`` / ``peak_flops``: given, or the card's own
    (:func:`~tpuslo_torch.deviceplane.roofline.card_peaks`, which raises
    without a card)."""
    if peak_bw is None or peak_flops is None:
        peak_bw, peak_flops = card_peaks()
    roofs = (float(peak_bw), float(peak_flops))
    report = ProfilerReport(seed=seed)
    _overhead_lane(report, seed, cycles, roofs)
    _governor_lane(report, seed, roofs)
    _join_lane(report, seed, min(cycles, 12), roofs)
    _parity_lane(report, seed, parity_windows, roofs)
    _preemption_lane(report, seed, roofs)
    return report
