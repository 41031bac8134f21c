"""The port's continuous profiler (``tpuslo_torch.deviceplane.profiler``)
against the JAX module's: cadence, the overhead governor, per-window /
spliced-capture ledger parity, emission, the state round trip,
construction and the seeded sweep gate (the cases of
``tests/test_profiler.py``).

Both profilers run side by side on the seeded lane (each over its own
package's synthetic capture, which give equal spans) or under one
injected ``capture_fn`` and ``cost_fn``; their windows, stride changes
and payload values must be equal.  The roofline fields are held to the
JAX fold at the H100's roofs (the JAX profiler's default roofs are
another chip's).  The sweep gate runs at the JAX package's default roofs
(its seeded step durations are drawn against them), so that the two
sweeps see equal captures and must make equal decisions.  The ``"torch"``
lane is driven over the port's CPU engines.
"""

from __future__ import annotations

import dataclasses
import itertools

import pytest

torch = pytest.importorskip("torch")

from tpuslo.deviceplane import profiler as jp  # noqa: E402
from tpuslo.deviceplane import roofline as jr  # noqa: E402
from tpuslo.deviceplane.ledger import build_ledger as j_build_ledger  # noqa: E402
from tpuslo.otel.xla_spans import parse_trace_events as j_parse  # noqa: E402
from tpuslo.schema import SCHEMA_PROBE_EVENT, is_valid, validate  # noqa: E402
from tpuslo_torch.deviceplane import profiler as tp  # noqa: E402
from tpuslo_torch.deviceplane import roofline as tr  # noqa: E402
from tpuslo_torch.deviceplane.ledger import build_ledger  # noqa: E402
from tpuslo_torch.otel.xla_spans import load_trace_file, parse_trace_events  # noqa: E402
from tpuslo_torch.signals import constants as sig  # noqa: E402

# Every ProfilerWindow field but the two clocks (the wall-clock stamp
# and the measured capture cost), and the roofline triple, which the
# JAX profiler folds at its own default roofs.
WINDOW_KEYS = ("index", "cycle", "window_ms", "idle_gap_ms", "eviction_events",
               "unexplained_share", "raw_join_rate", "substantive_join_rate",
               "launches", "new_compilations", "stride_cycles", "degraded", "forced")
DEFAULTS = dict(
    seed=1337,
    cycle_budget_ms=1000.0,
    stride_cycles=2,
    grace_cycles=2,
    window_steps=6,
    history=64,
    node="test-host",
    pod="test-pod",
)


def pair(**kw):
    """(JAX profiler, port profiler) on the seeded lane; a ``cost_fn``
    factory under ``cost`` gives each its own (equal) cost schedule."""
    cost = kw.pop("cost", None)
    out = []
    for mod in (jp, tp):
        args = dict(DEFAULTS, source="synthetic", **kw)
        if cost is not None:
            args["cost_fn"] = cost()
        out.append(mod.ContinuousProfiler(**args))
    return out


def window_view(w):
    return None if w is None else tuple(getattr(w, k) for k in WINDOW_KEYS)


def tick_both(profs, n):
    """Tick both ``n`` times; windows and governor states must agree at
    every cycle.  Returns the port's windows."""
    out = []
    for _ in range(n):
        a, b = profs[0].tick(), profs[1].tick()
        assert window_view(b) == window_view(a)
        assert (profs[1].stride_cycles, profs[1].degraded) == (
            profs[0].stride_cycles, profs[0].degraded)
        if profs[1]._cost_fn is not None:  # else each measures its own cost
            assert profs[1].overhead_ema_pct == pytest.approx(
                profs[0].overhead_ema_pct, rel=1e-12)
        out.append(b)
    return out


def fixed(ms):
    return lambda: (lambda _ms: ms)


# ---- stride / capture cadence ------------------------------------------


class TestCadence:
    def test_tick_captures_on_stride(self):
        profs = pair(stride_cycles=3)
        windows = [w for w in tick_both(profs, 9) if w is not None]
        assert len(windows) == 3
        assert [w.cycle for w in windows] == [3, 6, 9]
        assert [w.index for w in windows] == [0, 1, 2]

    def test_windows_are_deterministic_per_index(self):
        a = tp.ContinuousProfiler(**dict(DEFAULTS, stride_cycles=1))
        b = tp.ContinuousProfiler(**dict(DEFAULTS, stride_cycles=1))
        for x, y in zip([a.tick() for _ in range(4)], [b.tick() for _ in range(4)]):
            assert window_view(x)[2:] == window_view(y)[2:]

    def test_history_ring_trims(self):
        profs = pair(stride_cycles=1, history=3)
        tick_both(profs, 8)
        kept = profs[1].windows()
        assert [w.index for w in kept] == [5, 6, 7]
        assert [window_view(w) for w in kept] == [window_view(w) for w in profs[0].windows()]


# ---- the overhead governor ---------------------------------------------


class TestGovernor:
    def test_forced_slow_capture_degrades_stride(self):
        profs = pair(stride_cycles=2, grace_cycles=2, max_stride_cycles=16,
                     cost=fixed(400.0))
        for _ in range(40):
            tick_both(profs, 1)
            if profs[1].degraded:
                break
        prof = profs[1]
        assert prof.degraded
        assert prof.stride_cycles > prof.base_stride_cycles
        assert prof.degradations == profs[0].degradations >= 1

    def test_stride_caps_at_max(self):
        profs = pair(stride_cycles=2, grace_cycles=1, max_stride_cycles=8,
                     cost=fixed(900.0))
        tick_both(profs, 200)
        assert profs[1].stride_cycles == 8

    def test_sustained_headroom_reengages(self):
        costs = [{"ms": 400.0}, {"ms": 400.0}]
        it = iter(costs)
        profs = pair(stride_cycles=2, grace_cycles=2, max_stride_cycles=16,
                     cost=lambda: (lambda c: (lambda _ms: c["ms"]))(next(it)))
        for _ in range(40):
            tick_both(profs, 1)
            if profs[1].degraded:
                break
        assert profs[1].degraded
        for c in costs:
            c["ms"] = 1.0
        for _ in range(600):
            tick_both(profs, 1)
            if not profs[1].degraded:
                break
        prof = profs[1]
        assert not prof.degraded
        assert prof.stride_cycles == prof.base_stride_cycles
        assert prof.reengagements == profs[0].reengagements >= 1

    def test_eviction_notice_forces_capture_while_degraded(self):
        profs = pair(stride_cycles=2, grace_cycles=2, max_stride_cycles=16,
                     cost=fixed(400.0))
        for _ in range(40):
            tick_both(profs, 1)
            if profs[1].degraded:
                break
        assert profs[1].degraded
        for prof in profs:
            prof.notice_eviction()
        (window,) = tick_both(profs, 1)
        assert window is not None
        assert window.forced is True
        assert window.eviction_events >= 1
        assert profs[1].windows_forced == 1
        assert profs[1].eviction_windows >= 1

    def test_eviction_notice_rides_next_stride_capture_when_due(self):
        profs = pair(stride_cycles=1)
        for prof in profs:
            prof.notice_eviction(2)
        (window,) = tick_both(profs, 1)
        assert window is not None
        assert window.forced is False
        assert window.eviction_events == 2

    def test_overhead_ema_tracks_amortised_cost(self):
        profs = pair(stride_cycles=4, cost=fixed(40.0))
        tick_both(profs, 4)
        assert profs[1].overhead_ema_pct == pytest.approx(1.0)
        assert not profs[1].degraded

    def test_one_injected_capture_and_cost_schedule(self):
        """The same capture_fn (one span source for both) and a varying
        cost schedule: equal windows, strides, degradations and EMAs."""
        from tpuslo_torch.deviceplane.synthetic import synthesize_xprof_trace

        def capture_fn(index):
            doc, compiles, _ = synthesize_xprof_trace(
                seed=40 + index, steps=5, preemption_gap_ms=120.0 if index == 3 else 0.0)
            return parse_trace_events(doc, include_ops=True), compiles

        def cost():
            calls = itertools.chain([5.0, 300.0, 350.0, 420.0, 90.0], itertools.repeat(1.0))
            return lambda _ms: next(calls)

        profs = pair(stride_cycles=1, grace_cycles=2, max_stride_cycles=8,
                     capture_fn=capture_fn, cost=cost)
        windows = [w for w in tick_both(profs, 300) if w is not None]
        assert len(windows) > 30
        assert profs[1].degradations == profs[0].degradations >= 1
        assert profs[1].reengagements == profs[0].reengagements >= 1
        assert profs[1].stats() == profs[0].stats()


# ---- per-window / full-capture ledger parity ---------------------------


class TestLedgerParity:
    def test_window_buckets_sum_to_spliced_capture(self):
        profs = pair(stride_cycles=1, synthetic_orphan_helpers=0)
        docs, compile_lists = [], []
        per_window: dict[str, float] = {}
        total_us = 0.0
        for w in tick_both(profs, 5):
            doc, compiles = profs[1].window_trace_doc(w.index)
            docs.append(doc)
            compile_lists.append(compiles)
            ledger = build_ledger(parse_trace_events(doc, include_ops=True), compiles)
            for bucket, us in ledger.buckets_us.items():
                per_window[bucket] = per_window.get(bucket, 0.0) + us
            total_us += ledger.total_us
        spliced_doc, spliced_compiles = tp.concat_window_docs(docs, compile_lists)
        full = build_ledger(parse_trace_events(spliced_doc, include_ops=True),
                            spliced_compiles)
        j_docs = [profs[0].window_trace_doc(i) for i in range(5)]
        j_doc, j_compiles = jp.concat_window_docs([d for d, _ in j_docs],
                                                  [c for _, c in j_docs])
        j_full = j_build_ledger(j_parse(j_doc, include_ops=True), j_compiles)
        for bucket, us in j_full.buckets_us.items():
            assert full.buckets_us[bucket] == pytest.approx(us, rel=1e-9, abs=1e-9)
        assert total_us == pytest.approx(full.total_us, abs=0.5)
        for bucket, us in full.buckets_us.items():
            assert per_window.get(bucket, 0.0) == pytest.approx(us, abs=0.5), bucket

    def test_concat_preserves_event_count_and_order(self):
        profs = pair(stride_cycles=1, synthetic_orphan_helpers=0)
        docs = [profs[1].window_trace_doc(w.index) for w in tick_both(profs, 3)]
        docs = [d for d, _ in docs]
        spliced, _ = tp.concat_window_docs(docs)
        xs = [e for e in spliced["traceEvents"] if e.get("ph") == "X"]
        assert len(xs) == sum(
            sum(1 for e in d["traceEvents"] if e.get("ph") == "X") for d in docs)
        firsts, lasts = [], []
        cursor = 0
        for d in docs:
            n = sum(1 for e in d["traceEvents"] if e.get("ph") == "X")
            chunk = xs[cursor:cursor + n]
            firsts.append(min(float(e["ts"]) for e in chunk))
            lasts.append(max(float(e["ts"]) + float(e.get("dur", 0)) for e in chunk))
            cursor += n
        for prev_end, next_start in zip(lasts, firsts[1:]):
            assert next_start == pytest.approx(prev_end, abs=1e-6)


# ---- emission: contract validity and single-sourcing -------------------


def payload_view(payloads):
    return [{k: v for k, v in p.items() if k != "ts_unix_nano"} for p in payloads]


class TestEmission:
    def test_probe_payloads_are_contract_valid(self):
        profs = pair(stride_cycles=1, slice_id="v5e-8-slice0", host_index=1)
        (window,) = tick_both(profs, 1)
        payloads = profs[1].probe_payloads(window)
        assert payload_view(payloads) == payload_view(
            profs[0].probe_payloads(profs[0].windows()[-1]))
        assert len(payloads) == 4
        for payload in payloads:
            assert is_valid(payload, SCHEMA_PROBE_EVENT)
            validate(payload, SCHEMA_PROBE_EVENT)
        assert {p["signal"] for p in payloads} == {
            sig.SIGNAL_DEVICE_IDLE_GAP_MS,
            sig.SIGNAL_DEVICE_EVICTION_EVENTS,
            sig.SIGNAL_DEVICE_UNEXPLAINED_SHARE,
            sig.SIGNAL_DEVICE_MFU_PCT,
        }
        tpu = {p["signal"]: p for p in payloads}[sig.SIGNAL_DEVICE_IDLE_GAP_MS]["tpu"]
        assert tpu["chip"] == "accel0"
        assert tpu["slice_id"] == "v5e-8-slice0"
        assert tpu["host_index"] == 1

    def test_payloads_and_attribution_map_share_values(self):
        profs = pair(stride_cycles=1)
        (window,) = tick_both(profs, 1)
        by_sig = {p["signal"]: p["value"] for p in profs[1].probe_payloads(window)}
        values = profs[1].window_signal_values(window)
        assert values == profs[0].window_signal_values(profs[0].windows()[-1])
        for name, value in values.items():
            assert by_sig[name] == pytest.approx(value, abs=1e-4)

    def test_both_join_rates_ride_every_window(self):
        profs = pair(stride_cycles=1)
        for window in tick_both(profs, 4):
            assert 0.0 <= window.raw_join_rate <= 1.0
            assert window.raw_join_rate < window.substantive_join_rate
            assert window.substantive_join_rate >= jp.MIN_WINDOW_SUBSTANTIVE_JOIN

    def test_preemption_window_carries_gap_and_eviction(self):
        profs = pair(stride_cycles=1, synthetic_preempt_window=2,
                     synthetic_preempt_gap_ms=250.0)
        windows = tick_both(profs, 4)
        hit = windows[2]
        assert hit.eviction_events == 1
        clean_max = max(w.idle_gap_ms for w in windows if w.eviction_events == 0)
        assert hit.idle_gap_ms > clean_max + 100.0

    def test_roofline_verdict_attaches_with_cost_model(self):
        bw, flops = tr.peaks_for_chip("NVIDIA H100 80GB HBM3")
        step_bytes, step_flops, step_dur = tp.seeded_cost_model(peak_bw=bw)
        prof = tp.ContinuousProfiler(**dict(
            DEFAULTS, stride_cycles=1, bytes_per_step=step_bytes,
            flops_per_step=step_flops, step_dur_us=step_dur, peak_bw=bw,
            peak_flops=flops))
        window = prof.tick()
        assert window.verdict == "memory_bound"
        assert window.mfu_pct > 0.0
        block = prof.window_roofline(window.index)
        assert block["verdict"] == "memory_bound"
        assert block["achieved_gb_per_sec"] > 0.0
        # The JAX fold over the JAX window's ledger at the H100's roofs.
        jprof = jp.ContinuousProfiler(**dict(
            DEFAULTS, stride_cycles=1, bytes_per_step=step_bytes,
            flops_per_step=step_flops, step_dur_us=step_dur))
        doc, compiles = jprof.window_trace_doc(0)
        want = jr.verdict_from_ledger(
            j_build_ledger(j_parse(doc, include_ops=True), compiles),
            step_bytes, step_flops, program_id=jprof.program_id,
            peak_bw=bw, peak_flops=flops)
        assert {k: v for k, v in block.items() if k != "detail"} == {
            k: v for k, v in want.items() if k != "detail"}
        assert window.mfu_pct == want["mfu_pct"]

    def test_no_cost_model_means_no_invented_mfu(self):
        profs = pair(stride_cycles=1)
        (window,) = tick_both(profs, 1)
        assert window.mfu_pct == -1.0 == profs[0].windows()[-1].mfu_pct
        assert window.verdict == ""
        assert profs[1].window_roofline(window.index) == {}
        by_sig = {p["signal"]: p["value"] for p in profs[1].probe_payloads(window)}
        assert by_sig[sig.SIGNAL_DEVICE_MFU_PCT] == 0.0


# ---- state round-trip ---------------------------------------------------


class TestStateRoundTrip:
    def test_export_restore_round_trip(self):
        profs = pair(stride_cycles=2, grace_cycles=2, max_stride_cycles=16,
                     cost=fixed(400.0))
        for _ in range(40):
            tick_both(profs, 1)
            if profs[1].degraded:
                break
        for p in profs:
            p.notice_eviction()
        tick_both(profs, 1)
        state = profs[1].export_state()
        j_state = profs[0].export_state()
        strip = ("windows",)
        assert {k: v for k, v in state.items() if k not in strip} == {
            k: v for k, v in j_state.items() if k not in strip}

        fresh = tp.ContinuousProfiler(**dict(
            DEFAULTS, stride_cycles=2, grace_cycles=2, max_stride_cycles=16))
        fresh.restore_state(state)
        assert fresh.stats() == profs[1].stats()
        assert fresh.export_state()["window_index"] == state["window_index"]
        assert [w.to_dict() for w in fresh.windows()] == state["windows"]
        assert fresh.stride_cycles == profs[1].stride_cycles
        assert fresh.degraded == profs[1].degraded
        # A JAX profiler's state restores into the port's.
        cross = tp.ContinuousProfiler(**dict(
            DEFAULTS, stride_cycles=2, grace_cycles=2, max_stride_cycles=16))
        cross.restore_state(j_state)
        assert cross.stats() == fresh.stats()

    def test_restore_ignores_garbage(self):
        prof = tp.ContinuousProfiler(**DEFAULTS)
        prof.restore_state(None)
        prof.restore_state({"windows": [{"index": "bogus"}]})
        assert prof.windows() == []
        assert prof.stats()["cycle"] == 0


# ---- config / construction ---------------------------------------------


class TestConstruction:
    def test_unknown_source_rejected(self):
        with pytest.raises(ValueError):
            tp.ContinuousProfiler(source="perfetto")
        with pytest.raises(ValueError):
            tp.ContinuousProfiler(source="xprof")

    def test_torch_source_needs_log_dir_and_work(self):
        with pytest.raises(ValueError):
            tp.ContinuousProfiler(source="torch")
        with pytest.raises(ValueError):
            tp.ContinuousProfiler(source="torch", log_dir="/tmp/x")

    def test_a_cost_model_without_roofs_reads_the_card(self, monkeypatch):
        """A cost model needs the card's roofs: without a card, or on a
        card the table does not hold, construction raises."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.ContinuousProfiler(bytes_per_step=1e9, flops_per_step=1e9)
        tp.ContinuousProfiler()  # no cost model, no roofs needed
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None: "NVIDIA H100 80GB HBM3")
        prof = tp.ContinuousProfiler(bytes_per_step=1e9, flops_per_step=1e9)
        assert (prof.peak_bw, prof.peak_flops) == (3.35e12, 989e12)

    def test_seeded_cost_model_is_memory_bound_regime(self):
        bw, flops = tr.peaks_for_chip("NVIDIA H100 80GB HBM3")
        step_bytes, step_flops, (lo, hi) = tp.seeded_cost_model(peak_bw=bw)
        assert step_bytes > 0 and step_flops > 0
        assert 0 < lo < hi
        j_bytes, j_flops, _ = jp.seeded_cost_model()
        assert (step_bytes, step_flops) == (j_bytes, j_flops)
        # The draw bounds put a step at 30-39% of the H100's HBM roof.
        for dur_us in (lo, hi):
            v = tr.roofline_verdict(dur_us / 1e3, step_bytes, step_flops,
                                    peak_bw=bw, peak_flops=flops)
            assert v["verdict"] == "memory_bound"
            assert 30.0 <= v["hbm_bw_pct"] <= 39.0


# ---- the "torch" lane over the port's CPU engines ----------------------


class TestTorchLane:
    def test_windows_over_serve_engine_dispatches(self, tmp_path):
        from tpuslo_torch.models import llama as tl
        from tpuslo_torch.models import serve as ts

        torch.set_num_threads(1)
        engine = ts.ServeEngine(cfg=tl.llama_tiny(max_seq_len=128), device="cpu",
                                decode_chunk_size=4)
        work = {"n": 0}

        def work_fn():
            work["n"] += 1
            list(engine.generate(f"request {work['n']}", max_new_tokens=6,
                                 stop_at_eos=False))

        prof = tp.ContinuousProfiler(source="torch", log_dir=str(tmp_path),
                                     work_fn=work_fn, stride_cycles=2,
                                     cycle_budget_ms=50.0)
        windows = []
        for _ in range(6):
            w = prof.tick()
            if w is None:
                work_fn()  # an uncaptured step
            else:
                windows.append(w)
        assert work["n"] == 6
        assert [w.cycle for w in windows] == [2, 4, 6]
        for w in windows:
            # a prefill and two 4-token decode chunks per request
            assert w.launches == 3
            assert w.window_ms > 0.0
            assert w.raw_join_rate == 0.0  # no device ops on the CPU
        assert prof.stats()["windows_captured"] == 3
        assert prof.overhead_ema_pct > 0.0
        for payload in prof.probe_payloads(windows[-1]):
            validate(payload, SCHEMA_PROBE_EVENT)

    def test_frontdoor_steps_under_the_profiler(self, tmp_path):
        from tpuslo_torch.models import frontdoor as tfd
        from tpuslo_torch.models import llama as tl
        from tpuslo_torch.models import serve as ts

        torch.set_num_threads(1)
        cfg = dataclasses.replace(tl.llama_tiny(max_seq_len=128), dtype=torch.float32)
        target = ts.ServeEngine(cfg=cfg, device="cpu", rng_seed=0)
        draft = ts.ServeEngine(cfg=cfg, device="cpu", rng_seed=0)
        door = tfd.FrontDoorEngine(target, draft, k=2, max_slots=2, rounds_per_step=2)
        for i in range(3):
            door.submit(f"window {i}", max_new_tokens=8, stop_at_eos=False)
        prof = tp.ContinuousProfiler(source="torch", log_dir=str(tmp_path),
                                     work_fn=door.step, stride_cycles=1)
        windows = [prof.tick() for _ in range(3)]
        names = set()
        for path in sorted(tmp_path.rglob("*.trace.json*")):
            names |= {s.module_name for s in load_trace_file(str(path))}
        assert {"prefill", "inject_rows", "spec_multi_round"} <= names
        assert all(w is not None and w.launches >= 1 for w in windows)


#: The roofs the JAX sweep folds at (``tpuslo/deviceplane/roofline.py``
#: defaults); only here, to hold the port's sweep to the JAX one.
JAX_SWEEP_ROOFS = dict(peak_bw=jr.V5E_PEAK_HBM_BW, peak_flops=jr.V5E_PEAK_BF16_FLOPS)
# Report fields that are measured host times, and what follows from them
# (the governor backs off, and captures fewer windows, on a slow host).
SWEEP_TIMING = {"overhead": ("overhead_ema_pct", "mean_capture_cost_ms", "degradations",
                             "windows"),
                "joins": ("windows",)}


def _without_timing(report: dict) -> dict:
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in report.items()}
    for lane, keys in SWEEP_TIMING.items():
        for key in keys:
            out[lane].pop(key, None)
    return out


class TestProfilerSweep:
    @pytest.fixture(scope="class")
    def sweeps(self):
        got = tp.run_profiler_sweep(seed=1337, cycles=12, parity_windows=3,
                                    **JAX_SWEEP_ROOFS)
        want = jp.run_profiler_sweep(seed=1337, cycles=12, parity_windows=3)
        return got, want

    def test_sweep_passes_at_default_seed(self, sweeps):
        report, _ = sweeps
        assert report.passed, report.failures
        assert report.overhead["overhead_ema_pct"] <= tp.MAX_OVERHEAD_PCT
        assert report.joins["min_substantive_join_rate"] >= tp.MIN_WINDOW_SUBSTANTIVE_JOIN
        assert report.governor["degradations"] >= 1
        assert report.governor["reengagements"] >= 1
        assert report.governor["forced_capture_evictions"] >= 1
        assert report.parity["worst_bucket_drift_us"] <= tp.MAX_PARITY_DRIFT_US
        assert report.preemption["top_domain"] == "tpu_preemption"

    def test_sweep_makes_the_jax_decisions(self, sweeps):
        got, want = sweeps
        assert _without_timing(got.to_dict()) == _without_timing(want.to_dict())

    @pytest.mark.parametrize("seed", [7, 2024])
    def test_other_seeds_make_the_jax_decisions(self, seed):
        got = tp.run_profiler_sweep(seed=seed, cycles=6, parity_windows=2, **JAX_SWEEP_ROOFS)
        want = jp.run_profiler_sweep(seed=seed, cycles=6, parity_windows=2)
        assert _without_timing(got.to_dict()) == _without_timing(want.to_dict())

    def test_gate_floors_equal_jax(self):
        for name in ("MAX_OVERHEAD_PCT", "MIN_WINDOW_SUBSTANTIVE_JOIN", "MAX_PARITY_DRIFT_US"):
            assert getattr(tp, name) == getattr(jp, name)

    def test_sweep_without_roofs_reads_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.run_profiler_sweep(seed=1, cycles=2, parity_windows=1)

    def test_report_dict_shape(self):
        report = tp.ProfilerReport(seed=7)
        assert report.passed
        report.failures.append("x")
        data = report.to_dict()
        assert data["passed"] is False
        assert set(data) == set(jp.ProfilerReport(seed=7).to_dict()) == {
            "seed", "passed", "overhead", "governor", "joins", "parity",
            "preemption", "failures",
        }
