"""The port's device plane (``tpuslo_torch.deviceplane``) against the JAX
package's: the seeded capture, the ledger, its join tiers, the
breakdown, roofline verdicts, the dispatch ledger and front-door tracing.

The load-bearing parity: for each seed and argument set, the port's
parse of the port's synthetic capture (Kineto layout) gives the spans
the JAX parse of the JAX synthetic capture gives, and the port's ledger
gives JAX's buckets (to 1e-9 relative), tiers and both join rates.  The
JAX test's own assertions are then made on the port's results.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpuslo.deviceplane import dispatch as jdispatch  # noqa: E402
from tpuslo.deviceplane import ledger as jl  # noqa: E402
from tpuslo.deviceplane import roofline as jr  # noqa: E402
from tpuslo.deviceplane import synthetic as jsyn  # noqa: E402
from tpuslo.otel import xla_spans as jx  # noqa: E402
from tpuslo_torch.deviceplane import dispatch as tdispatch  # noqa: E402
from tpuslo_torch.deviceplane import ledger as tl  # noqa: E402
from tpuslo_torch.deviceplane import roofline as tr  # noqa: E402
from tpuslo_torch.deviceplane import synthetic as tsyn  # noqa: E402
from tpuslo_torch.otel import xla_spans as tx  # noqa: E402

SPAN_KEY = ("name", "module_name", "program_id", "launch_id", "start_us",
            "duration_us", "device_pid", "lane")
ARG_SETS = [
    {},
    {"devices": 2, "preemption_gap_ms": 80.0},
    {"lane_split_every": 3, "helpers_per_step": 2, "orphan_helpers": 4},
    {"lane_split_every": 0, "warmup_launches": 0, "steps": 7},
    {"step_dur_us": (2506.0, 3203.0), "ops_per_step": 9},
]


def both_captures(seed=1337, include_ops=True, **kw):
    """((JAX spans, compiles, truth), (port spans, compiles, truth))."""
    jdoc, jc, jt = jsyn.synthesize_xprof_trace(seed=seed, **kw)
    tdoc, tc, tt = tsyn.synthesize_xprof_trace(seed=seed, **kw)
    return ((jx.parse_trace_events(jdoc, include_ops=include_ops), jc, jt),
            (tx.parse_trace_events(tdoc, include_ops=include_ops), tc, tt))


def assert_same_ledger(got, want):
    assert set(got.buckets_us) == set(want.buckets_us)
    for bucket, us in want.buckets_us.items():
        assert got.buckets_us[bucket] == pytest.approx(us, rel=1e-9, abs=1e-9), bucket
    assert got.tier_counts == want.tier_counts
    assert got.reasons == want.reasons
    assert got.raw_join_rate == pytest.approx(want.raw_join_rate, rel=1e-9)
    assert got.substantive_join_rate == pytest.approx(want.substantive_join_rate, rel=1e-9)
    assert got.exact_substantive_join_rate == pytest.approx(
        want.exact_substantive_join_rate, rel=1e-9)
    assert [r.to_dict() for r in got.launches] == [r.to_dict() for r in want.launches]
    assert got.total_us == pytest.approx(want.total_us, rel=1e-9)
    assert (got.launches_with_ops, got.orphan_ops_count, got.orphan_ops_unclaimed) == (
        want.launches_with_ops, want.orphan_ops_count, want.orphan_ops_unclaimed)


def make_ledger(seed=1337, compile_events=True, **kw):
    """The port's ledger and truth, held to JAX's on the way."""
    (js, jc, jt), (ts, tc, tt) = both_captures(seed=seed, **kw)
    want = jl.build_ledger(js, jc if compile_events else ())
    got = tl.build_ledger(ts, tc if compile_events else ())
    assert_same_ledger(got, want)
    assert tt == jt
    return got, tt


# ---- the parity fixture -------------------------------------------------


class TestSyntheticParity:
    @pytest.mark.parametrize("seed", [1, 7, 1337])
    @pytest.mark.parametrize("kw", ARG_SETS, ids=lambda kw: ",".join(kw) or "defaults")
    def test_parse_and_ledger_equal_jax(self, seed, kw):
        for include_ops in (False, True):
            (js, jc, jt), (ts, tc, tt) = both_captures(seed, include_ops, **kw)
            assert [tuple(getattr(s, k) for k in SPAN_KEY) for s in ts] == [
                tuple(getattr(s, k) for k in SPAN_KEY) for s in js
            ]
            assert tc == jc and tt == jt
            assert_same_ledger(tl.build_ledger(ts, tc), jl.build_ledger(js, jc))
            assert_same_ledger(tl.build_ledger(ts), jl.build_ledger(js))

    def test_document_is_kineto_layout(self):
        doc, _, _ = tsyn.synthesize_xprof_trace(seed=3)
        cats = {e["cat"] for e in doc["traceEvents"]}
        assert cats == {tx.CAT_GPU_ANNOTATION, "kernel"}
        kernels = [e for e in doc["traceEvents"] if e["cat"] == "kernel"]
        corr = [e["args"]["correlation"] for e in kernels]
        assert corr == list(range(1, len(kernels) + 1))


# ---- ledger bucket accounting ------------------------------------------


class TestLedgerBuckets:
    @pytest.mark.parametrize("seed", [1, 7, 1337])
    def test_buckets_sum_to_total_device_time(self, seed):
        ledger, truth = make_ledger(seed=seed)
        assert ledger.total_us > 0
        assert ledger.bucket_sum_us == pytest.approx(ledger.total_us, rel=1e-9)
        assert ledger.total_us == pytest.approx(truth["window_us"], rel=1e-6)

    def test_idle_gap_matches_truth(self):
        ledger, truth = make_ledger(seed=5)
        assert ledger.buckets_us[tl.BUCKET_IDLE_GAP] == pytest.approx(
            truth["idle_us"], rel=1e-6
        )

    def test_preemption_gap_lands_in_idle_bucket(self):
        steady, _ = make_ledger(seed=3)
        preempted, _ = make_ledger(seed=3, preemption_gap_ms=80.0)
        delta = (preempted.buckets_us[tl.BUCKET_IDLE_GAP]
                 - steady.buckets_us[tl.BUCKET_IDLE_GAP])
        assert delta == pytest.approx(80_000.0, rel=1e-6)
        assert preempted.idle_gap_ms() > 80.0

    def test_multi_device_totals_are_per_device_sums(self):
        one, _ = make_ledger(seed=11, devices=1)
        two, _ = make_ledger(seed=11, devices=2)
        assert len(two.devices) == 2
        assert two.bucket_sum_us == pytest.approx(two.total_us, rel=1e-9)
        assert len(two.launches) == 2 * len(one.launches)

    def test_overlapping_launches_never_double_count(self):
        def spans(mod):
            return [
                mod.XLASpan(name="jit_a(1)", module_name="jit_a", program_id="1",
                            launch_id=1, start_us=0.0, duration_us=100.0,
                            device_pid=1, lane=mod.MODULES_LANE),
                mod.XLASpan(name="jit_b(2)", module_name="jit_b", program_id="2",
                            launch_id=1, start_us=60.0, duration_us=100.0,
                            device_pid=1, lane=mod.MODULES_LANE),
                mod.XLASpan(name="op", start_us=10.0, duration_us=5.0,
                            device_pid=1, lane=mod.OPS_LANE),
                mod.XLASpan(name="op2", start_us=70.0, duration_us=5.0,
                            device_pid=1, lane=mod.OPS_LANE),
            ]

        ledger = tl.build_ledger(spans(tx))
        assert_same_ledger(ledger, jl.build_ledger(spans(jx)))
        assert ledger.total_us == pytest.approx(160.0)
        assert ledger.bucket_sum_us == pytest.approx(160.0)
        owned = {r.module_name: r.owned_us for r in ledger.launches}
        assert owned["jit_a"] == pytest.approx(100.0)
        assert owned["jit_b"] == pytest.approx(60.0)

    def test_empty_spans_gives_empty_ledger(self):
        ledger = tl.build_ledger([])
        assert ledger.total_us == 0.0
        assert ledger.substantive_join_rate == 0.0
        assert ledger.unexplained_share == 0.0

    def test_idle_gap_probe_values(self):
        ledger, truth = make_ledger(seed=2)
        values = tl.idle_gap_probe_values(ledger)
        assert values["device_idle_gap_ms"] == pytest.approx(
            truth["idle_us"] / 1000.0, rel=1e-3
        )

    def test_to_dict_equals_jax(self):
        (js, jc, _), (ts, tc, _) = both_captures(seed=21)
        assert tl.build_ledger(ts, tc).to_dict() == jl.build_ledger(js, jc).to_dict()


# ---- join tiers ---------------------------------------------------------


class TestJoinTiers:
    def test_tier_counts_match_truth(self):
        ledger, truth = make_ledger(seed=1337)
        tiers = ledger.tier_counts
        assert tiers[tl.TIER_IDENTITY] == truth["steps"] - truth["lane_split_steps"]
        assert tiers[tl.TIER_LANE_WINDOW] == truth["lane_split_steps"]
        assert tiers[tl.TIER_COMPILE_EVENT] >= truth["warmups"]

    def test_substantive_rate_hits_gate_and_raw_stays_honest(self):
        ledger, _ = make_ledger(seed=1337)
        assert ledger.substantive_join_rate >= 0.9
        assert ledger.raw_join_rate < ledger.substantive_join_rate
        assert ledger.unexplained_share <= 0.1

    def test_orphan_helpers_stay_unexplained(self):
        ledger, truth = make_ledger(seed=1337)
        unexplained = [r for r in ledger.launches if r.bucket == tl.BUCKET_UNEXPLAINED]
        assert len(unexplained) == truth["orphan_helpers"]
        assert all(r.tier == tl.TIER_NONE for r in unexplained)

    def test_frame_tier_catches_helpers_without_compile_events(self):
        ledger, truth = make_ledger(seed=1337, compile_events=False)
        assert ledger.tier_counts.get(tl.TIER_FRAME, 0) == truth["helpers"]
        warmups = [r for r in ledger.launches if r.launch_id < 0 and r.ops_count > 0]
        assert warmups and all(r.bucket == tl.BUCKET_UNEXPLAINED for r in warmups)
        assert ledger.bucket_sum_us == pytest.approx(ledger.total_us, rel=1e-9)

    def test_lane_split_steps_recover_their_ops(self):
        ledger, truth = make_ledger(seed=1337)
        lane = [r for r in ledger.launches if r.tier == tl.TIER_LANE_WINDOW]
        assert len(lane) == truth["lane_split_steps"]
        assert all(r.ops_source == "lane" and r.ops_count > 0 for r in lane)
        assert all(r.bucket == tl.BUCKET_JOINED for r in lane)
        assert ledger.orphan_ops_unclaimed == 0

    def test_compile_tier_buckets(self):
        ledger, _ = make_ledger(seed=1337)
        for rec in ledger.launches:
            if rec.tier == tl.TIER_COMPILE_EVENT:
                want = tl.BUCKET_COMPILE if rec.ops_count else tl.BUCKET_HELPER
                assert rec.bucket == want

    def test_synthetic_trace_deterministic(self):
        a = tsyn.synthesize_xprof_trace(seed=9)
        assert a == tsyn.synthesize_xprof_trace(seed=9)
        assert tsyn.synthesize_xprof_trace(seed=10) != a


# ---- launch_match_breakdown (ledger-fed) --------------------------------


class TestBreakdown:
    def _both(self, seed=1337, include_ops=True, **kw):
        (js, jc, jt), (ts, tc, tt) = both_captures(seed, include_ops, **kw)
        got = tx.launch_match_breakdown(ts, tc)
        assert got == jx.launch_match_breakdown(js, jc)
        return got, ts, tc, tt

    def test_reason_classes_cover_the_pathologies(self):
        breakdown, _, _, truth = self._both()
        reasons = breakdown["reasons"]
        assert reasons.get("anonymous_launch", 0) >= truth["warmups"]
        assert reasons.get("no_contained_ops", 0) == (
            truth["helpers"] + truth["orphan_helpers"]
        )
        assert reasons.get("ops_on_split_lane", 0) == 0
        assert breakdown["ledger"]["tier_counts"]["lane_window"] == truth["lane_split_steps"]
        assert sum(reasons.values()) == breakdown["unmatched_count"] + truth["warmups"]

    def test_no_ops_lane_when_capture_has_no_ops(self):
        breakdown, _, _, _ = self._both(
            seed=4, include_ops=False, lane_split_every=0, orphan_helpers=0,
            warmup_launches=0, helpers_per_step=0,
        )
        assert breakdown["launches_with_ops"] == 0
        assert breakdown["reasons"] == {"no_ops_lane": breakdown["launches"]}
        assert breakdown["substantive_join_rate"] == 0.0

    def test_single_source_for_both_rates(self):
        breakdown, spans, compiles, _ = self._both()
        ledger = tl.build_ledger(spans, compiles)
        assert breakdown["raw_join_rate"] == pytest.approx(ledger.raw_join_rate, abs=5e-5)
        assert breakdown["ledger_substantive_join_rate"] == pytest.approx(
            ledger.substantive_join_rate, abs=5e-5)
        assert breakdown["substantive_join_rate"] == pytest.approx(
            ledger.exact_substantive_join_rate, abs=5e-5)
        assert breakdown["ledger"]["bucket_sum_ms"] == pytest.approx(
            breakdown["ledger"]["total_device_time_ms"])

    def test_unmatched_examples_stay_bounded_and_typed(self):
        breakdown, _, _, _ = self._both()
        assert len(breakdown["unmatched"]) <= 24
        for entry in breakdown["unmatched"]:
            assert {"module", "reason", "tier", "bucket"} <= set(entry)


class TestCardDispatches:
    """On a card's trace the parser cuts a dispatch range into one module
    span per run of its kernels; every count of launches still reads one
    launch per dispatch, as the JAX ledger's one record per program
    execution does."""

    @staticmethod
    def card_doc():
        """One dispatch range on device 0 whose kernels run in 4 runs
        separated by gaps (the host's queueing), with the host's launch
        events (``cuda_runtime``) that mark a card's trace."""
        events = [
            {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
             "name": "frontdoor_round(77)#5", "ts": 90.0, "dur": 300.0},
            {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
             "name": "frontdoor_round(77)#5", "ts": 100.0, "dur": 300.0},
        ]
        for i, (ts, dur) in enumerate(((100.0, 10.0), (150.0, 20.0),
                                       (250.0, 5.0), (390.0, 10.0))):
            events.append({"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
                           "name": "cudaLaunchKernel", "ts": ts - 20.0, "dur": 2.0})
            events.append({"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
                           "name": f"k{i}", "ts": ts, "dur": dur})
        return {"traceEvents": events}

    def test_a_dispatch_cut_into_runs_is_one_launch(self):
        spans = tx.parse_trace_events(self.card_doc(), include_ops=True)
        assert tx.module_lane_source(self.card_doc()) == "kernel_segments"
        ledger = tl.build_ledger(spans)
        assert len(ledger.launches) == 4  # the per-run records stay
        assert tl.dispatch_count(ledger) == 1
        summary = ledger.to_dict()
        assert summary["launches"] == 1
        assert summary["launches_with_ops"] == 1
        assert summary["tier_counts"] == {"identity": 1}
        assert summary["reasons"] == {}
        assert ledger.raw_join_rate == 1.0
        assert ledger.substantive_join_rate == 1.0
        assert ledger.exact_substantive_join_rate == 1.0
        breakdown = tx.launch_match_breakdown(spans, ledger=ledger)
        assert breakdown["launches"] == 1
        assert breakdown["launches_with_ops"] == 1
        assert breakdown["unmatched_count"] == 0
        assert breakdown["raw_join_rate"] == 1.0
        # The fold is unchanged: the runs are busy, the gaps idle.
        assert ledger.total_us == 300.0
        assert ledger.buckets_us == {"joined": 45.0, "helper": 0.0, "compile": 0.0,
                                     "idle_gap": 255.0, "unexplained": 0.0}
        assert [rec.tier for rec in ledger.launches] == ["identity"] * 4

    def test_raw_rate_counts_dispatches_on_both_sides(self):
        """A second dispatch with no kernels of its own (a helper) is one
        unjoined launch beside the joined one: 1 of 2, however many runs
        the joined one has; an anonymous run counts alone."""
        doc = self.card_doc()
        doc["traceEvents"] += [
            {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
             "name": "helper(9)#1", "ts": 420.0, "dur": 5.0},
            {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
             "name": "warmup(8)", "ts": 430.0, "dur": 5.0},
            {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "kw",
             "ts": 431.0, "dur": 2.0},
        ]
        ledger = tl.build_ledger(tx.parse_trace_events(doc, include_ops=True))
        # helper(9)#1 holds no kernel, so it makes no module span.
        assert len(ledger.launches) == 5
        assert tl.dispatch_count(ledger) == 2
        assert ledger.raw_join_rate == 0.5
        # Every count and rate reads dispatches: the 4 joined runs are
        # one joined launch beside the anonymous one.
        summary = ledger.to_dict()
        assert summary["launches_with_ops"] == 2
        assert summary["tier_counts"] == {"identity": 1}
        assert summary["reasons"] == {"anonymous_launch": 1}
        assert ledger.substantive_join_rate == 0.5
        assert ledger.exact_substantive_join_rate == 0.5
        breakdown = tx.launch_match_breakdown(
            tx.parse_trace_events(doc, include_ops=True))
        assert breakdown["launches"] == 2
        assert breakdown["reasons"] == {"anonymous_launch": 1}
        assert sum(breakdown["reasons"].values()) <= breakdown["launches"]

    @pytest.mark.parametrize("seed,kw", list(zip((1337, 3, 21, 99, 7), ARG_SETS)))
    def test_seeded_captures_have_one_record_per_dispatch(self, seed, kw):
        (js, jc, _), (ts, tc, _) = both_captures(seed=seed, **kw)
        ledger = tl.build_ledger(ts, tc)
        assert tl.dispatch_count(ledger) == len(ledger.launches)
        assert ledger.to_dict() == jl.build_ledger(js, jc).to_dict()


# ---- roofline -----------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"


def same_verdict(got, want):
    """Equal verdicts; the compute-bound ``detail`` names the card's own
    roof (tensor cores, not the MXU), so ``detail`` is held to its
    opening words."""
    assert {k: v for k, v in got.items() if k != "detail"} == {
        k: v for k, v in want.items() if k != "detail"}
    assert got["detail"].split(":")[0] == want["detail"].split(":")[0]


class TestRoofline:
    def test_peaks_table_is_the_h100_row_only(self):
        assert tr.peaks_for_chip(H100) == (3.35e12, 989e12)
        with pytest.raises(KeyError):
            tr.peaks_for_chip("v5e")
        with pytest.raises(KeyError):
            tr.peaks_for_chip("NVIDIA A100-SXM4-80GB")

    def test_roofs_are_required_and_read_from_the_card(self, monkeypatch):
        """No fold defaults to a card's roofs: they are passed, or read
        from the card this process runs on, whose name must be known."""
        with pytest.raises(TypeError):
            tr.roofline_verdict(1.2, 3.4e9, 2.5e9)
        with pytest.raises(TypeError):
            tr.verdict_from_ledger(tl.build_ledger([]), 1e9, 1e9)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tr.card_peaks()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda device=None: "NVIDIA A100-SXM4-80GB")
        with pytest.raises(KeyError):
            tr.card_peaks()
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: H100)
        assert tr.card_peaks() == tr.peaks_for_chip(H100)

    def test_memory_vs_compute_bound(self):
        bw, flops = tr.peaks_for_chip(H100)
        mem = tr.roofline_verdict(1.2, 3.4e9, 2.5e9 * 8, peak_bw=bw, peak_flops=flops)
        same_verdict(mem, jr.roofline_verdict(1.2, 3.4e9, 2.5e9 * 8,
                                              peak_bw=bw, peak_flops=flops))
        assert mem["verdict"] == tr.VERDICT_MEMORY_BOUND
        assert mem["hbm_bw_pct"] > mem["mfu_pct"]
        comp = tr.roofline_verdict(2.0, 1e8, 1.5e12, peak_bw=bw, peak_flops=flops)
        same_verdict(comp, jr.roofline_verdict(2.0, 1e8, 1.5e12,
                                               peak_bw=bw, peak_flops=flops))
        assert comp["verdict"] == tr.VERDICT_COMPUTE_BOUND
        assert comp["mfu_pct"] > comp["hbm_bw_pct"]

    def test_decode_step_cost_accounting(self):
        got = tr.decode_step_cost(1e9, 2e8, batch=8, param_bytes=2.0)
        assert got == jr.decode_step_cost(1e9, 2e8, batch=8, param_bytes=2.0)
        assert got[0] == pytest.approx(2.2e9)
        assert got[1] == pytest.approx(2.0 * 1e9 * 8)

    def test_verdict_from_ledger_uses_program_mean(self):
        ledger, _ = make_ledger(seed=1337)
        (js, jc, _), _ = both_captures(seed=1337)
        bw, flops = tr.peaks_for_chip(H100)
        verdict = tr.verdict_from_ledger(ledger, 3.4e9, 2.0e10,
                                         program_id=tsyn.STEP_FINGERPRINT,
                                         peak_bw=bw, peak_flops=flops)
        same_verdict(verdict, jr.verdict_from_ledger(
            jl.build_ledger(js, jc), 3.4e9, 2.0e10, program_id=jsyn.STEP_FINGERPRINT,
            peak_bw=bw, peak_flops=flops))
        assert verdict["launches"] == (ledger.tier_counts[tl.TIER_IDENTITY]
                                       + ledger.tier_counts[tl.TIER_LANE_WINDOW])
        assert verdict["launch"] == tsyn.STEP_FINGERPRINT

    def test_verdict_from_ledger_refuses_without_joins(self):
        bw, flops = tr.peaks_for_chip(H100)
        assert tr.verdict_from_ledger(tl.build_ledger([]), 1e9, 1e9,
                                      peak_bw=bw, peak_flops=flops) is None

    def test_attach_roofline_is_schema_legal(self):
        from datetime import datetime, timezone

        from tpuslo.attribution.mapper import build_attribution
        from tpuslo.faultreplay import generate_fault_samples
        from tpuslo.schema import SCHEMA_INCIDENT_ATTRIBUTION, validate

        sample = generate_fault_samples(
            "preemption_eviction", 1, datetime(2026, 8, 1, tzinfo=timezone.utc)
        )[0]
        attribution = build_attribution(sample)
        bw, flops = tr.peaks_for_chip(H100)
        tr.attach_roofline(attribution, tr.roofline_verdict(1.2, 3.4e9, 2.0e10,
                                                            peak_bw=bw, peak_flops=flops))
        payload = attribution.to_dict()
        assert payload["roofline"]["verdict"] == tr.VERDICT_MEMORY_BOUND
        validate(payload, SCHEMA_INCIDENT_ATTRIBUTION)

    def test_contract_rejects_malformed_verdict(self):
        from datetime import datetime, timezone

        from tpuslo.attribution.mapper import build_attribution
        from tpuslo.faultreplay import generate_fault_samples
        from tpuslo.schema import SCHEMA_INCIDENT_ATTRIBUTION, validate

        sample = generate_fault_samples(
            "hbm_pressure", 1, datetime(2026, 8, 1, tzinfo=timezone.utc)
        )[0]
        attribution = build_attribution(sample)
        tr.attach_roofline(attribution, {"verdict": "sideways_bound"})
        with pytest.raises(Exception):
            validate(attribution.to_dict(), SCHEMA_INCIDENT_ATTRIBUTION)


class TestDispatchLedger:
    def test_note_accumulates_and_snapshots(self):
        sides = []
        for mod in (jdispatch, tdispatch):
            ledger = mod.DispatchLedger()
            ledger.note(1_000_000, 4_000_000, tokens=10, slots=4)
            ledger.note(2_000_000, 6_000_000, tokens=14, slots=3)
            sides.append((ledger.steps, ledger.device_wait_ms_total,
                          ledger.dispatch_ms_total, ledger.last(), ledger.totals()))
        assert sides[1] == sides[0]
        steps, wait, dispatch, last, totals = sides[1]
        assert steps == 2
        assert wait == pytest.approx(10.0) and dispatch == pytest.approx(3.0)
        assert last == {"dispatch_ms": 2.0, "device_wait_ms": 6.0, "tokens": 14, "slots": 3}
        assert totals["tokens_total"] == 24
        assert totals["device_wait_ms_per_token"] == pytest.approx(10.0 / 24, rel=1e-3)


# ---- front-door tracing + per-dispatch ledger ---------------------------


@pytest.fixture(scope="module")
def engines():
    """(JAX target, JAX draft), (port target, port draft): llama_tiny in
    f32 on the CPU over the same weights."""
    from tpuslo.models import llama as jllama
    from tpuslo.models import serve as jserve
    from tpuslo_torch.models import bridge
    from tpuslo_torch.models import llama as tllama
    from tpuslo_torch.models import serve as tserve

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg_j = dataclasses.replace(jllama.llama_tiny(max_seq_len=128), dtype=jnp.float32)
    cfg_t = dataclasses.replace(tllama.llama_tiny(max_seq_len=128), dtype=torch.float32)
    pj = jllama.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, "cpu")
    yield ((jserve.ServeEngine(cfg=cfg_j, params=pj), jserve.ServeEngine(cfg=cfg_j, params=pj)),
           (tserve.ServeEngine(cfg=cfg_t, params=pt, device="cpu"),
            tserve.ServeEngine(cfg=cfg_t, params=pt, device="cpu")))
    torch.set_num_threads(threads)


def traced_run(side, tracer_mod, frontdoor_mod, prompt="trace me"):
    exported = []
    tracer = tracer_mod.SelfTracer(
        tracer_mod.TracerConfig(sample_rate=1.0, metrics_stride=1),
        on_export=exported.append,
    )
    door = frontdoor_mod.FrontDoorEngine(
        side[0], side[1], k=3, max_slots=2, rounds_per_step=1, self_tracer=tracer,
    )
    door.submit(prompt, max_new_tokens=6, stop_at_eos=False)
    door.submit(prompt + " again", max_new_tokens=9, stop_at_eos=False)
    results = door.run()
    return exported, results, door, tracer


class TestFrontDoorTracing:
    def test_step_emits_root_and_stage_spans_with_ledger_attrs(self, engines):
        from tpuslo.models import frontdoor as jfd
        from tpuslo.obs import tracer as jtracer
        from tpuslo_torch.models import frontdoor as tfd
        from tpuslo_torch.obs import tracer as ttracer

        j_exported, j_results, _, j_tracer = traced_run(engines[0], jtracer, jfd)
        exported, results, door, tracer = traced_run(engines[1], ttracer, tfd)
        assert results == j_results  # streams identical to the JAX engine's
        assert [[s.name for s in spans] for spans in exported] == [
            [s.name for s in spans] for spans in j_exported]
        # Which verdict kept a cycle depends on its wall time (a JAX
        # compile makes a slow first step); that every cycle was kept
        # does not.
        assert tracer.stats["cycles"] == j_tracer.stats["cycles"] == len(exported)
        assert tracer.stats["dropped"] == j_tracer.stats["dropped"] == 0
        assert exported, "sample_rate 1.0 must export every step cycle"
        roots = [spans[0] for spans in exported]
        assert all(root.name == "frontdoor.step" for root in roots)
        assert all(isinstance(root, ttracer.Span) for root in roots)
        dispatching = next(spans for spans in exported if len(spans) == 5)
        assert [s.name for s in dispatching[1:]] == ["admit", "dispatch", "read", "retire"]
        for child in dispatching[1:]:
            assert child.parent_span_id == dispatching[0].span_id
            assert child.trace_id == dispatching[0].trace_id
        retire = dispatching[4]
        assert retire.attributes["tokens"] > 0
        assert retire.attributes["device_wait_ms"] >= 0.0
        assert "dispatch_ms" in retire.attributes
        assert retire.attributes["device_wait_ms_total"] >= (
            retire.attributes["device_wait_ms"] - 1e-3)
        assert door.stats()["dispatch_ledger"]["steps"] == door.rounds

    def test_dispatch_ledger_rides_stats_without_tracer(self, engines):
        from tpuslo.models import frontdoor as jfd
        from tpuslo_torch.models import frontdoor as tfd

        observed = []
        for mod, side in ((jfd, engines[0]), (tfd, engines[1])):
            door = mod.FrontDoorEngine(side[0], side[1], k=3, max_slots=2, rounds_per_step=1)
            door.submit("no tracer", max_new_tokens=6, stop_at_eos=False)
            results = door.run()
            totals = door.stats()["dispatch_ledger"]
            observed.append((results, totals["steps"], totals["tokens_total"], door.rounds))
            assert all(len(v) == 6 for v in results.values())
            assert totals["steps"] == door.rounds
            assert totals["tokens_total"] == sum(len(v) for v in results.values()) - len(results)
            assert totals["device_wait_ms_total"] > 0.0
        assert observed[1] == observed[0]
