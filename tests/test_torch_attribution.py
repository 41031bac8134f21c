"""The port's attribution engine against the JAX package's.

Mirrors ``tests/test_attribution.py`` on ``tpuslo_torch`` (mapper,
Bayesian attributor, batch parity, pipeline, the golden multi-fault
dataset, fault replay, IO and the DCN domain), and holds every ported
function's output to the JAX function's on the same samples: domains and
evidence equal, floats within ``FLOAT_TOL``, and ``IncidentAttribution``
payloads equal apart from those floats.  Samples cross between the
packages through their JSON payloads (``FaultSample.to_dict`` /
``from_dict``).  The golden dataset is read from the JAX package's test
data.  The calibrated tables are held to 1e-12.
"""

from __future__ import annotations

import io
import json
import math
from datetime import datetime, timezone
from pathlib import Path

import pytest

from tpuslo import attribution as jattribution
from tpuslo import faultreplay as jfaultreplay
from tpuslo.attribution import calibrate as jcalibrate
from tpuslo.signals.generator import profile_for_fault as jprofile
from tpuslo_torch import attribution, faultreplay, schema
from tpuslo_torch.attribution import calibrate
from tpuslo_torch.signals.generator import profile_for_fault

#: The JAX package's own numpy-vs-jit bar for posteriors.
FLOAT_TOL = 1e-10
TS = datetime(2026, 7, 29, 12, 0, 0, tzinfo=timezone.utc)
GOLDEN = (Path(__file__).parent.parent
          / "tpuslo/attribution/testdata/multi_fault_samples.jsonl")

SINGLE_FAULTS = [
    "dns_latency", "cpu_throttle", "memory_pressure", "provider_throttle",
    "network_partition", "ici_drop", "hbm_pressure", "xla_recompile_storm",
    "host_offload_stall",
]


def make_sample(label, signals=None, **overrides):
    s = attribution.FaultSample(
        incident_id="inc-1", timestamp=TS, cluster="tpu-cluster", namespace="llm",
        service="rag-service", fault_label=label, confidence=0.9, burn_rate=2.0,
        window_minutes=5, request_id="req-1", trace_id="trace-1",
        signals=signals if signals is not None else profile_for_fault(label),
    )
    for k, v in overrides.items():
        setattr(s, k, v)
    return s


def to_jax(samples):
    """The same samples as the JAX package's ``FaultSample``s."""
    return [jattribution.FaultSample.from_dict(s.to_dict()) for s in samples]


def assert_close_payload(got, want, path="$"):
    """Equal JSON payloads, floats within FLOAT_TOL."""
    if isinstance(want, float) or isinstance(got, float):
        assert math.isclose(got, want, rel_tol=0.0, abs_tol=FLOAT_TOL), (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for key in want:
            assert_close_payload(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_payload(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def assert_same_attributions(port, jax):
    assert len(port) == len(jax)
    for p, j in zip(port, jax):
        assert p.predicted_fault_domain == j.predicted_fault_domain
        assert_close_payload(p.to_dict(), j.to_dict())


def assert_same_posteriors(port, jax):
    assert [p.domain for p in port] == [j.domain for j in jax]
    assert [p.evidence for p in port] == [j.evidence for j in jax]
    for p, j in zip(port, jax):
        assert p.posterior == pytest.approx(j.posterior, abs=FLOAT_TOL)


class TestMapper:
    @pytest.mark.parametrize("label,domain", [
        ("dns_latency", "network_dns"), ("network_partition", "network_egress"),
        ("ici_drop", "tpu_ici"), ("hbm_pressure", "tpu_hbm"),
        ("xla_recompile_storm", "xla_compile"), ("host_offload_stall", "host_offload"),
        ("dcn_degradation", "tpu_dcn"), ("preemption_eviction", "tpu_preemption"),
        ("noisy_neighbor_cpu", "host_noisy_neighbor"), ("something_else", "unknown"),
    ])
    def test_map_fault_label(self, label, domain):
        assert attribution.map_fault_label(label) == domain
        assert jattribution.map_fault_label(label) == domain

    @pytest.mark.parametrize("label", ["ici_drop", "dns_latency", "preemption_eviction"])
    def test_rule_envelope_validates_and_equals_jax(self, label):
        sample = make_sample(label, signals={})
        att = attribution.build_attribution(sample)
        schema.validate(att.to_dict(), schema.SCHEMA_INCIDENT_ATTRIBUTION)
        assert att.to_dict() == jattribution.build_attribution(to_jax([sample])[0]).to_dict()

    def test_expected_domains_for(self):
        samples = faultreplay.generate_fault_samples("tpu_mixed_multi", 4, TS)
        assert ([attribution.expected_domains_for(s) for s in samples]
                == [jattribution.expected_domains_for(s) for s in to_jax(samples)])


class TestBayesian:
    @pytest.mark.parametrize("label", SINGLE_FAULTS)
    def test_single_fault_top1(self, label):
        posteriors = attribution.BayesianAttributor().attribute(profile_for_fault(label))
        assert posteriors[0].domain == attribution.map_fault_label(label)
        assert posteriors[0].posterior > 0.5
        assert_same_posteriors(
            posteriors, jattribution.BayesianAttributor().attribute(jprofile(label)))

    @pytest.mark.parametrize("evidence", ["hard", "soft"])
    def test_posteriors_normalized_and_equal_jax(self, evidence):
        port = attribution.BayesianAttributor(evidence=evidence)
        jax = jattribution.BayesianAttributor(evidence=evidence)
        for label in ("hbm_pressure", "baseline", "preemption_eviction"):
            got = port.attribute(profile_for_fault(label))
            assert sum(p.posterior for p in got) == pytest.approx(1.0)
            assert_same_posteriors(got, jax.attribute(jprofile(label)))

    def test_no_elevated_signals_prefers_nothing_strongly(self):
        posteriors = attribution.BayesianAttributor().attribute(profile_for_fault("baseline"))
        assert posteriors[0].posterior < 0.9

    def test_evidence_lists_only_elevated_supporting_signals(self):
        top = attribution.BayesianAttributor().attribute(profile_for_fault("ici_drop"))[0]
        assert top.evidence == ["ici_collective_latency_ms", "ici_link_retries_total"]

    def test_attribute_sample_without_signals_falls_back_to_rule(self):
        out = attribution.BayesianAttributor().attribute_sample(
            make_sample("dns_latency", signals={}))
        assert out.predicted_fault_domain == "network_dns"
        assert out.fault_hypotheses == []

    def test_attribute_sample_envelope_validates(self):
        sample = make_sample("xla_recompile_storm")
        out = attribution.BayesianAttributor().attribute_sample(sample)
        schema.validate(out.to_dict(), schema.SCHEMA_INCIDENT_ATTRIBUTION)
        assert out.predicted_fault_domain == "xla_compile"
        assert_same_attributions(
            [out], [jattribution.BayesianAttributor().attribute_sample(to_jax([sample])[0])])

    def test_explaining_away_surfaces_secondary_fault(self):
        merged = {}
        for label in ("hbm_pressure", "host_offload_stall"):
            for k, v in profile_for_fault(label).items():
                merged[k] = max(merged.get(k, 0.0), v)
        sample = make_sample("hbm_pressure", signals=merged)
        out = attribution.BayesianAttributor().attribute_sample(sample)
        domains = {h.domain: h.posterior for h in out.fault_hypotheses}
        assert domains["tpu_hbm"] >= 0.05 and domains["host_offload"] >= 0.05
        assert_same_attributions(
            [out], [jattribution.BayesianAttributor().attribute_sample(to_jax([sample])[0])])

    def test_degraded_mode_dns_only_signals(self):
        full = profile_for_fault("dns_latency")
        subset = {k: full[k] for k in ("dns_latency_ms", "tcp_retransmits_total")}
        posteriors = attribution.BayesianAttributor().attribute(subset)
        assert posteriors[0].domain == "network_dns"
        assert_same_posteriors(posteriors, jattribution.BayesianAttributor().attribute(subset))

    def test_tables_equal_jax(self):
        assert attribution.default_likelihoods() == jattribution.default_likelihoods()
        assert attribution.default_priors() == jattribution.default_priors()
        assert attribution.ALL_DOMAINS == jattribution.ALL_DOMAINS
        assert attribution.TPU_DOMAINS == jattribution.TPU_DOMAINS
        assert (attribution.SIGNAL_ELEVATION_THRESHOLDS
                == jattribution.SIGNAL_ELEVATION_THRESHOLDS)
        table = attribution.default_likelihoods()
        assert len(table) == 22
        for row in table.values():
            assert set(row) == set(attribution.ALL_DOMAINS)
            assert all(0.0 < p < 1.0 for p in row.values())

    @pytest.mark.parametrize("signal,value", [
        ("dns_latency_ms", 0.0), ("dns_latency_ms", 40.0), ("dns_latency_ms", 500.0),
        ("device_idle_gap_ms", 600.0), ("xla_compile_ms", 3200.0), ("nope", 1.0),
    ])
    def test_soft_evidence_weight_equals_jax(self, signal, value):
        from tpuslo.attribution import bayesian as jb
        from tpuslo_torch.attribution import bayesian as tb

        assert tb.soft_evidence_weight(signal, value) == jb.soft_evidence_weight(signal, value)


class TestBatchParity:
    """attribute_batch against the scalar path (on the port), and both
    against the JAX package's on the same samples."""

    @staticmethod
    def all_samples():
        samples = attribution.load_samples_jsonl(GOLDEN)
        for label in SINGLE_FAULTS:
            samples.append(make_sample(label))
        samples.append(make_sample("dns_latency", signals={}))
        samples.append(make_sample("dns_latency", signals={"nope_ms": 9.9}))
        samples.append(make_sample("cpu_throttle", signals={"dns_latency_ms": 1.0}))
        samples.append(make_sample("hbm_pressure", signals={"hbm_alloc_stall_ms": 50.0}))
        return samples

    def test_batch_matches_scalar_exactly(self):
        attributor = attribution.BayesianAttributor()
        samples = self.all_samples()
        batch = attributor.attribute_batch(samples)
        scalar = [attributor.attribute_sample(s) for s in samples]
        for b, s in zip(batch, scalar):
            assert b.predicted_fault_domain == s.predicted_fault_domain
            assert b.confidence == pytest.approx(s.confidence, abs=1e-12)
            assert ([(h.domain, h.evidence) for h in b.fault_hypotheses]
                    == [(h.domain, h.evidence) for h in s.fault_hypotheses])
            for hb, hs in zip(b.fault_hypotheses, s.fault_hypotheses):
                assert hb.posterior == pytest.approx(hs.posterior, abs=1e-12)

    @pytest.mark.parametrize("evidence", ["hard", "soft"])
    def test_batch_and_scalar_equal_jax(self, evidence):
        port = attribution.BayesianAttributor(evidence=evidence)
        jax = jattribution.BayesianAttributor(evidence=evidence)
        samples = self.all_samples()
        jsamples = to_jax(samples)
        assert_same_attributions(port.attribute_batch(samples), jax.attribute_batch(jsamples))
        assert_same_attributions([port.attribute_sample(s) for s in samples],
                                 [jax.attribute_sample(s) for s in jsamples])

    def test_batch_preserves_input_order(self):
        samples = [make_sample("dns_latency", signals={}), make_sample("ici_drop"),
                   make_sample("cpu_throttle", signals={}), make_sample("hbm_pressure")]
        preds = attribution.BayesianAttributor().attribute_batch(samples)
        assert len(preds) == 4
        assert preds[1].predicted_fault_domain == "tpu_ici"
        assert preds[3].predicted_fault_domain == "tpu_hbm"

    def test_batch_matches_scalar_with_incomplete_custom_table(self):
        table = attribution.default_likelihoods()
        table["dns_latency_ms"] = {
            d: p for d, p in table["dns_latency_ms"].items() if d != "network_dns"}
        attributor = attribution.BayesianAttributor(likelihoods=table)
        jattributor = jattribution.BayesianAttributor(likelihoods=table)
        samples = [make_sample("dns_latency"), make_sample("network_partition")]
        batch = attributor.attribute_batch(samples)
        scalar = [attributor.attribute_sample(s) for s in samples]
        for b, s in zip(batch, scalar):
            assert b.predicted_fault_domain == s.predicted_fault_domain
            assert ([(h.domain, h.evidence) for h in b.fault_hypotheses]
                    == [(h.domain, h.evidence) for h in s.fault_hypotheses])
        assert_same_attributions(batch, jattributor.attribute_batch(to_jax(samples)))

    def test_batch_parity_with_table_missing_a_thresholded_signal(self):
        table = attribution.default_likelihoods()
        del table["syscall_latency_ms"]
        sample = make_sample("network_partition", signals={
            "dns_latency_ms": 100.0, "tcp_retransmits_total": 6.0,
            "connect_latency_ms": 200.0, "syscall_latency_ms": 120.0,
        })
        attributor = attribution.BayesianAttributor(likelihoods=table)
        b = attributor.attribute_batch([sample])[0]
        s = attributor.attribute_sample(sample)
        assert ([(h.domain, h.evidence) for h in b.fault_hypotheses]
                == [(h.domain, h.evidence) for h in s.fault_hypotheses])
        for hb, hs in zip(b.fault_hypotheses, s.fault_hypotheses):
            assert hb.posterior == pytest.approx(hs.posterior, abs=1e-12)
        assert_same_attributions(
            [b], jattribution.BayesianAttributor(likelihoods=table).attribute_batch(
                to_jax([sample])))

    def test_batch_tracks_live_table_mutation(self):
        attributor = attribution.BayesianAttributor()
        sample = make_sample("dns_latency")
        before = attributor.attribute_batch([sample])[0]
        attributor.likelihoods["dns_latency_ms"] = {d: 0.01 for d in attribution.ALL_DOMAINS}
        after = attributor.attribute_batch([sample])[0]
        assert after.confidence == pytest.approx(
            attributor.attribute_sample(sample).confidence, abs=1e-12)
        assert after.confidence != pytest.approx(before.confidence, abs=1e-6)

    def test_batch_empty(self):
        assert attribution.BayesianAttributor().attribute_batch([]) == []

    def test_jax_tables_carry_across(self):
        """The port's attributor takes the JAX attributor's dicts as
        they are and attributes as it does."""
        j = jcalibrate.calibrated_attributor()
        port = attribution.BayesianAttributor(
            priors=j.priors, likelihoods=j.likelihoods, evidence=j.evidence,
            sharpness=j.sharpness)
        samples = faultreplay.generate_fault_samples("tpu_mixed_multi", 12, TS)
        assert_same_attributions(port.attribute_batch(samples),
                                 j.attribute_batch(to_jax(samples)))


class TestPipeline:
    def test_mode_dispatch(self):
        assert attribution.normalize_mode("RULE ") == "rule"
        assert attribution.normalize_mode("bayes") == "bayes"
        assert attribution.normalize_mode("whatever") == "bayes"

    def test_confusion_matrix_counts(self):
        samples = [make_sample("dns_latency"), make_sample("ici_drop")]
        preds = attribution.build_attributions(samples)
        matrix = attribution.build_confusion_matrix(samples, preds)
        assert matrix[("network_dns", "network_dns")] == 1
        assert matrix[("tpu_ici", "tpu_ici")] == 1

    def test_rule_mode(self):
        samples = [make_sample("dns_latency")]
        preds = attribution.build_attributions(samples, mode="rule")
        assert preds[0].fault_hypotheses == []
        assert attribution.accuracy(samples, preds) == 1.0


class TestGoldenDataset:
    @pytest.fixture(scope="class")
    def golden(self):
        samples = attribution.load_samples_jsonl(GOLDEN)
        preds = attribution.build_attributions(samples, mode="bayes")
        return samples, preds

    def test_dataset_size(self, golden):
        assert len(golden[0]) >= 55

    def test_all_predictions_validate(self, golden):
        for p in golden[1]:
            schema.validate(p.to_dict(), schema.SCHEMA_INCIDENT_ATTRIBUTION)

    def test_predictions_equal_jax(self, golden):
        samples, preds = golden
        jsamples = jattribution.load_samples_jsonl(GOLDEN)
        assert [s.to_dict() for s in samples] == [s.to_dict() for s in jsamples]
        assert_same_attributions(preds, jattribution.build_attributions(jsamples))

    def test_single_fault_accuracy_gate(self, golden):
        singles = [(s, p) for s, p in zip(*golden) if not s.expected_domains]
        assert attribution.accuracy(*map(list, zip(*singles))) == 1.0

    def test_partial_accuracy_gate(self, golden):
        assert attribution.partial_accuracy(*golden) == 1.0

    def test_coverage_accuracy_gate(self, golden):
        assert attribution.coverage_accuracy(*golden) >= 0.85

    def test_macro_f1_beats_rebuild_target(self, golden):
        report = attribution.macro_f1(*golden)
        assert report.macro_f1 >= 0.85
        assert report.micro_accuracy >= 0.95

    def test_tpu_fault_f1(self, golden):
        pairs = [(s, p) for s, p in zip(*golden)
                 if set(attribution.expected_domains_for(s)) & set(attribution.TPU_DOMAINS)]
        assert attribution.macro_f1(*map(list, zip(*pairs))).macro_f1 >= 0.70

    def test_metrics_equal_jax(self, golden):
        samples, preds = golden
        jsamples = to_jax(samples)
        jpreds = jattribution.build_attributions(jsamples)
        assert (attribution.build_confusion_matrix(samples, preds)
                == jattribution.build_confusion_matrix(jsamples, jpreds))
        for name in ("accuracy", "partial_accuracy", "coverage_accuracy"):
            assert (getattr(attribution, name)(samples, preds)
                    == getattr(jattribution, name)(jsamples, jpreds))
        got, want = attribution.macro_f1(samples, preds), jattribution.macro_f1(jsamples, jpreds)
        assert (got.macro_f1, got.micro_accuracy) == (want.macro_f1, want.micro_accuracy)
        assert [vars(s) for s in got.per_domain] == [vars(s) for s in want.per_domain]


class TestFaultReplay:
    def test_supported_scenarios(self):
        scen = faultreplay.supported_scenarios()
        assert scen == jfaultreplay.supported_scenarios()
        for s in ("mixed", "mixed_multi", "tpu_mixed", "tpu_mixed_multi"):
            assert s in scen

    @pytest.mark.parametrize("scenario", jfaultreplay.supported_scenarios())
    def test_every_scenario_equals_jax(self, scenario):
        got = faultreplay.generate_fault_samples(scenario, 9, TS)
        want = jfaultreplay.generate_fault_samples(scenario, 9, TS)
        assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
        assert_same_attributions(attribution.build_attributions(got),
                                 jattribution.build_attributions(want))

    def test_deterministic(self):
        a = faultreplay.generate_fault_samples("tpu_mixed", 6, TS)
        b = faultreplay.generate_fault_samples("tpu_mixed", 6, TS)
        assert [s.to_dict() for s in a] == [s.to_dict() for s in b]

    def test_samples_carry_signal_vectors(self):
        samples = faultreplay.generate_fault_samples("hbm_pressure", 2, TS)
        assert samples[0].signals["hbm_alloc_stall_ms"] == 60

    def test_multi_fault_expected_domains(self):
        samples = faultreplay.generate_fault_samples("tpu_mixed_multi", 4, TS)
        assert samples[0].expected_domains == ["tpu_hbm", "host_offload"]
        assert samples[1].expected_domains == ["tpu_ici", "network_egress"]
        assert faultreplay.TPU_MULTI_FAULT_PAIRS == jfaultreplay.TPU_MULTI_FAULT_PAIRS
        assert faultreplay.MULTI_FAULT_PAIRS == jfaultreplay.MULTI_FAULT_PAIRS

    def test_unknown_scenario_raises(self):
        with pytest.raises(ValueError):
            faultreplay.generate_fault_samples("plasma_leak", 1, TS)

    def test_count_validation(self):
        with pytest.raises(ValueError):
            faultreplay.generate_fault_samples("mixed", 0, TS)


class TestIO:
    def test_round_trip(self, tmp_path):
        samples = faultreplay.generate_fault_samples("tpu_mixed_multi", 4, TS)
        path = tmp_path / "samples.jsonl"
        with open(path, "w") as f:
            attribution.dump_samples_jsonl(samples, f)
        loaded = attribution.load_samples_jsonl(path)
        assert [s.to_dict() for s in loaded] == [s.to_dict() for s in samples]
        # The JAX reader takes the port's file, line for line.
        assert ([s.to_dict() for s in jattribution.load_samples_jsonl(path)]
                == [s.to_dict() for s in samples])

    def test_attribution_lines_equal_jax(self):
        samples = faultreplay.generate_fault_samples("tpu_mixed", 4, TS)
        got, want = io.StringIO(), io.StringIO()
        attribution.dump_attributions_jsonl(attribution.build_attributions(samples), got)
        jattribution.dump_attributions_jsonl(
            jattribution.build_attributions(to_jax(samples)), want)
        assert got.getvalue().count("\n") == 4
        for g, w in zip(got.getvalue().splitlines(), want.getvalue().splitlines()):
            assert_close_payload(json.loads(g), json.loads(w))

    def test_empty_file_raises(self, tmp_path):
        path = tmp_path / "empty.jsonl"
        path.write_text("\n\n")
        with pytest.raises(ValueError):
            attribution.load_samples_jsonl(path)

    def test_bad_line_raises_with_location(self, tmp_path):
        path = tmp_path / "bad.jsonl"
        path.write_text('{"incident_id": "x"\n')
        with pytest.raises(ValueError, match="bad.jsonl:1"):
            attribution.load_samples_jsonl(path)


class TestDCNDomain:
    @pytest.mark.parametrize("scenario,expect", [
        ("dcn_degradation", "tpu_dcn"), ("ici_drop", "tpu_ici"),
        ("network_partition", "network_egress"),
    ])
    def test_dcn_scenario_attributes_to_tpu_dcn(self, scenario, expect):
        samples = faultreplay.generate_fault_samples(scenario, 10, TS)
        preds = attribution.build_attributions(samples, mode="bayes")
        assert {p.predicted_fault_domain for p in preds} == {expect}

    def test_dcn_evidence_names_the_transfer_signal(self):
        samples = faultreplay.generate_fault_samples("dcn_degradation", 3, TS)
        for p in attribution.build_attributions(samples, mode="bayes"):
            assert any(e.signal == "dcn_transfer_latency_ms" and e.source == "megascale"
                       for e in p.evidence), p.evidence


class TestCalibration:
    """The port's calibrated attributor is the JAX one: the fit is numpy
    and deterministic."""

    @pytest.fixture(scope="class")
    def pair(self):
        return calibrate.calibrated_attributor(), jcalibrate.calibrated_attributor()

    def test_calibrated_tables_equal_jax(self, pair):
        port, jax = pair
        assert set(port.likelihoods) == set(jax.likelihoods)
        for signal, row in jax.likelihoods.items():
            assert set(port.likelihoods[signal]) == set(row)
            for domain, p in row.items():
                assert port.likelihoods[signal][domain] == pytest.approx(p, abs=1e-12)
        assert set(port.priors) == set(jax.priors)
        for domain, p in jax.priors.items():
            assert port.priors[domain] == pytest.approx(p, abs=1e-12)
        assert (port.evidence, port.sharpness) == (jax.evidence, jax.sharpness)

    @pytest.mark.parametrize("noise", ["lognormal", "gamma"])
    def test_noisy_replicas_attribute_as_jax(self, pair, noise):
        port, jax = pair
        base = calibrate._base_samples(calibrate.TPU_SCENARIOS, 6)
        jbase = jcalibrate._base_samples(jcalibrate.TPU_SCENARIOS, 6)
        noisy = calibrate.corrupt(base, 0.5, 42, noise=noise)
        jnoisy = jcalibrate.corrupt(jbase, 0.5, 42, noise=noise)
        assert [s.to_dict() for s in noisy] == [s.to_dict() for s in jnoisy]
        assert_same_attributions(port.attribute_batch(noisy), jax.attribute_batch(jnoisy))

    def test_heldout_samples_equal_jax(self):
        for name in ("variant_samples", "baseline_samples"):
            got = getattr(calibrate, name)(3)
            want = getattr(jcalibrate, name)(3)
            assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
        got = calibrate.sampled_magnitude_samples(("ici_drop", "hbm_pressure"), 3, 5)
        want = jcalibrate.sampled_magnitude_samples(("ici_drop", "hbm_pressure"), 3, 5)
        assert [s.to_dict() for s in got] == [s.to_dict() for s in want]

    def test_heldout_report_equals_jax(self, pair):
        """The held-out axes (noise seed, gamma family, variant
        profiles, full domain, false alarm, abstain) score alike."""
        port, jax = pair
        got = calibrate.heldout_report(port, sigmas=(0.5,), count=6).to_dict()
        want = jcalibrate.heldout_report(jax, sigmas=(0.5,), count=6).to_dict()
        assert got == want

