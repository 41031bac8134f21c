"""Noise calibration for the Bayesian attributor
(the port's own copy of ``tpuslo/attribution/calibrate.py``).

The hand-set likelihood table (``bayesian.default_likelihoods``) encodes
P(signal elevated | domain) for *clean* measurements; under real
measurement noise those probabilities are different — a healthy
``hbm_utilization_pct`` of 62 crosses its 85 warning line in ~26% of
lognormal sigma=0.5 draws, so the hand-set 0.05 "healthy" columns are
badly miscalibrated and the r02 robustness sweep collapsed (macro-F1
0.62 at sigma=0.5 vs the reference methodology's >=0.85 single-fault
bar, from the reference project's attribution-accuracy benchmark).

This module fits the table *empirically*: generate noisy training
replicas of every single-fault scenario, take each signal's mean soft
evidence weight per domain as the calibrated P(signal | domain), and
serve the result through a soft-evidence
(:func:`~tpuslo_torch.attribution.bayesian.soft_evidence_weight`) attributor.

Fitting draws from the canonical fault profiles AND a sampled-magnitude
family (:func:`sampled_magnitude_samples` — severities log-uniform from
the warning line to the canonical point), so the table learns each
domain's testimony across severities rather than memorizing magnitudes.

Validation is held out four ways (``heldout_report``):

* a **noise seed** never used in training;
* a **different noise family** (gamma-multiplicative instead of the
  lognormal the fit saw);
* **variant fault profiles** over ALL trainable domains with
  magnitudes the generator never emits (milder faults, different
  secondary mixes), so the score cannot come from memorizing
  ``tpuslo_torch.signals.generator._FAULT_OVERRIDES``;
* the **abstain axis**: false-alarm rate on noisy NO-FAULT baselines
  and abstention rate on noisy faulted samples (methodology bars:
  both <= 15%).

Everything is deterministic (seeded numpy) and cheap (<1 s), so the
calibrated attributor is fitted on demand rather than shipped as a
frozen artifact — the fit itself is reproducible and tested.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from datetime import datetime, timezone

import numpy as np

from tpuslo_torch.attribution import bayesian as B
from tpuslo_torch.attribution.mapper import FaultSample, map_fault_label
from tpuslo_torch.attribution.pipeline import macro_f1

#: Single-fault scenarios used for fitting — one per attributable domain
#: the synthetic spine can produce.
TRAIN_SCENARIOS: tuple[str, ...] = (
    "ici_drop",
    "dcn_degradation",
    "hbm_pressure",
    "xla_recompile_storm",
    "host_offload_stall",
    "preemption_eviction",
    "noisy_neighbor_cpu",
    "dns_latency",
    "cpu_throttle",
    "memory_pressure",
    "provider_throttle",
    "network_partition",
)

#: The four headline TPU scenarios (bench.py's protocol — UNCHANGED by
#: the round-4 dcn domain for cross-round comparability).
TPU_SCENARIOS: tuple[str, ...] = (
    "ici_drop",
    "hbm_pressure",
    "xla_recompile_storm",
    "host_offload_stall",
)

#: Held-out fault profiles (signal -> value) with magnitudes deliberately
#: different from ``tpuslo_torch.signals.generator._FAULT_OVERRIDES`` — milder
#: faults sitting between warning and error thresholds, plus different
#: secondary-signal mixes.  Used only for evaluation, never fitting.
#:
#: Round 4 expands the set from the 4 TPU domains to ALL trainable
#: domains: with TPU-only variants, a single noisy sample straying into
#: a non-TPU class zeroed 1/5 of the macro (absent classes score F1 0),
#: so the axis measured stray-class luck more than generalization.
#: Full-domain coverage is the stronger validation — every plausible
#: stray lands in a class with support, and the CPU-side domains'
#: generalization gets measured at all.  (Round-3 comparability: the
#: TPU-only number can be recomputed by filtering to the 4 TPU labels.)
VARIANT_PROFILES: dict[str, dict[str, float]] = {
    "ici_drop": {
        "ici_link_retries_total": 12.0,
        "ici_collective_latency_ms": 18.0,
        "host_offload_stall_ms": 4.0,
    },
    "dcn_degradation": {
        # Milder cross-slice stall: transfer latency between warning
        # and error, retransmits at warning, collectives sub-warning.
        "dcn_transfer_latency_ms": 48.0,
        "tcp_retransmits_total": 3.0,
        "ici_collective_latency_ms": 8.0,
    },
    "hbm_pressure": {
        "hbm_alloc_stall_ms": 14.0,
        "hbm_utilization_pct": 91.0,
        "host_offload_stall_ms": 30.0,
        "mem_reclaim_latency_ms": 2.0,
    },
    "xla_recompile_storm": {
        "xla_compile_ms": 900.0,
        "runqueue_delay_ms": 16.0,
        "cpu_steal_pct": 1.5,
    },
    "host_offload_stall": {
        "host_offload_stall_ms": 45.0,
        "disk_io_latency_ms": 22.0,
        "syscall_latency_ms": 120.0,
        "hbm_utilization_pct": 70.0,
    },
    "preemption_eviction": {
        # A single eviction notice with a moderate idle gap (a brief
        # maintenance pause, not a full reclaim) and only a hint of
        # restart recompilation.
        "device_eviction_events_total": 1.0,
        "device_idle_gap_ms": 55.0,
        "xla_compile_ms": 150.0,
    },
    "noisy_neighbor_cpu": {
        # Milder contention: steal/runqueue between warning and error,
        # idle gap barely over warning, cfs_throttled stays clean.
        "cpu_steal_pct": 4.0,
        "runqueue_delay_ms": 14.0,
        "device_idle_gap_ms": 32.0,
    },
    "dns_latency": {
        # Mild resolution stall; connect rides it (the generator's DNS
        # fault is on the connect path), at a different dns:connect
        # ratio than the canonical profile.
        "dns_latency_ms": 70.0,
        "connect_latency_ms": 95.0,
    },
    "cpu_throttle": {
        "runqueue_delay_ms": 14.0,
        "cpu_steal_pct": 3.5,
        "cfs_throttled_ms": 60.0,
    },
    "memory_pressure": {
        "mem_reclaim_latency_ms": 9.0,
        "disk_io_latency_ms": 18.0,
        "runqueue_delay_ms": 11.0,
    },
    "provider_throttle": {
        "connect_latency_ms": 90.0,
        "tls_handshake_ms": 65.0,
        "connect_errors_total": 1.0,
        "syscall_latency_ms": 80.0,
    },
    "network_partition": {
        "connect_latency_ms": 200.0,
        "tcp_retransmits_total": 4.0,
        "dns_latency_ms": 60.0,
        "connect_errors_total": 2.0,
        "tls_handshake_fail_total": 1.0,
    },
}


def _base_samples(scenarios, count: int) -> list[FaultSample]:
    from tpuslo_torch.faultreplay import generate_fault_samples

    start = datetime(2026, 1, 1, tzinfo=timezone.utc)
    out: list[FaultSample] = []
    for scenario in scenarios:
        out.extend(generate_fault_samples(scenario, count, start))
    return out


def variant_samples(count: int = 25) -> list[FaultSample]:
    """Held-out TPU-fault samples built from :data:`VARIANT_PROFILES`."""
    from tpuslo_torch.signals.generator import profile_for_fault

    start = datetime(2026, 2, 1, tzinfo=timezone.utc)
    out: list[FaultSample] = []
    for label, overrides in VARIANT_PROFILES.items():
        base = profile_for_fault("baseline")
        for idx in range(count):
            signals = dict(base)
            signals.update(overrides)
            out.append(
                FaultSample(
                    incident_id=f"variant-{label}-{idx:04d}",
                    timestamp=start,
                    cluster="local",
                    namespace="default",
                    service="chat",
                    fault_label=label,
                    expected_domain=map_fault_label(label),
                    signals=signals,
                    confidence=0.9,
                    burn_rate=2.0,
                    window_minutes=5,
                    request_id=f"variant-req-{idx:04d}",
                    trace_id=f"variant-trace-{idx:04d}",
                )
            )
    return out


def sampled_magnitude_samples(
    scenarios: tuple[str, ...], count: int, seed: int
) -> list[FaultSample]:
    """Training replicas with fault magnitudes DRAWN, not canonical.

    For every fault signal the magnitude is log-uniform over
    [min(canonical, warning), max(canonical, error)] — the span from
    "barely warning" mild faults to the generator's canonical point.
    Fitting over this family teaches each P(signal | domain) the
    domain's testimony across severities instead of memorizing
    ``_FAULT_OVERRIDES``'s exact magnitudes, which is what left the
    variant-profile held-out axis at 0.787: profiles
    between warning and error were effectively out of distribution.
    """
    from tpuslo_torch.signals.generator import profile_for_fault

    import zlib

    start = datetime(2026, 1, 15, tzinfo=timezone.utc)
    base = profile_for_fault("baseline")
    out: list[FaultSample] = []
    for label in scenarios:
        # Per-scenario RNG keyed by (seed, scenario NAME), not list
        # position: adding a scenario to the registry must not shift
        # every later scenario's training draws (observed: the round-4
        # dcn domain silently re-rolled the xla/host fits and cost the
        # gamma held-out axis 0.21 macro through two stray samples).
        rs = np.random.RandomState(
            (seed + zlib.crc32(label.encode())) % (2**32)
        )
        canonical = profile_for_fault(label)
        overrides = {
            k: v for k, v in canonical.items() if v != base.get(k)
        }
        for idx in range(count):
            signals = dict(base)
            for name, value in overrides.items():
                warn = B.SIGNAL_ELEVATION_THRESHOLDS.get(name, value)
                err = B.SIGNAL_ERROR_THRESHOLDS.get(name, value)
                lo = max(min(float(value), float(warn)), 1e-3)
                if float(value) >= float(warn):
                    # Signature signal: mild-to-canonical/error span.
                    hi = max(float(value), float(err))
                else:
                    # Sub-warning co-signal (e.g. ici_drop's mild
                    # host_offload creep): vary it up to the warning
                    # line only — stretching it to the error threshold
                    # would teach the domain a strongly-elevated
                    # co-signal its faults do not actually produce.
                    hi = float(warn)
                draw = float(
                    np.exp(rs.uniform(np.log(lo), np.log(max(hi, lo))))
                )
                # Counter signals are integral in the schema's spirit;
                # keep at least 1 so the evidence is observed.
                signals[name] = max(1.0, round(draw)) if name in (
                    B._COUNTER_SIGNALS
                ) else draw
            out.append(
                FaultSample(
                    incident_id=f"magsample-{label}-{idx:04d}",
                    timestamp=start,
                    cluster="local",
                    namespace="default",
                    service="chat",
                    fault_label=label,
                    expected_domain=map_fault_label(label),
                    signals=signals,
                    confidence=0.9,
                    burn_rate=2.0,
                    window_minutes=5,
                    request_id=f"magsample-req-{idx:04d}",
                    trace_id=f"magsample-trace-{idx:04d}",
                )
            )
    return out


def baseline_samples(count: int = 25) -> list[FaultSample]:
    """No-fault samples (healthy signal vector) for the abstain axis.

    The attributor's correct answer on these is ``unknown`` — any
    specific fault domain is a false alarm.  They carry burn_rate 0
    (no SLO burn in progress), which is exactly the regime the
    incident-conditional ``UNKNOWN_PRIOR_SCALE`` does NOT model; the
    false-alarm measurement is what justifies (or retires) that knob.
    """
    from tpuslo_torch.signals.generator import profile_for_fault

    start = datetime(2026, 3, 1, tzinfo=timezone.utc)
    base = profile_for_fault("baseline")
    return [
        FaultSample(
            incident_id=f"baseline-{idx:04d}",
            timestamp=start,
            cluster="local",
            namespace="default",
            service="chat",
            fault_label="baseline",
            expected_domain=B.DOMAIN_UNKNOWN,
            signals=dict(base),
            confidence=0.9,
            burn_rate=0.0,
            window_minutes=5,
            request_id=f"baseline-req-{idx:04d}",
            trace_id=f"baseline-trace-{idx:04d}",
        )
        for idx in range(count)
    ]


def corrupt(
    samples: list[FaultSample],
    sigma: float,
    seed: int,
    noise: str = "lognormal",
    drop_rate: float = 0.15,
) -> list[FaultSample]:
    """Noisy replicas: multiplicative noise + probe drops (value -> 0).

    ``lognormal`` mirrors the bench sweep; ``gamma`` is the held-out
    family (same mean, heavier left tail) so validation shows the fit
    did not overfit the lognormal shape.
    """
    rs = np.random.RandomState(seed)
    out: list[FaultSample] = []
    for sample in samples:
        s = copy.deepcopy(sample)
        for key, value in list(s.signals.items()):
            if rs.rand() < drop_rate * sigma:
                s.signals[key] = 0.0
            elif noise == "gamma":
                # Mean-1 multiplicative gamma with variance sigma^2.
                shape = 1.0 / max(sigma, 1e-6) ** 2
                s.signals[key] = float(value) * float(
                    rs.gamma(shape, 1.0 / shape)
                )
            else:
                s.signals[key] = float(value) * float(
                    np.exp(rs.normal(0.0, sigma))
                )
        out.append(s)
    return out


def fit_likelihoods(
    sharpness: float = B.DEFAULT_EVIDENCE_SHARPNESS,
    seed: int = 7,
    sigmas: tuple[float, ...] = (0.25, 0.5, 1.0),
    count: int = 40,
    scenarios: tuple[str, ...] = TRAIN_SCENARIOS,
) -> dict[str, dict[str, float]]:
    """Empirical likelihood table from noisy training goldens.

    Each P(signal | domain) cell becomes the mean soft evidence weight
    of that signal over the domain's noisy replicas — i.e. the
    probability (in expectation) that the signal actually testifies
    under the modeled noise.  Domains without a training scenario
    (provider_error, retrieval_backend, unknown) keep their hand-set
    columns.  The sigma family includes 1.0: the heldout
    full-domain gate now runs at sigma=1.0, and a fit that never saw
    deep noise under-modeled the cross-domain bleed there (tpu_ici
    samples losing their dropped retries counter drifted into
    host_offload).  Training sigmas remain disjoint from the heldout
    SEED, which is what the axis holds out.
    """
    table = {s: dict(row) for s, row in B.default_likelihoods().items()}
    acc: dict[str, dict[str, list[float]]] = {}
    for sigma in sigmas:
        pool = _base_samples(scenarios, count) + sampled_magnitude_samples(
            scenarios, count, seed + 17 + int(sigma * 1000)
        )
        train = corrupt(pool, sigma, seed + int(sigma * 1000))
        for sample in train:
            domain = sample.expected_domain or map_fault_label(
                sample.fault_label
            )
            for name, value in sample.signals.items():
                if name not in table:
                    continue
                if value == 0.0 and name not in B._ZERO_AMBIGUOUS_SIGNALS:
                    continue  # dropped probe: unobserved, not healthy
                weight = B.soft_evidence_weight(name, value, sharpness)
                acc.setdefault(domain, {}).setdefault(name, []).append(weight)
    for domain, sigs in acc.items():
        for name, weights in sigs.items():
            table[name][domain] = float(
                np.clip(np.mean(weights), 0.02, 0.98)
            )
    return table


#: Incident-conditional prior scale for the ``unknown`` domain: the
#: attributor runs on incident samples (burn rate >= 2 — an SLO burn IS
#: in progress), so "no attributable cause" is a priori rarer than any
#: specific fault.  Without this, a single dropped pathognomonic probe
#: (e.g. ``xla_compile_ms`` zeroed by shedding) sends the sample to
#: ``unknown`` even when the healthy co-signals rule out every
#: competing domain.
UNKNOWN_PRIOR_SCALE = 0.25


def calibrated_priors() -> dict[str, float]:
    priors = B.default_priors()
    priors[B.DOMAIN_UNKNOWN] *= UNKNOWN_PRIOR_SCALE
    total = sum(priors.values())
    return {d: p / total for d, p in priors.items()}


def calibrated_attributor(
    sharpness: float = B.DEFAULT_EVIDENCE_SHARPNESS,
    seed: int = 7,
) -> B.BayesianAttributor:
    """Soft-evidence attributor over the empirically fitted table."""
    return B.BayesianAttributor(
        priors=calibrated_priors(),
        likelihoods=fit_likelihoods(sharpness=sharpness, seed=seed),
        evidence="soft",
        sharpness=sharpness,
    )


def fit_sharpness(
    grid: tuple[float, ...] = (1.0, 1.5, 2.0, 3.0, 4.0),
    seed: int = 9,
    sigmas: tuple[float, ...] = (0.25, 0.5),
    count: int = 15,
    n_seeds: int = 3,
) -> float:
    """Pick the evidence sharpness by training-noise macro-F1.

    Selection protocol (round 4 — see the earlier selection
    pitfalls): ALL trainable domains (the attributor serves all
    of them, and a TPU-only selection set picked a sharpness that
    generalized worse), the canonical training profiles PLUS the mild
    magnitude-sampled family (mildness robustness is an explicit goal,
    and it is training data), and several noise seeds per sigma (a
    single seed's draw luck dominated the comparison — observed swings
    of 0.13 macro between seeds at the same sharpness).  Seeds are the
    9-lineage — disjoint from both the fit seeds (7-lineage) and the
    held-out eval seed 42.  Ties break toward the smallest (least
    confident) sharpness.  ``bayesian.DEFAULT_EVIDENCE_SHARPNESS``
    records the result.
    """
    best_k, best_score = grid[0], -1.0
    pool = _base_samples(TRAIN_SCENARIOS, count) + sampled_magnitude_samples(
        TRAIN_SCENARIOS, count, seed * 101
    )
    for k in grid:
        attributor = B.BayesianAttributor(
            priors=calibrated_priors(),
            likelihoods=fit_likelihoods(sharpness=k),
            evidence="soft",
            sharpness=k,
        )
        scores = []
        for sigma in sigmas:
            for rep in range(n_seeds):
                noisy = corrupt(
                    pool, sigma, seed + int(sigma * 100) + 7 * rep
                )
                predictions = attributor.attribute_batch(noisy)
                scores.append(macro_f1(noisy, predictions).macro_f1)
        mean = sum(scores) / len(scores)
        if mean > best_score + 1e-9:
            best_k, best_score = k, mean
    return best_k


@dataclass
class HeldoutReport:
    """Macro-F1 of an attributor across the held-out validation axes,
    plus the abstain/false-alarm axis:

    * ``false_alarm`` — fraction of noisy NO-FAULT baselines attributed
      to a specific fault domain (correct answer: unknown).  Reference
      methodology bar: <= 15%.
    * ``abstain`` — fraction of noisy single-fault samples the
      attributor sent to ``unknown`` instead of naming a domain.
    """

    clean: float
    lognormal: dict[str, float] = field(default_factory=dict)
    gamma: dict[str, float] = field(default_factory=dict)
    variant_profiles: dict[str, float] = field(default_factory=dict)
    false_alarm: dict[str, float] = field(default_factory=dict)
    abstain: dict[str, float] = field(default_factory=dict)
    #: Lognormal noise over ALL trainable domains (additive axis,
    #: round 4): the TPU-only axes leave the other domains without support, so
    #: at sigma=1.0 a handful of strays zero whole absent classes and
    #: the macro reads far below the top-1 accuracy (0.55 macro at 94%
    #: micro).  With full-domain support every stray costs precision
    #: in a scored class instead.  The TPU-only axes above keep their
    #: r01-r03 protocol for cross-round comparability.
    full_domain: dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "clean": self.clean,
            "lognormal": self.lognormal,
            "gamma": self.gamma,
            "variant_profiles": self.variant_profiles,
            "false_alarm": self.false_alarm,
            "abstain": self.abstain,
            "full_domain": self.full_domain,
        }


def heldout_report(
    attributor: B.BayesianAttributor | None = None,
    sigmas: tuple[float, ...] = (0.25, 0.5, 1.0),
    count: int = 25,
    seed: int = 42,
) -> HeldoutReport:
    """Evaluate on held-out noise seed, noise family, and profiles.

    ``seed=42`` matches the bench sweep and is disjoint from the
    training seeds (7 + 1000*sigma).
    """
    attributor = attributor or calibrated_attributor()

    def score(samples: list[FaultSample]) -> float:
        """Macro-F1 over the sample set's OWN label classes.

        Subset axes (the 4 TPU scenarios, the variant profiles)
        evaluate a 13-class attributor on a handful of label classes;
        the macro averages over those classes — the sklearn
        ``labels=`` convention for subset evaluation.  A stray
        prediction outside the set still costs its true class a false
        negative, but cannot manufacture a zero-F1 singleton class
        that craters the mean (one stray in 100 samples used to read
        as -0.21 macro).  Cross-class stray behavior is measured where
        every class HAS support: the ``full_domain`` axis and the
        false-alarm/abstain rates.
        """
        from tpuslo_torch.attribution.mapper import expected_domains_for

        predictions = attributor.attribute_batch(samples)
        label_domains = sorted(
            {expected_domains_for(s)[0] for s in samples}
        )
        return round(
            macro_f1(samples, predictions, domains=label_domains).macro_f1,
            4,
        )

    base = _base_samples(TPU_SCENARIOS, count)
    full = _base_samples(TRAIN_SCENARIOS, count)
    variants = variant_samples(count)
    healthy = baseline_samples(count * 4)
    report = HeldoutReport(clean=score(base))
    for sigma in sigmas:
        key = str(sigma)
        noisy_base = corrupt(base, sigma, seed)
        # One attribution pass serves both the lognormal macro and the
        # abstain rate.
        faulted_preds = attributor.attribute_batch(noisy_base)
        from tpuslo_torch.attribution.mapper import expected_domains_for as _exp

        report.lognormal[key] = round(
            macro_f1(
                noisy_base, faulted_preds,
                domains=sorted({_exp(s)[0] for s in noisy_base}),
            ).macro_f1, 4,
        )
        report.gamma[key] = score(
            corrupt(base, sigma, seed + 1, noise="gamma")
        )
        report.variant_profiles[key] = score(
            corrupt(variants, sigma, seed + 2)
        )
        report.full_domain[key] = score(corrupt(full, sigma, seed + 4))
        noisy_healthy = corrupt(healthy, sigma, seed + 3)
        healthy_preds = attributor.attribute_batch(noisy_healthy)
        report.abstain[key] = round(
            sum(
                p.predicted_fault_domain == B.DOMAIN_UNKNOWN
                for p in faulted_preds
            ) / max(len(faulted_preds), 1), 4
        )
        report.false_alarm[key] = round(
            sum(
                p.predicted_fault_domain != B.DOMAIN_UNKNOWN
                for p in healthy_preds
            ) / max(len(healthy_preds), 1), 4
        )
    return report
