"""Naive-Bayes multi-fault attribution over the fault-domain registry
(the port's own copy of ``tpuslo/attribution/bayesian.py``).

Reference: ``pkg/attribution/bayesian.go`` — uniform priors, a
signal→domain likelihood table P(signal_elevated | domain), elevation
thresholds equal to the generator's warning thresholds, log-space
posterior with log-sum-exp normalization, likelihood clamp [0.01, 0.99],
and evidence lists built from elevated signals with P ≥ 0.5.

The TPU-native build extends the model with accelerator fault domains
(``tpu_ici``, ``tpu_dcn``, ``tpu_hbm``, ``xla_compile``,
``host_offload``, ``tpu_preemption``, ``host_noisy_neighbor``) and the
TPU/device-plane signal rows; the table encodes cross-domain bleed (HBM
pressure spills to host offload, recompiles warm the host runqueue, a
starved host leaves the chip idling) so multi-fault coverage metrics
stay meaningful.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from tpuslo_torch.attribution.mapper import FaultSample, build_attribution
from tpuslo_torch.columnar.posterior import (
    PosteriorMatrices,
    log_posterior_batch,
)
from tpuslo_torch.schema import FaultHypothesis, IncidentAttribution

# --- Fault domains ------------------------------------------------------
DOMAIN_NETWORK_DNS = "network_dns"
DOMAIN_NETWORK_EGRESS = "network_egress"
DOMAIN_CPU_THROTTLE = "cpu_throttle"
DOMAIN_MEMORY_PRESSURE = "memory_pressure"
DOMAIN_PROVIDER_THROTTLE = "provider_throttle"
DOMAIN_PROVIDER_ERROR = "provider_error"
DOMAIN_RETRIEVAL_BACKEND = "retrieval_backend"
DOMAIN_TPU_ICI = "tpu_ici"
DOMAIN_TPU_DCN = "tpu_dcn"
DOMAIN_TPU_HBM = "tpu_hbm"
DOMAIN_XLA_COMPILE = "xla_compile"
DOMAIN_HOST_OFFLOAD = "host_offload"
# The chip was preempted/evicted out from under the workload
# (maintenance event, spot reclaim, device re-init): eviction notices
# plus a massive device-plane idle gap.
DOMAIN_TPU_PREEMPTION = "tpu_preemption"
# Another tenant's burst starves this host's vCPUs: steal/runqueue
# explode WITHOUT cgroup throttling (the cpu_throttle separator), and
# the starved dispatch thread leaves the chip idling.
DOMAIN_HOST_NOISY_NEIGHBOR = "host_noisy_neighbor"
DOMAIN_UNKNOWN = "unknown"

ALL_DOMAINS: tuple[str, ...] = (
    DOMAIN_NETWORK_DNS,
    DOMAIN_NETWORK_EGRESS,
    DOMAIN_CPU_THROTTLE,
    DOMAIN_MEMORY_PRESSURE,
    DOMAIN_PROVIDER_THROTTLE,
    DOMAIN_PROVIDER_ERROR,
    DOMAIN_RETRIEVAL_BACKEND,
    DOMAIN_TPU_ICI,
    DOMAIN_TPU_DCN,
    DOMAIN_TPU_HBM,
    DOMAIN_XLA_COMPILE,
    DOMAIN_HOST_OFFLOAD,
    DOMAIN_TPU_PREEMPTION,
    DOMAIN_HOST_NOISY_NEIGHBOR,
    DOMAIN_UNKNOWN,
)

TPU_DOMAINS: tuple[str, ...] = (
    DOMAIN_TPU_ICI,
    DOMAIN_TPU_DCN,
    DOMAIN_TPU_HBM,
    DOMAIN_XLA_COMPILE,
    DOMAIN_HOST_OFFLOAD,
    DOMAIN_TPU_PREEMPTION,
)

# A signal is "elevated" (counts as evidence) at its warning threshold;
# kept in sync with tpuslo_torch.signals.generator.SIGNAL_THRESHOLDS.
SIGNAL_ELEVATION_THRESHOLDS: dict[str, float] = {
    "dns_latency_ms": 40,
    "tcp_retransmits_total": 2,
    "runqueue_delay_ms": 10,
    "connect_latency_ms": 80,
    "tls_handshake_ms": 60,
    "cpu_steal_pct": 2,
    "cfs_throttled_ms": 40,
    "mem_reclaim_latency_ms": 5,
    "disk_io_latency_ms": 10,
    "syscall_latency_ms": 50,
    "connect_errors_total": 1,
    "tls_handshake_fail_total": 1,
    "xla_compile_ms": 500,
    "hbm_alloc_stall_ms": 5,
    "hbm_utilization_pct": 85,
    "ici_link_retries_total": 5,
    "ici_collective_latency_ms": 10,
    "host_offload_stall_ms": 20,
    "dcn_transfer_latency_ms": 25,
    "device_idle_gap_ms": 25,
    "device_eviction_events_total": 1,
    "device_unexplained_share": 0.10,
    # device_mfu_pct is deliberately ABSENT: MFU is low-is-bad and the
    # elevation machinery is high-is-bad monotone; the profiler's
    # roofline verdict carries its interpretation instead.
}

# Error thresholds (same sync contract): together with the warning
# threshold they set each signal's natural log-scale for graded
# ("soft") evidence — how far past warning a value must travel before
# it counts as fully elevated.
SIGNAL_ERROR_THRESHOLDS: dict[str, float] = {
    "dns_latency_ms": 120,
    "tcp_retransmits_total": 5,
    "runqueue_delay_ms": 25,
    "connect_latency_ms": 180,
    "tls_handshake_ms": 160,
    "cpu_steal_pct": 8,
    "cfs_throttled_ms": 120,
    "mem_reclaim_latency_ms": 20,
    "disk_io_latency_ms": 50,
    "syscall_latency_ms": 200,
    "connect_errors_total": 3,
    "tls_handshake_fail_total": 3,
    "xla_compile_ms": 2000,
    "hbm_alloc_stall_ms": 20,
    "hbm_utilization_pct": 95,
    "ici_link_retries_total": 20,
    "ici_collective_latency_ms": 30,
    "host_offload_stall_ms": 80,
    "dcn_transfer_latency_ms": 80,
    "device_idle_gap_ms": 100,
    "device_eviction_events_total": 3,
    "device_unexplained_share": 0.25,
}

# Counter-valued signals: an exact 0.0 is a legitimate healthy reading.
# For continuous latency/percentage probes an exact 0.0 means "probe
# produced no sample" (shed probe, ring-buffer loss) and soft-evidence
# mode treats it as UNOBSERVED rather than healthy — counting missing
# probes as health systematically biases away from the faulted domain.
_COUNTER_SIGNALS = frozenset(
    {
        "tcp_retransmits_total",
        "connect_errors_total",
        "tls_handshake_fail_total",
        "ici_link_retries_total",
        "device_eviction_events_total",
    }
)

# Event-driven signals where 0.0 is ALSO a legitimate reading ("no such
# event this window"), not only a dropped probe: a window with zero
# compiles is real evidence against a recompile storm.  Treating a zero
# here as unobserved let the xla_compile domain dodge its pathognomonic
# healthy factor entirely and win NO-FAULT vectors by default (measured
# false-alarm rate on noisy healthy baselines: 100%).  Zeros on these
# get the same drop-mixture treatment as zero counters.
_ZERO_AMBIGUOUS_SIGNALS = _COUNTER_SIGNALS | {"xla_compile_ms"}

# Drop-mixture prior for a zero xla_compile_ms reading.  Unlike the
# counters (whose faulted profiles emit tens of events per window, so a
# zero under a fault is almost surely a drop), a compile storm's zero
# is STILL most plausibly a dropped probe — but a healthy serving
# window legitimately compiles nothing, so the healthy mass must stay
# substantial or no-fault windows get attributed to xla_compile by
# default (measured 100% false-alarm before this model).
COMPILE_ZERO_DROP_PRIOR = 0.5

# Soft-mode abstention floor: name a fault domain only when some
# observed signal's evidence weight reaches this value; otherwise
# predict ``unknown``.  0.5 is the warning threshold itself (abstain
# only with NO elevated evidence); higher values trade false alarms on
# noisy no-fault windows against abstentions on weakly-evidenced
# faults.  Selected on training noise (calibrate protocol, seed 9
# lineage) against the reference methodology's bars (false alarm <= 15%
# on noisy baselines, abstain <= 15% single-fault).
ABSTAIN_MIN_TOP_WEIGHT = 0.5

# An SLO burn rate at or past this marks the sample as an INCIDENT —
# the regime the attributor is built for (and the justification for
# UNKNOWN_PRIOR_SCALE in calibrate: during a burn, "no attributable
# cause" is a priori rare).  Samples WITHOUT a burn carry no
# corroboration that anything is wrong, and every modeled fault
# elevates at least two signals — so on no-burn samples a domain is
# named only with >= 2 elevated signals; a single noisy spike abstains.
# This is what holds the false-alarm rate on noisy no-fault windows
# under the methodology's 15% bar without desensitizing incidents.
INCIDENT_BURN_RATE = 2.0
NO_BURN_MIN_ELEVATED = 2

# Probability that a zero-valued counter reading is a dropped probe
# rather than a true zero, used by soft-evidence mode to temper the
# healthy factor of zero counters (drop mixture).  Matches the shedding
# drop-rate baseline the calibration corruption protocol models
# (calibrate.corrupt drop_rate=0.15).
COUNTER_ZERO_DROP_PRIOR = 0.15

# Default evidence sharpness, fitted by
# ``tpuslo_torch.attribution.calibrate.fit_sharpness`` on lognormal-noise
# training goldens — all trainable domains, canonical + mild magnitude
# families, multiple seeds (see that function's docstring for the
# protocol and tests/test_calibration.py for the reproduction check).
# The current protocol (twelve trainable domains incl. the two
# device-plane faults, sigma family extended to 1.0) selects 1.5 —
# slightly crisper than the round-4 pick of 1.0: with deep noise in
# the fit, borderline weights are calibrated DOWN by the table itself,
# so the sigmoid no longer needs to do that damping (measured: 1.5
# dominates 1.0 on every heldout axis, full-domain sigma=1.0
# 0.976 vs 0.964).
DEFAULT_EVIDENCE_SHARPNESS = 1.5


def soft_evidence_weight(
    signal: str, value: float, sharpness: float = DEFAULT_EVIDENCE_SHARPNESS
) -> float:
    """Graded elevation in [0, 1]: 0.5 at the warning threshold,
    ``sigmoid(sharpness)`` at the error threshold, log-scaled.

    Hard thresholding throws away magnitude, so measurement noise near
    a threshold flips evidence bits outright (the r02 robustness sweep
    collapsed to macro-F1 0.62 at sigma=0.5 for exactly this reason).
    The log-ratio sigmoid keeps a barely-over-warning value weak and a
    deep-in-error value decisive, which is also how multiplicative
    (lognormal) measurement noise actually perturbs values.
    """
    warn = SIGNAL_ELEVATION_THRESHOLDS.get(signal)
    if warn is None or warn <= 0:
        return 0.0
    if value <= 0:
        return 0.0
    err = SIGNAL_ERROR_THRESHOLDS.get(signal, warn * 3.0)
    scale = max(math.log(err / warn), 1e-6)
    z = sharpness * math.log(value / warn) / scale
    # Clamp the exponent: far-out values saturate without overflow.
    z = max(min(z, 60.0), -60.0)
    return 1.0 / (1.0 + math.exp(-z))


def _row(
    dns=0.10, egress=0.10, cpu=0.10, mem=0.10, pthr=0.10, perr=0.10,
    retr=0.10, ici=0.05, dcn=0.05, hbm=0.05, xla=0.05, offload=0.05,
    preempt=0.05, noisy=0.05, unknown=0.10,
) -> dict[str, float]:
    return {
        DOMAIN_NETWORK_DNS: dns,
        DOMAIN_NETWORK_EGRESS: egress,
        DOMAIN_CPU_THROTTLE: cpu,
        DOMAIN_MEMORY_PRESSURE: mem,
        DOMAIN_PROVIDER_THROTTLE: pthr,
        DOMAIN_PROVIDER_ERROR: perr,
        DOMAIN_RETRIEVAL_BACKEND: retr,
        DOMAIN_TPU_ICI: ici,
        DOMAIN_TPU_DCN: dcn,
        DOMAIN_TPU_HBM: hbm,
        DOMAIN_XLA_COMPILE: xla,
        DOMAIN_HOST_OFFLOAD: offload,
        DOMAIN_TPU_PREEMPTION: preempt,
        DOMAIN_HOST_NOISY_NEIGHBOR: noisy,
        DOMAIN_UNKNOWN: unknown,
    }


def default_priors() -> dict[str, float]:
    """Uniform priors over all registered domains."""
    p = 1.0 / len(ALL_DOMAINS)
    return {d: p for d in ALL_DOMAINS}


def default_likelihoods() -> dict[str, dict[str, float]]:
    """P(signal elevated | domain) for every thresholded signal × 15
    domains (``device_mfu_pct`` stays out: informational, no elevation
    semantics).

    CPU-signal columns over the original eight domains follow the
    reference table (``bayesian.go:67-190``); TPU columns/rows are
    designed from the fault physiology in
    ``tpuslo_torch.signals.generator._FAULT_OVERRIDES``.
    """
    return {
        "dns_latency_ms": _row(dns=0.95, egress=0.70, retr=0.15),
        "tcp_retransmits_total": _row(dns=0.15, egress=0.90, perr=0.15, dcn=0.60),
        "runqueue_delay_ms": _row(
            cpu=0.90, mem=0.60, xla=0.45, hbm=0.10, offload=0.10,
            noisy=0.90,
        ),
        "connect_latency_ms": _row(
            dns=0.50, egress=0.85, pthr=0.75, perr=0.40, retr=0.30
        ),
        "tls_handshake_ms": _row(egress=0.30, pthr=0.80, perr=0.50, retr=0.20),
        # Steal is the noisy-neighbor signature; a throttled cgroup
        # also reads steal because the quota enforcement preempts it.
        "cpu_steal_pct": _row(cpu=0.90, mem=0.20, noisy=0.95),
        "cfs_throttled_ms": _row(cpu=0.85, mem=0.75, xla=0.15),
        "mem_reclaim_latency_ms": _row(
            dns=0.05, egress=0.05, cpu=0.15, mem=0.95, pthr=0.05, perr=0.05,
            retr=0.05, unknown=0.05,
        ),
        "disk_io_latency_ms": _row(
            dns=0.05, egress=0.05, mem=0.85, pthr=0.05, perr=0.05,
            retr=0.30, offload=0.55, unknown=0.05,
        ),
        "syscall_latency_ms": _row(
            egress=0.20, cpu=0.15, pthr=0.90, perr=0.60, retr=0.40,
            offload=0.50, noisy=0.45,
        ),
        "connect_errors_total": _row(
            egress=0.80, cpu=0.05, mem=0.05, pthr=0.60, perr=0.85, retr=0.15
        ),
        "tls_handshake_fail_total": _row(
            dns=0.05, egress=0.70, cpu=0.05, mem=0.05, pthr=0.30, perr=0.60,
            unknown=0.05,
        ),
        # --- TPU signal rows ------------------------------------------
        # Compile latency is near-exclusive to recompile storms; HBM
        # churn can force re-layout compiles occasionally.
        "xla_compile_ms": _row(
            dns=0.05, egress=0.05, cpu=0.10, mem=0.05, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.05, hbm=0.15, xla=0.95, offload=0.05,
            preempt=0.30, unknown=0.05,
        ),
        # Allocation stalls: HBM exhaustion; spilling to host shows a
        # weaker echo, as can compile-time buffer churn.
        "hbm_alloc_stall_ms": _row(
            dns=0.05, egress=0.05, cpu=0.05, mem=0.10, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.05, hbm=0.95, xla=0.20, offload=0.30,
            unknown=0.05,
        ),
        "hbm_utilization_pct": _row(
            dns=0.05, egress=0.05, cpu=0.05, mem=0.10, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.10, hbm=0.90, xla=0.15, offload=0.40,
            unknown=0.10,
        ),
        "ici_link_retries_total": _row(
            dns=0.05, egress=0.05, cpu=0.05, mem=0.05, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.95, hbm=0.05, xla=0.05, offload=0.05,
            unknown=0.05,
        ),
        # Slow collectives: degraded ICI first; HBM pressure and host
        # launch delay stretch collectives secondarily.
        "ici_collective_latency_ms": _row(
            dns=0.05, egress=0.05, cpu=0.15, mem=0.05, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.90, dcn=0.55, hbm=0.20, xla=0.10, offload=0.10,
            unknown=0.05,
        ),
        # Host<->device stalls: offload path first; HBM pressure induces
        # spilling which surfaces here too.
        "host_offload_stall_ms": _row(
            dns=0.05, egress=0.05, cpu=0.10, mem=0.20, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.15, hbm=0.55, xla=0.05, offload=0.95,
            unknown=0.05,
        ),
        # Cross-slice transfer stalls are pathognomonic for DCN
        # degradation; a badly degraded ICI link can echo here weakly
        # when its slice straggles the cross-slice phase.
        "dcn_transfer_latency_ms": _row(
            dns=0.05, egress=0.10, cpu=0.05, mem=0.05, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.10, dcn=0.95, hbm=0.05, xla=0.05, offload=0.05,
            unknown=0.05,
        ),
        # Device idle gaps (device-plane ledger): a preempted chip sits
        # idle while the host re-acquires it; a starved dispatch thread
        # (noisy neighbor) or a throttled host also leaves launch-queue
        # holes; long compiles pause the launch stream too.
        "device_idle_gap_ms": _row(
            dns=0.05, egress=0.05, cpu=0.20, mem=0.05, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.05, dcn=0.05, hbm=0.05, xla=0.20, offload=0.10,
            preempt=0.95, noisy=0.65, unknown=0.05,
        ),
        # Eviction notices are pathognomonic: nothing else posts them.
        "device_eviction_events_total": _row(
            dns=0.03, egress=0.03, cpu=0.03, mem=0.03, pthr=0.03, perr=0.03,
            retr=0.03, ici=0.03, dcn=0.03, hbm=0.03, xla=0.03, offload=0.03,
            preempt=0.95, noisy=0.03, unknown=0.03,
        ),
        # Ledger unexplained share (continuous-profiler windows): a
        # capture cut mid-eviction leaves un-joinable launch fragments,
        # and a recompile storm floods the window with anonymous
        # first-execution launches; kept deliberately conservative —
        # it mostly indicts the OBSERVER (join ladder), so it should
        # tilt, never drive, an attribution.
        "device_unexplained_share": _row(
            dns=0.05, egress=0.05, cpu=0.05, mem=0.05, pthr=0.05, perr=0.05,
            retr=0.05, ici=0.05, dcn=0.05, hbm=0.05, xla=0.25, offload=0.05,
            preempt=0.35, noisy=0.10, unknown=0.30,
        ),
    }


@dataclass
class Posterior:
    """One domain's posterior probability with its supporting evidence."""

    domain: str
    posterior: float
    evidence: list[str] = field(default_factory=list)


@dataclass
class _Matrices:
    """Dense numpy views of the likelihood table for the batch path."""

    signals: list[str]
    signal_index: dict[str, int]
    log_lik: np.ndarray  # [S, D] log clamp(P(elev|domain))
    log_not_lik: np.ndarray  # [S, D] log clamp(1 - P)
    log_priors: np.ndarray  # [D]
    thresholds: np.ndarray  # [S] (+inf where no elevation threshold)
    supports: np.ndarray  # [S, D] raw P >= 0.5 (evidence membership)
    kernel: "PosteriorMatrices"  # columnar-kernel view of the same tables


def _clamp(p: float) -> float:
    return min(0.99, max(0.01, p))


def _sort_hypotheses(hypotheses) -> list[FaultHypothesis]:
    """Deterministic hypothesis order: posterior desc, domain order.

    Posteriors are rounded to 1e-9 for the comparison so the scalar and
    vectorized paths (whose float summation orders differ in the last
    ulps) rank exact ties identically.
    """
    return sorted(
        hypotheses,
        key=lambda h: (-round(h.posterior, 9), ALL_DOMAINS.index(h.domain)),
    )


def _softmax_rows(log_p: np.ndarray) -> np.ndarray:
    """Row-wise softmax with the same log-sum-exp shift as the scalar path."""
    shifted = log_p - log_p.max(axis=1, keepdims=True)
    e = np.exp(shifted)
    return e / e.sum(axis=1, keepdims=True)


class BayesianAttributor:
    """Log-space naive Bayes over fault domains.

    Reference: ``pkg/attribution/bayesian.go:218-343``.
    """

    def __init__(
        self,
        priors: dict[str, float] | None = None,
        likelihoods: dict[str, dict[str, float]] | None = None,
        evidence: str = "hard",
        sharpness: float = DEFAULT_EVIDENCE_SHARPNESS,
    ):
        if evidence not in ("hard", "soft"):
            raise ValueError(f"evidence must be 'hard' or 'soft', got {evidence!r}")
        self.priors = priors or default_priors()
        self.likelihoods = likelihoods or default_likelihoods()
        #: "hard" = reference-parity binary elevation; "soft" = graded
        #: log-ratio evidence (noise-robust; see soft_evidence_weight).
        self.evidence = evidence
        self.sharpness = sharpness

    def _observed_and_weights(
        self, signals: dict[str, float], observed: set[str] | None = None
    ) -> tuple[set[str], dict[str, float]]:
        """Observed-signal set and per-signal evidence weight in [0, 1].

        Hard mode: weight = 1 iff elevated (binary, reference parity).
        Soft mode: graded weights; exact-0.0 continuous signals are
        dropped from ``observed`` (missing probe, not health).
        """
        if observed is None:
            observed = set(signals)
        if self.evidence == "soft":
            observed = {
                s
                for s in observed
                if s in _ZERO_AMBIGUOUS_SIGNALS
                or s not in SIGNAL_ELEVATION_THRESHOLDS
                or signals.get(s, 0.0) != 0.0
            }
            weights = {
                s: soft_evidence_weight(s, signals.get(s, 0.0), self.sharpness)
                for s in observed
            }
        else:
            elevated = self.elevated_signals(signals)
            weights = {s: 1.0 if s in elevated else 0.0 for s in observed}
        return observed, weights

    def _matrices(self) -> "_Matrices":
        """Dense [signal × domain] views of the table.

        Rebuilt on every batch — the build is microseconds against the
        batch itself, and callers may mutate the public
        ``priors``/``likelihoods`` dicts between calls (the scalar path
        reads them live, so the batch path must too).
        """
        signals = list(self.likelihoods)
        # Likelihood factors default a missing domain to 0.5 (scalar
        # `_likelihood`), but evidence/residual membership defaults it
        # to 0.0 (scalar `.get(domain, 0.0) >= 0.5`) — two different
        # matrices, or incomplete custom tables diverge between paths.
        shape = (len(signals), len(ALL_DOMAINS))
        raw = np.array(
            [
                [self.likelihoods[s].get(d, 0.5) for d in ALL_DOMAINS]
                for s in signals
            ]
        ).reshape(shape)
        raw_support = np.array(
            [
                [self.likelihoods[s].get(d, 0.0) for d in ALL_DOMAINS]
                for s in signals
            ]
        ).reshape(shape)
        log_lik = np.log(np.clip(raw, 0.01, 0.99))
        log_not_lik = np.log(np.clip(1.0 - raw, 0.01, 0.99))
        log_priors = np.log(
            np.maximum(
                [self.priors.get(d, 0.0) for d in ALL_DOMAINS], 1e-10
            )
        )
        thresholds = np.array(
            [SIGNAL_ELEVATION_THRESHOLDS.get(s, math.inf) for s in signals]
        )
        warns = np.where(np.isfinite(thresholds), thresholds, np.nan)
        errs = np.array(
            [
                SIGNAL_ERROR_THRESHOLDS.get(
                    s, (SIGNAL_ELEVATION_THRESHOLDS.get(s) or np.nan) * 3.0
                )
                for s in signals
            ]
        )
        continuous = np.array(
            [
                s not in _ZERO_AMBIGUOUS_SIGNALS
                and s in SIGNAL_ELEVATION_THRESHOLDS
                for s in signals
            ]
        )
        ambiguous = np.array(
            [s in _ZERO_AMBIGUOUS_SIGNALS for s in signals]
        )
        p_drop = np.array(
            [
                COUNTER_ZERO_DROP_PRIOR
                if s in _COUNTER_SIGNALS
                else COMPILE_ZERO_DROP_PRIOR
                for s in signals
            ]
        )[:, None]
        return _Matrices(
            signals=signals,
            signal_index={s: i for i, s in enumerate(signals)},
            log_lik=log_lik,
            log_not_lik=log_not_lik,
            log_priors=log_priors,
            thresholds=thresholds,
            supports=raw_support >= 0.5,
            kernel=PosteriorMatrices(
                log_priors=log_priors,
                log_lik=log_lik,
                log_not_lik=log_not_lik,
                thresholds=thresholds,
                warns=warns,
                errs=errs,
                continuous=continuous,
                ambiguous=ambiguous,
                p_drop=p_drop,
            ),
        )

    def elevated_signals(self, signals: dict[str, float]) -> set[str]:
        return {
            name
            for name, value in signals.items()
            if name in SIGNAL_ELEVATION_THRESHOLDS
            and value >= SIGNAL_ELEVATION_THRESHOLDS[name]
        }

    def _likelihood(self, signal: str, domain: str, elevated: bool) -> float:
        row = self.likelihoods.get(signal)
        if row is None:
            return 0.5
        p = row.get(domain, 0.5)
        return _clamp(p if elevated else 1.0 - p)

    def attribute(
        self,
        signals: dict[str, float],
        observed: set[str] | None = None,
    ) -> list[Posterior]:
        """Posteriors over all domains, sorted descending.

        ``observed`` restricts which likelihood rows enter the product;
        signals outside it are treated as unobserved (factor skipped)
        rather than not-elevated.  By default only signals present in
        the input vector are observed — a deliberate departure from the
        reference (which folds *absent* signals in as evidence of
        health): in ``bcc_degraded`` or shed-probe operation most
        signals are not collected at all, and counting them as healthy
        systematically biases toward domains with small probe
        footprints.  For full 19-signal vectors the two semantics
        coincide.
        """
        # One pass over the full vector; an ``observed`` restriction
        # (the residual pass) narrows which factors enter the product,
        # not what counts as an elevated supporting signal — evidence
        # membership (weight >= 0.5) always reads the full weights.
        full_observed, full_weights = self._observed_and_weights(signals)
        if observed is None:
            observed, weights = full_observed, full_weights
        else:
            observed = {s for s in observed if s in full_observed}
            weights = {s: full_weights[s] for s in observed}
        elevated = {s for s, w in full_weights.items() if w >= 0.5}

        log_posteriors: dict[str, float] = {}
        for domain in ALL_DOMAINS:
            log_p = math.log(max(self.priors.get(domain, 0.0), 1e-10))
            for signal in self.likelihoods:
                if signal not in observed:
                    continue
                w = weights.get(signal, 0.0)
                p = _clamp(self.likelihoods[signal].get(domain, 0.5))
                if (
                    self.evidence == "soft"
                    and signal in _ZERO_AMBIGUOUS_SIGNALS
                    and signals.get(signal, 0.0) == 0.0
                ):
                    # Ambiguous zero: drop mixture, not full healthy
                    # credit (see COUNTER_ZERO_DROP_PRIOR).
                    p_drop = (
                        COUNTER_ZERO_DROP_PRIOR
                        if signal in _COUNTER_SIGNALS
                        else COMPILE_ZERO_DROP_PRIOR
                    )
                    log_p += math.log(
                        p_drop + (1.0 - p_drop) * _clamp(1.0 - p)
                    )
                    continue
                log_p += w * math.log(p) + (1.0 - w) * math.log(
                    _clamp(1.0 - p)
                )
            log_posteriors[domain] = log_p

        max_log = max(log_posteriors.values())
        log_z = max_log + math.log(
            sum(math.exp(lp - max_log) for lp in log_posteriors.values())
        )

        out = []
        for domain in ALL_DOMAINS:
            evidence = sorted(
                s
                for s in elevated
                if self.likelihoods.get(s, {}).get(domain, 0.0) >= 0.5
            )
            out.append(
                Posterior(
                    domain=domain,
                    posterior=math.exp(log_posteriors[domain] - log_z),
                    evidence=evidence,
                )
            )
        out.sort(key=lambda p: p.posterior, reverse=True)
        return out

    def attribute_sample(self, sample: FaultSample) -> IncidentAttribution:
        """Full attribution envelope for one fault sample.

        Without a signal vector this degrades to the rule-based mapping,
        mirroring reference ``bayesian.go:315-343``.
        """
        base = build_attribution(sample)
        if not sample.signals:
            return base

        posteriors = self.attribute(sample.signals)
        hypotheses = {
            p.domain: FaultHypothesis(p.domain, p.posterior, p.evidence)
            for p in posteriors
            if p.posterior >= 0.01
        }

        secondary = self._residual_posterior(sample.signals, posteriors[0])
        if secondary is not None and (
            secondary.domain not in hypotheses
            or hypotheses[secondary.domain].posterior < secondary.posterior
        ):
            hypotheses[secondary.domain] = FaultHypothesis(
                secondary.domain, secondary.posterior, secondary.evidence
            )

        base.fault_hypotheses = _sort_hypotheses(hypotheses.values())
        base.predicted_fault_domain = posteriors[0].domain
        base.confidence = posteriors[0].posterior
        if self.evidence == "soft":
            _observed, w = self._observed_and_weights(sample.signals)
            top_weight = max(w.values(), default=0.0)
            n_elevated = sum(v >= 0.5 for v in w.values())
            min_elevated = (
                1 if sample.burn_rate >= INCIDENT_BURN_RATE
                else NO_BURN_MIN_ELEVATED
            )
            if (
                top_weight < ABSTAIN_MIN_TOP_WEIGHT
                or n_elevated < min_elevated
            ):
                # Abstain (same rule as the batch path): no elevated
                # evidence means no testimony for any fault.
                base.predicted_fault_domain = DOMAIN_UNKNOWN
                base.confidence = next(
                    p.posterior
                    for p in posteriors
                    if p.domain == DOMAIN_UNKNOWN
                )
        return base

    def attribute_batch(
        self,
        samples: list[FaultSample],
        use_torch: bool | None = None,
        device: str = "cuda",
    ) -> list[IncidentAttribution]:
        """Vectorized :meth:`attribute_sample` over a batch.

        Semantics are identical (parity-tested); the per-sample
        19-signal × 13-domain log-likelihood accumulation and the
        residual explaining-away pass each become one masked matmul
        over the whole batch, so throughput scales with numpy rather
        than Python dict lookups.  The core contraction lives in
        ``tpuslo_torch.columnar.posterior`` and can run as the torch f64
        lane on ``device`` (``use_torch``: None = engagement policy,
        True/False = force; a forced lane without a card raises unless
        ``device="cpu"``).
        """
        mat = self._matrices()
        n_dom = len(ALL_DOMAINS)
        out: list[IncidentAttribution | None] = [None] * len(samples)

        rows = []  # (sample_pos, observed, values) for the bayes path
        for pos, sample in enumerate(samples):
            if not sample.signals:
                out[pos] = build_attribution(sample)
                continue
            rows.append(pos)
        if not rows:
            return [a for a in out if a is not None]

        n = len(rows)
        n_sig = len(mat.signals)
        observed = np.zeros((n, n_sig), dtype=bool)
        values = np.zeros((n, n_sig))
        # Elevated signals missing from the likelihood table contribute
        # no factors but DO trigger the scalar residual pass (they are
        # unexplained by any domain); track them separately.
        extra_trigger = np.zeros(n, dtype=bool)
        for i, pos in enumerate(rows):
            for name, value in samples[pos].signals.items():
                idx = mat.signal_index.get(name)
                if idx is not None:
                    observed[i, idx] = True
                    values[i, idx] = value
                elif (
                    name in SIGNAL_ELEVATION_THRESHOLDS
                    and value >= SIGNAL_ELEVATION_THRESHOLDS[name]
                ):
                    extra_trigger[i] = True

        # Shared columnar kernel (tpuslo_torch.columnar.posterior): graded
        # weights, the (batch, signals) @ (signals, domains) log-
        # likelihood contraction, ambiguous-zero drop mixture, and the
        # softmax — numpy here by default (bit-stable with the scalar
        # path), the torch lane for fleet-scale batches per the engagement
        # policy.  Soft mode drops exact-0.0 continuous probes from
        # ``observed`` (missing probe, not health), which is why the
        # mask comes back out.
        posteriors, weights, observed = log_posterior_batch(
            values,
            observed,
            mat.kernel,
            soft=self.evidence == "soft",
            sharpness=self.sharpness,
            use_torch=use_torch,
            device=device,
        )
        elevated = observed & (weights >= 0.5)

        # Residual explaining-away pass, one matmul for the batch,
        # restricted to the residual signals with their weights (in
        # hard mode the weights are 1, reducing to priors + R @ logL).
        top_idx = posteriors.argmax(axis=1)
        residual = elevated & ~mat.supports[:, top_idx].T
        has_residual = residual.any(axis=1) | extra_trigger
        res_posteriors = np.zeros((n, n_dom))
        if has_residual.any():
            resf = residual.astype(float)
            w_res = weights * resf
            res_log = (
                mat.log_priors
                + w_res @ mat.log_lik
                + (resf - w_res) @ mat.log_not_lik
            )
            res_posteriors[has_residual] = _softmax_rows(
                res_log[has_residual]
            )

        unknown_idx = ALL_DOMAINS.index(DOMAIN_UNKNOWN)
        for i, pos in enumerate(rows):
            sample = samples[pos]
            elev_names = [
                mat.signals[s] for s in np.flatnonzero(elevated[i])
            ]

            def evidence_for(d: int) -> list[str]:
                return sorted(
                    name
                    for name in elev_names
                    if mat.supports[mat.signal_index[name], d]
                )

            order = sorted(
                range(n_dom), key=lambda d: posteriors[i, d], reverse=True
            )
            top = order[0]
            hypotheses = {
                ALL_DOMAINS[d]: FaultHypothesis(
                    ALL_DOMAINS[d], float(posteriors[i, d]), evidence_for(d)
                )
                for d in order
                if posteriors[i, d] >= 0.01
            }

            if has_residual[i]:
                win = int(res_posteriors[i].argmax())
                win_evidence = evidence_for(win)
                if win not in (top, unknown_idx) and win_evidence:
                    weight = max(1.0 - float(posteriors[i, top]), 0.1)
                    sec_post = float(res_posteriors[i, win]) * weight
                    name = ALL_DOMAINS[win]
                    if (
                        name not in hypotheses
                        or hypotheses[name].posterior < sec_post
                    ):
                        hypotheses[name] = FaultHypothesis(
                            name, sec_post, win_evidence
                        )

            base = build_attribution(sample)
            base.fault_hypotheses = _sort_hypotheses(hypotheses.values())
            base.predicted_fault_domain = ALL_DOMAINS[top]
            base.confidence = float(posteriors[i, top])
            top_weight = float((weights[i] * observed[i]).max(initial=0.0))
            n_elevated = int(elevated[i].sum())
            min_elevated = (
                1 if sample.burn_rate >= INCIDENT_BURN_RATE
                else NO_BURN_MIN_ELEVATED
            )
            if self.evidence == "soft" and (
                top_weight < ABSTAIN_MIN_TOP_WEIGHT
                or n_elevated < min_elevated
            ):
                # Abstain: without sufficiently elevated evidence there
                # is no real testimony FOR any fault — a domain winning
                # purely on prior geometry and healthy-factor
                # asymmetries is a false alarm (measured 100% on noisy
                # no-fault baselines before this rule).
                base.predicted_fault_domain = DOMAIN_UNKNOWN
                base.confidence = float(posteriors[i, unknown_idx])
            out[pos] = base
        return [a for a in out if a is not None]

    def _residual_posterior(
        self, signals: dict[str, float], top: Posterior
    ) -> Posterior | None:
        """Greedy explaining-away pass for concurrent faults.

        Naive Bayes is a single-cause model: with two simultaneous
        faults the posterior collapses onto whichever domain explains
        more elevated signals, and the second fault vanishes from the
        hypothesis list.  This pass re-attributes the elevated signals
        the winning domain does *not* explain (likelihood < 0.5),
        treating explained signals as unobserved, and surfaces the
        winner as a secondary hypothesis damped by the remaining
        probability mass (floored so a decisive top-1 can't erase a
        clearly-present second fault).
        """
        _observed, weights = self._observed_and_weights(signals)
        elevated = {s for s, w in weights.items() if w >= 0.5}
        residual = {
            s
            for s in elevated
            if self.likelihoods.get(s, {}).get(top.domain, 0.0) < 0.5
        }
        if not residual:
            return None

        ranked = self.attribute(signals, observed=residual)
        winner = ranked[0]
        if winner.domain in (top.domain, DOMAIN_UNKNOWN) or not winner.evidence:
            return None
        weight = max(1.0 - top.posterior, 0.1)
        return Posterior(
            domain=winner.domain,
            posterior=winner.posterior * weight,
            evidence=winner.evidence,
        )
