"""Deterministic fault-sample stream generator (benchmark input)
(the port's own copy of ``tpuslo/faultreplay/generator.py``).

Reference: ``pkg/faultreplay/generator.go`` — scenario → fault-label
rotation, multi-fault pairs with ``expected_domains``.  This build also
embeds the per-fault signal vector (from the signal generator's fault
profiles) in every sample, so replayed benchmarks exercise the full
Bayesian path rather than the rule fallback; multi-fault samples merge
profiles signal-wise by max.
"""

from __future__ import annotations

from datetime import datetime, timedelta

from tpuslo_torch.attribution.mapper import FaultSample, map_fault_label
from tpuslo_torch.signals.generator import profile_for_fault

_SCENARIO_LABELS: dict[str, tuple[str, ...]] = {
    "provider_throttle": ("provider_throttle",),
    "dns_latency": ("dns_latency",),
    "cpu_throttle": ("cpu_throttle",),
    "memory_pressure": ("memory_pressure",),
    "network_partition": ("network_partition",),
    "ici_drop": ("ici_drop",),
    "dcn_degradation": ("dcn_degradation",),
    "hbm_pressure": ("hbm_pressure",),
    "xla_recompile_storm": ("xla_recompile_storm",),
    "host_offload_stall": ("host_offload_stall",),
    "preemption_eviction": ("preemption_eviction",),
    "noisy_neighbor_cpu": ("noisy_neighbor_cpu",),
    "mixed": (
        "provider_throttle",
        "dns_latency",
        "cpu_throttle",
        "memory_pressure",
        "network_partition",
    ),
    "tpu_mixed": (
        "ici_drop",
        "hbm_pressure",
        "xla_recompile_storm",
        "host_offload_stall",
    ),
}

# Concurrent fault pairs (primary, secondary).
# Reference pairs: ``generator.go:60-67``; TPU pairs model the common
# co-occurrences on a serving pod (HBM exhaustion spilling to host,
# an ICI brownout alongside a network partition, compile storms on a
# CPU-throttled host, offload stalls with memory pressure).
MULTI_FAULT_PAIRS: tuple[tuple[str, str], ...] = (
    ("provider_throttle", "dns_latency"),
    ("cpu_throttle", "memory_pressure"),
    ("network_partition", "dns_latency"),
    ("provider_throttle", "network_partition"),
)

TPU_MULTI_FAULT_PAIRS: tuple[tuple[str, str], ...] = (
    ("hbm_pressure", "host_offload_stall"),
    ("ici_drop", "network_partition"),
    ("xla_recompile_storm", "cpu_throttle"),
    ("host_offload_stall", "memory_pressure"),
)


def supported_scenarios() -> list[str]:
    return [*_SCENARIO_LABELS, "mixed_multi", "tpu_mixed_multi"]


def _merged_signals(*labels: str) -> dict[str, float]:
    """Signal-wise max over the fault profiles of concurrent labels."""
    merged: dict[str, float] = {}
    for label in labels:
        for name, value in profile_for_fault(label).items():
            merged[name] = max(merged.get(name, 0.0), value)
    return merged


def _unique_domains(*labels: str) -> list[str]:
    out: list[str] = []
    for label in labels:
        domain = map_fault_label(label)
        if domain != "unknown" and domain not in out:
            out.append(domain)
    return out or ["unknown"]


def generate_fault_samples(
    scenario: str,
    count: int,
    start: datetime,
    cluster: str = "local",
    namespace: str = "default",
    service: str = "chat",
) -> list[FaultSample]:
    """Deterministic synthetic fault samples for replay."""
    if count < 1:
        raise ValueError("count must be >= 1")

    if scenario == "mixed_multi":
        return _multi(MULTI_FAULT_PAIRS, count, start, cluster, namespace, service)
    if scenario == "tpu_mixed_multi":
        return _multi(
            TPU_MULTI_FAULT_PAIRS, count, start, cluster, namespace, service
        )

    labels = _SCENARIO_LABELS.get(scenario)
    if labels is None:
        raise ValueError(f"unsupported scenario {scenario!r}")

    out = []
    for idx in range(count):
        label = labels[idx % len(labels)]
        out.append(
            FaultSample(
                incident_id=f"replay-inc-{idx + 1:04d}",
                timestamp=start + timedelta(seconds=idx),
                cluster=cluster,
                namespace=namespace,
                service=service,
                fault_label=label,
                expected_domain=map_fault_label(label),
                signals=profile_for_fault(label),
                confidence=0.9,
                burn_rate=2.0,
                window_minutes=5,
                request_id=f"replay-req-{idx + 1:04d}",
                trace_id=f"replay-trace-{idx + 1:04d}",
            )
        )
    return out


def _multi(
    pairs: tuple[tuple[str, str], ...],
    count: int,
    start: datetime,
    cluster: str,
    namespace: str,
    service: str,
) -> list[FaultSample]:
    out = []
    for idx in range(count):
        primary, secondary = pairs[idx % len(pairs)]
        expected = _unique_domains(primary, secondary)
        out.append(
            FaultSample(
                incident_id=f"replay-inc-{idx + 1:04d}",
                timestamp=start + timedelta(seconds=idx),
                cluster=cluster,
                namespace=namespace,
                service=service,
                fault_label=primary,
                expected_domain=expected[0],
                expected_domains=expected,
                signals=_merged_signals(primary, secondary),
                confidence=0.9,
                burn_rate=2.4,
                window_minutes=5,
                request_id=f"replay-req-{idx + 1:04d}",
                trace_id=f"replay-trace-{idx + 1:04d}",
            )
        )
    return out
