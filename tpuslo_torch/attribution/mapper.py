"""Rule-based fault-label → domain mapping and attribution envelopes
(the port's own copy of ``tpuslo/attribution/mapper.py``).

Reference: ``pkg/attribution/mapper.go`` — the deterministic fallback
path used when no signal vector is available, and the envelope builder
shared by the Bayesian path.  TPU fault labels map onto the four new
accelerator domains.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any

from tpuslo_torch.schema import (
    Evidence,
    IncidentAttribution,
    SLOImpact,
    parse_rfc3339,
    rfc3339,
)

_LABEL_TO_DOMAIN: dict[str, str] = {
    "dns_latency": "network_dns",
    "egress_drop": "network_egress",
    "cpu_throttle": "cpu_throttle",
    "memory_pressure": "memory_pressure",
    "network_partition": "network_egress",
    "provider_throttle": "provider_throttle",
    "provider_error": "provider_error",
    "retrieval_slowdown": "retrieval_backend",
    # TPU fault labels.
    "ici_drop": "tpu_ici",
    "dcn_degradation": "tpu_dcn",
    "hbm_pressure": "tpu_hbm",
    "xla_recompile_storm": "xla_compile",
    "host_offload_stall": "host_offload",
    "preemption_eviction": "tpu_preemption",
    "noisy_neighbor_cpu": "host_noisy_neighbor",
}

# Evidence source per TPU signal family for envelope annotations.
_TPU_EVIDENCE: dict[str, tuple[str, str, float]] = {
    "ici_drop": ("ici_link_retries_total", "accel_driver", 45.0),
    "dcn_degradation": ("dcn_transfer_latency_ms", "megascale", 140.0),
    "hbm_pressure": ("hbm_alloc_stall_ms", "libtpu", 60.0),
    "xla_recompile_storm": ("xla_compile_ms", "libtpu", 3200.0),
    "host_offload_stall": ("host_offload_stall_ms", "libtpu", 120.0),
    "preemption_eviction": (
        "device_eviction_events_total", "accel_driver", 4.0,
    ),
    "noisy_neighbor_cpu": ("cpu_steal_pct", "ebpf", 18.0),
}


@dataclass
class FaultSample:
    """Normalized benchmark input for attribution.

    Reference: ``pkg/attribution/mapper.go:11-27``.
    """

    incident_id: str
    timestamp: datetime
    cluster: str
    namespace: str
    service: str
    fault_label: str
    confidence: float
    burn_rate: float
    window_minutes: int
    request_id: str
    trace_id: str
    expected_domain: str = ""
    expected_domains: list[str] = field(default_factory=list)
    signals: dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "incident_id": self.incident_id,
            "timestamp": rfc3339(self.timestamp),
            "cluster": self.cluster,
            "namespace": self.namespace,
            "service": self.service,
            "fault_label": self.fault_label,
            "confidence": self.confidence,
            "burn_rate": self.burn_rate,
            "window_minutes": self.window_minutes,
            "request_id": self.request_id,
            "trace_id": self.trace_id,
        }
        if self.expected_domain:
            out["expected_domain"] = self.expected_domain
        if self.expected_domains:
            out["expected_domains"] = list(self.expected_domains)
        if self.signals:
            out["signals"] = dict(self.signals)
        return out

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "FaultSample":
        ts = raw.get("timestamp")
        return cls(
            incident_id=raw.get("incident_id", ""),
            timestamp=parse_rfc3339(ts) if isinstance(ts, str) else ts,
            cluster=raw.get("cluster", ""),
            namespace=raw.get("namespace", ""),
            service=raw.get("service", ""),
            fault_label=raw.get("fault_label", ""),
            expected_domain=raw.get("expected_domain", ""),
            expected_domains=list(raw.get("expected_domains", []) or []),
            signals={k: float(v) for k, v in (raw.get("signals") or {}).items()},
            confidence=float(raw.get("confidence", 0.0)),
            burn_rate=float(raw.get("burn_rate", 0.0)),
            window_minutes=int(raw.get("window_minutes", 0)),
            request_id=raw.get("request_id", ""),
            trace_id=raw.get("trace_id", ""),
        )


def map_fault_label(label: str) -> str:
    """Map a scenario fault label into a schema-constrained domain."""
    return _LABEL_TO_DOMAIN.get(label, "unknown")


def expected_domains_for(sample: FaultSample) -> list[str]:
    """Ground-truth domain set for a sample, in priority order."""
    if sample.expected_domains:
        return list(sample.expected_domains)
    if sample.expected_domain:
        return [sample.expected_domain]
    return [map_fault_label(sample.fault_label)]


def build_attribution(sample: FaultSample) -> IncidentAttribution:
    """Rule-based attribution envelope for one sample.

    Reference: ``pkg/attribution/mapper.go:53-98``.
    """
    domain = map_fault_label(sample.fault_label)
    evidence = [
        Evidence("fault_label", sample.fault_label, "application"),
        Evidence("mapped_domain", domain, "ebpf"),
        Evidence("llm.ebpf.correlation_confidence", sample.confidence, "otel"),
    ]
    if sample.fault_label == "dns_latency":
        evidence.append(Evidence("llm.ebpf.dns.latency_ms", 180.0, "ebpf"))
    tpu_ev = _TPU_EVIDENCE.get(sample.fault_label)
    if tpu_ev:
        evidence.append(Evidence(tpu_ev[0], tpu_ev[2], tpu_ev[1]))

    return IncidentAttribution(
        incident_id=sample.incident_id,
        timestamp=sample.timestamp,
        cluster=sample.cluster,
        namespace=sample.namespace,
        service=sample.service,
        predicted_fault_domain=domain,
        confidence=sample.confidence,
        evidence=evidence,
        slo_impact=SLOImpact("ttft_ms", sample.burn_rate, sample.window_minutes),
        trace_ids=[sample.trace_id] if sample.trace_id else [],
        request_ids=[sample.request_id] if sample.request_id else [],
    )
