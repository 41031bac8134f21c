"""Deterministic synthetic sample generation — the pipeline's testable spine
(the port's own copy of ``tpuslo/collector/synthetic.py``).

Every pipeline stage downstream of collection can run on these
deterministic scenario samples with zero privileges and zero hardware;
the real-probe path (``tpuslo_torch.collector.ringbuf``) swaps in on capable
hosts.  Reference: ``pkg/collector/synthetic.go:17-130``; the TPU-native
build adds five accelerator fault scenarios (``ici_drop``, ``dcn_degradation``,
``hbm_pressure``, ``xla_recompile_storm``, ``host_offload_stall``) and a
``tpu_mixed`` rotation per BASELINE.json config 5.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime, timedelta
from typing import Any

from tpuslo_torch.schema import parse_rfc3339, rfc3339


@dataclass
class SampleMeta:
    """Workload identity attached to generated samples.

    Reference: ``pkg/collector/synthetic.go:9-15`` plus TPU slice identity.
    """

    cluster: str = "tpu-cluster"
    namespace: str = "llm"
    workload: str = "rag-service"
    service: str = "rag-service"
    node: str = "tpu-vm-0"
    slice_id: str = ""
    host_index: int = 0


@dataclass
class RawSample:
    """One synthetic or collected LLM request observation.

    Reference: ``pkg/collector/pipeline.go:11-25``.
    """

    timestamp: datetime
    cluster: str
    namespace: str
    workload: str
    service: str
    request_id: str
    trace_id: str
    ttft_ms: float
    request_latency_ms: float
    token_throughput_tps: float
    error_rate: float
    node: str = ""
    fault_label: str = ""
    labels: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "timestamp": rfc3339(self.timestamp),
            "cluster": self.cluster,
            "namespace": self.namespace,
            "workload": self.workload,
            "service": self.service,
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "ttft_ms": self.ttft_ms,
            "request_latency_ms": self.request_latency_ms,
            "token_throughput_tps": self.token_throughput_tps,
            "error_rate": self.error_rate,
        }
        if self.node:
            out["node"] = self.node
        if self.fault_label:
            out["fault_label"] = self.fault_label
        return out

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "RawSample":
        ts = raw.get("timestamp")
        return cls(
            timestamp=parse_rfc3339(ts) if isinstance(ts, str) else ts,
            cluster=raw.get("cluster", ""),
            namespace=raw.get("namespace", ""),
            workload=raw.get("workload", ""),
            service=raw.get("service", ""),
            node=raw.get("node", ""),
            request_id=raw.get("request_id", ""),
            trace_id=raw.get("trace_id", ""),
            ttft_ms=float(raw.get("ttft_ms", 0.0)),
            request_latency_ms=float(raw.get("request_latency_ms", 0.0)),
            token_throughput_tps=float(raw.get("token_throughput_tps", 0.0)),
            error_rate=float(raw.get("error_rate", 0.0)),
            fault_label=raw.get("fault_label", ""),
        )


# Scenario name -> rotation of per-sample fault labels.
# Reference: syntheticScenarioSequence, ``synthetic.go:17-26``.
_SCENARIO_SEQUENCE: dict[str, tuple[str, ...]] = {
    "baseline": ("baseline",),
    "provider_throttle": ("provider_throttle",),
    "dns_latency": ("dns_latency",),
    "cpu_throttle": ("cpu_throttle",),
    "memory_pressure": ("memory_pressure",),
    "network_partition": ("network_partition",),
    # TPU fault scenarios (BASELINE.json north star).
    "ici_drop": ("ici_drop",),
    "hbm_pressure": ("hbm_pressure",),
    "xla_recompile_storm": ("xla_recompile_storm",),
    "host_offload_stall": ("host_offload_stall",),
    "dcn_degradation": ("dcn_degradation",),
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
    "mixed_multi": ("mixed_multi",),
}

# SLO impact per fault label: (ttft_ms, request_latency_ms, tps, error_rate).
# CPU-side rows mirror reference ``synthetic.go:99-130``; TPU rows are
# designed from how each fault lands on serving SLIs:
#   xla_recompile_storm — compiles sit on the critical path, so TTFT
#     explodes while steady-state decode throughput barely moves.
#   hbm_pressure — allocator stalls throttle every decode step: TPS
#     collapses, moderate error rate from OOM-killed requests.
#   ici_drop — collectives retry across the degraded link: throughput
#     collapses and timeouts push the error rate up.
#   host_offload_stall — the input/offload pipeline delays the first
#     token but decode runs clean once data is resident.
_FAULT_SLO_PROFILE: dict[str, tuple[float, float, float, float]] = {
    "baseline": (340, 720, 36, 0.005),
    "provider_throttle": (980, 2100, 7, 0.14),
    "dns_latency": (820, 1600, 18, 0.03),
    "cpu_throttle": (700, 1350, 11, 0.05),
    "memory_pressure": (650, 1250, 13, 0.04),
    "network_partition": (1200, 3500, 3, 0.25),
    "ici_drop": (760, 2900, 4, 0.12),
    "hbm_pressure": (950, 2500, 6, 0.08),
    "xla_recompile_storm": (2600, 3400, 24, 0.01),
    "host_offload_stall": (1500, 2600, 15, 0.02),
    # dcn_degradation — cross-slice phases stall per step: throughput
    # sags and stragglers time some requests out, but single-slice
    # serving paths stay clean so the error rate is moderate.
    "dcn_degradation": (900, 2400, 9, 0.06),
    "mixed_multi": (1450, 4200, 2, 0.31),
}


def supported_synthetic_scenarios() -> list[str]:
    """Accepted synthetic scenario names (reference ``synthetic.go:29-40``)."""
    return list(_SCENARIO_SEQUENCE)


def supported_fault_labels() -> list[str]:
    return list(_FAULT_SLO_PROFILE)


def build_synthetic_sample(
    scenario: str, idx: int, timestamp: datetime, meta: SampleMeta
) -> RawSample:
    """One scenario-specific sample for a given index.

    Reference: ``pkg/collector/synthetic.go:66-78``.
    """
    labels = _SCENARIO_SEQUENCE.get(scenario)
    if labels is None:
        raise ValueError(f"unsupported scenario {scenario!r}")
    fault_label = labels[idx % len(labels)]
    ttft, latency, tps, err = _FAULT_SLO_PROFILE[fault_label]
    return RawSample(
        timestamp=timestamp,
        cluster=meta.cluster,
        namespace=meta.namespace,
        workload=meta.workload,
        service=meta.service,
        node=meta.node,
        request_id=f"collector-req-{idx + 1:04d}",
        trace_id=f"collector-trace-{idx + 1:04d}",
        ttft_ms=ttft,
        request_latency_ms=latency,
        token_throughput_tps=tps,
        error_rate=err,
        fault_label="" if fault_label == "baseline" else fault_label,
    )


def generate_synthetic_samples(
    scenario: str, count: int, start: datetime, meta: SampleMeta
) -> list[RawSample]:
    """A deterministic sequence of scenario samples, one per second.

    Reference: ``pkg/collector/synthetic.go:43-63``.
    """
    if count < 1:
        raise ValueError("count must be >= 1")
    return [
        build_synthetic_sample(scenario, idx, start + timedelta(seconds=idx), meta)
        for idx in range(count)
    ]
