"""Canonical event envelopes for every pipeline stage
(the port's own copy of ``tpuslo/schema/types.py``).

These are the L4 contract types: every emit site in the toolkit validates
its payload against the JSON schemas in ``tpuslo_torch/schema/contracts`` before
it crosses a process or network boundary.

Reference parity: ``pkg/schema/types.go:6-86`` defines SLOEvent,
Evidence, SLOImpact, FaultHypothesis, IncidentAttribution, ConnTuple and
ProbeEventV1.  The TPU-native build extends ``ProbeEventV1`` with an
optional accelerator identity block (:class:`TPURef`) so signals produced
by libtpu uprobes / ``/dev/accel*`` kprobes carry chip, ICI-link, slice
and XLA launch identity for the correlation tiers that replace the
pod+pid join on asynchronous TPU work.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any


def rfc3339(ts: datetime) -> str:
    """Format a datetime as RFC3339 with a trailing Z (UTC)."""
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=timezone.utc)
    return ts.astimezone(timezone.utc).isoformat().replace("+00:00", "Z")


def parse_rfc3339(raw: str) -> datetime:
    """Parse an RFC3339 timestamp into an aware UTC datetime."""
    return datetime.fromisoformat(raw.replace("Z", "+00:00")).astimezone(timezone.utc)


@dataclass
class SLOEvent:
    """Normalized SLO event emitted by the collector.

    Reference: ``pkg/schema/types.go:6-20``.
    """

    event_id: str
    timestamp: datetime
    cluster: str
    namespace: str
    workload: str
    service: str
    request_id: str
    sli_name: str
    sli_value: float
    unit: str
    status: str
    trace_id: str = ""
    labels: dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        out = {
            "event_id": self.event_id,
            "timestamp": rfc3339(self.timestamp),
            "cluster": self.cluster,
            "namespace": self.namespace,
            "workload": self.workload,
            "service": self.service,
            "request_id": self.request_id,
            "sli_name": self.sli_name,
            "sli_value": self.sli_value,
            "unit": self.unit,
            "status": self.status,
        }
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


@dataclass
class Evidence:
    """One observed signal supporting an attribution.

    Reference: ``pkg/schema/types.go:23-27``.
    """

    signal: str
    value: Any
    source: str

    def to_dict(self) -> dict[str, Any]:
        return {"signal": self.signal, "value": self.value, "source": self.source}


@dataclass
class SLOImpact:
    """Burn impact of an attributed incident.

    Reference: ``pkg/schema/types.go:30-34``.
    """

    sli: str
    burn_rate: float
    window_minutes: int

    def to_dict(self) -> dict[str, Any]:
        return {
            "sli": self.sli,
            "burn_rate": self.burn_rate,
            "window_minutes": self.window_minutes,
        }


@dataclass
class FaultHypothesis:
    """One Bayesian posterior for a candidate fault domain.

    Reference: ``pkg/schema/types.go:37-41``.
    """

    domain: str
    posterior: float
    evidence: list[str] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "domain": self.domain,
            "posterior": self.posterior,
            "evidence": list(self.evidence),
        }


@dataclass
class IncidentAttribution:
    """Normalized attribution envelope.

    Reference: ``pkg/schema/types.go:44-57``.
    """

    incident_id: str
    timestamp: datetime
    cluster: str
    service: str
    predicted_fault_domain: str
    confidence: float
    #: Required by the contract (tpulint TPL102): an attribution with
    #: no burn impact is not a reportable incident.
    slo_impact: SLOImpact
    evidence: list[Evidence] = field(default_factory=list)
    namespace: str = ""
    trace_ids: list[str] = field(default_factory=list)
    request_ids: list[str] = field(default_factory=list)
    fault_hypotheses: list[FaultHypothesis] = field(default_factory=list)
    #: Self-observability pointer: the producing cycle's trace/span ids
    #: and supporting probe-event ids (full chain in the provenance log,
    #: rendered by ``sloctl explain``).
    provenance: dict[str, Any] | None = None
    #: Error-budget context from the burn engine: which budgets were
    #: burning when the incident fired (``alerting`` entries carry
    #: tenant/objective/state/burn_rates/budget_remaining).  Webhook
    #: severity escalates on a fast burn.
    slo_burn: dict[str, Any] | None = None
    #: Device-plane roofline verdict (tpuslo_torch.deviceplane.roofline):
    #: memory- vs compute-bound for the serving program behind the
    #: incident, with achieved vs peak HBM bandwidth and MFU — the
    #: lens that says which lever actually fixes the regression.
    roofline: dict[str, Any] | None = None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "incident_id": self.incident_id,
            "timestamp": rfc3339(self.timestamp),
            "cluster": self.cluster,
            "service": self.service,
            "predicted_fault_domain": self.predicted_fault_domain,
            "confidence": self.confidence,
            "evidence": [e.to_dict() for e in self.evidence],
            "slo_impact": self.slo_impact.to_dict(),
        }
        if self.namespace:
            out["namespace"] = self.namespace
        if self.trace_ids:
            out["trace_ids"] = list(self.trace_ids)
        if self.request_ids:
            out["request_ids"] = list(self.request_ids)
        if self.fault_hypotheses:
            out["fault_hypotheses"] = [h.to_dict() for h in self.fault_hypotheses]
        if self.provenance:
            out["provenance"] = dict(self.provenance)
        if self.slo_burn:
            out["slo_burn"] = dict(self.slo_burn)
        if self.roofline:
            out["roofline"] = dict(self.roofline)
        return out


@dataclass(slots=True)
class ConnTuple:
    """One network flow tuple observed by probes.

    Reference: ``pkg/schema/types.go:60-66``.
    """

    src_ip: str
    dst_ip: str
    src_port: int
    dst_port: int
    protocol: str

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "ConnTuple":
        return cls(
            src_ip=str(raw.get("src_ip", "")),
            dst_ip=str(raw.get("dst_ip", "")),
            src_port=int(raw.get("src_port", 0)),
            dst_port=int(raw.get("dst_port", 0)),
            protocol=str(raw.get("protocol", "")),
        )

    def key(self) -> str:
        """Canonical string form used by correlation tier joins."""
        return (
            f"{self.protocol}:{self.src_ip}:{self.src_port}"
            f"->{self.dst_ip}:{self.dst_port}"
        )


@dataclass(slots=True)
class TPURef:
    """Accelerator identity attached to TPU-side probe events.

    TPU work is submitted asynchronously, so the pod+pid+timestamp joins
    the reference relies on are too coarse for per-step attribution;
    signals carry explicit XLA program/launch identity instead (see
    SURVEY.md §7 "Identity correlation on TPU-VMs").

    Fields:
      chip        — host-local accelerator device, e.g. ``accel0``.
      slice_id    — megascale slice identifier (multi-host pods).
      host_index  — host index within the slice topology.
      ici_link    — ICI link index for interconnect signals.
      program_id  — XLA program (compiled module) identifier.
      launch_id   — monotonically increasing execution launch id.
      module_name — XLA HLO module name, when known.
    """

    chip: str = ""
    slice_id: str = ""
    host_index: int = -1
    ici_link: int = -1
    program_id: str = ""
    launch_id: int = -1
    module_name: str = ""

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        if self.chip:
            out["chip"] = self.chip
        if self.slice_id:
            out["slice_id"] = self.slice_id
        if self.host_index >= 0:
            out["host_index"] = self.host_index
        if self.ici_link >= 0:
            out["ici_link"] = self.ici_link
        if self.program_id:
            out["program_id"] = self.program_id
        if self.launch_id >= 0:
            out["launch_id"] = self.launch_id
        if self.module_name:
            out["module_name"] = self.module_name
        return out

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "TPURef":
        return cls(
            chip=str(raw.get("chip", "")),
            slice_id=str(raw.get("slice_id", "")),
            host_index=int(raw.get("host_index", -1)),
            ici_link=int(raw.get("ici_link", -1)),
            program_id=str(raw.get("program_id", "")),
            launch_id=int(raw.get("launch_id", -1)),
            module_name=str(raw.get("module_name", "")),
        )


@dataclass(slots=True)
class ProbeEventV1:
    """Normalized probe envelope emitted by the node agent.

    Reference: ``pkg/schema/types.go:69-86``; the ``tpu`` block is the
    TPU-native extension (absent on the nine CPU-side kernel signals).
    """

    ts_unix_nano: int
    signal: str
    node: str
    namespace: str
    pod: str
    container: str
    pid: int
    tid: int
    value: float
    unit: str
    status: str
    conn_tuple: ConnTuple | None = None
    trace_id: str = ""
    span_id: str = ""
    errno: int | None = None
    confidence: float | None = None
    tpu: TPURef | None = None

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "ts_unix_nano": self.ts_unix_nano,
            "signal": self.signal,
            "node": self.node,
            "namespace": self.namespace,
            "pod": self.pod,
            "container": self.container,
            "pid": self.pid,
            "tid": self.tid,
            "value": self.value,
            "unit": self.unit,
            "status": self.status,
        }
        if self.conn_tuple is not None:
            out["conn_tuple"] = self.conn_tuple.to_dict()
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.span_id:
            out["span_id"] = self.span_id
        if self.errno is not None:
            out["errno"] = self.errno
        if self.confidence is not None:
            out["confidence"] = self.confidence
        if self.tpu is not None:
            tpu = self.tpu.to_dict()
            if tpu:
                out["tpu"] = tpu
        return out

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "ProbeEventV1":
        """Inverse of :meth:`to_dict` for schema-shaped payloads.

        Raises ``TypeError`` / ``ValueError`` / ``KeyError`` on
        malformed input — callers on ingest paths (the agent's chaos /
        gate loop, JSONL consumers) catch and account for the drop.
        """
        conn = raw.get("conn_tuple")
        tpu = raw.get("tpu")
        return cls(
            ts_unix_nano=int(raw["ts_unix_nano"]),
            signal=str(raw["signal"]),
            node=str(raw["node"]),
            namespace=str(raw["namespace"]),
            pod=str(raw["pod"]),
            container=str(raw["container"]),
            pid=int(raw["pid"]),
            tid=int(raw["tid"]),
            value=float(raw["value"]),
            unit=str(raw["unit"]),
            status=str(raw["status"]),
            conn_tuple=ConnTuple.from_dict(conn) if conn else None,
            trace_id=str(raw.get("trace_id", "")),
            span_id=str(raw.get("span_id", "")),
            errno=int(raw["errno"]) if raw.get("errno") is not None else None,
            confidence=(
                float(raw["confidence"])
                if raw.get("confidence") is not None
                else None
            ),
            tpu=TPURef.from_dict(tpu) if tpu else None,
        )
