"""Incident provenance: the causal chain behind every page
(the port's own copy of ``tpuslo/obs/provenance.py``: plain Python, behaviour identical).

Each :class:`IncidentAttribution` the agent emits is backed by concrete
evidence — the probe events of that cycle, the correlation decisions
that tied them to the workload trace, the Bayesian posterior, and the
delivery outcome of the alert itself.  This module records that chain
(keyed by incident id, linked to the cycle's self-trace via span/trace
ids) to an append-only JSONL file, and renders it for
``sloctl explain <incident>``.
"""

from __future__ import annotations

import io
import json
import os
from dataclasses import dataclass, field
from typing import Any


def probe_event_id(signal: str, ts_unix_nano: int) -> str:
    """Stable id for one probe event (``signal@ts``): ProbeEventV1
    carries no dedicated id field, and signal+timestamp is exactly the
    identity the ingest gate's dedup window keys on."""
    return f"{signal}@{ts_unix_nano}"


@dataclass
class EvidenceEvent:
    """One probe event supporting an incident, with its correlation
    verdict (tier + confidence against the cycle's workload trace)."""

    event_id: str
    signal: str
    value: float
    tier: str = ""
    confidence: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "event_id": self.event_id,
            "signal": self.signal,
            "value": self.value,
            "tier": self.tier,
            "confidence": self.confidence,
        }

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "EvidenceEvent":
        return cls(
            event_id=str(raw.get("event_id", "")),
            signal=str(raw.get("signal", "")),
            value=float(raw.get("value", 0.0)),
            tier=str(raw.get("tier", "")),
            confidence=float(raw.get("confidence", 0.0)),
        )


@dataclass
class ProvenanceRecord:
    """Everything needed to reconstruct why one incident paged."""

    incident_id: str
    recorded_at: str = ""
    cycle: int = -1
    trace_id: str = ""
    root_span_id: str = ""
    fault_label: str = ""
    predicted_fault_domain: str = ""
    confidence: float = 0.0
    #: Top fault-domain posteriors, domain → probability.
    posterior: dict[str, float] = field(default_factory=dict)
    #: Supporting probe events with per-event correlation verdicts.
    events: list[EvidenceEvent] = field(default_factory=list)
    #: Correlation summary: window, matched/total, best tier.
    correlation: dict[str, Any] = field(default_factory=dict)
    #: Alert delivery outcome (queued/ok/error/deduped + channel).
    delivery: dict[str, Any] = field(default_factory=dict)
    #: Per-stage durations (ms) of the producing cycle.
    stages_ms: dict[str, float] = field(default_factory=dict)
    #: Error budgets burning when the incident fired (burn-engine
    #: ``active_burns()`` entries: tenant/objective/state/burn_rates/
    #: budget_remaining).
    burning: list[dict[str, Any]] = field(default_factory=list)
    #: Fleet rollup only: the contributing node incidents this page
    #: collapsed (node/pod/slice, correlation tier, confidence) — a
    #: fleet page still drills down to kernel evidence through its
    #: members' own provenance chains.
    members: list[dict[str, Any]] = field(default_factory=list)
    #: Fleet rollup only: the blast radius of the collapsed page
    #: (pod/node/slice/fleet); empty for single-node incidents.
    blast_radius: str = ""
    #: Device-plane roofline verdict for the serving program behind
    #: this incident (tpuslo_torch.deviceplane.roofline block: memory- vs
    #: compute-bound, achieved vs peak bandwidth/MFU).
    roofline: dict[str, Any] = field(default_factory=dict)
    #: Continuous-profiler capture window that fed this incident
    #: (``ProfilerWindow.to_dict()``: idle gap, eviction count,
    #: unexplained share, MFU, join rates, governor state) — present
    #: only when the incident was raised off a profiler window.
    profiler: dict[str, Any] = field(default_factory=dict)
    #: Auto-remediation actions taken on this incident, in decision
    #: order (``RemediationEngine`` action-record dicts: action id,
    #: kind, target, phase, verify verdict, rollback detail).  The
    #: engine re-records the full chain on every phase change, so the
    #: last record per incident carries the complete action history.
    remediation: list[dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "incident_id": self.incident_id,
            "recorded_at": self.recorded_at,
            "cycle": self.cycle,
            "trace_id": self.trace_id,
            "root_span_id": self.root_span_id,
            "fault_label": self.fault_label,
            "predicted_fault_domain": self.predicted_fault_domain,
            "confidence": self.confidence,
            "posterior": dict(self.posterior),
            "events": [e.to_dict() for e in self.events],
            "correlation": dict(self.correlation),
            "delivery": dict(self.delivery),
            "stages_ms": dict(self.stages_ms),
            "burning": [dict(b) for b in self.burning],
            "members": [dict(m) for m in self.members],
            "blast_radius": self.blast_radius,
            "roofline": dict(self.roofline),
            "profiler": dict(self.profiler),
            "remediation": [dict(r) for r in self.remediation],
        }

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "ProvenanceRecord":
        return cls(
            incident_id=str(raw.get("incident_id", "")),
            recorded_at=str(raw.get("recorded_at", "")),
            cycle=int(raw.get("cycle", -1)),
            trace_id=str(raw.get("trace_id", "")),
            root_span_id=str(raw.get("root_span_id", "")),
            fault_label=str(raw.get("fault_label", "")),
            predicted_fault_domain=str(
                raw.get("predicted_fault_domain", "")
            ),
            confidence=float(raw.get("confidence", 0.0)),
            posterior={
                str(k): float(v)
                for k, v in (raw.get("posterior") or {}).items()
            },
            events=[
                EvidenceEvent.from_dict(e) for e in (raw.get("events") or [])
            ],
            correlation=dict(raw.get("correlation") or {}),
            delivery=dict(raw.get("delivery") or {}),
            stages_ms={
                str(k): float(v)
                for k, v in (raw.get("stages_ms") or {}).items()
            },
            burning=[
                dict(b)
                for b in (raw.get("burning") or [])
                if isinstance(b, dict)
            ],
            members=[
                dict(m)
                for m in (raw.get("members") or [])
                if isinstance(m, dict)
            ],
            blast_radius=str(raw.get("blast_radius", "")),
            roofline=dict(raw.get("roofline") or {}),
            profiler=dict(raw.get("profiler") or {}),
            remediation=[
                dict(r)
                for r in (raw.get("remediation") or [])
                if isinstance(r, dict)
            ],
        )

    def attribution_block(self) -> dict[str, Any]:
        """Compact provenance block embedded in the outgoing
        ``IncidentAttribution`` (webhook payloads carry the pointer;
        the full chain lives in the provenance log)."""
        return {
            "trace_id": self.trace_id,
            "root_span_id": self.root_span_id,
            "probe_event_ids": [e.event_id for e in self.events],
        }


class ProvenanceLog:
    """Append-only JSONL provenance store, one record per incident.

    Writes are line-buffered and flushed per record — a crash loses at
    most the incident being written, never corrupts prior chains (a
    torn tail is tolerated by :func:`load_records`).
    """

    def __init__(self, path: str):
        self.path = path
        self._fh: io.TextIOWrapper | None = None

    def record(self, rec: ProvenanceRecord) -> None:
        if self._fh is None:
            directory = os.path.dirname(self.path)
            if directory:
                os.makedirs(directory, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(
            json.dumps(rec.to_dict(), separators=(",", ":")) + "\n"
        )
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def load_records(path: str) -> dict[str, ProvenanceRecord]:
    """Load a provenance log; last record per incident id wins.

    Malformed lines (torn tail after a crash) are skipped, not fatal.
    """
    records: dict[str, ProvenanceRecord] = {}
    try:
        fh = open(path, encoding="utf-8")
    except OSError:
        return records
    with fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                raw = json.loads(line)
            except json.JSONDecodeError:
                continue
            rec = ProvenanceRecord.from_dict(raw)
            if rec.incident_id:
                records[rec.incident_id] = rec
    return records


def format_chain(rec: ProvenanceRecord) -> str:
    """Human-readable causal chain for ``sloctl explain``."""
    lines = [
        f"incident {rec.incident_id}"
        + (f"  (cycle {rec.cycle})" if rec.cycle >= 0 else "")
        + (
            f"  [fleet rollup, blast radius: {rec.blast_radius}]"
            if rec.blast_radius
            else ""
        ),
        f"  predicted: {rec.predicted_fault_domain} "
        f"(confidence {rec.confidence:.3f})"
        + (f", injected fault label: {rec.fault_label}" if rec.fault_label else ""),
    ]
    if rec.members:
        lines.append(
            f"  members ({len(rec.members)} contributing node "
            "incidents):"
        )
        for m in rec.members:
            where = m.get("incident_id") or (
                f"{m.get('node', '?')}/{m.get('pod', '?')}"
            )
            slice_id = m.get("slice_id", "")
            lines.append(
                f"     - {where}"
                + (f" slice={slice_id}" if slice_id else "")
                + f" tier={m.get('tier', 'node_window')}"
                + f" confidence={float(m.get('confidence', 0.0)):.2f}"
            )
    if rec.trace_id:
        lines.append(
            f"  self-trace: trace_id={rec.trace_id} "
            f"root_span_id={rec.root_span_id}"
        )

    lines.append(f"  1. probe events ({len(rec.events)} supporting):")
    for ev in rec.events:
        tier = ev.tier or "unmatched"
        lines.append(
            f"     - {ev.event_id} value={ev.value:g} "
            f"tier={tier} confidence={ev.confidence:.2f}"
        )
    if not rec.events:
        lines.append("     (none recorded)")

    corr = rec.correlation
    if "matched" in corr or "total" in corr:
        lines.append(
            "  2. correlation: {matched}/{total} events matched within "
            "{window_ms} ms (best tier: {best_tier})".format(
                matched=corr.get("matched", 0),
                total=corr.get("total", 0),
                window_ms=corr.get("window_ms", "?"),
                best_tier=corr.get("best_tier", "none"),
            )
        )
    elif "window_start_ns" in corr:
        # Fleet rollup: the correlation context is the merged window.
        lines.append(
            "  2. rollup window: [{start}, {end}] ns, tenant "
            "{tenant}, {nodes} nodes over {slices} slices".format(
                start=corr.get("window_start_ns", 0),
                end=corr.get("window_end_ns", 0),
                tenant=corr.get("tenant", "?"),
                nodes=corr.get("nodes", 0),
                slices=corr.get("slices", 0),
            )
        )
    else:
        lines.append("  2. correlation: (not recorded)")

    if rec.posterior:
        ranked = sorted(
            rec.posterior.items(), key=lambda kv: kv[1], reverse=True
        )
        chain = ", ".join(f"{d}={p:.3f}" for d, p in ranked)
        lines.append(f"  3. fault-domain posterior: {chain}")
    else:
        lines.append("  3. fault-domain posterior: (not recorded)")

    if rec.roofline:
        roof = rec.roofline
        lines.append(
            "  roofline: {verdict} — {bw:.1f} GB/s achieved "
            "({bw_pct:.1f}% of HBM roof), MFU {mfu:.1f}%".format(
                verdict=roof.get("verdict", "?"),
                bw=float(roof.get("achieved_gb_per_sec", 0.0)),
                bw_pct=float(roof.get("hbm_bw_pct", 0.0)),
                mfu=float(roof.get("mfu_pct", 0.0)),
            )
        )
        detail = roof.get("detail", "")
        if detail:
            lines.append(f"    {detail}")

    if rec.profiler:
        prof = rec.profiler
        lines.append(
            "  profiler window #{index} (cycle {cycle}): idle gap "
            "{gap:.3f} ms, {ev} eviction(s), unexplained "
            "{unexpl:.3f}, MFU {mfu:.2f}%".format(
                index=prof.get("index", "?"),
                cycle=prof.get("cycle", "?"),
                gap=float(prof.get("idle_gap_ms", 0.0)),
                ev=int(prof.get("eviction_events", 0)),
                unexpl=float(prof.get("unexplained_share", 0.0)),
                mfu=float(prof.get("mfu_pct", -1.0)),
            )
        )
        lines.append(
            "    joins: raw {raw:.3f} / substantive {sub:.3f}; "
            "stride {stride} cycle(s){deg}{forced}".format(
                raw=float(prof.get("raw_join_rate", 0.0)),
                sub=float(prof.get("substantive_join_rate", 0.0)),
                stride=prof.get("stride_cycles", "?"),
                deg=" [DEGRADED]" if prof.get("degraded") else "",
                forced=" [forced capture]" if prof.get("forced") else "",
            )
        )
        verdict_detail = prof.get("verdict_detail", "")
        if prof.get("verdict"):
            lines.append(
                f"    window verdict: {prof.get('verdict')}"
                + (f" — {verdict_detail}" if verdict_detail else "")
            )

    if rec.burning:
        for burn in rec.burning:
            rates = burn.get("burn_rates") or {}
            rate_text = " ".join(
                f"{window}={rate:.1f}x"
                for window, rate in sorted(rates.items())
            )
            lines.append(
                "  budget burning: "
                f"{burn.get('tenant', '?')}/{burn.get('objective', '?')} "
                f"state={burn.get('state', '?')} "
                f"remaining={burn.get('budget_remaining', 0.0):.1%}"
                + (f" ({rate_text})" if rate_text else "")
            )

    delivery = rec.delivery
    if delivery:
        extra = "".join(
            f" {k}={v}" for k, v in delivery.items() if k != "outcome"
        )
        lines.append(
            f"  4. alert delivery: outcome={delivery.get('outcome', '?')}"
            + extra
        )
    else:
        lines.append("  4. alert delivery: (not recorded)")

    if rec.remediation:
        lines.append(
            f"  5. remediation ({len(rec.remediation)} action(s)):"
        )
        for action in rec.remediation:
            verdict = action.get("verdict") or action.get("phase", "?")
            lines.append(
                f"     - {action.get('kind', '?')} on "
                f"{action.get('target', '?')} "
                f"[{action.get('action_id', '?')}] "
                f"phase={action.get('phase', '?')} verdict={verdict}"
            )
            detail = action.get("detail", "")
            if detail:
                lines.append(f"       {detail}")
            if action.get("escalated"):
                lines.append(
                    "       ESCALATED: verify failed or apply was "
                    "interrupted — paged a human"
                )

    if rec.stages_ms:
        stages = " ".join(
            f"{name}={ms:.2f}ms" for name, ms in rec.stages_ms.items()
        )
        lines.append(f"  cycle stages: {stages}")
    return "\n".join(lines)
