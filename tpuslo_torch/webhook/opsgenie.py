"""Opsgenie Alert API payload builder.

Reference: ``pkg/webhook/opsgenie.go:24-58`` — P2 at confidence ≥ 0.8,
P1 at burn rate ≥ 3.0.

The port's own copy of ``tpuslo/webhook/opsgenie.py``.
"""

from __future__ import annotations

import json

from tpuslo_torch.schema import IncidentAttribution


def build_opsgenie_payload(attr: IncidentAttribution) -> bytes:
    priority = "P3"
    if attr.confidence >= 0.8:
        priority = "P2"
    burn_rate = attr.slo_impact.burn_rate
    if burn_rate >= 3.0:
        priority = "P1"
    # Burn-engine escalation: an active fast-burn page outranks the
    # confidence tiers — the budget is draining now.
    if any(
        entry.get("state") == "fast_burn"
        for entry in (attr.slo_burn or {}).get("alerting", [])
    ):
        priority = "P1"
    evidence = "; ".join(f"{e.signal}={e.value}" for e in attr.evidence)
    payload = {
        "message": f"[{attr.service}] {attr.predicted_fault_domain} fault detected",
        "alias": attr.incident_id,
        "description": (
            f"Fault domain {attr.predicted_fault_domain} attributed with "
            f"confidence {attr.confidence:.4f}. Evidence: {evidence}"
        ),
        "priority": priority,
        "source": f"{attr.cluster}/{attr.service}",
        "tags": ["tpuslo", attr.predicted_fault_domain],
        "details": {
            "incident_id": attr.incident_id,
            "fault_domain": attr.predicted_fault_domain,
            "confidence": f"{attr.confidence:.4f}",
            "burn_rate": f"{burn_rate:.2f}",
        },
        "entity": attr.service,
    }
    if attr.slo_burn:
        payload["details"]["burning_budgets"] = "; ".join(
            f"{entry.get('tenant', '?')}/{entry.get('objective', '?')}"
            f"={entry.get('state', '?')}"
            for entry in attr.slo_burn.get("alerting", [])
        )
    return json.dumps(payload).encode()
