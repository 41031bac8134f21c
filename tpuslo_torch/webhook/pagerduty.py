"""PagerDuty Events API v2 payload builder.

Reference: ``pkg/webhook/pagerduty.go:29-61`` — severity escalates to
``critical`` at confidence ≥ 0.8.  The burn engine adds a second
escalation path: an incident that fires while a fast-burn page is
active (or whose SLO impact burns at page rate) is ``critical``
regardless of attribution confidence — budget exhaustion outranks
classifier certainty.

The port's own copy of ``tpuslo/webhook/pagerduty.py``.
"""

from __future__ import annotations

import json

from tpuslo_torch.schema import IncidentAttribution

#: Burn rate at which severity escalates regardless of confidence —
#: the fast-burn page threshold (SRE 1h+5m rule).
FAST_BURN_ESCALATION = 14.4


def _fast_burning(attr: IncidentAttribution) -> bool:
    if attr.slo_impact.burn_rate >= FAST_BURN_ESCALATION:
        return True
    for entry in (attr.slo_burn or {}).get("alerting", []):
        if entry.get("state") == "fast_burn":
            return True
    return False


def build_pagerduty_payload(attr: IncidentAttribution) -> bytes:
    severity = (
        "critical"
        if attr.confidence >= 0.8 or _fast_burning(attr)
        else "warning"
    )
    evidence = "; ".join(f"{e.signal}={e.value}" for e in attr.evidence)
    burn_rate = attr.slo_impact.burn_rate
    payload = {
        "routing_key": "",
        "event_action": "trigger",
        "payload": {
            "summary": (
                f"[{attr.service}] {attr.predicted_fault_domain} fault detected "
                f"(confidence={attr.confidence:.2f})"
            ),
            "source": f"{attr.cluster}/{attr.service}",
            "severity": severity,
            "timestamp": attr.timestamp.strftime("%Y-%m-%dT%H:%M:%S.000+0000"),
            "component": attr.service,
            "group": attr.cluster,
            "custom_details": {
                "incident_id": attr.incident_id,
                "fault_domain": attr.predicted_fault_domain,
                "confidence": f"{attr.confidence:.4f}",
                "evidence": evidence,
                "burn_rate": f"{burn_rate:.2f}",
            },
        },
    }
    if attr.slo_burn:
        payload["payload"]["custom_details"]["burning_budgets"] = [
            f"{entry.get('tenant', '?')}/{entry.get('objective', '?')}"
            f"={entry.get('state', '?')}"
            for entry in attr.slo_burn.get("alerting", [])
        ]
    return json.dumps(payload).encode()
