"""Attribution-driven auto-remediation: close the observe → act loop
(the port's own copy of ``tpuslo/remediation``: plain Python, behaviour identical).

Until this subsystem, every incident in the toolkit ended at a page —
burn state and fleet rollups were observed, never acted on.  The
remediation engine turns a *high-confidence attribution under an
active burn* into a ranked, rate-limited, **reversible** action through
machinery the toolkit already trusts (probe shed lists, delivery
breakers, the crash-safe runtime, the fleet hash ring, the burn
engine's admission priorities), then verifies the burn actually
subsides — or rolls the action back and escalates to a human.

Layers (see docs/runbooks/auto-remediation.md):

* :mod:`~tpuslo_torch.remediation.policy` — declarative rules
  (domain × confidence × burn state → action) plus the three
  anti-thrash dampers (cooldowns, rate limits, a global
  concurrent-actions budget);
* :mod:`~tpuslo_torch.remediation.actions` — the ``apply()``/``rollback()``
  action implementations and :class:`ActionBindings`;
* :mod:`~tpuslo_torch.remediation.verifier` — the verify-or-rollback window
  fold with hysteresis;
* :mod:`~tpuslo_torch.remediation.engine` — the state machine, crash-safe
  through the ``AgentRuntime`` snapshot registry, every decision
  appended to the provenance chain.

The seeded release gate (``tpuslo/remediation/sweep.py``) is not copied:
the serving entry does not run it.
"""

from tpuslo_torch.remediation.actions import (
    ACTION_BREAKER_TRIP,
    ACTION_CORDON_NODE,
    ACTION_DEMOTE_TENANT,
    ACTION_DRAIN_SNAPSHOT,
    ACTION_PROBE_SHED,
    ACTION_REHOME_SLICE,
    ALL_ACTION_KINDS,
    Action,
    ActionBindings,
    ActionResult,
    BreakerTripAction,
    CordonNodeAction,
    DemoteTenantAction,
    DrainSnapshotAction,
    ProbeShedAction,
    RehomeSliceAction,
    rehome_slice,
)
from tpuslo_torch.remediation.engine import (
    PHASE_APPLY_FAILED,
    PHASE_APPLYING,
    PHASE_CONFIRMED,
    PHASE_ROLLBACK_FAILED,
    PHASE_ROLLED_BACK,
    PHASE_VERIFYING,
    TERMINAL_PHASES,
    ActionRecord,
    RemediationEngine,
    RemediationObserver,
    action_id_for,
)
from tpuslo_torch.remediation.policy import (
    AttributionContext,
    PolicyDecision,
    RemediationPolicy,
    RemediationRule,
    default_rules,
)
from tpuslo_torch.remediation.verifier import (
    VERDICT_CONFIRMED,
    VERDICT_PENDING,
    VERDICT_ROLLBACK,
    VerifyPolicy,
    VerifyState,
    observe_window,
)

__all__ = [
    "ACTION_BREAKER_TRIP",
    "ACTION_CORDON_NODE",
    "ACTION_DEMOTE_TENANT",
    "ACTION_DRAIN_SNAPSHOT",
    "ACTION_PROBE_SHED",
    "ACTION_REHOME_SLICE",
    "ALL_ACTION_KINDS",
    "Action",
    "ActionBindings",
    "ActionRecord",
    "ActionResult",
    "AttributionContext",
    "BreakerTripAction",
    "CordonNodeAction",
    "DemoteTenantAction",
    "DrainSnapshotAction",
    "PHASE_APPLYING",
    "PHASE_APPLY_FAILED",
    "PHASE_CONFIRMED",
    "PHASE_ROLLBACK_FAILED",
    "PHASE_ROLLED_BACK",
    "PHASE_VERIFYING",
    "PolicyDecision",
    "ProbeShedAction",
    "RehomeSliceAction",
    "RemediationEngine",
    "RemediationObserver",
    "RemediationPolicy",
    "RemediationRule",
    "TERMINAL_PHASES",
    "VERDICT_CONFIRMED",
    "VERDICT_PENDING",
    "VERDICT_ROLLBACK",
    "VerifyPolicy",
    "VerifyState",
    "action_id_for",
    "default_rules",
    "observe_window",
    "rehome_slice",
]
