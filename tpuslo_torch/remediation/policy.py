"""Declarative remediation policy: attribution × burn state → action
(the port's own copy of ``tpuslo/remediation/policy.py``: plain Python, behaviour identical).

A rule fires only on the conjunction the remediation precision contract
demands — the right fault domain AND confidence at or above the rule's
floor AND an active burn state the rule covers.  Low-confidence
attributions and healthy tenants never act, which is the whole
difference between auto-remediation and auto-thrash.

Three dampers keep a mis-attribution storm from thrashing the fleet:

* a **per-(action, target) cooldown** — the same knob is not turned
  twice inside ``cooldown_s`` even across distinct incidents;
* a **per-action-kind rate limit** — at most ``rate_limit`` applies of
  one kind inside ``rate_window_s``;
* a **global concurrent-actions budget** — the engine passes its
  in-flight count and the policy refuses past
  ``max_concurrent_actions``.

Every refusal is counted by reason so the sweep (and the operator)
can tell "correctly held fire" from "never matched".
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any

from tpuslo_torch.remediation.actions import (
    ACTION_BREAKER_TRIP,
    ACTION_CORDON_NODE,
    ACTION_DEMOTE_TENANT,
    ACTION_DRAIN_SNAPSHOT,
    ACTION_PROBE_SHED,
    ACTION_REHOME_SLICE,
    ALL_ACTION_KINDS,
)

# Refusal reason classes (metrics label values; precision evidence).
REFUSED_NO_RULE = "no_rule"
REFUSED_LOW_CONFIDENCE = "low_confidence"
REFUSED_NOT_BURNING = "not_burning"
REFUSED_COOLDOWN = "cooldown"
REFUSED_RATE_LIMITED = "rate_limited"
REFUSED_BUDGET = "budget"
REFUSED_NO_TARGET = "no_target"
REFUSED_DISABLED = "disabled"


@dataclass(slots=True)
class AttributionContext:
    """One attribution + burn-state snapshot the policy decides on.

    A flattened view of ``IncidentAttribution`` + the burn engine's
    active state — flattened so the fleet plane (which holds
    ``FleetIncident``, not ``IncidentAttribution``) feeds the same
    policy.
    """

    incident_id: str
    domain: str
    confidence: float
    burn_state: str = "ok"  # ok | slow_burn | fast_burn
    burn_rate: float = 0.0
    tenant: str = ""
    node: str = ""
    slice_id: str = ""
    at_s: float = 0.0


@dataclass(slots=True)
class RemediationRule:
    """One declarative mapping: domain × confidence × burn → action."""

    domain: str
    action: str
    #: Which context field names the action's target ("tenant",
    #: "node_slice", "slice_id", "incident"); ``fixed_target`` wins
    #: when set (breaker sink names, probe signal names).
    target_field: str = "tenant"
    fixed_target: str = ""
    min_confidence: float = 0.8
    burn_states: tuple[str, ...] = ("fast_burn",)
    cooldown_s: float = 300.0
    rate_limit: int = 3
    rate_window_s: float = 3600.0
    enabled: bool = True

    def target_for(self, ctx: AttributionContext) -> str:
        if self.fixed_target:
            return self.fixed_target
        if self.target_field == "tenant":
            return ctx.tenant or "default"
        if self.target_field == "node_slice":
            if not ctx.node:
                return ""
            return f"{ctx.node}|{ctx.slice_id}"
        if self.target_field == "slice_id":
            return ctx.slice_id
        if self.target_field == "incident":
            return ctx.incident_id
        return ""


@dataclass(slots=True)
class PolicyDecision:
    """One act verdict: the rule that matched plus the bound target."""

    rule: RemediationRule
    action: str
    target: str


def default_rules(
    min_confidence: float = 0.8,
    cooldown_s: float = 300.0,
    rate_limit: int = 3,
    rate_window_s: float = 3600.0,
) -> list[RemediationRule]:
    """The shipped domain → action mapping.

    Rationale per row lives in docs/runbooks/auto-remediation.md; the
    short version: act where the toolkit itself holds the lever (its
    own probes, its own sinks, its own ring, its own admission), page a
    human everywhere else.
    """

    def rule(domain: str, action: str, **kw: Any) -> RemediationRule:
        return RemediationRule(
            domain=domain,
            action=action,
            min_confidence=min_confidence,
            cooldown_s=cooldown_s,
            rate_limit=rate_limit,
            rate_window_s=rate_window_s,
            **kw,
        )

    # Domains are the schema-constrained fault domains the attribution
    # pipeline emits (attribution/mapper.py _LABEL_TO_DOMAIN).
    return [
        # A burning tenant under HBM pressure: shed its admission
        # priority so the serving scheduler stops feeding the pressure.
        rule("tpu_hbm", ACTION_DEMOTE_TENANT, target_field="tenant"),
        # Network-plane faults: trip the delivery breaker so the agent
        # stops hammering a path the attribution says is bad (the
        # breaker's own half-open probe undoes a wrong trip cheaply).
        rule(
            "network_egress",
            ACTION_BREAKER_TRIP,
            target_field="incident",
            fixed_target="otlp",
        ),
        rule(
            "network_dns",
            ACTION_BREAKER_TRIP,
            target_field="incident",
            fixed_target="otlp",
        ),
        # CPU throttling on the host: shed the costliest probe — the
        # one lever that reduces the agent's own contribution.
        rule(
            "cpu_throttle",
            ACTION_PROBE_SHED,
            target_field="incident",
            fixed_target="syscall_latency_ms",
        ),
        # A recompile storm wants a clean hand-off: drain queued work
        # and snapshot so the workload restarts from durable state.
        rule(
            "xla_compile",
            ACTION_DRAIN_SNAPSHOT,
            target_field="incident",
            fixed_target="agent",
        ),
        # ICI faults are node-local hardware: cordon the (node, slice)
        # arc out of fleet placement.
        rule("tpu_ici", ACTION_CORDON_NODE, target_field="node_slice"),
        # Offload stalls track a slice's aggregation hot spot: re-home
        # the slice to another shard.
        rule(
            "host_offload",
            ACTION_REHOME_SLICE,
            target_field="slice_id",
        ),
    ]


class RemediationPolicy:
    """Rule matcher + the three anti-thrash dampers."""

    def __init__(
        self,
        rules: list[RemediationRule] | None = None,
        max_concurrent_actions: int = 2,
        disabled_actions: tuple[str, ...] = (),
    ):
        self.rules = list(rules) if rules is not None else default_rules()
        self.max_concurrent_actions = max(1, int(max_concurrent_actions))
        self.disabled_actions = tuple(disabled_actions)
        #: (action, target) -> last apply time (cooldown anchor).
        self._last_applied: dict[tuple[str, str], float] = {}
        #: action kind -> recent apply times (rate-limit window).
        self._recent: dict[str, deque[float]] = {}
        self.refusals: dict[str, int] = {}
        self.last_refusal = ""
        self.decisions = 0

    # ---- decision (hot path: once per attribution) --------------------

    def decide(
        self, ctx: AttributionContext, now_s: float, in_flight: int
    ) -> PolicyDecision | None:
        """Match one context against the rules and the dampers.

        Returns the decision to act, or None after counting the refusal
        reason.  First matching enabled rule wins (rule order is the
        escalation order the operator wrote).
        """
        self.decisions += 1
        best_reason = REFUSED_NO_RULE
        for rule in self.rules:
            if rule.domain != ctx.domain or not rule.enabled:
                continue
            if rule.action in self.disabled_actions:
                best_reason = REFUSED_DISABLED
                continue
            if ctx.confidence < rule.min_confidence:
                best_reason = REFUSED_LOW_CONFIDENCE
                continue
            if ctx.burn_state not in rule.burn_states:
                best_reason = REFUSED_NOT_BURNING
                continue
            target = rule.target_for(ctx)
            if not target:
                best_reason = REFUSED_NO_TARGET
                continue
            if in_flight >= self.max_concurrent_actions:
                best_reason = REFUSED_BUDGET
                continue
            last = self._last_applied.get((rule.action, target))
            if last is not None and now_s - last < rule.cooldown_s:
                best_reason = REFUSED_COOLDOWN
                continue
            recent = self._recent.get(rule.action)
            if recent is not None:
                while recent and now_s - recent[0] > rule.rate_window_s:
                    recent.popleft()
                if len(recent) >= rule.rate_limit:
                    best_reason = REFUSED_RATE_LIMITED
                    continue
            return PolicyDecision(rule, rule.action, target)
        self.refusals[best_reason] = self.refusals.get(best_reason, 0) + 1
        self.last_refusal = best_reason
        return None

    def note_applied(self, action: str, target: str, now_s: float) -> None:
        """Record one apply for the cooldown + rate-limit dampers."""
        self._last_applied[(action, target)] = now_s
        self._recent.setdefault(action, deque(maxlen=256)).append(now_s)

    # ---- snapshot hooks -----------------------------------------------

    def export_state(self) -> dict[str, Any]:
        """Damper state only — rules come from config, not snapshots."""
        return {
            "last_applied": {
                f"{action}\x1f{target}": at
                for (action, target), at in self._last_applied.items()
            },
            "recent": {
                action: list(times)
                for action, times in self._recent.items()
            },
            "refusals": dict(self.refusals),
            "decisions": self.decisions,
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        self._last_applied = {}
        for key, at in (state.get("last_applied") or {}).items():
            if "\x1f" not in key:
                continue
            action, target = key.split("\x1f", 1)
            self._last_applied[(action, target)] = float(at)
        self._recent = {}
        for action, times in (state.get("recent") or {}).items():
            if str(action) in ALL_ACTION_KINDS:
                self._recent[str(action)] = deque(
                    (float(t) for t in times), maxlen=256
                )
        self.refusals = {
            str(reason): int(count)
            for reason, count in (state.get("refusals") or {}).items()
        }
        self.decisions = int(state.get("decisions", 0))


#: Default fast-burn-only rules also cover slow burns for the gentler
#: levers — exported so config wiring can widen coverage explicitly.
SLOW_BURN_OK = ("fast_burn", "slow_burn")
