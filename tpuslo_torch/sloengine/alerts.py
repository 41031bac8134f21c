"""Multi-window multi-burn-rate alert rules with hysteresis + dedup.

The canonical SRE-workbook pair of rules, evaluated per
(tenant, objective):

* **fast_burn** — burn ≥ 14.4x on BOTH the 1h and 5m windows → page.
  14.4x spends a 30d budget in ~2 days; at our 6h demo-scale ledger it
  spends the whole budget in ~25 minutes.
* **slow_burn** — burn ≥ 6x on BOTH the 6h and 30m windows → ticket.

The short window makes alerts recover quickly once the burn stops; the
long window keeps a brief spike from paging at all.  The state machine
adds the two things raw threshold checks lack:

* **dedup** — a sustained burn is ONE transition (``page``/``ticket``),
  not one per evaluation cycle; the gauge carries the ongoing state.
* **hysteresis** — leaving a burning state requires the active rule's
  burn to sit below ``threshold * clear_hysteresis`` on both windows
  for ``clear_cycles`` consecutive evaluations, so traffic flapping
  around the threshold cannot re-fire the same alert.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

SEVERITY_PAGE = "page"
SEVERITY_TICKET = "ticket"
SEVERITY_RESOLVE = "resolve"

STATE_OK = "ok"
STATE_SLOW = "slow_burn"
STATE_FAST = "fast_burn"

_STATE_LEVELS = {STATE_OK: 0, STATE_SLOW: 1, STATE_FAST: 2}


def state_level(state: str) -> int:
    """Numeric alert level (0 ok / 1 slow_burn / 2 fast_burn)."""
    return _STATE_LEVELS.get(state, 0)


@dataclass(slots=True)
class BurnRule:
    """One multi-window burn rule: fire when BOTH windows exceed it."""

    name: str
    long_window: str
    short_window: str
    threshold: float
    severity: str
    state: str

    def firing(self, burns: dict[str, float]) -> bool:
        return (
            burns.get(self.long_window, 0.0) >= self.threshold
            and burns.get(self.short_window, 0.0) >= self.threshold
        )

    def clearing(self, burns: dict[str, float], hysteresis: float) -> bool:
        line = self.threshold * hysteresis
        return (
            burns.get(self.long_window, 0.0) < line
            and burns.get(self.short_window, 0.0) < line
        )


@dataclass(slots=True)
class AlertTransition:
    """One alert state change (the thing that actually notifies)."""

    tenant: str
    objective: str
    rule: str
    severity: str
    from_state: str
    to_state: str
    burn_long: float
    burn_short: float
    at_s: float

    def to_dict(self) -> dict[str, Any]:
        return {
            "tenant": self.tenant,
            "objective": self.objective,
            "rule": self.rule,
            "severity": self.severity,
            "from_state": self.from_state,
            "to_state": self.to_state,
            "burn_long": self.burn_long,
            "burn_short": self.burn_short,
            "at_s": self.at_s,
        }


@dataclass
class _AlertSlot:
    state: str = STATE_OK
    clear_streak: int = 0
    since_s: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "state": self.state,
            "clear_streak": self.clear_streak,
            "since_s": self.since_s,
        }

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "_AlertSlot":
        state = str(raw.get("state", STATE_OK))
        if state not in _STATE_LEVELS:
            state = STATE_OK
        return cls(
            state=state,
            clear_streak=int(raw.get("clear_streak", 0)),
            since_s=float(raw.get("since_s", 0.0)),
        )


@dataclass
class AlertPolicy:
    """Per-(tenant, objective) burn alert state machines."""

    fast_threshold: float = 14.4
    slow_threshold: float = 6.0
    clear_hysteresis: float = 0.5
    clear_cycles: int = 6
    _slots: dict[tuple[str, str], _AlertSlot] = field(default_factory=dict)

    def rules(self) -> tuple[BurnRule, BurnRule]:
        """Fast first: escalation outranks the ticket tier."""
        return (
            BurnRule(
                "fast_burn", "1h", "5m", self.fast_threshold,
                SEVERITY_PAGE, STATE_FAST,
            ),
            BurnRule(
                "slow_burn", "6h", "30m", self.slow_threshold,
                SEVERITY_TICKET, STATE_SLOW,
            ),
        )

    def state_of(self, tenant: str, objective: str) -> str:
        slot = self._slots.get((tenant, objective))
        return slot.state if slot is not None else STATE_OK

    def alerting_count(self) -> int:
        """Number of (tenant, objective) pairs not in the ok state."""
        return sum(
            1 for slot in self._slots.values() if slot.state != STATE_OK
        )

    def evaluate(
        self,
        tenant: str,
        objective: str,
        burns: dict[str, float],
        now_s: float,
    ) -> AlertTransition | None:
        """One evaluation step; at most one transition per step."""
        slot = self._slots.get((tenant, objective))
        if slot is None:
            slot = _AlertSlot()
            self._slots[(tenant, objective)] = slot
        fast, slow = self.rules()
        if fast.firing(burns):
            desired, desired_rule = STATE_FAST, fast
        elif slow.firing(burns):
            desired, desired_rule = STATE_SLOW, slow
        else:
            desired, desired_rule = STATE_OK, None
        current = slot.state
        if state_level(desired) > state_level(current):
            # Escalation is immediate: a faster burn must page now.
            slot.state = desired
            slot.clear_streak = 0
            slot.since_s = now_s
            return AlertTransition(
                tenant=tenant,
                objective=objective,
                rule=desired_rule.name,
                severity=desired_rule.severity,
                from_state=current,
                to_state=desired,
                burn_long=burns.get(desired_rule.long_window, 0.0),
                burn_short=burns.get(desired_rule.short_window, 0.0),
                at_s=now_s,
            )
        if state_level(desired) < state_level(current):
            # De-escalation needs sustained clearance of the ACTIVE
            # rule — this is the flap dampener.
            active = fast if current == STATE_FAST else slow
            if active.clearing(burns, self.clear_hysteresis):
                slot.clear_streak += 1
            else:
                slot.clear_streak = 0
            if slot.clear_streak >= self.clear_cycles:
                slot.state = desired
                slot.clear_streak = 0
                slot.since_s = now_s
                return AlertTransition(
                    tenant=tenant,
                    objective=objective,
                    rule=active.name,
                    severity=SEVERITY_RESOLVE,
                    from_state=current,
                    to_state=desired,
                    burn_long=burns.get(active.long_window, 0.0),
                    burn_short=burns.get(active.short_window, 0.0),
                    at_s=now_s,
                )
            return None
        slot.clear_streak = 0
        return None

    # ---- snapshot / restore -------------------------------------------

    def export_state(self) -> dict[str, Any]:
        return {
            f"{tenant}\x1f{objective}": slot.to_dict()
            for (tenant, objective), slot in self._slots.items()
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        self._slots.clear()
        for key, raw in (state or {}).items():
            if "\x1f" not in key or not isinstance(raw, dict):
                continue
            tenant, objective = key.split("\x1f", 1)
            self._slots[(tenant, objective)] = _AlertSlot.from_dict(raw)
