"""Error-budget math: per-tenant targets, windowed SLI, burn rates.

Burn rate follows the SRE workbook definition: the rate at which the
error budget is being consumed relative to the sustainable rate, i.e.
``bad_fraction / (1 - target)``.  A burn rate of 1.0 spends exactly the
whole budget over the budget window; 14.4x spends it in 1/14.4 of it.

Budget remaining is computed over the budget-ledger window (the ring
horizon, default 6h — the demo-scale stand-in for a 30d period):
``1 - bad_fraction / (1 - target)``, clamped to [0, 1].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from tpuslo_torch.sloengine.stream import (
    BUDGET_WINDOW_INDEX,
    WINDOWS,
    TenantWindows,
)

#: Objective names, in ring-buffer slot order.
OBJECTIVES: tuple[str, ...] = ("availability", "ttft", "tpot")

_MIN_BUDGET = 1e-9


@dataclass(slots=True)
class TenantTargets:
    """Resolved SLO targets for one tenant."""

    availability_target: float = 0.99
    ttft_objective_ms: float = 800.0
    ttft_target: float = 0.95
    tpot_objective_ms: float = 120.0
    tpot_target: float = 0.95

    def target_for(self, objective: str) -> float:
        if objective == "availability":
            return self.availability_target
        if objective == "ttft":
            return self.ttft_target
        return self.tpot_target

    def error_budget(self, objective: str) -> float:
        """Allowed bad fraction; floored so a 100% target still divides."""
        return max(_MIN_BUDGET, 1.0 - self.target_for(objective))

    def to_dict(self) -> dict[str, Any]:
        return {
            "availability_target": self.availability_target,
            "ttft_objective_ms": self.ttft_objective_ms,
            "ttft_target": self.ttft_target,
            "tpot_objective_ms": self.tpot_objective_ms,
            "tpot_target": self.tpot_target,
        }


def resolve_targets(
    defaults: TenantTargets, overrides: dict[str, dict[str, float]],
    tenant: str,
) -> TenantTargets:
    """Defaults + the tenant's partial override block (unknown keys and
    non-numeric values are ignored, not fatal — config is operator
    input)."""
    raw = overrides.get(tenant)
    resolved = TenantTargets(
        availability_target=defaults.availability_target,
        ttft_objective_ms=defaults.ttft_objective_ms,
        ttft_target=defaults.ttft_target,
        tpot_objective_ms=defaults.tpot_objective_ms,
        tpot_target=defaults.tpot_target,
    )
    if not raw:
        return resolved
    for key in (
        "availability_target",
        "ttft_objective_ms",
        "ttft_target",
        "tpot_objective_ms",
        "tpot_target",
    ):
        value = raw.get(key)
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            setattr(resolved, key, float(value))
    return resolved


@dataclass
class BudgetStatus:
    """One (tenant, objective) budget snapshot for CLI/metrics export."""

    tenant: str
    objective: str
    target: float
    budget_remaining: float
    #: window label -> burn rate (bad_fraction / error_budget).
    burn_rates: dict[str, float] = field(default_factory=dict)
    #: window label -> measured SLI (good fraction; 1.0 when empty).
    sli: dict[str, float] = field(default_factory=dict)
    #: window label -> total requests observed in the window.
    totals: dict[str, int] = field(default_factory=dict)
    alert_state: str = "ok"

    def to_dict(self) -> dict[str, Any]:
        return {
            "tenant": self.tenant,
            "objective": self.objective,
            "target": self.target,
            "budget_remaining": self.budget_remaining,
            "burn_rates": dict(self.burn_rates),
            "sli": dict(self.sli),
            "totals": dict(self.totals),
            "alert_state": self.alert_state,
        }


def burn_rates_for(
    windows: TenantWindows, objective_index: int, error_budget: float
) -> dict[str, float]:
    """Burn rate per named window; an empty window burns at 0."""
    out: dict[str, float] = {}
    for wi, (label, _) in enumerate(WINDOWS):
        good, total = windows.window_counts(wi, objective_index)
        if total <= 0:
            out[label] = 0.0
        else:
            out[label] = ((total - good) / total) / error_budget
    return out


def budget_remaining_for(
    windows: TenantWindows, objective_index: int, error_budget: float
) -> float:
    """Fraction of the budget-window error budget still unspent."""
    good, total = windows.window_counts(
        BUDGET_WINDOW_INDEX, objective_index
    )
    if total <= 0:
        return 1.0
    consumed = ((total - good) / total) / error_budget
    return max(0.0, min(1.0, 1.0 - consumed))


def sli_for(
    windows: TenantWindows, objective_index: int
) -> tuple[dict[str, float], dict[str, int]]:
    """(good-fraction, total) per named window; empty windows read 1.0."""
    sli: dict[str, float] = {}
    totals: dict[str, int] = {}
    for wi, (label, _) in enumerate(WINDOWS):
        good, total = windows.window_counts(wi, objective_index)
        totals[label] = total
        sli[label] = (good / total) if total > 0 else 1.0
    return sli, totals
