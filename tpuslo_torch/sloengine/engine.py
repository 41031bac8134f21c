"""BurnEngine: the streaming error-budget and burn-rate evaluator.

One engine per agent: ``record()`` folds each :class:`RequestOutcome`
into its tenant's ring-buffer windows (hot path — O(1), no wall-clock
reads, timestamps arrive with the outcome), ``evaluate(now_s)`` runs
the multi-window burn rules and returns the alert transitions that
actually fired.  The engine registers with the PR-4 ``AgentRuntime``
(``export_state``/``restore_state``) so budgets, rings and alert
states survive a crash-restart, and bridges to Prometheus through a
duck-typed :class:`SLOObserver`.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Iterable, Iterator

from tpuslo_torch.sloengine.alerts import (
    SEVERITY_RESOLVE,
    STATE_OK,
    AlertPolicy,
    AlertTransition,
    state_level,
)
from tpuslo_torch.sloengine.budget import (
    OBJECTIVES,
    BudgetStatus,
    TenantTargets,
    budget_remaining_for,
    burn_rates_for,
    resolve_targets,
    sli_for,
)
from tpuslo_torch.sloengine.stream import RequestOutcome, TenantWindows

STATE_VERSION = 1

#: Admission priority the serving scheduler consults per tenant
#: (higher = admitted first).  Every tenant starts at the default; the
#: auto-remediation engine demotes a burning tenant to the demoted
#: value and restores it on rollback.
DEFAULT_ADMISSION_PRIORITY = 100
DEMOTED_ADMISSION_PRIORITY = 10


class SLOObserver:
    """No-op observer; the agent bridges these to Prometheus."""

    def outcome(self, tenant: str, status: str) -> None: ...

    def burn_rate(
        self, tenant: str, objective: str, window: str, rate: float
    ) -> None: ...

    def budget_remaining(
        self, tenant: str, objective: str, remaining: float
    ) -> None: ...

    def alert_state(
        self, tenant: str, objective: str, level: int
    ) -> None: ...

    def transition(
        self, tenant: str, objective: str, severity: str
    ) -> None: ...


@dataclass
class EngineConfig:
    """Engine knobs, shape-compatible with the ``slo:`` config section."""

    bucket_s: int = 10
    budget_window_s: int = 21600
    availability_target: float = 0.99
    ttft_objective_ms: float = 800.0
    ttft_target: float = 0.95
    tpot_objective_ms: float = 120.0
    tpot_target: float = 0.95
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0
    clear_hysteresis: float = 0.5
    clear_cycles: int = 6
    max_tenants: int = 64
    tenant_overrides: dict[str, dict[str, float]] = field(
        default_factory=dict
    )

    @classmethod
    def from_toolkit(cls, slo_cfg: Any) -> "EngineConfig":
        """Build from a ``toolkitcfg.SLOConfig`` (duck-typed: any object
        with the same attribute names works)."""
        return cls(
            bucket_s=int(slo_cfg.bucket_s),
            budget_window_s=int(slo_cfg.budget_window_s),
            availability_target=float(slo_cfg.availability_target),
            ttft_objective_ms=float(slo_cfg.ttft_objective_ms),
            ttft_target=float(slo_cfg.ttft_target),
            tpot_objective_ms=float(slo_cfg.tpot_objective_ms),
            tpot_target=float(slo_cfg.tpot_target),
            fast_burn_threshold=float(slo_cfg.fast_burn_threshold),
            slow_burn_threshold=float(slo_cfg.slow_burn_threshold),
            clear_hysteresis=float(slo_cfg.clear_hysteresis),
            clear_cycles=int(slo_cfg.clear_cycles),
            max_tenants=int(slo_cfg.max_tenants),
            tenant_overrides=dict(slo_cfg.tenants or {}),
        )

    def default_targets(self) -> TenantTargets:
        return TenantTargets(
            availability_target=self.availability_target,
            ttft_objective_ms=self.ttft_objective_ms,
            ttft_target=self.ttft_target,
            tpot_objective_ms=self.tpot_objective_ms,
            tpot_target=self.tpot_target,
        )


class BurnEngine:
    """Streaming per-tenant error-budget + burn-rate engine."""

    def __init__(
        self,
        config: EngineConfig | None = None,
        observer: SLOObserver | None = None,
    ):
        self.config = config or EngineConfig()
        self._observer = observer or SLOObserver()
        self._defaults = self.config.default_targets()
        self._tenants: dict[str, TenantWindows] = {}
        self._targets: dict[str, TenantTargets] = {}
        self.policy = AlertPolicy(
            fast_threshold=self.config.fast_burn_threshold,
            slow_threshold=self.config.slow_burn_threshold,
            clear_hysteresis=self.config.clear_hysteresis,
            clear_cycles=self.config.clear_cycles,
        )
        self.recorded = 0
        self.dropped_overflow = 0
        self.transitions_fired = 0
        self._last_eval_s = 0.0
        # tenant -> demoted admission priority (absent = default).
        self._admission: dict[str, int] = {}

    # ---- stream side (hot path) ---------------------------------------

    def tenant_targets(self, tenant: str) -> TenantTargets:
        targets = self._targets.get(tenant)
        if targets is None:
            targets = resolve_targets(
                self._defaults, self.config.tenant_overrides, tenant
            )
            self._targets[tenant] = targets
        return targets

    def _tenant_windows(self, tenant: str) -> TenantWindows | None:
        windows = self._tenants.get(tenant)
        if windows is None:
            if len(self._tenants) >= self.config.max_tenants:
                return None
            windows = TenantWindows(
                n_objectives=len(OBJECTIVES),
                bucket_s=self.config.bucket_s,
                horizon_s=self.config.budget_window_s,
            )
            self._tenants[tenant] = windows
        return windows

    def record(self, outcome: RequestOutcome) -> bool:
        """Fold one request outcome into its tenant's windows."""
        tenant = outcome.tenant or "default"
        windows = self._tenant_windows(tenant)
        if windows is None:
            self.dropped_overflow += 1
            return False
        targets = self.tenant_targets(tenant)
        ok = outcome.status == "ok"
        goods = (
            ok,
            ok and outcome.ttft_ms <= targets.ttft_objective_ms,
            ok and outcome.tpot_ms <= targets.tpot_objective_ms,
        )
        accepted = windows.record(
            outcome.ts_unix_nano // 1_000_000_000, goods
        )
        if accepted:
            self.recorded += 1
            self._observer.outcome(tenant, outcome.status)
        return accepted

    # ---- evaluation (cold path) ---------------------------------------

    def roll_to(self, now_s: float) -> None:
        """Advance every tenant's windows to ``now_s`` WITHOUT running
        the alert policy — the read-only roll for display paths
        (``sloctl budget``) that must not mutate persisted alert
        state."""
        now_bucket = int(now_s) // self.config.bucket_s
        for windows in self._tenants.values():
            windows.roll_to(now_bucket)

    def evaluate(self, now_s: float) -> list[AlertTransition]:
        """Roll every tenant forward to ``now_s``, run the burn rules,
        export gauges, and return the transitions that fired."""
        self._last_eval_s = now_s
        transitions: list[AlertTransition] = []
        now_bucket = int(now_s) // self.config.bucket_s
        for tenant, windows in self._tenants.items():
            windows.roll_to(now_bucket)
            targets = self.tenant_targets(tenant)
            for oi, objective in enumerate(OBJECTIVES):
                budget = targets.error_budget(objective)
                burns = burn_rates_for(windows, oi, budget)
                transition = self.policy.evaluate(
                    tenant, objective, burns, now_s
                )
                if transition is not None:
                    transitions.append(transition)
                    self.transitions_fired += 1
                    self._observer.transition(
                        tenant, objective, transition.severity
                    )
                for window, rate in burns.items():
                    self._observer.burn_rate(
                        tenant, objective, window, rate
                    )
                self._observer.budget_remaining(
                    tenant,
                    objective,
                    budget_remaining_for(windows, oi, budget),
                )
                self._observer.alert_state(
                    tenant,
                    objective,
                    state_level(self.policy.state_of(tenant, objective)),
                )
        return transitions

    def status(self) -> list[BudgetStatus]:
        """Per-(tenant, objective) budget table (``sloctl budget``)."""
        out: list[BudgetStatus] = []
        for tenant in sorted(self._tenants):
            windows = self._tenants[tenant]
            targets = self.tenant_targets(tenant)
            for oi, objective in enumerate(OBJECTIVES):
                budget = targets.error_budget(objective)
                sli, totals = sli_for(windows, oi)
                out.append(
                    BudgetStatus(
                        tenant=tenant,
                        objective=objective,
                        target=targets.target_for(objective),
                        budget_remaining=budget_remaining_for(
                            windows, oi, budget
                        ),
                        burn_rates=burn_rates_for(windows, oi, budget),
                        sli=sli,
                        totals=totals,
                        alert_state=self.policy.state_of(
                            tenant, objective
                        ),
                    )
                )
        return out

    def active_burns(self) -> list[dict[str, Any]]:
        """Currently-burning budgets, for incident attachment."""
        out: list[dict[str, Any]] = []
        for stat in self.status():
            if stat.alert_state == STATE_OK:
                continue
            out.append(
                {
                    "tenant": stat.tenant,
                    "objective": stat.objective,
                    "state": stat.alert_state,
                    "burn_rates": dict(stat.burn_rates),
                    "budget_remaining": stat.budget_remaining,
                }
            )
        return out

    def max_active_burn(
        self, burns: list[dict[str, Any]] | None = None
    ) -> float:
        """Largest long-window burn among alerting budgets (severity
        input for webhook payloads); 0 when nothing is burning.  Pass
        an ``active_burns()`` result to avoid recomputing it."""
        best = 0.0
        for burn in self.active_burns() if burns is None else burns:
            rates = burn["burn_rates"]
            window = "1h" if burn["state"] == "fast_burn" else "6h"
            best = max(best, rates.get(window, 0.0))
        return best

    # ---- admission priority (remediation surface) ---------------------

    def tenant_burn_state(self, tenant: str) -> str:
        """Worst live alert state across this tenant's objectives
        (``ok`` | ``slow_burn`` | ``fast_burn``) — the burn signal the
        serving front door's admission layer deprioritizes on.  Pure
        state-machine read: no windows roll, nothing mutates."""
        worst = STATE_OK
        for objective in OBJECTIVES:
            state = self.policy.state_of(tenant or "default", objective)
            if state_level(state) > state_level(worst):
                worst = state
        return worst

    def admission_priority(self, tenant: str) -> int:
        """Priority the serving scheduler should admit this tenant at
        (higher first); demoted tenants sort behind everyone else."""
        return self._admission.get(
            tenant or "default", DEFAULT_ADMISSION_PRIORITY
        )

    def demote_tenant(
        self, tenant: str, priority: int = DEMOTED_ADMISSION_PRIORITY
    ) -> bool:
        """Demote one tenant's admission priority; False when already
        demoted (the caller must not stack demotions it cannot
        symmetrically restore)."""
        tenant = tenant or "default"
        if tenant in self._admission:
            return False
        self._admission[tenant] = int(priority)
        return True

    def restore_tenant(self, tenant: str) -> bool:
        """Return a demoted tenant to the default admission priority;
        False when it was not demoted."""
        return self._admission.pop(tenant or "default", None) is not None

    def demoted_tenants(self) -> list[str]:
        return sorted(self._admission)

    def snapshot(self) -> dict[str, Any]:
        """Stats-line counters."""
        return {
            "tenants": len(self._tenants),
            "recorded": self.recorded,
            "dropped_stale": sum(
                w.dropped_stale for w in self._tenants.values()
            ),
            "dropped_overflow": self.dropped_overflow,
            "transitions": self.transitions_fired,
            "alerting": self.policy.alerting_count(),
        }

    # ---- snapshot / restore (crash-safe runtime) ----------------------

    def export_state(self) -> dict[str, Any]:
        return {
            "version": STATE_VERSION,
            "bucket_s": self.config.bucket_s,
            "tenants": {
                tenant: windows.export_state()
                for tenant, windows in self._tenants.items()
            },
            "alerts": self.policy.export_state(),
            "admission": dict(self._admission),
            "recorded": self.recorded,
            "transitions_fired": self.transitions_fired,
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        if not isinstance(state, dict):
            return
        if int(state.get("version", -1)) != STATE_VERSION:
            return
        if int(state.get("bucket_s", -1)) != self.config.bucket_s:
            # A resolution change makes old rings unrestorable; start
            # cold rather than restore wrong windows.
            return
        restored: dict[str, TenantWindows] = {}
        for tenant, raw in (state.get("tenants") or {}).items():
            if len(restored) >= self.config.max_tenants:
                break
            windows = TenantWindows(
                n_objectives=len(OBJECTIVES),
                bucket_s=self.config.bucket_s,
                horizon_s=self.config.budget_window_s,
            )
            if isinstance(raw, dict) and windows.restore_state(raw):
                restored[tenant] = windows
        self._tenants = restored
        self.policy.restore_state(state.get("alerts") or {})
        self._admission = {
            str(tenant): int(priority)
            for tenant, priority in (state.get("admission") or {}).items()
        }
        self.recorded = int(state.get("recorded", 0))
        self.transitions_fired = int(state.get("transitions_fired", 0))


# ---- offline replay helpers (loadgen --slo-out, sloctl budget --replay) -------


def load_outcomes(path: str) -> Iterator[RequestOutcome]:
    """Stream a ``RequestOutcome`` JSONL file; malformed lines (torn
    tail) are skipped, not fatal."""
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                raw = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(raw, dict):
                yield RequestOutcome.from_dict(raw)


def replay_outcomes(
    engine: BurnEngine,
    outcomes: Iterable[RequestOutcome],
    evaluation_interval_s: float = 30.0,
) -> list[AlertTransition]:
    """Drive the engine from a recorded stream, evaluating on the
    stream's own clock every ``evaluation_interval_s`` of event time
    (plus once at end-of-stream)."""
    transitions: list[AlertTransition] = []
    next_eval_s: float | None = None
    last_ts_s = 0.0
    for outcome in outcomes:
        ts_s = outcome.ts_unix_nano / 1e9
        last_ts_s = max(last_ts_s, ts_s)
        if next_eval_s is None:
            next_eval_s = ts_s + evaluation_interval_s
        while ts_s >= next_eval_s:
            transitions.extend(engine.evaluate(next_eval_s))
            next_eval_s += evaluation_interval_s
        engine.record(outcome)
    if last_ts_s > 0.0:
        transitions.extend(engine.evaluate(last_ts_s))
    return transitions


def dedupe_resolved(
    transitions: list[AlertTransition],
) -> list[AlertTransition]:
    """Just the notifying transitions (pages + tickets)."""
    return [t for t in transitions if t.severity != SEVERITY_RESOLVE]
