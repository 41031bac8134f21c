"""SLO error-budget and burn-rate engine (the port's own copy of
``tpuslo/sloengine``: plain Python, behaviour identical).

The top layer of the observability stack: a streaming
per-request SLI pipeline (``RequestOutcome`` → ring-buffer sliding
windows), per-tenant error budgets, Google-SRE-style multi-window
multi-burn-rate alerting with hysteresis; the seeded burn-scenario
sweep gate is ``tpuslo_torch.sloengine.sweep``.  Burn state feeds outgoing ``IncidentAttribution`` payloads
(severity + customer-impact denominator for the Bayesian attribution),
the provenance chain, Prometheus, and ``sloctl budget``.
"""

from tpuslo_torch.sloengine.alerts import (
    SEVERITY_PAGE,
    SEVERITY_RESOLVE,
    SEVERITY_TICKET,
    STATE_FAST,
    STATE_OK,
    STATE_SLOW,
    AlertPolicy,
    AlertTransition,
    BurnRule,
    state_level,
)
from tpuslo_torch.sloengine.budget import (
    OBJECTIVES,
    BudgetStatus,
    TenantTargets,
    resolve_targets,
)
from tpuslo_torch.sloengine.engine import (
    DEFAULT_ADMISSION_PRIORITY,
    DEMOTED_ADMISSION_PRIORITY,
    BurnEngine,
    EngineConfig,
    SLOObserver,
    load_outcomes,
    replay_outcomes,
)
from tpuslo_torch.sloengine.stream import (
    WINDOWS,
    RequestOutcome,
    TenantWindows,
)

__all__ = [
    "SEVERITY_PAGE",
    "SEVERITY_RESOLVE",
    "SEVERITY_TICKET",
    "STATE_FAST",
    "STATE_OK",
    "STATE_SLOW",
    "AlertPolicy",
    "AlertTransition",
    "BurnRule",
    "state_level",
    "OBJECTIVES",
    "BudgetStatus",
    "TenantTargets",
    "resolve_targets",
    "BurnEngine",
    "DEFAULT_ADMISSION_PRIORITY",
    "DEMOTED_ADMISSION_PRIORITY",
    "EngineConfig",
    "SLOObserver",
    "load_outcomes",
    "replay_outcomes",
    "WINDOWS",
    "RequestOutcome",
    "TenantWindows",
]
