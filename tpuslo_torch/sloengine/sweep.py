"""Seeded burn-scenario sweep: the release gate for the burn engine.

Each scenario synthesizes a deterministic per-request traffic shape on
a synthetic clock (hours of event time, milliseconds of wall time),
replays it through a fresh :class:`BurnEngine`, and asserts the alert
contract:

* **precision** — only the expected (tenant, objective, severity)
  alerts fire;
* **recall** — every expected alert fires;
* **promptness** — a fast-burn page lands at the first evaluation
  where both fast windows cross the threshold (within one evaluation
  cycle of the crossing, by construction);
* **dedup** — a sustained or flapping burn fires each alert at most
  once (zero flap-induced duplicates);
* **isolation** — tenant A's burn never alerts tenant B;
* **durability** — exporting the engine state mid-scenario, restoring
  it into a fresh engine and continuing yields the exact transition
  stream of the uninterrupted run (crash-restart equivalence).

The port's copy of ``tpuslo/sloengine/sweep.py``, over the port's
:class:`BurnEngine`: the same scenarios and seeds give the same reports
(``tests/test_torch_burn_sweep.py``).  The reference's ``m5gate
--burn-sweep`` runs the reference's copy.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable

from tpuslo_torch.sloengine.alerts import (
    SEVERITY_PAGE,
    SEVERITY_TICKET,
    AlertTransition,
)
from tpuslo_torch.sloengine.engine import BurnEngine, EngineConfig
from tpuslo_torch.sloengine.stream import RequestOutcome

#: Synthetic stream epoch (event time; nothing reads the wall clock).
BASE_TS_S = 1_700_000_000


@dataclass
class Phase:
    """One traffic phase: constant rates over ``duration_s``."""

    duration_s: int
    error_rate: float = 0.0
    slow_ttft_rate: float = 0.0
    slow_tpot_rate: float = 0.0


@dataclass
class Scenario:
    """One seeded traffic shape plus its expected alert set."""

    name: str
    phases: list[Phase]
    #: Expected notifying alerts: (tenant, objective, severity).
    expected: set[tuple[str, str, str]] = field(default_factory=set)
    tenant: str = "tenant-a"
    #: Extra interleaved clean-traffic tenants (isolation scenarios).
    quiet_tenants: tuple[str, ...] = ()
    request_interval_s: int = 5
    #: Check page promptness against the independent crossing trace.
    check_fast_timing: bool = False
    #: Export/restore the engine mid-run and require identical output.
    restart_at_fraction: float = 0.0


def default_scenarios() -> list[Scenario]:
    """The seeded shapes the gate replays.

    Rates are chosen so binomial noise cannot cross the wrong rule:
    the second (long) window of each rule filters the short-window
    noise, which is exactly the property multi-window alerting buys.
    """
    clean = Phase(duration_s=3600, error_rate=0.002)
    return [
        Scenario(
            name="steady",
            phases=[Phase(duration_s=14400, error_rate=0.002)],
            expected=set(),
        ),
        # A hard burn legitimately crosses the slow (ticket) rule on
        # its way up, then escalates to the page: both are expected,
        # each exactly once.
        Scenario(
            name="fast_burn",
            phases=[clean, Phase(duration_s=5400, error_rate=0.25)],
            expected={
                ("tenant-a", "availability", SEVERITY_PAGE),
                ("tenant-a", "availability", SEVERITY_TICKET),
            },
            check_fast_timing=True,
        ),
        Scenario(
            name="slow_burn",
            phases=[clean, Phase(duration_s=14400, error_rate=0.08)],
            expected={("tenant-a", "availability", SEVERITY_TICKET)},
        ),
        Scenario(
            name="latency_regression",
            phases=[clean, Phase(duration_s=14400, slow_ttft_rate=0.5)],
            expected={("tenant-a", "ttft", SEVERITY_TICKET)},
        ),
        Scenario(
            name="flapping",
            phases=[clean]
            + [
                Phase(duration_s=600, error_rate=rate)
                for _ in range(9)
                for rate in (0.25, 0.10)
            ],
            expected={
                ("tenant-a", "availability", SEVERITY_PAGE),
                ("tenant-a", "availability", SEVERITY_TICKET),
            },
        ),
        Scenario(
            name="tenant_isolated",
            phases=[clean, Phase(duration_s=5400, error_rate=0.25)],
            expected={
                ("tenant-a", "availability", SEVERITY_PAGE),
                ("tenant-a", "availability", SEVERITY_TICKET),
            },
            quiet_tenants=("tenant-b",),
        ),
        Scenario(
            name="restart_resume",
            phases=[clean, Phase(duration_s=5400, error_rate=0.25)],
            expected={
                ("tenant-a", "availability", SEVERITY_PAGE),
                ("tenant-a", "availability", SEVERITY_TICKET),
            },
            restart_at_fraction=0.5,
        ),
    ]


def synthesize_outcomes(
    scenario: Scenario, seed: int
) -> list[RequestOutcome]:
    """Deterministic outcome stream for one scenario."""
    rng = random.Random(seed)
    outcomes: list[RequestOutcome] = []
    tenants = (scenario.tenant,) + scenario.quiet_tenants
    ts_s = BASE_TS_S
    request_idx = 0
    for phase in scenario.phases:
        steps = max(1, phase.duration_s // scenario.request_interval_s)
        for _ in range(steps):
            for tenant in tenants:
                burning = tenant == scenario.tenant
                error = burning and rng.random() < phase.error_rate
                slow_ttft = (
                    burning and rng.random() < phase.slow_ttft_rate
                )
                slow_tpot = (
                    burning and rng.random() < phase.slow_tpot_rate
                )
                if not burning and rng.random() < 0.002:
                    error = True
                request_idx += 1
                outcomes.append(
                    RequestOutcome(
                        tenant=tenant,
                        ts_unix_nano=ts_s * 1_000_000_000,
                        ttft_ms=(
                            rng.uniform(2000.0, 5000.0)
                            if slow_ttft
                            else rng.uniform(150.0, 450.0)
                        ),
                        tpot_ms=(
                            rng.uniform(400.0, 900.0)
                            if slow_tpot
                            else rng.uniform(20.0, 60.0)
                        ),
                        tokens=128,
                        status="error" if error else "ok",
                        request_id=f"sweep-{request_idx:06d}",
                    )
                )
            ts_s += scenario.request_interval_s
    return outcomes


@dataclass
class ScenarioRun:
    """Verdict for one scenario."""

    name: str
    passed: bool
    failures: list[str] = field(default_factory=list)
    fired: list[dict[str, Any]] = field(default_factory=list)
    fast_crossing_eval_s: float = -1.0
    fast_fired_eval_s: float = -1.0
    outcomes: int = 0
    evaluations: int = 0

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "passed": self.passed,
            "failures": list(self.failures),
            "fired": list(self.fired),
            "fast_crossing_eval_s": self.fast_crossing_eval_s,
            "fast_fired_eval_s": self.fast_fired_eval_s,
            "outcomes": self.outcomes,
            "evaluations": self.evaluations,
        }


@dataclass
class BurnSweepReport:
    """The whole gate's verdict."""

    passed: bool
    seed: int
    eval_interval_s: float
    runs: list[ScenarioRun] = field(default_factory=list)
    failures: list[str] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "passed": self.passed,
            "seed": self.seed,
            "eval_interval_s": self.eval_interval_s,
            "runs": [r.to_dict() for r in self.runs],
            "failures": list(self.failures),
        }


def _engine_config(bucket_s: int) -> EngineConfig:
    return EngineConfig(bucket_s=bucket_s)


def _replay_instrumented(
    scenario: Scenario,
    outcomes: list[RequestOutcome],
    bucket_s: int,
    eval_interval_s: float,
    restart_at_fraction: float = 0.0,
) -> tuple[list[AlertTransition], float, int]:
    """Replay with per-evaluation burn tracking.

    Returns (transitions, first eval time where BOTH fast windows of
    the burning tenant's availability objective crossed the fast
    threshold, evaluation count).  When ``restart_at_fraction`` is set
    the engine is snapshotted and rebuilt at that point in the stream —
    the crash-restart equivalence probe.
    """
    engine = BurnEngine(_engine_config(bucket_s))
    fast_threshold = engine.config.fast_burn_threshold
    transitions: list[AlertTransition] = []
    crossing_s = -1.0
    evaluations = 0
    restart_index = (
        int(len(outcomes) * restart_at_fraction)
        if restart_at_fraction > 0.0
        else -1
    )
    next_eval_s: float | None = None
    last_ts_s = 0.0

    def _evaluate(at_s: float) -> None:
        nonlocal crossing_s, evaluations
        evaluations += 1
        transitions.extend(engine.evaluate(at_s))
        if crossing_s < 0:
            for stat in engine.status():
                if (
                    stat.tenant == scenario.tenant
                    and stat.objective == "availability"
                    and stat.burn_rates.get("1h", 0.0) >= fast_threshold
                    and stat.burn_rates.get("5m", 0.0) >= fast_threshold
                ):
                    crossing_s = at_s
                    break

    for idx, outcome in enumerate(outcomes):
        if idx == restart_index:
            state = engine.export_state()
            engine = BurnEngine(_engine_config(bucket_s))
            engine.restore_state(state)
        ts_s = outcome.ts_unix_nano / 1e9
        last_ts_s = max(last_ts_s, ts_s)
        if next_eval_s is None:
            next_eval_s = ts_s + eval_interval_s
        while ts_s >= next_eval_s:
            _evaluate(next_eval_s)
            next_eval_s += eval_interval_s
        engine.record(outcome)
    if last_ts_s > 0.0:
        _evaluate(last_ts_s)
    return transitions, crossing_s, evaluations


def run_scenario(
    scenario: Scenario,
    seed: int,
    bucket_s: int = 10,
    eval_interval_s: float = 30.0,
) -> ScenarioRun:
    outcomes = synthesize_outcomes(scenario, seed)
    transitions, crossing_s, evaluations = _replay_instrumented(
        scenario, outcomes, bucket_s, eval_interval_s,
        restart_at_fraction=scenario.restart_at_fraction,
    )
    failures: list[str] = []
    notifying = [
        t for t in transitions if t.severity in (SEVERITY_PAGE,
                                                 SEVERITY_TICKET)
    ]
    fired_keys = [(t.tenant, t.objective, t.severity) for t in notifying]

    # Precision: nothing unexpected fired.
    for key in fired_keys:
        if key not in scenario.expected:
            failures.append(f"unexpected alert {key}")
    # Recall: everything expected fired.
    for key in sorted(scenario.expected):
        if key not in fired_keys:
            failures.append(f"expected alert {key} never fired")
    # Dedup: one notifying transition per (tenant, objective, severity).
    seen: set[tuple[str, str, str]] = set()
    for key in fired_keys:
        if key in seen:
            failures.append(f"duplicate alert transition {key}")
        seen.add(key)

    fired_s = -1.0
    if scenario.check_fast_timing:
        pages = [t for t in notifying if t.severity == SEVERITY_PAGE]
        if pages:
            fired_s = pages[0].at_s
            if crossing_s < 0:
                failures.append(
                    "page fired but fast windows never crossed"
                )
            elif abs(fired_s - crossing_s) > 1e-6:
                failures.append(
                    "page not within one evaluation cycle of the "
                    f"crossing (crossed at {crossing_s:.0f}, fired at "
                    f"{fired_s:.0f})"
                )

    if scenario.restart_at_fraction > 0.0:
        # Crash-restart equivalence: the interrupted run above must
        # match a clean, uninterrupted replay transition-for-transition.
        reference, _, _ = _replay_instrumented(
            scenario, outcomes, bucket_s, eval_interval_s
        )
        got = [t.to_dict() for t in transitions]
        want = [t.to_dict() for t in reference]
        if got != want:
            failures.append(
                "snapshot/restore diverged from the uninterrupted run "
                f"({len(got)} vs {len(want)} transitions)"
            )

    return ScenarioRun(
        name=scenario.name,
        passed=not failures,
        failures=failures,
        fired=[t.to_dict() for t in notifying],
        fast_crossing_eval_s=crossing_s,
        fast_fired_eval_s=fired_s,
        outcomes=len(outcomes),
        evaluations=evaluations,
    )


def run_burn_sweep(
    seed: int = 1337,
    bucket_s: int = 10,
    eval_interval_s: float = 30.0,
    scenarios: list[Scenario] | None = None,
    log: Callable[[str], None] | None = None,
) -> BurnSweepReport:
    """Replay every scenario; the gate passes only if all of them do."""
    runs: list[ScenarioRun] = []
    failures: list[str] = []
    for scenario in scenarios if scenarios is not None else (
        default_scenarios()
    ):
        run = run_scenario(
            scenario, seed, bucket_s=bucket_s,
            eval_interval_s=eval_interval_s,
        )
        runs.append(run)
        if log is not None:
            log(
                f"burn-sweep: {run.name}: "
                f"{'PASS' if run.passed else 'FAIL'} "
                f"({len(run.fired)} alerts, {run.outcomes} outcomes)"
            )
        failures.extend(f"{run.name}: {f}" for f in run.failures)
    return BurnSweepReport(
        passed=not failures,
        seed=seed,
        eval_interval_s=eval_interval_s,
        runs=runs,
        failures=failures,
    )
