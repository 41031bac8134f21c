"""The port's burn-scenario sweep (``tpuslo_torch.sloengine.sweep``)
against the JAX package's (``tpuslo.sloengine.sweep``): the scenarios of
``tests/test_burn_sweep.py`` run through each package's own
``BurnEngine``; the synthesized outcomes and the reports must be equal,
and the JAX test's assertions are made on the port's report."""

from __future__ import annotations

import json

import pytest

from tpuslo.sloengine import sweep as jsweep
from tpuslo_torch.sloengine import SEVERITY_PAGE, SEVERITY_TICKET
from tpuslo_torch.sloengine import sweep as tsweep


def _scenario_pair(name, phases, expected):
    return tuple(
        m.Scenario(name=name, phases=[m.Phase(**p) for p in phases], expected=expected)
        for m in (jsweep, tsweep)
    )


def test_default_scenarios_equal_jax():
    want = [vars(s) | {"phases": [vars(p) for p in s.phases]}
            for s in jsweep.default_scenarios()]
    got = [vars(s) | {"phases": [vars(p) for p in s.phases]}
           for s in tsweep.default_scenarios()]
    assert got == want
    assert {s["name"] for s in got} >= {"steady", "fast_burn", "slow_burn",
                                         "latency_regression", "flapping",
                                         "tenant_isolated", "restart_resume"}


@pytest.mark.parametrize("seed", [7, 8])
def test_synthesized_outcomes_equal_jax(seed):
    for j, t in zip(jsweep.default_scenarios(), tsweep.default_scenarios()):
        want = [o.to_dict() for o in jsweep.synthesize_outcomes(j, seed)]
        assert [o.to_dict() for o in tsweep.synthesize_outcomes(t, seed)] == want


@pytest.mark.parametrize("seed", [1337, 7, 42])
def test_full_sweep_report_equals_jax(seed):
    want = jsweep.run_burn_sweep(seed=seed).to_dict()
    report = tsweep.run_burn_sweep(seed=seed)
    assert json.loads(json.dumps(report.to_dict())) == json.loads(json.dumps(want))
    assert report.passed, report.failures
    if seed == 1337:
        by_name = {r.name: r for r in report.runs}
        fast = by_name["fast_burn"]
        assert fast.fast_crossing_eval_s > 0
        assert fast.fast_fired_eval_s == fast.fast_crossing_eval_s
        severities = [f["severity"] for f in by_name["flapping"].fired]
        assert severities.count(SEVERITY_PAGE) == 1
        assert severities.count(SEVERITY_TICKET) == 1
        assert all(f["tenant"] == "tenant-a" for f in by_name["tenant_isolated"].fired)


def test_a_missed_alert_fails_on_both_sides():
    j, t = _scenario_pair("expect_ghost", [dict(duration_s=3600, error_rate=0.002)],
                          {("tenant-a", "availability", SEVERITY_PAGE)})
    want, run = jsweep.run_scenario(j, seed=1), tsweep.run_scenario(t, seed=1)
    assert run.to_dict() == want.to_dict()
    assert not run.passed and any("never fired" in f for f in run.failures)


def test_a_spurious_alert_fails_on_both_sides():
    j, t = _scenario_pair("unexpected_burn", [dict(duration_s=3600, error_rate=0.002),
                                              dict(duration_s=5400, error_rate=0.25)], set())
    want, run = jsweep.run_scenario(j, seed=1), tsweep.run_scenario(t, seed=1)
    assert run.to_dict() == want.to_dict()
    assert not run.passed and any("unexpected alert" in f for f in run.failures)


def test_a_tiny_report_round_trips_to_json():
    j, t = _scenario_pair("tiny", [dict(duration_s=600)], set())
    want = jsweep.run_burn_sweep(seed=1, scenarios=[j]).to_dict()
    encoded = json.loads(json.dumps(tsweep.run_burn_sweep(seed=1, scenarios=[t]).to_dict()))
    assert encoded == json.loads(json.dumps(want))
    assert encoded["passed"] is True and encoded["runs"][0]["name"] == "tiny"
