"""Auto-remediation: ``tpuslo_torch.remediation`` (with its copies of
``safety.recovery``, ``obs.provenance`` and ``runtime``) against the JAX
package's.

The cases of ``tests/test_remediation.py`` that touch the ported modules
(``TestPolicy``, ``TestActions``, ``TestShedOwnership``,
``TestVerifier``, ``TestEngine`` and the ``TestWiring`` cases that need
no fleet) are written once, as functions of a *side* (one package's
modules), run on the JAX package's and on the port's, and must observe
the same values on both: decisions, refusal counts, action results,
records, exported states and the provenance JSONL bytes.  The JAX
test's own assertions hold on each side.

The port has no delivery breaker, fleet hash ring or aggregator shard;
the actions over those are duck-typed, so both sides drive the JAX
package's own plain objects (``tpuslo.delivery.breaker.CircuitBreaker``,
``tpuslo.fleet.ring.HashRing``, ``tpuslo.fleet.aggregator.AggregatorShard``)
as their targets.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from pathlib import Path
from types import SimpleNamespace

import pytest

import tpuslo.remediation as jrem
import tpuslo_torch.remediation as trem
from tpuslo.attribution import mapper as jmapper
from tpuslo.delivery.breaker import STATE_CLOSED, STATE_OPEN, CircuitBreaker
from tpuslo.fleet.aggregator import AggregatorShard
from tpuslo.fleet.ring import HashRing
from tpuslo.obs import provenance as jprov
from tpuslo.remediation import engine as jengine
from tpuslo.runtime import statestore as jstate
from tpuslo.runtime import supervisor as jsup
from tpuslo.safety import recovery as jrec
from tpuslo.signals import generator as jgen
from tpuslo.sloengine import engine as jslo
from tpuslo_torch.attribution import mapper as tmapper
from tpuslo_torch.obs import provenance as tprov
from tpuslo_torch.remediation import engine as tengine
from tpuslo_torch.runtime import statestore as tstate
from tpuslo_torch.runtime import supervisor as tsup
from tpuslo_torch.safety import recovery as trec
from tpuslo_torch.signals import generator as tgen
from tpuslo_torch.sloengine import engine as tslo

ROOT = Path(__file__).resolve().parents[1]

J = SimpleNamespace(name="jax", rem=jrem, engine=jengine, prov=jprov, rec=jrec,
                    sup=jsup, slo=jslo, gen=jgen, state=jstate, mapper=jmapper)
T = SimpleNamespace(name="port", rem=trem, engine=tengine, prov=tprov, rec=trec,
                    sup=tsup, slo=tslo, gen=tgen, state=tstate, mapper=tmapper)


def both(scenario, tmp_path=None):
    """Run ``scenario`` on both sides (each in its own directory when
    ``tmp_path`` is given), require equal observations, return the
    port's."""
    def on(side):
        if tmp_path is None:
            return scenario(side)
        where = tmp_path / side.name
        where.mkdir()
        return scenario(side, where)

    want, got = on(J), on(T)
    assert got == want
    return got


def test_the_port_exports_the_same_names():
    assert trem.__all__ == jrem.__all__
    assert tengine.MAX_TERMINAL_RECORDS == jengine.MAX_TERMINAL_RECORDS
    assert tengine.STATE_VERSION == jengine.STATE_VERSION


def _ctx(s, domain="tpu_hbm", confidence=0.95, burn_state="fast_burn",
         incident="inc-1", tenant="tenant-a", **kw):
    return s.rem.AttributionContext(incident_id=incident, domain=domain,
                                    confidence=confidence, burn_state=burn_state,
                                    tenant=tenant, **kw)


def _decision(d):
    return None if d is None else (d.action, d.target)


# ---------------------------------------------------------------------------
# policy: matching + dampers
# ---------------------------------------------------------------------------


class TestPolicy:
    def test_matches_high_confidence_fast_burn(self):
        def run(s):
            decision = s.rem.RemediationPolicy().decide(_ctx(s), now_s=0.0, in_flight=0)
            assert decision is not None
            assert decision.action == s.rem.ACTION_DEMOTE_TENANT
            assert decision.target == "tenant-a"
            return _decision(decision)

        both(run)

    @pytest.mark.parametrize("kw,reason", [
        ({"confidence": 0.5}, "low_confidence"),
        ({"burn_state": "ok"}, "not_burning"),
        ({"domain": "made_up"}, "no_rule"),
    ], ids=["low_confidence", "healthy_burn_state", "unknown_domain"])
    def test_refused(self, kw, reason):
        def run(s):
            policy = s.rem.RemediationPolicy()
            assert policy.decide(_ctx(s, **kw), now_s=0.0, in_flight=0) is None
            assert policy.refusals.get(reason, 0) == 1
            return dict(policy.refusals), policy.last_refusal

        both(run)

    def test_global_budget_refused(self):
        def run(s):
            policy = s.rem.RemediationPolicy(max_concurrent_actions=2)
            assert policy.decide(_ctx(s), now_s=0.0, in_flight=2) is None
            assert policy.refusals.get("budget", 0) == 1
            return dict(policy.refusals)

        both(run)

    def test_cooldown_blocks_same_target(self):
        def run(s):
            policy = s.rem.RemediationPolicy()
            decision = policy.decide(_ctx(s), now_s=0.0, in_flight=0)
            policy.note_applied(decision.action, decision.target, 0.0)
            # Same target inside the cooldown: refused.
            assert policy.decide(_ctx(s, incident="inc-2"), now_s=10.0, in_flight=0) is None
            assert policy.refusals.get("cooldown", 0) == 1
            # Past the cooldown it can act again.
            later = policy.decide(_ctx(s, incident="inc-3"), now_s=301.0, in_flight=0)
            assert later is not None
            return _decision(later), policy.export_state()

        both(run)

    def test_cooldown_does_not_block_other_target(self):
        def run(s):
            policy = s.rem.RemediationPolicy()
            policy.note_applied(s.rem.ACTION_DEMOTE_TENANT, "tenant-a", 0.0)
            decision = policy.decide(_ctx(s, incident="inc-2", tenant="tenant-b"),
                                     now_s=10.0, in_flight=0)
            assert decision is not None
            return _decision(decision)

        both(run)

    def test_rate_limit_per_kind(self):
        def run(s):
            policy = s.rem.RemediationPolicy()
            for i in range(3):
                policy.note_applied(s.rem.ACTION_DEMOTE_TENANT, f"tenant-{i}", float(i))
            assert policy.decide(_ctx(s, incident="inc-x", tenant="tenant-z"),
                                 now_s=10.0, in_flight=0) is None
            assert policy.refusals.get("rate_limited", 0) == 1
            # The window slides: an hour later the same kind can act.
            later = policy.decide(_ctx(s, incident="inc-y", tenant="tenant-z"),
                                  now_s=3700.0, in_flight=0)
            assert later is not None
            return _decision(later), policy.export_state()

        both(run)

    def test_disabled_action_refused(self):
        def run(s):
            policy = s.rem.RemediationPolicy(disabled_actions=(s.rem.ACTION_DEMOTE_TENANT,))
            assert policy.decide(_ctx(s), now_s=0.0, in_flight=0) is None
            assert policy.refusals.get("disabled", 0) == 1
            return dict(policy.refusals)

        both(run)

    def test_node_slice_target_derivation(self):
        def run(s):
            decision = s.rem.RemediationPolicy().decide(
                _ctx(s, domain="tpu_ici", node="n1", slice_id="s1"), now_s=0.0, in_flight=0)
            assert decision.action == s.rem.ACTION_CORDON_NODE
            assert decision.target == "n1|s1"
            return _decision(decision)

        both(run)

    def test_missing_node_target_refused(self):
        def run(s):
            policy = s.rem.RemediationPolicy()
            assert policy.decide(_ctx(s, domain="tpu_ici"), now_s=0.0, in_flight=0) is None
            assert policy.refusals.get("no_target", 0) == 1
            return dict(policy.refusals)

        both(run)

    def test_damper_state_round_trip(self):
        def run(s):
            policy = s.rem.RemediationPolicy()
            policy.note_applied(s.rem.ACTION_DEMOTE_TENANT, "tenant-a", 100.0)
            policy.decide(_ctx(s, burn_state="ok"), now_s=0.0, in_flight=0)
            restored = s.rem.RemediationPolicy()
            restored.restore_state(policy.export_state())
            assert restored.decisions == policy.decisions
            # Cooldown survives the round trip.
            assert restored.decide(_ctx(s, incident="inc-2"), now_s=150.0, in_flight=0) is None
            assert restored.refusals.get("cooldown", 0) == 1
            # The pre-restart refusal counts carried over too.
            assert restored.refusals.get("not_burning", 0) == 1
            return policy.export_state(), restored.export_state()

        both(run)

    def test_default_rules_are_the_same(self):
        both(lambda s: [dataclasses.asdict(r) for r in s.rem.default_rules()])


# ---------------------------------------------------------------------------
# actions: apply/rollback round trips against the real substrate
# ---------------------------------------------------------------------------


def _result(r):
    return r.ok, r.detail


class TestActions:
    def test_probe_shed_round_trip(self):
        def run(s):
            gen = s.gen.Generator("tpu_full")
            ownership = s.rec.ShedOwnership()
            action = s.rem.ProbeShedAction("syscall_latency_ms", gen, ownership=ownership)
            applied = action.apply()
            assert applied.ok
            assert "syscall_latency_ms" in gen.shed_signals()
            assert ownership.owner_of("syscall_latency_ms") == s.rec.OWNER_REMEDIATION
            rolled = action.rollback()
            assert rolled.ok
            assert "syscall_latency_ms" not in gen.shed_signals()
            assert "syscall_latency_ms" in gen.enabled_signals()
            assert ownership.owner_of("syscall_latency_ms") == ""
            return _result(applied), _result(rolled), gen.shed_signals()

        both(run)

    def test_probe_shed_refuses_foreign_shed(self):
        def run(s):
            gen = s.gen.Generator("tpu_full")
            ownership = s.rec.ShedOwnership()
            ownership.claim("syscall_latency_ms", s.rec.OWNER_GUARD)
            result = s.rem.ProbeShedAction("syscall_latency_ms", gen,
                                           ownership=ownership).apply()
            assert not result.ok
            assert "guard" in result.detail
            return _result(result)

        both(run)

    def test_probe_shed_refuses_untagged_existing_shed(self):
        def run(s):
            gen = s.gen.Generator("tpu_full")
            gen.import_shed(["syscall_latency_ms"])  # legacy untagged shed
            ownership = s.rec.ShedOwnership()
            result = s.rem.ProbeShedAction("syscall_latency_ms", gen,
                                           ownership=ownership).apply()
            assert not result.ok
            # The refused apply must not leave a dangling claim behind.
            assert ownership.owner_of("syscall_latency_ms") == ""
            return _result(result)

        both(run)

    def test_probe_shed_rollback_respects_holddown(self):
        def run(s):
            gen = s.gen.Generator("tpu_full")
            ownership = s.rec.ShedOwnership()
            clock = [0.0]
            supervisor = s.sup.ProbeSupervisor(s.sup.SupervisorConfig(flap_holddown_s=300.0),
                                               clock=lambda: clock[0])
            action = s.rem.ProbeShedAction("syscall_latency_ms", gen, ownership=ownership,
                                           supervisor=supervisor)
            assert action.apply().ok
            # The supervisor flap-sheds the same signal while the
            # remediation is in flight.
            supervisor._held["syscall_latency_ms"] = 300.0
            result = action.rollback()
            assert result.ok and "held down" in result.detail
            # The probe stays shed; ownership is released.
            assert "syscall_latency_ms" in gen.shed_signals()
            assert ownership.owner_of("syscall_latency_ms") == ""
            return _result(result)

        both(run)

    def test_breaker_trip_round_trip(self):
        def run(s):
            breaker = CircuitBreaker()
            action = s.rem.BreakerTripAction("otlp", breaker)
            applied = action.apply()
            assert applied.ok and breaker.state == STATE_OPEN
            rolled = action.rollback()
            assert rolled.ok and breaker.state == STATE_CLOSED
            return _result(applied), _result(rolled)

        both(run)

    def test_breaker_family_trip_covers_every_otlp_channel(self):
        def run(s):
            breakers = {name: CircuitBreaker()
                        for name in ("otlp-slo", "otlp-probe", "otlp-traces", "webhook")}
            bindings = s.rem.ActionBindings(breakers=breakers)
            action = bindings.build(s.rem.ACTION_BREAKER_TRIP, "otlp")
            assert action is not None
            result = action.apply()
            assert result.ok and "3 breaker(s)" in result.detail
            for name in ("otlp-slo", "otlp-probe", "otlp-traces"):
                assert breakers[name].state == STATE_OPEN, name
            assert breakers["webhook"].state == STATE_CLOSED
            rolled = action.rollback()
            assert rolled.ok
            assert all(b.state == STATE_CLOSED for b in breakers.values())
            # An unmatched family is unbound, not a silent no-op.
            assert bindings.build(s.rem.ACTION_BREAKER_TRIP, "nosuch") is None
            return _result(result), _result(rolled)

        both(run)

    def test_cordon_round_trip(self):
        def run(s):
            ring = HashRing(["agg-0", "agg-1"], vnodes=8)
            action = s.rem.CordonNodeAction("n1", "s1", ring)
            results = [action.apply()]
            assert results[0].ok
            assert ring.is_cordoned("n1", "s1")
            assert "n1" not in ring.assignments([("n1", "s1"), ("n2", "s1")])
            results.append(action.apply())
            assert not results[-1].ok  # idempotence guard
            results.append(action.rollback())
            assert results[-1].ok
            assert not ring.is_cordoned("n1", "s1")
            assert "n1" in ring.assignments([("n1", "s1")])
            results.append(action.rollback())  # ensure-undone
            assert results[-1].ok and "nothing to undo" in results[-1].detail
            return [_result(r) for r in results]

        both(run)

    def test_demote_tenant_round_trip(self):
        def run(s):
            burn = s.slo.BurnEngine(s.slo.EngineConfig())
            action = s.rem.DemoteTenantAction("tenant-a", burn)
            results = [action.apply()]
            assert results[0].ok
            assert burn.admission_priority("tenant-a") < s.slo.DEFAULT_ADMISSION_PRIORITY
            results.append(action.apply())
            assert not results[-1].ok  # no stacked demotions
            results.append(action.rollback())
            assert results[-1].ok
            assert burn.admission_priority("tenant-a") == s.slo.DEFAULT_ADMISSION_PRIORITY
            # Ensure-undone semantics: a second rollback is a clean no-op.
            results.append(action.rollback())
            assert results[-1].ok and "nothing to undo" in results[-1].detail
            return [_result(r) for r in results]

        both(run)

    def test_demotion_survives_burn_snapshot(self):
        def run(s):
            burn = s.slo.BurnEngine(s.slo.EngineConfig())
            burn.demote_tenant("tenant-a")
            restored = s.slo.BurnEngine(s.slo.EngineConfig())
            restored.restore_state(burn.export_state())
            assert restored.demoted_tenants() == ["tenant-a"]
            assert restored.admission_priority("tenant-a") < s.slo.DEFAULT_ADMISSION_PRIORITY
            return restored.admission_priority("tenant-a")

        both(run)

    def test_rehome_slice_round_trip(self):
        def run(s):
            source, target = AggregatorShard("agg-0"), AggregatorShard("agg-1")
            for node, slice_id in (("n1", "s1"), ("n2", "s1"), ("n3", "s2")):
                source.absorb_node_state(node, {"head_ns": 10, "seq": 1, "events": 5,
                                                "slice_id": slice_id})
            action = s.rem.RehomeSliceAction("s1", source, target)
            result = action.apply()
            assert result.ok and "2 node(s)" in result.detail
            assert set(target.nodes) == {"n1", "n2"}
            assert set(source.nodes) == {"n3"}
            rolled = action.rollback()
            assert rolled.ok
            assert set(source.nodes) == {"n1", "n2", "n3"}
            return _result(result), _result(rolled), source.export_state()

        both(run)

    def test_rehome_moves_pending_evidence_off_the_source(self):
        def run(s):
            source, target = AggregatorShard("agg-0"), AggregatorShard("agg-1")
            source.absorb_node_state("n1", {
                "head_ns": 10, "seq": 1, "events": 5, "slice_id": "s1",
                "pending": [{"bucket": 3, "namespace": "tenant-a", "pod": "pod-0",
                             "signals": {"hbm_alloc_stall_ms": 40.0}}],
            })
            assert s.rem.RehomeSliceAction("s1", source, target).apply().ok
            target_pending = target.export_state()["nodes"]["n1"]["pending"]
            assert target_pending and target_pending[0]["bucket"] == 3
            assert source.export_state() == {"window_ns": source.window_ns, "nodes": {}}
            return target.export_state()

        both(run)

    def test_drain_snapshot_runs_steps(self, tmp_path):
        def run(s, where):
            runtime = s.state.AgentRuntime(s.state.StateStore(where / "state.json",
                                                              interval_s=0))
            runtime.register("c", lambda: {"x": 1}, lambda st: None)
            ran = []
            action = s.rem.DrainSnapshotAction(
                "agent", runtime, drain_steps=[("flush", lambda budget: ran.append(budget))],
                deadline_s=2.0)
            result = action.apply()
            assert result.ok
            assert len(ran) == 1
            assert (where / "state.json").exists()
            rolled = action.rollback()
            assert rolled.ok  # honest no-op
            return result.ok, rolled.detail, s.state.StateStore(where / "state.json").load()[1]

        both(run, tmp_path)

    def test_bindings_build_unbound_kind_is_none(self):
        def run(s):
            bindings = s.rem.ActionBindings()
            built = [bindings.build(kind, target) for kind, target in (
                (s.rem.ACTION_PROBE_SHED, "x"), (s.rem.ACTION_BREAKER_TRIP, "otlp"),
                (s.rem.ACTION_REHOME_SLICE, "s1"), ("unknown_kind", "x"))]
            assert built == [None] * 4
            return built

        both(run)


# ---------------------------------------------------------------------------
# shed ownership
# ---------------------------------------------------------------------------


class TestShedOwnership:
    def test_claim_release_owner(self):
        def run(s):
            o = s.rec.ShedOwnership()
            seen = [o.claim("sig", s.rec.OWNER_REMEDIATION),
                    o.claim("sig", s.rec.OWNER_REMEDIATION),  # re-claim ok
                    o.claim("sig", s.rec.OWNER_GUARD),
                    o.release("sig", s.rec.OWNER_GUARD),
                    o.release("sig", s.rec.OWNER_REMEDIATION)]
            assert seen == [True, True, False, False, True]
            assert o.owner_of("sig") == ""
            return seen

        both(run)

    def test_guard_cannot_restore_remediation_shed(self):
        def run(s):
            gen = s.gen.Generator("tpu_full")
            ownership = s.rec.ShedOwnership()
            s.rem.ProbeShedAction("syscall_latency_ms", gen, ownership=ownership).apply()
            candidate = gen.shed_signals()[-1]
            assert not ownership.may_restore(candidate, s.rec.OWNER_GUARD)
            # Untagged and guard-owned sheds remain restorable.
            gen.disable_highest_cost()
            untagged = gen.shed_signals()[-1]
            assert untagged != "syscall_latency_ms"
            assert ownership.may_restore(untagged, s.rec.OWNER_GUARD)
            return candidate, untagged

        both(run)

    def test_supervisor_holddown_vetoes_every_owner(self):
        def run(s):
            ownership = s.rec.ShedOwnership()
            clock = [0.0]
            supervisor = s.sup.ProbeSupervisor(s.sup.SupervisorConfig(flap_holddown_s=100.0),
                                               clock=lambda: clock[0])
            supervisor._held["sig"] = 100.0
            ownership.claim("sig", s.rec.OWNER_REMEDIATION)
            seen = [ownership.may_restore("sig", s.rec.OWNER_REMEDIATION, supervisor),
                    ownership.may_restore("sig", s.rec.OWNER_GUARD, supervisor)]
            clock[0] = 101.0
            seen.append(ownership.may_restore("sig", s.rec.OWNER_REMEDIATION, supervisor))
            assert seen == [False, False, True]
            return seen

        both(run)

    def test_ownership_state_round_trip(self):
        def run(s):
            ownership = s.rec.ShedOwnership()
            ownership.claim("a", s.rec.OWNER_REMEDIATION)
            ownership.claim("b", s.rec.OWNER_GUARD)
            restored = s.rec.ShedOwnership()
            restored.restore_state(ownership.export_state())
            assert restored.owner_of("a") == s.rec.OWNER_REMEDIATION
            assert restored.owner_of("b") == s.rec.OWNER_GUARD
            return ownership.export_state()

        both(run)


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


class TestVerifier:
    @pytest.mark.parametrize("policy,burns,want", [
        (dict(windows=6, subside_streak=2, subside_below=3.0), (20.0, 1.0, 0.5),
         ("pending", "pending", "confirmed")),
        (dict(windows=3, subside_streak=2), (20.0, 20.0, 20.0),
         ("pending", "pending", "rollback")),
        # hysteresis: a bounce resets the streak without failing
        (dict(windows=6, subside_streak=2, subside_below=3.0), (1.0, 10.0, 1.0, 1.0),
         ("pending", "pending", "pending", "confirmed")),
        # the last budgeted window is the streak's second hit: confirm wins
        (dict(windows=4, subside_streak=2), (20.0, 20.0, 1.0, 1.0),
         ("pending", "pending", "pending", "confirmed")),
    ], ids=["confirms_on_sustained_subsidence", "rolls_back_when_budget_exhausted",
            "hysteresis_bounce_resets_streak", "last_window_subsidence_still_confirms"])
    def test_verdicts(self, policy, burns, want):
        def run(s):
            p, state = s.rem.VerifyPolicy(**policy), s.rem.VerifyState()
            seen = []
            for burn in burns:
                seen.append((s.rem.observe_window(p, state, burn), state.windows_seen,
                             state.streak))
            assert tuple(v for v, _, _ in seen) == want
            return seen

        both(run)


# ---------------------------------------------------------------------------
# engine: state machine, restart parity, provenance
# ---------------------------------------------------------------------------


def _engine(s, where, **kw):
    burn = s.slo.BurnEngine(s.slo.EngineConfig())
    engine = s.rem.RemediationEngine(
        bindings=s.rem.ActionBindings(burn_engine=burn),
        verify=s.rem.VerifyPolicy(windows=4, subside_streak=2),
        provenance_log=s.prov.ProvenanceLog(os.fspath(where / "provenance.jsonl")),
        **kw,
    )
    return engine, burn


def _observe(engine, where=None) -> dict:
    """An engine's outcome as plain data: its records, exported state,
    snapshot counters and (when it logs) the provenance file's bytes."""
    out = {"records": [r.to_dict() for r in engine.records()],
           "state": engine.export_state(), "snapshot": engine.snapshot()}
    if where is not None:
        engine._provenance_log.close()
        path = where / "provenance.jsonl"
        out["provenance"] = path.read_bytes() if path.exists() else b""
    return out


class TestEngine:
    def test_consider_applies_and_verifies(self, tmp_path):
        def run(s, where):
            engine, burn = _engine(s, where)
            rec = engine.consider(_ctx(s), now_s=100.0)
            assert rec is not None and rec.phase == s.rem.PHASE_VERIFYING
            assert burn.demoted_tenants() == ["tenant-a"]
            assert engine.in_flight() == 1
            resolved = []
            for _ in range(3):
                resolved += engine.tick(200.0, lambda r: 0.0)
            assert [r.phase for r in resolved] == [s.rem.PHASE_CONFIRMED]
            assert engine.in_flight() == 0
            assert burn.demoted_tenants() == ["tenant-a"]  # stays applied
            return _observe(engine, where)

        both(run, tmp_path)

    def test_failed_verify_rolls_back_and_escalates(self, tmp_path):
        def run(s, where):
            engine, burn = _engine(s, where)
            engine.consider(_ctx(s), now_s=0.0)
            resolved = []
            for i in range(5):
                resolved += engine.tick(float(i), lambda r: 50.0)
            assert [r.phase for r in resolved] == [s.rem.PHASE_ROLLED_BACK]
            assert resolved[0].escalated
            assert burn.demoted_tenants() == []
            return _observe(engine, where)

        both(run, tmp_path)

    def test_same_incident_never_acts_twice(self, tmp_path):
        def run(s, where):
            engine, _ = _engine(s, where)
            assert engine.consider(_ctx(s), now_s=0.0) is not None
            assert engine.consider(_ctx(s), now_s=10_000.0) is None
            assert engine.counters.applied == 1
            return _observe(engine, where)

        both(run, tmp_path)

    def test_unbound_substrate_is_apply_failed(self):
        def run(s):
            engine = s.rem.RemediationEngine(bindings=s.rem.ActionBindings(),
                                             provenance_log=None)
            rec = engine.consider(_ctx(s), now_s=0.0)
            assert rec is not None and rec.phase == s.rem.PHASE_APPLY_FAILED
            assert engine.in_flight() == 0
            return _observe(engine)

        both(run)

    def test_export_restore_parity_with_uninterrupted_run(self, tmp_path):
        """The restart run's records equal the uninterrupted run's,
        transition for transition, on both sides."""
        def drive(s, engine, burn_seq, kill_at=None):
            engine.consider(_ctx(s), now_s=0.0)
            out = []
            for i, burn_rate in enumerate(burn_seq):
                if i == kill_at:
                    state = engine.export_state()
                    burn2 = s.slo.BurnEngine(s.slo.EngineConfig())
                    burn2.restore_state(engine.bindings.burn_engine.export_state())
                    engine = s.rem.RemediationEngine(
                        bindings=s.rem.ActionBindings(burn_engine=burn2),
                        verify=engine.verify)
                    engine.restore_state(state)
                out += engine.tick(float(i + 1), lambda r: burn_rate)
            return engine, out

        def run(s, where):
            burn_seq = [20.0, 2.0, 1.0, 0.5]
            (where / "a").mkdir()
            (where / "b").mkdir()
            eng_a, resolved_a = drive(s, _engine(s, where / "a")[0], burn_seq)
            eng_b, resolved_b = drive(s, _engine(s, where / "b")[0], burn_seq, kill_at=2)
            assert [r.to_dict() for r in resolved_a] == [r.to_dict() for r in resolved_b]
            assert eng_b.counters.applied == 1
            assert eng_b.counters.interrupted == 0
            return [r.to_dict() for r in resolved_b], eng_b.export_state()

        both(run, tmp_path)

    def test_interrupted_mid_apply_rolls_back_never_reapplies(self, tmp_path):
        def run(s, where):
            engine, burn = _engine(s, where)
            aid = s.rem.action_id_for("inc-1", s.rem.ACTION_DEMOTE_TENANT, "tenant-a")
            engine.restore_state({
                "version": 1,
                "records": [s.rem.ActionRecord(
                    action_id=aid, incident_id="inc-1", kind=s.rem.ACTION_DEMOTE_TENANT,
                    target="tenant-a", phase=s.rem.PHASE_APPLYING).to_dict()],
                "policy": {},
                "counters": {},
            })
            rec = engine._records[aid]
            assert rec.phase == s.rem.PHASE_ROLLED_BACK
            assert rec.escalated
            assert engine.counters.interrupted == 1
            # The demotion never happened; rollback must not invent one.
            assert burn.demoted_tenants() == []
            # The id guard refuses the same decision forever.
            assert engine.consider(_ctx(s), now_s=10_000.0) is None
            return _observe(engine, where)

        both(run, tmp_path)

    def test_provenance_chain_records_full_lifecycle(self, tmp_path):
        def run(s, where):
            engine, _ = _engine(s, where)
            base = s.prov.ProvenanceRecord(incident_id="inc-1",
                                           predicted_fault_domain="tpu_hbm", confidence=0.95)
            engine.consider(_ctx(s), now_s=0.0, provenance=base)
            for i in range(3):
                engine.tick(float(i + 1), lambda r: 0.0)
            chains = s.prov.load_records(os.fspath(where / "provenance.jsonl"))
            rec = chains["inc-1"]
            assert rec.predicted_fault_domain == "tpu_hbm"
            assert len(rec.remediation) == 1
            entry = rec.remediation[0]
            assert entry["kind"] == s.rem.ACTION_DEMOTE_TENANT
            assert entry["phase"] == s.rem.PHASE_CONFIRMED
            assert entry["verdict"] == s.rem.VERDICT_CONFIRMED
            text = s.prov.format_chain(rec)
            assert "remediation" in text
            assert "demote_tenant" in text
            return text, _observe(engine, where)

        both(run, tmp_path)

    def test_synthesized_provenance_without_base_record(self, tmp_path):
        def run(s, where):
            engine, _ = _engine(s, where)
            engine.consider(_ctx(s), now_s=0.0)
            chains = s.prov.load_records(os.fspath(where / "provenance.jsonl"))
            assert chains["inc-1"].remediation[0]["phase"] == s.rem.PHASE_VERIFYING
            return _observe(engine, where)

        both(run, tmp_path)

    def test_observer_bridge_counts(self, tmp_path):
        def run(s, where):
            calls = []

            class Obs:
                def applied(self, action):
                    calls.append(("applied", action))

                def rolled_back(self, action):
                    calls.append(("rolled_back", action))

                def verify_outcome(self, outcome):
                    calls.append(("verify", outcome))

                def in_flight(self, count):
                    calls.append(("in_flight", count))

                def refused(self, reason):
                    calls.append(("refused", reason))

            engine, _ = _engine(s, where, observer=Obs())
            engine.consider(_ctx(s, burn_state="ok"), now_s=0.0)
            engine.consider(_ctx(s), now_s=0.0)
            for i in range(5):
                engine.tick(float(i), lambda r: 50.0)
            kinds = [c[0] for c in calls]
            assert "refused" in kinds
            assert ("applied", s.rem.ACTION_DEMOTE_TENANT) in calls
            assert ("verify", s.rem.VERDICT_ROLLBACK) in calls
            assert ("rolled_back", s.rem.ACTION_DEMOTE_TENANT) in calls
            return calls

        both(run, tmp_path)

    def test_terminal_records_pruned_past_retention(self):
        def run(s):
            burn = s.slo.BurnEngine(s.slo.EngineConfig(max_tenants=2048))
            engine = s.rem.RemediationEngine(
                policy=s.rem.RemediationPolicy(
                    rules=s.rem.default_rules(cooldown_s=0.0, rate_limit=100_000,
                                              rate_window_s=1.0),
                    max_concurrent_actions=1),
                bindings=s.rem.ActionBindings(burn_engine=burn),
                verify=s.rem.VerifyPolicy(windows=2, subside_streak=1),
            )
            total = s.engine.MAX_TERMINAL_RECORDS + 40
            for i in range(total):
                rec = engine.consider(_ctx(s, incident=f"inc-{i:04d}", tenant=f"t-{i:04d}"),
                                      now_s=float(i))
                assert rec is not None
                engine.tick(float(i), lambda r: 0.0)  # instant confirm
            assert len(engine.records()) == s.engine.MAX_TERMINAL_RECORDS
            ids = {r.action_id for r in engine.records()}
            assert s.rem.action_id_for("inc-0000", s.rem.ACTION_DEMOTE_TENANT, "t-0000") not in ids
            assert s.rem.action_id_for(f"inc-{total - 1:04d}", s.rem.ACTION_DEMOTE_TENANT,
                                       f"t-{total - 1:04d}") in ids
            assert engine.counters.applied == total
            return _observe(engine)

        both(run)

    def test_snapshot_counters(self, tmp_path):
        def run(s, where):
            engine, _ = _engine(s, where)
            engine.consider(_ctx(s), now_s=0.0)
            snap = engine.snapshot()
            assert snap["applied"] == 1
            assert snap["in_flight"] == 1
            return snap

        both(run, tmp_path)

    @pytest.mark.parametrize("src,dst", [(J, T), (T, J)], ids=["jax-to-port", "port-to-jax"])
    def test_an_exported_engine_continues_across_the_packages(self, tmp_path, src, dst):
        """A JAX engine's state (mid-verify, with its burn engine's)
        restored into the port's continues with the records the JAX
        engine would have produced; and the reverse."""
        burn_seq = [20.0, 2.0, 1.0, 0.5]

        def start(s, where):
            engine, _ = _engine(s, where)
            engine.consider(_ctx(s), now_s=0.0)
            engine.tick(1.0, lambda r: burn_seq[0])
            return engine

        (tmp_path / "ref").mkdir()
        (tmp_path / "src").mkdir()
        (tmp_path / "dst").mkdir()
        ref = start(src, tmp_path / "ref")
        for i, rate in enumerate(burn_seq[1:], 1):
            ref.tick(float(i + 1), lambda r: rate)

        crashed = start(src, tmp_path / "src")
        state = json.loads(json.dumps(crashed.export_state()))
        burn_state = json.loads(json.dumps(crashed.bindings.burn_engine.export_state()))
        engine, burn = _engine(dst, tmp_path / "dst")
        burn.restore_state(burn_state)
        engine.restore_state(state)
        for i, rate in enumerate(burn_seq[1:], 1):
            engine.tick(float(i + 1), lambda r: rate)
        assert [r.to_dict() for r in engine.records()] == [r.to_dict() for r in ref.records()]
        assert engine.export_state() == ref.export_state()
        assert burn.demoted_tenants() == ["tenant-a"]


# ---------------------------------------------------------------------------
# wiring that needs no fleet
# ---------------------------------------------------------------------------


class TestWiring:
    def test_default_rules_cover_known_domains_only(self):
        def run(s):
            known = {s.mapper.map_fault_label(label) for label in (
                "hbm_pressure", "network_partition", "dns_latency", "cpu_throttle",
                "xla_recompile_storm", "ici_drop", "host_offload_stall")}
            domains = [rule.domain for rule in s.rem.default_rules()]
            assert set(domains) <= known
            return domains

        both(run)

    def test_the_hot_path_functions_are_the_ported_ones(self):
        """The JAX package registers the remediation evaluate path in
        its hot-path manifest; the port keeps each of those functions
        and dataclasses, under the same qualified name, in the same
        module of its own copy."""
        from tpuslo.analysis.hotpaths import HOT_DATACLASSES, HOT_FUNCTIONS

        def defined(path: Path) -> set[str]:
            names = set()
            for node in ast.parse(path.read_text()).body:
                if isinstance(node, ast.ClassDef):
                    names.add(node.name)
                    names.update(f"{node.name}.{f.name}" for f in node.body
                                 if isinstance(f, ast.FunctionDef))
                elif isinstance(node, ast.FunctionDef):
                    names.add(node.name)
            return names

        wanted = [(rel, qn) for rel, qn in (*HOT_FUNCTIONS, *HOT_DATACLASSES)
                  if rel.startswith("tpuslo/remediation/")]
        assert {qn for _, qn in wanted} >= {
            "RemediationPolicy.decide", "RemediationEngine.consider",
            "RemediationEngine.tick", "observe_window", "ActionRecord",
            "AttributionContext"}
        for rel, qn in wanted:
            port = ROOT / rel.replace("tpuslo/", "tpuslo_torch/", 1)
            assert qn in defined(port), (rel, qn)
