"""RemediationEngine: observe → attribute → remediate → verify
(the port's own copy of ``tpuslo/remediation/engine.py``: plain Python, behaviour identical).

One engine per agent (or fleet controller).  ``consider()`` takes one
attribution-plus-burn context, runs the policy, and — on a decision —
applies the bound action; ``tick()`` advances every in-flight
verification one evaluation window and settles confirm / rollback.
Both run on the caller's clock (``now_s`` arrives as a parameter, like
the burn engine) so the sweep drives hours of event time in
milliseconds and a restarted agent never misreads a monotonic stamp.

Crash safety is the load-bearing contract:

* the action record is registered (and exportable) **before** apply is
  attempted, keyed by a deterministic id derived from the incident —
  a restarted engine that sees the id again refuses to re-apply, so a
  mid-sweep kill can never double-apply one decision;
* a record restored in the ``applying`` phase is treated as
  *interrupted mid-apply*: the engine cannot know whether the lever
  moved, so it rolls the action back and escalates — the conservative
  reading (rollbacks are designed to be safe on an un-applied target:
  every action's rollback refuses cleanly when there is nothing to
  undo);
* records restored in ``verifying`` resume their window/streak
  counters exactly where the snapshot left them.

Every phase change appends the full provenance record for the
triggering incident (which attribution acted, what the action did,
what the verifier concluded) — ``sloctl explain`` renders the chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from tpuslo_torch.obs.provenance import ProvenanceLog, ProvenanceRecord
from tpuslo_torch.remediation.actions import Action, ActionBindings
from tpuslo_torch.remediation.policy import (
    AttributionContext,
    RemediationPolicy,
)
from tpuslo_torch.remediation.verifier import (
    VERDICT_CONFIRMED,
    VERDICT_PENDING,
    VERDICT_ROLLBACK,
    VerifyPolicy,
    VerifyState,
    observe_window,
)

STATE_VERSION = 1

# Action-record phases.
PHASE_APPLYING = "applying"
PHASE_VERIFYING = "verifying"
PHASE_CONFIRMED = "confirmed"
PHASE_ROLLED_BACK = "rolled_back"
PHASE_APPLY_FAILED = "apply_failed"
PHASE_ROLLBACK_FAILED = "rollback_failed"

#: Phases with no further transitions.
TERMINAL_PHASES = (
    PHASE_CONFIRMED,
    PHASE_ROLLED_BACK,
    PHASE_APPLY_FAILED,
    PHASE_ROLLBACK_FAILED,
)

#: Retention for settled action records.  A long-running agent must
#: not grow its per-cycle scans and durable snapshot without bound,
#: so the oldest terminal records (and their provenance bases) are
#: pruned past this depth.  Deep enough that a re-delivered
#: attribution still hits the action-id dedup guard for any plausible
#: re-delivery window; past it, the per-(action, target) cooldowns
#: still damp repeats.  In-flight records are never pruned.
MAX_TERMINAL_RECORDS = 256


class RemediationObserver:
    """No-op observer; the agent bridges these to Prometheus."""

    def applied(self, action: str) -> None: ...

    def rolled_back(self, action: str) -> None: ...

    def verify_outcome(self, outcome: str) -> None: ...

    def in_flight(self, count: int) -> None: ...

    def refused(self, reason: str) -> None: ...


@dataclass(slots=True)
class ActionRecord:
    """One remediation decision's full lifecycle."""

    action_id: str
    incident_id: str
    kind: str
    target: str
    phase: str = PHASE_APPLYING
    verdict: str = VERDICT_PENDING
    detail: str = ""
    applied_at_s: float = 0.0
    resolved_at_s: float = 0.0
    windows_seen: int = 0
    streak: int = 0
    #: True when the loop gave up and paged a human (verify failed or
    #: the apply was interrupted by a crash).
    escalated: bool = False
    domain: str = ""
    confidence: float = 0.0
    burn_state: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "action_id": self.action_id,
            "incident_id": self.incident_id,
            "kind": self.kind,
            "target": self.target,
            "phase": self.phase,
            "verdict": self.verdict,
            "detail": self.detail,
            "applied_at_s": self.applied_at_s,
            "resolved_at_s": self.resolved_at_s,
            "windows_seen": self.windows_seen,
            "streak": self.streak,
            "escalated": self.escalated,
            "domain": self.domain,
            "confidence": self.confidence,
            "burn_state": self.burn_state,
        }

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "ActionRecord":
        return cls(
            action_id=str(raw.get("action_id", "")),
            incident_id=str(raw.get("incident_id", "")),
            kind=str(raw.get("kind", "")),
            target=str(raw.get("target", "")),
            phase=str(raw.get("phase", PHASE_APPLYING)),
            verdict=str(raw.get("verdict", VERDICT_PENDING)),
            detail=str(raw.get("detail", "")),
            applied_at_s=float(raw.get("applied_at_s", 0.0)),
            resolved_at_s=float(raw.get("resolved_at_s", 0.0)),
            windows_seen=int(raw.get("windows_seen", 0)),
            streak=int(raw.get("streak", 0)),
            escalated=bool(raw.get("escalated", False)),
            domain=str(raw.get("domain", "")),
            confidence=float(raw.get("confidence", 0.0)),
            burn_state=str(raw.get("burn_state", "")),
        )


def action_id_for(incident_id: str, kind: str, target: str) -> str:
    """Deterministic id: one (incident, action, target) acts once —
    across restarts, across re-considered attributions, across a
    mid-sweep kill."""
    return f"rem-{incident_id}-{kind}-{target}"


@dataclass
class EngineCounters:
    applied: int = 0
    apply_failed: int = 0
    confirmed: int = 0
    rolled_back: int = 0
    rollback_failed: int = 0
    interrupted: int = 0

    def to_dict(self) -> dict[str, int]:
        return {
            "applied": self.applied,
            "apply_failed": self.apply_failed,
            "confirmed": self.confirmed,
            "rolled_back": self.rolled_back,
            "rollback_failed": self.rollback_failed,
            "interrupted": self.interrupted,
        }


class RemediationEngine:
    """The action loop's state machine."""

    def __init__(
        self,
        policy: RemediationPolicy | None = None,
        bindings: ActionBindings | None = None,
        verify: VerifyPolicy | None = None,
        observer: RemediationObserver | None = None,
        provenance_log: ProvenanceLog | None = None,
        log: Callable[[str], None] | None = None,
    ):
        self.policy = policy or RemediationPolicy()
        self.bindings = bindings or ActionBindings()
        self.verify = verify or VerifyPolicy()
        self._observer = observer or RemediationObserver()
        self._provenance_log = provenance_log
        self._log = log or (lambda msg: None)
        #: action_id -> record, insertion-ordered (action history).
        self._records: dict[str, ActionRecord] = {}
        #: action_id -> live Action (rebuilt lazily after restore).
        self._actions: dict[str, Action] = {}
        #: incident_id -> base provenance record to extend.
        self._provenance: dict[str, ProvenanceRecord] = {}
        self.counters = EngineCounters()

    # ---- observe → attribute → remediate ------------------------------

    def in_flight(self) -> int:
        return sum(
            1
            for rec in self._records.values()
            if rec.phase not in TERMINAL_PHASES
        )

    def consider(
        self,
        ctx: AttributionContext,
        now_s: float,
        provenance: ProvenanceRecord | None = None,
    ) -> ActionRecord | None:
        """Decide + apply for one attribution; None when holding fire.

        Registered in the hot-path manifest (one call per attributed
        incident): the decision path is dict/deque arithmetic, and the
        apply itself only runs for the rare context that passes every
        gate.
        """
        decision = self.policy.decide(ctx, now_s, self.in_flight())
        if decision is None:
            self._observer.refused(self.policy.last_refusal or "no_rule")
            return None
        action_id = action_id_for(
            ctx.incident_id, decision.action, decision.target
        )
        if action_id in self._records:
            # The same decision resolved (or is resolving) already —
            # a re-delivered attribution must not act twice.
            return None
        rec = ActionRecord(
            action_id=action_id,
            incident_id=ctx.incident_id,
            kind=decision.action,
            target=decision.target,
            phase=PHASE_APPLYING,
            applied_at_s=now_s,
            domain=ctx.domain,
            confidence=ctx.confidence,
            burn_state=ctx.burn_state,
        )
        # Registered BEFORE apply: a crash between here and the apply
        # restores as "interrupted mid-apply" and rolls back — never
        # re-applies.
        self._records[action_id] = rec
        if provenance is not None:
            self._provenance[ctx.incident_id] = provenance
        action = self.bindings.build(decision.action, decision.target)
        if action is None:
            rec.phase = PHASE_APPLY_FAILED
            rec.resolved_at_s = now_s
            rec.detail = f"no substrate bound for {decision.action}"
            self.counters.apply_failed += 1
            self._finish(rec)
            return rec
        self._actions[action_id] = action
        result = action.apply()
        if not result.ok:
            rec.phase = PHASE_APPLY_FAILED
            rec.resolved_at_s = now_s
            rec.detail = result.detail
            self.counters.apply_failed += 1
            self._finish(rec)
            return rec
        rec.phase = PHASE_VERIFYING
        rec.detail = result.detail
        self.policy.note_applied(decision.action, decision.target, now_s)
        self.counters.applied += 1
        self._observer.applied(decision.action)
        self._observer.in_flight(self.in_flight())
        self._record_provenance(rec)
        return rec

    # ---- verify --------------------------------------------------------

    def tick(
        self,
        now_s: float,
        burn_lookup: Callable[[ActionRecord], float],
    ) -> list[ActionRecord]:
        """Advance every in-flight verification one evaluation window.

        ``burn_lookup`` maps an action record to the current burn
        evidence for its target (the engine does not know whether the
        caller watches a tenant objective, a node's signal profile, or
        a synthetic sweep trace).  Returns the records that settled
        this tick.  Registered in the hot-path manifest: per in-flight
        action arithmetic plus at most one rollback call.
        """
        resolved: list[ActionRecord] = []
        # Snapshot: settling a record prunes old terminal records from
        # the same dict.
        for rec in list(self._records.values()):
            if rec.phase != PHASE_VERIFYING:
                continue
            state = VerifyState(
                windows_seen=rec.windows_seen, streak=rec.streak
            )
            verdict = observe_window(
                self.verify, state, burn_lookup(rec)
            )
            rec.windows_seen = state.windows_seen
            rec.streak = state.streak
            if verdict == VERDICT_PENDING:
                continue
            rec.verdict = verdict
            rec.resolved_at_s = now_s
            if verdict == VERDICT_CONFIRMED:
                rec.phase = PHASE_CONFIRMED
                self.counters.confirmed += 1
            else:
                self._rollback(rec, "verify window budget exhausted")
            self._observer.verify_outcome(verdict)
            resolved.append(rec)
            self._finish(rec)
        if resolved:
            self._observer.in_flight(self.in_flight())
        return resolved

    def _rollback(self, rec: ActionRecord, why: str) -> None:
        """Roll one applied action back; escalate regardless of how
        the rollback itself goes (the loop gave up either way)."""
        rec.escalated = True
        action = self._actions.get(rec.action_id)
        if action is None:
            # Post-restore: rebuild the binding fresh.
            action = self.bindings.build(rec.kind, rec.target)
        if action is None:
            rec.phase = PHASE_ROLLBACK_FAILED
            rec.detail = f"{why}; no substrate bound for rollback"
            self.counters.rollback_failed += 1
            return
        result = action.rollback()
        if result.ok:
            rec.phase = PHASE_ROLLED_BACK
            rec.detail = f"{why}; {result.detail}"
            self.counters.rolled_back += 1
            self._observer.rolled_back(rec.kind)
        else:
            rec.phase = PHASE_ROLLBACK_FAILED
            rec.detail = f"{why}; rollback failed: {result.detail}"
            self.counters.rollback_failed += 1

    def _finish(self, rec: ActionRecord) -> None:
        self._actions.pop(rec.action_id, None)
        self._record_provenance(rec)
        self._prune_terminal()

    def _prune_terminal(self) -> None:
        """Drop the oldest settled records past the retention depth."""
        terminal = [
            aid
            for aid, rec in self._records.items()
            if rec.phase in TERMINAL_PHASES
        ]
        for aid in terminal[: max(0, len(terminal) - MAX_TERMINAL_RECORDS)]:
            dropped = self._records.pop(aid)
            if not any(
                rec.incident_id == dropped.incident_id
                for rec in self._records.values()
            ):
                self._provenance.pop(dropped.incident_id, None)

    # ---- provenance ----------------------------------------------------

    def _record_provenance(self, rec: ActionRecord) -> None:
        """Re-record the incident's full chain with the action history.

        The provenance log is last-record-wins per incident, so the
        whole base record rides along — a remediated incident's chain
        always reads attribution evidence AND action outcome together.
        """
        base = self._provenance.get(rec.incident_id)
        if base is None:
            base = ProvenanceRecord(
                incident_id=rec.incident_id,
                predicted_fault_domain=rec.domain,
                confidence=rec.confidence,
            )
            self._provenance[rec.incident_id] = base
        actions = [
            r.to_dict()
            for r in self._records.values()
            if r.incident_id == rec.incident_id
        ]
        base.remediation = actions
        if self._provenance_log is not None:
            try:
                self._provenance_log.record(base)
            except OSError as exc:
                self._log(f"remediation: provenance write failed: {exc!r}")

    # ---- introspection -------------------------------------------------

    def records(self) -> list[ActionRecord]:
        """Action history, decision order."""
        return list(self._records.values())

    def snapshot(self) -> dict[str, Any]:
        """Stats-line counters."""
        return {
            "in_flight": self.in_flight(),
            **self.counters.to_dict(),
            "refused": dict(self.policy.refusals),
        }

    # ---- snapshot / restore (crash-safe runtime) -----------------------

    def export_state(self) -> dict[str, Any]:
        return {
            "version": STATE_VERSION,
            "records": [rec.to_dict() for rec in self._records.values()],
            "policy": self.policy.export_state(),
            "counters": self.counters.to_dict(),
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        if not isinstance(state, dict):
            return
        if int(state.get("version", -1)) != STATE_VERSION:
            return
        self._records = {}
        self._actions = {}
        interrupted: list[ActionRecord] = []
        for raw in state.get("records") or []:
            if not isinstance(raw, dict):
                continue
            rec = ActionRecord.from_dict(raw)
            if not rec.action_id:
                continue
            self._records[rec.action_id] = rec
            if rec.phase == PHASE_APPLYING:
                interrupted.append(rec)
        self.policy.restore_state(state.get("policy") or {})
        counters = state.get("counters") or {}
        self.counters = EngineCounters(
            applied=int(counters.get("applied", 0)),
            apply_failed=int(counters.get("apply_failed", 0)),
            confirmed=int(counters.get("confirmed", 0)),
            rolled_back=int(counters.get("rolled_back", 0)),
            rollback_failed=int(counters.get("rollback_failed", 0)),
            interrupted=int(counters.get("interrupted", 0)),
        )
        # Interrupted mid-apply: the previous incarnation died between
        # registering the record and finishing apply().  Whether the
        # lever moved is unknowable, so roll back (safe on un-applied
        # targets) and escalate — never re-apply.
        for rec in interrupted:
            rec.verdict = VERDICT_ROLLBACK
            self.counters.interrupted += 1
            self._rollback(rec, "interrupted mid-apply on restart")
            self._observer.verify_outcome(rec.verdict)
            self._finish(rec)
