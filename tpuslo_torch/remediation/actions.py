"""Remediation actions: reversible operations over existing machinery
(the port's own copy of ``tpuslo/remediation/actions.py``: plain Python, behaviour identical).

Every action is a thin, *typed* wrapper over a subsystem the toolkit
already trusts — probe shed/restore rides the overhead-guard shed
lists, breaker trips ride the delivery circuit breaker, drain +
snapshot rides the crash-safe runtime, and the fleet-level actions ride
the hash ring / aggregator shards / burn engine.  The engine never
learns those subsystems' shapes: it sees ``apply()`` / ``rollback()``
and an :class:`ActionResult`.

The contract every action honors:

* **apply is idempotent at the engine level** — the engine registers an
  action id before calling apply and never constructs the same id
  twice, so a crash between registration and apply resolves to a
  rollback, not a double apply;
* **rollback undoes apply** — byte-for-byte where the substrate allows
  (uncordon restores the identical ring placement; restore_tenant
  returns the default admission priority), best-effort-and-honest
  where it does not (a drain hand-off has nothing to undo);
* **ownership is explicit** — a probe shed claims the signal in the
  :class:`~tpuslo_torch.safety.ShedOwnership` ledger so the overhead-guard
  recovery streak cannot restore it out from under the verifier, and a
  remediation restore defers to the supervisor's flap hold-down.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from tpuslo_torch.safety.recovery import OWNER_REMEDIATION, ShedOwnership

# Action kinds (policy rules name these; metrics label on them).
ACTION_PROBE_SHED = "probe_shed"
ACTION_BREAKER_TRIP = "breaker_trip"
ACTION_DRAIN_SNAPSHOT = "drain_snapshot"
ACTION_CORDON_NODE = "cordon_node"
ACTION_REHOME_SLICE = "rehome_slice"
ACTION_DEMOTE_TENANT = "demote_tenant"

ALL_ACTION_KINDS = (
    ACTION_PROBE_SHED,
    ACTION_BREAKER_TRIP,
    ACTION_DRAIN_SNAPSHOT,
    ACTION_CORDON_NODE,
    ACTION_REHOME_SLICE,
    ACTION_DEMOTE_TENANT,
)


@dataclass(slots=True)
class ActionResult:
    """Outcome of one apply/rollback attempt."""

    ok: bool
    detail: str = ""


class Action:
    """Protocol-shaped base: one reversible remediation operation."""

    kind: str = ""

    def __init__(self, target: str):
        self.target = target

    def apply(self) -> ActionResult:  # pragma: no cover - interface
        raise NotImplementedError

    def rollback(self) -> ActionResult:  # pragma: no cover - interface
        raise NotImplementedError


class ProbeShedAction(Action):
    """Shed one probe signal through the existing shed-list machinery.

    ``manager`` is duck-typed over ``signals.Generator`` and
    ``collector.ProbeManager`` (both expose ``import_shed`` /
    ``restore_signal`` / ``shed_signals``).  The shed claims the signal
    in the ownership ledger; rollback defers to the supervisor's flap
    hold-down — a probe the supervisor proved unstable stays down even
    when the remediation that shed it is withdrawn (the claim is
    released so the supervisor's own machinery takes over).
    """

    kind = ACTION_PROBE_SHED

    def __init__(
        self,
        signal: str,
        manager: Any,
        ownership: ShedOwnership | None = None,
        supervisor: Any = None,
    ):
        super().__init__(signal)
        self._manager = manager
        self._ownership = ownership
        self._supervisor = supervisor

    def _shed_list(self) -> list[str]:
        shed = self._manager.shed_signals
        return list(shed() if callable(shed) else shed)

    def apply(self) -> ActionResult:
        signal = self.target
        if (
            self._ownership is not None
            and not self._ownership.claim(signal, OWNER_REMEDIATION)
        ):
            return ActionResult(
                False,
                f"signal {signal} already shed by "
                f"{self._ownership.owner_of(signal)!r}",
            )
        if signal in self._shed_list():
            # Shed by an untagged policy before ownership existed;
            # adopting it would make rollback restore someone else's
            # shed, so refuse and release the claim.
            if self._ownership is not None:
                self._ownership.release(signal, OWNER_REMEDIATION)
            return ActionResult(False, f"signal {signal} already shed")
        imported = self._manager.import_shed([signal])
        if signal not in imported:
            if self._ownership is not None:
                self._ownership.release(signal, OWNER_REMEDIATION)
            return ActionResult(
                False, f"signal {signal} unknown or not sheddable"
            )
        return ActionResult(True, f"shed probe {signal}")

    def rollback(self) -> ActionResult:
        signal = self.target
        if self._supervisor is not None and not self._supervisor.may_restore(
            signal
        ):
            # Flap hold-down outranks the rollback: leave the probe
            # shed, hand the signal to the supervisor's machinery.
            if self._ownership is not None:
                self._ownership.release(signal, OWNER_REMEDIATION)
            return ActionResult(
                True, f"restore of {signal} held down (flapping); left shed"
            )
        restored = bool(self._manager.restore_signal(signal))
        if self._ownership is not None:
            self._ownership.release(signal, OWNER_REMEDIATION)
        if restored:
            return ActionResult(True, f"restored probe {signal}")
        if signal not in self._shed_list():
            # Ensure-undone semantics: the probe is not shed (the apply
            # this rollback undoes never landed, e.g. an interrupted
            # mid-apply restore) — the lever is already in its
            # pre-apply state.
            return ActionResult(
                True, f"probe {signal} was not shed (nothing to undo)"
            )
        return ActionResult(
            False, f"signal {signal} could not be restored"
        )


class BreakerTripAction(Action):
    """Trip (and on rollback reset) a sink family's circuit breakers.

    A target names either one breaker exactly or a sink *family*: the
    agent's OTLP path runs one delivery channel per payload kind
    (``otlp-slo`` / ``otlp-probe`` / ``otlp-traces``), and a
    network-fault remediation must take the whole path offline, not
    one third of it.  ``breakers`` carries every resolved member.
    """

    kind = ACTION_BREAKER_TRIP

    def __init__(
        self,
        sink: str,
        breaker: Any = None,
        breakers: list[Any] | None = None,
    ):
        super().__init__(sink)
        self._breakers = (
            list(breakers) if breakers else [breaker]
        )

    def apply(self) -> ActionResult:
        for breaker in self._breakers:
            breaker.force_open()
        return ActionResult(
            True,
            f"tripped {len(self._breakers)} breaker(s) for sink "
            f"{self.target}",
        )

    def rollback(self) -> ActionResult:
        for breaker in self._breakers:
            breaker.force_close()
        return ActionResult(
            True,
            f"reset {len(self._breakers)} breaker(s) for sink "
            f"{self.target}",
        )


class DrainSnapshotAction(Action):
    """Snapshot durable state, then run the caller's drain steps.

    ``runtime`` is an :class:`~tpuslo_torch.runtime.AgentRuntime`;
    ``drain_steps`` is the ordered ``[(name, fn(budget_s) -> ok)]``
    list the drain controller runs (the same shapes the SIGTERM path
    uses).  The snapshot lands *first* so the hand-off state is durable
    even when a flush step overruns.  Rollback is a recorded no-op: a
    drain hand-off moves work, it does not destroy it — there is
    nothing to un-move, and saying so honestly beats pretending.
    """

    kind = ACTION_DRAIN_SNAPSHOT

    def __init__(
        self,
        target: str,
        runtime: Any,
        drain_steps: list[tuple[str, Callable[[float], object]]]
        | None = None,
        deadline_s: float = 10.0,
    ):
        super().__init__(target)
        self._runtime = runtime
        self._drain_steps = list(drain_steps or [])
        self._deadline_s = deadline_s

    def apply(self) -> ActionResult:
        from tpuslo_torch.runtime.drain import DRAIN_CLEAN, DrainController

        if self._runtime is not None and self._runtime.enabled:
            if not self._runtime.snapshot_now():
                return ActionResult(False, "snapshot for hand-off failed")
        controller = DrainController(
            reason="remediation", deadline_s=self._deadline_s
        )
        for name, fn in self._drain_steps:
            controller.step(name, fn)
        report = controller.finish()
        ok = report.outcome == DRAIN_CLEAN
        return ActionResult(
            ok, f"drain+snapshot hand-off: {report.summary()}"
        )

    def rollback(self) -> ActionResult:
        return ActionResult(
            True, "drain hand-off is one-way; nothing to undo"
        )


class CordonNodeAction(Action):
    """Cordon one (node, slice) arc out of the fleet hash ring."""

    kind = ACTION_CORDON_NODE

    def __init__(self, node: str, slice_id: str, ring: Any):
        super().__init__(f"{node}|{slice_id}")
        self._node = node
        self._slice_id = slice_id
        self._ring = ring

    def apply(self) -> ActionResult:
        if not self._ring.cordon(self._node, self._slice_id):
            return ActionResult(
                False, f"{self.target} already cordoned"
            )
        return ActionResult(True, f"cordoned {self.target} from the ring")

    def rollback(self) -> ActionResult:
        if not self._ring.uncordon(self._node, self._slice_id):
            # Ensure-undone: the arc is not cordoned, which IS the
            # rollback's goal state (interrupted-mid-apply restores
            # roll back actions that may never have landed).
            return ActionResult(
                True, f"{self.target} was not cordoned (nothing to undo)"
            )
        return ActionResult(True, f"uncordoned {self.target}")


def rehome_slice(source: Any, target: Any, slice_id: str) -> int:
    """Move one slice's node fragments between aggregator shards.

    Exports the source shard's per-node state, absorbs the fragments
    whose ``slice_id`` matches onto the target (the same
    ``absorb_node_state`` path shard failover uses), and drops them
    from the source — reporting state AND pending evidence groups
    (``drop_node``), so the slice's windows are aggregated and
    emitted in exactly one place.  Returns the number of nodes
    re-homed.
    """
    exported = source.export_state()
    moved = 0
    for node, fragment in (exported.get("nodes") or {}).items():
        if str(fragment.get("slice_id", "")) != slice_id:
            continue
        target.absorb_node_state(node, fragment)
        source.drop_node(node)
        moved += 1
    return moved


class RehomeSliceAction(Action):
    """Re-home one slice's aggregation from a struggling shard."""

    kind = ACTION_REHOME_SLICE

    def __init__(self, slice_id: str, source: Any, target_shard: Any):
        super().__init__(slice_id)
        self._source = source
        self._target_shard = target_shard

    def apply(self) -> ActionResult:
        moved = rehome_slice(self._source, self._target_shard, self.target)
        if moved == 0:
            return ActionResult(
                False, f"no nodes of slice {self.target} on source shard"
            )
        return ActionResult(
            True, f"re-homed {moved} node(s) of slice {self.target}"
        )

    def rollback(self) -> ActionResult:
        moved = rehome_slice(self._target_shard, self._source, self.target)
        return ActionResult(
            True, f"re-homed {moved} node(s) of slice {self.target} back"
        )


class DemoteTenantAction(Action):
    """Demote a burning tenant's admission priority in the burn engine."""

    kind = ACTION_DEMOTE_TENANT

    def __init__(self, tenant: str, burn_engine: Any):
        super().__init__(tenant)
        self._burn_engine = burn_engine

    def apply(self) -> ActionResult:
        if not self._burn_engine.demote_tenant(self.target):
            return ActionResult(
                False, f"tenant {self.target} already demoted"
            )
        return ActionResult(
            True,
            f"demoted tenant {self.target} to admission priority "
            f"{self._burn_engine.admission_priority(self.target)}",
        )

    def rollback(self) -> ActionResult:
        if not self._burn_engine.restore_tenant(self.target):
            # Ensure-undone: not demoted = already the goal state.
            return ActionResult(
                True,
                f"tenant {self.target} was not demoted "
                "(nothing to undo)",
            )
        return ActionResult(
            True, f"restored tenant {self.target} admission priority"
        )


@dataclass
class ActionBindings:
    """The subsystem handles actions bind to, assembled by the caller.

    Every field is optional: an agent wires the node-local subset
    (probes, breakers, burn engine), a fleet controller wires the ring
    and shards.  :meth:`build` returns None for a kind whose substrate
    is absent — the engine records that as an apply failure rather
    than guessing.
    """

    #: Probe manager (Generator or ProbeManager duck type).
    probe_manager: Any = None
    ownership: ShedOwnership | None = None
    supervisor: Any = None
    #: sink name -> CircuitBreaker.
    breakers: dict[str, Any] = field(default_factory=dict)
    runtime: Any = None
    drain_steps: list[tuple[str, Callable[[float], object]]] = field(
        default_factory=list
    )
    drain_deadline_s: float = 10.0
    ring: Any = None
    #: shard id -> AggregatorShard (rehome picks source by the slice's
    #: current owner and target by ``rehome_target``).
    shards: dict[str, Any] = field(default_factory=dict)
    rehome_source: str = ""
    rehome_target: str = ""
    burn_engine: Any = None

    def build(self, kind: str, target: str) -> Action | None:
        """Bind one (kind, target) to its substrate; None if absent."""
        if kind == ACTION_PROBE_SHED and self.probe_manager is not None:
            return ProbeShedAction(
                target,
                self.probe_manager,
                ownership=self.ownership,
                supervisor=self.supervisor,
            )
        if kind == ACTION_BREAKER_TRIP:
            # Exact name or sink-family prefix: the agent's OTLP path
            # is one channel per payload kind (otlp-slo / otlp-probe /
            # otlp-traces), and the policy targets the family "otlp".
            matched = [
                breaker
                for name, breaker in sorted(self.breakers.items())
                if name == target or name.startswith(target + "-")
            ]
            if matched:
                return BreakerTripAction(target, breakers=matched)
            return None
        if kind == ACTION_DRAIN_SNAPSHOT and self.runtime is not None:
            return DrainSnapshotAction(
                target,
                self.runtime,
                drain_steps=self.drain_steps,
                deadline_s=self.drain_deadline_s,
            )
        if kind == ACTION_CORDON_NODE and self.ring is not None:
            node, _, slice_id = target.partition("|")
            return CordonNodeAction(node, slice_id, self.ring)
        if kind == ACTION_REHOME_SLICE:
            source = self.shards.get(self.rehome_source)
            dest = self.shards.get(self.rehome_target)
            if source is not None and dest is not None:
                return RehomeSliceAction(target, source, dest)
            return None
        if kind == ACTION_DEMOTE_TENANT and self.burn_engine is not None:
            return DemoteTenantAction(target, self.burn_engine)
        return None
