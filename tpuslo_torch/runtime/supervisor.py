"""ProbeSupervisor: heartbeat-watched probes, restarts, flap shedding
(the port's own copy of ``tpuslo/runtime/supervisor.py``: plain Python, behaviour identical).

A kernel probe can die without the agent noticing: the BPF link is
detached by an external actor, the ring producer wedges, the traced
library is replaced under the uprobe.  The event stream just goes
quiet.  The supervisor turns that silence into action:

* every consumed event **beats** the signal's heartbeat;
* a heartbeat older than the timeout marks a probe that has *proven
  itself alive at least once* as **dead** and schedules a restart
  through the caller-supplied hook
  (detach + re-attach for ring probes), with exponential backoff so a
  permanently broken probe does not become a restart storm;
* **K restarts inside a rolling window** is flapping — the supervisor
  sheds the signal via the caller's shed hook (the existing
  ``ProbeManager.detach_signal`` / shed-list machinery), records the
  reason, and holds the signal down: :meth:`may_restore` returns False
  until the hold-down expires, so :class:`ShedRecoveryPolicy` cannot
  immediately re-attach a probe the supervisor just proved unstable.

State is snapshot-friendly: restart counts and flap hold-downs are
exported relative to "now" so a restarted agent keeps distrusting a
probe that was flapping before the crash.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

ACTION_RESTARTED = "restarted"
ACTION_RESTART_FAILED = "restart_failed"
ACTION_FLAP_SHED = "flap_shed"

REASON_FLAPPING = "flapping"


@dataclass
class SupervisorConfig:
    """Knobs for one :class:`ProbeSupervisor` (config: ``runtime:``)."""

    heartbeat_timeout_s: float = 30.0
    restart_backoff_base_s: float = 1.0
    restart_backoff_cap_s: float = 60.0
    flap_restarts: int = 3
    flap_window_s: float = 120.0
    flap_holddown_s: float = 300.0


@dataclass
class SupervisorEvent:
    """One supervision action, for logs and the chaos evidence."""

    signal: str
    action: str
    detail: str = ""


@dataclass
class _ProbeState:
    last_beat: float
    restarts: deque = field(default_factory=lambda: deque(maxlen=64))
    next_restart_at: float = 0.0
    consecutive_failures: int = 0
    # Only a probe that has produced at least one event can be declared
    # dead: a signal that is legitimately quiet (zero retransmits on a
    # healthy network) is unproven, not dead — restarting it would
    # churn the BPF link and eventually flap-shed real telemetry.
    proven: bool = False


class ProbeSupervisor:
    """Tracks per-signal liveness and drives restart/shed decisions."""

    def __init__(
        self,
        config: SupervisorConfig | None = None,
        restart: Callable[[str], bool] | None = None,
        shed: Callable[[str, str], None] | None = None,
        clock: Callable[[], float] = time.monotonic,
        log: Callable[[str], None] | None = None,
    ):
        self.config = config or SupervisorConfig()
        self._restart = restart or (lambda signal: False)
        self._shed = shed or (lambda signal, reason: None)
        self._clock = clock
        self._log = log or (lambda msg: None)
        self._probes: dict[str, _ProbeState] = {}
        # signal -> hold-down expiry (monotonic); present = flap-shed.
        self._held: dict[str, float] = {}
        self.shed_reasons: dict[str, str] = {}
        self.restarts_total = 0
        self.flap_sheds_total = 0

    # ---- liveness -----------------------------------------------------

    def watch(self, signals: list[str]) -> None:
        """Start (or refresh) supervision for the given signals."""
        now = self._clock()
        for signal in signals:
            if signal not in self._probes:
                self._probes[signal] = _ProbeState(last_beat=now)

    def forget(self, signal: str) -> None:
        """Stop supervising a signal (guard-shed, operator-disabled)."""
        self._probes.pop(signal, None)

    def beat(self, signal: str) -> None:
        state = self._probes.get(signal)
        if state is not None:
            state.last_beat = self._clock()
            state.consecutive_failures = 0
            state.proven = True

    def heartbeat_age_s(self, signal: str) -> float:
        state = self._probes.get(signal)
        if state is None:
            return 0.0
        return max(0.0, self._clock() - state.last_beat)

    # ---- supervision --------------------------------------------------

    def evaluate(self) -> list[SupervisorEvent]:
        """One supervision pass: restart dead probes, shed flappers."""
        now = self._clock()
        events: list[SupervisorEvent] = []
        for signal, state in list(self._probes.items()):
            if not state.proven:
                continue  # quiet-but-unproven: nothing to resurrect
            if now - state.last_beat < self.config.heartbeat_timeout_s:
                continue
            if now < state.next_restart_at:
                continue  # backing off
            window_start = now - self.config.flap_window_s
            while state.restarts and state.restarts[0] < window_start:
                state.restarts.popleft()
            if len(state.restarts) >= self.config.flap_restarts:
                events.append(self._flap_shed(signal, state, now))
                continue
            events.append(self._try_restart(signal, state, now))
        return events

    def _try_restart(
        self, signal: str, state: _ProbeState, now: float
    ) -> SupervisorEvent:
        state.restarts.append(now)
        self.restarts_total += 1
        backoff = min(
            self.config.restart_backoff_cap_s,
            self.config.restart_backoff_base_s
            * (2 ** state.consecutive_failures),
        )
        state.next_restart_at = now + backoff
        try:
            ok = bool(self._restart(signal))
        except Exception as exc:  # noqa: BLE001 — a restart hook bug
            # must not kill the agent loop the supervisor protects.
            ok = False
            self._log(f"supervisor: restart hook for {signal} raised: {exc!r}")
        if ok:
            state.last_beat = now  # grant a fresh heartbeat window
            state.consecutive_failures = 0
            self._log(f"supervisor: restarted dead probe {signal}")
            return SupervisorEvent(signal, ACTION_RESTARTED)
        state.consecutive_failures += 1
        return SupervisorEvent(
            signal, ACTION_RESTART_FAILED, f"backoff {backoff:.1f}s"
        )

    def _flap_shed(
        self, signal: str, state: _ProbeState, now: float
    ) -> SupervisorEvent:
        self._probes.pop(signal, None)
        self._held[signal] = now + self.config.flap_holddown_s
        self.shed_reasons[signal] = REASON_FLAPPING
        self.flap_sheds_total += 1
        detail = (
            f"{len(state.restarts)} restarts in "
            f"{self.config.flap_window_s:.0f}s, hold-down "
            f"{self.config.flap_holddown_s:.0f}s"
        )
        try:
            self._shed(signal, REASON_FLAPPING)
        except Exception as exc:  # noqa: BLE001
            self._log(f"supervisor: shed hook for {signal} raised: {exc!r}")
        self._log(f"supervisor: flap-shed {signal} ({detail})")
        return SupervisorEvent(signal, ACTION_FLAP_SHED, detail)

    # ---- restore gating -----------------------------------------------

    def may_restore(self, signal: str) -> bool:
        """False while a flap-shed signal's hold-down is still running.

        The overhead-guard recovery path (``ShedRecoveryPolicy`` +
        ``restore_one``) must consult this before re-enabling a shed
        signal: N quiet under-budget cycles say nothing about why the
        supervisor shed a flapping probe.
        """
        expiry = self._held.get(signal)
        if expiry is None:
            return True
        if self._clock() >= expiry:
            del self._held[signal]
            self.shed_reasons.pop(signal, None)
            return True
        return False

    def note_restored(self, signal: str) -> None:
        """A shed signal came back: resume supervising it fresh."""
        self._held.pop(signal, None)
        self.shed_reasons.pop(signal, None)
        self.watch([signal])

    # ---- snapshot hooks ----------------------------------------------

    def export_state(self) -> dict[str, Any]:
        """Hold-downs and restart histories, relative to now.

        Monotonic timestamps do not survive a process restart, so
        everything is exported as an offset from the export instant.
        """
        now = self._clock()
        return {
            "held": {
                signal: max(0.0, expiry - now)
                for signal, expiry in self._held.items()
            },
            "shed_reasons": dict(self.shed_reasons),
            "restarts": {
                signal: [max(0.0, now - at) for at in state.restarts]
                for signal, state in self._probes.items()
                if state.restarts
            },
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        now = self._clock()
        for signal, remaining in (state.get("held") or {}).items():
            self._held[str(signal)] = now + max(0.0, float(remaining))
        for signal, reason in (state.get("shed_reasons") or {}).items():
            self.shed_reasons[str(signal)] = str(reason)
        for signal, ages in (state.get("restarts") or {}).items():
            probe = self._probes.get(str(signal))
            if probe is None:
                probe = self._probes[str(signal)] = _ProbeState(
                    last_beat=now
                )
            for age in sorted(ages, reverse=True):
                probe.restarts.append(now - max(0.0, float(age)))

    def snapshot(self) -> dict[str, Any]:
        """Point-in-time stats for logs and tests."""
        return {
            "watched": sorted(self._probes),
            "held": sorted(self._held),
            "shed_reasons": dict(sorted(self.shed_reasons.items())),
            "restarts_total": self.restarts_total,
            "flap_sheds_total": self.flap_sheds_total,
        }
