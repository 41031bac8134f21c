"""Per-sink circuit breaker: closed → open → half-open → closed.

The agent's sinks (OTLP collector, incident webhook) fail together with
the incidents the toolkit attributes, so a sink outage must not turn
into a retry storm against a struggling endpoint.  The breaker trips
after N consecutive failures, holds deliveries off for a cooldown, then
lets a bounded number of probe sends through; one success closes it,
one failure re-arms the cooldown.

The port's own copy of ``tpuslo/delivery/breaker.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable

STATE_CLOSED = "closed"
STATE_HALF_OPEN = "half_open"
STATE_OPEN = "open"

#: Numeric encoding for the breaker-state gauge (alert on > 0).
STATE_VALUES = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probe sends."""

    def __init__(
        self,
        failure_threshold: int = 5,
        open_duration_s: float = 10.0,
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_state_change: Callable[[str], None] | None = None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if open_duration_s <= 0:
            raise ValueError("open_duration_s must be > 0")
        self._failure_threshold = failure_threshold
        self._open_duration_s = open_duration_s
        self._half_open_max_probes = max(1, half_open_max_probes)
        self._clock = clock
        self._on_state_change = on_state_change
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0
        #: Transition log (state, at) — chaos tests assert the
        #: open → half-open → closed lifecycle actually happened.
        #: Bounded: a sink flapping for days must not grow agent memory.
        self.transitions: deque[tuple[str, float]] = deque(
            [(STATE_CLOSED, 0.0)], maxlen=64
        )

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _set_state_locked(self, state: str) -> None:
        if state == self._state:
            return
        self._state = state
        self.transitions.append((state, self._clock()))
        if self._on_state_change is not None:
            self._on_state_change(state)

    def _maybe_half_open_locked(self) -> None:
        if (
            self._state == STATE_OPEN
            and self._clock() - self._opened_at >= self._open_duration_s
        ):
            self._set_state_locked(STATE_HALF_OPEN)
            self._probes_in_flight = 0

    def allow(self) -> bool:
        """True when a send may be attempted right now.

        In half-open state each ``allow()`` grants one probe slot until
        a ``record_*`` call settles the outcome.
        """
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == STATE_CLOSED:
                return True
            if (
                self._state == STATE_HALF_OPEN
                and self._probes_in_flight < self._half_open_max_probes
            ):
                self._probes_in_flight += 1
                return True
            return False

    def release_probe(self) -> None:
        """Return a half-open probe slot without a verdict (the probe
        send never actually contacted the sink)."""
        with self._lock:
            if self._probes_in_flight > 0:
                self._probes_in_flight -= 1

    # ---- remediation surface ------------------------------------------

    def force_open(self) -> None:
        """Trip the breaker by decree (auto-remediation, operator).

        A forced trip re-arms the full cooldown from now: the caller
        has outside evidence (a network-partition attribution) that the
        sink's path is bad, which outranks whatever consecutive-failure
        count the breaker had accumulated on its own.
        """
        with self._lock:
            self._opened_at = self._clock()
            self._probes_in_flight = 0
            self._set_state_locked(STATE_OPEN)

    def force_close(self) -> None:
        """Reset the breaker by decree (remediation rollback).

        Clears the failure count too — the rollback's claim is that the
        trip was wrong, so the breaker must not re-open on the next
        single failure off a stale streak.
        """
        with self._lock:
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            self._set_state_locked(STATE_CLOSED)

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probes_in_flight = 0
            if self._state != STATE_CLOSED:
                self._set_state_locked(STATE_CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            self._probes_in_flight = 0
            if self._state == STATE_HALF_OPEN:
                # The probe send failed: re-arm the cooldown.
                self._opened_at = self._clock()
                self._set_state_locked(STATE_OPEN)
            elif (
                self._state == STATE_CLOSED
                and self._consecutive_failures >= self._failure_threshold
            ):
                self._opened_at = self._clock()
                self._set_state_locked(STATE_OPEN)

    # ---- snapshot hooks (tpuslo.runtime.StateStore) -------------------

    def export_state(self) -> dict:
        """Restart-portable breaker state.

        The monotonic ``opened_at`` instant cannot cross a process
        boundary, so an open breaker exports its *remaining* cooldown
        instead; half-open exports as open with no remaining cooldown
        (the restarted worker immediately re-probes — the conservative
        reading of an interrupted probe).
        """
        with self._lock:
            self._maybe_half_open_locked()
            remaining = 0.0
            if self._state == STATE_OPEN:
                remaining = max(
                    0.0,
                    self._open_duration_s
                    - (self._clock() - self._opened_at),
                )
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "open_remaining_s": remaining,
            }

    def restore_state(self, state: dict) -> None:
        """Adopt a previous incarnation's breaker verdict.

        A restored open breaker keeps sink traffic off for its
        remaining cooldown — a restart must not turn one crash into a
        retry storm against a sink that was already refusing.
        """
        restored = state.get("state")
        if restored not in STATE_VALUES:
            return
        with self._lock:
            self._consecutive_failures = int(
                state.get("consecutive_failures", 0)
            )
            if restored == STATE_CLOSED:
                self._set_state_locked(STATE_CLOSED)
                return
            remaining = max(0.0, float(state.get("open_remaining_s", 0.0)))
            # Backdate opened_at so exactly `remaining` cooldown is left;
            # an expired (or half-open) cooldown re-probes on first allow().
            self._opened_at = (
                self._clock() - self._open_duration_s + remaining
            )
            self._probes_in_flight = 0
            self._set_state_locked(STATE_OPEN)
            self._maybe_half_open_locked()
