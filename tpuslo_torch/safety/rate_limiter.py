"""Event-rate limiter for agent emit paths
(the port's own copy of ``tpuslo/safety/rate_limiter.py``: plain Python, behaviour identical).

Reference: ``pkg/safety/rate_limiter.go:9-39`` (per-second window).
Implemented as a token bucket — identical steady-state behaviour with a
configurable burst, and deterministic under an injected clock.
"""

from __future__ import annotations

import time
from typing import Callable


class RateLimiter:
    """Token bucket: ``events_per_second`` refill, ``burst`` capacity."""

    def __init__(
        self,
        events_per_second: int,
        burst: int | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if events_per_second < 1:
            raise ValueError("events_per_second must be >= 1")
        self._rate = float(events_per_second)
        self._capacity = float(burst if burst and burst > 0 else events_per_second)
        self._clock = clock
        self._tokens = self._capacity
        self._last = clock()

    def allow(self, n: int = 1) -> bool:
        """Consume ``n`` tokens if available; False means drop the event."""
        now = self._clock()
        elapsed = max(0.0, now - self._last)
        self._last = now
        self._tokens = min(self._capacity, self._tokens + elapsed * self._rate)
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    @property
    def tokens(self) -> float:
        return self._tokens

    # ---- snapshot hooks (tpuslo_torch.runtime.StateStore) -------------------

    def export_state(self) -> dict:
        return {"tokens": self._tokens}

    def restore_state(self, state: dict) -> None:
        """Resume the previous incarnation's budget (clamped).

        Without this a crash-looping agent gets a full burst allowance
        on every restart — the restart loop itself would defeat the
        limiter.  Restoring the spent budget keeps the token bucket an
        invariant of the *node*, not the process.
        """
        try:
            tokens = float(state.get("tokens", self._capacity))
        except (TypeError, ValueError):
            return
        self._tokens = min(self._capacity, max(0.0, tokens))
        self._last = self._clock()
