"""Per-dispatch device-time accounting for the serving front door (the
port's own copy of ``tpuslo/deviceplane/dispatch.py``).

A profiler capture is the precise device-plane truth; the serving loop
needs a number it can afford EVERY dispatch.  On an asynchronous backend the
fused multi-round dispatch returns immediately (enqueue) and the ONE
fused host read blocks until the device finishes the chained
rounds — so the read-wait is the host-side proxy for device busy time
per dispatch, and the dispatch call itself measures host dispatch
overhead.  :class:`DispatchLedger` folds both, per step and
cumulatively, and the front door attaches the totals to its self-trace
span attrs when a tracer is wired.

Hot-path discipline: ``note`` is integer arithmetic on a slotted
object — timestamps arrive as ``perf_counter_ns`` deltas from the
caller, never from the wall clock.
"""

from __future__ import annotations

from typing import Any


class DispatchLedger:
    """Cumulative + last-step device-time proxy for one serving loop."""

    __slots__ = (
        "steps",
        "dispatch_ns_total",
        "read_ns_total",
        "tokens_total",
        "last_dispatch_ns",
        "last_read_ns",
        "last_tokens",
        "last_slots",
    )

    def __init__(self) -> None:
        self.steps = 0
        self.dispatch_ns_total = 0
        self.read_ns_total = 0
        self.tokens_total = 0
        self.last_dispatch_ns = 0
        self.last_read_ns = 0
        self.last_tokens = 0
        self.last_slots = 0

    def note(
        self, dispatch_ns: int, read_ns: int, tokens: int, slots: int
    ) -> None:
        """Record one fused dispatch's timings (perf_counter_ns deltas)."""
        self.steps += 1
        self.dispatch_ns_total += dispatch_ns
        self.read_ns_total += read_ns
        self.tokens_total += tokens
        self.last_dispatch_ns = dispatch_ns
        self.last_read_ns = read_ns
        self.last_tokens = tokens
        self.last_slots = slots

    @property
    def device_wait_ms_total(self) -> float:
        """Cumulative read-wait: the device-busy proxy."""
        return self.read_ns_total / 1e6

    @property
    def dispatch_ms_total(self) -> float:
        return self.dispatch_ns_total / 1e6

    def last(self) -> dict[str, Any]:
        """The most recent dispatch's span-attr block."""
        return {
            "dispatch_ms": round(self.last_dispatch_ns / 1e6, 4),
            "device_wait_ms": round(self.last_read_ns / 1e6, 4),
            "tokens": self.last_tokens,
            "slots": self.last_slots,
        }

    def totals(self) -> dict[str, Any]:
        tokens = max(self.tokens_total, 1)
        return {
            "steps": self.steps,
            "dispatch_ms_total": round(self.dispatch_ms_total, 3),
            "device_wait_ms_total": round(self.device_wait_ms_total, 3),
            "tokens_total": self.tokens_total,
            "device_wait_ms_per_token": round(
                self.device_wait_ms_total / tokens, 5
            ),
        }
