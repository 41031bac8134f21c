"""Graceful drain: bounded-deadline shutdown for the agent loops
(the port's own copy of ``tpuslo/runtime/drain.py``: plain Python, behaviour identical).

Kubernetes terminates a pod with SIGTERM, waits
``terminationGracePeriodSeconds``, then SIGKILLs.  The agent's job in
that window is fixed and ordered: stop generating, push every queued
batch to the sink or the disk spool, write one final state snapshot,
release probes.  :class:`DrainController` runs those steps under one
shared deadline — a hung sink eats its own step budget, never the
snapshot's — and reports what happened so the chaos sweep (and the
operator) can tell a clean drain from a deadline overrun.

:func:`install_drain_handler` routes SIGTERM through the same
exception path ``KeyboardInterrupt`` already takes, so both loops end
in exactly one drain sequence.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable

DRAIN_CLEAN = "clean"
DRAIN_DEADLINE_EXCEEDED = "deadline_exceeded"
DRAIN_STEP_ERROR = "step_error"

DEFAULT_DRAIN_TIMEOUT_S = 10.0


class DrainSignal(BaseException):
    """Raised in the main thread when SIGTERM arrives.

    A ``BaseException`` (like ``KeyboardInterrupt``) so it cannot be
    swallowed by the loops' broad ``except Exception`` emit guards.
    """

    def __init__(self, signum: int):
        super().__init__(f"drain requested by signal {signum}")
        self.signum = signum


def install_drain_handler(
    signals: tuple[int, ...] = (signal.SIGTERM,),
) -> Callable[[], None]:
    """Route the given signals into :class:`DrainSignal`.

    Returns a restore callable that reinstates the previous handlers —
    the agent entry point runs under callers (tests, the dispatcher)
    that outlive it, so handler installation must be reversible.  When
    called off the main thread (tests driving ``agent.main`` from a
    worker), installation is skipped and the restore is a no-op:
    CPython only delivers signals to the main thread anyway.
    """

    def _handler(signum, frame):  # noqa: ARG001 — signal API shape
        raise DrainSignal(signum)

    previous: list[tuple[int, object]] = []
    try:
        for signum in signals:
            previous.append((signum, signal.getsignal(signum)))
            signal.signal(signum, _handler)
    except ValueError:  # not the main thread
        previous.clear()

    def _restore() -> None:
        for signum, handler in previous:
            try:
                signal.signal(signum, handler)
            except (ValueError, TypeError):
                pass

    return _restore


@dataclass
class DrainStep:
    name: str
    ok: bool
    duration_s: float
    detail: str = ""


@dataclass
class DrainReport:
    """What the shutdown sequence actually did, step by step."""

    reason: str
    deadline_s: float
    outcome: str = DRAIN_CLEAN
    steps: list[DrainStep] = field(default_factory=list)
    duration_s: float = 0.0

    def summary(self) -> str:
        steps = " ".join(
            f"{s.name}={'ok' if s.ok else 'FAIL'}({s.duration_s:.2f}s)"
            for s in self.steps
        )
        return (
            f"reason={self.reason} outcome={self.outcome} "
            f"took={self.duration_s:.2f}s {steps}".rstrip()
        )


class DrainController:
    """Runs named shutdown steps under one shared deadline.

    Each step callable receives the remaining budget in seconds and
    returns True on success (a False/None return marks the step failed
    but the drain continues — later steps like the final snapshot must
    run even when a flush timed out).  A step raising is caught,
    recorded, and does not stop the sequence: drain is the last code
    that runs, so it must be crash-only itself.
    """

    def __init__(
        self,
        reason: str,
        deadline_s: float = DEFAULT_DRAIN_TIMEOUT_S,
        clock: Callable[[], float] = time.monotonic,
        log: Callable[[str], None] | None = None,
    ):
        self._clock = clock
        self._log = log or (lambda msg: None)
        self._started = clock()
        self._deadline = self._started + max(0.1, deadline_s)
        self.report = DrainReport(reason=reason, deadline_s=deadline_s)

    def remaining_s(self) -> float:
        return max(0.0, self._deadline - self._clock())

    def step(
        self, name: str, fn: Callable[[float], object]
    ) -> bool:
        """Run one bounded step; returns its success verdict.

        A step always runs, even with the budget exhausted — it just
        runs with budget 0 (flushes give up immediately and fall back
        to their loss-free path: spill to spool, skip the network).
        Skipping late steps outright would drop exactly the
        spill-to-spool / final-snapshot work that must happen when an
        earlier flush overran.
        """
        budget = self.remaining_s()
        start = self._clock()
        ok = False
        detail = ""
        if budget <= 0 and self.report.outcome == DRAIN_CLEAN:
            self.report.outcome = DRAIN_DEADLINE_EXCEEDED
        try:
            result = fn(budget)
            ok = result is None or bool(result)
        except Exception as exc:  # noqa: BLE001 — drain must finish
            detail = repr(exc)
            if self.report.outcome == DRAIN_CLEAN:
                self.report.outcome = DRAIN_STEP_ERROR
            self._log(f"drain: step {name} raised: {exc!r}")
        duration = self._clock() - start
        if not ok and not detail:
            detail = "timed out or refused"
            if self.report.outcome == DRAIN_CLEAN:
                self.report.outcome = DRAIN_DEADLINE_EXCEEDED
        self.report.steps.append(DrainStep(name, ok, duration, detail))
        return ok

    def finish(self) -> DrainReport:
        self.report.duration_s = self._clock() - self._started
        return self.report
