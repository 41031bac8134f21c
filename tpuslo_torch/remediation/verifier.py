"""Verify-or-rollback: did the burn actually subside after the action?
(the port's own copy of ``tpuslo/remediation/verifier.py``: plain Python, behaviour identical).

An applied action is a hypothesis, not a fix.  The verifier watches the
target's burn evidence for up to ``windows`` evaluation windows and
settles on exactly one of two verdicts:

* **confirmed** — the burn sat below ``subside_below`` for
  ``subside_streak`` *consecutive* windows (hysteresis: one bounce
  resets the streak but does not fail the verify, so a verify cannot
  flap between confirm and rollback on threshold noise);
* **rollback** — the window budget ran out without a sustained
  subsidence; the action gets rolled back and the incident escalates
  to a human, because acting did not help and the mis-applied lever
  must not stay pulled.

The verifier is a pure per-action state fold (no wall clock, no I/O):
the engine feeds it one burn observation per evaluation window and
persists its two counters inside the action record, so verification
resumes exactly where it left off across an agent restart.
"""

from __future__ import annotations

from dataclasses import dataclass

VERDICT_PENDING = "pending"
VERDICT_CONFIRMED = "confirmed"
VERDICT_ROLLBACK = "rollback"


@dataclass(slots=True)
class VerifyPolicy:
    """Verification knobs (config: ``remediation:``)."""

    #: Evaluation-window budget before the verify gives up.
    windows: int = 6
    #: Consecutive subsided windows required to confirm.
    subside_streak: int = 2
    #: Burn-rate line the target must sit below to count as subsided.
    #: Default 3.0 = the slow rule's clearing line (threshold 6.0 ×
    #: clear hysteresis 0.5) — the same convention the alert state
    #: machine de-escalates on, and comfortably above the single-error
    #: binomial noise floor of a short window (one stray error in a
    #: 5m/60-request window reads ~1.7x) while 5x under the fast-burn
    #: page threshold.
    subside_below: float = 3.0


@dataclass(slots=True)
class VerifyState:
    """The two counters one in-flight verification carries."""

    windows_seen: int = 0
    streak: int = 0


def observe_window(
    policy: VerifyPolicy, state: VerifyState, burn_rate: float
) -> str:
    """Fold one evaluation window's burn evidence; returns the verdict.

    Mutates ``state`` in place (the engine persists it inside the
    action record).  Registered in the hot-path manifest: one call per
    in-flight action per evaluation window, pure arithmetic.
    """
    state.windows_seen += 1
    if burn_rate < policy.subside_below:
        state.streak += 1
    else:
        state.streak = 0
    if state.streak >= policy.subside_streak:
        return VERDICT_CONFIRMED
    if state.windows_seen >= policy.windows:
        return VERDICT_ROLLBACK
    return VERDICT_PENDING
