"""Shed recovery: makes overhead-driven degradation two-way
(the port's own copy of ``tpuslo/safety/recovery.py``: plain Python, behaviour identical).

The overhead guard sheds probes when the agent busts its CPU budget,
but the reference design never re-enables them — one transient spike
permanently blinds the costliest signals.  This policy watches guard
results and, after N *consecutive* cycles comfortably under budget
(budget × headroom_factor, so recovery doesn't flap against the shed
threshold), authorizes re-enabling one shed signal.  Callers restore in
reverse shed order (cheapest first) and the streak restarts after every
restore, ramping probes back one at a time.
"""

from __future__ import annotations

from typing import Any

from tpuslo_torch.safety.overhead_guard import OverheadResult

#: Shed owners, in the order their claims arrive.  The supervisor's
#: flap hold-down is not an owner here — it is a separate veto that
#: outranks every owner (see :meth:`ShedOwnership.may_restore`).
OWNER_GUARD = "guard"
OWNER_REMEDIATION = "remediation"


class ShedOwnership:
    """Who shed each probe signal, and who may restore it.

    Three policies can shed (and want to restore) the same probe: the
    overhead guard + :class:`ShedRecoveryPolicy`, the supervisor's
    flap-shed, and the auto-remediation engine.  Without an explicit
    owner they tug-of-war — the recovery streak re-enables a probe
    remediation just shed, remediation rolls back a shed the guard
    still needs — so every shed carries an ownership tag and only the
    owner (or nobody, for legacy untagged sheds) may restore it.  The
    supervisor's flap hold-down additionally vetoes *every* restore:
    N quiet CPU cycles or a remediation rollback say nothing about why
    a probe was flapping.
    """

    def __init__(self):
        self._owners: dict[str, str] = {}

    def claim(self, signal: str, owner: str) -> bool:
        """Tag one shed; False when another owner already holds it
        (the first shed's reason wins — a second policy must not
        silently adopt, then restore, someone else's shed)."""
        current = self._owners.get(signal)
        if current is not None and current != owner:
            return False
        self._owners[signal] = owner
        return True

    def release(self, signal: str, owner: str) -> bool:
        """Drop a tag; only the owner may release its own claim."""
        if self._owners.get(signal) != owner:
            return False
        del self._owners[signal]
        return True

    def owner_of(self, signal: str) -> str:
        """The claiming owner, or "" for an untagged shed."""
        return self._owners.get(signal, "")

    def may_restore(
        self, signal: str, requestor: str, supervisor: Any = None
    ) -> bool:
        """True when ``requestor`` may restore this signal now.

        The supervisor hold-down (duck-typed ``may_restore(signal)``)
        outranks ownership in both directions: a flap-shed probe stays
        down for everyone.  Past that veto, a signal may be restored by
        its owner or — when untagged — by anyone (the pre-ownership
        behavior, so existing guard-shed flows are unchanged).
        """
        if supervisor is not None and not supervisor.may_restore(signal):
            return False
        owner = self._owners.get(signal)
        return owner is None or owner == requestor

    # ---- snapshot hooks (tpuslo_torch.runtime.StateStore) -------------------

    def export_state(self) -> dict[str, Any]:
        return {"owners": dict(self._owners)}

    def restore_state(self, state: dict[str, Any]) -> None:
        self._owners = {
            str(signal): str(owner)
            for signal, owner in (state.get("owners") or {}).items()
        }


class ShedRecoveryPolicy:
    """Counts consecutive under-budget guard cycles with hysteresis."""

    def __init__(self, cycles: int = 30, headroom_factor: float = 0.8):
        if cycles < 1:
            raise ValueError("cycles must be >= 1")
        if not 0 < headroom_factor <= 1:
            raise ValueError("headroom_factor must be in (0, 1]")
        self.cycles = cycles
        self.headroom_factor = headroom_factor
        self._streak = 0

    @property
    def streak(self) -> int:
        return self._streak

    def reset(self) -> None:
        self._streak = 0

    def note(self, result: OverheadResult) -> bool:
        """Feed one guard evaluation; True authorizes one restore.

        Invalid samples (first cycle, counter resets) neither extend
        nor break the streak — they carry no overhead signal.
        """
        if not result.valid:
            return False
        if (
            result.over_budget
            or result.cpu_pct > result.budget_pct * self.headroom_factor
        ):
            self._streak = 0
            return False
        self._streak += 1
        if self._streak >= self.cycles:
            self._streak = 0
            return True
        return False
