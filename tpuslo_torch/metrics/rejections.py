"""Process-wide reason-classed rejection counters.

Every stage that discards or refuses an input event used to do so
silently (``matcher._ts`` swallowing unparseable timestamps,
``SliceJoiner.add`` returning ``False`` on missing fields).  A silent
drop on the telemetry plane is indistinguishable from a healthy quiet
stream — exactly the failure mode that turns a clock-skewed or corrupt
DaemonSet feed into confident mis-attribution.  These counters make
every rejection observable without coupling the correlation layer to
Prometheus: plain ints guarded only by the GIL (same contract as
:class:`tpuslo_torch.schema.fastpath.ValidationCounters` — a lost increment
under contention is acceptable for diagnostics, a lock on the hot path
is not).

The agent surfaces a snapshot in its periodic stats line; ``slicecorr``
folds the joiner's share into its summary JSON.
"""

from __future__ import annotations


class RejectionCounters:
    """Tallies of rejected inputs keyed by ``(stage, reason)``."""

    def __init__(self) -> None:
        self._counts: dict[tuple[str, str], int] = {}

    def note(self, stage: str, reason: str, n: int = 1) -> None:
        key = (stage, reason)
        self._counts[key] = self._counts.get(key, 0) + n

    def total(self, stage: str | None = None) -> int:
        return sum(
            count
            for (s, _), count in self._counts.items()
            if stage is None or s == stage
        )

    def snapshot(self, stage: str | None = None) -> dict[str, int]:
        """``{"stage.reason": count}`` map, optionally stage-filtered."""
        return {
            f"{s}.{reason}": count
            for (s, reason), count in sorted(self._counts.items())
            if stage is None or s == stage
        }

    def reset(self) -> None:
        self._counts.clear()


REJECTION_COUNTERS = RejectionCounters()
