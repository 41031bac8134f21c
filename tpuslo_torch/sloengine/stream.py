"""SLI stream primitives: request outcomes + ring-buffer windows.

``RequestOutcome`` is the one record every traffic source emits (the
agent's synthetic loop, ``loadgen --slo-out``, the burn sweep).  A
:class:`TenantWindows` folds outcomes into per-objective good/total
counts across the four Google-SRE burn windows (5m/30m/1h/6h) plus the
budget-ledger window, using one fixed-size ring of time buckets with
O(1) amortized roll-forward — no per-request rescans, ever.

``TenantWindows.record`` / ``roll_to`` are hot-path manifest entries
(tpulint's hot-path rules): no wall-clock reads, no serialization, no logging —
time arrives with the outcome, integer bucket arithmetic does the rest.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

#: Burn-rate windows (label, seconds) — the Google SRE multi-window set.
WINDOWS: tuple[tuple[str, int], ...] = (
    ("5m", 300),
    ("30m", 1800),
    ("1h", 3600),
    ("6h", 21600),
)

#: Index of the internal budget-ledger window (appended after WINDOWS).
BUDGET_WINDOW_INDEX = len(WINDOWS)


@dataclass(slots=True)
class RequestOutcome:
    """One request-level SLI observation on the stream.

    ``status`` is ``"ok"`` or ``"error"``; latency objectives treat an
    errored request as bad regardless of its timings.
    """

    tenant: str
    ts_unix_nano: int
    ttft_ms: float
    tpot_ms: float
    tokens: int
    status: str
    request_id: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "tenant": self.tenant,
            "ts_unix_nano": self.ts_unix_nano,
            "ttft_ms": self.ttft_ms,
            "tpot_ms": self.tpot_ms,
            "tokens": self.tokens,
            "status": self.status,
            "request_id": self.request_id,
        }

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "RequestOutcome":
        return cls(
            tenant=str(raw.get("tenant", "")) or "default",
            ts_unix_nano=int(raw.get("ts_unix_nano", 0)),
            ttft_ms=float(raw.get("ttft_ms", 0.0)),
            tpot_ms=float(raw.get("tpot_ms", 0.0)),
            tokens=int(raw.get("tokens", 0)),
            status=str(raw.get("status", "ok")),
            request_id=str(raw.get("request_id", "")),
        )


class TenantWindows:
    """Per-tenant sliding good/total counts over the burn windows.

    One ring of ``horizon_s / bucket_s`` buckets; each bucket holds
    ``(good, total)`` pairs per objective.  Running sums per window are
    maintained incrementally: advancing the head by one bucket
    subtracts exactly the bucket leaving each window and zeroes the
    reused slot — O(#windows) per bucket transition, O(1) per record.
    Late events land in their own (still-covered) bucket; events older
    than the horizon are counted and dropped.
    """

    __slots__ = (
        "bucket_s",
        "n_buckets",
        "n_objectives",
        "dropped_stale",
        "_stride",
        "_counts",
        "_head_abs",
        "_window_buckets",
        "_sums",
    )

    def __init__(
        self,
        n_objectives: int,
        bucket_s: int = 10,
        horizon_s: int = 21600,
    ):
        if bucket_s <= 0:
            raise ValueError("bucket_s must be > 0")
        max_window_s = max(seconds for _, seconds in WINDOWS)
        horizon_s = max(int(horizon_s), max_window_s)
        self.bucket_s = int(bucket_s)
        self.n_buckets = max(1, horizon_s // self.bucket_s)
        self.n_objectives = int(n_objectives)
        self.dropped_stale = 0
        self._stride = 2 * self.n_objectives
        self._counts = [0] * (self.n_buckets * self._stride)
        self._head_abs = -1
        window_seconds = [seconds for _, seconds in WINDOWS]
        window_seconds.append(horizon_s)  # budget-ledger window
        self._window_buckets = tuple(
            min(self.n_buckets, max(1, seconds // self.bucket_s))
            for seconds in window_seconds
        )
        self._sums = [[0] * self._stride for _ in self._window_buckets]

    # ---- hot path -----------------------------------------------------

    def roll_to(self, abs_bucket: int) -> None:
        """Advance the head to ``abs_bucket``, expiring old buckets."""
        head = self._head_abs
        if head < 0:
            self._head_abs = abs_bucket
            return
        gap = abs_bucket - head
        if gap <= 0:
            return
        n = self.n_buckets
        stride = self._stride
        if gap >= n:
            # Entire horizon expired: everything resets.
            counts = self._counts
            for i in range(len(counts)):
                counts[i] = 0
            for sums in self._sums:
                for j in range(stride):
                    sums[j] = 0
            self._head_abs = abs_bucket
            return
        counts = self._counts
        window_buckets = self._window_buckets
        all_sums = self._sums
        for h in range(head + 1, abs_bucket + 1):
            for wi in range(len(window_buckets)):
                leave = h - window_buckets[wi]
                if leave < 0:
                    continue
                slot = (leave % n) * stride
                sums = all_sums[wi]
                for j in range(stride):
                    sums[j] -= counts[slot + j]
            # The reused slot held the bucket one full horizon back; it
            # left the largest window in the subtraction above.
            slot = (h % n) * stride
            for j in range(stride):
                counts[slot + j] = 0
        self._head_abs = abs_bucket

    def record(self, ts_s: int, goods: tuple[bool, ...]) -> bool:
        """Fold one outcome in; False (and counted) if past the horizon."""
        ab = ts_s // self.bucket_s
        head = self._head_abs
        if head < 0 or ab > head:
            self.roll_to(ab)
            head = ab
        offset = head - ab
        if offset >= self.n_buckets:
            self.dropped_stale += 1
            return False
        slot = (ab % self.n_buckets) * self._stride
        counts = self._counts
        window_buckets = self._window_buckets
        all_sums = self._sums
        for i in range(self.n_objectives):
            g = 1 if goods[i] else 0
            gi = 2 * i
            counts[slot + gi] += g
            counts[slot + gi + 1] += 1
            for wi in range(len(window_buckets)):
                if offset < window_buckets[wi]:
                    sums = all_sums[wi]
                    sums[gi] += g
                    sums[gi + 1] += 1
        return True

    # ---- read side ----------------------------------------------------

    @property
    def head_abs(self) -> int:
        return self._head_abs

    def window_counts(
        self, window_index: int, objective_index: int
    ) -> tuple[int, int]:
        """(good, total) for one window and objective."""
        sums = self._sums[window_index]
        gi = 2 * objective_index
        return sums[gi], sums[gi + 1]

    # ---- snapshot / restore (crash-safe runtime) ----------------------

    def export_state(self) -> dict[str, Any]:
        return {
            "bucket_s": self.bucket_s,
            "n_buckets": self.n_buckets,
            "n_objectives": self.n_objectives,
            "head_abs": self._head_abs,
            "counts": list(self._counts),
            "dropped_stale": self.dropped_stale,
        }

    def restore_state(self, state: dict[str, Any]) -> bool:
        """Restore the ring; False (cold) on any shape mismatch.

        Window sums are recomputed from the restored buckets rather
        than trusted from the snapshot — the ring is the single source
        of truth, so a partial write can never desynchronize the two.
        """
        if (
            int(state.get("bucket_s", -1)) != self.bucket_s
            or int(state.get("n_buckets", -1)) != self.n_buckets
            or int(state.get("n_objectives", -1)) != self.n_objectives
        ):
            return False
        counts = state.get("counts")
        if (
            not isinstance(counts, list)
            or len(counts) != self.n_buckets * self._stride
        ):
            return False
        self._counts = [int(v) for v in counts]
        self._head_abs = int(state.get("head_abs", -1))
        self.dropped_stale = int(state.get("dropped_stale", 0))
        stride = self._stride
        n = self.n_buckets
        head = self._head_abs
        self._sums = [[0] * stride for _ in self._window_buckets]
        if head < 0:
            return True
        for wi, wb in enumerate(self._window_buckets):
            sums = self._sums[wi]
            lo = head - wb + 1
            for b in range(max(0, lo), head + 1):
                slot = (b % n) * stride
                for j in range(stride):
                    sums[j] += self._counts[slot + j]
        return True
