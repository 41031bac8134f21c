"""Per-launch device-time ledger over profiler span captures (the port's
own copy of ``tpuslo/deviceplane/ledger.py``: a pure fold, unchanged,
over the port's :class:`~tpuslo_torch.otel.xla_spans.XLASpan`).

What a launch is: on a TPU one module span is one program execution, and
the JAX ledger makes one record per span.  On a card the port's parser
cuts each dispatch into one module span per run of its kernels, so a
dispatch can have thousands of records.  The records stay (the fold
needs them for exact idle gaps and owned times), and every count of
launches reads them by dispatch (:func:`dispatch_records`): the
published ``launches``, ``launches_with_ops``, tier and reason counts,
and both sides of every join rate.  On a capture where every record is
its own dispatch (a TPU's, the seeded ones) these are the JAX ledger's
counts.

The real-chip evidence had ``xla_launch_join_rate`` at 0.556 — half of
device time unexplained — because the only join the pipeline served was
the exact ``(program_id, launch_id)`` identity: dispatch-only helper
programs, anonymous launches (no launch number), and launches whose op
events landed on a different trace lane all fell out of the
denominator with no accounting.  This module closes that gap with a
tiered join ladder (THAPI's multi-tier heterogeneous-API join and
CrossTrace's cross-thread span correlation are the tier designs —
PAPERS.md):

1. **identity** — ops contained in the launch's own window on its own
   device, launch carries a launch number: the exact join the
   ``xla_launch`` correlation tier already serves.
2. **lane_window** — the launch has no ops on its own lane, but an
   ops-only satellite lane (a device id that carries ops and no module
   span) carries ops fully contained in the launch window: windowed
   containment recovers them.
3. **compile_event** — anonymous/helper launches tie to their owning
   compilation by program fingerprint, module-name prefix, or a
   bounded time window after the compile finished.
4. **frame** — per-step frames bucket the remainder: a dispatch-only
   helper between step N's launch and step N+1's belongs to step N.

Every module launch lands in exactly ONE bucket — ``joined`` /
``helper`` / ``compile`` / ``idle_gap`` / ``unexplained`` — and the
buckets provably sum to total device time (the per-device observation
window).

Accounting rule: overlapping launches on one device each own only the
time not already owned by an earlier-starting launch (a sweep clip),
so bucket sums cannot double-count; the idle gap is the window minus
the merged busy time.  Device work outside every module span (kernels
no dispatch range encloses) is therefore idle time to this ledger.
All functions are pure folds over the span lists.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Any, Iterable, Sequence

from tpuslo_torch.otel.xla_spans import MODULES_LANE, OPS_LANE, XLASpan

# Buckets: every launch (and every idle nanosecond) lands in exactly one.
BUCKET_JOINED = "joined"
BUCKET_HELPER = "helper"
BUCKET_COMPILE = "compile"
BUCKET_IDLE_GAP = "idle_gap"
BUCKET_UNEXPLAINED = "unexplained"

ALL_BUCKETS = (
    BUCKET_JOINED,
    BUCKET_HELPER,
    BUCKET_COMPILE,
    BUCKET_IDLE_GAP,
    BUCKET_UNEXPLAINED,
)

# Join tiers, strongest first (a launch keeps the first tier that
# explains it).
TIER_IDENTITY = "identity"
TIER_LANE_WINDOW = "lane_window"
TIER_COMPILE_EVENT = "compile_event"
TIER_FRAME = "frame"
TIER_NONE = "none"

ALL_TIERS = (TIER_IDENTITY, TIER_LANE_WINDOW, TIER_COMPILE_EVENT, TIER_FRAME)

# Unattributed-launch reason classes (superset of the historical
# ``launch_match_breakdown`` vocabulary, which this ledger now feeds).
REASON_NO_OPS_LANE = "no_ops_lane"
REASON_NO_CONTAINED_OPS = "no_contained_ops"
REASON_OVERLAPPING = "ops_assigned_to_overlapping_launch"
REASON_ANONYMOUS = "anonymous_launch"
REASON_SPLIT_LANE = "ops_on_split_lane"

#: Default window after a compile event's end within which an otherwise
#: unidentifiable launch is attributed to that compilation (first
#: execution of a freshly compiled program).
DEFAULT_COMPILE_ATTACH_WINDOW_US = 50_000.0


@dataclass(slots=True)
class CompileEvent:
    """One finished XLA compilation (ServeEngine.compile_events shape)."""

    program_id: str = ""
    module_name: str = ""
    end_us: float = 0.0
    duration_ms: float = 0.0

    @classmethod
    def from_any(cls, raw: Any) -> "CompileEvent":
        if isinstance(raw, CompileEvent):
            return raw
        if isinstance(raw, dict):
            return cls(
                program_id=str(raw.get("program_id", "")),
                module_name=str(
                    raw.get("module_name", raw.get("name", ""))
                ),
                end_us=float(raw.get("end_us", 0.0)),
                duration_ms=float(raw.get("duration_ms", 0.0)),
            )
        raise TypeError(f"not a compile event: {raw!r}")


@dataclass(slots=True)
class LaunchRecord:
    """One module launch's ledger entry."""

    name: str
    module_name: str
    program_id: str
    launch_id: int
    device_pid: int
    start_us: float
    duration_us: float
    #: Time this launch owns after the overlap clip (what its bucket
    #: receives) — equal to ``duration_us`` on a serial device timeline.
    owned_us: float
    #: Summed ops-lane device time inside this launch (0 for helpers).
    ops_us: float = 0.0
    ops_count: int = 0
    #: Where the ops came from: "own" lane, a recovered split "lane",
    #: or "" for dispatch-only helpers.
    ops_source: str = ""
    tier: str = TIER_NONE
    bucket: str = BUCKET_UNEXPLAINED
    reason: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "module": self.module_name or self.name,
            "program_id": self.program_id,
            "launch_id": self.launch_id,
            "device_pid": self.device_pid,
            "duration_us": round(self.duration_us, 1),
            "ops_us": round(self.ops_us, 1),
            "tier": self.tier,
            "bucket": self.bucket,
            "reason": self.reason,
        }


@dataclass(slots=True)
class DeviceWindow:
    """One device's observation window and busy/idle split."""

    device_pid: int
    window_start_us: float
    window_end_us: float
    busy_us: float
    idle_gap_us: float

    @property
    def window_us(self) -> float:
        return max(self.window_end_us - self.window_start_us, 0.0)


@dataclass(slots=True)
class DeviceLedger:
    """The full ledger: per-launch records, per-device windows, bucket
    totals, and the join rates the serving bench publishes."""

    launches: list[LaunchRecord] = field(default_factory=list)
    devices: list[DeviceWindow] = field(default_factory=list)
    #: bucket -> microseconds (sums to ``total_us`` — the invariant).
    buckets_us: dict[str, float] = field(default_factory=dict)
    tier_counts: dict[str, int] = field(default_factory=dict)
    reasons: dict[str, int] = field(default_factory=dict)
    #: Exact-identity matches over ALL module launches (helpers
    #: included) — the historical headline number, REPORTED ONLY; the
    #: substantive rate is the one gates consume.
    raw_join_rate: float = 0.0
    #: Fraction of ops-bearing launches whose identity a join can
    #: actually serve after the full tier ladder.
    substantive_join_rate: float = 0.0
    #: Exact-identity-only variant of the substantive rate (the number
    #: ``launch_match_breakdown`` historically published).
    exact_substantive_join_rate: float = 0.0
    launches_with_ops: int = 0
    orphan_ops_count: int = 0
    orphan_ops_unclaimed: int = 0

    @property
    def total_us(self) -> float:
        return sum(d.window_us for d in self.devices)

    @property
    def bucket_sum_us(self) -> float:
        return sum(self.buckets_us.values())

    @property
    def unexplained_share(self) -> float:
        total = self.total_us
        if total <= 0.0:
            return 0.0
        return self.buckets_us.get(BUCKET_UNEXPLAINED, 0.0) / total

    def bucket_ms(self) -> dict[str, float]:
        return {b: self.buckets_us.get(b, 0.0) / 1000.0 for b in ALL_BUCKETS}

    def idle_gap_ms(self) -> float:
        return self.buckets_us.get(BUCKET_IDLE_GAP, 0.0) / 1000.0

    def to_dict(self, example_cap: int = 12) -> dict[str, Any]:
        unexplained = [
            rec.to_dict()
            for rec in self.launches
            if rec.bucket == BUCKET_UNEXPLAINED
        ]
        return {
            "launches": dispatch_count(self),
            "launches_with_ops": self.launches_with_ops,
            "devices": len(self.devices),
            "total_device_time_ms": round(self.total_us / 1000.0, 3),
            "buckets_ms": {
                b: round(us / 1000.0, 3)
                for b, us in sorted(self.buckets_us.items())
            },
            "bucket_sum_ms": round(self.bucket_sum_us / 1000.0, 3),
            "unexplained_share": round(self.unexplained_share, 4),
            "tier_counts": dict(sorted(self.tier_counts.items())),
            "reasons": dict(sorted(self.reasons.items())),
            "raw_join_rate": round(self.raw_join_rate, 4),
            "substantive_join_rate": round(self.substantive_join_rate, 4),
            "exact_substantive_join_rate": round(
                self.exact_substantive_join_rate, 4
            ),
            "orphan_ops": {
                "total": self.orphan_ops_count,
                "unclaimed": self.orphan_ops_unclaimed,
            },
            "unexplained_examples": unexplained[:example_cap],
        }


_TIER_RANK = {
    TIER_IDENTITY: 0,
    TIER_LANE_WINDOW: 1,
    TIER_COMPILE_EVENT: 2,
    TIER_FRAME: 3,
    TIER_NONE: 4,
}


def dispatch_records(records: Iterable[LaunchRecord]) -> list[LaunchRecord]:
    """One record per dispatch, in order of first appearance: of the
    records of one (device, program, launch number), the one furthest up
    the tier ladder (the earliest on a tie) stands for the dispatch, so
    a dispatch joins when one of its runs joined.  A record without a
    launch number stands alone."""
    best: dict[tuple, LaunchRecord] = {}
    for i, rec in enumerate(records):
        key = (
            (rec.device_pid, rec.program_id, rec.launch_id)
            if rec.launch_id >= 0
            else (i,)
        )
        held = best.get(key)
        if held is None or _TIER_RANK[rec.tier] < _TIER_RANK[held.tier]:
            best[key] = rec
    return list(best.values())


def dispatch_count(ledger: DeviceLedger) -> int:
    """Launches in a ledger, counted by dispatch
    (:func:`dispatch_records`)."""
    return len(dispatch_records(ledger.launches))


def _compile_index(
    compile_events: Iterable[Any],
) -> tuple[dict[str, CompileEvent], list[CompileEvent], list[float]]:
    """(by program_id, by end-time order, sorted end times)."""
    events = [CompileEvent.from_any(e) for e in compile_events]
    by_id = {e.program_id: e for e in events if e.program_id}
    ordered = sorted(events, key=lambda e: e.end_us)
    return by_id, ordered, [e.end_us for e in ordered]


def _match_compile(
    rec: LaunchRecord,
    by_id: dict[str, CompileEvent],
    ordered: list[CompileEvent],
    end_times: list[float],
    attach_window_us: float,
    allow_time_window: bool,
) -> CompileEvent | None:
    """Owning compilation for a helper/anonymous launch, or None.

    Fingerprint identity first (canonical), then module-name prefix
    (helper programs are named after the compilation that emitted
    them), then — for ops-bearing launches only — the bounded
    first-execution window after a compile.  Dispatch-only helpers
    never time-window join: a glue launch that merely HAPPENS to follow
    a compile proves nothing, and claiming it would hide real
    unexplained time (the bucket this ledger exists to expose).
    """
    if rec.program_id and rec.program_id in by_id:
        return by_id[rec.program_id]
    name = rec.module_name or rec.name
    if name:
        for event in ordered:
            if not event.module_name:
                continue
            if name.startswith(event.module_name) or event.module_name.startswith(
                name
            ):
                return event
    if not allow_time_window:
        return None
    # Nearest compile that finished at or before this launch's start,
    # within the attach window.
    idx = bisect.bisect_right(end_times, rec.start_us) - 1
    if idx >= 0:
        event = ordered[idx]
        if rec.start_us - event.end_us <= attach_window_us:
            return event
    return None


def _contained_ops(
    mods: list[XLASpan], ops: list[XLASpan]
) -> tuple[dict[int, float], dict[int, int], list[int]]:
    """Assign each op to the latest-starting module span containing it.

    Returns ``(ops_us by module index, ops count by module index,
    unassigned op indexes)`` — the same containment rule as
    ``xla_spans._sum_ops_by_launch`` so the two stay join-compatible.
    """
    starts = [m.start_us for m in mods]
    ops_us: dict[int, float] = {}
    ops_n: dict[int, int] = {}
    unassigned: list[int] = []
    for i, op in enumerate(ops):
        idx = bisect.bisect_right(starts, op.start_us) - 1
        if idx < 0:
            unassigned.append(i)
            continue
        mod = mods[idx]
        if not op.start_us < mod.start_us + mod.duration_us:
            unassigned.append(i)
            continue
        ops_us[idx] = ops_us.get(idx, 0.0) + op.duration_us
        ops_n[idx] = ops_n.get(idx, 0) + 1
    return ops_us, ops_n, unassigned


def build_ledger(
    spans: Sequence[XLASpan],
    compile_events: Iterable[Any] = (),
    compile_attach_window_us: float = DEFAULT_COMPILE_ATTACH_WINDOW_US,
) -> DeviceLedger:
    """Fold one capture's spans into the device-time ledger.

    ``spans`` is a module+ops span list (``capture(include_ops=True)``
    or :func:`tpuslo_torch.deviceplane.synthetic.synthesize_xprof_trace`
    parsed through ``parse_trace_events``); ``compile_events`` is any
    iterable of :class:`CompileEvent`-shaped records with
    ``program_id``/``module_name``/``end_us``.
    """
    ledger = DeviceLedger()
    mods_by_dev: dict[int, list[XLASpan]] = {}
    ops_by_dev: dict[int, list[XLASpan]] = {}
    for span in spans:
        if span.lane == MODULES_LANE:
            mods_by_dev.setdefault(span.device_pid, []).append(span)
        elif span.lane == OPS_LANE:
            ops_by_dev.setdefault(span.device_pid, []).append(span)

    # Satellite lanes: pids that carry ops but no module lane at all —
    # xprof split those ops off their device's timeline.  They are
    # candidates for the lane_window tier, never devices themselves.
    # A satellite lane belongs to exactly ONE device; with overlapping
    # device timelines an op can sit inside several devices' launch
    # windows, so each lane is associated with the device whose module
    # windows contain the MOST of its ops (best containment fit), and
    # only that device may claim from it.
    sorted_mods = {
        pid: sorted(mods, key=lambda s: s.start_us)
        for pid, mods in mods_by_dev.items()
    }
    mod_starts = {
        pid: [m.start_us for m in mods]
        for pid, mods in sorted_mods.items()
    }

    def _containment_count(pid: int, ops: list[XLASpan]) -> int:
        mods = sorted_mods[pid]
        starts = mod_starts[pid]
        n = 0
        for op in ops:
            idx = bisect.bisect_right(starts, op.start_us) - 1
            if idx < 0:
                continue
            mod = mods[idx]
            if op.start_us + op.duration_us <= mod.start_us + mod.duration_us:
                n += 1
        return n

    device_rank = {pid: i for i, pid in enumerate(sorted(mods_by_dev))}
    lane_pids = sorted(
        pid for pid in ops_by_dev if pid not in mods_by_dev
    )
    lane_rank = {pid: i for i, pid in enumerate(lane_pids)}
    orphan_by_dev: dict[int, list[XLASpan]] = {}
    orphan_total = 0
    orphan_unowned = 0
    for lane_pid in lane_pids:
        lane_ops = ops_by_dev[lane_pid]
        orphan_total += len(lane_ops)
        best_pid, best_key = -1, (0, -1)
        for pid in sorted(mods_by_dev):
            n = _containment_count(pid, lane_ops)
            if n == 0:
                continue
            # Containment fit first; on a tie (overlapping device
            # timelines make full-window containment coincidental),
            # prefer rank alignment — xprof emits satellite lanes in
            # device order.
            key = (n, 1 if device_rank[pid] == lane_rank[lane_pid] else 0)
            if key > best_key:
                best_pid, best_key = pid, key
        if best_pid >= 0:
            orphan_by_dev.setdefault(best_pid, []).extend(lane_ops)
        else:
            orphan_unowned += len(lane_ops)
    for pool in orphan_by_dev.values():
        pool.sort(key=lambda s: s.start_us)
    ledger.orphan_ops_count = orphan_total

    by_id, ordered_compiles, compile_ends = _compile_index(compile_events)

    total_unclaimed = orphan_unowned
    for pid in sorted(mods_by_dev):
        mods = sorted_mods[pid]
        ops = sorted(ops_by_dev.get(pid, ()), key=lambda s: s.start_us)
        device_has_ops = bool(ops)
        orphan_ops = orphan_by_dev.get(pid, [])
        orphan_starts = [o.start_us for o in orphan_ops]
        orphan_claimed = [False] * len(orphan_ops)
        ops_us, ops_n, _unassigned = _contained_ops(mods, ops)

        # Observation window: every span the device emitted, ops
        # included (an op outside any module window still proves the
        # device was observed then).
        lo = min(s.start_us for s in (mods + ops))
        hi = max(s.start_us + s.duration_us for s in (mods + ops))

        # Overlap clip: each launch owns the part of its window no
        # earlier-starting launch already owns; merged busy time is the
        # running union, so owned times sum to it exactly.
        frontier = lo
        busy = 0.0
        records: list[LaunchRecord] = []
        for i, mod in enumerate(mods):
            end = mod.start_us + mod.duration_us
            owned = max(0.0, min(end, hi) - max(mod.start_us, frontier))
            frontier = max(frontier, end)
            busy += owned
            records.append(
                LaunchRecord(
                    name=mod.name,
                    module_name=mod.module_name,
                    program_id=mod.program_id,
                    launch_id=mod.launch_id,
                    device_pid=pid,
                    start_us=mod.start_us,
                    duration_us=mod.duration_us,
                    owned_us=owned,
                    ops_us=ops_us.get(i, 0.0),
                    ops_count=ops_n.get(i, 0),
                )
            )

        ledger.devices.append(
            DeviceWindow(
                device_pid=pid,
                window_start_us=lo,
                window_end_us=hi,
                busy_us=busy,
                idle_gap_us=max(hi - lo, 0.0) - busy,
            )
        )

        # --- tier ladder ------------------------------------------------
        for i, rec in enumerate(records):
            if rec.ops_count > 0:
                rec.ops_source = "own"
                if rec.launch_id >= 0:
                    rec.tier = TIER_IDENTITY
                    rec.bucket = BUCKET_JOINED
                    continue
                rec.reason = REASON_ANONYMOUS
                event = _match_compile(
                    rec, by_id, ordered_compiles, compile_ends,
                    compile_attach_window_us, allow_time_window=True,
                )
                if event is not None:
                    rec.tier = TIER_COMPILE_EVENT
                    rec.bucket = BUCKET_COMPILE
                continue

            # No ops on the launch's own lane: probe the satellite
            # pool for ops fully contained in this launch's window.
            lane_us = 0.0
            lane_n = 0
            start = bisect.bisect_left(orphan_starts, rec.start_us)
            j = start
            launch_end = rec.start_us + rec.duration_us
            while j < len(orphan_ops) and orphan_ops[j].start_us < launch_end:
                if not orphan_claimed[j]:
                    op = orphan_ops[j]
                    if op.start_us + op.duration_us <= launch_end:
                        orphan_claimed[j] = True
                        lane_us += op.duration_us
                        lane_n += 1
                j += 1
            if lane_n > 0:
                rec.ops_us = lane_us
                rec.ops_count = lane_n
                rec.ops_source = "lane"
                rec.reason = REASON_SPLIT_LANE
                if rec.launch_id >= 0:
                    rec.tier = TIER_LANE_WINDOW
                    rec.bucket = BUCKET_JOINED
                else:
                    rec.reason = REASON_ANONYMOUS
                    event = _match_compile(
                        rec, by_id, ordered_compiles, compile_ends,
                        compile_attach_window_us, allow_time_window=True,
                    )
                    if event is not None:
                        rec.tier = TIER_COMPILE_EVENT
                        rec.bucket = BUCKET_COMPILE
                continue

            # Dispatch-only helper (or a launch on an ops-less device).
            if not device_has_ops:
                rec.reason = REASON_NO_OPS_LANE
            elif any(
                rec.start_us <= op.start_us < launch_end for op in ops
            ):
                rec.reason = REASON_OVERLAPPING
            else:
                rec.reason = REASON_NO_CONTAINED_OPS
            event = _match_compile(
                rec, by_id, ordered_compiles, compile_ends,
                compile_attach_window_us, allow_time_window=False,
            )
            if event is not None:
                rec.tier = TIER_COMPILE_EVENT
                rec.bucket = BUCKET_HELPER

        # --- frame tier: step launches bucket the leftover helpers -----
        steps = [
            r for r in records if r.tier in (TIER_IDENTITY, TIER_LANE_WINDOW)
        ]
        step_starts = [s.start_us for s in steps]
        for rec in records:
            if rec.tier != TIER_NONE or rec.ops_count > 0:
                continue
            idx = bisect.bisect_right(step_starts, rec.start_us) - 1
            if idx >= 0:
                rec.tier = TIER_FRAME
                rec.bucket = BUCKET_HELPER

        ledger.launches.extend(records)
        total_unclaimed += orphan_claimed.count(False)

    for rec in ledger.launches:
        ledger.buckets_us[rec.bucket] = (
            ledger.buckets_us.get(rec.bucket, 0.0) + rec.owned_us
        )
    ledger.buckets_us[BUCKET_IDLE_GAP] = sum(
        d.idle_gap_us for d in ledger.devices
    )
    for bucket in ALL_BUCKETS:
        ledger.buckets_us.setdefault(bucket, 0.0)

    # Every count below is of dispatches, numerators and denominators
    # alike, so no rate can pass 1.
    dispatches = dispatch_records(ledger.launches)
    exact = with_ops = substantive = with_own_ops = anon_with_own_ops = 0
    for rec in dispatches:
        if rec.tier != TIER_NONE:
            ledger.tier_counts[rec.tier] = (
                ledger.tier_counts.get(rec.tier, 0) + 1
            )
        if rec.reason and rec.bucket == BUCKET_UNEXPLAINED:
            ledger.reasons[rec.reason] = ledger.reasons.get(rec.reason, 0) + 1
        exact += rec.tier == TIER_IDENTITY
        if rec.ops_count > 0:
            # Ops-bearing after lane recovery (the substantive
            # denominator): own-lane ops + lane-window recoveries.
            with_ops += 1
            substantive += rec.tier != TIER_NONE
        if rec.ops_source == "own":
            with_own_ops += 1
            anon_with_own_ops += rec.launch_id < 0

    ledger.launches_with_ops = with_ops
    ledger.orphan_ops_unclaimed = total_unclaimed
    ledger.raw_join_rate = exact / len(dispatches) if dispatches else 0.0
    ledger.substantive_join_rate = (
        substantive / with_ops if with_ops else 0.0
    )
    ledger.exact_substantive_join_rate = (
        (with_own_ops - anon_with_own_ops) / with_own_ops
        if with_own_ops
        else 0.0
    )
    return ledger


def idle_gap_probe_values(ledger: DeviceLedger) -> dict[str, float]:
    """Device-plane signal values derived from one ledger window —
    the feed for ``device_idle_gap_ms`` (``device_eviction_events_total``
    comes from the runtime's eviction notices, not the trace)."""
    return {"device_idle_gap_ms": round(ledger.idle_gap_ms(), 4)}
