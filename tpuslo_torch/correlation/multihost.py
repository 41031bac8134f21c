"""Multi-host slice correlation: collective straggler attribution (the
port's own copy of ``tpuslo/correlation/multihost.py``: the same joiner,
defaults and incidents, over the port's rejection counters and signal
constants).

The reference correlates one host's kernel signals to one host's spans
(`pkg/correlation/dns.go:50-76`); nothing in it joins streams *across*
hosts.  On a multi-host TPU pod that join is the whole game: every
cross-chip collective is a synchronization point over ICI, so a single
slow host (or a flaky ICI link) shows up in *every other host's*
``ici_collective_latency_ms`` stream (BASELINE.json config 4
"ICI collective tracing + multi-host DaemonSet correlation";
SURVEY.md §2.5 "multi-host correlation").

Physics of the join — for one launch of one collective:

* all participating hosts **finish together** (the collective completes
  when the last input arrives and the result is exchanged), but they
  **enter at different times**;
* a host that enters late — the *straggler* — therefore observes a
  **short** collective wall time (everyone else was already waiting for
  it), while the punctual hosts observe a **long** wall time (their
  clocks ran while blocked on the straggler).

So, grouping per-host ``ici_collective_latency_ms`` events by
``(slice_id, program_id, launch_id)``, the straggler is the host with
the *minimum* observed latency when the max−min skew is large.  That
launch-id keyed join is exact identity (the reason the xla_launch tier
exists, :mod:`tpuslo_torch.correlation.matcher`), so no timestamp windows are
involved in forming a group — only in attaching side evidence.

Cause refinement: if the straggler host also shows elevated
``ici_link_retries_total`` near the launch, the root cause is the
interconnect (``ici_link``), not host compute; otherwise it is reported
as a compute-side straggler (``compute_straggler``), e.g. host-offload
stall or CPU contention feeding the chip.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable

from tpuslo_torch.metrics.rejections import REJECTION_COUNTERS
from tpuslo_torch.signals.constants import (
    SIGNAL_DCN_TRANSFER_MS,
    SIGNAL_ICI_COLLECTIVE_MS,
    SIGNAL_ICI_LINK_RETRIES,
)

# Reason classes for events the joiner cannot use.  ``skipped`` stays as
# the aggregate for backwards compatibility; the per-reason map is what
# turns a silent False return into a triageable summary line.
SKIP_MISSING_SLICE_IDENTITY = "missing_slice_identity"
SKIP_MISSING_LAUNCH_ID = "missing_launch_id"
SKIP_UNMATCHED_SIGNAL = "unmatched_signal"
SKIP_BAD_FIELD_TYPE = "bad_field_type"

# A launch group is "skewed" when (max-min)/max exceeds this ratio AND
# the absolute skew exceeds the floor — both guards are needed because
# tiny collectives have large relative jitter and long collectives have
# meaningful absolute jitter.
DEFAULT_SKEW_RATIO = 0.5
DEFAULT_SKEW_FLOOR_MS = 5.0
# Link-retry evidence window around the group's launch timestamps.
DEFAULT_RETRY_WINDOW_NS = 2_000_000_000
# A launch group still missing hosts this long after the slice's newest
# observation is attributed best-effort and evicted (a host agent died
# — the very failure domain this tool diagnoses — or its stream was
# never fed in); keeps drain() memory bounded on long-lived streams.
DEFAULT_PENDING_HORIZON_NS = 30_000_000_000
# Retries on one link within the window to blame the interconnect.
DEFAULT_RETRY_THRESHOLD = 3.0

CAUSE_COMPUTE = "compute_straggler"
CAUSE_ICI_LINK = "ici_link"
# Cross-slice (DCN-path) stall: the skewed group is a dcn_transfer
# stream spanning slices, so the blame is the straggler's DCN path —
# ICI link evidence does not apply.
CAUSE_DCN = "dcn_path"
# Group key namespace for cross-slice dcn_transfer joins: the group
# spans slices by construction, so it cannot key on one slice_id.
CROSS_SLICE = "cross-slice"


@dataclass
class HostObservation:
    """One host's view of one collective launch."""

    host_index: int
    node: str
    latency_ms: float
    ts_unix_nano: int
    slice_id: str = ""  # filled for cross-slice (dcn) observations


@dataclass
class LaunchGroup:
    """All hosts' observations of one (slice, program, launch)."""

    slice_id: str
    program_id: str
    launch_id: int
    hosts: dict[int, HostObservation] = field(default_factory=dict)


@dataclass
class StragglerIncident:
    """One attributed cross-host straggler.

    ``confidence`` follows the tier ethos of the matcher: launch-id
    joins are near-exact, so confidence is driven by evidence quality
    (skew ratio, retry corroboration), not by timestamp proximity.
    """

    slice_id: str
    program_id: str
    launch_id: int
    straggler_host: int
    straggler_node: str
    cause: str
    skew_ms: float
    skew_ratio: float
    n_hosts: int
    confidence: float
    ici_link: int = -1
    link_retries: float = 0.0
    host_latencies_ms: dict[int, float] = field(default_factory=dict)
    straggler_slice: str = ""  # set for cross-slice (dcn) incidents

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "slice_id": self.slice_id,
            "program_id": self.program_id,
            "launch_id": self.launch_id,
            "straggler_host": self.straggler_host,
            "straggler_node": self.straggler_node,
            "cause": self.cause,
            "skew_ms": round(self.skew_ms, 3),
            "skew_ratio": round(self.skew_ratio, 4),
            "n_hosts": self.n_hosts,
            "confidence": round(self.confidence, 4),
            "host_latencies_ms": {
                str(k): round(v, 3) for k, v in sorted(self.host_latencies_ms.items())
            },
        }
        if self.cause == CAUSE_ICI_LINK:
            out["ici_link"] = self.ici_link
            out["link_retries"] = self.link_retries
        if self.straggler_slice:
            out["straggler_slice"] = self.straggler_slice
        return out


@dataclass
class _RetryObservation:
    host_index: int
    ici_link: int
    value: float
    ts_unix_nano: int


class SliceJoiner:
    """Joins per-host agent streams for one or more slices.

    Feed it raw ``ProbeEventV1`` dicts (the JSONL the per-host agents
    emit) in any order and any host interleaving.  Batch call sites use
    ``incidents()``, which inspects without evicting (idempotent, may
    re-report).  Streaming call sites use ``drain(min_hosts)``
    periodically: it reports each launch group at most once, evicts
    evaluated groups, and prunes aged retry evidence, so memory stays
    bounded on a long-lived stream.
    """

    def __init__(
        self,
        expected_hosts: int = 0,
        skew_ratio: float = DEFAULT_SKEW_RATIO,
        skew_floor_ms: float = DEFAULT_SKEW_FLOOR_MS,
        retry_window_ns: int = DEFAULT_RETRY_WINDOW_NS,
        retry_threshold: float = DEFAULT_RETRY_THRESHOLD,
        pending_horizon_ns: int = DEFAULT_PENDING_HORIZON_NS,
    ):
        self.expected_hosts = expected_hosts
        self.skew_ratio = skew_ratio
        self.skew_floor_ms = skew_floor_ms
        self.retry_window_ns = retry_window_ns
        self.retry_threshold = retry_threshold
        self.pending_horizon_ns = pending_horizon_ns
        self._groups: dict[tuple[str, str, int], LaunchGroup] = {}
        self._retries: dict[str, list[_RetryObservation]] = {}
        # Highest distinct host_index count ever seen on one launch,
        # per slice: the completeness proxy when expected_hosts is
        # unset (a launch is only "everyone reported" once it matches
        # the widest membership this slice has demonstrated).
        self._seen_hosts: dict[str, int] = {}
        self.ingested = 0
        self.skipped = 0
        self.skipped_by_reason: dict[str, int] = {}
        # Stale groups evicted by drain() with too few hosts to
        # attribute (single reporter): surfaced so a dead-pod diagnosis
        # is not silently discarded.
        self.dropped_unattributable = 0

    def _skip(self, reason: str) -> bool:
        self.skipped += 1
        self.skipped_by_reason[reason] = (
            self.skipped_by_reason.get(reason, 0) + 1
        )
        REJECTION_COUNTERS.note("slice_joiner", reason)
        return False

    def add(self, event: dict[str, Any]) -> bool:
        """Ingest one probe-event dict; returns True if it was used.

        Every False is reason-classed (``skipped_by_reason`` plus the
        process-wide ``slice_joiner.*`` rejection counters) — a missing
        identity field is a telemetry-quality fact, not a silent drop.
        """
        tpu = event.get("tpu") or {}
        if not isinstance(tpu, dict):
            return self._skip(SKIP_BAD_FIELD_TYPE)
        try:
            slice_id = tpu.get("slice_id", "")
            host_index = int(tpu.get("host_index", -1))
            signal = event.get("signal", "")
            if not slice_id or host_index < 0:
                return self._skip(SKIP_MISSING_SLICE_IDENTITY)
            launch_id = int(tpu.get("launch_id", -1))
            ici_link = int(tpu.get("ici_link", -1))
            value = float(event.get("value", 0.0))
            ts_unix_nano = int(event.get("ts_unix_nano", 0))
        except (TypeError, ValueError):
            # Corrupt field types (a string host_index, a dict value)
            # must not abort the whole stream one bad row in.
            return self._skip(SKIP_BAD_FIELD_TYPE)

        if signal == SIGNAL_ICI_COLLECTIVE_MS:
            program_id = tpu.get("program_id", "")
            if launch_id < 0:
                return self._skip(SKIP_MISSING_LAUNCH_ID)
            key = (slice_id, program_id, launch_id)
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = LaunchGroup(
                    slice_id=slice_id, program_id=program_id, launch_id=launch_id
                )
            group.hosts[host_index] = HostObservation(
                host_index=host_index,
                node=event.get("node", ""),
                latency_ms=value,
                ts_unix_nano=ts_unix_nano,
            )
            self._seen_hosts[slice_id] = max(
                self._seen_hosts.get(slice_id, 0), len(group.hosts)
            )
            self.ingested += 1
            return True

        if signal == SIGNAL_DCN_TRANSFER_MS:
            # Cross-slice transfer component: the launch group spans
            # slices, so it keys on (program, launch) alone under the
            # CROSS_SLICE namespace; each observation remembers its
            # own slice for the incident verdict.
            program_id = tpu.get("program_id", "")
            if launch_id < 0:
                return self._skip(SKIP_MISSING_LAUNCH_ID)
            key = (CROSS_SLICE, program_id, launch_id)
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = LaunchGroup(
                    slice_id=CROSS_SLICE, program_id=program_id,
                    launch_id=launch_id,
                )
            group.hosts[host_index] = HostObservation(
                host_index=host_index,
                node=event.get("node", ""),
                latency_ms=value,
                ts_unix_nano=ts_unix_nano,
                slice_id=slice_id,
            )
            self._seen_hosts[CROSS_SLICE] = max(
                self._seen_hosts.get(CROSS_SLICE, 0), len(group.hosts)
            )
            self.ingested += 1
            return True

        if signal == SIGNAL_ICI_LINK_RETRIES:
            self._retries.setdefault(slice_id, []).append(
                _RetryObservation(
                    host_index=host_index,
                    ici_link=ici_link,
                    value=value,
                    ts_unix_nano=ts_unix_nano,
                )
            )
            self.ingested += 1
            return True

        return self._skip(SKIP_UNMATCHED_SIGNAL)

    def add_all(self, events: Iterable[dict[str, Any]]) -> int:
        return sum(1 for e in events if self.add(e))

    def _link_evidence(
        self, slice_id: str, host_index: int, around_ns: int
    ) -> tuple[int, float]:
        """Summed retries per link on one host near a launch; best link."""
        per_link: dict[int, float] = {}
        for obs in self._retries.get(slice_id, []):
            if obs.host_index != host_index:
                continue
            if abs(obs.ts_unix_nano - around_ns) > self.retry_window_ns:
                continue
            per_link[obs.ici_link] = per_link.get(obs.ici_link, 0.0) + obs.value
        if not per_link:
            return -1, 0.0
        link = max(per_link, key=lambda k: per_link[k])
        return link, per_link[link]

    def incidents(self, min_hosts: int = 2) -> list[StragglerIncident]:
        """Attribute every sufficiently-populated, skewed launch group.

        ``min_hosts`` guards against attributing from a partial join
        (an agent stream that has not arrived yet); when
        ``expected_hosts`` is set it also caps the completeness factor
        in the confidence score.
        """
        return self._evaluate(self._groups.values(), min_hosts)

    def _evaluate(
        self, groups: Iterable[LaunchGroup], min_hosts: int
    ) -> list[StragglerIncident]:
        out: list[StragglerIncident] = []
        for group in groups:
            if len(group.hosts) < max(2, min_hosts):
                continue
            obs = sorted(group.hosts.values(), key=lambda o: o.latency_ms)
            fastest, slowest = obs[0], obs[-1]
            skew = slowest.latency_ms - fastest.latency_ms
            ratio = skew / slowest.latency_ms if slowest.latency_ms > 0 else 0.0
            if skew < self.skew_floor_ms or ratio < self.skew_ratio:
                continue

            if group.slice_id == CROSS_SLICE:
                # dcn_transfer group: the stall is on the straggler
                # SLICE's DCN path.  Cross-slice data can only name the
                # slice — every host of the straggler slice shows a
                # near-zero dcn component (the delayed host slept, its
                # intra peers absorbed the stall intra-slice), so the
                # within-slice pick would be jitter.  The verdict is
                # the slice with the lowest mean component; the
                # reported host is its lowest representative, and the
                # intra-slice ICI groups carry the per-host verdict.
                by_slice: dict[str, list[HostObservation]] = {}
                for o in obs:
                    by_slice.setdefault(o.slice_id, []).append(o)
                slice_means = {
                    sid: sum(o.latency_ms for o in rows) / len(rows)
                    for sid, rows in by_slice.items()
                }
                straggler_sid = min(slice_means, key=slice_means.get)
                fastest = min(
                    by_slice[straggler_sid], key=lambda o: o.latency_ms
                )
                link, retries = -1, 0.0
                cause = CAUSE_DCN
            else:
                link, retries = self._link_evidence(
                    group.slice_id, fastest.host_index, fastest.ts_unix_nano
                )
                cause = (
                    CAUSE_ICI_LINK
                    if retries >= self.retry_threshold
                    else CAUSE_COMPUTE
                )
            completeness = 1.0
            if self.expected_hosts > 0:
                completeness = min(1.0, len(group.hosts) / self.expected_hosts)
            # Base 0.75 mirrors the slice_host tier; exact launch-id
            # grouping plus strong skew raises it, partial host
            # coverage lowers it, retry corroboration raises it again.
            confidence = 0.75 + 0.15 * min(1.0, ratio) * completeness
            if cause == CAUSE_ICI_LINK:
                confidence = min(0.99, confidence + 0.05)
            out.append(
                StragglerIncident(
                    slice_id=group.slice_id,
                    program_id=group.program_id,
                    launch_id=group.launch_id,
                    straggler_host=fastest.host_index,
                    straggler_node=fastest.node,
                    cause=cause,
                    skew_ms=skew,
                    skew_ratio=ratio,
                    n_hosts=len(group.hosts),
                    confidence=round(confidence, 4),
                    ici_link=link if cause == CAUSE_ICI_LINK else -1,
                    link_retries=retries if cause == CAUSE_ICI_LINK else 0.0,
                    host_latencies_ms={
                        o.host_index: o.latency_ms for o in obs
                    },
                    straggler_slice=(
                        fastest.slice_id
                        if group.slice_id == CROSS_SLICE
                        else ""
                    ),
                )
            )
        out.sort(key=lambda i: (-i.confidence, -i.skew_ms, i.launch_id))
        return out

    def drain(self, min_hosts: int = 2) -> list[StragglerIncident]:
        """Streaming variant of :meth:`incidents`: report-once + evict.

        A group is *complete* — and therefore final, skewed or healthy —
        once every expected host has reported: ``expected_hosts`` when
        set, else the widest membership this slice has demonstrated on
        any launch so far (never below ``min_hosts``).  Complete groups
        are evaluated and evicted; incomplete ones are kept for
        late-arriving host streams, so a launch is reported at most
        once and a straggler whose *stream* is also lagging is still
        attributed when it finally lands.  Incomplete groups older than
        ``pending_horizon_ns`` behind *their own slice's* newest
        observation (a host agent died mid-stream) are attributed
        best-effort from whoever reported, then evicted — memory stays
        bounded even when a host stream stops.  Attribution needs at
        least two reporting hosts (skew is relative); a stale group
        with a single reporter cannot be attributed and is evicted
        counted under ``dropped_unattributable``.  Retry evidence is
        pruned against the *pending horizon* (never less than twice the
        retry window) behind the newest observation, so link-retry
        corroboration outlives any group that may still reference it.
        """

        def threshold_for(slice_id: str) -> int:
            if self.expected_hosts > 0:
                return self.expected_hosts
            return max(2, min_hosts, self._seen_hosts.get(slice_id, 0))

        complete: dict[tuple[str, str, int], LaunchGroup] = {}
        newest_by_slice: dict[str, int] = {}
        for key, group in self._groups.items():
            for obs in group.hosts.values():
                newest_by_slice[group.slice_id] = max(
                    newest_by_slice.get(group.slice_id, 0), obs.ts_unix_nano
                )
            if len(group.hosts) >= threshold_for(group.slice_id):
                complete[key] = group
        stale = {
            key: group
            for key, group in self._groups.items()
            if key not in complete
            and max(o.ts_unix_nano for o in group.hosts.values())
            < newest_by_slice[group.slice_id] - self.pending_horizon_ns
        }
        out = self._evaluate(complete.values(), min_hosts)
        out += self._evaluate(stale.values(), min_hosts)
        out.sort(key=lambda i: (-i.confidence, -i.skew_ms, i.launch_id))
        for group in stale.values():
            if len(group.hosts) < max(2, min_hosts):
                self.dropped_unattributable += 1
        for key in complete:
            del self._groups[key]
        for key in stale:
            del self._groups[key]
        for slice_id, observations in list(self._retries.items()):
            if not observations:
                del self._retries[slice_id]
                continue
            horizon = max(o.ts_unix_nano for o in observations) - max(
                self.pending_horizon_ns, 2 * self.retry_window_ns
            )
            kept = [o for o in observations if o.ts_unix_nano >= horizon]
            if kept:
                self._retries[slice_id] = kept
            else:
                del self._retries[slice_id]
        return out
