"""Tiered confidence matching of kernel/TPU signals to workload spans.

Reference: ``pkg/correlation/dns.go:50-105`` — four tiers
(trace_id=1.0, pod+pid≤100ms=0.9, pod+conn≤250ms=0.8,
service+node≤500ms=0.65; enrichment threshold 0.70).

The TPU-native build inserts two tiers:

* ``xla_launch`` (0.95, ≤250ms) — join on XLA program + launch id.  TPU
  work is submitted asynchronously, so wall-clock windows are too coarse
  for per-step attribution; the launch id recovered by libtpu uprobes is
  near-exact identity (only "near" because id reuse across processes is
  possible after restarts).
* ``slice_host`` (0.75, ≤250ms) — join on megascale slice + host index,
  for driver-level events that carry no pod/pid identity; this replaces
  pod+conn for cross-host correlation on multi-host pods (SURVEY.md
  §2.5 "multi-host correlation").
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import Any, Callable, Sequence

from tpuslo_torch import semconv
from tpuslo_torch.metrics.rejections import REJECTION_COUNTERS
from tpuslo_torch.schema import parse_rfc3339

DEFAULT_WINDOW_MS = 2000
DEFAULT_ENRICHMENT_THRESHOLD = 0.7

# Confidence for an exact trace-id join when either timestamp is
# missing or unparseable: the identity is exact but un-anchored in
# time, so it must not clear the 0.7 enrichment threshold and must not
# shadow any tier that *did* pass its window check (lowest tier is
# service_node at 0.65).
MISSING_TS_CONFIDENCE = 0.6

TIER_TRACE_ID = "trace_id_exact"
TIER_XLA_LAUNCH = "xla_launch"
TIER_POD_PID = "pod_pid_100ms"
TIER_POD_CONN = "pod_conn_250ms"
TIER_SLICE_HOST = "slice_host_250ms"
TIER_SERVICE_NODE = "service_node_500ms"

TIER_CONFIDENCE = {
    TIER_TRACE_ID: 1.0,
    TIER_XLA_LAUNCH: 0.95,
    TIER_POD_PID: 0.9,
    TIER_POD_CONN: 0.8,
    TIER_SLICE_HOST: 0.75,
    TIER_SERVICE_NODE: 0.65,
}


def _ts(raw: Any) -> datetime | None:
    """Parse a raw timestamp; unparseable inputs are None, not a crash.

    Rejections are tallied (``matcher.unparseable_timestamp`` /
    ``matcher.bad_timestamp_type``) instead of silently discarded: a
    corrupt timestamp downgrades the pair to the missing-timestamp
    path, it does not abort the whole batch.
    """
    if raw is None or isinstance(raw, datetime):
        return raw
    if isinstance(raw, str):
        try:
            return parse_rfc3339(raw)
        except ValueError:
            REJECTION_COUNTERS.note("matcher", "unparseable_timestamp")
            return None
    REJECTION_COUNTERS.note("matcher", "bad_timestamp_type")
    return None


@dataclass(slots=True)
class SpanRef:
    """Minimal span metadata used for correlation."""

    timestamp: datetime | None = None
    trace_id: str = ""
    service: str = ""
    node: str = ""
    pod: str = ""
    pid: int = 0
    conn_tuple: str = ""
    # TPU identity (from JAX/XLA span attributes).
    slice_id: str = ""
    host_index: int = -1
    program_id: str = ""
    launch_id: int = -1

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "SpanRef":
        return cls(
            timestamp=_ts(raw.get("timestamp")),
            trace_id=raw.get("trace_id", ""),
            service=raw.get("service", ""),
            node=raw.get("node", ""),
            pod=raw.get("pod", ""),
            pid=int(raw.get("pid", 0)),
            conn_tuple=raw.get("conn_tuple", ""),
            slice_id=raw.get("slice_id", ""),
            host_index=int(raw.get("host_index", -1)),
            program_id=raw.get("program_id", ""),
            launch_id=int(raw.get("launch_id", -1)),
        )


@dataclass(slots=True)
class SignalRef:
    """Normalized signal metadata for correlation."""

    signal: str = ""
    timestamp: datetime | None = None
    trace_id: str = ""
    service: str = ""
    node: str = ""
    pod: str = ""
    pid: int = 0
    conn_tuple: str = ""
    value: float = 0.0
    slice_id: str = ""
    host_index: int = -1
    program_id: str = ""
    launch_id: int = -1

    @classmethod
    def from_dict(cls, raw: dict[str, Any]) -> "SignalRef":
        return cls(
            signal=raw.get("signal", ""),
            timestamp=_ts(raw.get("timestamp")),
            trace_id=raw.get("trace_id", ""),
            service=raw.get("service", ""),
            node=raw.get("node", ""),
            pod=raw.get("pod", ""),
            pid=int(raw.get("pid", 0)),
            conn_tuple=raw.get("conn_tuple", ""),
            value=float(raw.get("value", 0.0)),
            slice_id=raw.get("slice_id", ""),
            host_index=int(raw.get("host_index", -1)),
            program_id=raw.get("program_id", ""),
            launch_id=int(raw.get("launch_id", -1)),
        )

    @classmethod
    def from_probe_dict(cls, event: dict[str, Any]) -> "SignalRef":
        """Build a SignalRef from a ``ProbeEventV1``-shaped dict.

        The agent's JSONL rows carry ``ts_unix_nano`` (not an RFC3339
        ``timestamp``) and nest TPU identity under ``tpu``; this is the
        adapter the ingest gate's late re-match pass uses.  A missing
        or non-positive ``ts_unix_nano`` yields a None timestamp (the
        capped-confidence path), never a crash.
        """
        ts_raw = event.get("ts_unix_nano")
        timestamp = None
        if type(ts_raw) is int and ts_raw > 0:
            timestamp = datetime.fromtimestamp(ts_raw / 1e9, tz=timezone.utc)
        conn = event.get("conn_tuple")
        conn_key = ""
        if isinstance(conn, dict):
            conn_key = (
                f"{conn.get('protocol', '')}:"
                f"{conn.get('src_ip', '')}:{conn.get('src_port', 0)}"
                f"->{conn.get('dst_ip', '')}:{conn.get('dst_port', 0)}"
            )
        tpu = event.get("tpu") or {}
        try:
            pid = int(event.get("pid", 0))
            host_index = int(tpu.get("host_index", -1))
            launch_id = int(tpu.get("launch_id", -1))
            value = float(event.get("value", 0.0))
        except (TypeError, ValueError):
            pid, host_index, launch_id, value = 0, -1, -1, 0.0
        return cls(
            signal=str(event.get("signal", "")),
            timestamp=timestamp,
            trace_id=str(event.get("trace_id", "")),
            node=str(event.get("node", "")),
            pod=str(event.get("pod", "")),
            pid=pid,
            conn_tuple=conn_key,
            value=value,
            slice_id=str(tpu.get("slice_id", "")),
            host_index=host_index,
            program_id=str(tpu.get("program_id", "")),
            launch_id=launch_id,
        )


@dataclass(slots=True)
class Decision:
    """One correlation result."""

    matched: bool = False
    confidence: float = 0.0
    tier: str = ""


def _within(a: datetime | None, b: datetime | None, window: timedelta) -> bool:
    if a is None or b is None:
        return False
    return abs(a - b) <= window


def match(span: SpanRef, signal: SignalRef, window_ms: int = 0) -> Decision:
    """Compute confidence/tier for one span-signal pair.

    A trace-id join with a missing timestamp on either side still
    matches (the identity is exact), but at
    :data:`MISSING_TS_CONFIDENCE` — below every windowed tier and below
    the enrichment threshold, so an un-anchored join can never claim
    the full 1.0 the windowed trace tier earns.
    """
    window = timedelta(milliseconds=window_ms if window_ms > 0 else DEFAULT_WINDOW_MS)
    trace_match = bool(span.trace_id) and span.trace_id == signal.trace_id
    if span.timestamp is None or signal.timestamp is None:
        if trace_match:
            return Decision(True, MISSING_TS_CONFIDENCE, TIER_TRACE_ID)
        return Decision()
    if not _within(span.timestamp, signal.timestamp, window):
        return Decision()

    if trace_match:
        return Decision(True, TIER_CONFIDENCE[TIER_TRACE_ID], TIER_TRACE_ID)

    if (
        span.program_id
        and span.program_id == signal.program_id
        and span.launch_id >= 0
        and span.launch_id == signal.launch_id
        and _within(span.timestamp, signal.timestamp, timedelta(milliseconds=250))
    ):
        return Decision(True, TIER_CONFIDENCE[TIER_XLA_LAUNCH], TIER_XLA_LAUNCH)

    if (
        span.pod
        and span.pod == signal.pod
        and span.pid > 0
        and span.pid == signal.pid
        and _within(span.timestamp, signal.timestamp, timedelta(milliseconds=100))
    ):
        return Decision(True, TIER_CONFIDENCE[TIER_POD_PID], TIER_POD_PID)

    if (
        span.pod
        and span.pod == signal.pod
        and span.conn_tuple
        and span.conn_tuple == signal.conn_tuple
        and _within(span.timestamp, signal.timestamp, timedelta(milliseconds=250))
    ):
        return Decision(True, TIER_CONFIDENCE[TIER_POD_CONN], TIER_POD_CONN)

    if (
        span.slice_id
        and span.slice_id == signal.slice_id
        and span.host_index >= 0
        and span.host_index == signal.host_index
        and _within(span.timestamp, signal.timestamp, timedelta(milliseconds=250))
    ):
        return Decision(True, TIER_CONFIDENCE[TIER_SLICE_HOST], TIER_SLICE_HOST)

    if (
        span.service
        and span.service == signal.service
        and span.node
        and span.node == signal.node
        and _within(span.timestamp, signal.timestamp, timedelta(milliseconds=500))
    ):
        return Decision(True, TIER_CONFIDENCE[TIER_SERVICE_NODE], TIER_SERVICE_NODE)

    return Decision()


def enrich_dns(
    base: dict[str, float] | None,
    span: SpanRef,
    signal: SignalRef,
    window_ms: int = 0,
    threshold: float = 0.0,
) -> tuple[dict[str, float], Decision]:
    """Apply DNS attributes when confidence passes the threshold.

    Reference: ``pkg/correlation/dns.go:79-105``.

    Every path copies the caller's mapping exactly once (the returned
    dict is always safe to mutate; the input is never touched).
    """
    threshold = threshold if threshold > 0 else DEFAULT_ENRICHMENT_THRESHOLD

    decision = match(span, signal, window_ms)
    if not decision.matched or decision.confidence < threshold:
        return dict(base or {}), decision
    if signal.signal != "dns_latency_ms":
        return dict(base or {}), Decision()

    out = dict(base or {})
    out[semconv.ATTR_DNS_LATENCY_MS] = signal.value
    out[semconv.ATTR_CORRELATION_CONF] = decision.confidence
    return out, decision


# --- batched correlation -------------------------------------------------
#
# The pairwise loop is O(spans x signals) with a timedelta allocation per
# probe; at agent batch sizes (hundreds of spans x thousands of signals)
# it dominates the correlation stage.  ``match_batch`` builds one hash
# index per tier over the signal set (exact join key -> timestamp-sorted
# postings) and answers each span with bisect window probes: O(n + m)
# index build plus O(log m + k) per span per tier.
#
# Timestamps are reduced to integer microseconds relative to a per-batch
# reference so window-edge comparisons are exact (floats at epoch
# magnitude cannot represent every microsecond, and the 100/250/500 ms
# tier edges are inclusive).  tests/test_torch_matcher.py proves parity
# with the pairwise ``match`` across all six tiers and window edges.

_US = timedelta(microseconds=1)

# (tier, tier window in ms or None for the global window only,
#  span join key, signal join key).  Order = descending confidence, which
# makes "first tier with any candidate" equal to the pairwise maximum:
# if a higher tier had a candidate for this span, no lower-tier posting
# can out-score it, and within the winning tier every in-window posting
# has exactly that pairwise tier (higher-tier keys for this span came up
# empty).
_TIER_SPECS: tuple[
    tuple[
        str,
        int | None,
        Callable[[SpanRef], Any],
        Callable[[SignalRef], Any],
    ],
    ...,
] = (
    (
        TIER_TRACE_ID,
        None,
        lambda s: s.trace_id if s.trace_id else None,
        lambda s: s.trace_id if s.trace_id else None,
    ),
    (
        TIER_XLA_LAUNCH,
        250,
        lambda s: (s.program_id, s.launch_id)
        if s.program_id and s.launch_id >= 0
        else None,
        lambda s: (s.program_id, s.launch_id)
        if s.program_id and s.launch_id >= 0
        else None,
    ),
    (
        TIER_POD_PID,
        100,
        lambda s: (s.pod, s.pid) if s.pod and s.pid > 0 else None,
        lambda s: (s.pod, s.pid) if s.pod and s.pid > 0 else None,
    ),
    (
        TIER_POD_CONN,
        250,
        lambda s: (s.pod, s.conn_tuple) if s.pod and s.conn_tuple else None,
        lambda s: (s.pod, s.conn_tuple) if s.pod and s.conn_tuple else None,
    ),
    (
        TIER_SLICE_HOST,
        250,
        lambda s: (s.slice_id, s.host_index)
        if s.slice_id and s.host_index >= 0
        else None,
        lambda s: (s.slice_id, s.host_index)
        if s.slice_id and s.host_index >= 0
        else None,
    ),
    (
        TIER_SERVICE_NODE,
        500,
        lambda s: (s.service, s.node) if s.service and s.node else None,
        lambda s: (s.service, s.node) if s.service and s.node else None,
    ),
)


@dataclass(slots=True)
class BatchMatch:
    """Best correlation for one span out of a signal batch.

    ``signal_index`` is -1 when no signal matched; otherwise it is the
    lowest index among the signals tied at the winning confidence —
    i.e. exactly the signal a first-strict-maximum pairwise scan with
    :func:`match` would have kept.
    """

    span_index: int
    signal_index: int
    decision: Decision


def match_batch(
    spans: Sequence[SpanRef],
    signals: Sequence[SignalRef],
    window_ms: int = 0,
) -> list[BatchMatch]:
    """Best-match correlation of a span batch against a signal batch.

    Returns one :class:`BatchMatch` per span, in span order.  For every
    span the decision equals the highest-confidence pairwise
    ``match(span, signal, window_ms)`` over all signals (first maximum
    on ties).  Timestamps must be consistently naive or consistently
    timezone-aware across the batch, like the pairwise matcher itself.
    """
    global_ms = window_ms if window_ms > 0 else DEFAULT_WINDOW_MS

    # Missing-timestamp trace joins (pairwise MISSING_TS_CONFIDENCE):
    # a span with no timestamp matches any signal sharing its trace id;
    # a span WITH a timestamp falls back to trace-matching signals that
    # themselves lack one — but only when no windowed tier matched,
    # because 0.6 is below every windowed tier's confidence.
    trace_min_any: dict[str, int] = {}
    trace_min_no_ts: dict[str, int] = {}
    for idx, signal in enumerate(signals):
        if not signal.trace_id:
            continue
        trace_min_any.setdefault(signal.trace_id, idx)
        if signal.timestamp is None:
            trace_min_no_ts.setdefault(signal.trace_id, idx)

    def _missing_ts_match(span_index: int, lookup: dict[str, int]) -> BatchMatch:
        idx = lookup.get(spans[span_index].trace_id, -1) if spans[
            span_index
        ].trace_id else -1
        if idx < 0:
            return BatchMatch(span_index, -1, Decision())
        return BatchMatch(
            span_index,
            idx,
            Decision(True, MISSING_TS_CONFIDENCE, TIER_TRACE_ID),
        )

    ref: datetime | None = None
    for signal in signals:
        if signal.timestamp is not None:
            ref = signal.timestamp
            break
    if ref is None:
        return [
            _missing_ts_match(
                i,
                trace_min_any if spans[i].timestamp is None else trace_min_no_ts,
            )
            for i in range(len(spans))
        ]

    # One pass over the signals builds all six tier indexes:
    # key -> [(microseconds-from-ref, signal index), ...], sorted.
    indexes: list[dict[Any, list[tuple[int, int]]]] = [
        {} for _ in _TIER_SPECS
    ]
    for idx, signal in enumerate(signals):
        ts = signal.timestamp
        if ts is None:
            continue
        ts_us = (ts - ref) // _US
        for tier_pos, (_, _, _, signal_key) in enumerate(_TIER_SPECS):
            key = signal_key(signal)
            if key is not None:
                indexes[tier_pos].setdefault(key, []).append((ts_us, idx))
    for index in indexes:
        for postings in index.values():
            postings.sort()

    out: list[BatchMatch] = []
    for span_index, span in enumerate(spans):
        if span.timestamp is None:
            out.append(_missing_ts_match(span_index, trace_min_any))
            continue
        span_us = (span.timestamp - ref) // _US
        best_index = -1
        best_tier = ""
        for tier_pos, (tier, tier_ms, span_key, _) in enumerate(_TIER_SPECS):
            key = span_key(span)
            if key is None:
                continue
            postings = indexes[tier_pos].get(key)
            if not postings:
                continue
            w_us = (
                global_ms if tier_ms is None else min(global_ms, tier_ms)
            ) * 1000
            lo = bisect_left(postings, (span_us - w_us, -1))
            hi = bisect_right(postings, (span_us + w_us, len(signals)))
            if lo < hi:
                best_index = min(idx for _, idx in postings[lo:hi])
                best_tier = tier
                break
        if best_index < 0:
            out.append(_missing_ts_match(span_index, trace_min_no_ts))
        else:
            out.append(
                BatchMatch(
                    span_index,
                    best_index,
                    Decision(True, TIER_CONFIDENCE[best_tier], best_tier),
                )
            )
    return out
