"""L11 SLO math: TTFT, token throughput, retrieval breakdown, percentiles
(the port's own copy of ``tpuslo/slo/calculator.py``).

Reference: ``pkg/slo/calculator.go:11-149``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from datetime import datetime


@dataclass
class Timing:
    """One request generation timeline."""

    request_start: datetime | None = None
    first_token_at: datetime | None = None
    last_token_at: datetime | None = None
    token_count: int = 0


@dataclass
class RetrievalBreakdown:
    """Retrieval latency components."""

    vectordb_ms: float = 0.0
    network_ms: float = 0.0
    dns_ms: float = 0.0


@dataclass
class Snapshot:
    """One request-level SLO observation."""

    ttft_ms: float = 0.0
    tokens_per_s: float = 0.0
    retrieval: RetrievalBreakdown = field(default_factory=RetrievalBreakdown)


@dataclass
class Percentiles:
    """Distribution summary over SLO snapshots."""

    ttft_p50: float = 0.0
    ttft_p95: float = 0.0
    ttft_p99: float = 0.0
    tokens_per_s_p50: float = 0.0
    tokens_per_s_p95: float = 0.0
    retrieval_p95_ms: float = 0.0


def ttft_ms(request_start: datetime | None, first_token_at: datetime | None) -> float:
    """Time-to-first-token in milliseconds."""
    if request_start is None or first_token_at is None:
        raise ValueError("request_start and first_token_at are required")
    if first_token_at < request_start:
        raise ValueError("first_token_at must be after request_start")
    return (first_token_at - request_start).total_seconds() * 1000.0


def tokens_per_second(
    first_token_at: datetime | None,
    last_token_at: datetime | None,
    token_count: int,
) -> float:
    """Generation throughput from first to last token."""
    if first_token_at is None or last_token_at is None:
        raise ValueError("first_token_at and last_token_at are required")
    if token_count < 1:
        raise ValueError("token_count must be >= 1")
    if last_token_at < first_token_at:
        raise ValueError("last_token_at must be after first_token_at")
    window_s = (last_token_at - first_token_at).total_seconds()
    if window_s == 0:
        return float(token_count)
    return token_count / window_s


def calculate(timing: Timing, retrieval: RetrievalBreakdown | None = None) -> Snapshot:
    """One request-level SLO snapshot."""
    return Snapshot(
        ttft_ms=ttft_ms(timing.request_start, timing.first_token_at),
        tokens_per_s=tokens_per_second(
            timing.first_token_at, timing.last_token_at, timing.token_count
        ),
        retrieval=retrieval or RetrievalBreakdown(),
    )


def total_retrieval_ms(b: RetrievalBreakdown) -> float:
    return max(b.vectordb_ms, 0.0) + max(b.network_ms, 0.0) + max(b.dns_ms, 0.0)


def quantile(values: list[float], q: float) -> float:
    """Linear-interpolation quantile (matches reference semantics).

    Total over every input: an empty list is 0.0, a single element is
    that exact value at every q, q is clamped to [0, 1], and NaN
    elements are dropped before sorting (one poisoned snapshot must
    not make sort order — and therefore every percentile — undefined).
    Ties interpolate between equal values, so the result is NaN-free
    whenever the retained inputs are.
    """
    ordered = sorted(v for v in values if not math.isnan(v))
    if not ordered:
        return 0.0
    q = min(max(q, 0.0), 1.0)
    if len(ordered) == 1:
        return ordered[0]
    pos = q * (len(ordered) - 1)
    lower = math.floor(pos)
    upper = math.ceil(pos)
    if lower == upper:
        return ordered[lower]
    frac = pos - lower
    return ordered[lower] * (1 - frac) + ordered[upper] * frac


def aggregate(items: list[Snapshot]) -> Percentiles:
    """Percentile summaries over snapshots.

    Total: an empty snapshot list yields all-zero percentiles and a
    single snapshot yields its exact values — callers never need to
    special-case either.
    """
    if not items:
        return Percentiles()
    ttft = [max(s.ttft_ms, 0.0) for s in items]
    tps = [max(s.tokens_per_s, 0.0) for s in items]
    retrieval = [total_retrieval_ms(s.retrieval) for s in items]
    return Percentiles(
        ttft_p50=quantile(ttft, 0.50),
        ttft_p95=quantile(ttft, 0.95),
        ttft_p99=quantile(ttft, 0.99),
        tokens_per_s_p50=quantile(tps, 0.50),
        tokens_per_s_p95=quantile(tps, 0.95),
        retrieval_p95_ms=quantile(retrieval, 0.95),
    )
