"""Loadgen: deterministic request-trace JSONL generator (the port's
copy of ``tpuslo/cli/loadgen.py``: plain Python, the same records and
output for the same seed and flags).

Reference: ``cmd/loadgen/main.go`` — request profiles with expected
TTFT ranges; generates traces, does not drive HTTP.  The toolkit adds a
``context_128k`` profile for long-context serving, and ``--slo-out``
emits a parallel ``RequestOutcome`` JSONL (the burn engine's SLI
stream) so error-budget scenarios can be rehearsed offline.

The front-door bench drives its admission layer from this module's
:func:`synthesize_requests`, so the arrival process is shaped here:
``--arrival steady|burst|ramp|poisson`` picks the inter-arrival model,
``--tenants N``/``--tenant-mix`` spreads requests over a multi-tenant
population with weighted shares, and ``--prefix-rate`` marks a fraction
of each tenant's requests as sharing a per-tenant prompt prefix
(``prefix_group``) — the signal prefix-cache-aware placement batches
on.

The router bench needs prefix traffic an affinity router can actually
be *wrong* about: one group per tenant makes affinity routing trivially
easy (any stable hash wins).  ``--prefix-groups N`` distributes each
tenant's prefix hits over N distinct, fleet-wide groups with per-tenant
weighting (:func:`prefix_group_weights`): every tenant leans on a
different subset of the shared groups, so placement quality depends on
tracking *which engine is warm for which group*, not on tenant
identity.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys
from datetime import datetime, timezone

# profile -> (prompt_tokens, max_new_tokens, expected_ttft_ms_range)
PROFILES = {
    "chat_short": (64, 128, (150, 450)),
    "rag_medium": (512, 256, (300, 800)),
    "context_long": (4096, 512, (600, 1600)),
    "context_128k": (131072, 512, (2500, 8000)),
}

#: Arrival processes the bench lanes can request by name.
ARRIVALS = ("steady", "burst", "ramp", "poisson")

#: Deterministic default stream epoch for --slo-out timestamps.
DEFAULT_START = "2026-01-01T00:00:00Z"


def parse_tenant_mix(spec: str, n_tenants: int) -> list[float]:
    """Normalized tenant weights from a ``--tenant-mix`` spec.

    ``spec`` is comma-separated positive weights (``"70,20,10"``);
    empty means uniform.  Fewer weights than tenants pad with the last
    weight; extras are an error (a silently-dropped weight would skew
    the mix the bench asserts on).
    """
    if n_tenants < 1:
        raise ValueError("--tenants must be >= 1")
    if not spec:
        weights = [1.0] * n_tenants
    else:
        # Every comma-separated entry must parse: silently dropping an
        # empty one ('70,,10') would shift later weights onto the
        # wrong tenants — the exact skew this function exists to
        # prevent.
        try:
            weights = [float(w) for w in spec.split(",")]
        except ValueError as exc:
            raise ValueError(
                f"--tenant-mix entry is not a number: {spec!r}"
            ) from exc
        if len(weights) > n_tenants:
            raise ValueError(
                f"--tenant-mix has {len(weights)} weights for "
                f"{n_tenants} tenants"
            )
        if any(w <= 0 for w in weights):
            raise ValueError("--tenant-mix weights must be positive")
        weights += [weights[-1]] * (n_tenants - len(weights))
    total = sum(weights)
    return [w / total for w in weights]


def prefix_group_weights(
    tenant_idx: int, prefix_groups: int
) -> list[float]:
    """Normalized per-tenant weights over the shared prefix groups.

    Tenant ``t`` favors group ``t % N`` and decays harmonically over
    the groups after it (cyclically): group ``(t + j) % N`` carries
    weight ``1 / (1 + j)``.  Deterministic and parameter-free, so the
    bench and the CLI agree on the mix without sharing an RNG; every
    tenant's hot set is distinct, which is exactly what makes
    prefix-affinity routing non-trivial to get right.
    """
    if prefix_groups < 1:
        raise ValueError("--prefix-groups must be >= 1")
    weights = [0.0] * prefix_groups
    for j in range(prefix_groups):
        weights[(tenant_idx + j) % prefix_groups] = 1.0 / (1 + j)
    total = sum(weights)
    return [w / total for w in weights]


def prefix_group_name(group_idx: int) -> str:
    """Fleet-wide group naming (``grp-03/sys``): groups are shared
    ACROSS tenants, unlike the legacy per-tenant ``<tenant>/sys``."""
    return f"grp-{group_idx:02d}/sys"


def arrival_offsets_ms(
    arrival: str,
    count: int,
    duration_s: float,
    rng: random.Random,
) -> list[float]:
    """Monotonic arrival offsets (ms) for ``count`` requests.

    * ``steady`` — fixed interval with ±20% jitter (the legacy shape);
    * ``burst`` — arrivals clump into square-wave bursts: 4 bursts
      over the duration, each packing 1/4 of the traffic into the
      first 20% of its window (the TTFT-p99 stressor);
    * ``ramp`` — arrival rate grows linearly from ~0 to 2x the mean
      (offsets follow sqrt(u): a warm-up then saturation);
    * ``poisson`` — exponential inter-arrivals at the mean rate.
    """
    if count < 1:
        return []
    duration_ms = max(1.0, duration_s * 1000.0)
    interval_ms = duration_ms / count
    if arrival == "steady":
        offsets = [
            i * interval_ms + rng.uniform(-0.2, 0.2) * interval_ms
            for i in range(count)
        ]
    elif arrival == "burst":
        n_bursts = 4
        window_ms = duration_ms / n_bursts
        offsets = []
        for i in range(count):
            burst = i % n_bursts
            offsets.append(
                burst * window_ms
                + rng.random() * 0.2 * window_ms
            )
    elif arrival == "ramp":
        offsets = [
            math.sqrt(rng.random()) * duration_ms for _ in range(count)
        ]
    elif arrival == "poisson":
        t = 0.0
        offsets = []
        for _ in range(count):
            t += rng.expovariate(1.0 / interval_ms)
            offsets.append(t)
    else:
        raise ValueError(
            f"unknown arrival model {arrival!r} (one of {ARRIVALS})"
        )
    return [round(v, 3) for v in sorted(max(0.0, o) for o in offsets)]


def synthesize_requests(
    profile: str = "rag_medium",
    rps: float = 2.0,
    duration_s: float = 30.0,
    seed: int = 42,
    arrival: str = "steady",
    tenants: int = 1,
    tenant_mix: str = "",
    prefix_rate: float = 0.0,
    prefix_groups: int = 1,
) -> list[dict]:
    """Deterministic multi-tenant request records (offset-sorted).

    Each record carries the legacy trace fields plus ``tenant`` and —
    for the ``prefix_rate`` fraction of a tenant's requests —
    ``prefix_group``: requests in one group share a prompt prefix, the
    unit prefix caching snapshots once and the front-door scheduler
    batches together.  With ``prefix_groups == 1`` (the default) the
    group is the legacy per-tenant ``"<tenant>/sys"``; with ``N > 1``
    hits spread over N fleet-wide groups (``grp-00/sys``..) under
    :func:`prefix_group_weights` per-tenant weighting.
    """
    prompt_tokens, max_new, ttft_range = PROFILES[profile]
    rng = random.Random(seed)
    count = max(1, int(rps * duration_s))
    weights = parse_tenant_mix(tenant_mix, tenants)
    tenant_names = [f"tenant-{i:02d}" for i in range(tenants)]
    group_weights = [
        prefix_group_weights(t, prefix_groups) for t in range(tenants)
    ]
    group_names = [prefix_group_name(g) for g in range(prefix_groups)]
    offsets = arrival_offsets_ms(arrival, count, duration_s, rng)
    records = []
    for idx, offset_ms in enumerate(offsets):
        tenant = rng.choices(tenant_names, weights=weights)[0]
        record = {
            "request_id": f"load-req-{idx + 1:05d}",
            "trace_id": f"load-trace-{idx + 1:05d}",
            "profile": profile,
            "offset_ms": offset_ms,
            "tenant": tenant,
            "prompt_tokens": prompt_tokens,
            "max_new_tokens": max_new,
            "expected_ttft_ms_min": ttft_range[0],
            "expected_ttft_ms_max": ttft_range[1],
            "stream": True,
        }
        if rng.random() < prefix_rate:
            if prefix_groups == 1:
                record["prefix_group"] = f"{tenant}/sys"
            else:
                tenant_idx = tenant_names.index(tenant)
                record["prefix_group"] = rng.choices(
                    group_names, weights=group_weights[tenant_idx]
                )[0]
        records.append(record)
    return records


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpuslo_torch loadgen", description=__doc__)
    p.add_argument("--profile", default="rag_medium", choices=sorted(PROFILES))
    p.add_argument("--rps", type=float, default=2.0)
    p.add_argument("--duration-s", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", default="-")
    p.add_argument(
        "--arrival",
        default="steady",
        choices=ARRIVALS,
        help="inter-arrival model: steady (jittered fixed rate), "
        "burst (4 square-wave bursts — the TTFT-p99 stressor), ramp "
        "(rate grows to 2x mean), poisson (exponential gaps)",
    )
    p.add_argument(
        "--tenants",
        type=int,
        default=1,
        help="number of synthetic tenants (tenant-00..); requests "
        "spread per --tenant-mix",
    )
    p.add_argument(
        "--tenant-mix",
        default="",
        help="comma-separated positive tenant weights, e.g. "
        "'70,20,10' (default uniform; short lists pad with the last "
        "weight)",
    )
    p.add_argument(
        "--prefix-rate",
        type=float,
        default=0.0,
        help="fraction of each tenant's requests stamped with a "
        "shared prefix_group (prefix-cache-aware placement batches "
        "these onto snapshot-reusing slots)",
    )
    p.add_argument(
        "--prefix-groups",
        type=int,
        default=1,
        help="number of distinct fleet-wide prefix groups the "
        "--prefix-rate hits spread over (grp-00/sys..), weighted per "
        "tenant so every tenant leans on a different hot set; 1 keeps "
        "the legacy per-tenant '<tenant>/sys' group",
    )
    p.add_argument(
        "--slo-out",
        default="",
        help="also emit one RequestOutcome JSONL line per request "
        "(tenant/ttft/tpot/tokens/status) — the burn engine's SLI "
        "stream, replayable via `sloctl budget --replay`",
    )
    p.add_argument(
        "--tenant",
        default="default",
        help="tenant stamped on --slo-out outcomes when --tenants is "
        "1 (multi-tenant runs stamp each record's own tenant)",
    )
    p.add_argument(
        "--error-rate",
        type=float,
        default=0.0,
        help="fraction of requests marked status=error on --slo-out",
    )
    p.add_argument(
        "--error-after-s",
        type=float,
        default=0.0,
        help="errors only start this many seconds into the run "
        "(clean warm-up, then burn — a one-command burn scenario)",
    )
    p.add_argument(
        "--slow-ttft-rate",
        type=float,
        default=0.0,
        help="fraction of requests with TTFT 2-4x past the profile's "
        "expected max (latency-objective burn on --slo-out)",
    )
    p.add_argument(
        "--start",
        default=DEFAULT_START,
        help="RFC3339 epoch of the generated stream (deterministic "
        "timestamps; the burn engine runs on event time)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    _prompt_tokens, max_new, ttft_range = PROFILES[args.profile]
    rng = random.Random(args.seed ^ 0x5105)  # outcome noise stream
    records = synthesize_requests(
        profile=args.profile,
        rps=args.rps,
        duration_s=args.duration_s,
        seed=args.seed,
        arrival=args.arrival,
        tenants=args.tenants,
        tenant_mix=args.tenant_mix,
        prefix_rate=args.prefix_rate,
        prefix_groups=args.prefix_groups,
    )
    start = datetime.fromisoformat(
        args.start.replace("Z", "+00:00")
    ).astimezone(timezone.utc)
    base_ns = int(start.timestamp() * 1e9)

    sink = sys.stdout if args.output == "-" else open(args.output, "w", encoding="utf-8")
    slo_sink = (
        open(args.slo_out, "w", encoding="utf-8") if args.slo_out else None
    )
    try:
        for record in records:
            if args.tenants == 1:
                record = {**record, "tenant": args.tenant}
            sink.write(json.dumps(record, separators=(",", ":")) + "\n")
            if slo_sink is not None:
                offset_ms = record["offset_ms"]
                in_error_window = (
                    offset_ms / 1000.0 >= args.error_after_s
                )
                error = (
                    in_error_window and rng.random() < args.error_rate
                )
                slow = rng.random() < args.slow_ttft_rate
                ttft_ms = (
                    rng.uniform(2.0 * ttft_range[1], 4.0 * ttft_range[1])
                    if slow
                    else rng.uniform(*ttft_range)
                )
                outcome = {
                    "tenant": record["tenant"],
                    "ts_unix_nano": base_ns + int(offset_ms * 1e6),
                    "ttft_ms": round(ttft_ms, 3),
                    "tpot_ms": round(rng.uniform(20.0, 60.0), 3),
                    "tokens": max_new,
                    "status": "error" if error else "ok",
                    "request_id": record["request_id"],
                }
                slo_sink.write(
                    json.dumps(outcome, separators=(",", ":")) + "\n"
                )
    finally:
        if sink is not sys.stdout:
            sink.close()
        if slo_sink is not None:
            slo_sink.close()
    print(
        f"loadgen: wrote {len(records)} request records"
        + (f" + {len(records)} slo outcomes to {args.slo_out}"
           if args.slo_out else ""),
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
