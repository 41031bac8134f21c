"""Slicecorr: cross-host collective straggler attribution (the port of
``tpuslo/cli/slicecorr.py``, with the same flags and output).

Joins per-host agent probe-event JSONL streams, or the per-host
collective launches of a profiler capture (``--xprof-dir``: NCCL
kernels, :func:`tpuslo_torch.otel.xla_spans.extract_collective_signals_by_host`),
and attributes collective stragglers to a host (compute) or a link.

``--gate`` (the telemetry ingest gate) needs the port of
``tpuslo/ingest/``, which belongs to ROADMAP item 17: until then it
exits 2 rather than join ungated.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpuslo_torch.correlation.multihost import (
    DEFAULT_RETRY_THRESHOLD,
    DEFAULT_RETRY_WINDOW_NS,
    DEFAULT_SKEW_FLOOR_MS,
    DEFAULT_SKEW_RATIO,
    SliceJoiner,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpuslo_torch slicecorr", description=__doc__)
    p.add_argument(
        "inputs",
        nargs="*",
        help="per-host probe-event JSONL files ('-' or empty = stdin)",
    )
    p.add_argument(
        "--xprof-dir",
        default="",
        help="profiler log dir: extract per-host collective signals "
        "from the newest xprof run instead of reading JSONL "
        "(requires a trace captured with ops; see tpuslo_torch.otel.xla_spans)",
    )
    p.add_argument(
        "--xprof-anchor-ns",
        type=int,
        default=0,
        help="wall-clock ns of profiling start; 0 emits trace-relative "
        "timestamps, internally consistent for the launch-id join but "
        "NOT time-joinable with wall-clock agent JSONL or retry "
        "evidence",
    )
    p.add_argument("--slice-id", default="slice-0")
    p.add_argument("--output", default="-", help="incidents JSONL ('-' = stdout)")
    p.add_argument("--expected-hosts", type=int, default=0)
    p.add_argument("--min-hosts", type=int, default=2)
    p.add_argument("--skew-ratio", type=float, default=DEFAULT_SKEW_RATIO)
    p.add_argument("--skew-floor-ms", type=float, default=DEFAULT_SKEW_FLOOR_MS)
    p.add_argument("--retry-threshold", type=float, default=DEFAULT_RETRY_THRESHOLD)
    p.add_argument("--retry-window-ns", type=int, default=DEFAULT_RETRY_WINDOW_NS)
    p.add_argument(
        "--summary", default="", help="optional summary JSON output path"
    )
    p.add_argument(
        "--gate",
        action="store_true",
        help="route events through the telemetry ingest gate "
        "(dedup, quarantine, clock-skew correction, watermark) "
        "before joining (not ported yet: ROADMAP item 17; exits 2)",
    )
    p.add_argument(
        "--quarantine-dir",
        default="",
        help="with --gate: write malformed events here (capped JSONL)",
    )
    p.add_argument("--watermark-lateness-ms", type=int, default=2000)
    p.add_argument(
        "--coordinator-host",
        type=int,
        default=0,
        help="host index whose clock anchors skew correction",
    )
    return p


def _read_events(paths: list[str]):
    for path in paths or ["-"]:
        fh = sys.stdin if path == "-" else open(path, encoding="utf-8")
        try:
            for line in fh:
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            if fh is not sys.stdin:
                fh.close()


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    joiner = SliceJoiner(
        expected_hosts=args.expected_hosts,
        skew_ratio=args.skew_ratio,
        skew_floor_ms=args.skew_floor_ms,
        retry_window_ns=args.retry_window_ns,
        retry_threshold=args.retry_threshold,
    )
    if args.gate:
        print(
            "slicecorr: --gate needs the telemetry ingest gate (tpuslo/ingest/), "
            "which is not ported yet (ROADMAP item 17); run without --gate",
            file=sys.stderr,
        )
        return 2
    # ValueError covers malformed JSONL (e.g. an agent killed mid-write
    # truncating a line — exactly the crash-consistency shape this
    # tool's inputs come from); same contract as attributor/collector.
    try:
        if args.xprof_dir:
            if args.inputs:
                print(
                    "slicecorr: --xprof-dir and JSONL inputs are mutually "
                    "exclusive",
                    file=sys.stderr,
                )
                return 2
            from tpuslo_torch.otel.xla_spans import (
                extract_collective_signals_by_host,
                load_latest_trace_by_host,
            )

            by_host = load_latest_trace_by_host(
                args.xprof_dir, include_ops=True
            )
            if not by_host:
                # Silent zero-incidents here would read as "healthy".
                print(
                    f"slicecorr: no xprof profile runs under "
                    f"{args.xprof_dir!r} (expected plugins/profile/"
                    f"<run>/*.trace.json[.gz])",
                    file=sys.stderr,
                )
                return 2
            if args.xprof_anchor_ns == 0:
                print(
                    "slicecorr: --xprof-anchor-ns not set; emitting "
                    "trace-relative timestamps (launch-id joins are "
                    "valid, but incidents cannot be time-joined with "
                    "wall-clock agent JSONL)",
                    file=sys.stderr,
                )
            events = extract_collective_signals_by_host(
                by_host, args.xprof_anchor_ns, slice_id=args.slice_id
            )
        else:
            events = _read_events(args.inputs)
        joiner.add_all(events)
        incidents = joiner.incidents(min_hosts=args.min_hosts)

        sink = (
            sys.stdout
            if args.output == "-"
            else open(args.output, "w", encoding="utf-8")
        )
        try:
            for incident in incidents:
                sink.write(json.dumps(incident.to_dict(), sort_keys=True) + "\n")
        finally:
            if sink is not sys.stdout:
                sink.close()

        summary = {
            "ingested": joiner.ingested,
            "skipped": joiner.skipped,
            "skipped_by_reason": dict(
                sorted(joiner.skipped_by_reason.items())
            ),
            "incidents": len(incidents),
            "by_cause": {},
        }
        for incident in incidents:
            summary["by_cause"][incident.cause] = (
                summary["by_cause"].get(incident.cause, 0) + 1
            )
        if args.summary:
            with open(args.summary, "w", encoding="utf-8") as fh:
                json.dump(summary, fh, indent=2, sort_keys=True)
    except BrokenPipeError:
        raise  # dispatcher-level handling (exit 141, no traceback)
    except (OSError, ValueError) as exc:
        print(f"slicecorr: {exc}", file=sys.stderr)
        return 2
    print(f"slicecorr: {json.dumps(summary, sort_keys=True)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
