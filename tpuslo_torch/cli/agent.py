"""Node agent: the toolkit's ``serve()`` loop (the port's own copy of
``tpuslo/cli/agent.py``, run as ``python -m tpuslo_torch agent``).

Reference: ``cmd/agent/main.go`` — synthetic scenario → SLO + probe
events → stdout/jsonl/OTLP, Prometheus metrics server on :2112,
overhead-guard probe shedding, rate limiting with drop accounting,
optional webhook attribution, ``--probe-smoke`` privilege check.

The real-probe path swaps in behind ``--probe-source ring``: the native
consumer drains the kernel ring buffers and any userspace ring
(``--ring-path``; the HBM sampler and the hello tracer share one).

Flag names, defaults, exit codes, stderr lines and rows are the JAX
agent's.  The port adds ``--device cuda|cpu`` (default ``cuda``), which
governs the two lanes that touch a device: the active collective prober
(``--ici-probe-interval-s``: one NCCL rank on the card, or one gloo rank
with ``--device cpu``, brought up before the first cycle) and the ring
loop's HBM sampler when it reads the live device (a stats file named by
``TPUSLO_HBM_STATS_PATH`` touches no device).  Without a card a device
lane under ``--device cuda`` exits 2 before the loop starts; the loops
that touch no device import no ``torch``.

The columnar spine (``--columnar``, ``--fleet-upstream``), the
continuous device profiler (``--profile-device``, ``--profiler-source``),
the telemetry ingest gate (a config with an ``ingest:`` section) and the
telemetry chaos stream (``--chaos-telemetry``) are not ported yet: each
exits 2 naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import argparse
import sys
import time

from tpuslo_torch import attribution, webhook
from tpuslo_torch.cli.common import EventWriters, resolve_config, validate_probe, validate_slo
from tpuslo_torch.collector import (
    SampleMeta,
    build_synthetic_sample,
    normalize_sample,
    supported_synthetic_scenarios,
)
from tpuslo_torch.collector.kernel import probe_smoke_check
from tpuslo_torch.correlation.matcher import SignalRef
from tpuslo_torch.delivery import DeliveryOptions
from tpuslo_torch.metrics import AgentMetrics, start_metrics_server
from tpuslo_torch.safety import OverheadGuard, RateLimiter, ShedRecoveryPolicy
from tpuslo_torch.signals import (
    Generator,
    Metadata,
    StaticMetadataEnricher,
    TPUMetadataEnricher,
    parse_capability_mode,
    profile_for_fault,
)
from datetime import datetime, timedelta, timezone


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuslo-torch agent", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--config", default="", help="toolkit.yaml path")
    p.add_argument(
        "--scenario",
        default="baseline",
        choices=supported_synthetic_scenarios(),
    )
    p.add_argument("--interval-s", type=float, default=1.0)
    p.add_argument("--count", type=int, default=0, help="0 = run forever")
    p.add_argument("--event-kind", default="both", choices=["slo", "probe", "both"])
    p.add_argument("--output", default="stdout", choices=["stdout", "jsonl", "otlp"])
    p.add_argument("--jsonl-path", default="")
    p.add_argument("--otlp-endpoint", default="")
    p.add_argument(
        "--capability-mode",
        default="auto",
        help="auto, or a tier (the JAX agent's, or cuda_full)",
    )
    p.add_argument("--signal-set", default="", help="comma-separated override")
    p.add_argument("--metrics-port", type=int, default=2112, help="0 disables")
    p.add_argument("--max-overhead-pct", type=float, default=0.0)
    p.add_argument("--events-per-second", type=int, default=0)
    p.add_argument("--webhook-url", default="")
    p.add_argument("--webhook-secret", default="")
    p.add_argument("--webhook-format", default="")
    p.add_argument("--cluster", default="tpu-cluster")
    p.add_argument("--namespace", default="llm")
    p.add_argument("--workload", default="rag-service")
    p.add_argument("--service", default="rag-service")
    p.add_argument("--node", default="tpu-vm-0")
    p.add_argument("--probe-smoke", action="store_true")
    p.add_argument(
        "--columnar",
        action="store_true",
        help="batch loop on the columnar spine: each cycle generates "
        "--columnar-batch samples straight into columns, gates them "
        "vectorized, and serializes one JSONL block (fleet-scale "
        "probe-event throughput; probe events only)",
    )
    p.add_argument(
        "--columnar-batch",
        type=int,
        default=256,
        help="samples per columnar cycle (each fans out to one probe "
        "event per enabled signal)",
    )
    p.add_argument(
        "--fleet-upstream",
        default="",
        help="ship gated columnar batches upward to the fleet "
        "aggregators: append one base64-transport shipment per gated "
        "batch (versioned wire contract, monotonic per-node seq) to "
        "this JSONL log, which `tpuslo fleetagg` consumes; requires "
        "--columnar",
    )
    p.add_argument(
        "--profile-device",
        action="store_true",
        help="continuous device profiler: stride-gated capture "
        "windows (live xprof or the seeded synthetic lane) folded "
        "through the device-plane ledger under a measured-overhead "
        "governor, emitting per-window device signals into the "
        "columnar spine; requires --columnar (knobs: the `profiler:` "
        "config section)",
    )
    p.add_argument(
        "--profiler-source",
        default="",
        choices=["", "synthetic", "xprof"],
        help="capture lane override (default: profiler.source config; "
        "xprof needs importable jax and falls back to synthetic with "
        "a note when unavailable)",
    )
    p.add_argument(
        "--profiler-stride",
        type=int,
        default=0,
        help="capture every N columnar cycles "
        "(0 = profiler.stride_cycles config)",
    )
    p.add_argument(
        "--profiler-preempt-window",
        type=int,
        default=-1,
        help="synthetic lane only: inject a preemption-sized idle gap "
        "and its eviction notice into this capture window (seeded "
        "e2e evidence; -1 disables)",
    )
    # Multi-host identity for the ring loop's TPU events: a DaemonSet
    # agent knows which slice/host it runs on; SliceJoiner joins
    # per-host streams on exactly this identity.
    p.add_argument("--slice-id", default="", help="TPU slice identity")
    p.add_argument(
        "--host-index", type=int, default=0,
        help="this host's index within the slice",
    )
    p.add_argument(
        "--xla-program-id", default="",
        help="program identity stamped on collective probe events",
    )
    p.add_argument("--tpu-chip", default="accel0")
    p.add_argument(
        "--probe-source",
        default="synthetic",
        choices=["synthetic", "ring"],
        help="ring = consume the native eBPF ring buffer",
    )
    p.add_argument(
        "--ring-path",
        default="",
        help="extra userspace ring to consume (injectors/fallback); "
        "ring mode only",
    )
    p.add_argument(
        "--hello",
        action="store_true",
        help="emit hello heartbeat events through the ring (e2e evidence)",
    )
    p.add_argument(
        "--spool-dir",
        default="",
        help="enable resilient delivery: batches that cannot reach a "
        "network sink are spooled here and replayed on recovery "
        "(config: delivery.spool_dir)",
    )
    p.add_argument(
        "--restore-after-cycles",
        type=int,
        default=0,
        help="re-enable one shed probe signal after this many "
        "consecutive under-budget guard cycles "
        "(0 = config delivery.restore_after_cycles)",
    )
    p.add_argument(
        "--chaos-sink",
        default="",
        metavar="SCHEDULE",
        help="start an in-process fault-injection OTLP sink and point "
        "the exporters at it; SCHEDULE is behavior[:count],... with "
        "behaviors ok|refuse|5xx|4xx|hang|flap (e.g. 'ok:3,refuse:6,ok') "
        "— demo/chaos harness, implies --output otlp",
    )
    p.add_argument(
        "--ici-probe-interval-s",
        type=float,
        default=0.0,
        help="run the active ICI collective prober every N seconds "
        "(0 disables; needs exclusive device access — the chip must "
        "not be held by a serving workload)",
    )
    p.add_argument("--ici-probe-payload-kb", type=int, default=256)
    p.add_argument(
        "--chaos-telemetry",
        type=float,
        default=0.0,
        metavar="INTENSITY",
        help="perturb the probe stream at the source with seeded skew/"
        "reorder/dup/corrupt/drop chaos (1.0 = moderate: skew<=250ms, "
        "5%% dup, 5%% reorder, 1%% corrupt); pairs with the ingest "
        "gate (config ingest:) to rehearse telemetry-quality incidents",
    )
    p.add_argument("--chaos-telemetry-seed", type=int, default=1337)
    p.add_argument(
        "--stats-interval-cycles",
        type=int,
        default=30,
        help="emit a periodic stats line (drops, rejections by reason, "
        "gate counters) every N cycles; 0 disables",
    )
    p.add_argument(
        "--state-dir",
        default="",
        help="enable the crash-safe runtime: periodic atomic snapshots "
        "of agent state (watermark, skew, dedup digest, breaker/shed "
        "state, limiter budget) land here and are restored on restart "
        "(config: runtime.state_dir)",
    )
    p.add_argument(
        "--snapshot-interval-s",
        type=float,
        default=-1.0,
        help="seconds between periodic snapshots; 0 = every cycle, "
        "-1 = config runtime.snapshot_interval_s",
    )
    p.add_argument(
        "--cold-start",
        action="store_true",
        help="ignore any on-disk snapshot and start cold (operator "
        "escape hatch for a poisoned snapshot)",
    )
    p.add_argument(
        "--drain-timeout-s",
        type=float,
        default=0.0,
        help="deadline for the graceful SIGTERM/SIGINT drain sequence "
        "(0 = config runtime.drain_timeout_s)",
    )
    p.add_argument(
        "--trace",
        action="store_true",
        help="self-trace every agent cycle: a root span with child "
        "spans per pipeline stage (generate/ingest-gate/validate/"
        "correlate/attribute/deliver/snapshot), tail-sampled so slow "
        "and error cycles are always kept, exported as OTLP traces "
        "through the delivery layer (config: observability.enabled)",
    )
    p.add_argument(
        "--trace-endpoint",
        default="",
        help="OTLP/HTTP traces endpoint; empty derives the /v1/traces "
        "sibling of the logs endpoint when --output otlp "
        "(config: observability.trace_endpoint)",
    )
    p.add_argument(
        "--trace-sample-rate",
        type=float,
        default=-1.0,
        help="probability of keeping a fast, error-free cycle "
        "(-1 = config observability.sample_rate)",
    )
    p.add_argument(
        "--trace-slow-ms",
        type=float,
        default=0.0,
        help="cycle-duration budget: cycles at or past it are always "
        "sampled (0 = config observability.slow_cycle_ms)",
    )
    p.add_argument(
        "--provenance-path",
        default="",
        help="incident provenance JSONL (read by `sloctl explain`); "
        "empty = config observability.provenance_path, falling back "
        "to <state-dir>/provenance.jsonl",
    )
    p.add_argument(
        "--burn-engine",
        action="store_true",
        help="run the SLO error-budget / burn-rate engine over the "
        "per-request SLI stream with default targets (config: slo: "
        "section — presence implies on); burn state feeds Prometheus, "
        "incident payloads, provenance, and `sloctl budget`",
    )
    p.add_argument(
        "--tenant",
        default="",
        help="tenant identity stamped on this agent's request outcomes "
        "(default: --namespace); per-tenant SLO targets come from "
        "config slo.tenants",
    )
    p.add_argument(
        "--remediate",
        action="store_true",
        help="run the auto-remediation engine over attributed "
        "incidents (config: remediation: section — presence implies "
        "on; needs the burn engine for its burn-state gate and verify "
        "evidence): high-confidence attributions under active burn "
        "apply reversible actions (probe shed, breaker trip, tenant "
        "demotion), verified against the burn or rolled back",
    )
    p.add_argument(
        "--device",
        default="cuda",
        choices=["cuda", "cpu"],
        help="where the lanes that touch a device run: the collective "
        "prober (one NCCL rank on the card, one gloo rank on the CPU) and "
        "the ring loop's live HBM reading; 'cuda' (the default) exits 2 "
        "without a card when such a lane is on",
    )
    return p


def _print_stats(
    metrics: AgentMetrics | None = None, burn_engine=None
) -> None:
    """Periodic stats line: every silent drop, made loud — and, with
    the self-tracer's histograms populated, per-stage p50/p99 so "why
    is the loop slow" is answerable from the log alone."""
    from tpuslo_torch.metrics import REJECTION_COUNTERS, VALIDATION_COUNTERS

    parts = [f"validation={VALIDATION_COUNTERS.snapshot()}"]
    rejections = REJECTION_COUNTERS.snapshot()
    if rejections:
        parts.append(f"rejections={rejections}")
    if burn_engine is not None:
        parts.append(f"burn={burn_engine.snapshot()}")
    if metrics is not None:
        stages = metrics.stage_quantiles()
        if stages:
            parts.append(
                "stage_ms="
                + ",".join(
                    f"{name}:{est.get('p50', 0.0):.2f}/{est.get('p99', 0.0):.2f}"
                    for name, est in sorted(stages.items())
                )
                + " (p50/p99)"
            )
    print("agent: stats: " + " ".join(parts), file=sys.stderr)


def _signal_ref(event, ts_cache: dict | None = None):
    """ProbeEventV1 → correlation SignalRef without a dict round-trip.

    ``ts_cache`` memoizes the ns→datetime conversion: every probe
    event in one synthetic cycle carries the same sample timestamp,
    and this runs once per emitted event inside the correlate stage
    whose latency the tracer is measuring.
    """
    ts = None
    if event.ts_unix_nano > 0:
        if ts_cache is not None:
            ts = ts_cache.get(event.ts_unix_nano)
        if ts is None:
            ts = datetime.fromtimestamp(
                event.ts_unix_nano / 1e9, tz=timezone.utc
            )
            if ts_cache is not None:
                ts_cache[event.ts_unix_nano] = ts
    tpu = event.tpu
    return SignalRef(
        signal=event.signal,
        timestamp=ts,
        trace_id=event.trace_id,
        node=event.node,
        pod=event.pod,
        pid=event.pid,
        conn_tuple=event.conn_tuple.key() if event.conn_tuple else "",
        value=event.value,
        slice_id=tpu.slice_id if tpu else "",
        host_index=tpu.host_index if tpu else -1,
        program_id=tpu.program_id if tpu else "",
        launch_id=tpu.launch_id if tpu else -1,
    )


# The lanes that wait for a later slice of the port: each refuses with
# exit 2 and names the ROADMAP item that brings it.
DEFERRED_17B = "ROADMAP item 17b"
DEFERRED_17C = "ROADMAP item 17c"


def deferred_lane(args, cfg) -> str:
    """The stderr line refusing a lane that is not ported yet, or ""."""
    for flag, on, what, item in (
        ("--columnar", args.columnar, "the columnar spine", DEFERRED_17B),
        ("--fleet-upstream", bool(args.fleet_upstream),
         "the fleet shipment path of the columnar spine", DEFERRED_17B),
        ("--profile-device", args.profile_device,
         "the continuous device profiler", DEFERRED_17B),
        ("--profiler-source", bool(args.profiler_source),
         "the continuous device profiler", DEFERRED_17B),
        ("--chaos-telemetry", args.chaos_telemetry > 0,
         "the telemetry chaos stream", DEFERRED_17C),
    ):
        if on:
            return (
                f"agent: {flag} needs {what}, which is not ported yet "
                f"({item}); run without {flag}"
            )
    if cfg.ingest.enabled:
        return (
            "agent: the config's ingest: section needs the telemetry "
            f"ingest gate, which is not ported yet ({DEFERRED_17B}); "
            "drop the section"
        )
    return ""


def _stats_file_named() -> bool:
    """Is there an HBM stats file (``TPUSLO_HBM_STATS_PATH``) for the
    sampler to read instead of the live device?"""
    import os

    path = os.environ.get("TPUSLO_HBM_STATS_PATH", "")
    return bool(path) and os.path.exists(path)


def device_lanes(args, signal_set) -> list[str]:
    """The lanes of this run that touch the device ``--device`` names."""
    from tpuslo_torch.signals import constants as sigconst

    lanes = []
    if args.ici_probe_interval_s > 0 and not (
        args.event_kind == "slo" and args.probe_source != "ring"
    ):
        lanes.append("--ici-probe-interval-s (the collective prober)")
    if (
        args.probe_source == "ring"
        and sigconst.SIGNAL_HBM_UTILIZATION_PCT in signal_set
        and args.device == "cuda"
        and not _stats_file_named()
    ):
        lanes.append("the ring loop's HBM sampler (the live device)")
    return lanes


def open_probe_group(device: str) -> bool:
    """Bring up the one-rank group the collective prober measures over:
    NCCL on the card, gloo on the CPU (tcp on a free localhost port).
    Returns whether this call opened it (an initialized group is used
    as it is)."""
    import socket

    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    kwargs = {}
    backend = "gloo"
    if device == "cuda":
        backend = "nccl"
        torch.cuda.set_device(0)
        kwargs["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=1,
        rank=0, **kwargs,
    )
    return True


def main(
    argv: list[str] | None = None, metrics: AgentMetrics | None = None
) -> int:
    args = build_parser().parse_args(argv)

    if args.probe_smoke:
        result = probe_smoke_check()
        print(f"probe-smoke: {'PASS' if result.ok else 'FAIL'}: {result.detail}")
        return 0 if result.ok else 1

    cfg = resolve_config(args.config)
    refused = deferred_lane(args, cfg)
    if refused:
        print(refused, file=sys.stderr)
        return 2
    mode = parse_capability_mode(args.capability_mode)
    signal_set = (
        [s.strip() for s in args.signal_set.split(",") if s.strip()]
        if args.signal_set
        else cfg.signal_set
    )
    lanes = device_lanes(args, signal_set)
    if lanes and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print(
                "agent: --device cuda: no CUDA device for "
                + " and ".join(lanes)
                + "; pass --device cpu to run it on the CPU",
                file=sys.stderr,
            )
            return 2
    max_overhead = args.max_overhead_pct or cfg.safety.max_overhead_pct
    eps = args.events_per_second or cfg.sampling.events_per_second_limit

    chaos_server = None
    otlp_endpoint = args.otlp_endpoint or cfg.otlp.endpoint
    if args.chaos_sink:
        from tpuslo_torch.delivery.faultsink import FaultInjectingHTTPServer

        chaos_server = FaultInjectingHTTPServer(args.chaos_sink).start()
        otlp_endpoint = chaos_server.endpoint
        if args.output != "otlp":
            print(
                "agent: --chaos-sink implies --output otlp", file=sys.stderr
            )
            args.output = "otlp"
        print(f"agent: chaos sink on {otlp_endpoint}", file=sys.stderr)

    spool_dir = args.spool_dir or cfg.delivery.spool_dir
    delivery_opts = (
        DeliveryOptions.from_config(cfg.delivery, spool_dir=spool_dir)
        if spool_dir
        else None
    )

    metrics = metrics or AgentMetrics()

    # ---- SLO error-budget / burn-rate engine -------------------------
    burn_engine = None
    tenant = args.tenant or args.namespace
    if (args.burn_engine or cfg.slo.enabled) and args.probe_source == "ring":
        # The SLI stream comes from the synthetic loop's per-request
        # samples; ring mode emits probe events only (SLO events come
        # from the observed workload).  Refusing loudly beats a "burn
        # engine on" banner over an engine that can never record.
        print(
            "agent: the burn engine needs the synthetic SLO loop; "
            "ignored with --probe-source ring",
            file=sys.stderr,
        )
    elif args.burn_engine or cfg.slo.enabled:
        from tpuslo_torch.collector.pipeline import ERROR_RATE_THRESHOLDS
        from tpuslo_torch.sloengine import (
            BurnEngine,
            EngineConfig,
            RequestOutcome,
        )

        burn_engine = BurnEngine(
            EngineConfig.from_toolkit(cfg.slo),
            observer=metrics.slo_observer(),
        )
        print(
            "agent: burn engine on (tenant="
            f"{tenant}, availability>="
            f"{burn_engine.config.availability_target:g}, "
            f"ttft<={burn_engine.config.ttft_objective_ms:g}ms@"
            f"{burn_engine.config.ttft_target:g}, fast "
            f"{burn_engine.config.fast_burn_threshold:g}x/1h+5m, slow "
            f"{burn_engine.config.slow_burn_threshold:g}x/6h+30m)",
            file=sys.stderr,
        )

    # ---- crash-safe runtime: durable snapshots + warm restore --------
    from tpuslo_torch.runtime import AgentRuntime, StateStore

    runtime_observer = metrics.runtime_observer()
    state_dir = args.state_dir or cfg.runtime.state_dir
    store = None
    if state_dir:
        snapshot_interval = (
            args.snapshot_interval_s
            if args.snapshot_interval_s >= 0
            else cfg.runtime.snapshot_interval_s
        )
        import os as os_mod

        store = StateStore(
            os_mod.path.join(state_dir, "agent-state.json"),
            interval_s=snapshot_interval,
            max_age_s=cfg.runtime.snapshot_max_age_s,
            observer=runtime_observer,
        )
    runtime = AgentRuntime(
        store,
        observer=runtime_observer,
        log=lambda msg: print(f"agent: {msg}", file=sys.stderr),
    )
    # Loop progress: the synthetic loop resumes at next_cycle instead
    # of re-emitting from zero; alert_cycle is the webhook high-water
    # mark (alerts are at-most-once across restarts).
    progress = {"next_cycle": 0, "alert_cycle": -1}
    runtime.register(
        "progress",
        lambda: dict(progress),
        lambda s: progress.update(
            next_cycle=int(s.get("next_cycle", 0)),
            alert_cycle=int(s.get("alert_cycle", -1)),
        ),
    )
    if burn_engine is not None:
        # Budgets survive crash-restart: the rings, alert states and
        # counters ride the same snapshot as everything else.
        runtime.register(
            "sloengine",
            burn_engine.export_state,
            burn_engine.restore_state,
        )

    meta_template = Metadata(
        node=args.node,
        namespace=args.namespace,
        pod=f"{args.workload}-agent",
        container=args.workload,
        pid=1,
        tid=1,
        slice_id=cfg.tpu.slice_id,
        host_index=cfg.tpu.host_index,
    )
    enricher = StaticMetadataEnricher(
        TPUMetadataEnricher(dev_glob=cfg.tpu.accel_device_glob).enrich(meta_template)
    )
    generator = Generator(mode, signal_set, enricher=enricher)

    writers = EventWriters(
        output=args.output,
        jsonl_path=args.jsonl_path,
        otlp_endpoint=otlp_endpoint,
        delivery=delivery_opts,
        observer_factory=metrics.delivery_observer,
    )

    # ---- self-observability: cycle spans + incident provenance -------
    from tpuslo_torch.obs import (
        ProvenanceLog,
        SelfTracer,
        SpanExporter,
        TracerConfig,
        trace_endpoint_from_logs,
    )

    obs_cfg = cfg.observability
    obs_enabled = args.trace or obs_cfg.enabled
    span_exporter = None
    trace_channel = None
    trace_poster = None
    if obs_enabled:
        trace_endpoint = (
            args.trace_endpoint
            or obs_cfg.trace_endpoint
            or (
                trace_endpoint_from_logs(otlp_endpoint)
                if args.output == "otlp"
                else ""
            )
        )
        if trace_endpoint:
            span_exporter = SpanExporter(trace_endpoint)
            if delivery_opts is not None:
                # The agent's own telemetry rides the same resilience
                # rails as everyone else's: spool, breaker, retry.
                from tpuslo_torch.delivery.sinks import OTLPRecordSink

                trace_channel = delivery_opts.build_channel(
                    "otlp-traces",
                    OTLPRecordSink(span_exporter),
                    observer=metrics.delivery_observer("otlp-traces"),
                )
            else:
                # No delivery layer: a synchronous POST in the cycle's
                # finish path would stall the loop for the exporter
                # timeout whenever the endpoint is down — hand batches
                # to a bounded background worker instead (best-effort,
                # drop-oldest, accounted).
                from tpuslo_torch.obs import BackgroundSpanPoster

                trace_poster = BackgroundSpanPoster(span_exporter)

    def _export_spans(spans) -> None:
        records = span_exporter.to_records(spans)
        if trace_channel is not None:
            trace_channel.submit("trace", records)
        else:
            trace_poster.submit(records)

    tracer = SelfTracer(
        TracerConfig(
            enabled=obs_enabled,
            sample_rate=(
                args.trace_sample_rate
                if args.trace_sample_rate >= 0
                else obs_cfg.sample_rate
            ),
            slow_cycle_ms=args.trace_slow_ms or obs_cfg.slow_cycle_ms,
            max_overhead_pct=obs_cfg.max_overhead_pct,
        ),
        observer=metrics.trace_observer(),
        # No endpoint = metrics-only tracing: pass no export callback
        # at all, so neither stats nor the spans-exported counter can
        # report spans that never leave the process.
        on_export=_export_spans if span_exporter is not None else None,
        log=lambda msg: print(f"agent: {msg}", file=sys.stderr),
    )
    provenance_path = args.provenance_path or obs_cfg.provenance_path
    if not provenance_path and obs_enabled and (
        args.state_dir or cfg.runtime.state_dir
    ):
        import os as _os

        provenance_path = _os.path.join(
            args.state_dir or cfg.runtime.state_dir, "provenance.jsonl"
        )
    provenance_log = (
        ProvenanceLog(provenance_path)
        if obs_enabled and provenance_path
        else None
    )
    if obs_enabled:
        print(
            "agent: self-tracing on (sample_rate="
            f"{tracer.config.sample_rate:g}, slow>="
            f"{tracer.config.slow_cycle_ms:g}ms, "
            + (
                f"endpoint={span_exporter.endpoint}"
                if span_exporter
                else "metrics-only"
            )
            + (
                f", provenance={provenance_path}" if provenance_log else ""
            )
            + ")",
            file=sys.stderr,
        )

    metrics.up.set(1)
    metrics.capability_mode.labels(mode=mode).set(1)
    metrics.event_kind.labels(kind=args.event_kind).set(1)
    metrics.set_enabled_signals(generator.enabled_signals())

    limiter = RateLimiter(eps, cfg.sampling.burst_limit)
    guard = OverheadGuard(max_overhead)
    recovery = ShedRecoveryPolicy(
        cycles=args.restore_after_cycles or cfg.delivery.restore_after_cycles
    )
    runtime.register(
        "limiter", limiter.export_state, limiter.restore_state
    )
    runtime.register(
        "generator_shed",
        lambda: {"signals": generator.shed_signals()},
        lambda s: generator.import_shed(list(s.get("signals") or [])),
    )

    webhook_url = args.webhook_url or (cfg.webhook.url if cfg.webhook.enabled else "")
    hook = None
    attributor = None
    webhook_channel = None
    if webhook_url:
        hook = webhook.Exporter(
            webhook_url,
            secret=args.webhook_secret or cfg.webhook.secret,
            format=args.webhook_format or cfg.webhook.format,
            timeout_ms=cfg.webhook.timeout_ms,
        )
        attributor = attribution.BayesianAttributor()
        if delivery_opts is not None:
            # Incident delivery rides its own channel: the agent loop
            # never blocks on webhook retries/backoff again.
            from tpuslo_torch.delivery.sinks import WebhookSink

            webhook_channel = delivery_opts.build_channel(
                "webhook",
                WebhookSink(hook),
                observer=metrics.delivery_observer("webhook"),
            )

    def _all_channels():
        return writers.delivery_channels + [
            ch
            for ch in (webhook_channel, trace_channel)
            if ch is not None
        ]

    def _export_breakers():
        return {
            ch.name: ch.breaker.export_state() for ch in _all_channels()
        }

    def _restore_breakers(state):
        for ch in _all_channels():
            if isinstance(state.get(ch.name), dict):
                ch.breaker.restore_state(state[ch.name])

    runtime.register("breakers", _export_breakers, _restore_breakers)

    # ---- real readiness: /readyz tells the truth ---------------------
    from tpuslo_torch.metrics import Readiness

    readiness = Readiness()
    readiness_state = {"draining": False}
    readiness.add_check(
        "drain",
        lambda: (not readiness_state["draining"], "drain in progress"),
    )

    def _breakers_ready():
        channels = _all_channels()
        if channels and all(
            ch.breaker.state == "open" for ch in channels
        ):
            return False, (
                f"all {len(channels)} delivery breakers open "
                "(every sink unreachable)"
            )
        return True, "ok"

    readiness.add_check("breakers", _breakers_ready)
    if store is not None:

        def _snapshot_fresh():
            age = store.age_s()
            max_age = cfg.runtime.snapshot_max_age_s
            if age != float("inf") and max_age > 0 and age > max_age:
                return False, (
                    f"state snapshot stale ({age:.0f}s > {max_age:.0f}s)"
                )
            return True, "ok"

        readiness.add_check("snapshot", _snapshot_fresh)

    server = None
    if args.metrics_port:
        server = start_metrics_server(
            metrics, args.metrics_port, readiness=readiness
        )
        print(
            f"agent: metrics on :{args.metrics_port}/metrics",
            file=sys.stderr,
        )

    # ---- auto-remediation engine: close the observe → act loop -------
    remediation_engine = None
    shed_ownership = None
    if args.remediate or cfg.remediation.enabled:
        if burn_engine is None:
            # The policy gates on burn state and the verifier watches
            # burn evidence; without the burn engine the loop would
            # either act blind or never act.  Refusing loudly beats a
            # "remediation on" banner over an engine that cannot
            # verify.
            print(
                "agent: auto-remediation needs the burn engine "
                "(--burn-engine / config slo:); disabled",
                file=sys.stderr,
            )
        else:
            from tpuslo_torch.remediation import (
                ActionBindings,
                RemediationEngine,
                RemediationPolicy,
                VerifyPolicy,
                default_rules,
            )
            from tpuslo_torch.safety import ShedOwnership

            shed_ownership = ShedOwnership()
            remediation_engine = RemediationEngine(
                policy=RemediationPolicy(
                    rules=default_rules(
                        min_confidence=cfg.remediation.min_confidence,
                        cooldown_s=cfg.remediation.cooldown_s,
                        rate_limit=cfg.remediation.rate_limit,
                        rate_window_s=cfg.remediation.rate_window_s,
                    ),
                    max_concurrent_actions=(
                        cfg.remediation.max_concurrent_actions
                    ),
                    disabled_actions=tuple(
                        cfg.remediation.disabled_actions
                    ),
                ),
                bindings=ActionBindings(
                    probe_manager=generator,
                    ownership=shed_ownership,
                    breakers={
                        ch.name: ch.breaker for ch in _all_channels()
                    },
                    runtime=runtime,
                    burn_engine=burn_engine,
                ),
                verify=VerifyPolicy(
                    windows=cfg.remediation.verify_windows,
                    subside_streak=cfg.remediation.verify_streak,
                    subside_below=cfg.remediation.verify_subside_below,
                ),
                observer=metrics.remediation_observer(),
                provenance_log=provenance_log,
                log=lambda msg: print(f"agent: {msg}", file=sys.stderr),
            )
            runtime.register(
                "remediation",
                remediation_engine.export_state,
                remediation_engine.restore_state,
            )
            runtime.register(
                "shed_ownership",
                shed_ownership.export_state,
                shed_ownership.restore_state,
            )
            print(
                "agent: auto-remediation on (min confidence "
                f"{cfg.remediation.min_confidence:g}, budget "
                f"{cfg.remediation.max_concurrent_actions} concurrent, "
                f"verify {cfg.remediation.verify_windows} windows)",
                file=sys.stderr,
            )

    sample_meta = SampleMeta(
        cluster=args.cluster,
        namespace=args.namespace,
        workload=args.workload,
        service=args.service,
        node=args.node,
        slice_id=cfg.tpu.slice_id,
        host_index=cfg.tpu.host_index,
    )

    ici_prober = None
    if (
        args.ici_probe_interval_s > 0
        and args.event_kind == "slo"
        and args.probe_source != "ring"
    ):
        # Ring mode emits probe events regardless of event_kind, so the
        # guard only applies to the synthetic loop.
        print(
            "agent: --ici-probe-interval-s needs --event-kind probe|both "
            "(probe events are the prober's output); disabled",
            file=sys.stderr,
        )
    elif args.ici_probe_interval_s > 0:
        from tpuslo_torch.parallel.collectives import ActiveICIProber

        ici_prober = ActiveICIProber(
            interval_s=args.ici_probe_interval_s,
            node=args.node,
            namespace=args.namespace,
            slice_id=cfg.tpu.slice_id,
            host_index=cfg.tpu.host_index,
            payload_kb=args.ici_probe_payload_kb,
            log=lambda msg: print(f"agent: {msg}", file=sys.stderr),
        )

    from tpuslo_torch.correlation.matcher import SpanRef
    from tpuslo_torch.correlation.matcher import match as corr_match
    from tpuslo_torch.obs import (
        EvidenceEvent,
        ProvenanceRecord,
        probe_event_id,
    )
    from tpuslo_torch.schema import rfc3339

    def _correlation_summary(decisions) -> dict:
        matched = [d for _, d in decisions if d.matched]
        best = max(matched, key=lambda d: d.confidence, default=None)
        return {
            "window_ms": cfg.correlation.window_ms,
            "total": len(decisions),
            "matched": len(matched),
            "best_tier": best.tier if best else "none",
        }

    def emit_one(idx: int) -> None:
        now = datetime.now(timezone.utc)
        with tracer.cycle(
            "agent.cycle", cycle=idx, scenario=args.scenario
        ) as tr:
            # ---- generate: synthetic sample → SLO + probe events -----
            with tr.stage("generate") as sp:
                sample = build_synthetic_sample(
                    args.scenario, idx, now, sample_meta
                )
                slo_events = (
                    normalize_sample(sample)
                    if args.event_kind in ("slo", "both")
                    else []
                )
                generated: list = []
                if args.event_kind in ("probe", "both"):
                    probe_meta = Metadata(trace_id=sample.trace_id)
                    generated = list(generator.generate(sample, probe_meta))
                    if ici_prober is not None:
                        # Measured collectives ride the same validation /
                        # rate-limit / emit path as every other signal.
                        generated.extend(
                            ici_prober.maybe_probe(time.monotonic())
                        )
                sp.set(
                    slo_events=len(slo_events),
                    probe_events=len(generated),
                    fault_label=sample.fault_label or "",
                )

            # ---- ingest gate: a pass-through until the gate is ported
            with tr.stage("ingest_gate") as sp:
                gated = generated
                sp.set(
                    events_in=len(generated),
                    events_out=len(gated),
                    gate_enabled=False,
                )

            # ---- validate: schema + rate limit ---------------------
            with tr.stage("validate") as sp:
                valid_slo = []
                slo_rejects = 0
                for event in slo_events:
                    if validate_slo(event):
                        valid_slo.append(event)
                    else:
                        slo_rejects += 1
                        metrics.dropped.labels(reason="schema").inc()
                emitted = []
                rate_dropped = schema_dropped = 0
                for event in gated:
                    if not limiter.allow():
                        rate_dropped += 1
                        metrics.dropped.labels(reason="rate_limit").inc()
                        continue
                    if not validate_probe(event):
                        schema_dropped += 1
                        metrics.dropped.labels(reason="schema").inc()
                        continue
                    emitted.append(event)
                sp.set(
                    slo_valid=len(valid_slo),
                    slo_rejected=slo_rejects,
                    probe_valid=len(emitted),
                    rate_limited=rate_dropped,
                    schema_rejected=schema_dropped,
                )

            # ---- burn: fold the request outcome into the SLI stream
            # and run the multi-window burn rules.  A transition here
            # is the alert; sustained burns only move the gauges.
            burn_transitions: list = []
            if burn_engine is not None:
                with tr.stage("burn") as sp:
                    tps = sample.token_throughput_tps
                    burn_engine.record(
                        RequestOutcome(
                            tenant=tenant,
                            ts_unix_nano=int(now.timestamp() * 1e9),
                            ttft_ms=sample.ttft_ms,
                            tpot_ms=(1000.0 / tps if tps > 0 else 0.0),
                            tokens=max(
                                1,
                                int(
                                    tps
                                    * sample.request_latency_ms
                                    / 1000.0
                                ),
                            ),
                            status=(
                                "error"
                                if sample.error_rate
                                >= ERROR_RATE_THRESHOLDS[1]
                                else "ok"
                            ),
                            request_id=sample.request_id,
                        )
                    )
                    burn_transitions = burn_engine.evaluate(
                        now.timestamp()
                    )
                    for transition in burn_transitions:
                        print(
                            "agent: burn alert: "
                            f"{transition.severity} "
                            f"{transition.tenant}/"
                            f"{transition.objective} "
                            f"{transition.from_state}->"
                            f"{transition.to_state} "
                            f"(burn {transition.burn_long:.1f}x long / "
                            f"{transition.burn_short:.1f}x short)",
                            file=sys.stderr,
                        )
                    sp.set(
                        transitions=len(burn_transitions),
                        alerting=burn_engine.policy.alerting_count(),
                    )

            # ---- correlate: probe events vs this cycle's trace -----
            # Per-event tier/confidence decisions feed the incident
            # provenance chain — their only consumer — so the matcher
            # runs exactly on the cycles that will attribute (fault
            # label + webhook) with observability on; every other
            # cycle records the stage as skipped and pays nothing.
            incident_fault = (
                hook is not None
                and attributor is not None
                and sample.fault_label
            )
            decisions: list = []
            with tr.stage("correlate") as sp:
                if (
                    incident_fault
                    and emitted
                    and (tracer.enabled or provenance_log is not None)
                ):
                    span_ref = SpanRef(
                        timestamp=now,
                        trace_id=sample.trace_id,
                        service=args.service,
                        node=args.node,
                    )
                    ts_cache: dict = {}
                    decisions = [
                        (
                            event,
                            corr_match(
                                span_ref,
                                _signal_ref(event, ts_cache),
                                cfg.correlation.window_ms,
                            ),
                        )
                        for event in emitted
                    ]
                    matched = [d for _, d in decisions if d.matched]
                    best = max(
                        matched, key=lambda d: d.confidence, default=None
                    )
                    sp.set(
                        total=len(emitted),
                        matched=len(matched),
                        best_tier=best.tier if best else "",
                        window_ms=cfg.correlation.window_ms,
                    )
                else:
                    sp.set(total=len(emitted), skipped=True)

            # ---- attribute: fault cycles → incident posterior ------
            attr = None
            prov_rec = None
            webhook_outcome = ""
            with tr.stage("attribute") as sp:
                if incident_fault and idx <= progress["alert_cycle"]:
                    # Already alerted by a previous incarnation
                    # (restored high-water mark): re-emitting would
                    # page twice for one incident.
                    webhook_outcome = "deduped"
                    sp.set(deduped=True)
                elif incident_fault:
                    # The burn engine supplies the customer-impact
                    # denominator: slo_impact carries the real max
                    # active burn instead of a placeholder, so webhook
                    # severity escalates on fast burns.
                    active_burns = (
                        burn_engine.active_burns()
                        if burn_engine is not None
                        else []
                    )
                    incident_burn = max(
                        2.0,
                        (
                            burn_engine.max_active_burn(active_burns)
                            if burn_engine is not None
                            else 0.0
                        ),
                    )
                    fault = attribution.FaultSample(
                        incident_id=f"agent-inc-{idx + 1:04d}",
                        timestamp=now,
                        cluster=args.cluster,
                        namespace=args.namespace,
                        service=args.service,
                        fault_label=sample.fault_label,
                        confidence=0.9,
                        burn_rate=incident_burn,
                        window_minutes=5,
                        request_id=sample.request_id,
                        trace_id=sample.trace_id,
                        # Full fault profile, independent of the
                        # currently-enabled probe set: shedding
                        # shouldn't starve attribution.
                        signals=profile_for_fault(sample.fault_label),
                    )
                    attr = attributor.attribute_sample(fault)
                    if active_burns:
                        # The incident records which budgets were
                        # burning when it fired — the page's "how bad
                        # is this" context.
                        attr.slo_burn = {
                            "evaluated_at": rfc3339(now),
                            "max_burn_rate": round(incident_burn, 4),
                            "alerting": active_burns,
                        }
                    if tracer.enabled or provenance_log is not None:
                        supporting = {
                            s
                            for h in attr.fault_hypotheses
                            for s in h.evidence
                        }
                        prov_rec = ProvenanceRecord(
                            incident_id=attr.incident_id,
                            recorded_at=rfc3339(now),
                            cycle=idx,
                            trace_id=tr.trace_id,
                            root_span_id=(
                                tr.root.span_id if tr.root else ""
                            ),
                            fault_label=sample.fault_label,
                            predicted_fault_domain=(
                                attr.predicted_fault_domain
                            ),
                            confidence=attr.confidence,
                            posterior={
                                h.domain: round(h.posterior, 6)
                                for h in attr.fault_hypotheses[:5]
                            },
                            events=[
                                EvidenceEvent(
                                    event_id=probe_event_id(
                                        ev.signal, ev.ts_unix_nano
                                    ),
                                    signal=ev.signal,
                                    value=ev.value,
                                    tier=dec.tier,
                                    confidence=dec.confidence,
                                )
                                for ev, dec in decisions
                                if ev.signal in supporting or dec.matched
                            ],
                            correlation=_correlation_summary(decisions),
                            burning=active_burns,
                        )
                        attr.provenance = prov_rec.attribution_block()
                        # The provenance record points at this cycle's
                        # trace — force tail sampling to keep it, or
                        # the pointer would dangle for ~95% of
                        # incidents at the default sample rate.
                        tr.mark_keep()
                    sp.set(
                        incident_id=attr.incident_id,
                        domain=attr.predicted_fault_domain,
                        confidence=round(attr.confidence, 4),
                    )
                else:
                    sp.set(skipped=True)

            # ---- deliver: writers + webhook ------------------------
            with tr.stage("deliver") as sp:
                if args.event_kind in ("slo", "both"):
                    try:
                        writers.emit_slo(valid_slo)
                        metrics.slo_events.inc(len(valid_slo))
                    except Exception as exc:  # noqa: BLE001 — drops
                        metrics.dropped.labels(reason="emit").inc(
                            len(valid_slo)
                        )
                        print(
                            f"agent: slo emit failed: {exc}",
                            file=sys.stderr,
                        )
                if args.event_kind in ("probe", "both"):
                    try:
                        writers.emit_probe(emitted)
                        for event in emitted:
                            metrics.observe_probe(event.signal, event.value)
                    except Exception as exc:  # noqa: BLE001
                        metrics.dropped.labels(reason="emit").inc(
                            len(emitted)
                        )
                        print(
                            f"agent: probe emit failed: {exc}",
                            file=sys.stderr,
                        )
                if webhook_outcome == "deduped":
                    metrics.webhook_sent.labels(outcome="deduped").inc()
                elif attr is not None:
                    # At-most-once across restarts: persist the high-
                    # water mark *before* the send, so a crash in
                    # between loses (at worst) one alert instead of
                    # duplicating it — downstream pagers treat
                    # duplicate incidents as new pages, lost ones
                    # re-fire on the next burn window.
                    progress["alert_cycle"] = idx
                    if runtime.enabled:
                        runtime.snapshot_now()
                    if webhook_channel is not None:
                        import json as json_mod

                        webhook_channel.submit(
                            "incident",
                            [json_mod.loads(hook.build_payload(attr))],
                        )
                        metrics.webhook_sent.labels(outcome="queued").inc()
                        webhook_outcome = "queued"
                    else:
                        try:
                            hook.send(attr)
                            metrics.webhook_sent.labels(outcome="ok").inc()
                            webhook_outcome = "ok"
                        except webhook.WebhookError as exc:
                            metrics.webhook_sent.labels(
                                outcome="error"
                            ).inc()
                            webhook_outcome = "error"
                            print(
                                f"agent: webhook failed: {exc}",
                                file=sys.stderr,
                            )
                sp.set(
                    slo=len(valid_slo),
                    probe=len(emitted),
                    webhook=webhook_outcome or "none",
                )
                if prov_rec is not None:
                    prov_rec.delivery = {
                        "outcome": webhook_outcome or "none",
                        "channel": (
                            "delivery_channel"
                            if webhook_channel is not None
                            else "direct"
                        ),
                    }

            # ---- remediate: high-confidence attribution × burn ------
            # → ranked reversible action, then verify-or-rollback.
            if remediation_engine is not None:
                with tr.stage("remediate") as sp:
                    now_s = now.timestamp()
                    if attr is not None:
                        from tpuslo_torch.remediation import (
                            AttributionContext,
                        )

                        ctx = AttributionContext(
                            incident_id=attr.incident_id,
                            domain=attr.predicted_fault_domain,
                            confidence=attr.confidence,
                            burn_state=burn_engine.policy.state_of(
                                tenant, "availability"
                            ),
                            burn_rate=burn_engine.max_active_burn(),
                            tenant=tenant,
                            node=args.node,
                            slice_id=cfg.tpu.slice_id,
                            at_s=now_s,
                        )
                        acted = remediation_engine.consider(
                            ctx, now_s, provenance=prov_rec
                        )
                        if acted is not None:
                            print(
                                "agent: remediation: "
                                f"{acted.kind} on {acted.target} "
                                f"[{acted.phase}] for "
                                f"{attr.incident_id} — {acted.detail}",
                                file=sys.stderr,
                            )

                    def _verify_burn(rec) -> float:
                        # Verify evidence: the fast-reacting 5m
                        # availability burn of the acted tenant.
                        watch = (
                            rec.target
                            if rec.kind == "demote_tenant"
                            else tenant
                        )
                        for stat in burn_engine.status():
                            if (
                                stat.tenant == watch
                                and stat.objective == "availability"
                            ):
                                return stat.burn_rates.get("5m", 0.0)
                        return 0.0

                    for settled in remediation_engine.tick(
                        now_s, _verify_burn
                    ):
                        print(
                            "agent: remediation: "
                            f"{settled.kind} on {settled.target} "
                            f"settled {settled.phase} after "
                            f"{settled.windows_seen} window(s)"
                            + (
                                " — ESCALATED"
                                if settled.escalated
                                else ""
                            ),
                            file=sys.stderr,
                        )
                    snap = remediation_engine.snapshot()
                    sp.set(
                        in_flight=snap["in_flight"],
                        applied=snap["applied"],
                        confirmed=snap["confirmed"],
                        rolled_back=snap["rolled_back"],
                    )

            # ---- snapshot: stats, overhead guard, durable state ----
            with tr.stage("snapshot") as sp:
                if (
                    args.stats_interval_cycles
                    and (idx + 1) % args.stats_interval_cycles == 0
                ):
                    _print_stats(metrics, burn_engine)
                result = guard.evaluate()
                if result.valid:
                    metrics.cpu_overhead_pct.set(result.cpu_pct)
                    if result.over_budget:
                        recovery.note(result)  # breaks the streak
                        shed = generator.disable_highest_cost()
                        if shed:
                            print(
                                f"agent: overhead {result.cpu_pct:.2f}% > "
                                f"{max_overhead:.2f}%, disabled {shed}",
                                file=sys.stderr,
                            )
                            metrics.set_enabled_signals(
                                generator.enabled_signals()
                            )
                    elif recovery.note(result):
                        shed_list = generator.shed_signals()
                        candidate = shed_list[-1] if shed_list else None
                        if (
                            candidate is not None
                            and shed_ownership is not None
                            and not shed_ownership.may_restore(
                                candidate, "guard"
                            )
                        ):
                            # Ownership precedence: the recovery streak
                            # must not restore a probe the remediation
                            # engine shed — its verifier owns that
                            # lever until it confirms or rolls back.
                            print(
                                f"agent: restore of {candidate} held "
                                "(remediation-owned shed)",
                                file=sys.stderr,
                            )
                            restored = None
                        else:
                            restored = generator.restore_one()
                        if restored:
                            print(
                                f"agent: overhead {result.cpu_pct:.2f}% "
                                f"under budget for {recovery.cycles} "
                                f"cycles, re-enabled {restored}",
                                file=sys.stderr,
                            )
                            metrics.signals_restored.labels(
                                signal=restored
                            ).inc()
                            metrics.set_enabled_signals(
                                generator.enabled_signals()
                            )
                metrics.mark_cycle()
                # Progress advances only after the cycle's events hit
                # the writers: a crash replays from the last durable
                # cycle (at-least-once; the restored dedup digest
                # absorbs the overlap).
                progress["next_cycle"] = idx + 1
                snapshot_age = -1.0
                if runtime.enabled:
                    runtime.maybe_snapshot()
                    age = runtime.store.age_s()
                    if age != float("inf"):
                        metrics.runtime_snapshot_age_seconds.set(age)
                        snapshot_age = age
                sp.set(
                    snapshot_age_s=round(snapshot_age, 3),
                    breakers_open=sum(
                        1
                        for ch in _all_channels()
                        if ch.breaker.state == "open"
                    ),
                )

            # Provenance is finalized after the last stage CM closed,
            # so stages_ms covers the full cycle — deliver and snapshot
            # included (the two stages most likely to explain a slow
            # incident cycle).
            if prov_rec is not None:
                prov_rec.stages_ms = {
                    s.name: round(s.duration_ms, 4)
                    for s in getattr(tr, "spans", [])
                }
                if provenance_log is not None:
                    provenance_log.record(prov_rec)

    # Warm restore happens after every component registered its hooks;
    # ring-loop components (ProbeManager shed list, supervisor) apply
    # their restored sections at late registration inside the loop.
    restore_outcome = runtime.restore(cold_start=args.cold_start)
    if runtime.enabled:
        detail = ""
        if restore_outcome == "restored":
            detail = (
                f" (age {runtime.restored_age_s:.1f}s, components: "
                f"{','.join(runtime.restored_components) or 'none'})"
            )
        print(
            f"agent: runtime: snapshot {restore_outcome}{detail}; "
            f"resuming at cycle {progress['next_cycle']}",
            file=sys.stderr,
        )

    from tpuslo_torch.runtime import (
        DrainController,
        DrainSignal,
        install_drain_handler,
    )

    # SIGTERM takes exactly the KeyboardInterrupt path: one drain
    # sequence for Ctrl-C and for a Kubernetes pod termination.
    restore_handlers = install_drain_handler()
    drain_timeout = args.drain_timeout_s or cfg.runtime.drain_timeout_s
    drain_reason = "completed"
    probe_group = False
    try:
        # The prober's one-rank group comes up before the first cycle,
        # and goes down after the drain.
        probe_group = ici_prober is not None and open_probe_group(args.device)
        if args.probe_source == "ring":
            _run_ring_loop(
                args, cfg, mode, signal_set, enricher, writers, metrics,
                limiter, guard, recovery, ici_prober=ici_prober,
                runtime=runtime, runtime_observer=runtime_observer,
                self_tracer=tracer,
            )
        else:
            idx = progress["next_cycle"]
            while not args.count or idx < args.count:
                emit_one(idx)
                idx += 1
                if args.count and idx >= args.count:
                    break
                time.sleep(args.interval_s)
    except KeyboardInterrupt:
        drain_reason = "sigint"
    except DrainSignal as sig:
        drain_reason = f"signal_{sig.signum}"
    finally:
        restore_handlers()
        readiness_state["draining"] = True  # /readyz flips to 503 first
        drain = DrainController(
            drain_reason,
            deadline_s=drain_timeout,
            log=lambda msg: print(f"agent: {msg}", file=sys.stderr),
        )
        metrics.up.set(0)
        _print_stats(metrics, burn_engine)
        if obs_enabled:
            snap = dict(tracer.snapshot())
            if trace_poster is not None:
                snap["direct_poster"] = dict(trace_poster.stats)
            print(f"agent: self-trace: {snap}", file=sys.stderr)
        # Generation stopped above; now push queued batches out (or to
        # the spool), snapshot, and release sinks — all on one deadline.
        if webhook_channel is not None:
            drain.step(
                "flush_webhook",
                lambda budget: webhook_channel.close(
                    flush_timeout_s=budget
                ),
            )
        drain.step(
            "flush_writers",
            lambda budget: writers.close(flush_timeout_s=budget),
        )
        if trace_channel is not None:
            drain.step(
                "flush_traces",
                lambda budget: trace_channel.close(flush_timeout_s=budget),
            )
        if trace_poster is not None:
            drain.step(
                "flush_traces",
                lambda budget: trace_poster.close(timeout_s=budget),
            )
        if provenance_log is not None:
            drain.step(
                "close_provenance", lambda budget: provenance_log.close()
            )
        if runtime.enabled:
            drain.step(
                "final_snapshot", lambda budget: runtime.snapshot_now()
            )
        report = drain.finish()
        runtime_observer.drain(report.outcome, report.duration_s)
        print(f"agent: drain: {report.summary()}", file=sys.stderr)
        for channel in (
            writers.delivery_channels
            + ([webhook_channel] if webhook_channel else [])
            + ([trace_channel] if trace_channel else [])
        ):
            snap = channel.snapshot()
            print(
                "agent: delivery[{sink}]: delivered={delivered_events} "
                "spooled={spooled_events} replayed={replayed_events} "
                "dead_lettered={dead_lettered_events} retries={retries} "
                "breaker={breaker} spool_bytes={spool_bytes}".format(**snap),
                file=sys.stderr,
            )
        if chaos_server is not None:
            chaos_server.stop()
        if server is not None:
            server.shutdown()
        if probe_group:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


def _run_ring_loop(
    args, cfg, mode, signal_set, enricher, writers, metrics, limiter, guard,
    recovery, ici_prober=None, runtime=None,
    runtime_observer=None, self_tracer=None,
) -> None:
    """The real-probe path: ringbuf → normalize → schema → emit.

    This is the loop the reference scaffolded but never closed (its
    RingBufConsumer/ProbeManager have no caller outside tests —
    SURVEY.md §0).  Degradation is graceful and reported: no libbpf or
    no privileges → the kernel surface is skipped but userspace rings
    (BCC fallback, injectors, hello tracer, HBM sampler) still flow.
    """
    import os
    import tempfile

    from tpuslo_torch.collector.hbm_sampler import HBMSampler
    from tpuslo_torch.collector.hello_tracer import HelloTracer
    from tpuslo_torch.collector.probe_manager import ProbeManager
    from tpuslo_torch.collector.ringbuf import RingBufConsumer, to_probe_event
    from tpuslo_torch.signals import constants as sigconst

    pm = ProbeManager(guard=guard)
    report = pm.attach_all(signal_set)
    attached = report.attached_signals
    print(
        f"agent: ring mode, {len(attached)}/{len(signal_set)} signals "
        f"attached ({mode})",
        file=sys.stderr,
    )
    for r in report.results:
        if not r.attached:
            print(
                f"agent:   {r.signal}: {r.status} {r.detail}".rstrip(),
                file=sys.stderr,
            )
    metrics.set_enabled_signals(attached)

    consumer = RingBufConsumer(
        steal_window_ms=1000,
        batch=cfg.sampling.burst_limit or 256,
    )
    known_fds: set[int] = set()
    for fd in pm.ringbuf_fds():
        consumer.add_kernel_ringbuf(fd)
        known_fds.add(fd)

    def _sync_ring_fds() -> None:
        """Re-register new ring fds; forget fds closed by a detach."""
        nonlocal known_fds
        current = set(pm.ringbuf_fds())
        for fd in current - known_fds:
            try:
                consumer.add_kernel_ringbuf(fd)
                known_fds.add(fd)
            except Exception as exc:  # noqa: BLE001
                print(f"agent: ring re-add failed: {exc}", file=sys.stderr)
        known_fds &= current

    # ---- probe supervision (tpuslo.runtime.ProbeSupervisor) ----------
    from tpuslo_torch.runtime import (
        ProbeSupervisor,
        RuntimeObserver,
        SupervisorConfig,
    )

    if runtime_observer is None:
        runtime_observer = RuntimeObserver()

    def _restart_probe(signal: str) -> bool:
        pm.detach_signal(signal)
        restarted = signal in pm.attach_all([signal]).attached_signals
        _sync_ring_fds()
        return restarted

    def _flap_shed(signal: str, reason: str) -> None:
        # Route through the shed list so restore_one can bring the
        # signal back (reverse cost order) once the hold-down expires.
        pm.import_shed([signal])
        _sync_ring_fds()
        metrics.set_enabled_signals(pm.attached_signals)
        runtime_observer.flap_shed(signal)

    supervisor = ProbeSupervisor(
        config=SupervisorConfig(
            heartbeat_timeout_s=cfg.runtime.supervisor_heartbeat_timeout_s,
            flap_restarts=cfg.runtime.supervisor_flap_restarts,
            flap_window_s=cfg.runtime.supervisor_flap_window_s,
            flap_holddown_s=cfg.runtime.supervisor_flap_holddown_s,
        ),
        restart=_restart_probe,
        shed=_flap_shed,
        log=lambda msg: print(f"agent: {msg}", file=sys.stderr),
    )
    supervisor.watch(attached)
    if runtime is not None:
        # Late registration: a restored "supervisor"/"pm_shed" section
        # pending from main's restore pass applies here.
        runtime.register(
            "supervisor", supervisor.export_state, supervisor.restore_state
        )
        runtime.register(
            "pm_shed",
            lambda: {"signals": pm.shed_signals},
            lambda s: pm.import_shed(list(s.get("signals") or [])),
        )
        metrics.set_enabled_signals(pm.attached_signals)

    # Userspace side-channel ring: hello tracer + HBM sampler share it,
    # plus whatever external producer --ring-path points at.
    tracer = None
    sampler = None
    side_ring = args.ring_path
    side_ring_owned = False
    if not side_ring and (args.hello or sigconst.SIGNAL_HBM_UTILIZATION_PCT
                          in signal_set):
        # mkstemp (not the race-prone, deprecated mktemp): the path is
        # created 0600 and owned by us; the ring producer re-initializes
        # it in place (O_TRUNC) before the consumer maps it.
        fd, side_ring = tempfile.mkstemp(
            prefix="tpuslo-ring-", suffix=".buf"
        )
        os.close(fd)
        side_ring_owned = True
    if args.hello and side_ring:
        tracer = HelloTracer(side_ring, interval_s=5.0)
        tracer.start()
    if side_ring and sigconst.SIGNAL_HBM_UTILIZATION_PCT in signal_set:
        try:
            sampler = HBMSampler(side_ring, live=args.device == "cuda")
        except Exception:  # noqa: BLE001 — sampler is best-effort
            sampler = None
    if side_ring:
        try:
            consumer.add_userspace_ring(side_ring)
        except Exception as exc:  # noqa: BLE001
            print(f"agent: side ring attach failed: {exc}", file=sys.stderr)

    meta_template = Metadata(
        node=args.node,
        namespace=args.namespace,
        pod=f"{args.workload}-agent",
        container=args.workload,
        pid=1,
        tid=1,
        tpu_chip=args.tpu_chip,
        slice_id=args.slice_id,
        host_index=args.host_index,
        xla_program_id=args.xla_program_id,
    )

    if args.event_kind == "slo":
        print(
            "agent: ring mode emits probe events only "
            "(SLO events come from the observed workload)",
            file=sys.stderr,
        )

    def emit_probe_event(event) -> None:
        if not limiter.allow():
            metrics.dropped.labels(reason="rate_limit").inc()
            return
        if not validate_probe(event):
            metrics.dropped.labels(reason="schema").inc()
            return
        try:
            writers.emit_probe([event])
            metrics.observe_probe(event.signal, event.value)
        except Exception as exc:  # noqa: BLE001
            metrics.dropped.labels(reason="emit").inc()
            print(f"agent: probe emit failed: {exc}", file=sys.stderr)

    if self_tracer is None:
        from tpuslo_torch.obs import SelfTracer, TracerConfig

        self_tracer = SelfTracer(TracerConfig(enabled=False))

    cycles = 0
    try:
        while True:
            # Ring cycles get a shallower span tree than the synthetic
            # loop (gate/validate/deliver happen per-event inside the
            # consumer drain), but the same root span + tail sampling.
            with self_tracer.cycle(
                "agent.cycle", cycle=cycles, loop="ring"
            ) as tr:
                with tr.stage("generate") as sp:
                    if sampler is not None:
                        sampler.sample_once()
                    polled = list(
                        consumer.poll(
                            timeout_ms=int(args.interval_s * 500)
                        )
                    )
                    sp.set(samples=len(polled))
                with tr.stage("deliver") as sp:
                    emitted_n = 0
                    for sample in polled:
                        supervisor.beat(sample.signal)
                        event = to_probe_event(
                            sample, meta_template, enricher
                        )
                        if event is None:
                            if sample.signal == "hello_heartbeat_total":
                                metrics.mark_cycle()
                            continue
                        emit_probe_event(event)
                        emitted_n += 1
                    if ici_prober is not None:
                        # Active interconnect probe rides the same emit
                        # path as kernel-ring events.
                        for event in ici_prober.maybe_probe(
                            time.monotonic()
                        ):
                            emit_probe_event(event)
                            emitted_n += 1
                    sp.set(events=emitted_n)

                with tr.stage("supervise") as sp:
                    restarts = 0
                    for action in supervisor.evaluate():
                        if action.action == "restarted":
                            restarts += 1
                            runtime_observer.probe_restarted(action.signal)
                        print(
                            f"agent: supervisor: {action.signal} "
                            f"{action.action} {action.detail}".rstrip(),
                            file=sys.stderr,
                        )
                    sp.set(restarts=restarts)

                with tr.stage("guard") as sp:
                    result = guard.evaluate()
                    if result.valid:
                        metrics.cpu_overhead_pct.set(result.cpu_pct)
                        sp.set(cpu_pct=round(result.cpu_pct, 3))
                        if result.over_budget:
                            recovery.note(result)  # breaks the streak
                            shed = pm.shed_highest_cost()
                            if shed:
                                print(
                                    f"agent: overhead "
                                    f"{result.cpu_pct:.2f}%, "
                                    f"detached {shed}",
                                    file=sys.stderr,
                                )
                                supervisor.forget(shed)
                                metrics.set_enabled_signals(
                                    pm.attached_signals
                                )
                                # Detach closed that object's ring fd;
                                # forget it so a restored probe reusing
                                # the fd number re-registers.
                                known_fds &= set(pm.ringbuf_fds())
                        elif recovery.note(result):
                            shed_list = pm.shed_signals
                            candidate = (
                                shed_list[-1] if shed_list else None
                            )
                            if (
                                candidate is not None
                                and not supervisor.may_restore(candidate)
                            ):
                                # Flap hold-down outranks the overhead-
                                # guard recovery streak: quiet CPU
                                # cycles say nothing about why the
                                # supervisor shed a flapping probe.
                                print(
                                    f"agent: restore of {candidate} "
                                    "held down (flapping)",
                                    file=sys.stderr,
                                )
                                restored = None
                            else:
                                restored = pm.restore_one()
                            if restored:
                                print(
                                    f"agent: overhead "
                                    f"{result.cpu_pct:.2f}% under "
                                    f"budget for {recovery.cycles} "
                                    f"cycles, re-attached {restored}",
                                    file=sys.stderr,
                                )
                                supervisor.note_restored(restored)
                                metrics.signals_restored.labels(
                                    signal=restored
                                ).inc()
                                metrics.set_enabled_signals(
                                    pm.attached_signals
                                )
                                _sync_ring_fds()

                with tr.stage("snapshot") as sp:
                    metrics.mark_cycle()
                    if runtime is not None and runtime.enabled:
                        runtime.maybe_snapshot()
                        age = runtime.store.age_s()
                        if age != float("inf"):
                            # Kept current even across failed saves:
                            # the staleness alert must fire then.
                            metrics.runtime_snapshot_age_seconds.set(age)
            cycles += 1
            if (
                args.stats_interval_cycles
                and cycles % args.stats_interval_cycles == 0
            ):
                _print_stats(metrics)
            if args.count and cycles >= args.count:
                break
            time.sleep(args.interval_s)
    finally:
        if tracer is not None:
            tracer.stop()
        if sampler is not None:
            sampler.close()
        consumer.close()
        pm.detach_all()
        if side_ring_owned:
            try:
                os.unlink(side_ring)
            except OSError:
                pass


if __name__ == "__main__":
    raise SystemExit(main())
