"""Agent Prometheus metrics + /metrics //healthz //readyz server.

Reference: ``cmd/agent/main.go:154-249`` — heartbeat, up,
cpu_overhead_pct, event-kind / capability / signal-enabled one-hot
gauges, dropped-by-reason counter, DNS latency histogram, probe-event
counter.  The TPU-native build adds a TPU-signal counter and an
hbm-utilization gauge so dashboards can chart device pressure directly
from the agent.

The port's own copy of ``tpuslo/metrics/registry.py``.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from prometheus_client import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)
from prometheus_client.exposition import CONTENT_TYPE_LATEST

from tpuslo_torch.signals import ALL_SIGNALS, TPU_SIGNALS


class AgentMetrics:
    """Registry of the node agent's operational series."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.heartbeat = Gauge(
            "llm_slo_agent_heartbeat_timestamp_seconds",
            "Unix time of the agent's last emit cycle",
            registry=self.registry,
        )
        self.up = Gauge(
            "llm_slo_agent_up", "1 while the agent loop is running",
            registry=self.registry,
        )
        self.cpu_overhead_pct = Gauge(
            "llm_slo_agent_cpu_overhead_pct",
            "Agent self-measured CPU overhead percent",
            registry=self.registry,
        )
        self.event_kind = Gauge(
            "llm_slo_agent_event_kind",
            "One-hot event kind selector",
            ["kind"],
            registry=self.registry,
        )
        self.capability_mode = Gauge(
            "llm_slo_agent_capability_mode",
            "One-hot capability mode",
            ["mode"],
            registry=self.registry,
        )
        self.signal_enabled = Gauge(
            "llm_slo_agent_signal_enabled",
            "1 when a signal probe is enabled",
            ["signal"],
            registry=self.registry,
        )
        self.dropped = Counter(
            "llm_slo_agent_events_dropped_total",
            "Events dropped by reason",
            ["reason"],
            registry=self.registry,
        )
        self.slo_events = Counter(
            "llm_slo_agent_slo_events_total",
            "SLO events emitted",
            registry=self.registry,
        )
        self.probe_events = Counter(
            "llm_slo_agent_probe_events_total",
            "Probe events emitted",
            ["signal"],
            registry=self.registry,
        )
        self.dns_latency_ms = Histogram(
            "llm_slo_agent_dns_latency_ms",
            "Observed DNS latency signal values",
            buckets=(5, 10, 25, 50, 100, 200, 400, 800),
            registry=self.registry,
        )
        self.hbm_utilization_pct = Gauge(
            "llm_tpu_agent_hbm_utilization_pct",
            "Latest observed HBM utilization percent",
            registry=self.registry,
        )
        self.ici_collective_ms = Histogram(
            "llm_tpu_agent_ici_collective_ms",
            "Observed ICI collective latency signal values "
            "(passive uprobe or active icibench prober)",
            buckets=(0.5, 1, 2.5, 5, 10, 20, 40, 80),
            registry=self.registry,
        )
        self.tpu_events = Counter(
            "llm_tpu_agent_probe_events_total",
            "TPU-side probe events emitted",
            registry=self.registry,
        )
        self.webhook_sent = Counter(
            "llm_slo_agent_webhook_deliveries_total",
            "Webhook deliveries by outcome",
            ["outcome"],
            registry=self.registry,
        )
        # ---- resilient-delivery series (tpuslo.delivery) -------------
        self.delivery_queue_depth = Gauge(
            "llm_slo_agent_delivery_queue_depth",
            "Batches queued in memory for a sink (incl. in-flight)",
            ["sink"],
            registry=self.registry,
        )
        self.delivery_spool_bytes = Gauge(
            "llm_slo_agent_delivery_spool_bytes",
            "Bytes spooled to disk awaiting replay, per sink",
            ["sink"],
            registry=self.registry,
        )
        self.delivery_breaker_state = Gauge(
            "llm_slo_agent_delivery_breaker_state",
            "Circuit-breaker state per sink (0=closed 1=half-open 2=open)",
            ["sink"],
            registry=self.registry,
        )
        self.delivery_breaker_transitions = Counter(
            "llm_slo_agent_delivery_breaker_transitions_total",
            "Circuit-breaker state transitions per sink, by entered state",
            ["sink", "state"],
            registry=self.registry,
        )
        self.delivery_delivered = Counter(
            "llm_slo_agent_delivery_delivered_events_total",
            "Events delivered to a sink (live + replayed)",
            ["sink"],
            registry=self.registry,
        )
        self.delivery_retries = Counter(
            "llm_slo_agent_delivery_retries_total",
            "Sink send retries",
            ["sink"],
            registry=self.registry,
        )
        self.delivery_spooled = Counter(
            "llm_slo_agent_delivery_spooled_events_total",
            "Events written to the disk spool (not drops: replay pending)",
            ["sink"],
            registry=self.registry,
        )
        self.delivery_replayed = Counter(
            "llm_slo_agent_delivery_replayed_events_total",
            "Spooled events successfully replayed to a sink",
            ["sink"],
            registry=self.registry,
        )
        self.delivery_dead_letters = Counter(
            "llm_slo_agent_delivery_dead_letter_events_total",
            "Events written to the dead-letter file, by reason class",
            ["sink", "reason"],
            registry=self.registry,
        )
        self.delivery_truncated = Counter(
            "llm_slo_agent_delivery_spool_truncated_batches_total",
            "Spooled batches evicted by the size/age caps (lost evidence)",
            ["sink"],
            registry=self.registry,
        )
        self.signals_restored = Counter(
            "llm_slo_agent_signals_restored_total",
            "Shed probe signals re-enabled after sustained under-budget "
            "guard cycles",
            ["signal"],
            registry=self.registry,
        )
        # ---- ingest-gate series (tpuslo.ingest) ----------------------
        self.ingest_admitted = Counter(
            "llm_slo_agent_ingest_admitted_events_total",
            "Events admitted through the telemetry gate in order",
            registry=self.registry,
        )
        self.ingest_duplicates = Counter(
            "llm_slo_agent_ingest_duplicate_events_total",
            "Events suppressed by the gate's dedup window",
            registry=self.registry,
        )
        self.ingest_quarantined = Counter(
            "llm_slo_agent_ingest_quarantined_events_total",
            "Malformed events quarantined by the gate, by reason class",
            ["reason"],
            registry=self.registry,
        )
        self.ingest_late_admitted = Counter(
            "llm_slo_agent_ingest_late_admitted_events_total",
            "Events admitted behind the watermark (low-confidence path)",
            registry=self.registry,
        )
        self.ingest_clock_skew_ms = Gauge(
            "llm_slo_agent_ingest_clock_skew_ms",
            "Estimated per-node clock offset vs the coordinator host",
            ["node"],
            registry=self.registry,
        )
        self.ingest_watermark_lag_ms = Gauge(
            "llm_slo_agent_ingest_watermark_lag_ms",
            "Lag of the most recent event behind the stream head",
            registry=self.registry,
        )
        # ---- crash-safe runtime series (tpuslo.runtime) --------------
        self.runtime_snapshot_age_seconds = Gauge(
            "llm_slo_agent_runtime_snapshot_age_seconds",
            "Seconds since the last durable state snapshot was written",
            registry=self.registry,
        )
        self.runtime_snapshot_bytes = Gauge(
            "llm_slo_agent_runtime_snapshot_bytes",
            "Size of the last durable state snapshot",
            registry=self.registry,
        )
        self.runtime_snapshot_saves = Counter(
            "llm_slo_agent_runtime_snapshot_saves_total",
            "Durable state snapshot writes, by outcome",
            ["outcome"],
            registry=self.registry,
        )
        self.runtime_snapshot_restores = Counter(
            "llm_slo_agent_runtime_snapshot_restores_total",
            "Startup snapshot restore attempts, by outcome "
            "(restored/cold/stale/corrupt/version/forced_cold)",
            ["outcome"],
            registry=self.registry,
        )
        self.runtime_probe_restarts = Counter(
            "llm_slo_agent_runtime_probe_restarts_total",
            "Dead probes restarted by the supervisor",
            ["signal"],
            registry=self.registry,
        )
        self.runtime_flap_sheds = Counter(
            "llm_slo_agent_runtime_flap_sheds_total",
            "Signals shed by the supervisor for restart flapping",
            ["signal"],
            registry=self.registry,
        )
        self.runtime_drains = Counter(
            "llm_slo_agent_runtime_drains_total",
            "Graceful drain sequences, by outcome "
            "(clean/deadline_exceeded/step_error)",
            ["outcome"],
            registry=self.registry,
        )
        self.runtime_drain_duration_seconds = Gauge(
            "llm_slo_agent_runtime_drain_duration_seconds",
            "Wall time of the last graceful drain sequence",
            registry=self.registry,
        )
        # ---- error-budget / burn-rate series (tpuslo.sloengine) ------
        self.slo_request_outcomes = Counter(
            "llm_slo_agent_slo_request_outcomes_total",
            "Request outcomes folded into the burn engine's SLI stream",
            ["tenant", "status"],
            registry=self.registry,
        )
        self.slo_budget_remaining = Gauge(
            "llm_slo_agent_slo_budget_remaining",
            "Fraction of the error budget left over the budget window, "
            "per tenant and objective (availability/ttft/tpot)",
            ["tenant", "objective"],
            registry=self.registry,
        )
        self.slo_burn_rate = Gauge(
            "llm_slo_agent_slo_burn_rate",
            "Error-budget burn rate per sliding window "
            "(1.0 = spending exactly the whole budget over the window)",
            ["tenant", "objective", "window"],
            registry=self.registry,
        )
        self.slo_alert_state = Gauge(
            "llm_slo_agent_slo_alert_state",
            "Burn alert state per tenant/objective "
            "(0=ok 1=slow_burn 2=fast_burn)",
            ["tenant", "objective"],
            registry=self.registry,
        )
        self.slo_alert_transitions = Counter(
            "llm_slo_agent_slo_alert_transitions_total",
            "Burn alert state transitions by severity "
            "(page/ticket/resolve) — one per sustained burn, not one "
            "per evaluation cycle",
            ["tenant", "objective", "severity"],
            registry=self.registry,
        )
        # ---- fleet observability plane (tpuslo.fleet) ----------------
        self.fleet_ingested_events = Counter(
            "llm_slo_fleet_ingested_events_total",
            "Columnar probe events ingested by an aggregator shard "
            "(decode -> merge -> gate path), per shard",
            ["shard"],
            registry=self.registry,
        )
        self.fleet_rollup_latency_ms = Histogram(
            "llm_slo_fleet_rollup_latency_ms",
            "Latency of one fleet rollup pass (window close + "
            "attribution + cross-node collapse)",
            buckets=(1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000, 2500),
            registry=self.registry,
        )
        self.fleet_incidents_open = Gauge(
            "llm_slo_fleet_incidents_open",
            "Fleet incidents currently open, by blast radius "
            "(pod/node/slice/fleet)",
            ["blast_radius"],
            registry=self.registry,
        )
        self.fleet_nodes_reporting = Gauge(
            "llm_slo_fleet_nodes_reporting",
            "Nodes whose stream head is within the staleness bound "
            "of the fleet head",
            registry=self.registry,
        )
        self.fleet_nodes_stale = Gauge(
            "llm_slo_fleet_nodes_stale",
            "Nodes aged out of the watermark min (stopped shipping)",
            registry=self.registry,
        )
        self.fleet_ring_rebalances = Counter(
            "llm_slo_fleet_ring_rebalances_total",
            "Hash-ring membership changes (shard added or removed; "
            "each re-homes only the changed shard's arcs)",
            registry=self.registry,
        )
        # ---- federation plane (tpuslo.federation) --------------------
        self.federation_region_ingested = Counter(
            "llm_slo_fleet_federation_region_ingested_incidents_total",
            "Node incidents ingested by the region aggregator, per "
            "source cluster (the cluster->region envelope hop)",
            ["cluster"],
            registry=self.registry,
        )
        self.federation_backpressure_level = Gauge(
            "llm_slo_fleet_federation_backpressure_level",
            "Current ingest-degradation level per aggregator "
            "(0 none, 1 coarse batches, 2 sample low-severity, "
            "3 aggressive sampling)",
            ["source"],
            registry=self.registry,
        )
        self.federation_sampled_rows = Counter(
            "llm_slo_fleet_federation_sampled_rows_total",
            "Low-severity rows sampled out under backpressure, by "
            "the degradation level that dropped them (gated fault "
            "evidence is structurally never sampled)",
            ["level"],
            registry=self.registry,
        )
        self.federation_churn_rebalances = Counter(
            "llm_slo_fleet_federation_churn_rebalances_total",
            "Online ring rebalances under churn, by kind "
            "(shard_join/shard_leave); each re-homes only the moved "
            "arcs with in-flight window handoff",
            ["kind"],
            registry=self.registry,
        )
        self.federation_incident_staleness_ms = Histogram(
            "llm_slo_fleet_federation_incident_staleness_ms",
            "How far the region head had advanced past an emitted "
            "incident's window end — the resolution cost of "
            "saturation-induced coarsening/sampling",
            buckets=(
                100, 250, 500, 1000, 2500, 5000, 10000, 20000,
                30000, 60000,
            ),
            registry=self.registry,
        )
        # ---- global tier (tpuslo.federation.global_tier) -------------
        self.global_region_ingested = Counter(
            "llm_slo_global_region_ingested_incidents_total",
            "Fleet pages ingested by the global tier, per source "
            "region (the region->global envelope hop)",
            ["region"],
            registry=self.registry,
        )
        self.global_pages = Counter(
            "llm_slo_global_pages_total",
            "Global incidents emitted, by scope (single_region / "
            "multi_region / partition_scoped — the last means some "
            "region was unreachable and a peer may hold the rest)",
            ["scope"],
            registry=self.registry,
        )
        self.global_duplicates_suppressed = Counter(
            "llm_slo_global_duplicates_suppressed_total",
            "Duplicates the global tier absorbed, by reason "
            "(seq_replay: WAN replay of an already-accepted "
            "envelope; emitted_window: a healed peer already paged "
            "this session window)",
            ["reason"],
            registry=self.registry,
        )
        self.global_region_reachable = Gauge(
            "llm_slo_global_region_reachable",
            "1 while the region's stream head is within the "
            "staleness bound of the fleet head, 0 once it has aged "
            "out (partitioned or dark)",
            ["region"],
            registry=self.registry,
        )
        # ---- global peer mesh (symmetric root) -------------------------
        self.global_peer_epoch = Gauge(
            "llm_slo_global_peer_epoch",
            "This peer's election epoch — the fence every emitted "
            "page carries; a deposed root's pages at a lower epoch "
            "are rejected mesh-wide",
            ["peer"],
            registry=self.registry,
        )
        self.global_peer_elections = Counter(
            "llm_slo_global_peer_elections_total",
            "Leadership takes by this peer (bully by stable rank "
            "over gossiped liveness; each take bumps the epoch past "
            "everything seen)",
            ["peer"],
            registry=self.registry,
        )
        self.global_peer_gossip_rounds = Counter(
            "llm_slo_global_peer_gossip_rounds_total",
            "Anti-entropy gossip rounds this peer initiated (one per "
            "round, not per remote peer)",
            ["peer"],
            registry=self.registry,
        )
        self.global_peer_reachable = Gauge(
            "llm_slo_global_peer_reachable",
            "1 while the remote mesh peer was heard (directly or "
            "transitively) within the peer staleness bound, 0 once "
            "it has aged out — the liveness the bully rule elects on",
            ["peer"],
            registry=self.registry,
        )
        # ---- auto-remediation series (tpuslo.remediation) ------------
        self.remediation_actions_applied = Counter(
            "llm_slo_agent_remediation_actions_applied_total",
            "Remediation actions applied, by action kind "
            "(probe_shed/breaker_trip/drain_snapshot/cordon_node/"
            "rehome_slice/demote_tenant)",
            ["action"],
            registry=self.registry,
        )
        self.remediation_actions_rolled_back = Counter(
            "llm_slo_agent_remediation_actions_rolled_back_total",
            "Remediation actions rolled back (verify failed or apply "
            "was interrupted by a restart), by action kind",
            ["action"],
            registry=self.registry,
        )
        self.remediation_verify_outcomes = Counter(
            "llm_slo_agent_remediation_verify_outcomes_total",
            "Verify-or-rollback verdicts (confirmed/rollback)",
            ["outcome"],
            registry=self.registry,
        )
        self.remediation_actions_in_flight = Gauge(
            "llm_slo_agent_remediation_actions_in_flight",
            "Remediation actions currently applying or verifying "
            "(bounded by the global concurrent-actions budget)",
            registry=self.registry,
        )
        self.remediation_refusals = Counter(
            "llm_slo_agent_remediation_refusals_total",
            "Attributions the policy declined to act on, by reason "
            "(no_rule/low_confidence/not_burning/cooldown/"
            "rate_limited/budget/no_target/disabled) — the precision "
            "evidence",
            ["reason"],
            registry=self.registry,
        )
        # ---- self-observability series (tpuslo.obs) ------------------
        self.cycle_stage_ms = Histogram(
            "llm_slo_agent_cycle_stage_ms",
            "Per-stage latency of the agent's own pipeline cycle "
            "(generate/ingest_gate/validate/correlate/attribute/"
            "deliver/snapshot); exemplars carry the cycle trace_id",
            ["stage"],
            buckets=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100, 250),
            registry=self.registry,
        )
        self.cycle_ms = Histogram(
            "llm_slo_agent_cycle_ms",
            "End-to-end latency of one agent emit cycle",
            buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000),
            registry=self.registry,
        )
        self.trace_cycles = Counter(
            "llm_slo_agent_trace_cycles_total",
            "Self-traced cycles by tail-sampling verdict "
            "(kept_slow/kept_error/kept_probabilistic/dropped)",
            ["verdict"],
            registry=self.registry,
        )
        self.trace_spans_exported = Counter(
            "llm_slo_agent_trace_spans_exported_total",
            "Self-tracing spans handed to the export path",
            registry=self.registry,
        )
        self.trace_overhead_pct = Gauge(
            "llm_slo_agent_trace_overhead_pct",
            "Measured self-tracing overhead as percent of cycle time "
            "(EMA; the tracer degrades to metrics-only past its budget)",
            registry=self.registry,
        )
        # ---- device-plane ledger series (tpuslo.deviceplane) ----------
        self.deviceplane_device_time_ms = Counter(
            "llm_slo_deviceplane_device_time_ms_total",
            "Device time folded by the per-launch ledger, by bucket "
            "(joined/helper/compile/idle_gap/unexplained) — the five "
            "buckets sum to total observed device time",
            ["bucket"],
            registry=self.registry,
        )
        self.deviceplane_launches = Counter(
            "llm_slo_deviceplane_launches_total",
            "Module launches attributed by the ledger, by join tier "
            "(identity/lane_window/compile_event/frame)",
            ["tier"],
            registry=self.registry,
        )
        self.deviceplane_join_rate = Gauge(
            "llm_slo_deviceplane_join_rate",
            "Launch->signal join rate from the last ledger fold, by "
            "kind (raw = exact identity over ALL launches, reported "
            "only; substantive = tiered rate over ops-bearing "
            "launches, gated >= 0.9)",
            ["kind"],
            registry=self.registry,
        )
        self.deviceplane_unexplained_share = Gauge(
            "llm_slo_deviceplane_unexplained_share",
            "Share of device time the ledger could not attribute "
            "(gated <= 0.1 on the synthetic lane)",
            registry=self.registry,
        )
        self.deviceplane_dispatch_device_wait_ms = Histogram(
            "llm_slo_deviceplane_dispatch_device_wait_ms",
            "Per-dispatch device-busy proxy from the serving front "
            "door (fused-read wait time)",
            buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500),
            registry=self.registry,
        )
        self.deviceplane_roofline_verdicts = Counter(
            "llm_slo_deviceplane_roofline_verdicts_total",
            "Roofline verdicts attached to serving-path attributions, "
            "by verdict (memory_bound/compute_bound)",
            ["verdict"],
            registry=self.registry,
        )
        # ---- continuous profiler (tpuslo.deviceplane.profiler) --------
        self.profiler_windows = Counter(
            "llm_slo_profiler_windows_total",
            "Profiler capture windows folded through the ledger, by "
            "kind (captured = every window; forced = taken mid-stride "
            "on an eviction notice; eviction = windows carrying at "
            "least one eviction event)",
            ["kind"],
            registry=self.registry,
        )
        self.profiler_capture_overhead_pct = Gauge(
            "llm_slo_profiler_capture_overhead_pct",
            "Measured capture+parse+fold cost as percent of the cycle "
            "budget, amortized over the stride (EMA; the governor "
            "degrades to a longer stride past its budget)",
            registry=self.registry,
        )
        self.profiler_governor_transitions = Counter(
            "llm_slo_profiler_governor_transitions_total",
            "Overhead-governor state changes, by transition (degraded "
            "= stride lengthened past the overhead budget; reengaged "
            "= base stride restored on sustained headroom)",
            ["transition"],
            registry=self.registry,
        )
        self.profiler_stride_cycles = Gauge(
            "llm_slo_profiler_stride_cycles",
            "Current capture stride in agent cycles (base when "
            "healthy, doubled per degradation up to the cap)",
            registry=self.registry,
        )
        self.profiler_idle_gap_ms = Histogram(
            "llm_slo_profiler_idle_gap_ms",
            "Per-window device idle gap from the profiler's ledger "
            "fold (preemptions surface here as outlier windows)",
            buckets=(0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500, 1000),
            registry=self.registry,
        )
        self.profiler_window_mfu_pct = Gauge(
            "llm_slo_profiler_window_mfu_pct",
            "Roofline MFU of the most recent capture window (-1 when "
            "the window carried no cost model)",
            registry=self.registry,
        )
        self.profiler_window_unexplained_share = Gauge(
            "llm_slo_profiler_window_unexplained_share",
            "Unexplained device-time share of the most recent capture "
            "window (same fold the device_unexplained_share probe "
            "signal is emitted from)",
            registry=self.registry,
        )
        # ---- serving front door (tpuslo.models.frontdoor) -------------
        # The engine's admission counters were internal-only (stats()
        # dicts); these export them live through the FrontDoorObserver
        # hooks so shed/preempt pressure shows up on the error-budget
        # board next to the burn it causes.
        self.frontdoor_admitted = Counter(
            "llm_slo_frontdoor_admitted_total",
            "Requests admitted into front-door decode slots, by "
            "engine and tenant",
            ["engine", "tenant"],
            registry=self.registry,
        )
        self.frontdoor_shed = Counter(
            "llm_slo_frontdoor_shed_total",
            "Requests refused by SLO-aware admission, by engine, "
            "tenant and reason "
            "(queue_full/displaced/queue_full_burning)",
            ["engine", "tenant", "reason"],
            registry=self.registry,
        )
        self.frontdoor_preemptions = Counter(
            "llm_slo_frontdoor_preemptions_total",
            "Running slots parked to make room for higher-priority "
            "work, by engine and tenant",
            ["engine", "tenant"],
            registry=self.registry,
        )
        self.frontdoor_resumes = Counter(
            "llm_slo_frontdoor_resumes_total",
            "Parked/teacher-forced streams resumed into a slot, by "
            "engine and tenant",
            ["engine", "tenant"],
            registry=self.registry,
        )
        self.frontdoor_completed_tokens = Counter(
            "llm_slo_frontdoor_completed_tokens_total",
            "Tokens emitted by completed front-door requests, by "
            "engine and tenant",
            ["engine", "tenant"],
            registry=self.registry,
        )

        # ---- live deployment plane (tpuslo.livenet) --------------------
        # The socket transport's health surface: a partition shows up
        # here first — connected_peers drops, reconnects and spool
        # replays climb on heal (docs/runbooks/live-deployment.md).
        self.livenet_connected_peers = Gauge(
            "llm_slo_livenet_connected_peers",
            "Open peer connections on a live listener, by listener",
            ["listener"],
            registry=self.registry,
        )
        self.livenet_reconnects = Counter(
            "llm_slo_livenet_reconnects_total",
            "Upstream socket reconnections by a sending client, "
            "by peer",
            ["peer"],
            registry=self.registry,
        )
        self.livenet_spool_replayed = Counter(
            "llm_slo_livenet_spool_replayed_frames_total",
            "Spooled frames redelivered upstream after an outage, "
            "by peer",
            ["peer"],
            registry=self.registry,
        )
        self.livenet_pressure_level = Gauge(
            "llm_slo_livenet_upstream_pressure_level",
            "Latest ack-carried upstream pressure level (0-3) seen "
            "by a sending client, by peer",
            ["peer"],
            registry=self.registry,
        )
        self.livenet_frames_rejected = Counter(
            "llm_slo_livenet_frames_rejected_total",
            "Inbound frames refused by a live listener, by listener "
            "and reason (framing/contract)",
            ["listener", "reason"],
            registry=self.registry,
        )

    def set_enabled_signals(self, enabled: list[str]) -> None:
        enabled_set = set(enabled)
        for signal in ALL_SIGNALS:
            self.signal_enabled.labels(signal=signal).set(
                1.0 if signal in enabled_set else 0.0
            )

    def observe_probe(self, signal: str, value: float) -> None:
        self.probe_events.labels(signal=signal).inc()
        if signal == "dns_latency_ms":
            self.dns_latency_ms.observe(value)
        if signal == "hbm_utilization_pct":
            self.hbm_utilization_pct.set(value)
        if signal == "ici_collective_latency_ms":
            self.ici_collective_ms.observe(value)
        if signal in TPU_SIGNALS:
            self.tpu_events.inc()

    def mark_cycle(self, duration_ms: float | None = None) -> None:
        """Heartbeat plus (when known) the cycle-duration observation —
        the stats line and dashboards read the same histogram, so the
        two can no longer drift apart."""
        self.heartbeat.set(time.time())
        if duration_ms is not None:
            self.cycle_ms.observe(duration_ms)

    def stage_quantiles(
        self, quantiles: tuple[float, ...] = (0.5, 0.99)
    ) -> dict[str, dict[str, float]]:
        """Per-stage latency quantiles estimated from the
        ``cycle_stage_ms`` histogram buckets (linear interpolation —
        the same estimate PromQL's histogram_quantile produces).

        Returns ``{stage: {"p50": ..., "p99": ..., "count": ...}}`` for
        stages with at least one observation.
        """
        # stage -> sorted [(le, cumulative_count)]
        buckets: dict[str, list[tuple[float, float]]] = {}
        for metric in self.cycle_stage_ms.collect():
            for sample in metric.samples:
                if not sample.name.endswith("_bucket"):
                    continue
                stage = sample.labels.get("stage", "")
                le = float(sample.labels.get("le", "inf").replace("+Inf", "inf"))
                buckets.setdefault(stage, []).append((le, sample.value))
        out: dict[str, dict[str, float]] = {}
        for stage, rows in buckets.items():
            rows.sort(key=lambda r: r[0])
            total = rows[-1][1] if rows else 0.0
            if total <= 0:
                continue
            est = {"count": total}
            for q in quantiles:
                rank = q * total
                lo_bound, lo_count = 0.0, 0.0
                value = rows[-1][0]
                for le, cum in rows:
                    if cum >= rank:
                        if le == float("inf"):
                            value = lo_bound
                        elif cum == lo_count:
                            value = le
                        else:
                            value = lo_bound + (le - lo_bound) * (
                                (rank - lo_count) / (cum - lo_count)
                            )
                        break
                    lo_bound, lo_count = le, cum
                est[f"p{int(q * 100)}"] = value
            out[stage] = est
        return out

    def delivery_observer(self, sink: str) -> "_PromDeliveryObserver":
        """Observer adapter wiring one DeliveryChannel to this registry
        (duck-typed against tpuslo.delivery.DeliveryObserver)."""
        return _PromDeliveryObserver(self, sink)

    def ingest_observer(self) -> "_PromIngestObserver":
        """Observer adapter wiring a TelemetryGate to this registry
        (duck-typed against tpuslo.ingest.GateObserver)."""
        return _PromIngestObserver(self)

    def runtime_observer(self) -> "_PromRuntimeObserver":
        """Observer adapter wiring the crash-safe runtime to this
        registry (duck-typed against tpuslo.runtime.RuntimeObserver)."""
        return _PromRuntimeObserver(self)

    def trace_observer(self) -> "_PromTraceObserver":
        """Observer adapter wiring a SelfTracer to this registry
        (duck-typed against tpuslo.obs.TraceObserver)."""
        return _PromTraceObserver(self)

    def slo_observer(self) -> "_PromSLOObserver":
        """Observer adapter wiring a BurnEngine to this registry
        (duck-typed against tpuslo.sloengine.SLOObserver)."""
        return _PromSLOObserver(self)

    def fleet_observer(self) -> "_PromFleetObserver":
        """Observer adapter wiring aggregator shards / the fleet
        simulator to this registry (duck-typed against
        tpuslo.fleet.FleetObserver)."""
        return _PromFleetObserver(self)

    def federation_observer(self) -> "_PromFederationObserver":
        """Observer adapter wiring the federation tree (region +
        cluster aggregators, backpressure loop, churn rebalancer) to
        this registry (duck-typed against
        tpuslo.federation.FederationObserver)."""
        return _PromFederationObserver(self)

    def global_observer(self) -> "_PromGlobalObserver":
        """Observer adapter wiring the global tier (gap-tolerant
        dedup, partition-aware emission) to this registry (duck-typed
        against tpuslo.federation.GlobalObserver)."""
        return _PromGlobalObserver(self)

    def remediation_observer(self) -> "_PromRemediationObserver":
        """Observer adapter wiring a RemediationEngine to this registry
        (duck-typed against tpuslo.remediation.RemediationObserver)."""
        return _PromRemediationObserver(self)

    def profiler_observer(self) -> "_PromProfilerObserver":
        """Observer for the continuous device profiler
        (``ContinuousProfiler(observer=...)``)."""
        return _PromProfilerObserver(self)

    def deviceplane_observer(self) -> "_PromDeviceplaneObserver":
        """Observer adapter wiring device-plane ledger folds, serving
        dispatches, and roofline attachments to this registry."""
        return _PromDeviceplaneObserver(self)

    def frontdoor_observer(self, engine: str = "0") -> "_PromFrontDoorObserver":
        """Observer adapter wiring ONE serving front door's admission
        lifecycle to this registry (duck-typed against
        tpuslo.models.frontdoor.FrontDoorObserver); ``engine`` labels
        the replica under an SLORouter fleet."""
        return _PromFrontDoorObserver(self, engine)

    def livenet_observer(self) -> "_PromLivenetObserver":
        """Observer adapter wiring live listeners and reconnecting
        clients to this registry (duck-typed against
        tpuslo.livenet.LivenetObserver)."""
        return _PromLivenetObserver(self)


_BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class _PromDeliveryObserver:
    """Per-sink bridge from delivery-channel callbacks to Prometheus."""

    def __init__(self, metrics: AgentMetrics, sink: str):
        self._m = metrics
        self._sink = sink
        # Touch the per-sink series so dashboards see explicit zeros.
        metrics.delivery_queue_depth.labels(sink=sink).set(0)
        metrics.delivery_spool_bytes.labels(sink=sink).set(0)
        metrics.delivery_breaker_state.labels(sink=sink).set(0)

    def queue_depth(self, depth: int) -> None:
        self._m.delivery_queue_depth.labels(sink=self._sink).set(depth)

    def spool_bytes(self, n: int) -> None:
        self._m.delivery_spool_bytes.labels(sink=self._sink).set(n)

    def breaker_state(self, state: str) -> None:
        self._m.delivery_breaker_state.labels(sink=self._sink).set(
            _BREAKER_STATE_VALUES.get(state, 2)
        )
        self._m.delivery_breaker_transitions.labels(
            sink=self._sink, state=state
        ).inc()

    def delivered(self, kind: str, events: int) -> None:
        self._m.delivery_delivered.labels(sink=self._sink).inc(events)

    def retried(self, events: int) -> None:
        self._m.delivery_retries.labels(sink=self._sink).inc()

    def spooled(self, kind: str, events: int) -> None:
        self._m.delivery_spooled.labels(sink=self._sink).inc(events)

    def replayed(self, events: int) -> None:
        self._m.delivery_replayed.labels(sink=self._sink).inc(events)

    def dead_lettered(self, kind: str, events: int, reason: str) -> None:
        self._m.delivery_dead_letters.labels(
            sink=self._sink, reason=reason
        ).inc(events)

    def truncated(self, batches: int) -> None:
        self._m.delivery_truncated.labels(sink=self._sink).inc(batches)


class _PromIngestObserver:
    """Bridge from telemetry-gate callbacks to Prometheus."""

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics
        # Touch the scalar series so dashboards see explicit zeros.
        metrics.ingest_watermark_lag_ms.set(0)

    def admitted(self) -> None:
        self._m.ingest_admitted.inc()

    def duplicate(self) -> None:
        self._m.ingest_duplicates.inc()

    def quarantined(self, reason: str) -> None:
        self._m.ingest_quarantined.labels(reason=reason).inc()

    def late(self, lag_ns: int) -> None:
        self._m.ingest_late_admitted.inc()

    def skew_offsets(self, offsets_ms: dict[str, float]) -> None:
        for node, offset_ms in offsets_ms.items():
            self._m.ingest_clock_skew_ms.labels(node=node).set(offset_ms)

    def watermark_lag_ms(self, lag_ms: float) -> None:
        self._m.ingest_watermark_lag_ms.set(lag_ms)


class _PromRuntimeObserver:
    """Bridge from crash-safe runtime callbacks to Prometheus."""

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics
        metrics.runtime_snapshot_age_seconds.set(0)
        metrics.runtime_snapshot_bytes.set(0)

    def snapshot_saved(self, size_bytes: int) -> None:
        self._m.runtime_snapshot_saves.labels(outcome="ok").inc()
        self._m.runtime_snapshot_bytes.set(size_bytes)
        self._m.runtime_snapshot_age_seconds.set(0)

    def snapshot_save_failed(self) -> None:
        self._m.runtime_snapshot_saves.labels(outcome="error").inc()

    def snapshot_restored(self, outcome: str, age_s: float) -> None:
        self._m.runtime_snapshot_restores.labels(outcome=outcome).inc()

    def probe_restarted(self, signal: str) -> None:
        self._m.runtime_probe_restarts.labels(signal=signal).inc()

    def flap_shed(self, signal: str) -> None:
        self._m.runtime_flap_sheds.labels(signal=signal).inc()

    def drain(self, outcome: str, duration_s: float) -> None:
        self._m.runtime_drains.labels(outcome=outcome).inc()
        self._m.runtime_drain_duration_seconds.set(duration_s)


class _PromFleetObserver:
    """Bridge from fleet-plane callbacks to Prometheus.

    Per-shard counter children are cached: the aggregator calls
    ``ingested`` once per merged drain (tens of thousands of events),
    so a ``labels()`` dict lookup per call would be pure waste.
    """

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics
        self._ingest_children: dict[str, object] = {}
        metrics.fleet_nodes_reporting.set(0)
        metrics.fleet_nodes_stale.set(0)
        for radius in ("pod", "node", "slice", "fleet"):
            metrics.fleet_incidents_open.labels(blast_radius=radius).set(0)

    def ingested(self, shard: str, events: int) -> None:
        child = self._ingest_children.get(shard)
        if child is None:
            child = self._m.fleet_ingested_events.labels(shard=shard)
            self._ingest_children[shard] = child
        child.inc(events)

    def rollup_latency_ms(self, ms: float) -> None:
        self._m.fleet_rollup_latency_ms.observe(ms)

    def incidents_open(self, blast_radius: str, count: int) -> None:
        self._m.fleet_incidents_open.labels(
            blast_radius=blast_radius
        ).set(count)

    def nodes(self, reporting: int, stale: int) -> None:
        self._m.fleet_nodes_reporting.set(reporting)
        self._m.fleet_nodes_stale.set(stale)

    def rebalance(self) -> None:
        self._m.fleet_ring_rebalances.inc()


class _PromFederationObserver:
    """Bridge from federation-tree callbacks to Prometheus.

    Per-cluster counter children are cached like the fleet observer's:
    region ingest fires once per envelope, sampling once per degraded
    batch — a ``labels()`` dict lookup per call is avoidable waste.
    """

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics
        self._ingest_children: dict[str, object] = {}
        self._sampled_children: dict[int, object] = {}

    def region_ingested(self, cluster: str, incidents: int) -> None:
        child = self._ingest_children.get(cluster)
        if child is None:
            child = self._m.federation_region_ingested.labels(
                cluster=cluster
            )
            self._ingest_children[cluster] = child
        child.inc(incidents)

    def backpressure_level(self, source: str, level: int) -> None:
        self._m.federation_backpressure_level.labels(
            source=source
        ).set(level)

    def sampled_rows(self, level: int, rows: int) -> None:
        child = self._sampled_children.get(level)
        if child is None:
            child = self._m.federation_sampled_rows.labels(
                level=str(level)
            )
            self._sampled_children[level] = child
        child.inc(rows)

    def churn_rebalance(self, kind: str, moved: int) -> None:
        self._m.federation_churn_rebalances.labels(kind=kind).inc()

    def incident_staleness_ms(self, ms: float) -> None:
        self._m.federation_incident_staleness_ms.observe(ms)


class _PromGlobalObserver:
    """Bridge from global-tier callbacks to Prometheus.

    Per-region children are cached like the federation observer's;
    ``region_reachable`` fires for every region on every watermark
    read, so the gauge child lookup is the hot one.
    """

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics
        self._ingest_children: dict[str, object] = {}
        self._reachable_children: dict[str, object] = {}
        self._peer_reach_children: dict[str, object] = {}

    def global_ingested(self, region: str, incidents: int) -> None:
        child = self._ingest_children.get(region)
        if child is None:
            child = self._m.global_region_ingested.labels(
                region=region
            )
            self._ingest_children[region] = child
        child.inc(incidents)

    def global_page(self, scope: str) -> None:
        self._m.global_pages.labels(scope=scope).inc()

    def global_duplicate(self, reason: str) -> None:
        self._m.global_duplicates_suppressed.labels(
            reason=reason
        ).inc()

    def region_reachable(self, region: str, reachable: int) -> None:
        child = self._reachable_children.get(region)
        if child is None:
            child = self._m.global_region_reachable.labels(
                region=region
            )
            self._reachable_children[region] = child
        child.set(reachable)

    # ---- peer mesh (symmetric root) --------------------------------

    def peer_epoch(self, peer: str, epoch: int) -> None:
        self._m.global_peer_epoch.labels(peer=peer).set(epoch)

    def peer_election(self, peer: str) -> None:
        self._m.global_peer_elections.labels(peer=peer).inc()

    def peer_gossip_round(self, peer: str) -> None:
        self._m.global_peer_gossip_rounds.labels(peer=peer).inc()

    def peer_reachable(self, peer: str, reachable: int) -> None:
        child = self._peer_reach_children.get(peer)
        if child is None:
            child = self._m.global_peer_reachable.labels(peer=peer)
            self._peer_reach_children[peer] = child
        child.set(reachable)


class _PromTraceObserver:
    """Bridge from self-tracer callbacks to Prometheus.

    One batched callback per cycle: histogram children are cached (a
    ``labels()`` lookup costs microseconds) and exemplars — which cost
    another few microseconds per observation — are attached only for
    cycles the tail sampler kept, i.e. exactly the ones whose trace_id
    actually resolves to an exported trace.  Dropped cycles still feed
    every histogram, so p50/p99 stay unbiased at any sample rate.
    """

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics
        self._children: dict[str, object] = {}
        metrics.trace_overhead_pct.set(0)

    @staticmethod
    def _observe(histogram, ms: float, trace_id: str) -> None:
        try:
            histogram.observe(ms, exemplar={"trace_id": trace_id})
        except (TypeError, ValueError):
            # Exemplar-less prometheus_client, or an exemplar the
            # client rejects: the observation must still land.
            histogram.observe(ms)

    def _stage_child(self, stage: str):
        child = self._children.get(stage)
        if child is None:
            child = self._m.cycle_stage_ms.labels(stage=stage)
            self._children[stage] = child
        return child

    def cycle_complete(
        self, root, stage_spans, verdict: str, observe_stages: bool = True
    ) -> None:
        kept = verdict != "dropped"
        trace_id = root.trace_id
        if observe_stages:
            for span in stage_spans:
                child = self._stage_child(span.name)
                if kept:
                    self._observe(child, span.duration_ms, trace_id)
                else:
                    child.observe(span.duration_ms)
            if kept:
                self._observe(
                    self._m.cycle_ms, root.duration_ms, trace_id
                )
            else:
                self._m.cycle_ms.observe(root.duration_ms)
        counter = self._children.get(verdict)
        if counter is None:
            counter = self._m.trace_cycles.labels(verdict=verdict)
            self._children[verdict] = counter
        counter.inc()

    def spans_exported(self, count: int) -> None:
        # Fired by the tracer only when a batch actually reached the
        # export callback: a kept-but-exporterless cycle must not show
        # a healthy span-export rate on the dashboard.
        self._m.trace_spans_exported.inc(count)

    def overhead_pct(self, pct: float) -> None:
        self._m.trace_overhead_pct.set(pct)


class _PromSLOObserver:
    """Bridge from burn-engine callbacks to Prometheus.

    ``outcome`` runs once per request on the engine's record path, so
    its labelled child is cached — a ``labels()`` lookup per request
    is the kind of cost the TPL120 manifest exists to keep out.
    """

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics
        self._outcome_children: dict[tuple[str, str], object] = {}

    def outcome(self, tenant: str, status: str) -> None:
        key = (tenant, status)
        child = self._outcome_children.get(key)
        if child is None:
            child = self._m.slo_request_outcomes.labels(
                tenant=tenant, status=status
            )
            self._outcome_children[key] = child
        child.inc()

    def burn_rate(
        self, tenant: str, objective: str, window: str, rate: float
    ) -> None:
        self._m.slo_burn_rate.labels(
            tenant=tenant, objective=objective, window=window
        ).set(rate)

    def budget_remaining(
        self, tenant: str, objective: str, remaining: float
    ) -> None:
        self._m.slo_budget_remaining.labels(
            tenant=tenant, objective=objective
        ).set(remaining)

    def alert_state(
        self, tenant: str, objective: str, level: int
    ) -> None:
        self._m.slo_alert_state.labels(
            tenant=tenant, objective=objective
        ).set(level)

    def transition(
        self, tenant: str, objective: str, severity: str
    ) -> None:
        self._m.slo_alert_transitions.labels(
            tenant=tenant, objective=objective, severity=severity
        ).inc()


class _PromRemediationObserver:
    """Bridge from remediation-engine callbacks to Prometheus."""

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics

    def applied(self, action: str) -> None:
        self._m.remediation_actions_applied.labels(action=action).inc()

    def rolled_back(self, action: str) -> None:
        self._m.remediation_actions_rolled_back.labels(
            action=action
        ).inc()

    def verify_outcome(self, outcome: str) -> None:
        self._m.remediation_verify_outcomes.labels(
            outcome=outcome
        ).inc()

    def in_flight(self, count: int) -> None:
        self._m.remediation_actions_in_flight.set(count)

    def refused(self, reason: str) -> None:
        self._m.remediation_refusals.labels(reason=reason).inc()


class _PromDeviceplaneObserver:
    """Bridge from device-plane ledger folds to Prometheus."""

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics

    def ledger_folded(self, ledger) -> None:
        """Publish one :class:`tpuslo.deviceplane.DeviceLedger` fold."""
        for bucket, us in ledger.buckets_us.items():
            self._m.deviceplane_device_time_ms.labels(bucket=bucket).inc(
                us / 1000.0
            )
        for tier, count in ledger.tier_counts.items():
            self._m.deviceplane_launches.labels(tier=tier).inc(count)
        self._m.deviceplane_join_rate.labels(kind="raw").set(
            ledger.raw_join_rate
        )
        self._m.deviceplane_join_rate.labels(kind="substantive").set(
            ledger.substantive_join_rate
        )
        self._m.deviceplane_unexplained_share.set(
            ledger.unexplained_share
        )

    def dispatch_observed(self, device_wait_ms: float) -> None:
        self._m.deviceplane_dispatch_device_wait_ms.observe(
            device_wait_ms
        )

    def roofline_attached(self, verdict: str) -> None:
        self._m.deviceplane_roofline_verdicts.labels(
            verdict=verdict
        ).inc()


class _PromProfilerObserver:
    """Bridge from continuous-profiler callbacks to Prometheus
    (the profiler observer contract: window/degraded/reengaged)."""

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics

    def window(self, window, ema_pct: float) -> None:
        """Publish one :class:`ProfilerWindow` fold plus the
        governor's current overhead EMA."""
        self._m.profiler_windows.labels(kind="captured").inc()
        if window.forced:
            self._m.profiler_windows.labels(kind="forced").inc()
        if window.eviction_events > 0:
            self._m.profiler_windows.labels(kind="eviction").inc()
        self._m.profiler_capture_overhead_pct.set(ema_pct)
        self._m.profiler_stride_cycles.set(window.stride_cycles)
        self._m.profiler_idle_gap_ms.observe(window.idle_gap_ms)
        self._m.profiler_window_mfu_pct.set(window.mfu_pct)
        self._m.profiler_window_unexplained_share.set(
            window.unexplained_share
        )

    def degraded(self, stride: int) -> None:
        self._m.profiler_governor_transitions.labels(
            transition="degraded"
        ).inc()
        self._m.profiler_stride_cycles.set(stride)

    def reengaged(self, stride: int) -> None:
        self._m.profiler_governor_transitions.labels(
            transition="reengaged"
        ).inc()
        self._m.profiler_stride_cycles.set(stride)


class _PromFrontDoorObserver:
    """Per-engine bridge from front-door admission callbacks to
    Prometheus (the FrontDoorObserver contract: admitted/shed/
    preempted/resumed/completed)."""

    def __init__(self, metrics: AgentMetrics, engine: str):
        self._m = metrics
        self._engine = str(engine)

    def admitted(self, tenant: str) -> None:
        self._m.frontdoor_admitted.labels(
            engine=self._engine, tenant=tenant
        ).inc()

    def shed(self, tenant: str, reason: str) -> None:
        self._m.frontdoor_shed.labels(
            engine=self._engine, tenant=tenant, reason=reason
        ).inc()

    def preempted(self, tenant: str) -> None:
        self._m.frontdoor_preemptions.labels(
            engine=self._engine, tenant=tenant
        ).inc()

    def resumed(self, tenant: str) -> None:
        self._m.frontdoor_resumes.labels(
            engine=self._engine, tenant=tenant
        ).inc()

    def completed(self, tenant: str, tokens: int) -> None:
        self._m.frontdoor_completed_tokens.labels(
            engine=self._engine, tenant=tenant
        ).inc(tokens)


class _PromLivenetObserver:
    """Bridge from livenet listener/client callbacks to Prometheus
    (the LivenetObserver contract: peers/frame_rejected/reconnected/
    spool_replayed/pressure_level)."""

    def __init__(self, metrics: AgentMetrics):
        self._m = metrics

    def peers(self, listener: str, connected: int) -> None:
        self._m.livenet_connected_peers.labels(
            listener=listener
        ).set(connected)

    def frame_rejected(self, listener: str, reason: str) -> None:
        self._m.livenet_frames_rejected.labels(
            listener=listener, reason=reason
        ).inc()

    def reconnected(self, peer: str) -> None:
        self._m.livenet_reconnects.labels(peer=peer).inc()

    def spool_replayed(self, peer: str, frames: int) -> None:
        self._m.livenet_spool_replayed.labels(peer=peer).inc(frames)

    def pressure_level(self, peer: str, level: int) -> None:
        self._m.livenet_pressure_level.labels(peer=peer).set(level)


class Readiness:
    """Aggregated readiness for ``/readyz``: every registered check must
    pass, and failures explain themselves in the response body.

    Checks are callables returning ``(ok, detail)``; a check that
    raises counts as not-ready with the exception as the detail (a
    broken check must fail loud, not report ready).
    """

    def __init__(self):
        self._checks: list[tuple[str, object]] = []
        self._lock = threading.Lock()

    def add_check(self, name: str, fn) -> None:
        with self._lock:
            self._checks.append((name, fn))

    def evaluate(self) -> tuple[bool, str]:
        reasons = []
        with self._lock:
            checks = list(self._checks)
        for name, fn in checks:
            try:
                ok, detail = fn()
            except Exception as exc:  # noqa: BLE001 — see class docstring
                ok, detail = False, f"check raised {exc!r}"
            if not ok:
                reasons.append(f"{name}: {detail}")
        if reasons:
            return False, "; ".join(reasons)
        return True, "ok"


def start_metrics_server(
    metrics: AgentMetrics,
    port: int,
    host: str = "0.0.0.0",
    readiness: Readiness | None = None,
) -> ThreadingHTTPServer:
    """Serve /metrics, /healthz, /readyz on a daemon thread.

    ``/healthz`` is liveness: 200 while the process serves requests.
    ``/readyz`` is readiness: with a :class:`Readiness` wired in it
    returns 503 + the failing reasons (drain in progress, all breakers
    open, stale snapshot) instead of the unconditional 200 a load
    balancer would happily route traffic at.
    """

    registry = metrics.registry

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/metrics"):
                body = generate_latest(registry)
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE_LATEST)
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/healthz":
                self._plain(200, "ok\n")
            elif self.path == "/readyz":
                if readiness is None:
                    self._plain(200, "ok\n")
                    return
                ready, reason = readiness.evaluate()
                self._plain(200 if ready else 503, reason + "\n")
            else:
                self.send_response(404)
                self.end_headers()

        def _plain(self, code: int, body: str) -> None:
            payload = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server
