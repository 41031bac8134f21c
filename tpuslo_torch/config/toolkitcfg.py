"""L12 config: YAML loader with zero-value→default normalization.

Reference: ``pkg/toolkitcfg/config.go:11-170``; extended with a ``tpu``
section for the accelerator probe surface.  CLI flags > config file >
defaults, with the precedence implemented by each binary.

The port's own copy of ``tpuslo/config/toolkitcfg.py``. The file is read by :mod:`tpuslo_torch.config.yamlsubset` (the card's machine has no PyYAML).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from tpuslo_torch.config.yamlsubset import safe_load
from tpuslo_torch.schema import SCHEMA_TOOLKIT_CONFIG, validate

API_VERSION = "toolkit.tpuslo.dev/v1alpha1"
KIND = "ToolkitConfig"

DEFAULT_SIGNAL_SET = [
    "dns_latency_ms",
    "tcp_retransmits_total",
    "runqueue_delay_ms",
    "connect_latency_ms",
    "tls_handshake_ms",
    "cpu_steal_pct",
    "mem_reclaim_latency_ms",
    "disk_io_latency_ms",
    "syscall_latency_ms",
    "xla_compile_ms",
    "hbm_alloc_stall_ms",
    "hbm_utilization_pct",
    "ici_link_retries_total",
    "ici_collective_latency_ms",
    "host_offload_stall_ms",
    "dcn_transfer_latency_ms",
    "device_idle_gap_ms",
    "device_eviction_events_total",
]


@dataclass
class SamplingConfig:
    events_per_second_limit: int = 10000
    burst_limit: int = 20000


@dataclass
class CorrelationConfig:
    window_ms: int = 2000
    enrichment_threshold: float = 0.7


@dataclass
class OTLPConfig:
    endpoint: str = "http://otel-collector:4318/v1/logs"


@dataclass
class SafetyConfig:
    max_overhead_pct: float = 3.0


@dataclass
class WebhookConfig:
    enabled: bool = False
    url: str = ""
    secret: str = ""
    format: str = "generic"
    timeout_ms: int = 5000


@dataclass
class CDGateConfig:
    enabled: bool = False
    prometheus_url: str = "http://prometheus:9090"
    ttft_p95_ms: float = 800.0
    error_rate: float = 0.05
    burn_rate: float = 2.0
    fail_open: bool = True


@dataclass
class DeliveryConfig:
    """Resilient-delivery knobs; ``spool_dir`` enables the subsystem."""

    spool_dir: str = ""
    queue_max: int = 512
    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    breaker_failure_threshold: int = 5
    breaker_open_duration_s: float = 10.0
    spool_max_bytes: int = 64 * 1024 * 1024
    spool_max_age_s: float = 24 * 3600.0
    restore_after_cycles: int = 30


@dataclass
class IngestConfig:
    """Telemetry ingest-gate knobs (``tpuslo.ingest.TelemetryGate``).

    ``enabled`` flips to True whenever an ``ingest:`` section is
    present in the config file — the gate is always-on once the
    operator has described it.  Like every other section, explicit
    zero/empty values fall back to these defaults (the reference
    ``normalize()`` convention) — there is no "0 means strict" knob.
    """

    enabled: bool = False
    dedup_window: int = 4096
    watermark_lateness_ms: int = 2000
    coordinator_host: int = 0
    min_skew_samples: int = 3
    skew_correction: bool = True
    quarantine_dir: str = ""
    quarantine_max_bytes: int = 8 * 1024 * 1024
    quarantine_max_age_s: float = 24 * 3600.0


@dataclass
class ObservabilityConfig:
    """Self-tracing knobs (``tpuslo.obs``).

    ``enabled`` flips to True whenever an ``observability:`` section is
    present in the config file (same presence-implies-on convention as
    ``ingest:``); an explicit ``enabled: false`` still wins.  The agent
    CLI's ``--trace`` flag overrides everything.
    """

    enabled: bool = False
    #: OTLP/HTTP traces endpoint; empty derives the sibling
    #: ``/v1/traces`` of the configured logs endpoint.
    trace_endpoint: str = ""
    #: Probability of keeping a fast, error-free cycle (tail sampling
    #: always keeps slow/error cycles).
    sample_rate: float = 0.05
    #: Cycle-duration budget (the p99 target): cycles at or past it are
    #: always sampled.
    slow_cycle_ms: float = 250.0
    #: Measured tracer-overhead budget as percent of cycle time; a
    #: sustained breach degrades tracing to metrics-only.
    max_overhead_pct: float = 5.0
    #: Incident provenance JSONL path (``sloctl explain`` reads it);
    #: empty falls back to ``<runtime.state_dir>/provenance.jsonl``.
    provenance_path: str = ""


@dataclass
class ProfilerConfig:
    """Continuous device profiler knobs
    (``tpuslo.deviceplane.profiler``).

    ``enabled`` flips to True whenever a ``profiler:`` section is
    present in the config file (presence-implies-on, like
    ``observability:``); an explicit ``enabled: false`` still wins.
    The agent CLI's ``--profile-device`` flag overrides everything.
    """

    enabled: bool = False
    #: Capture source: "synthetic" (seeded CI lane) or "xprof" (real
    #: ``jax.profiler`` capture; needs JAX and a workload to bracket).
    source: str = "synthetic"
    #: Capture every N agent cycles (the governor doubles this under
    #: overhead pressure, up to ``max_stride_cycles``).
    stride_cycles: int = 5
    max_stride_cycles: int = 40
    #: Serving steps per synthetic capture window.
    window_steps: int = 8
    #: Measured capture+parse budget as percent of the cycle budget,
    #: amortised over the stride.
    overhead_budget_pct: float = 3.0
    #: Assumed serving-loop cycle budget for the overhead accounting.
    cycle_budget_ms: float = 1000.0
    ema_alpha: float = 0.1
    grace_cycles: int = 3
    #: Recent windows kept for sloctl / the state snapshot.
    history: int = 32
    #: Profiler log dir for the xprof lane (trace files land here).
    log_dir: str = ""


@dataclass
class SLOConfig:
    """Error-budget / burn-rate engine knobs (``tpuslo.sloengine``).

    ``enabled`` flips to True whenever an ``slo:`` section is present
    in the config file (presence-implies-on, like ``ingest:``); an
    explicit ``enabled: false`` still wins.  Targets are the default
    per-tenant objectives; ``tenants`` holds per-tenant overrides
    (``tenant -> {availability_target, ttft_objective_ms, ...}``).
    """

    enabled: bool = False
    #: Ring-buffer bucket resolution for the sliding windows.
    bucket_s: int = 10
    #: Budget-ledger window (also the ring horizon); 6h demo-scale
    #: stand-in for the classic 30d period.
    budget_window_s: int = 21600
    availability_target: float = 0.99
    ttft_objective_ms: float = 800.0
    ttft_target: float = 0.95
    tpot_objective_ms: float = 120.0
    tpot_target: float = 0.95
    #: Multi-window thresholds: fast = 1h+5m page, slow = 6h+30m ticket.
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0
    #: Hysteresis: clearing needs burn < threshold * this ratio ...
    clear_hysteresis: float = 0.5
    #: ... for this many consecutive evaluations.
    clear_cycles: int = 6
    max_tenants: int = 64
    tenants: dict[str, dict[str, float]] = field(default_factory=dict)


@dataclass
class RemediationConfig:
    """Auto-remediation knobs (``tpuslo.remediation``).

    ``enabled`` flips to True whenever a ``remediation:`` section is
    present in the config file (presence-implies-on, like ``slo:``);
    an explicit ``enabled: false`` still wins.  The engine needs the
    burn engine (``slo:``) for its burn-state gate and verify
    evidence.  ``disabled_actions`` disables individual action kinds
    without turning the loop off.
    """

    enabled: bool = False
    #: Confidence floor an attribution must clear before any rule acts.
    min_confidence: float = 0.8
    #: Global concurrent-actions budget (a mis-attribution storm can
    #: hold at most this many levers at once).
    max_concurrent_actions: int = 2
    #: Per-(action, target) cooldown between applies.
    cooldown_s: float = 300.0
    #: Per-action-kind rate limit over ``rate_window_s``.
    rate_limit: int = 3
    rate_window_s: float = 3600.0
    #: Verify-or-rollback: evaluation-window budget, consecutive
    #: subsided windows to confirm, and the burn line that counts as
    #: subsided (default = the slow rule's clearing line).
    verify_windows: int = 6
    verify_streak: int = 2
    verify_subside_below: float = 3.0
    #: Action kinds to refuse (e.g. ["cordon_node"]) — per-action off
    #: switch without disabling the loop.
    disabled_actions: list[str] = field(default_factory=list)


@dataclass
class RuntimeConfig:
    """Crash-safe runtime knobs (``tpuslo.runtime``).

    ``state_dir`` enables the subsystem: durable snapshots, warm
    restore, and supervised drain all hang off it.  The drain handler
    and probe supervisor are always on — they need no disk.
    """

    state_dir: str = ""
    snapshot_interval_s: float = 5.0
    snapshot_max_age_s: float = 300.0
    drain_timeout_s: float = 10.0
    supervisor_heartbeat_timeout_s: float = 30.0
    supervisor_flap_restarts: int = 3
    supervisor_flap_window_s: float = 120.0
    supervisor_flap_holddown_s: float = 300.0


@dataclass
class TPUConfig:
    enabled: bool = True
    libtpu_path: str = ""
    accel_device_glob: str = "/dev/accel*"
    slice_id: str = ""
    host_index: int = 0


@dataclass
class ToolkitConfig:
    api_version: str = API_VERSION
    kind: str = KIND
    signal_set: list[str] = field(default_factory=lambda: list(DEFAULT_SIGNAL_SET))
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    correlation: CorrelationConfig = field(default_factory=CorrelationConfig)
    otlp: OTLPConfig = field(default_factory=OTLPConfig)
    safety: SafetyConfig = field(default_factory=SafetyConfig)
    webhook: WebhookConfig = field(default_factory=WebhookConfig)
    cdgate: CDGateConfig = field(default_factory=CDGateConfig)
    delivery: DeliveryConfig = field(default_factory=DeliveryConfig)
    ingest: IngestConfig = field(default_factory=IngestConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig
    )
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    slo: SLOConfig = field(default_factory=SLOConfig)
    remediation: RemediationConfig = field(
        default_factory=RemediationConfig
    )
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    tpu: TPUConfig = field(default_factory=TPUConfig)

    def to_dict(self) -> dict[str, Any]:
        return {
            "apiVersion": self.api_version,
            "kind": self.kind,
            "signal_set": list(self.signal_set),
            "sampling": {
                "events_per_second_limit": self.sampling.events_per_second_limit,
                "burst_limit": self.sampling.burst_limit,
            },
            "correlation": {
                "window_ms": self.correlation.window_ms,
                "enrichment_threshold": self.correlation.enrichment_threshold,
            },
            "otlp": {"endpoint": self.otlp.endpoint},
            "safety": {"max_overhead_pct": self.safety.max_overhead_pct},
            "webhook": {
                "enabled": self.webhook.enabled,
                "url": self.webhook.url,
                "secret": self.webhook.secret,
                "format": self.webhook.format,
                "timeout_ms": self.webhook.timeout_ms,
            },
            "cdgate": {
                "enabled": self.cdgate.enabled,
                "prometheus_url": self.cdgate.prometheus_url,
                "ttft_p95_ms": self.cdgate.ttft_p95_ms,
                "error_rate": self.cdgate.error_rate,
                "burn_rate": self.cdgate.burn_rate,
                "fail_open": self.cdgate.fail_open,
            },
            "delivery": {
                "spool_dir": self.delivery.spool_dir,
                "queue_max": self.delivery.queue_max,
                "max_attempts": self.delivery.max_attempts,
                "base_delay_s": self.delivery.base_delay_s,
                "max_delay_s": self.delivery.max_delay_s,
                "breaker_failure_threshold":
                    self.delivery.breaker_failure_threshold,
                "breaker_open_duration_s":
                    self.delivery.breaker_open_duration_s,
                "spool_max_bytes": self.delivery.spool_max_bytes,
                "spool_max_age_s": self.delivery.spool_max_age_s,
                "restore_after_cycles": self.delivery.restore_after_cycles,
            },
            "ingest": {
                "enabled": self.ingest.enabled,
                "dedup_window": self.ingest.dedup_window,
                "watermark_lateness_ms": self.ingest.watermark_lateness_ms,
                "coordinator_host": self.ingest.coordinator_host,
                "min_skew_samples": self.ingest.min_skew_samples,
                "skew_correction": self.ingest.skew_correction,
                "quarantine_dir": self.ingest.quarantine_dir,
                "quarantine_max_bytes": self.ingest.quarantine_max_bytes,
                "quarantine_max_age_s": self.ingest.quarantine_max_age_s,
            },
            "observability": {
                "enabled": self.observability.enabled,
                "trace_endpoint": self.observability.trace_endpoint,
                "sample_rate": self.observability.sample_rate,
                "slow_cycle_ms": self.observability.slow_cycle_ms,
                "max_overhead_pct": self.observability.max_overhead_pct,
                "provenance_path": self.observability.provenance_path,
            },
            "profiler": {
                "enabled": self.profiler.enabled,
                "source": self.profiler.source,
                "stride_cycles": self.profiler.stride_cycles,
                "max_stride_cycles": self.profiler.max_stride_cycles,
                "window_steps": self.profiler.window_steps,
                "overhead_budget_pct": self.profiler.overhead_budget_pct,
                "cycle_budget_ms": self.profiler.cycle_budget_ms,
                "ema_alpha": self.profiler.ema_alpha,
                "grace_cycles": self.profiler.grace_cycles,
                "history": self.profiler.history,
                "log_dir": self.profiler.log_dir,
            },
            "slo": {
                "enabled": self.slo.enabled,
                "bucket_s": self.slo.bucket_s,
                "budget_window_s": self.slo.budget_window_s,
                "availability_target": self.slo.availability_target,
                "ttft_objective_ms": self.slo.ttft_objective_ms,
                "ttft_target": self.slo.ttft_target,
                "tpot_objective_ms": self.slo.tpot_objective_ms,
                "tpot_target": self.slo.tpot_target,
                "fast_burn_threshold": self.slo.fast_burn_threshold,
                "slow_burn_threshold": self.slo.slow_burn_threshold,
                "clear_hysteresis": self.slo.clear_hysteresis,
                "clear_cycles": self.slo.clear_cycles,
                "max_tenants": self.slo.max_tenants,
                "tenants": {
                    tenant: dict(overrides)
                    for tenant, overrides in self.slo.tenants.items()
                },
            },
            "remediation": {
                "enabled": self.remediation.enabled,
                "min_confidence": self.remediation.min_confidence,
                "max_concurrent_actions":
                    self.remediation.max_concurrent_actions,
                "cooldown_s": self.remediation.cooldown_s,
                "rate_limit": self.remediation.rate_limit,
                "rate_window_s": self.remediation.rate_window_s,
                "verify_windows": self.remediation.verify_windows,
                "verify_streak": self.remediation.verify_streak,
                "verify_subside_below":
                    self.remediation.verify_subside_below,
                "disabled_actions": list(
                    self.remediation.disabled_actions
                ),
            },
            "runtime": {
                "state_dir": self.runtime.state_dir,
                "snapshot_interval_s": self.runtime.snapshot_interval_s,
                "snapshot_max_age_s": self.runtime.snapshot_max_age_s,
                "drain_timeout_s": self.runtime.drain_timeout_s,
                "supervisor_heartbeat_timeout_s":
                    self.runtime.supervisor_heartbeat_timeout_s,
                "supervisor_flap_restarts":
                    self.runtime.supervisor_flap_restarts,
                "supervisor_flap_window_s":
                    self.runtime.supervisor_flap_window_s,
                "supervisor_flap_holddown_s":
                    self.runtime.supervisor_flap_holddown_s,
            },
            "tpu": {
                "enabled": self.tpu.enabled,
                "libtpu_path": self.tpu.libtpu_path,
                "accel_device_glob": self.tpu.accel_device_glob,
                "slice_id": self.tpu.slice_id,
                "host_index": self.tpu.host_index,
            },
        }


def default_config() -> ToolkitConfig:
    return ToolkitConfig()


def _tenant_overrides(raw: Any) -> dict[str, dict[str, float]]:
    """Normalize the ``slo.tenants`` override map: tenant -> numeric
    partial targets.  A malformed block fails loud here — the contract
    validation only ever sees the normalized dict, so this caster is
    the type gate for raw operator input."""
    if not isinstance(raw, dict):
        raise ValueError("slo.tenants must be a mapping")
    out: dict[str, dict[str, float]] = {}
    for tenant, overrides in raw.items():
        if not isinstance(overrides, dict):
            raise ValueError(
                f"slo.tenants[{tenant!r}] must be a mapping of "
                "target overrides"
            )
        numeric: dict[str, float] = {}
        for key, value in overrides.items():
            if isinstance(value, bool) or not isinstance(
                value, (int, float)
            ):
                raise ValueError(
                    f"slo.tenants[{tenant!r}].{key} must be a number"
                )
            numeric[str(key)] = float(value)
        if numeric:
            out[str(tenant)] = numeric
    return out


def _action_kind_list(raw: Any) -> list[str]:
    """Normalize ``remediation.disabled_actions``: a list of known
    action-kind strings.  Unknown kinds fail loud — a typo here would
    silently leave an action armed the operator meant to disable."""
    from tpuslo_torch.remediation.actions import ALL_ACTION_KINDS

    if not isinstance(raw, list):
        raise ValueError("remediation.disabled_actions must be a list")
    out: list[str] = []
    for kind in raw:
        if str(kind) not in ALL_ACTION_KINDS:
            raise ValueError(
                f"remediation.disabled_actions: unknown action kind "
                f"{kind!r} (known: {', '.join(ALL_ACTION_KINDS)})"
            )
        out.append(str(kind))
    return out


def _merge_section(target, raw: dict[str, Any], fields: dict[str, type]) -> None:
    for name, caster in fields.items():
        value = raw.get(name)
        if value is None:
            continue
        # Zero/empty values fall back to defaults (reference normalize()).
        if caster is not bool and (value == "" or value == 0):
            continue
        setattr(target, name, caster(value))


def load_config(path: str) -> ToolkitConfig:
    """Parse and normalize a toolkit config file; validates the contract."""
    with open(path, encoding="utf-8") as f:
        raw = safe_load(f) or {}
    if not isinstance(raw, dict):
        raise ValueError(f"config {path} must be a mapping")

    cfg = default_config()
    if raw.get("apiVersion"):
        cfg.api_version = str(raw["apiVersion"])
    if raw.get("kind"):
        cfg.kind = str(raw["kind"])
    if raw.get("signal_set"):
        cfg.signal_set = [str(s) for s in raw["signal_set"]]

    _merge_section(
        cfg.sampling,
        raw.get("sampling") or {},
        {"events_per_second_limit": int, "burst_limit": int},
    )
    _merge_section(
        cfg.correlation,
        raw.get("correlation") or {},
        {"window_ms": int, "enrichment_threshold": float},
    )
    _merge_section(cfg.otlp, raw.get("otlp") or {}, {"endpoint": str})
    _merge_section(cfg.safety, raw.get("safety") or {}, {"max_overhead_pct": float})
    _merge_section(
        cfg.webhook,
        raw.get("webhook") or {},
        {
            "enabled": bool,
            "url": str,
            "secret": str,
            "format": str,
            "timeout_ms": int,
        },
    )
    _merge_section(
        cfg.cdgate,
        raw.get("cdgate") or {},
        {
            "enabled": bool,
            "prometheus_url": str,
            "ttft_p95_ms": float,
            "error_rate": float,
            "burn_rate": float,
            "fail_open": bool,
        },
    )
    _merge_section(
        cfg.delivery,
        raw.get("delivery") or {},
        {
            "spool_dir": str,
            "queue_max": int,
            "max_attempts": int,
            "base_delay_s": float,
            "max_delay_s": float,
            "breaker_failure_threshold": int,
            "breaker_open_duration_s": float,
            "spool_max_bytes": int,
            "spool_max_age_s": float,
            "restore_after_cycles": int,
        },
    )
    if "ingest" in raw:
        # Presence of the section turns the gate on (the operator
        # described it); an explicit ``enabled: false`` still wins.
        cfg.ingest.enabled = True
        _merge_section(
            cfg.ingest,
            raw.get("ingest") or {},
            {
                "enabled": bool,
                "dedup_window": int,
                "watermark_lateness_ms": int,
                "coordinator_host": int,
                "min_skew_samples": int,
                "skew_correction": bool,
                "quarantine_dir": str,
                "quarantine_max_bytes": int,
                "quarantine_max_age_s": float,
            },
        )
    if "observability" in raw:
        # Presence of the section turns self-tracing on (the operator
        # described it); an explicit ``enabled: false`` still wins.
        cfg.observability.enabled = True
        _merge_section(
            cfg.observability,
            raw.get("observability") or {},
            {
                "enabled": bool,
                "trace_endpoint": str,
                "sample_rate": float,
                "slow_cycle_ms": float,
                "max_overhead_pct": float,
                "provenance_path": str,
            },
        )
    if "profiler" in raw:
        # Presence of the section turns the continuous profiler on
        # (the operator described it); an explicit ``enabled: false``
        # still wins.
        cfg.profiler.enabled = True
        _merge_section(
            cfg.profiler,
            raw.get("profiler") or {},
            {
                "enabled": bool,
                "source": str,
                "stride_cycles": int,
                "max_stride_cycles": int,
                "window_steps": int,
                "overhead_budget_pct": float,
                "cycle_budget_ms": float,
                "ema_alpha": float,
                "grace_cycles": int,
                "history": int,
                "log_dir": str,
            },
        )
    if "slo" in raw:
        # Presence of the section turns the burn engine on (the
        # operator described it); an explicit ``enabled: false`` wins.
        cfg.slo.enabled = True
        _merge_section(
            cfg.slo,
            raw.get("slo") or {},
            {
                "enabled": bool,
                "bucket_s": int,
                "budget_window_s": int,
                "availability_target": float,
                "ttft_objective_ms": float,
                "ttft_target": float,
                "tpot_objective_ms": float,
                "tpot_target": float,
                "fast_burn_threshold": float,
                "slow_burn_threshold": float,
                "clear_hysteresis": float,
                "clear_cycles": int,
                "max_tenants": int,
                "tenants": _tenant_overrides,
            },
        )
    if "remediation" in raw:
        # Presence of the section arms the action loop (the operator
        # described it); an explicit ``enabled: false`` still wins.
        cfg.remediation.enabled = True
        _merge_section(
            cfg.remediation,
            raw.get("remediation") or {},
            {
                "enabled": bool,
                "min_confidence": float,
                "max_concurrent_actions": int,
                "cooldown_s": float,
                "rate_limit": int,
                "rate_window_s": float,
                "verify_windows": int,
                "verify_streak": int,
                "verify_subside_below": float,
                "disabled_actions": _action_kind_list,
            },
        )
    _merge_section(
        cfg.runtime,
        raw.get("runtime") or {},
        {
            "state_dir": str,
            "snapshot_interval_s": float,
            "snapshot_max_age_s": float,
            "drain_timeout_s": float,
            "supervisor_heartbeat_timeout_s": float,
            "supervisor_flap_restarts": int,
            "supervisor_flap_window_s": float,
            "supervisor_flap_holddown_s": float,
        },
    )
    _merge_section(
        cfg.tpu,
        raw.get("tpu") or {},
        {
            "enabled": bool,
            "libtpu_path": str,
            "accel_device_glob": str,
            "slice_id": str,
            "host_index": int,
        },
    )

    validate(cfg.to_dict(), SCHEMA_TOOLKIT_CONFIG)
    return cfg
