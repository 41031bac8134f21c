"""Per-fault synthetic signal profiles and probe-event fan-out (the port's
own copy of ``tpuslo/signals/generator.py``; the columnar twin
``Generator.generate_batch_columnar`` waits for the port's columnar spine).

Reference: ``pkg/signals/generator.go`` — a capability-filtered generator
expands one request sample into one normalized probe event per enabled
signal, with values drawn from a fault-label → signal-profile table and
statuses from per-signal warn/error thresholds
(``generator.go:203-289``).  The TPU-native build extends both tables
with the six accelerator signals and stamps TPU events with accelerator
identity (:class:`tpuslo_torch.schema.TPURef`) so the XLA correlation tier can
join them to spans.
"""

from __future__ import annotations

import re
import threading
from typing import Iterable

from tpuslo_torch.collector.synthetic import RawSample
from tpuslo_torch.schema import ConnTuple, ProbeEventV1, TPURef
from tpuslo_torch.signals import constants as sig
from tpuslo_torch.signals.metadata import Metadata, MetadataEnricher

# Per-signal (warning, error) status thresholds.
# CPU rows: reference ``generator.go:203-242``; TPU rows: designed from
# v5e serving envelopes (a >2s compile or >20ms HBM stall is pathological).
SIGNAL_THRESHOLDS: dict[str, tuple[float, float]] = {
    sig.SIGNAL_DNS_LATENCY_MS: (40, 120),
    sig.SIGNAL_TCP_RETRANSMITS: (2, 5),
    sig.SIGNAL_RUNQUEUE_DELAY_MS: (10, 25),
    sig.SIGNAL_CONNECT_LATENCY_MS: (80, 180),
    sig.SIGNAL_CONNECT_ERRORS: (1, 3),
    sig.SIGNAL_TLS_HANDSHAKE_MS: (60, 160),
    sig.SIGNAL_TLS_HANDSHAKE_FAILS: (1, 3),
    sig.SIGNAL_CPU_STEAL_PCT: (2, 8),
    sig.SIGNAL_CFS_THROTTLED_MS: (40, 120),
    sig.SIGNAL_MEM_RECLAIM_LATENCY_MS: (5, 20),
    sig.SIGNAL_DISK_IO_LATENCY_MS: (10, 50),
    sig.SIGNAL_SYSCALL_LATENCY_MS: (50, 200),
    sig.SIGNAL_XLA_COMPILE_MS: (500, 2000),
    sig.SIGNAL_HBM_ALLOC_STALL_MS: (5, 20),
    sig.SIGNAL_HBM_UTILIZATION_PCT: (85, 95),
    sig.SIGNAL_ICI_LINK_RETRIES: (5, 20),
    sig.SIGNAL_ICI_COLLECTIVE_MS: (10, 30),
    sig.SIGNAL_HOST_OFFLOAD_STALL_MS: (20, 80),
    sig.SIGNAL_DCN_TRANSFER_MS: (25, 80),
    sig.SIGNAL_DEVICE_IDLE_GAP_MS: (25, 100),
    sig.SIGNAL_DEVICE_EVICTION_EVENTS: (1, 3),
    sig.SIGNAL_DEVICE_UNEXPLAINED_SHARE: (0.10, 0.25),
    # MFU is LOW-is-bad and often meaningless (memory-bound decode);
    # the high-is-bad ladder must never fire on it, so both thresholds
    # sit above the 100% ceiling and the status is always "ok".  The
    # profiler's roofline verdict carries the interpretation.
    sig.SIGNAL_DEVICE_MFU_PCT: (101.0, 101.0),
}

SIGNAL_UNITS: dict[str, str] = {
    sig.SIGNAL_DNS_LATENCY_MS: "ms",
    sig.SIGNAL_TCP_RETRANSMITS: "count",
    sig.SIGNAL_RUNQUEUE_DELAY_MS: "ms",
    sig.SIGNAL_CONNECT_LATENCY_MS: "ms",
    sig.SIGNAL_CONNECT_ERRORS: "count",
    sig.SIGNAL_TLS_HANDSHAKE_MS: "ms",
    sig.SIGNAL_TLS_HANDSHAKE_FAILS: "count",
    sig.SIGNAL_CPU_STEAL_PCT: "pct",
    sig.SIGNAL_CFS_THROTTLED_MS: "ms",
    sig.SIGNAL_MEM_RECLAIM_LATENCY_MS: "ms",
    sig.SIGNAL_DISK_IO_LATENCY_MS: "ms",
    sig.SIGNAL_SYSCALL_LATENCY_MS: "ms",
    sig.SIGNAL_XLA_COMPILE_MS: "ms",
    sig.SIGNAL_HBM_ALLOC_STALL_MS: "ms",
    sig.SIGNAL_HBM_UTILIZATION_PCT: "pct",
    sig.SIGNAL_ICI_LINK_RETRIES: "count",
    sig.SIGNAL_ICI_COLLECTIVE_MS: "ms",
    sig.SIGNAL_HOST_OFFLOAD_STALL_MS: "ms",
    sig.SIGNAL_DCN_TRANSFER_MS: "ms",
    sig.SIGNAL_DEVICE_IDLE_GAP_MS: "ms",
    sig.SIGNAL_DEVICE_EVICTION_EVENTS: "count",
    sig.SIGNAL_DEVICE_UNEXPLAINED_SHARE: "ratio",
    sig.SIGNAL_DEVICE_MFU_PCT: "pct",
}

# Signals only the continuous profiler's capture windows can source:
# the synthetic fault generator has no per-request story for them (they
# are per-WINDOW ledger folds), and — load-bearing — adding them to
# ``_BASE_PROFILE``/``_FAULT_OVERRIDES`` would insert RNG draws into
# ``calibrate.corrupt``'s sequential stream and re-roll every
# calibrated likelihood floor.  ``Generator.set_signals`` filters them
# out of the enabled set so both fan-out paths (row and columnar)
# never look them up in a fault profile.
PROFILER_ONLY_SIGNALS = frozenset(
    {
        sig.SIGNAL_DEVICE_UNEXPLAINED_SHARE,
        sig.SIGNAL_DEVICE_MFU_PCT,
    }
)

# Signals that carry a network flow tuple.
_CONN_TUPLE_SIGNALS = frozenset(
    {
        sig.SIGNAL_DNS_LATENCY_MS,
        sig.SIGNAL_TCP_RETRANSMITS,
        sig.SIGNAL_CONNECT_LATENCY_MS,
        sig.SIGNAL_CONNECT_ERRORS,
        sig.SIGNAL_TLS_HANDSHAKE_MS,
        sig.SIGNAL_TLS_HANDSHAKE_FAILS,
    }
)

# Healthy baseline values; CPU rows mirror reference ``generator.go:244-261``.
_BASE_PROFILE: dict[str, float] = {
    sig.SIGNAL_DNS_LATENCY_MS: 12,
    sig.SIGNAL_TCP_RETRANSMITS: 0.2,
    sig.SIGNAL_RUNQUEUE_DELAY_MS: 4,
    sig.SIGNAL_CONNECT_LATENCY_MS: 18,
    sig.SIGNAL_CONNECT_ERRORS: 0,
    sig.SIGNAL_TLS_HANDSHAKE_MS: 22,
    sig.SIGNAL_TLS_HANDSHAKE_FAILS: 0,
    sig.SIGNAL_CPU_STEAL_PCT: 0.6,
    sig.SIGNAL_CFS_THROTTLED_MS: 5,
    sig.SIGNAL_MEM_RECLAIM_LATENCY_MS: 0.5,
    sig.SIGNAL_DISK_IO_LATENCY_MS: 2,
    sig.SIGNAL_SYSCALL_LATENCY_MS: 5,
    sig.SIGNAL_XLA_COMPILE_MS: 0,
    sig.SIGNAL_HBM_ALLOC_STALL_MS: 0.2,
    sig.SIGNAL_HBM_UTILIZATION_PCT: 62,
    sig.SIGNAL_ICI_LINK_RETRIES: 0,
    sig.SIGNAL_ICI_COLLECTIVE_MS: 3.5,
    sig.SIGNAL_HOST_OFFLOAD_STALL_MS: 1.5,
    sig.SIGNAL_DCN_TRANSFER_MS: 8.0,
    sig.SIGNAL_DEVICE_IDLE_GAP_MS: 2.0,
    sig.SIGNAL_DEVICE_EVICTION_EVENTS: 0,
}

# Fault label -> (signal overrides, connect errno).
# CPU rows mirror reference ``generator.go:263-289``.  TPU rows encode
# how each accelerator fault manifests across the probe surface:
#   ici_drop            — link retries + collective latency explode; a
#                         degraded link also backs up the launch queue.
#   hbm_pressure        — allocator stalls + near-full HBM; the runtime
#                         starts spilling to host, so offload stall
#                         creeps into warning.
#   xla_recompile_storm — compile wall-time dominates; compiles burn
#                         host CPU so the runqueue warms up.
#   host_offload_stall  — host<->device transfers stall; feeding from
#                         disk drags disk/syscall latency with it.
_FAULT_OVERRIDES: dict[str, tuple[dict[str, float], int]] = {
    "baseline": ({}, 0),
    "dns_latency": (
        {
            sig.SIGNAL_DNS_LATENCY_MS: 220,
            sig.SIGNAL_CONNECT_LATENCY_MS: 130,
        },
        0,
    ),
    "cpu_throttle": (
        {
            sig.SIGNAL_RUNQUEUE_DELAY_MS: 28,
            sig.SIGNAL_CPU_STEAL_PCT: 9,
            sig.SIGNAL_CFS_THROTTLED_MS: 170,
        },
        0,
    ),
    "memory_pressure": (
        {
            sig.SIGNAL_RUNQUEUE_DELAY_MS: 14,
            sig.SIGNAL_CFS_THROTTLED_MS: 90,
            sig.SIGNAL_MEM_RECLAIM_LATENCY_MS: 25,
            sig.SIGNAL_DISK_IO_LATENCY_MS: 60,
        },
        0,
    ),
    "provider_throttle": (
        {
            # Backoff at the provider edge: accepts and handshakes slow
            # past their warning lines while reads block on rate limits.
            sig.SIGNAL_CONNECT_LATENCY_MS: 95,
            sig.SIGNAL_TLS_HANDSHAKE_MS: 70,
            sig.SIGNAL_CONNECT_ERRORS: 1,
            sig.SIGNAL_SYSCALL_LATENCY_MS: 250,
        },
        110,
    ),
    "network_partition": (
        {
            sig.SIGNAL_CONNECT_LATENCY_MS: 350,
            sig.SIGNAL_CONNECT_ERRORS: 3,
            sig.SIGNAL_TCP_RETRANSMITS: 12,
            sig.SIGNAL_DNS_LATENCY_MS: 180,
            sig.SIGNAL_TLS_HANDSHAKE_FAILS: 2,
        },
        113,
    ),
    "ici_drop": (
        {
            sig.SIGNAL_ICI_LINK_RETRIES: 45,
            sig.SIGNAL_ICI_COLLECTIVE_MS: 55,
            sig.SIGNAL_HOST_OFFLOAD_STALL_MS: 8,
        },
        0,
    ),
    "hbm_pressure": (
        {
            sig.SIGNAL_HBM_ALLOC_STALL_MS: 60,
            sig.SIGNAL_HBM_UTILIZATION_PCT: 97,
            sig.SIGNAL_HOST_OFFLOAD_STALL_MS: 25,
        },
        0,
    ),
    "xla_recompile_storm": (
        {
            sig.SIGNAL_XLA_COMPILE_MS: 3200,
            sig.SIGNAL_RUNQUEUE_DELAY_MS: 12,
        },
        0,
    ),
    "host_offload_stall": (
        {
            sig.SIGNAL_HOST_OFFLOAD_STALL_MS: 120,
            sig.SIGNAL_DISK_IO_LATENCY_MS: 40,
            sig.SIGNAL_SYSCALL_LATENCY_MS: 80,
        },
        0,
    ),
    # preemption_eviction — the chip is preempted/evicted out from
    # under the serving process: the runtime posts eviction notices and
    # the device-plane ledger shows a massive idle gap while the host
    # re-acquires the device.  The restart recompiles warm xla_compile
    # only mildly (sub-warning — the separator from a recompile storm),
    # and ICI/HBM stay clean (the separators from the fabric domains).
    "preemption_eviction": (
        {
            sig.SIGNAL_DEVICE_EVICTION_EVENTS: 4,
            sig.SIGNAL_DEVICE_IDLE_GAP_MS: 420,
            sig.SIGNAL_XLA_COMPILE_MS: 380,
            sig.SIGNAL_HOST_OFFLOAD_STALL_MS: 6,
        },
        0,
    ),
    # noisy_neighbor_cpu — another tenant's burst starves this host's
    # vCPUs: steal and runqueue delay explode WITHOUT cgroup quota
    # throttling (cfs_throttled stays at baseline — the separator from
    # cpu_throttle, whose physiology is the quota).  The starved
    # dispatch thread cannot feed the chip, so the ledger's idle gap
    # creeps past warning — host-plane cause, device-plane symptom.
    "noisy_neighbor_cpu": (
        {
            sig.SIGNAL_CPU_STEAL_PCT: 18,
            sig.SIGNAL_RUNQUEUE_DELAY_MS: 32,
            sig.SIGNAL_DEVICE_IDLE_GAP_MS: 60,
            sig.SIGNAL_SYSCALL_LATENCY_MS: 70,
        },
        0,
    ),
    # dcn_degradation — the cross-slice transfer phase stalls: the DCN
    # fabric is ethernet, so retransmits climb with it and whole-
    # collective latency warms up, but ICI link retries stay clean
    # (that is the separator from ici_drop) and there are no connect/
    # DNS symptoms (the separator from network_partition).
    "dcn_degradation": (
        {
            sig.SIGNAL_DCN_TRANSFER_MS: 140,
            sig.SIGNAL_TCP_RETRANSMITS: 6,
            sig.SIGNAL_ICI_COLLECTIVE_MS: 18,
        },
        0,
    ),
    "mixed_multi": (
        {
            # Concurrent network partition + provider throttle.
            sig.SIGNAL_CONNECT_LATENCY_MS: 350,
            sig.SIGNAL_CONNECT_ERRORS: 3,
            sig.SIGNAL_TCP_RETRANSMITS: 12,
            sig.SIGNAL_DNS_LATENCY_MS: 180,
            sig.SIGNAL_TLS_HANDSHAKE_FAILS: 2,
            sig.SIGNAL_TLS_HANDSHAKE_MS: 70,
            sig.SIGNAL_SYSCALL_LATENCY_MS: 250,
        },
        110,
    ),
}


def profile_for_fault(fault_label: str) -> dict[str, float]:
    """Full signal→value map for a fault label (base + overrides)."""
    overrides, _ = _FAULT_OVERRIDES.get(fault_label or "baseline", ({}, 0))
    profile = dict(_BASE_PROFILE)
    profile.update(overrides)
    return profile


def errno_for_fault(fault_label: str) -> int:
    return _FAULT_OVERRIDES.get(fault_label or "baseline", ({}, 0))[1]


def signal_status(signal: str, value: float) -> str:
    """Map a signal value to ok/warning/error via per-signal thresholds."""
    thresholds = SIGNAL_THRESHOLDS.get(signal)
    if thresholds is None:
        return "ok"
    warning, error = thresholds
    if value >= error:
        return "error"
    if value >= warning:
        return "warning"
    return "ok"


_REQ_NUM = re.compile(r"(\d+)$")


def _launch_id_for(sample: RawSample) -> int:
    """Deterministic synthetic XLA launch id derived from request identity."""
    match = _REQ_NUM.search(sample.request_id or "")
    return int(match.group(1)) if match else 0


class Generator:
    """Capability-filtered probe-event generator.

    Reference: ``pkg/signals/generator.go:27-155``.  Thread-safe: the
    agent's shedding loop disables signals concurrently with generation.
    """

    def __init__(
        self,
        mode: str,
        signal_set: Iterable[str] | None = None,
        enricher: MetadataEnricher | None = None,
    ):
        self._mode = mode
        self._enricher = enricher
        self._lock = threading.Lock()
        self._enabled: set[str] = set()
        self._shed: list[str] = []  # guard-shed signals, shed order
        self.set_signals(signal_set or [])

    @property
    def mode(self) -> str:
        return self._mode

    def set_signals(self, signal_set: Iterable[str]) -> None:
        """Replace enabled probes at runtime, filtered by capability."""
        allowed = (
            set(sig.supported_signals_for_mode(self._mode))
            - PROFILER_ONLY_SIGNALS
        )
        requested = set(signal_set)
        with self._lock:
            self._enabled = (requested & allowed) if requested else allowed
            self._shed.clear()  # a new set supersedes shed history

    def enabled_signals(self) -> list[str]:
        with self._lock:
            return sorted(self._enabled)

    def disable(self, signal: str) -> bool:
        with self._lock:
            if signal not in self._enabled:
                return False
            self._enabled.discard(signal)
            return True

    def disable_highest_cost(self) -> str | None:
        """Shed the next signal in the high-cost disable order."""
        with self._lock:
            for candidate in sig.HIGH_COST_DISABLE_ORDER:
                if candidate in self._enabled:
                    self._enabled.discard(candidate)
                    self._shed.append(candidate)
                    return candidate
        return None

    def shed_signals(self) -> list[str]:
        """Guard-shed signals awaiting restore, in shed order."""
        with self._lock:
            return list(self._shed)

    def restore_one(self) -> str | None:
        """Re-enable the most recently shed signal (reverse cost order:
        the cheapest still-shed probe comes back first).  Degradation is
        no longer one-way — see tpuslo_torch.safety.ShedRecoveryPolicy."""
        with self._lock:
            while self._shed:
                signal = self._shed.pop()
                if signal in self._enabled:
                    continue  # re-enabled out of band (set_signals race)
                self._enabled.add(signal)
                return signal
        return None

    def restore_signal(self, signal: str) -> bool:
        """Re-enable one specific shed signal (remediation rollback:
        the engine must restore exactly the probe *it* shed, not
        whatever happens to sit on top of the shed stack)."""
        with self._lock:
            if signal not in self._shed:
                return False
            self._shed.remove(signal)
            self._enabled.add(signal)
            return True

    def import_shed(self, signals: Iterable[str]) -> list[str]:
        """Adopt a restored shed list (oldest-shed first).

        A restarted agent must not re-enable probes its previous
        incarnation shed for overhead: the CPU pressure that forced the
        shed does not reset with the process.  Signals are re-shed in
        the recorded order so ``restore_one`` still ramps back cheapest
        first.  Returns the signals actually re-shed (unknown or
        already-shed names are skipped).
        """
        imported: list[str] = []
        with self._lock:
            for signal in signals:
                if signal in self._enabled:
                    self._enabled.discard(signal)
                    self._shed.append(signal)
                    imported.append(signal)
        return imported

    def generate(self, sample: RawSample, meta: Metadata) -> list[ProbeEventV1]:
        """Expand one sample into normalized probe events, one per signal."""
        return self.generate_batch([sample], meta)

    def generate_batch(
        self, samples: Iterable[RawSample], meta: Metadata
    ) -> list[ProbeEventV1]:
        """Expand a sample batch, in sample order then signal order.

        The hot-path twin of :meth:`generate`: the enabled-signal set and
        metadata enrichment are snapshotted once per batch (one lock
        acquisition, one enricher call), per-signal templates
        (unit / conn-tuple membership / errno eligibility / ICI link)
        are precomputed, and the per-fault value+status pairs are cached
        per distinct fault label rather than rebuilt per sample.
        """
        with self._lock:
            enabled = self._enabled.copy()
        if not enabled:
            return []

        if self._enricher is not None:
            meta = self._enricher.enrich(meta)

        # Per-batch signal templates: (signal, unit, is_conn, takes_errno,
        # ici_link or None when the signal carries no TPU block).
        templates = [
            (
                signal,
                SIGNAL_UNITS[signal],
                signal in _CONN_TUPLE_SIGNALS,
                signal
                in (sig.SIGNAL_CONNECT_LATENCY_MS, sig.SIGNAL_CONNECT_ERRORS),
                (0 if signal == sig.SIGNAL_ICI_LINK_RETRIES else -1)
                if signal in sig.TPU_SIGNALS
                else None,
            )
            for signal in sig.ALL_SIGNALS
            if signal in enabled
        ]
        conn_tuple = ConnTuple("10.244.0.10", "10.244.0.53", 42424, 443, "tcp")
        node, namespace, pod = meta.node, meta.namespace, meta.pod
        container, pid, tid = meta.container, meta.pid, meta.tid
        trace_id, span_id = meta.trace_id, meta.span_id
        chip = meta.tpu_chip or "accel0"

        # (value, status) per enabled signal, keyed by fault label: a
        # batch usually carries a handful of labels across hundreds of
        # samples, so threshold lookups happen once per label.
        fault_rows: dict[str, tuple[tuple[float, str], ...]] = {}

        out: list[ProbeEventV1] = []
        for sample in samples:
            label = sample.fault_label
            rows = fault_rows.get(label)
            if rows is None:
                profile = profile_for_fault(label)
                rows = tuple(
                    (profile[signal], signal_status(signal, profile[signal]))
                    for signal, _, _, _, _ in templates
                )
                fault_rows[label] = rows
            errno = errno_for_fault(label)
            ts_ns = int(sample.timestamp.timestamp() * 1e9)
            launch_id = _launch_id_for(sample)
            # TPU identity is per sample (launch id), shared across the
            # sample's TPU events except the ICI-link variant.
            tpu_ref = ici_ref = None

            for (signal, unit, is_conn, takes_errno, ici_link), (
                value,
                status,
            ) in zip(templates, rows):
                event = ProbeEventV1(
                    ts_unix_nano=ts_ns,
                    signal=signal,
                    node=node,
                    namespace=namespace,
                    pod=pod,
                    container=container,
                    pid=pid,
                    tid=tid,
                    value=value,
                    unit=unit,
                    status=status,
                    trace_id=trace_id,
                    span_id=span_id,
                )
                if is_conn:
                    event.conn_tuple = conn_tuple
                    if errno and takes_errno:
                        event.errno = errno
                if ici_link is not None:
                    if ici_link >= 0:
                        if ici_ref is None:
                            ici_ref = self._tpu_ref(
                                chip, meta, launch_id, ici_link
                            )
                        event.tpu = ici_ref
                    else:
                        if tpu_ref is None:
                            tpu_ref = self._tpu_ref(
                                chip, meta, launch_id, ici_link
                            )
                        event.tpu = tpu_ref
                out.append(event)
        return out

    @staticmethod
    def _tpu_ref(
        chip: str, meta: Metadata, launch_id: int, ici_link: int
    ) -> TPURef:
        return TPURef(
            chip=chip,
            slice_id=meta.slice_id,
            host_index=meta.host_index,
            ici_link=ici_link,
            program_id=meta.xla_program_id,
            launch_id=launch_id,
        )
