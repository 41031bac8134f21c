"""Per-signal status thresholds (the port's own copy of the part of
``tpuslo/signals/generator.py`` the device plane reads:
``SIGNAL_THRESHOLDS`` and ``signal_status``).

The rest of the JAX module (the fault profiles and the probe-event
generator) pulls in the collector and the schema and is not ported.
"""

from __future__ import annotations

from tpuslo_torch.signals import constants as sig

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
