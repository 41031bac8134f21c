"""Signal registry and capability modes (the port's own copy of
``tpuslo/signals/constants.py``).

Signal names are contract strings: the probe payloads the port's device
plane emits carry exactly the names the JAX package's consumers read,
so this file is a verbatim copy of the registry, not a translation.
The original's notes on the reference follow.

Reference: ``pkg/signals/constants.go:4-59`` defines twelve CPU-side
signal keys, two capability modes (``core_full`` / ``bcc_degraded``) and
the overhead disable order.  The TPU-native build adds seven accelerator
signals sourced from libtpu uprobes and ``/dev/accel*`` kprobes and a
``tpu_full`` capability mode; TPU probes are shed *first* when the
overhead guard trips (SURVEY.md §7 step 6).
"""

from __future__ import annotations

# --- CPU-side kernel signals (reference parity) -------------------------
SIGNAL_DNS_LATENCY_MS = "dns_latency_ms"
SIGNAL_TCP_RETRANSMITS = "tcp_retransmits_total"
SIGNAL_RUNQUEUE_DELAY_MS = "runqueue_delay_ms"
SIGNAL_CONNECT_LATENCY_MS = "connect_latency_ms"
SIGNAL_CONNECT_ERRORS = "connect_errors_total"
SIGNAL_TLS_HANDSHAKE_MS = "tls_handshake_ms"
SIGNAL_TLS_HANDSHAKE_FAILS = "tls_handshake_fail_total"
SIGNAL_CPU_STEAL_PCT = "cpu_steal_pct"
SIGNAL_CFS_THROTTLED_MS = "cfs_throttled_ms"
SIGNAL_MEM_RECLAIM_LATENCY_MS = "mem_reclaim_latency_ms"
SIGNAL_DISK_IO_LATENCY_MS = "disk_io_latency_ms"
SIGNAL_SYSCALL_LATENCY_MS = "syscall_latency_ms"

# --- TPU-side signals (TPU-native extension) ----------------------------
# XLA program compile wall time, from uprobes on libtpu compile entry/exit.
SIGNAL_XLA_COMPILE_MS = "xla_compile_ms"
# Time a device allocation waited for HBM to free up (allocator uprobes).
SIGNAL_HBM_ALLOC_STALL_MS = "hbm_alloc_stall_ms"
# Fraction of device HBM in use, sampled from the allocator statistics.
SIGNAL_HBM_UTILIZATION_PCT = "hbm_utilization_pct"
# Per-window count of ICI link-level retries (driver counters).
SIGNAL_ICI_LINK_RETRIES = "ici_link_retries_total"
# Wall time of cross-chip collectives (all-reduce/all-gather launches).
SIGNAL_ICI_COLLECTIVE_MS = "ici_collective_latency_ms"
# Host<->device transfer stall (infeed/outfeed/offload wait), dma uprobes
# plus /dev/accel* ioctl kprobe latency.
SIGNAL_HOST_OFFLOAD_STALL_MS = "host_offload_stall_ms"
# Wall time of the cross-slice (DCN) transfer phase inside multi-slice
# collectives, from megascale transfer uprobes.  Distinct from the ICI
# signals: DCN rides the data-center ethernet fabric between slices, so
# its failure physiology pairs with TCP retransmits, not link retries.
SIGNAL_DCN_TRANSFER_MS = "dcn_transfer_latency_ms"
# Per-window device idle-gap time from the device-plane ledger
# (tpuslo/deviceplane): wall time inside the observation window where
# the chip ran NO launch at all.  A preempted/evicted device shows a
# huge gap; a starved dispatch thread (noisy-neighbor host CPU) shows a
# creeping one.  Sampled from the ledger, not probed.
SIGNAL_DEVICE_IDLE_GAP_MS = "device_idle_gap_ms"
# Per-window count of device preemption/eviction notices (maintenance
# events, device re-init after the runtime lost the chip).
SIGNAL_DEVICE_EVICTION_EVENTS = "device_eviction_events_total"
# Fraction of the profiler window's device time the ledger's tier
# ladder could NOT explain (tpuslo/deviceplane/ledger.py's honest
# remainder).  A creeping share means the join ladder is losing
# launches — capture truncation, a new anonymous program, or a lane
# the ledger has never seen.  Sampled per capture window by the
# continuous profiler (tpuslo/deviceplane/profiler.py); the synthetic
# fault generator never fabricates it (see Generator.set_signals).
SIGNAL_DEVICE_UNEXPLAINED_SHARE = "device_unexplained_share"
# Model-FLOP utilisation of the window's serving program against the
# chip's compute roof, from the roofline fold over the ledger's joined
# launches.  LOW is bad (and on memory-bound decode, meaningless — the
# attached roofline verdict carries the interpretation), so it takes
# no place in the high-is-bad warn/error ladder: informational only.
SIGNAL_DEVICE_MFU_PCT = "device_mfu_pct"

CPU_SIGNALS: tuple[str, ...] = (
    SIGNAL_DNS_LATENCY_MS,
    SIGNAL_TCP_RETRANSMITS,
    SIGNAL_RUNQUEUE_DELAY_MS,
    SIGNAL_CONNECT_LATENCY_MS,
    SIGNAL_CONNECT_ERRORS,
    SIGNAL_TLS_HANDSHAKE_MS,
    SIGNAL_TLS_HANDSHAKE_FAILS,
    SIGNAL_CPU_STEAL_PCT,
    SIGNAL_CFS_THROTTLED_MS,
    SIGNAL_MEM_RECLAIM_LATENCY_MS,
    SIGNAL_DISK_IO_LATENCY_MS,
    SIGNAL_SYSCALL_LATENCY_MS,
)

TPU_SIGNALS: tuple[str, ...] = (
    SIGNAL_XLA_COMPILE_MS,
    SIGNAL_HBM_ALLOC_STALL_MS,
    SIGNAL_HBM_UTILIZATION_PCT,
    SIGNAL_ICI_LINK_RETRIES,
    SIGNAL_ICI_COLLECTIVE_MS,
    SIGNAL_HOST_OFFLOAD_STALL_MS,
    SIGNAL_DCN_TRANSFER_MS,
    SIGNAL_DEVICE_IDLE_GAP_MS,
    SIGNAL_DEVICE_EVICTION_EVENTS,
    SIGNAL_DEVICE_UNEXPLAINED_SHARE,
    SIGNAL_DEVICE_MFU_PCT,
)

ALL_SIGNALS: tuple[str, ...] = CPU_SIGNALS + TPU_SIGNALS

# --- Capability modes ---------------------------------------------------
# tpu_full     — TPU-VM host with libtpu + /dev/accel access: all signals.
# cuda_full    — GPU host with /dev/nvidia* or libcuda.so (the port's
#                probe surface, tpuslo_torch/collector): all signals.
# core_full    — CO-RE capable kernel, no device probe surface: CPU signals.
# bcc_degraded — no BTF; BCC fallback covers DNS + TCP retransmits only.
CAPABILITY_TPU_FULL = "tpu_full"
CAPABILITY_CUDA_FULL = "cuda_full"
CAPABILITY_CORE_FULL = "core_full"
CAPABILITY_BCC_DEGRADED = "bcc_degraded"

CAPABILITY_MODES = (
    CAPABILITY_TPU_FULL,
    CAPABILITY_CUDA_FULL,
    CAPABILITY_CORE_FULL,
    CAPABILITY_BCC_DEGRADED,
)

_BCC_SIGNAL_SET: tuple[str, ...] = (
    SIGNAL_DNS_LATENCY_MS,
    SIGNAL_TCP_RETRANSMITS,
)

# Disable order when the overhead guard trips.  TPU uprobes are shed
# before kernel probes: high-rate libtpu call sites (collective launches,
# allocator hits) dominate event volume on a busy chip, and losing TPU
# depth degrades attribution less than losing the kernel spine entirely.
# The CPU tail mirrors reference ``constants.go:46-59``.
HIGH_COST_DISABLE_ORDER: tuple[str, ...] = (
    # The device-plane ledger signals are sampled (no probe cost), but
    # producing them requires an xprof/ledger pass — shed that first.
    # The continuous-profiler window signals sit at the very front:
    # they ride the same capture the profiler's own overhead governor
    # already degrades, so they are the cheapest depth to give back.
    SIGNAL_DEVICE_UNEXPLAINED_SHARE,
    SIGNAL_DEVICE_MFU_PCT,
    SIGNAL_DEVICE_IDLE_GAP_MS,
    SIGNAL_DEVICE_EVICTION_EVENTS,
    SIGNAL_DCN_TRANSFER_MS,
    SIGNAL_ICI_COLLECTIVE_MS,
    SIGNAL_HBM_ALLOC_STALL_MS,
    SIGNAL_HOST_OFFLOAD_STALL_MS,
    SIGNAL_XLA_COMPILE_MS,
    SIGNAL_HBM_UTILIZATION_PCT,
    SIGNAL_ICI_LINK_RETRIES,
    SIGNAL_TLS_HANDSHAKE_MS,
    SIGNAL_SYSCALL_LATENCY_MS,
    SIGNAL_RUNQUEUE_DELAY_MS,
    SIGNAL_DISK_IO_LATENCY_MS,
    SIGNAL_CONNECT_LATENCY_MS,
    SIGNAL_MEM_RECLAIM_LATENCY_MS,
    SIGNAL_CPU_STEAL_PCT,
    SIGNAL_DNS_LATENCY_MS,
    SIGNAL_TCP_RETRANSMITS,
    SIGNAL_CFS_THROTTLED_MS,
    SIGNAL_CONNECT_ERRORS,
    SIGNAL_TLS_HANDSHAKE_FAILS,
)


def required_minimum_signals() -> list[str]:
    """The six required baseline signals (reference ``constants.go:62-71``)."""
    return [
        SIGNAL_DNS_LATENCY_MS,
        SIGNAL_TCP_RETRANSMITS,
        SIGNAL_RUNQUEUE_DELAY_MS,
        SIGNAL_CONNECT_LATENCY_MS,
        SIGNAL_TLS_HANDSHAKE_MS,
        SIGNAL_CPU_STEAL_PCT,
    ]


def supported_signals_for_mode(mode: str) -> list[str]:
    """Signal set available under a capability mode.

    Reference: ``pkg/signals/constants.go:74-82``.
    """
    if mode == CAPABILITY_BCC_DEGRADED:
        return list(_BCC_SIGNAL_SET)
    if mode == CAPABILITY_CORE_FULL:
        return list(CPU_SIGNALS)
    return list(ALL_SIGNALS)


def disable_order() -> list[str]:
    """Preferred shed order when overhead exceeds budget."""
    return list(HIGH_COST_DISABLE_ORDER)
