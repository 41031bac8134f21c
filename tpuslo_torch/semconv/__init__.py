"""OTel semantic-convention attribute names (``llm.ebpf.*``, ``llm.slo.*``,
``llm.tpu.*``).

Reference: ``pkg/semconv/llm_ebpf.go:3-27``; the ``llm.tpu.*`` namespace
is the TPU-native extension.
"""

ATTR_DNS_LATENCY_MS = "llm.ebpf.dns.latency_ms"
ATTR_TCP_RETRANSMITS = "llm.ebpf.tcp.retransmits"
ATTR_RUNQUEUE_DELAY_MS = "llm.ebpf.sched.runqueue_delay_ms"
ATTR_CPU_STEAL_PCT = "llm.ebpf.cpu.steal_pct"
ATTR_CONNECT_LATENCY_MS = "llm.ebpf.net.connect_latency_ms"
ATTR_TLS_HANDSHAKE_MS = "llm.ebpf.tls.handshake_ms"
ATTR_CORRELATION_CONF = "llm.ebpf.correlation_confidence"
ATTR_CORRELATION_TIER = "llm.ebpf.correlation_tier"
ATTR_CFS_THROTTLED_MS = "llm.ebpf.cpu.cfs_throttled_ms"
ATTR_MEM_RECLAIM_LATENCY_MS = "llm.ebpf.mm.reclaim_latency_ms"
ATTR_DISK_IO_LATENCY_MS = "llm.ebpf.blk.io_latency_ms"
ATTR_SYSCALL_LATENCY_MS = "llm.ebpf.syscall.latency_ms"
ATTR_CONNECT_ERRORS = "llm.ebpf.net.connect_errors_total"
ATTR_TLS_HANDSHAKE_FAILS = "llm.ebpf.tls.handshake_fail_total"
ATTR_RETRIEVAL_KERNEL_MS = "llm.ebpf.retrieval.kernel_attributed_ms"
ATTR_RETRY_STORM = "llm.ebpf.tcp.retry_storm"

ATTR_SLO_TTFT_MS = "llm.slo.ttft_ms"
ATTR_SLO_TOKENS_PER_SEC = "llm.slo.tokens_per_sec"
ATTR_RETRIEVAL_VECTORDB_MS = "llm.slo.retrieval.vectordb_ms"
ATTR_RETRIEVAL_NETWORK_MS = "llm.slo.retrieval.network_ms"
ATTR_RETRIEVAL_DNS_MS = "llm.slo.retrieval.dns_ms"

# TPU-native namespace.
ATTR_XLA_COMPILE_MS = "llm.tpu.xla.compile_ms"
ATTR_HBM_ALLOC_STALL_MS = "llm.tpu.hbm.alloc_stall_ms"
ATTR_HBM_UTILIZATION_PCT = "llm.tpu.hbm.utilization_pct"
ATTR_ICI_LINK_RETRIES = "llm.tpu.ici.link_retries_total"
ATTR_ICI_COLLECTIVE_MS = "llm.tpu.ici.collective_latency_ms"
ATTR_HOST_OFFLOAD_STALL_MS = "llm.tpu.offload.stall_ms"
ATTR_TPU_KERNEL_MS = "llm.tpu.kernel_attributed_ms"
ATTR_TPU_CHIP = "llm.tpu.chip"
ATTR_TPU_SLICE = "llm.tpu.slice_id"
ATTR_XLA_PROGRAM_ID = "llm.tpu.xla.program_id"
ATTR_XLA_LAUNCH_ID = "llm.tpu.xla.launch_id"

# signal name -> span attribute key (correlator mapping).
SIGNAL_ATTR_KEYS = {
    "dns_latency_ms": ATTR_DNS_LATENCY_MS,
    "tcp_retransmits_total": ATTR_TCP_RETRANSMITS,
    "runqueue_delay_ms": ATTR_RUNQUEUE_DELAY_MS,
    "connect_latency_ms": ATTR_CONNECT_LATENCY_MS,
    "tls_handshake_ms": ATTR_TLS_HANDSHAKE_MS,
    "cpu_steal_pct": ATTR_CPU_STEAL_PCT,
    "cfs_throttled_ms": ATTR_CFS_THROTTLED_MS,
    "mem_reclaim_latency_ms": ATTR_MEM_RECLAIM_LATENCY_MS,
    "disk_io_latency_ms": ATTR_DISK_IO_LATENCY_MS,
    "syscall_latency_ms": ATTR_SYSCALL_LATENCY_MS,
    "connect_errors_total": ATTR_CONNECT_ERRORS,
    "tls_handshake_fail_total": ATTR_TLS_HANDSHAKE_FAILS,
    "xla_compile_ms": ATTR_XLA_COMPILE_MS,
    "hbm_alloc_stall_ms": ATTR_HBM_ALLOC_STALL_MS,
    "hbm_utilization_pct": ATTR_HBM_UTILIZATION_PCT,
    "ici_link_retries_total": ATTR_ICI_LINK_RETRIES,
    "ici_collective_latency_ms": ATTR_ICI_COLLECTIVE_MS,
    "host_offload_stall_ms": ATTR_HOST_OFFLOAD_STALL_MS,
}
