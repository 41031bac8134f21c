"""Ring-buffer transport of the real-probe event path (the port's own
copy of ``tpuslo/collector/ringbuf.py``).

A producer (:class:`RingWriter`: the HBM sampler, the hello tracer, the
on-chip session's storm) writes packed wire events into a shared-memory
ring; :class:`RingBufConsumer` polls the native consumer
(``native/consumer.cc``: decode, unit normalization and cpu-steal window
aggregation happen natively) over ctypes, and :func:`to_probe_event`
lifts each decoded sample into a schema ``ProbeEventV1`` envelope.  The
agent's ring loop (:mod:`tpuslo_torch.cli.agent`) drives the consumer.

Two transports feed the same native consumer: the kernel BPF ring
buffer (privileged hosts; the map fd comes from
:class:`tpuslo_torch.collector.probe_manager.ProbeManager`) and
userspace shared-memory rings written through :class:`RingWriter`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace

from tpuslo_torch.collector import native
from tpuslo_torch.schema import ConnTuple, ProbeEventV1
from tpuslo_torch.signals.generator import SIGNAL_UNITS, signal_status
from tpuslo_torch.signals.metadata import Metadata, MetadataEnricher

#: Signals whose native samples carry TPU identity semantics.
_TPU_SIGNAL_PREFIXES = ("xla_", "hbm_", "ici_", "host_offload")


@dataclass
class DecodedSample:
    """One normalized sample handed up by the native consumer."""

    signal: str
    value: float
    unit: str
    ts_ns: int
    pid: int
    tid: int
    aux: int = 0
    err: int = 0
    flags: int = 0
    conn_tuple: str = ""
    comm: str = ""

    @property
    def is_tpu(self) -> bool:
        return bool(self.flags & native.F_TPU) or self.signal.startswith(
            _TPU_SIGNAL_PREFIXES
        )


def _from_native(raw: native.NativeSample) -> DecodedSample:
    return DecodedSample(
        signal=raw.signal.decode(),
        value=raw.value,
        unit=raw.unit.decode(),
        ts_ns=raw.ts_ns,
        pid=raw.pid,
        tid=raw.tid,
        aux=raw.aux,
        err=raw.err,
        flags=raw.flags,
        conn_tuple=raw.conn_tuple.decode(),
        comm=raw.comm.split(b"\0", 1)[0].decode(errors="replace"),
    )


class RingWriter:
    """Producer handle for a userspace ring."""

    def __init__(self, path: str, capacity: int = 1 << 20):
        self._lib = native.load_runtime()
        self._handle = self._lib.tpuslo_ring_create(
            path.encode(), capacity
        )
        if not self._handle:
            raise native.NativeRuntimeError(f"ring create failed: {path}")
        self.path = path

    def write(self, event: bytes) -> bool:
        rc = self._lib.tpuslo_ring_write(
            self._handle, event, len(event)
        )
        return rc == 0

    def write_event(self, **kwargs) -> bool:
        return self.write(native.pack_event(**kwargs))

    @property
    def dropped(self) -> int:
        return self._lib.tpuslo_ring_dropped(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.tpuslo_ring_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RingBufConsumer:
    """Polls the native consumer and yields :class:`DecodedSample`."""

    def __init__(
        self,
        steal_window_ms: int = 1000,
        ncpu: int | None = None,
        batch: int = 256,
    ):
        self._lib = native.load_runtime()
        self._handle = self._lib.tpuslo_consumer_new()
        if not self._handle:
            raise native.NativeRuntimeError("consumer allocation failed")
        self._batch = batch
        self._buf = (native.NativeSample * batch)()
        if steal_window_ms or ncpu:
            import os

            self._lib.tpuslo_consumer_configure_steal(
                self._handle,
                steal_window_ms * 1_000_000,
                ncpu or os.cpu_count() or 1,
            )

    def add_userspace_ring(self, path: str) -> int:
        rc = self._lib.tpuslo_consumer_add_userspace(
            self._handle, path.encode()
        )
        if rc < 0:
            raise native.NativeRuntimeError(f"ring attach failed: {path}")
        return rc

    def add_kernel_ringbuf(self, map_fd: int) -> int:
        rc = self._lib.tpuslo_consumer_add_kernel(self._handle, map_fd)
        if rc < 0:
            raise native.NativeRuntimeError(
                "kernel ringbuf attach failed (libbpf present?)"
            )
        return rc

    def poll(self, timeout_ms: int = 0) -> list[DecodedSample]:
        n = self._lib.tpuslo_consumer_poll(
            self._handle,
            ctypes.cast(self._buf, ctypes.POINTER(native.NativeSample)),
            self._batch,
            timeout_ms,
        )
        return [_from_native(self._buf[i]) for i in range(max(n, 0))]

    @property
    def decode_errors(self) -> int:
        return self._lib.tpuslo_consumer_decode_errors(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.tpuslo_consumer_free(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _parse_conn(tuple_str: str) -> ConnTuple | None:
    """``"1.2.3.4:5->6.7.8.9:10"`` → :class:`ConnTuple`."""
    if "->" not in tuple_str:
        return None
    src, dst = tuple_str.split("->", 1)
    try:
        saddr, sport = src.rsplit(":", 1)
        daddr, dport = dst.rsplit(":", 1)
        return ConnTuple(saddr, daddr, int(sport), int(dport), "tcp")
    except ValueError:
        return None


def to_probe_event(
    sample: DecodedSample,
    meta: Metadata,
    enricher: MetadataEnricher | None = None,
) -> ProbeEventV1 | None:
    """Lift a decoded sample into the schema envelope.

    Returns None for diagnostics signals (hello heartbeat) that have no
    schema identity.
    """
    if sample.signal not in SIGNAL_UNITS:
        return None
    meta = replace(meta, pid=sample.pid or meta.pid, tid=sample.tid or meta.tid)
    if enricher is not None:
        meta = enricher.enrich(meta)
    event = ProbeEventV1(
        ts_unix_nano=sample.ts_ns,
        signal=sample.signal,
        node=meta.node,
        namespace=meta.namespace,
        pod=meta.pod,
        container=meta.container,
        pid=meta.pid,
        tid=meta.tid,
        value=sample.value,
        unit=sample.unit or SIGNAL_UNITS[sample.signal],
        status=signal_status(sample.signal, sample.value),
        trace_id=meta.trace_id,
        span_id=meta.span_id,
        conn_tuple=_parse_conn(sample.conn_tuple),
    )
    if sample.err:
        event.errno = abs(sample.err)
    if sample.is_tpu:
        from tpuslo_torch.schema import TPURef

        # aux is signal-scoped (ebpf/c/tpuslo_event.h): launch id for
        # collectives (intra-slice and cross-slice), link index for
        # link retries.
        event.tpu = TPURef(
            chip=meta.tpu_chip,
            slice_id=meta.slice_id,
            host_index=meta.host_index,
            program_id=meta.xla_program_id,
            launch_id=(
                sample.aux
                if sample.signal
                in ("ici_collective_latency_ms", "dcn_transfer_latency_ms")
                else -1
            ),
            ici_link=(
                sample.aux
                if sample.signal == "ici_link_retries_total"
                else -1
            ),
        )
    return event
