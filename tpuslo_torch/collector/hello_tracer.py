"""Hello heartbeat tracer: periodic evidence events.

Reference: ``pkg/collector/hello_tracer.go:18-69`` — a goroutine that
emits a heartbeat counter so operators can prove the agent→metrics
chain is alive.  Here the tracer writes ``TPUSLO_SIG_HELLO`` wire
events into a userspace ring at a fixed cadence; on privileged hosts
the eBPF program ``ebpf/c/hello_heartbeat.bpf.c`` supersedes it with a
kernel-sourced count.

The port's own copy of ``tpuslo/collector/hello_tracer.py``.
"""

from __future__ import annotations

import os
import threading
import time

from tpuslo_torch.collector import native
from tpuslo_torch.collector.ringbuf import RingWriter


class HelloTracer:
    """Background heartbeat writer (daemon thread)."""

    def __init__(self, ring_path: str, interval_s: float = 5.0):
        self._writer = RingWriter(ring_path)
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.beats = 0

    def beat_once(self) -> bool:
        self.beats += 1
        return self._writer.write_event(
            signal=native.SIG_HELLO,
            value=self.beats,
            ts_ns=time.time_ns(),
            pid=os.getpid(),
            comm=b"hello_tracer",
        )

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self._interval):
                self.beat_once()

        self._thread = threading.Thread(
            target=loop, name="tpuslo-hello", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._writer.close()
