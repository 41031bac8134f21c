"""Userspace ring producer (the port's own copy of ``RingWriter`` from
``tpuslo/collector/ringbuf.py``).

A producer writes packed wire events into a shared-memory ring that the
agent's native consumer polls, the same path the kernel probes feed.
The consumer side stays in the JAX package's collector.
"""

from __future__ import annotations

from tpuslo_torch.collector import native


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
