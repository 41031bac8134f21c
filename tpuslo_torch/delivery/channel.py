"""Resilient delivery channel: queue → retry → breaker → spool → replay.

One channel fronts one sink (OTLP logs endpoint, incident webhook).
The producing loop calls :meth:`DeliveryChannel.submit` and never
blocks on the network: a worker thread drains the bounded in-memory
queue, retries retryable failures with exponential backoff + full
jitter, trips a per-sink circuit breaker on sustained failure, spools
undeliverable batches to a segmented disk WAL, and replays the spool
once the sink recovers.  Poison batches (non-retryable sink verdicts)
land in a dead-letter JSONL file with the recorded reason.

Loss accounting contract: a submitted batch is eventually *delivered*,
*dead-lettered* (reason recorded), or *truncated* by the spool caps
(counted via the observer) — it is never silently dropped, and spooled
batches are not drops.

The port's own copy of ``tpuslo/delivery/channel.py``.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Protocol

from tpuslo_torch.delivery.breaker import STATE_VALUES, CircuitBreaker
from tpuslo_torch.delivery.spool import DiskSpool


class SinkError(RuntimeError):
    """A sink delivery failure with an explicit retryability verdict."""

    def __init__(self, message: str, retryable: bool = True):
        super().__init__(message)
        self.retryable = retryable


class Sink(Protocol):
    """One network destination; ``send`` raises :class:`SinkError`."""

    def send(self, kind: str, payloads: list[dict]) -> None: ...


def full_jitter_delay(
    attempt: int,
    base_s: float,
    cap_s: float,
    rng: Callable[[], float] = random.random,
) -> float:
    """AWS-style full-jitter backoff: ``rng() * min(cap, base * 2^n)``."""
    return rng() * min(cap_s, base_s * (2 ** attempt))


class DeliveryObserver:
    """Metrics seam — no-op base so delivery stays prometheus-free."""

    def queue_depth(self, depth: int) -> None: ...
    def spool_bytes(self, n: int) -> None: ...
    def breaker_state(self, state: str) -> None: ...
    def delivered(self, kind: str, events: int) -> None: ...
    def retried(self, events: int) -> None: ...
    def spooled(self, kind: str, events: int) -> None: ...
    def replayed(self, events: int) -> None: ...
    def dead_lettered(self, kind: str, events: int, reason: str) -> None: ...
    def truncated(self, batches: int) -> None: ...


class DeliveryChannel:
    """Per-sink resilient delivery pipeline (see module docstring)."""

    def __init__(
        self,
        name: str,
        sink: Sink,
        spool_dir: str | os.PathLike,
        *,
        queue_max: int = 512,
        max_attempts: int = 4,
        base_delay_s: float = 0.05,
        max_delay_s: float = 2.0,
        breaker: CircuitBreaker | None = None,
        observer: DeliveryObserver | None = None,
        dead_letter_path: str = "",
        segment_max_bytes: int = 256 * 1024,
        spool_max_bytes: int = 64 * 1024 * 1024,
        spool_max_age_s: float = 24 * 3600.0,
        replay_interval_s: float = 0.5,
        sleep: Callable[[float], None] = time.sleep,
        rng: Callable[[], float] = random.random,
        walltime: Callable[[], float] = time.time,
        start_worker: bool = True,
    ):
        self.name = name
        self._sink = sink
        self._queue_max = max(1, queue_max)
        self._max_attempts = max(1, max_attempts)
        self._base_delay_s = base_delay_s
        self._max_delay_s = max_delay_s
        self._observer = observer or DeliveryObserver()
        self._breaker = breaker or CircuitBreaker(
            on_state_change=self._observer.breaker_state
        )
        self._sleep = sleep
        self._rng = rng
        self._walltime = walltime
        self._replay_interval_s = replay_interval_s

        spool_path = os.fspath(spool_dir)
        self._spool = DiskSpool(
            os.path.join(spool_path, name),
            segment_max_bytes=segment_max_bytes,
            max_bytes=spool_max_bytes,
            max_age_s=spool_max_age_s,
            walltime=walltime,
            on_truncate=self._on_truncate,
        )
        self._dead_letter_path = dead_letter_path or os.path.join(
            spool_path, f"{name}-dead-letter.jsonl"
        )

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: deque[tuple[str, list[dict]]] = deque()
        self._inflight = 0
        self._closed = False
        self._stop = False
        self.stats = {
            "submitted_events": 0,
            "delivered_events": 0,
            "spooled_events": 0,
            "replayed_events": 0,
            "dead_lettered_events": 0,
            "truncated_batches": 0,
            "retries": 0,
            "worker_errors": 0,
        }
        self._worker: threading.Thread | None = None
        if start_worker:
            self._worker = threading.Thread(
                target=self._run, name=f"delivery-{name}", daemon=True
            )
            self._worker.start()

    # ---- producer side ------------------------------------------------

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def spool_pending_bytes(self) -> int:
        return self._spool.pending_bytes()

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue) + self._inflight

    def _bump(self, key: str, n: int = 1) -> None:
        """Count one stats event under the channel lock.

        The worker thread and the producing loop both mutate ``stats``;
        GIL-atomicity of dict increments is an implementation accident,
        not a contract (tpulint TPL110 enforces the lock).
        """
        with self._lock:
            self.stats[key] += n

    def submit(self, kind: str, payloads: list[dict]) -> None:
        """Accept one batch; never blocks on the sink.

        A full queue spills the batch straight to the spool so memory
        stays bounded while the sink is down.
        """
        if not payloads:
            return
        spill = False
        with self._cond:
            if self._closed:
                raise RuntimeError(f"delivery channel {self.name} is closed")
            self.stats["submitted_events"] += len(payloads)
            if self._worker is not None and len(self._queue) >= self._queue_max:
                spill = True
            else:
                self._queue.append((kind, payloads))
                self._observer.queue_depth(len(self._queue) + self._inflight)
                self._cond.notify()
        if spill:
            # Outside the lock: the spill path appends to the disk
            # spool (its own lock) and bumps stats — doing either under
            # self._cond would nest lock acquisitions for no benefit.
            self._spool_batch(kind, payloads)
            return
        if self._worker is None:
            self.pump()

    def pump(self) -> None:
        """Synchronous drain for worker-less channels (tests, one-shots)."""
        while True:
            with self._cond:
                if not self._queue:
                    return
                kind, payloads = self._queue.popleft()
                self._inflight += 1
            try:
                self._process(kind, payloads)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._observer.queue_depth(len(self._queue) + self._inflight)
                    self._cond.notify_all()

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block until the in-memory queue is drained (spool may remain)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
        return True

    def close(self, flush_timeout_s: float = 10.0) -> None:
        """Flush, stop the worker, and attempt one final spool replay.

        If the flush times out (sink hanging, breaker not yet tripped),
        the remaining queue is spilled to the spool before returning —
        batches may ride out a shutdown on disk but are never silently
        dropped with the daemon worker.
        """
        deadline = time.monotonic() + flush_timeout_s
        with self._cond:
            if self._closed:
                return
            self._closed = True
        flushed = self.flush(flush_timeout_s)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._worker is not None:
            # One deadline covers flush AND join: a hung sink must not
            # get a second full budget out of the worker join (the
            # drain sequence shares this bound with the final snapshot).
            self._worker.join(
                timeout=max(0.0, deadline - time.monotonic())
            )
        with self._cond:
            leftover = list(self._queue)
            self._queue.clear()
        for kind, payloads in leftover:
            self._spool_batch(kind, payloads)
        # Last-gasp replay: if the sink recovered before shutdown, the
        # spool drains now instead of waiting for the next run.  A
        # timed-out flush means the sink is stuck — don't block
        # shutdown on one more send; the spool persists for next run.
        if flushed and self._spool.pending_bytes() and self._breaker.allow():
            try:
                self._replay()
            except SinkError:
                self._breaker.record_failure()
        self._spool.close()
        self._observer.spool_bytes(self._spool.pending_bytes())

    # ---- worker side --------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=self._replay_interval_s)
                    if not self._queue and not self._stop:
                        break  # idle tick: try a spool replay below
                if self._stop and not self._queue:
                    return
                if not self._queue:
                    batch = None
                else:
                    batch = self._queue.popleft()
                    self._inflight += 1
            if batch is None:
                try:
                    self._idle_replay()
                except Exception:  # noqa: BLE001 — worker must survive
                    self._bump("worker_errors")
                continue
            kind, payloads = batch
            try:
                self._process(kind, payloads)
            except Exception:  # noqa: BLE001 — a dying worker would
                # stall delivery forever; count it and keep draining.
                self._bump("worker_errors")
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._observer.queue_depth(len(self._queue) + self._inflight)
                    self._cond.notify_all()

    def _idle_replay(self) -> None:
        """Replay the spool while idle — recovery without new traffic."""
        if self._spool.pending_bytes() == 0:
            return
        if not self._breaker.allow():
            return
        try:
            contacted = self._replay()
        except SinkError:
            self._breaker.record_failure()
            return
        if contacted:
            self._breaker.record_success()
        else:
            # Nothing reached the sink (e.g. only torn lines drained):
            # no verdict either way, just free the half-open probe slot.
            self._breaker.release_probe()

    def _process(self, kind: str, payloads: list[dict]) -> None:
        attempt = 0
        while True:
            if not self._breaker.allow():
                self._spool_batch(kind, payloads)
                return
            try:
                self._sink.send(kind, payloads)
            except SinkError as exc:
                if not exc.retryable:
                    # A 4xx verdict proves the sink is reachable and
                    # responding — the breaker guards availability, not
                    # payload validity.
                    self._breaker.record_success()
                    self._dead_letter(kind, payloads, "non_retryable", str(exc))
                    return
                self._breaker.record_failure()
                attempt += 1
                self._bump("retries")
                self._observer.retried(len(payloads))
                if attempt >= self._max_attempts:
                    self._spool_batch(kind, payloads)
                    return
                self._sleep(
                    full_jitter_delay(
                        attempt - 1, self._base_delay_s, self._max_delay_s,
                        self._rng,
                    )
                )
                continue
            except Exception as exc:  # noqa: BLE001 — sink bug = poison batch
                self._breaker.record_failure()
                self._dead_letter(kind, payloads, "sink_exception", repr(exc))
                return
            self._breaker.record_success()
            self._bump("delivered_events", len(payloads))
            self._observer.delivered(kind, len(payloads))
            if self._spool.pending_bytes():
                try:
                    self._replay()
                except SinkError as exc:
                    self._breaker.record_failure()
                    _ = exc  # retryable: records stay spooled for later
            return

    # ---- spool / dead-letter ------------------------------------------

    def _spool_batch(self, kind: str, payloads: list[dict]) -> None:
        try:
            self._spool.append(
                {"ts": self._walltime(), "kind": kind, "payloads": payloads}
            )
        except OSError as exc:
            # Disk full / spool dir gone: the batch cannot be persisted,
            # but the loss must still be counted, not crash the worker.
            self._dead_letter(kind, payloads, "spool_error", repr(exc))
            return
        self._bump("spooled_events", len(payloads))
        self._observer.spooled(kind, len(payloads))
        self._observer.spool_bytes(self._spool.pending_bytes())

    def _replay(self) -> int:
        """Drain the spool through the sink; raises SinkError to abort.

        Returns the number of records that actually contacted the sink
        (delivered or rejected as poison) — zero means no verdict on
        sink health can be drawn from this drain.
        """
        contacted = 0

        def handle(record: dict[str, Any]) -> None:
            nonlocal contacted
            kind = record.get("kind", "")
            payloads = record.get("payloads") or []
            try:
                self._sink.send(kind, payloads)
            except SinkError as exc:
                if not exc.retryable:
                    contacted += 1  # the sink answered, with a rejection
                    self._dead_letter(kind, payloads, "non_retryable", str(exc))
                    return  # poison: skip and keep draining
                raise
            contacted += 1
            self._bump("replayed_events", len(payloads))
            self._bump("delivered_events", len(payloads))
            self._observer.replayed(len(payloads))
            self._observer.delivered(kind, len(payloads))

        try:
            self._spool.drain(handle)
        finally:
            self._observer.spool_bytes(self._spool.pending_bytes())
        return contacted

    def _dead_letter(
        self, kind: str, payloads: list[dict], reason: str, detail: str = ""
    ) -> None:
        """Record a poison batch: ``reason`` is a bounded class (metric
        label), ``detail`` the free-form sink verdict (triage)."""
        record = {
            "ts": self._walltime(),
            "sink": self.name,
            "kind": kind,
            "reason": reason,
            "detail": detail,
            "payloads": payloads,
        }
        try:
            with open(self._dead_letter_path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(record, separators=(",", ":")) + "\n")
        except OSError:
            pass  # the counter below still records the loss
        self._bump("dead_lettered_events", len(payloads))
        self._observer.dead_lettered(kind, len(payloads), reason)

    def _on_truncate(self, batches: int) -> None:
        self._bump("truncated_batches", batches)
        self._observer.truncated(batches)

    # ---- introspection ------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Point-in-time stats for logs and tests."""
        with self._lock:
            depth = len(self._queue) + self._inflight
        return {
            "sink": self.name,
            "breaker": self._breaker.state,
            "breaker_value": STATE_VALUES[self._breaker.state],
            "queue_depth": depth,
            "spool_bytes": self._spool.pending_bytes(),
            **self.stats,
        }
