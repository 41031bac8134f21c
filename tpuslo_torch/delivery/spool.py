"""Segmented JSONL disk spool: the delivery layer's write-ahead log.

Batches that cannot be delivered (breaker open, retries exhausted) are
appended here and replayed oldest-first once the sink recovers.  The
spool is a directory of append-only segment files so truncation under
the size/age caps drops whole old segments instead of rewriting files,
and a crash mid-append corrupts at most the final line of one segment
(torn lines are skipped on read).

Bookkeeping is O(1) on the append path: per-segment size, record
count, and seal time are cached in memory (seeded by one directory
scan at startup), so the caps never re-stat or re-read the directory
while the agent is already degraded — exactly when it must stay under
its CPU budget.

Delivery semantics are at-least-once: a crash or a retryable failure
mid-segment replays the whole segment again later.  The events carry
stable identities (event_id / ts + signal), so downstream consumers
dedupe; that is the standard OTLP collector contract.

The port's own copy of ``tpuslo/delivery/spool.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator

_SEGMENT_PREFIX = "seg-"
_SEGMENT_SUFFIX = ".jsonl"


@dataclass
class _SegmentInfo:
    path: Path
    bytes: int
    records: int
    sealed_at: float  # walltime when sealed (startup scan time for
    #                   pre-existing segments)


class DiskSpool:
    """Size/age-capped segmented JSONL WAL for undelivered batches."""

    def __init__(
        self,
        directory: str | os.PathLike,
        segment_max_bytes: int = 256 * 1024,
        max_bytes: int = 64 * 1024 * 1024,
        max_age_s: float = 24 * 3600.0,
        walltime: Callable[[], float] = time.time,
        on_truncate: Callable[[int], None] | None = None,
    ):
        self._dir = Path(directory)
        self._dir.mkdir(parents=True, exist_ok=True)
        self._segment_max_bytes = max(4096, segment_max_bytes)
        self._max_bytes = max_bytes
        self._max_age_s = max_age_s
        self._walltime = walltime
        self._on_truncate = on_truncate
        # Guards the segment bookkeeping: the channel's submit path
        # (queue-overflow spill) and its worker thread both append.
        # Never held across network sends — drain snapshots the sealed
        # segment list under the lock, then replays lock-free.
        self._lock = threading.Lock()
        # Startup scan: one stat + one line count per leftover segment
        # (a previous run's outage window being re-adopted).
        now = self._walltime()
        self._sealed: list[_SegmentInfo] = []
        for path in sorted(
            self._dir.glob(f"{_SEGMENT_PREFIX}*{_SEGMENT_SUFFIX}")
        ):
            try:
                size = path.stat().st_size
            except OSError:
                continue
            records = sum(1 for _ in self._read_segment(path))
            self._sealed.append(_SegmentInfo(path, size, records, now))
        self._seq = (
            int(self._sealed[-1].path.stem[len(_SEGMENT_PREFIX):]) + 1
            if self._sealed
            else 1
        )
        self._active: Path | None = None
        self._active_fh = None
        self._active_bytes = 0
        self._active_records = 0
        # Segments currently being replayed lock-free by drain(): cap
        # eviction must not unlink them (their records would be counted
        # truncated even though they were just delivered).
        self._draining: set[Path] = set()

    # ---- write side ---------------------------------------------------

    def append(self, record: dict[str, Any]) -> None:
        """Durably append one batch record (fsync-free, flush per line).

        May raise ``OSError`` (disk full, spool dir removed) — the
        channel downgrades that to a dead-letter count.
        """
        line = json.dumps(record, separators=(",", ":")) + "\n"
        encoded = line.encode("utf-8")
        with self._lock:
            if (
                self._active_fh is None
                or self._active_bytes + len(encoded) > self._segment_max_bytes
            ):
                self._roll_locked()
            self._active_fh.write(line)
            self._active_fh.flush()
            self._active_bytes += len(encoded)
            self._active_records += 1
            dropped = self._enforce_caps_locked()
        if dropped and self._on_truncate is not None:
            self._on_truncate(dropped)

    def _roll_locked(self) -> None:
        self._seal_locked()
        self._active = self._dir / f"{_SEGMENT_PREFIX}{self._seq:08d}{_SEGMENT_SUFFIX}"
        self._seq += 1
        self._active_fh = open(self._active, "a", encoding="utf-8")
        self._active_bytes = 0
        self._active_records = 0

    def seal(self) -> None:
        """Close the active segment so readers (and replay) see it."""
        with self._lock:
            self._seal_locked()

    def _seal_locked(self) -> None:
        if self._active_fh is not None:
            self._active_fh.close()
            self._sealed.append(
                _SegmentInfo(
                    self._active,
                    self._active_bytes,
                    self._active_records,
                    self._walltime(),
                )
            )
            self._active_fh = None
            self._active = None
            self._active_bytes = 0
            self._active_records = 0

    # ---- capping ------------------------------------------------------

    def _enforce_caps_locked(self) -> int:
        """Drop oldest sealed segments over the size/age caps.

        The active segment is never truncated: the newest evidence is
        the most valuable, so pressure evicts history first.  Returns
        the number of batch records dropped (all from cached counts —
        no file reads on this path).
        """
        dropped = 0
        now = self._walltime()
        if self._max_age_s > 0:
            for info in list(self._sealed):
                if info.path in self._draining:
                    continue
                if now - info.sealed_at > self._max_age_s:
                    dropped += self._drop_locked(info)
        if self._max_bytes > 0:
            total = (
                sum(s.bytes for s in self._sealed) + self._active_bytes
            )
            for info in list(self._sealed):
                if total <= self._max_bytes:
                    break
                if info.path in self._draining:
                    continue
                total -= info.bytes
                dropped += self._drop_locked(info)
        return dropped

    def _drop_locked(self, info: _SegmentInfo) -> int:
        self._sealed.remove(info)
        try:
            info.path.unlink()
        except OSError:
            pass
        return info.records

    # ---- read side ----------------------------------------------------

    @staticmethod
    def _read_segment(segment: Path) -> Iterator[dict[str, Any]]:
        try:
            with open(segment, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn final line from a crash mid-append
        except OSError:
            return

    def pending_bytes(self) -> int:
        with self._lock:
            return sum(s.bytes for s in self._sealed) + self._active_bytes

    def pending_batches(self) -> int:
        with self._lock:
            return (
                sum(s.records for s in self._sealed) + self._active_records
            )

    def drain(
        self,
        handler: Callable[[dict[str, Any]], None],
        max_segments: int = 0,
    ) -> int:
        """Replay records oldest-first; delete each fully-handled segment.

        ``handler`` raising aborts the drain (already-handled records in
        the current segment will be re-sent on the next drain — the
        at-least-once contract).  Returns the number of records handled.

        The sealed-segment snapshot is taken under the lock; the replay
        itself runs lock-free so concurrent appends (which go to a new
        active segment) never wait on the network.
        """
        with self._lock:
            self._seal_locked()
            snapshot = list(self._sealed)
            self._draining.update(info.path for info in snapshot)
        handled = 0
        try:
            for i, info in enumerate(snapshot):
                if max_segments and i >= max_segments:
                    break
                for record in self._read_segment(info.path):
                    handler(record)
                    handled += 1
                with self._lock:
                    try:
                        info.path.unlink()
                    except OSError:
                        pass
                    if info in self._sealed:
                        self._sealed.remove(info)
                    self._draining.discard(info.path)
        finally:
            with self._lock:
                for info in snapshot:
                    self._draining.discard(info.path)
        return handled

    def close(self) -> None:
        self.seal()
