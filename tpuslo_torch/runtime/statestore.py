"""Durable agent-state snapshots: atomic write, bounded-staleness read
(the port's own copy of ``tpuslo/runtime/statestore.py``: plain Python, behaviour identical).

One :class:`StateStore` owns one snapshot file.  Writes are crash-only
safe: the snapshot is serialized to a ``mkstemp`` sibling in the same
directory, fsynced, then ``os.replace``d over the target (and the
directory entry fsynced), so a reader — including the next incarnation
of this agent — sees either the previous complete snapshot or the new
complete snapshot, never a torn one.  ``kill -9`` at any byte offset
cannot corrupt the restore path.

Reads are guarded three ways: a schema version check (a snapshot from
an incompatible build restores nothing rather than something wrong), a
JSON-integrity check (corrupt file → cold start, counted), and a
staleness bound (state older than ``max_age_s`` describes a world that
has moved on — warm-restoring an hours-old dedup window would *cause*
the duplicate admissions it exists to stop).

:class:`AgentRuntime` is the thin registry that turns component-level
``export_state()``/``restore_state()`` hooks into one snapshot
payload, so the agent wires components by name and the store never
learns their shapes.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Callable

SCHEMA_VERSION = 1

# Restore outcome classes (metric label values).
RESTORE_RESTORED = "restored"
RESTORE_COLD = "cold"            # no snapshot on disk (first boot)
RESTORE_STALE = "stale"          # snapshot older than max_age_s
RESTORE_CORRUPT = "corrupt"      # unreadable / not valid JSON
RESTORE_VERSION = "version"      # schema version mismatch
RESTORE_FORCED_COLD = "forced_cold"  # operator asked for --cold-start

DEFAULT_SNAPSHOT_INTERVAL_S = 5.0
DEFAULT_SNAPSHOT_MAX_AGE_S = 300.0


class RuntimeObserver:
    """No-op observer; the agent bridges these to Prometheus."""

    def snapshot_saved(self, size_bytes: int) -> None: ...

    def snapshot_save_failed(self) -> None: ...

    def snapshot_restored(self, outcome: str, age_s: float) -> None: ...

    def probe_restarted(self, signal: str) -> None: ...

    def flap_shed(self, signal: str) -> None: ...

    def drain(self, outcome: str, duration_s: float) -> None: ...


class StateStore:
    """Atomic, versioned, staleness-bounded snapshot file."""

    def __init__(
        self,
        path: str | os.PathLike,
        interval_s: float = DEFAULT_SNAPSHOT_INTERVAL_S,
        max_age_s: float = DEFAULT_SNAPSHOT_MAX_AGE_S,
        walltime: Callable[[], float] = time.time,
        observer: RuntimeObserver | None = None,
    ):
        self.path = os.fspath(path)
        self.interval_s = interval_s
        self.max_age_s = max_age_s
        self._walltime = walltime
        self._observer = observer or RuntimeObserver()
        self._last_save = 0.0
        self.saves = 0
        self.save_errors = 0
        self.last_size_bytes = 0
        self.restore_outcome = ""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    # ---- write side ---------------------------------------------------

    def save(self, components: dict[str, Any]) -> bool:
        """Atomically persist one snapshot; False on (counted) failure.

        A failed save never raises into the agent loop: losing one
        snapshot interval is survivable, crashing the agent over it is
        exactly the fragility this store exists to remove.
        """
        payload = {
            "schema_version": SCHEMA_VERSION,
            "saved_at": self._walltime(),
            "components": components,
        }
        directory = os.path.dirname(self.path) or "."
        try:
            encoded = json.dumps(payload, separators=(",", ":")).encode(
                "utf-8"
            )
            fd, tmp_path = tempfile.mkstemp(
                prefix=".snapshot-", suffix=".tmp", dir=directory
            )
            try:
                with os.fdopen(fd, "wb") as fh:
                    fh.write(encoded)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp_path, self.path)
            except BaseException:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
                raise
            # Durability of the rename itself: fsync the directory so
            # the new entry survives a host power cut, not just a
            # process kill.
            try:
                dir_fd = os.open(directory, os.O_RDONLY)
                try:
                    os.fsync(dir_fd)
                finally:
                    os.close(dir_fd)
            except OSError:
                pass  # platform without directory fsync; rename stands
        except (OSError, TypeError, ValueError):
            self.save_errors += 1
            self._observer.snapshot_save_failed()
            return False
        self.saves += 1
        self.last_size_bytes = len(encoded)
        self._last_save = self._walltime()
        self._observer.snapshot_saved(len(encoded))
        return True

    def maybe_save(self, components_fn: Callable[[], dict[str, Any]]) -> bool:
        """Interval-gated save; ``interval_s <= 0`` saves every call."""
        now = self._walltime()
        if self.interval_s > 0 and now - self._last_save < self.interval_s:
            return False
        return self.save(components_fn())

    # ---- read side ----------------------------------------------------

    def load(self) -> tuple[str, dict[str, Any], float]:
        """Read the snapshot: ``(outcome, components, age_s)``.

        ``components`` is empty for every outcome except
        :data:`RESTORE_RESTORED`.
        """
        try:
            with open(self.path, "rb") as fh:
                payload = json.loads(fh.read().decode("utf-8"))
        except FileNotFoundError:
            return RESTORE_COLD, {}, 0.0
        except (OSError, ValueError, UnicodeDecodeError):
            return RESTORE_CORRUPT, {}, 0.0
        if not isinstance(payload, dict):
            return RESTORE_CORRUPT, {}, 0.0
        if payload.get("schema_version") != SCHEMA_VERSION:
            return RESTORE_VERSION, {}, 0.0
        try:
            age_s = max(0.0, self._walltime() - float(payload["saved_at"]))
        except (KeyError, TypeError, ValueError):
            return RESTORE_CORRUPT, {}, 0.0
        if self.max_age_s > 0 and age_s > self.max_age_s:
            return RESTORE_STALE, {}, age_s
        components = payload.get("components")
        if not isinstance(components, dict):
            return RESTORE_CORRUPT, {}, 0.0
        return RESTORE_RESTORED, components, age_s

    def age_s(self) -> float:
        """Seconds since the last successful save (inf before the first)."""
        if self._last_save <= 0:
            return float("inf")
        return max(0.0, self._walltime() - self._last_save)


class AgentRuntime:
    """Named export/restore hooks assembled into one snapshot.

    Components register ``(export_fn, restore_fn)`` pairs; restore
    failures are isolated per component (one incompatible section
    degrades that component to cold, not the whole agent) and counted.
    """

    def __init__(
        self,
        store: StateStore | None,
        observer: RuntimeObserver | None = None,
        log: Callable[[str], None] | None = None,
    ):
        self.store = store
        self._observer = observer or RuntimeObserver()
        self._log = log or (lambda msg: None)
        self._exporters: dict[str, Callable[[], Any]] = {}
        self._restorers: dict[str, Callable[[Any], None]] = {}
        self.restore_outcome = ""
        self.restored_components: list[str] = []
        self.restore_errors: list[str] = []
        self.restored_age_s = 0.0
        # Sections loaded before their component registered (the ring
        # loop builds its ProbeManager after restore runs): applied at
        # registration time.
        self._pending_state: dict[str, Any] = {}

    @property
    def enabled(self) -> bool:
        return self.store is not None

    def register(
        self,
        name: str,
        export: Callable[[], Any],
        restore: Callable[[Any], None],
    ) -> None:
        """Register hooks; a pending restored section applies now."""
        self._exporters[name] = export
        self._restorers[name] = restore
        if name in self._pending_state:
            self._apply(name, restore, self._pending_state.pop(name))

    def deregister(self, name: str) -> None:
        """Drop a component's hooks (e.g. a killed aggregator shard).

        Later snapshots must not keep persisting the dead component's
        pre-death state — a restore from such a snapshot would revive
        state the system already migrated elsewhere.
        """
        self._exporters.pop(name, None)
        self._restorers.pop(name, None)

    # ---- snapshot assembly --------------------------------------------

    def export_components(self) -> dict[str, Any]:
        components: dict[str, Any] = {}
        for name, export in self._exporters.items():
            try:
                components[name] = export()
            except Exception as exc:  # noqa: BLE001 — one component's
                # export bug must not kill the whole snapshot.
                self._log(f"runtime: export of {name!r} failed: {exc!r}")
        return components

    def maybe_snapshot(self) -> bool:
        if self.store is None:
            return False
        return self.store.maybe_save(self.export_components)

    def snapshot_now(self) -> bool:
        """Unconditional save (drain path, alert watermark updates)."""
        if self.store is None:
            return False
        return self.store.save(self.export_components())

    # ---- restore ------------------------------------------------------

    def restore(self, cold_start: bool = False) -> str:
        """Load + fan out the snapshot; returns the outcome class."""
        if self.store is None:
            self.restore_outcome = RESTORE_COLD
            return self.restore_outcome
        if cold_start:
            self.restore_outcome = RESTORE_FORCED_COLD
            self._observer.snapshot_restored(RESTORE_FORCED_COLD, 0.0)
            return self.restore_outcome
        outcome, components, age_s = self.store.load()
        self.restore_outcome = outcome
        self.restored_age_s = age_s
        if outcome == RESTORE_RESTORED:
            for name, state in components.items():
                restore = self._restorers.get(name)
                if restore is None:
                    self._pending_state[name] = state
                    continue
                self._apply(name, restore, state)
        self._observer.snapshot_restored(outcome, age_s)
        return outcome

    def _apply(
        self, name: str, restore: Callable[[Any], None], state: Any
    ) -> None:
        try:
            restore(state)
            self.restored_components.append(name)
        except Exception as exc:  # noqa: BLE001 — per-component
            # isolation: a bad section costs that component only.
            self.restore_errors.append(name)
            self._log(f"runtime: restore of {name!r} failed: {exc!r}")


def repair_jsonl_tail(path: str | os.PathLike) -> int:
    """Truncate a trailing torn line from an append-mode JSONL file.

    ``kill -9`` mid-write leaves the file ending in a partial record
    with no terminating newline; appending the next run's output to it
    would weld two records into one corrupt mid-file line — the one
    torn-line shape readers cannot skip cheaply.  The partial record
    was never durable (its writer died before finishing it), so the
    honest repair is to drop it and account for it.  Returns the number
    of bytes truncated (0 when the file is absent, empty, or clean).
    """
    path = os.fspath(path)
    try:
        with open(path, "rb+") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size == 0:
                return 0
            fh.seek(size - 1)
            if fh.read(1) == b"\n":
                return 0
            # Scan back (bounded chunks) for the last newline.
            chunk = 4096
            pos = size
            keep = 0
            while pos > 0:
                step = min(chunk, pos)
                fh.seek(pos - step)
                data = fh.read(step)
                idx = data.rfind(b"\n")
                if idx >= 0:
                    keep = pos - step + idx + 1
                    break
                pos -= step
            fh.truncate(keep)
            return size - keep
    except OSError:
        return 0
