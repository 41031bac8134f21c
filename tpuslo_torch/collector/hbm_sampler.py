"""HBM utilization sampler — a level, not an event (the port's counterpart
of ``tpuslo/collector/hbm_sampler.py``).

``hbm_utilization_pct`` has no probe: allocator call sites only see
deltas, so utilization is sampled from the device runtime's statistics
and injected into the same ring the probes feed, keeping one consumer
path.

Sources, in priority order:

1. a JSON stats file exported by a serving runtime
   (``TPUSLO_HBM_STATS_PATH``), with ``bytes_in_use`` / ``bytes_limit``
   keys;
2. the live CUDA device of this process.  Bytes in use is
   ``torch.cuda.memory_allocated()``: the bytes of live tensors the
   caching allocator has handed out, which answers to JAX's
   ``bytes_in_use`` (bytes of live buffers).  ``memory_reserved()`` is
   not used: it also counts the free blocks the allocator keeps cached,
   which no tensor holds.  The limit is the card's total memory from
   ``torch.cuda.mem_get_info()`` (what the allocator can grow to, JAX's
   ``bytes_limit``), not its free memory, which moves with the cache.

On a box without a card the live source returns ``None`` and records
why in :data:`LAST_PROBE_ERROR`: the reference's "no accelerator" miss,
never a reading of host memory.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from tpuslo_torch.collector import native
from tpuslo_torch.collector.ringbuf import RingWriter

# Once a live-device probe times out (a hung driver), stop retrying for
# the life of the process: every retry would park another worker thread
# inside the hung runtime for nothing.
_DEVICE_PROBE_DEAD = False

# Most recent live-probe miss or failure (a reason string, or the repr
# of the exception), or None while probes succeed / have not run.  "No
# card" is this probe's normal miss, so nothing is printed — but the
# reason stays inspectable instead of being swallowed.
LAST_PROBE_ERROR: str | None = None

NO_DEVICE = "no CUDA device (torch.cuda.is_available() is False)"


def _read_device() -> tuple[int, int] | None:
    """(bytes in use, bytes limit) of the current CUDA device, or None
    with the reason in :data:`LAST_PROBE_ERROR`."""
    global LAST_PROBE_ERROR
    import torch

    if not torch.cuda.is_available():
        LAST_PROBE_ERROR = NO_DEVICE
        return None
    device = torch.cuda.current_device()
    _free, total = torch.cuda.mem_get_info(device)
    return int(torch.cuda.memory_allocated(device)), int(total)


def read_stats(path: str | None = None, live: bool = True) -> tuple[int, int] | None:
    """Return (bytes_in_use, bytes_limit) or None.  ``live=False`` reads
    the stats file alone and never touches a device."""
    stats_path = path or os.environ.get("TPUSLO_HBM_STATS_PATH", "")
    if stats_path and os.path.exists(stats_path):
        try:
            with open(stats_path, "r", encoding="utf-8") as fh:
                raw = json.load(fh)
            return int(raw["bytes_in_use"]), int(raw["bytes_limit"])
        except (OSError, ValueError, KeyError):
            return None
    if not live:
        return None
    # Live device stats behind a join-timeout worker: a hung driver makes
    # the first CUDA call block with no exception for the except to
    # catch, and a wedged sampler would stall the loop it feeds.
    global _DEVICE_PROBE_DEAD
    if _DEVICE_PROBE_DEAD:
        return None

    box: dict[str, tuple[int, int] | None] = {"stats": None}

    def probe():
        global LAST_PROBE_ERROR
        # Reset up front so a miss below does not keep a previous run's
        # exception misattributed to this one.
        LAST_PROBE_ERROR = None
        try:
            box["stats"] = _read_device()
        except Exception as exc:  # noqa: BLE001 — recorded, not swallowed:
            # a runtime bug must stay distinguishable from "no card".
            LAST_PROBE_ERROR = repr(exc)

    try:
        timeout_s = float(os.environ.get("TPUSLO_HBM_PROBE_TIMEOUT_S", 60))
    except ValueError:
        timeout_s = 60.0
    thread = threading.Thread(target=probe, daemon=True)
    thread.start()
    thread.join(timeout=timeout_s)
    if thread.is_alive():
        _DEVICE_PROBE_DEAD = True
        print(
            f"hbm_sampler: device probe exceeded {timeout_s}s (runtime "
            "hang); live HBM sampling disabled for this process",
            file=sys.stderr,
        )
    return box["stats"]


class HBMSampler:
    """Periodically writes utilization basis points into a ring."""

    def __init__(self, ring_path: str, stats_path: str | None = None, live: bool = True):
        self._writer = RingWriter(ring_path)
        self._stats_path = stats_path
        self._live = live
        self.samples = 0

    def sample_once(self) -> bool:
        stats = read_stats(self._stats_path, live=self._live)
        if stats is None:
            return False
        in_use, limit = stats
        basis_points = min(int(10000 * in_use / limit), 10000)
        ok = self._writer.write_event(
            signal=native.SIG_HBM_UTILIZATION,
            value=basis_points,
            ts_ns=time.time_ns(),
            pid=os.getpid(),
            flags=native.F_TPU,
            comm=b"hbm_sampler",
        )
        if ok:
            self.samples += 1
        return ok

    def close(self) -> None:
        self._writer.close()
