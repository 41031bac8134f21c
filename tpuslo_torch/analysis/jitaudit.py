"""Dynamic recapture and host-sync audit for the serving benches (the
port's counterpart of ``tpuslo/analysis/jitaudit.py``).

JAX compiles each serving program once and the reference auditor counts
XLA compiles from ``jax.monitoring``; a compile inside a steady section
is a retrace.  The port has no compiler: on a card each speculative
dispatch is a CUDA graph captured once
(:class:`tpuslo_torch.models.graphs.GraphedDispatch`), so the
counts mean:

* **a steady compile is a recapture**: a capture of a key that its owner
  (an engine) already holds, or a capture by a front door after its
  first dispatch (inside ``step()``: a front door captures only when it
  is built).  The port does not imitate XLA's compile log;
* **a host sync** is a :class:`tpuslo_torch.models.serve._HostRead`
  read (the one fused read of a dispatch, as ``jax.device_get`` is in
  JAX), or a call that PyTorch's sync debug mode reports as
  synchronizing, such as a copy from pageable host memory.

On the CPU nothing is captured and PyTorch reports no synchronizing
call: the capture and recapture counts are 0 and the sync count is the
reads alone.  Only what the two benches call is ported: :func:`install`,
:func:`uninstall`, :func:`installed`, :func:`registry`, and on the
registry :meth:`JitAuditRegistry.steady_compile_count` and
:meth:`JitAuditRegistry.host_sync_count`.
"""

from __future__ import annotations

import threading
import warnings
import weakref
from dataclasses import dataclass

import torch

#: The substring of PyTorch's sync debug warnings.
_SYNC_MARK = "synchroniz"


@dataclass(slots=True)
class CaptureEvent:
    key: str
    capture_ms: float
    recapture: bool


class JitAuditRegistry:
    """Capture, read and sync counters.  Process-global when installed
    through :func:`install`; tests may build their own and drive the
    ``on_*`` hooks directly."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.captures: list[CaptureEvent] = []
        # Keys each live owner holds (weakly: a freed engine's id() may
        # come back for a new one, which holds nothing yet).
        self._held: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self.host_reads = 0
        self.syncs = 0

    def on_capture(self, owner, key: str, capture_ms: float) -> None:
        """A capture of ``key`` by ``owner`` (an engine; ``None`` holds
        nothing)."""
        from tpuslo_torch.models.frontdoor import FrontDoorEngine

        dispatched = isinstance(owner, FrontDoorEngine) and owner.rounds > 0
        with self._mu:
            held = self._held.setdefault(owner, set()) if owner is not None else set()
            recapture = dispatched or key in held
            held.add(key)
            self.captures.append(CaptureEvent(key, capture_ms, recapture))

    def on_host_read(self) -> None:
        with self._mu:
            self.host_reads += 1

    def on_sync(self) -> None:
        with self._mu:
            self.syncs += 1

    def capture_count(self) -> int:
        with self._mu:
            return len(self.captures)

    def steady_compile_count(self) -> int:
        """Recaptures: the count every serving gate floors at zero."""
        with self._mu:
            return sum(1 for e in self.captures if e.recapture)

    def host_sync_count(self) -> int:
        """Host round trips: fused reads plus synchronizing calls."""
        with self._mu:
            return self.host_reads + self.syncs

    def reset(self) -> None:
        with self._mu:
            self.captures.clear()
            self._held = weakref.WeakKeyDictionary()
            self.host_reads = 0
            self.syncs = 0


_GLOBAL = JitAuditRegistry()
_installed = False
_real_showwarning = None
_sync_mode = None
_sync_filter = None


def registry() -> JitAuditRegistry:
    return _GLOBAL


def installed() -> bool:
    return _installed


def _showwarning(message, category, filename, lineno, file=None, line=None):
    if _SYNC_MARK in str(message):
        _GLOBAL.on_sync()
        return
    _real_showwarning(message, category, filename, lineno, file, line)


def install() -> None:
    """Hook the captures, the fused reads and, on a card, PyTorch's sync
    debug mode (each synchronizing call warns; the warning is counted and
    not shown)."""
    global _installed, _real_showwarning, _sync_mode, _sync_filter
    if _installed:
        return
    from tpuslo_torch.models.serve import _HostRead
    from tpuslo_torch.models.graphs import GraphedDispatch

    GraphedDispatch.on_capture = _GLOBAL.on_capture
    _HostRead.on_read = _GLOBAL.on_host_read
    if torch.cuda.is_available():
        _real_showwarning = warnings.showwarning
        warnings.showwarning = _showwarning
        warnings.filterwarnings("always", message=f".*{_SYNC_MARK}")
        _sync_filter = warnings.filters[0]
        _sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _installed = True


def uninstall() -> None:
    global _installed, _real_showwarning, _sync_mode, _sync_filter
    if not _installed:
        return
    from tpuslo_torch.models.serve import _HostRead
    from tpuslo_torch.models.graphs import GraphedDispatch

    GraphedDispatch.on_capture = None
    _HostRead.on_read = None
    if _real_showwarning is not None:
        torch.cuda.set_sync_debug_mode(_sync_mode)
        warnings.showwarning = _real_showwarning
        if _sync_filter in warnings.filters:
            warnings.filters.remove(_sync_filter)
        _real_showwarning = _sync_mode = _sync_filter = None
    _installed = False
