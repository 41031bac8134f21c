"""ctypes binding to the repo's native runtime (``native/libtpuslo_runtime.so``):
the port's own copy of the parts of ``tpuslo/collector/native.py`` that a
ring producer and the probe manager call (``load_runtime``,
``runtime_available``, ``pack_event``, the ``tpuslo_pm_*`` attach entry
points, the signal id and flag constants).

The runtime owns the ring-buffer transport; this module locates it
(building it on demand with ``make -C native`` if needed), loads it and
packs the flat wire event.  The struct layout here MUST match
``ebpf/c/tpuslo_event.h`` (``WireEvent``); ``load_runtime`` checks the
size against the library's own.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO_ROOT / "native"
_LIB_NAME = "libtpuslo_runtime.so"

EVENT_BYTES = 72

# Signal ids — mirror of ``enum tpuslo_signal_id`` (contract values).
SIG_DNS_LATENCY = 1
SIG_TCP_RETRANSMIT = 2
SIG_RUNQ_DELAY = 3
SIG_CONNECT_LATENCY = 4
SIG_TLS_HANDSHAKE = 5
SIG_CPU_STEAL = 6
SIG_MEM_RECLAIM = 7
SIG_DISK_IO = 8
SIG_SYSCALL_LATENCY = 9
SIG_XLA_COMPILE = 16
SIG_HBM_ALLOC_STALL = 17
SIG_HBM_UTILIZATION = 18
SIG_ICI_LINK_RETRY = 19
SIG_ICI_COLLECTIVE = 20
SIG_HOST_OFFLOAD = 21
SIG_DCN_TRANSFER = 22

# Flags — mirror of TPUSLO_F_*.
F_TPU = 0x0008


class WireEvent(ctypes.Structure):
    """Mirror of ``struct tpuslo_event`` (packed, 72 bytes)."""

    _pack_ = 1
    _fields_ = [
        ("ts_ns", ctypes.c_uint64),
        ("value", ctypes.c_uint64),
        ("aux", ctypes.c_uint64),
        ("pid", ctypes.c_uint32),
        ("tid", ctypes.c_uint32),
        ("saddr4", ctypes.c_uint32),
        ("daddr4", ctypes.c_uint32),
        ("sport", ctypes.c_uint16),
        ("dport", ctypes.c_uint16),
        ("signal", ctypes.c_uint16),
        ("flags", ctypes.c_uint16),
        ("err", ctypes.c_int16),
        ("comm", ctypes.c_char * 16),
        ("_pad", ctypes.c_uint16 * 3),
    ]


class NativeRuntimeError(RuntimeError):
    """The native runtime could not be built or loaded."""


_lib: ctypes.CDLL | None = None


def _configure(lib: ctypes.CDLL) -> None:
    lib.tpuslo_ring_create.restype = ctypes.c_void_p
    lib.tpuslo_ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tpuslo_ring_write.restype = ctypes.c_int
    lib.tpuslo_ring_write.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
    ]
    lib.tpuslo_ring_dropped.restype = ctypes.c_uint64
    lib.tpuslo_ring_dropped.argtypes = [ctypes.c_void_p]
    lib.tpuslo_ring_close.argtypes = [ctypes.c_void_p]

    lib.tpuslo_pm_available.restype = ctypes.c_int
    lib.tpuslo_pm_new.restype = ctypes.c_void_p
    lib.tpuslo_pm_free.argtypes = [ctypes.c_void_p]
    lib.tpuslo_pm_load.restype = ctypes.c_int
    lib.tpuslo_pm_load.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.tpuslo_pm_ringbuf_fd.restype = ctypes.c_int
    lib.tpuslo_pm_ringbuf_fd.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tpuslo_pm_attach_auto.restype = ctypes.c_int
    lib.tpuslo_pm_attach_auto.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tpuslo_pm_attach_kprobe.restype = ctypes.c_int
    lib.tpuslo_pm_attach_kprobe.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int,
    ]
    lib.tpuslo_pm_attach_uprobe.restype = ctypes.c_int
    lib.tpuslo_pm_attach_uprobe.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
    ]
    lib.tpuslo_pm_detach_object.restype = ctypes.c_int
    lib.tpuslo_pm_detach_object.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tpuslo_pm_last_error.restype = ctypes.c_char_p
    lib.tpuslo_pm_last_error.argtypes = [ctypes.c_void_p]

    lib.tpuslo_event_size.restype = ctypes.c_int


def load_runtime(build: bool = True) -> ctypes.CDLL:
    """Load (building if necessary) the native runtime library."""
    global _lib
    if _lib is not None:
        return _lib

    lib_path = Path(
        os.environ.get("TPUSLO_RUNTIME_LIB", _NATIVE_DIR / _LIB_NAME)
    )
    if not lib_path.exists() and build and (_NATIVE_DIR / "Makefile").exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=300,
            )
        except (subprocess.SubprocessError, OSError) as exc:
            raise NativeRuntimeError(
                f"failed to build native runtime: {exc}"
            ) from exc
    if not lib_path.exists():
        raise NativeRuntimeError(f"native runtime not found at {lib_path}")

    lib = ctypes.CDLL(str(lib_path))
    _configure(lib)
    wire = lib.tpuslo_event_size()
    if wire != ctypes.sizeof(WireEvent):
        raise NativeRuntimeError(
            f"wire-event size drift: native={wire} python="
            f"{ctypes.sizeof(WireEvent)}"
        )
    _lib = lib
    return lib


def runtime_available() -> bool:
    try:
        load_runtime()
        return True
    except NativeRuntimeError:
        return False


def pack_event(
    signal: int,
    value: int,
    *,
    ts_ns: int = 0,
    aux: int = 0,
    pid: int = 0,
    tid: int = 0,
    saddr4: int = 0,
    daddr4: int = 0,
    sport: int = 0,
    dport: int = 0,
    flags: int = 0,
    err: int = 0,
    comm: bytes = b"",
) -> bytes:
    """Pack one wire event."""
    ev = WireEvent(
        ts_ns=ts_ns,
        value=value,
        aux=aux,
        pid=pid,
        tid=tid,
        saddr4=saddr4,
        daddr4=daddr4,
        sport=sport,
        dport=dport,
        signal=signal,
        flags=flags,
        err=err,
        comm=comm[:15],
    )
    return bytes(ev)
