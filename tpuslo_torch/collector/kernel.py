"""Kernel privilege probe: can this process create BPF objects?

Reference: ``pkg/collector/kernel.go:18-39`` (``ProbeSmokeCheck``
creates a real BPF map as a privilege probe).  Implemented via the raw
``bpf(2)`` syscall through ctypes so the check needs no compiled
bindings.

The port's own copy of ``tpuslo/collector/kernel.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import platform
from dataclasses import dataclass

BPF_MAP_CREATE = 0
BPF_MAP_TYPE_ARRAY = 2

_SYSCALL_NR = {
    "x86_64": 321,
    "aarch64": 280,
}


class _BpfMapCreateAttr(ctypes.Structure):
    _fields_ = [
        ("map_type", ctypes.c_uint32),
        ("key_size", ctypes.c_uint32),
        ("value_size", ctypes.c_uint32),
        ("max_entries", ctypes.c_uint32),
        ("map_flags", ctypes.c_uint32),
    ]


@dataclass
class SmokeResult:
    ok: bool
    detail: str


def probe_smoke_check() -> SmokeResult:
    """Try to create (and immediately close) a tiny BPF array map."""
    nr = _SYSCALL_NR.get(platform.machine())
    if nr is None:
        return SmokeResult(False, f"unsupported architecture {platform.machine()}")
    libc_path = ctypes.util.find_library("c")
    if not libc_path:
        return SmokeResult(False, "libc not found")
    libc = ctypes.CDLL(libc_path, use_errno=True)

    attr = _BpfMapCreateAttr(
        map_type=BPF_MAP_TYPE_ARRAY,
        key_size=4,
        value_size=8,
        max_entries=1,
        map_flags=0,
    )
    fd = libc.syscall(
        ctypes.c_long(nr),
        ctypes.c_int(BPF_MAP_CREATE),
        ctypes.byref(attr),
        ctypes.c_size_t(ctypes.sizeof(attr)),
    )
    if fd < 0:
        err = ctypes.get_errno()
        return SmokeResult(
            False,
            f"bpf(BPF_MAP_CREATE) failed: {errno.errorcode.get(err, err)} "
            f"({os.strerror(err)})",
        )
    os.close(fd)
    return SmokeResult(True, "created and closed a BPF array map")
