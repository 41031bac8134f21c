"""Capability-mode autodetection
(the port's own copy of ``tpuslo/signals/mode.py``, with the CUDA tier).

Reference: ``pkg/signals/mode.go:9-31`` — BTF presence selects
``core_full`` vs ``bcc_degraded``.  The TPU-native build adds the top
tier: a host with BTF *and* a visible TPU probe surface (``/dev/accel*``
nodes or a resolvable ``libtpu.so``) runs ``tpu_full``.  The port adds
``cuda_full`` beside it: BTF and a visible CUDA probe surface
(``/dev/nvidia[0-9]*`` nodes or a resolvable ``libcuda.so``), with the
full signal set.  A host with neither surface picks what the JAX package
picks.
"""

from __future__ import annotations

import glob
import os

from tpuslo_torch.signals import constants as sig

BTF_PATH = "/sys/kernel/btf/vmlinux"
DEFAULT_ACCEL_GLOB = "/dev/accel*"
DEFAULT_NVIDIA_GLOB = "/dev/nvidia[0-9]*"
DEFAULT_LIBTPU_CANDIDATES = (
    "/usr/lib/libtpu.so",
    "/lib/libtpu.so",
    "/usr/local/lib/libtpu.so",
)


def has_btf(btf_path: str = BTF_PATH) -> bool:
    return os.path.exists(btf_path)


def find_libtpu(env: dict[str, str] | None = None) -> str:
    """Best-effort libtpu.so discovery (env override, then well-known paths)."""
    env = env if env is not None else dict(os.environ)
    override = env.get("TPU_LIBRARY_PATH", "")
    if override and os.path.exists(override):
        return override
    for candidate in DEFAULT_LIBTPU_CANDIDATES:
        if os.path.exists(candidate):
            return candidate
    return ""


def has_tpu_surface(
    accel_glob: str = DEFAULT_ACCEL_GLOB, env: dict[str, str] | None = None
) -> bool:
    return bool(glob.glob(accel_glob)) or bool(find_libtpu(env))


def has_cuda_surface(
    nvidia_glob: str = DEFAULT_NVIDIA_GLOB,
    env: dict[str, str] | None = None,
    libcuda_paths=None,
) -> bool:
    """``/dev/nvidia[0-9]*`` nodes or a resolvable ``libcuda.so``
    (:func:`tpuslo_torch.collector.symbols.find_libcuda`, searched in
    ``libcuda_paths`` when given)."""
    from tpuslo_torch.collector.symbols import find_libcuda

    return bool(glob.glob(nvidia_glob)) or bool(find_libcuda(libcuda_paths, env=env))


def detect_capability_mode(
    btf_path: str = BTF_PATH,
    accel_glob: str = DEFAULT_ACCEL_GLOB,
    env: dict[str, str] | None = None,
    nvidia_glob: str = DEFAULT_NVIDIA_GLOB,
    libcuda_paths=None,
) -> str:
    """Autodetect the richest supported capability mode for this host."""
    if not has_btf(btf_path):
        return sig.CAPABILITY_BCC_DEGRADED
    if has_tpu_surface(accel_glob, env):
        return sig.CAPABILITY_TPU_FULL
    if has_cuda_surface(nvidia_glob, env, libcuda_paths):
        return sig.CAPABILITY_CUDA_FULL
    return sig.CAPABILITY_CORE_FULL


def parse_capability_mode(raw: str) -> str:
    """Parse a user-supplied mode; ``auto``/empty triggers detection."""
    mode = (raw or "auto").strip().lower()
    if mode == "auto":
        return detect_capability_mode()
    if mode not in sig.CAPABILITY_MODES:
        raise ValueError(
            f"unsupported capability mode {raw!r}; "
            f"expected one of {', '.join(sig.CAPABILITY_MODES)} or 'auto'"
        )
    return mode
