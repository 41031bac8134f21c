"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and includes no
PyTorch header, so one ``nvcc`` call builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

Sources may include the shared headers ``csrc/*.cuh`` (``hopper.cuh``:
cp.async, mbarrier, TMA and wgmma helpers).  The library goes to
``build/tpuslo_torch/<name>-<hash>/`` at the root of the checkout (listed
in ``.gitignore``), keyed by a hash of the source, every header under
``csrc/`` and the flags, and is built at first use.  ``ptxas``'s report
(registers, shared memory, spills) is kept beside it in ``ptxas.log``.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tpuslo_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuildInfo:
    """Where a library lives and what building it cost."""

    path: Path
    seconds: float  # 0.0 when an earlier build with the same hash was reused
    ptxas: str  # ptxas -v report of the build that produced ``path``


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH); the "
        "port's CUDA kernels are built from source at first use"
    )


def source_digest(name: str) -> str:
    """Hash of what a build of ``csrc/<name>.cu`` depends on: the source,
    every ``*.cuh`` header under ``csrc/`` (by name and content) and the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a build of the same source,
    headers and flags exists; return where the library is."""
    src = CSRC / f"{name}.cu"
    out_dir = BUILD_ROOT / f"{name}-{source_digest(name)}"
    lib = out_dir / f"lib{name}.so"
    log = out_dir / "ptxas.log"
    if lib.exists():
        return BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return BuildInfo(lib, seconds, report)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so`` once per process."""
    return ctypes.CDLL(str(build(name).path))
