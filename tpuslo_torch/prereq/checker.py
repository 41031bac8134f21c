"""Host prerequisite checks for running the agent with real probes (the
port's copy of ``tpuslo/prereq/checker.py``).

Reference: ``pkg/prereq/checker.go:56-216`` — kernel ≥ 5.15, BTF,
bpftool, clang, root, kind, helm with blocker/warning severities, as the
JAX package has them.  The accelerator checks are the card's:
``/dev/nvidia[0-9]*`` nodes, the CUDA driver library ``libcuda.so``
(:func:`tpuslo_torch.collector.symbols.find_libcuda`), and an importable
torch built with CUDA for the serving workload.
"""

from __future__ import annotations

import glob
import importlib.util
import os
import platform
import re
import shutil
from dataclasses import dataclass, field

from tpuslo_torch.collector.symbols import find_libcuda
from tpuslo_torch.signals.mode import BTF_PATH, DEFAULT_NVIDIA_GLOB

SEVERITY_BLOCKER = "blocker"
SEVERITY_WARNING = "warning"
SEVERITY_INFO = "info"

MIN_KERNEL = (5, 15)

_KERNEL_RE = re.compile(r"^(\d+)\.(\d+)")


def parse_kernel_release(release: str) -> tuple[int, int]:
    """Extract (major, minor) from a uname release string."""
    m = _KERNEL_RE.match(release.strip())
    if not m:
        raise ValueError(f"unparseable kernel release {release!r}")
    return int(m.group(1)), int(m.group(2))


@dataclass
class HostSnapshot:
    kernel_release: str = ""
    has_btf: bool = False
    is_root: bool = False
    bpftool: str = ""
    clang: str = ""
    kind: str = ""
    helm: str = ""
    nvidia_devices: list[str] = field(default_factory=list)
    libcuda_path: str = ""
    torch_cuda: bool = False


def _torch_cuda() -> bool:
    """torch is importable and was built with CUDA."""
    if importlib.util.find_spec("torch") is None:
        return False
    import torch

    return torch.version.cuda is not None


def collect_snapshot(
    btf_path: str = BTF_PATH,
    nvidia_glob: str = DEFAULT_NVIDIA_GLOB,
    env: dict[str, str] | None = None,
) -> HostSnapshot:
    return HostSnapshot(
        kernel_release=platform.release(),
        has_btf=os.path.exists(btf_path),
        is_root=(os.geteuid() == 0) if hasattr(os, "geteuid") else False,
        bpftool=shutil.which("bpftool") or "",
        clang=shutil.which("clang") or "",
        kind=shutil.which("kind") or "",
        helm=shutil.which("helm") or "",
        nvidia_devices=sorted(glob.glob(nvidia_glob)),
        libcuda_path=find_libcuda(env=env) or "",
        torch_cuda=_torch_cuda(),
    )


@dataclass
class CheckResult:
    name: str
    severity: str
    passed: bool
    detail: str

    def to_dict(self):
        return self.__dict__


def evaluate(snapshot: HostSnapshot) -> list[CheckResult]:
    """Evaluate prerequisite checks against a host snapshot."""
    results: list[CheckResult] = []

    try:
        major, minor = parse_kernel_release(snapshot.kernel_release)
        kernel_ok = (major, minor) >= MIN_KERNEL
        detail = f"kernel {snapshot.kernel_release}"
    except ValueError:
        kernel_ok = False
        detail = f"unparseable kernel release {snapshot.kernel_release!r}"
    results.append(
        CheckResult(
            "kernel_version",
            SEVERITY_BLOCKER,
            kernel_ok,
            detail + f" (required >= {MIN_KERNEL[0]}.{MIN_KERNEL[1]})",
        )
    )
    results.append(
        CheckResult(
            "btf_available",
            SEVERITY_BLOCKER,
            snapshot.has_btf,
            "BTF at /sys/kernel/btf/vmlinux enables CO-RE probes"
            if snapshot.has_btf
            else "no BTF: agent degrades to bcc_degraded signal set",
        )
    )
    results.append(
        CheckResult(
            "root_privileges",
            SEVERITY_BLOCKER,
            snapshot.is_root,
            "root (or CAP_BPF + CAP_SYS_ADMIN) required to attach probes",
        )
    )
    results.append(
        CheckResult(
            "bpftool",
            SEVERITY_WARNING,
            bool(snapshot.bpftool),
            snapshot.bpftool or "bpftool missing: probe smoke checks unavailable",
        )
    )
    results.append(
        CheckResult(
            "clang",
            SEVERITY_WARNING,
            bool(snapshot.clang),
            snapshot.clang or "clang missing: cannot rebuild eBPF objects locally",
        )
    )
    results.append(
        CheckResult(
            "nvidia_devices",
            SEVERITY_WARNING,
            bool(snapshot.nvidia_devices),
            ", ".join(snapshot.nvidia_devices)
            or "no /dev/nvidia[0-9]* nodes: nvidia ioctl kprobes unavailable "
            "(core_full mode)",
        )
    )
    results.append(
        CheckResult(
            "libcuda",
            SEVERITY_WARNING,
            bool(snapshot.libcuda_path),
            snapshot.libcuda_path
            or "libcuda.so not found: CUDA uprobes unavailable",
        )
    )
    results.append(
        CheckResult(
            "torch_cuda",
            SEVERITY_WARNING,
            snapshot.torch_cuda,
            "torch with CUDA importable for the serving workload"
            if snapshot.torch_cuda
            else "torch with CUDA not importable: serving on the card unavailable",
        )
    )
    results.append(
        CheckResult(
            "kind",
            SEVERITY_INFO,
            bool(snapshot.kind),
            snapshot.kind or "kind missing: local cluster smoke unavailable",
        )
    )
    results.append(
        CheckResult(
            "helm",
            SEVERITY_INFO,
            bool(snapshot.helm),
            snapshot.helm or "helm missing: chart install unavailable",
        )
    )
    return results
