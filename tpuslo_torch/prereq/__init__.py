"""Host prerequisite checks (the port's copy of ``tpuslo/prereq``)."""

from tpuslo_torch.prereq.checker import (
    SEVERITY_BLOCKER,
    SEVERITY_INFO,
    SEVERITY_WARNING,
    CheckResult,
    HostSnapshot,
    collect_snapshot,
    evaluate,
    parse_kernel_release,
)

__all__ = [
    "SEVERITY_BLOCKER",
    "SEVERITY_INFO",
    "SEVERITY_WARNING",
    "CheckResult",
    "HostSnapshot",
    "collect_snapshot",
    "evaluate",
    "parse_kernel_release",
]
