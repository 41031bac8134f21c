"""L3 safety governor: overhead guard + rate limiter + shed recovery
(the port's own copy of ``tpuslo/safety``: plain Python, behaviour identical)."""

from tpuslo_torch.safety.overhead_guard import (
    CPUSample,
    CPUSampler,
    OverheadGuard,
    OverheadResult,
    ProcCPUSampler,
)
from tpuslo_torch.safety.rate_limiter import RateLimiter
from tpuslo_torch.safety.recovery import (
    OWNER_GUARD,
    OWNER_REMEDIATION,
    ShedOwnership,
    ShedRecoveryPolicy,
)

__all__ = [
    "CPUSample",
    "CPUSampler",
    "OverheadGuard",
    "OverheadResult",
    "OWNER_GUARD",
    "OWNER_REMEDIATION",
    "ProcCPUSampler",
    "RateLimiter",
    "ShedOwnership",
    "ShedRecoveryPolicy",
]
