"""Crash-only agent runtime: snapshots, drain, probe supervision
(the port's own copy of ``tpuslo/runtime``: plain Python, behaviour identical).

The agent is a long-lived per-node DaemonSet process, and everything
it learns at runtime — ingest watermark, per-node clock-skew
estimates, the dedup window, per-sink breaker state, the shed-signal
set, the rate-limiter budget — used to live only in memory.  A
SIGTERM, OOM kill, or node reboot therefore re-admitted duplicates,
forgot open breakers, and reset skew correction to cold.  Production
collection agents (ARGUS, SysOM — PAPERS.md) treat restart-without-
evidence-loss as table stakes; this package closes that gap:

* :class:`StateStore` — periodic atomic, versioned snapshots
  (mkstemp + fsync + os.replace) with staleness bounds on restore,
  so a restarted agent resumes *warm*.
* :class:`AgentRuntime` — the component registry that assembles one
  snapshot from export hooks and fans a restored one back out.
* :class:`DrainController` / :func:`install_drain_handler` — graceful
  SIGTERM/SIGINT drain: stop generation, flush delivery queues to
  spool, final snapshot, all under a bounded deadline, so Kubernetes
  terminations are loss-free.
* :class:`ProbeSupervisor` — per-signal heartbeat tracking, dead-probe
  restart with exponential backoff, and flap detection (K restarts in
  a window sheds the signal with a hold-down the recovery policy must
  respect).
* :func:`repair_jsonl_tail` — crash-tear repair for append-mode JSONL
  sinks: a line torn by ``kill -9`` mid-write is truncated on reopen
  instead of merging with the next run's first record.
"""

from tpuslo_torch.runtime.drain import (
    DrainController,
    DrainReport,
    DrainSignal,
    install_drain_handler,
)
from tpuslo_torch.runtime.statestore import (
    RESTORE_COLD,
    RESTORE_CORRUPT,
    RESTORE_RESTORED,
    RESTORE_STALE,
    RESTORE_VERSION,
    AgentRuntime,
    RuntimeObserver,
    StateStore,
    repair_jsonl_tail,
)
from tpuslo_torch.runtime.supervisor import (
    ProbeSupervisor,
    SupervisorConfig,
    SupervisorEvent,
)

__all__ = [
    "AgentRuntime",
    "DrainController",
    "DrainReport",
    "DrainSignal",
    "ProbeSupervisor",
    "RESTORE_COLD",
    "RESTORE_CORRUPT",
    "RESTORE_RESTORED",
    "RESTORE_STALE",
    "RESTORE_VERSION",
    "RuntimeObserver",
    "StateStore",
    "SupervisorConfig",
    "SupervisorEvent",
    "install_drain_handler",
    "repair_jsonl_tail",
]
