"""Self-protection: CPU overhead governor
(the port's own copy of ``tpuslo/safety/overhead_guard.py``: plain Python, behaviour identical).

Reference: ``pkg/safety/overhead_guard.go:19-158`` — delta-ticks CPU
percentage ``(Δproc / Δtotal) · 100 · num_cpus`` compared against a
budget; a pluggable sampler seam keeps it unit-testable without /proc.
The agent sheds probes in cost order while the guard reports breaches.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Protocol


@dataclass
class CPUSample:
    """One (process ticks, total ticks) observation."""

    proc_ticks: float
    total_ticks: float


class CPUSampler(Protocol):
    def sample(self) -> CPUSample: ...


class ProcCPUSampler:
    """Reads process and machine tick counters from /proc."""

    def __init__(self, proc_root: str = "/proc", pid: int | None = None):
        self._proc_root = proc_root
        self._pid = pid if pid is not None else os.getpid()

    def sample(self) -> CPUSample:
        return CPUSample(
            proc_ticks=self._read_proc_ticks(),
            total_ticks=self._read_total_ticks(),
        )

    def _read_total_ticks(self) -> float:
        with open(os.path.join(self._proc_root, "stat"), encoding="utf-8") as f:
            first = f.readline()
        fields = first.split()
        if not fields or fields[0] != "cpu":
            raise ValueError("unexpected /proc/stat format")
        return float(sum(int(v) for v in fields[1:]))

    def _read_proc_ticks(self) -> float:
        path = os.path.join(self._proc_root, str(self._pid), "stat")
        with open(path, encoding="utf-8") as f:
            content = f.read()
        # utime and stime are fields 14 and 15 (1-indexed) after the
        # parenthesised comm, which may itself contain spaces.
        rest = content.rsplit(")", 1)[1].split()
        utime, stime = int(rest[11]), int(rest[12])
        return float(utime + stime)


@dataclass
class OverheadResult:
    cpu_pct: float
    budget_pct: float
    over_budget: bool
    valid: bool


class OverheadGuard:
    """Delta-based CPU overhead evaluation against a budget.

    The first :meth:`evaluate` call primes the baseline and reports an
    invalid (non-actionable) result, mirroring the reference guard.
    """

    def __init__(
        self,
        budget_pct: float,
        sampler: CPUSampler | None = None,
        num_cpus: int | None = None,
    ):
        if budget_pct <= 0:
            raise ValueError("budget_pct must be > 0")
        self._budget_pct = budget_pct
        self._sampler = sampler or ProcCPUSampler()
        self._num_cpus = num_cpus or os.cpu_count() or 1
        self._last: CPUSample | None = None

    @property
    def budget_pct(self) -> float:
        return self._budget_pct

    def evaluate(self) -> OverheadResult:
        current = self._sampler.sample()
        last, self._last = self._last, current
        if last is None:
            return OverheadResult(0.0, self._budget_pct, False, valid=False)

        delta_total = current.total_ticks - last.total_ticks
        delta_proc = current.proc_ticks - last.proc_ticks
        if delta_total <= 0 or delta_proc < 0:
            return OverheadResult(0.0, self._budget_pct, False, valid=False)

        cpu_pct = (delta_proc / delta_total) * 100.0 * self._num_cpus
        return OverheadResult(
            cpu_pct=cpu_pct,
            budget_pct=self._budget_pct,
            over_budget=cpu_pct > self._budget_pct,
            valid=True,
        )
