"""Unreachable-card guard for the chaos injectors (the port's counterpart
of ``tpuslo/chaos/backend_guard.py``).

The JAX guard catches a dead tunnel relay, on which ``jax.devices()``
hangs forever.  A CUDA card is unreachable in two ways: there is none
(``torch.cuda.is_available()`` is False), or the driver does not answer,
so that CUDA's initialisation and a first ``torch.cuda.mem_get_info()``
never return.  The second is probed behind a join timeout, as the HBM
sampler probes (:mod:`tpuslo_torch.collector.hbm_sampler`): a hung
driver blocks the calling thread with no exception to catch.

Either way an injector fails fast with an honest report (``real:
false`` and the reason) and never carries on on the CPU: the fault
matrix then records the injector as not real and moves on.
``TPUSLO_FORCE_BACKEND_UNREACHABLE=1`` forces the verdict (deterministic
tests; operators forcing the synthetic lane).
"""

from __future__ import annotations

import json
import os
import threading

PROBE_TIMEOUT_S = 30.0


def backend_unreachable_reason(timeout_s: float = PROBE_TIMEOUT_S) -> str | None:
    """Why the card cannot be reached, or None when it answered.

    The CUDA initialisation and ``mem_get_info`` run in a daemon thread
    joined for ``timeout_s``; a thread still inside the driver after that
    is a hung card."""
    if os.environ.get("TPUSLO_FORCE_BACKEND_UNREACHABLE", "") == "1":
        return "CUDA device unreachable (forced by TPUSLO_FORCE_BACKEND_UNREACHABLE=1)"
    import torch

    if not torch.cuda.is_available():
        return "CUDA device unreachable: no CUDA device (torch.cuda.is_available() is False)"
    box: dict[str, str | None] = {"error": None}

    def probe() -> None:
        try:
            torch.cuda.init()
            torch.cuda.mem_get_info(torch.cuda.current_device())
        except Exception as exc:  # noqa: BLE001 - the failure is the verdict, reported
            box["error"] = repr(exc)

    thread = threading.Thread(target=probe, daemon=True)
    thread.start()
    thread.join(timeout=timeout_s)
    if thread.is_alive():
        return f"CUDA device unreachable: CUDA init did not return in {timeout_s:g} s"
    if box["error"] is not None:
        return f"CUDA device unreachable: CUDA init failed: {box['error']}"
    return None


def fail_fast_report(name: str, report_path: str = "") -> dict | None:
    """The injector guard: an honesty report dict when the card is
    unreachable (also written to ``report_path`` so the fault matrix
    keeps the machine-readable reason), None when it is safe to proceed.
    """
    reason = backend_unreachable_reason()
    if reason is None:
        return None
    report = {"injector": name, "real": False, "reason": reason}
    if report_path:
        try:
            with open(report_path, "w", encoding="utf-8") as fh:
                json.dump(report, fh, indent=2)
        except OSError:
            pass
    return report
