"""Real ICI-domain injector (thin CLI over
:mod:`tpuslo_torch.chaos.ici_contention`; the port of
``scripts/chaos/injectors/ici_contention.py``, same flags and report).

Two mechanisms, both measured (non-synthetic):

* ``--mode contention``: a background compute storm contends the device
  the collective prober measures; ``ici_collective_latency_ms`` degrades
  for real (device-queue contention; link-level drops need platform
  tooling and are out of scope, recorded in the report's ``mechanism``
  and ``transport`` fields).  On the card the prober runs in one NCCL
  rank; ``--force-cpu-devices N`` runs it over N gloo ranks on the CPU.
* ``--mode straggler``: N OS processes rendezvous over a localhost TCP
  barrier; one host is delayed; per-host measured waits feed
  SliceJoiner, which must attribute the delayed host.
* ``--mode both`` (default) runs the two in sequence.

Exit codes: 0 when every mechanism run met its bar (the straggler
attributed in some launch, a degradation above 1.0), 1 when one did
not, 2 when the contention half found no card that answers (its report
is ``"real": false`` with the reason; the straggler half, which needs no
device, still runs).

Usage: python -m tpuslo_torch.chaos.injectors.ici_contention
           [--mode both] [--reps 10] [--hosts 3] [--delay-ms 150]
           [--launches 6] [--force-cpu-devices N] [--report out.json]
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=("contention", "straggler", "both"),
                   default="both")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--payload-kb", type=int, default=512)
    p.add_argument("--hosts", type=int, default=3)
    p.add_argument("--delay-ms", type=float, default=150.0)
    p.add_argument("--launches", type=int, default=6)
    p.add_argument(
        "--force-cpu-devices", type=int, default=0,
        help="N>0 probes N gloo ranks on the CPU (no card touched)",
    )
    p.add_argument("--report", default="")
    args = p.parse_args(argv)

    report: dict = {"injector": "ici_contention", "real": True}
    unreachable = False
    if args.mode in ("contention", "both"):
        from tpuslo_torch.chaos.backend_guard import fail_fast_report

        guard = (
            None if args.force_cpu_devices > 0
            else fail_fast_report("ici_contention")
        )
        if guard is not None:
            report["contention"] = guard
            report["real"] = False
            unreachable = True
        else:
            from tpuslo_torch.chaos import run_contention

            report["contention"] = run_contention(
                payload_kb=args.payload_kb, reps=args.reps,
                cpu_ranks=args.force_cpu_devices,
            )
    if args.mode in ("straggler", "both"):
        from tpuslo_torch.chaos import run_straggler_injection

        report["straggler"] = run_straggler_injection(
            n_hosts=args.hosts, launches=args.launches,
            delay_ms=args.delay_ms,
        )

    print(json.dumps(report))
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)

    ok = True
    if "straggler" in report:
        ok &= report["straggler"]["correct_attributions"] > 0
    if "contention" in report and "degradation" in report["contention"]:
        ok &= report["contention"]["degradation"] > 1.0
    if unreachable:
        return 2
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
