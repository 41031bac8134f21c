"""frontdoor: the serving front door as a supervised live process, on the
card (the port's counterpart of ``tpuslo/cli/frontdoor.py``).

Runs one :class:`~tpuslo_torch.models.frontdoor.FrontDoorEngine`
(llama-tiny target/draft pair) under the crash-safe runtime, serving a
two-tenant traffic loop, with its own co-located remediation agent:
the tenant whose requests keep failing burns its error budget, the
burn trips fast-burn, a real hbm_pressure fault sample attributes
through the Bayesian posterior, the remediation policy demotes the
tenant, and the **live** admission order flips — the healthy tenant
admitted ahead of the demoted one on the very next cycle.

Every cycle appends one status JSONL line (``--status-out``): that
file is simultaneously the supervisor's heartbeat artifact (mtime)
and the chaos lane's audit record (burn state, admission order,
remediation phase, restore evidence).  kill -9 at any point and a
restart with the same argv resumes from the runtime snapshot —
in-flight streams, burn windows, and the remediation ledger included
— without ever applying the same action twice.

The engines serve on ``--device`` (default ``cuda``); without a card
the process exits non-zero unless ``--device cpu`` is given.  The
argv, stderr lines, status rows and summary are the JAX entry's, plus
``--device`` and one stderr line naming the device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from datetime import datetime, timezone
from typing import Any


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpuslo-torch frontdoor", description=__doc__
    )
    p.add_argument(
        "--cycles", type=int, default=0, help="0 = until --run-for-s"
    )
    p.add_argument(
        "--run-for-s",
        type=float,
        default=0.0,
        help="stop after this many seconds (0 = until --cycles or "
        "SIGTERM)",
    )
    p.add_argument("--interval-s", type=float, default=0.2)
    p.add_argument(
        "--tenant",
        default="burny",
        help="the tenant whose traffic burns budget (the remediation "
        "target); the healthy tenant is always 'steady'",
    )
    p.add_argument("--max-new-tokens", type=int, default=3)
    p.add_argument(
        "--status-out",
        default="",
        help="per-cycle status JSONL; doubles as the supervisor's "
        "heartbeat artifact",
    )
    p.add_argument(
        "--state-dir",
        default="",
        help="crash-safe runtime snapshots land here "
        "(frontdoor-state.json)",
    )
    p.add_argument("--snapshot-interval-s", type=float, default=0.0)
    p.add_argument(
        "--json",
        action="store_true",
        help="print the run summary as JSON instead of text",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="where the engines serve: 'cuda' (the default; fails "
        "without a card) or 'cpu'",
    )
    return p


def build_engines(device, params=None):
    """The (target, draft) ``ServeEngine`` pair the entry serves on:
    ``llama_tiny(max_seq_len=128)``, both drawn from seed 0 (a
    self-draft: acceptance 1.0, deterministic and fast) unless
    ``params`` is given, which then serves as both."""
    from tpuslo_torch.models.llama import llama_tiny
    from tpuslo_torch.models.serve import ServeEngine

    cfg = llama_tiny(max_seq_len=128)
    return tuple(
        ServeEngine(cfg=cfg, params=params, rng_seed=0, device=device)
        for _ in range(2)
    )


def _prefeed_burn(burn, tenant: str, now_s: float) -> None:
    """Backfill ~25 minutes of failing history for ``tenant`` so the
    fast-burn window trips within the first live cycles instead of
    after a real hour of traffic."""
    from tpuslo_torch.sloengine import RequestOutcome

    for j in range(600):
        ts = now_s - 1500.0 + j * 2.5
        burn.record(
            RequestOutcome(
                tenant=tenant,
                ts_unix_nano=int(ts * 1e9),
                ttft_ms=50.0,
                tpot_ms=10.0,
                tokens=8,
                status="error" if j % 2 == 0 else "ok",
            )
        )


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from tpuslo_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"frontdoor: {exc}", file=sys.stderr)
        return 2

    from tpuslo_torch.attribution.bayesian import BayesianAttributor
    from tpuslo_torch.faultreplay.generator import generate_fault_samples
    from tpuslo_torch.models.frontdoor import (
        FrontDoorEngine,
        FrontDoorObserver,
    )
    from tpuslo_torch.remediation.actions import ActionBindings
    from tpuslo_torch.remediation.engine import RemediationEngine
    from tpuslo_torch.remediation.policy import AttributionContext
    from tpuslo_torch.runtime import (
        AgentRuntime,
        DrainSignal,
        StateStore,
        install_drain_handler,
    )
    from tpuslo_torch.sloengine import BurnEngine, RequestOutcome

    tenant = args.tenant
    healthy = "steady"

    target, draft = build_engines(device)
    if device.type == "cuda":
        import torch

        where = f"{device} ({torch.cuda.get_device_name(device)})"
    else:
        where = str(device)
    print(f"frontdoor: serving on {where}", file=sys.stderr)

    order: list[str] = []

    class _OrderObserver(FrontDoorObserver):
        def admitted(self, t: str) -> None:
            order.append(t)

    burn = BurnEngine()
    fd = FrontDoorEngine(
        target,
        draft,
        k=3,
        max_slots=1,
        burn_engine=burn,
        observer=_OrderObserver(),
    )
    remediation = RemediationEngine(
        bindings=ActionBindings(burn_engine=burn),
        log=lambda msg: print(f"frontdoor: {msg}", file=sys.stderr),
    )

    progress = {"next_cycle": 0, "prefed": False}
    store = None
    if args.state_dir:
        import os

        store = StateStore(
            os.path.join(args.state_dir, "frontdoor-state.json"),
            interval_s=args.snapshot_interval_s,
        )
    runtime = AgentRuntime(
        store,
        log=lambda msg: print(f"frontdoor: {msg}", file=sys.stderr),
    )
    runtime.register(
        "progress",
        lambda: dict(progress),
        lambda s: progress.update(s or {}),
    )
    runtime.register("burn", burn.export_state, burn.restore_state)
    runtime.register(
        "frontdoor", fd.export_state, fd.restore_state
    )
    runtime.register(
        "remediation",
        remediation.export_state,
        remediation.restore_state,
    )

    restore_outcome = runtime.restore()
    if runtime.enabled:
        detail = ""
        if restore_outcome == "restored":
            detail = (
                f" (age {runtime.restored_age_s:.1f}s, components: "
                f"{','.join(runtime.restored_components) or 'none'})"
            )
        print(
            f"frontdoor: runtime: snapshot {restore_outcome}{detail}; "
            f"resuming at cycle {progress['next_cycle']}",
            file=sys.stderr,
        )
    if not progress.get("prefed"):
        _prefeed_burn(burn, tenant, time.time())
        progress["prefed"] = True

    status_fh = None
    if args.status_out:
        status_fh = open(args.status_out, "a", encoding="utf-8")

    def _status(line: dict[str, Any]) -> None:
        if status_fh is None:
            return
        status_fh.write(
            json.dumps(line, separators=(",", ":")) + "\n"
        )
        status_fh.flush()

    print(
        f"frontdoor: serving tenants [{tenant}, {healthy}] "
        f"(max_slots=1, k=3); remediation loop armed",
        file=sys.stderr,
    )

    restore_handlers = install_drain_handler()
    deadline = (
        time.monotonic() + args.run_for_s
        if args.run_for_s > 0
        else float("inf")
    )
    flips = 0
    applied_record = None
    try:
        cycle = progress["next_cycle"]
        while time.monotonic() < deadline:
            if args.cycles and cycle >= args.cycles:
                break
            now_s = time.time()
            order.clear()
            demoted = any(
                rec.kind == "demote_tenant"
                and rec.phase
                in ("applying", "verifying", "confirmed")
                for rec in remediation.records()
            )
            # The burning tenant queued FIRST: pre-demotion FIFO
            # admits it first; post-demotion priority admits it last.
            fd.submit(
                f"cycle {cycle} {tenant}",
                tenant=tenant,
                max_new_tokens=args.max_new_tokens,
                stop_at_eos=False,
            )
            fd.submit(
                f"cycle {cycle} {healthy}",
                tenant=healthy,
                max_new_tokens=args.max_new_tokens,
                stop_at_eos=False,
            )
            fd.run()
            admitted = list(order)
            # Live outcomes keep the budget honest: the burning tenant
            # fails until the demotion lands, then recovers (so the
            # verifier can confirm the action helped).
            for t, status in (
                (tenant, "ok" if demoted else "error"),
                (healthy, "ok"),
            ):
                burn.record(
                    RequestOutcome(
                        tenant=t,
                        ts_unix_nano=int(now_s * 1e9),
                        ttft_ms=50.0,
                        tpot_ms=10.0,
                        tokens=args.max_new_tokens,
                        status=status,
                    )
                )
            burn.evaluate(now_s)
            burn_state = burn.tenant_burn_state(tenant)

            record = None
            if burn_state == "fast_burn" and not demoted:
                # The co-located agent: a real fault sample, the real
                # posterior, the real policy — nothing scripted.
                sample = generate_fault_samples(
                    "hbm_pressure",
                    1,
                    start=datetime.fromtimestamp(
                        now_s, tz=timezone.utc
                    ),
                )[0]
                attribution = BayesianAttributor().attribute_sample(
                    sample
                )
                record = remediation.consider(
                    AttributionContext(
                        incident_id=f"inc-live-hbm-{tenant}",
                        domain=attribution.predicted_fault_domain,
                        confidence=attribution.confidence,
                        burn_state=burn_state,
                        burn_rate=burn.max_active_burn(),
                        tenant=tenant,
                        at_s=now_s,
                    ),
                    now_s,
                )
                if record is not None:
                    applied_record = record
                    print(
                        f"frontdoor: remediation {record.kind} -> "
                        f"{record.target} phase={record.phase}",
                        file=sys.stderr,
                    )
            if cycle and cycle % 25 == 0:
                # Verification windows are minutes-long in production;
                # one tick per ~25 sub-second serve cycles keeps the
                # 6-window budget from burning in seconds of wallclock.
                remediation.tick(
                    now_s, lambda rec: burn.max_active_burn()
                )
            order_flipped = admitted == [healthy, tenant]
            if order_flipped:
                flips += 1
            _status(
                {
                    "ts": now_s,
                    "cycle": cycle,
                    "burn_state": burn_state,
                    "priority": burn.admission_priority(tenant),
                    "admitted": admitted,
                    "remediation_applied": demoted
                    or record is not None,
                    "order_flipped": order_flipped,
                    "restored": restore_outcome,
                }
            )
            cycle += 1
            progress["next_cycle"] = cycle
            runtime.maybe_snapshot()
            if args.interval_s > 0:
                time.sleep(args.interval_s)
    except (KeyboardInterrupt, DrainSignal):
        pass
    finally:
        restore_handlers()
        runtime.snapshot_now()
        if status_fh is not None:
            status_fh.close()

    summary = {
        "cycles": progress["next_cycle"],
        "burn_state": burn.tenant_burn_state(tenant),
        "priority": burn.admission_priority(tenant),
        "remediation_phase": (
            applied_record.phase if applied_record else ""
        ),
        "order_flips": flips,
    }
    if args.json:
        print(json.dumps(summary, indent=2))
    else:
        print(
            f"frontdoor: {summary['cycles']} cycles, tenant {tenant} "
            f"{summary['burn_state']} priority={summary['priority']}, "
            f"{flips} flipped-admission cycles"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
