"""Front-door serving gate: batched spec decoding under bursty
multi-tenant traffic, with SLO-aware admission observable (the port's
copy of ``tpuslo/benchmark/frontdoor_bench.py``: the same phases,
floors, report keys and failure strings).

* **Throughput/goodput**: the same loadgen-synthesized bursty
  multi-tenant request set is served twice — sequentially through the
  per-stream :class:`~tpuslo_torch.models.speculative.SpeculativeEngine`
  (FIFO, one stream at a time), then through the
  :class:`~tpuslo_torch.models.frontdoor.FrontDoorEngine` — and the
  front door must deliver ≥ ``goodput_floor`` (2x) the sequential
  goodput (tokens delivered within SLO per second) AND ≥ 2x the raw
  aggregate tokens/s.  SLO thresholds derive from a measured solo
  request (single-stream, empty system) so the gate transfers across
  hosts.  On a card both sides run every dispatch as one CUDA graph
  replay, so the ratio compares the two schedulers, not a graph with an
  eager launch queue.

* **Trace discipline**: the front-door phase runs under the audit of
  :mod:`tpuslo_torch.analysis.jitaudit`; any steady-state recapture
  (``spec_retrace_count``) fails the gate, and host syncs (reads and
  synchronizing calls) per emitted token must stay under the serving
  ceiling.

* **Burn-aware admission**: a second burst runs with one tenant's
  error budget in fast burn (pre-seeded through the real
  :class:`~tpuslo_torch.sloengine.engine.BurnEngine`).  The burning
  tenant's goodput share must drop below its submitted share (shed +
  deprioritized) while the HEALTHY tenants' TTFT p99 stays within the
  SLO — the budget math throttles the burning tenant's traffic, not
  its neighbours'.

Exactness is not re-proven here (the front-door tests pin per-slot
streams to the target-only greedy streams); the lane asserts the spot
check cheaply on a handful of streams.

What differs from the JAX bench: ``cfg`` (default JAX's
``llama_tiny(max_seq_len=192)``) lets the card run the bench at full
width, and ``device`` (default the card) is where it serves.  Engines
are built (and, on a card, their dispatches captured) before each
timer starts, as XLA compiles before the JAX bench's timers.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from tpuslo_torch.cli.loadgen import synthesize_requests

#: Gate floors (the digest gates bench.py enforces).
GOODPUT_SPEEDUP_FLOOR = 2.0
THROUGHPUT_SPEEDUP_FLOOR = 2.0
SPEC_RETRACE_CEILING = 0
HOST_SYNCS_PER_TOKEN_CEILING = 1.0


def _percentile(values: list[float], q: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(round(q * (len(ordered) - 1)))))
    return ordered[idx]


def _prefix_text(group: str) -> str:
    # Short enough that prefix + prompt + the token budget fits the
    # joint KV capacity without clamping either serving path.
    return f"[system:{group}] answer tersely."


def _prompt_text(record: dict) -> str:
    return f"{record['tenant']} {record['request_id']}: status of shard?"


def _latency_summary(
    timings: list[dict[str, float]], ttft_slo_s: float, tpot_slo_s: float
) -> dict[str, Any]:
    ttfts = [t["ttft_s"] for t in timings]
    tpots = [t["tpot_s"] for t in timings if "tpot_s" in t]
    good_tokens = sum(
        t["tokens"]
        for t in timings
        if t["ttft_s"] <= ttft_slo_s
        and t.get("tpot_s", 0.0) <= tpot_slo_s
    )
    return {
        "requests": len(timings),
        "tokens": int(sum(t["tokens"] for t in timings)),
        "good_tokens": int(good_tokens),
        "ttft_p50_ms": round(_percentile(ttfts, 0.50) * 1000.0, 2),
        "ttft_p99_ms": round(_percentile(ttfts, 0.99) * 1000.0, 2),
        "tpot_p50_ms": round(_percentile(tpots, 0.50) * 1000.0, 3),
        "tpot_p99_ms": round(_percentile(tpots, 0.99) * 1000.0, 3),
    }


def _serve_sequential(
    spec_engine, records: list[dict], max_new_tokens: int
) -> tuple[list[dict[str, float]], float]:
    """Today's baseline: per-stream speculative serving, FIFO, one
    stream at a time.  Arrival offsets are honored (idle time sleeps),
    so queue wait lands in TTFT exactly as it would in production."""
    timings: list[dict[str, float]] = []
    start = time.perf_counter()
    for record in records:
        arrival_s = record["offset_ms"] / 1000.0
        now = time.perf_counter() - start
        if now < arrival_s:
            time.sleep(arrival_s - now)
            now = arrival_s
        prefix = record.get("prefix_group")
        stream = spec_engine.stream(
            _prompt_text(record),
            max_new_tokens=max_new_tokens,
            stop_at_eos=False,
            prefix=_prefix_text(prefix) if prefix else None,
        )
        tokens = [next(stream)]
        first_s = time.perf_counter() - start
        tokens.extend(stream)
        done_s = time.perf_counter() - start
        timing = {
            "tenant": record["tenant"],
            "tokens": float(len(tokens)),
            "ttft_s": first_s - arrival_s,
        }
        if len(tokens) > 1:
            timing["tpot_s"] = (done_s - first_s) / (len(tokens) - 1)
        timings.append(timing)
    return timings, time.perf_counter() - start


def _serve_frontdoor(
    engine, records: list[dict], max_new_tokens: int
) -> tuple[list[dict[str, float]], float, dict[str, float]]:
    """Open-loop arrival driving of the front door: requests submit at
    their offsets, the engine steps whenever it has work."""
    pending = sorted(records, key=lambda r: r["offset_ms"])
    submitted: dict[int, str] = {}
    start = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - start
        while i < len(pending) and pending[i]["offset_ms"] / 1000.0 <= now:
            record = pending[i]
            prefix = record.get("prefix_group")
            rid = engine.submit(
                _prompt_text(record),
                tenant=record["tenant"],
                max_new_tokens=max_new_tokens,
                stop_at_eos=False,
                prefix=_prefix_text(prefix) if prefix else None,
            )
            if rid is not None:
                submitted[rid] = record["tenant"]
            i += 1
        busy = engine.step()
        if not busy:
            if i >= len(pending):
                break
            time.sleep(
                max(0.0, pending[i]["offset_ms"] / 1000.0 - now) / 2.0
                + 1e-4
            )
    elapsed = time.perf_counter() - start
    timings = [
        t for rid, t in engine.request_timings().items()
        if rid in submitted
    ]
    per_tenant_tokens: dict[str, float] = {}
    for t in timings:
        per_tenant_tokens[t["tenant"]] = (
            per_tenant_tokens.get(t["tenant"], 0.0) + t["tokens"]
        )
    return timings, elapsed, per_tenant_tokens


def run_frontdoor_bench(
    seed: int = 1337,
    streams: int = 192,
    max_slots: int = 16,
    k: int = 4,
    max_new_tokens: int = 96,
    tenants: int = 4,
    tenant_mix: str = "40,30,20,10",
    prefix_rate: float = 0.35,
    arrival: str = "burst",
    arrival_window_s: float = 1.0,
    burn_queue: int | None = None,
    passes: int = 2,
    rounds_per_step: int = 3,
    log: Callable[[str], None] = lambda msg: None,
    cfg=None,
    device: str = "cuda",
) -> dict[str, Any]:
    """Run the full gate; returns a report dict with ``passed`` /
    ``failures`` and every gated number.  ``cfg`` is the model (target
    and self-draft); ``device`` where it serves."""
    from tpuslo_torch.analysis import jitaudit
    from tpuslo_torch.models.frontdoor import FrontDoorEngine
    from tpuslo_torch.models.llama import llama_tiny
    from tpuslo_torch.models.serve import ServeEngine
    from tpuslo_torch.models.speculative import SpeculativeEngine
    from tpuslo_torch.sloengine.engine import BurnEngine
    from tpuslo_torch.sloengine.stream import RequestOutcome

    failures: list[str] = []
    cfg = cfg or llama_tiny(max_seq_len=192)
    records = synthesize_requests(
        profile="chat_short",
        rps=streams / arrival_window_s,
        duration_s=arrival_window_s,
        seed=seed,
        arrival=arrival,
        tenants=tenants,
        tenant_mix=tenant_mix,
        prefix_rate=prefix_rate,
    )[:streams]

    # The recapture/host-sync audit installs BEFORE engine
    # construction, so that it sees every capture.
    owned_audit = not jitaudit.installed()
    if owned_audit:
        jitaudit.install()
    audit = jitaudit.registry()
    try:
        # Self-draft pair: target and draft share weights, so
        # acceptance is 1.0 and the lane is deterministic + fast.  The
        # gate compares batched vs sequential over the SAME pair, so
        # the acceptance rate cancels out of the speedup.
        target = ServeEngine(cfg=cfg, rng_seed=0, device=device)
        drafts = ServeEngine(cfg=cfg, rng_seed=0, device=device)
        spec = SpeculativeEngine(target, drafts, k=k)

        # Warm every path on BOTH sides (prefill buckets, per-stream
        # round, batched round at max_slots, inject/extract, prefix
        # snapshots) before any timed run — using prompts of the REAL
        # traffic's lengths: a shorter warm prompt lands in a smaller
        # prefill bucket and leaves the (batch, bucket) shapes the timed
        # phase actually uses to run for the first time mid-measurement.
        def warm_prompt(j: int) -> str:
            return _prompt_text(records[j % len(records)])

        warm = FrontDoorEngine(target, drafts, k=k, max_slots=max_slots, rounds_per_step=rounds_per_step)
        for g in range(tenants):
            warm.submit(
                warm_prompt(g), tenant=f"tenant-{g:02d}",
                max_new_tokens=6, stop_at_eos=False,
                prefix=_prefix_text(f"tenant-{g:02d}/sys"),
            )
        warm.run()
        # Every admission-batch bucket runs its lockstep prefill + fused
        # inject shapes here, not inside the timed phase.
        for n in warm._admit_buckets:
            warm_n = FrontDoorEngine(
                target, drafts, k=k, max_slots=max_slots,
                rounds_per_step=rounds_per_step,
            )
            for j in range(n):
                warm_n.submit(
                    warm_prompt(j), max_new_tokens=6, stop_at_eos=False
                )
            warm_n.run()
        # Per-stream paths, with and without a prefix (the prefix
        # stream ingests a longer id sequence — its own bucket).
        spec.generate(warm_prompt(0), max_new_tokens=6, stop_at_eos=False)
        spec.generate(
            warm_prompt(1), max_new_tokens=6, stop_at_eos=False,
            prefix=_prefix_text("tenant-00/sys"),
        )

        # Exactness spot check (full parity suite lives in tests/).
        probe_prompt = _prompt_text(records[0])
        fd_probe = FrontDoorEngine(target, drafts, k=k, max_slots=2,
                                   rounds_per_step=rounds_per_step)
        pid = fd_probe.submit(
            probe_prompt, max_new_tokens=max_new_tokens, stop_at_eos=False
        )
        parity_ok = fd_probe.run()[pid] == spec.generate(
            probe_prompt, max_new_tokens=max_new_tokens, stop_at_eos=False
        )
        if not parity_ok:
            failures.append("front-door stream diverged from per-stream spec")

        # Solo calibration: SLO thresholds scale from one request on an
        # empty system so the gate transfers across hosts (best of 3 —
        # a noisy-neighbour spike here would loosen every SLO gate).
        solo_ttft_s = solo_total_s = 1e30
        solo_tpot_s = 1e30
        for _ in range(3):
            t0 = time.perf_counter()
            stream = spec.stream(
                probe_prompt, max_new_tokens=max_new_tokens,
                stop_at_eos=False,
            )
            next(stream)
            ttft = time.perf_counter() - t0
            n_rest = len(list(stream))
            total = time.perf_counter() - t0
            solo_ttft_s = min(solo_ttft_s, ttft)
            solo_total_s = min(solo_total_s, total)
            solo_tpot_s = min(
                solo_tpot_s, (total - ttft) / max(1, n_rest)
            )
        ttft_slo_s = max(10.0 * solo_total_s, 0.25)
        tpot_slo_s = max(30.0 * solo_tpot_s, 0.05)
        log(
            f"solo ttft {solo_ttft_s * 1e3:.1f}ms total "
            f"{solo_total_s * 1e3:.1f}ms -> SLO ttft "
            f"{ttft_slo_s * 1e3:.0f}ms tpot {tpot_slo_s * 1e3:.1f}ms"
        )

        # ---- phase 1: sequential baseline vs front door -------------
        # Alternating PAIRED passes (the tracer-bench discipline,
        # pair-wise): the lane measures wall clock on a possibly-
        # shared box whose load drifts at the tens-of-seconds scale.
        # Taking each side's independent best would pair one side's
        # luckiest window with the other's unluckiest; instead each
        # pass runs sequential-then-front-door back to back and the
        # gate takes the best PAIRED ratio — load is far more uniform
        # within one ~20 s pair than across the whole lane.
        # Retrace/host-sync counters accumulate across passes — they
        # are deterministic counts, not timings.
        sequential = frontdoor = None
        throughput_speedup = 0.0
        goodput_speedup = 0.0
        spec_retraces = 0
        fd_syncs = 0
        fd_tokens_total = 0
        for _pass in range(max(1, passes)):
            seq_timings, seq_elapsed = _serve_sequential(
                spec, records, max_new_tokens
            )
            candidate = _latency_summary(
                seq_timings, ttft_slo_s, tpot_slo_s
            )
            candidate["elapsed_s"] = round(seq_elapsed, 3)
            candidate["tokens_per_sec"] = round(
                candidate["tokens"] / max(seq_elapsed, 1e-9), 2
            )
            candidate["goodput_tokens_per_sec"] = round(
                candidate["good_tokens"] / max(seq_elapsed, 1e-9), 2
            )
            pass_seq = candidate
            if (
                sequential is None
                or candidate["tokens_per_sec"]
                > sequential["tokens_per_sec"]
            ):
                sequential = candidate

            engine = FrontDoorEngine(
                target, drafts, k=k, max_slots=max_slots,
                max_queue=max(streams, 1),
                rounds_per_step=rounds_per_step,
            )
            retrace0 = audit.steady_compile_count()
            syncs0 = audit.host_sync_count()
            fd_timings, fd_elapsed, _tenant_tokens = _serve_frontdoor(
                engine, records, max_new_tokens
            )
            spec_retraces += audit.steady_compile_count() - retrace0
            fd_syncs += audit.host_sync_count() - syncs0
            candidate = _latency_summary(
                fd_timings, ttft_slo_s, tpot_slo_s
            )
            candidate["elapsed_s"] = round(fd_elapsed, 3)
            candidate["tokens_per_sec"] = round(
                candidate["tokens"] / max(fd_elapsed, 1e-9), 2
            )
            candidate["goodput_tokens_per_sec"] = round(
                candidate["good_tokens"] / max(fd_elapsed, 1e-9), 2
            )
            candidate["occupancy_stats"] = engine.stats()
            candidate["acceptance_rate"] = engine.stats()[
                "acceptance_rate"
            ]
            candidate["healthy_ttft_p99_ms"] = round(
                _percentile(
                    [
                        t["ttft_s"] for t in fd_timings
                        if t["tenant"] != f"tenant-{tenants - 1:02d}"
                    ],
                    0.99,
                )
                * 1000.0,
                2,
            )
            fd_tokens_total += candidate["tokens"]
            pair_throughput = candidate["tokens_per_sec"] / max(
                pass_seq["tokens_per_sec"], 1e-9
            )
            pair_goodput = min(
                candidate["goodput_tokens_per_sec"]
                / max(pass_seq["goodput_tokens_per_sec"], 1e-9),
                999.0,
            )
            throughput_speedup = max(throughput_speedup, pair_throughput)
            goodput_speedup = max(goodput_speedup, pair_goodput)
            log(
                f"pass {_pass + 1}/{passes}: sequential "
                f"{pass_seq['tokens_per_sec']:.0f} tok/s (goodput "
                f"{pass_seq['goodput_tokens_per_sec']:.0f}) vs front "
                f"door {candidate['tokens_per_sec']:.0f} (goodput "
                f"{candidate['goodput_tokens_per_sec']:.0f}) -> "
                f"{pair_throughput:.2f}x / {pair_goodput:.2f}x"
            )
            if (
                frontdoor is None
                or candidate["tokens_per_sec"]
                > frontdoor["tokens_per_sec"]
            ):
                frontdoor = candidate
        host_syncs_per_token = round(
            fd_syncs / max(fd_tokens_total, 1), 3
        )


        # ---- phase 2: burn-aware admission under the same burst -----
        burn = BurnEngine()
        burning_tenant = f"tenant-{tenants - 1:02d}"
        now_s = time.time()
        for j in range(600):
            ts = now_s - 1500.0 + j * 2.5
            burn.record(
                RequestOutcome(
                    tenant=burning_tenant,
                    ts_unix_nano=int(ts * 1e9),
                    ttft_ms=50.0,
                    tpot_ms=10.0,
                    tokens=8,
                    status="error" if j % 2 == 0 else "ok",
                )
            )
        burn.evaluate(now_s)
        burn_state = burn.tenant_burn_state(burning_tenant)
        if burn_state != "fast_burn":
            failures.append(
                f"seeded burn scenario never reached fast_burn "
                f"({burn_state})"
            )
        burn_engine_front = FrontDoorEngine(
            target, drafts, k=k, max_slots=max_slots,
            max_queue=burn_queue or max(8, streams // 8),
            rounds_per_step=rounds_per_step,
            burn_engine=burn,
        )
        burn_timings, burn_elapsed, _tok = _serve_frontdoor(
            burn_engine_front, records, max_new_tokens
        )
        submitted_share = sum(
            1 for r in records if r["tenant"] == burning_tenant
        ) / max(len(records), 1)
        good_by_tenant: dict[str, float] = {}
        for t in burn_timings:
            if (
                t["ttft_s"] <= ttft_slo_s
                and t.get("tpot_s", 0.0) <= tpot_slo_s
            ):
                good_by_tenant[t["tenant"]] = (
                    good_by_tenant.get(t["tenant"], 0.0) + t["tokens"]
                )
        total_good = sum(good_by_tenant.values())
        goodput_share = (
            good_by_tenant.get(burning_tenant, 0.0) / total_good
            if total_good
            else 0.0
        )
        healthy_ttfts = [
            t["ttft_s"] for t in burn_timings
            if t["tenant"] != burning_tenant
        ]
        healthy_p99_s = _percentile(healthy_ttfts, 0.99)
        # "Healthy p99 holds" is measured against the SAME front door
        # serving the SAME burst WITHOUT burn awareness (phase 1):
        # deprioritizing + shedding the burning tenant must not make
        # its neighbours' tail latency worse (it usually makes it
        # better — the burning tenant's work leaves the fast path).
        # 1.5x cushions wall-clock noise on a loaded box; the SLO
        # itself is the floor so an ultra-fast phase-1 pass cannot
        # tighten the bound below what the lane gates elsewhere.
        healthy_hold_s = max(
            1.5 * frontdoor["healthy_ttft_p99_ms"] / 1000.0,
            ttft_slo_s,
        )
        burn_shed = dict(burn_engine_front.stats()["shed"])
        burn_scenario = {
            "burning_tenant": burning_tenant,
            "burn_state": burn_state,
            "submitted_share": round(submitted_share, 4),
            "goodput_share": round(goodput_share, 4),
            "shed": burn_shed,
            "preemptions": burn_engine_front.preemptions,
            "healthy_ttft_p99_ms": round(healthy_p99_s * 1000.0, 2),
            "healthy_hold_ms": round(healthy_hold_s * 1000.0, 2),
            "baseline_healthy_ttft_p99_ms": frontdoor[
                "healthy_ttft_p99_ms"
            ],
            "elapsed_s": round(burn_elapsed, 3),
        }
        if goodput_share >= submitted_share * 0.75:
            failures.append(
                f"burning tenant's goodput share did not drop: "
                f"submitted {submitted_share:.3f} vs goodput "
                f"{goodput_share:.3f}"
            )
        if healthy_p99_s > healthy_hold_s:
            failures.append(
                f"healthy tenants' TTFT p99 {healthy_p99_s * 1e3:.0f}ms "
                f"did not hold during the burn burst (bound "
                f"{healthy_hold_s * 1e3:.0f}ms = max(1.5x the "
                "burn-unaware front door's healthy p99, the TTFT SLO))"
            )
        if not any(burn_shed.values()) and not burn_engine_front.preemptions:
            failures.append(
                "burn burst neither shed nor preempted anything — "
                "admission never reacted to the burning budget"
            )
    finally:
        if owned_audit:
            jitaudit.uninstall()

    if goodput_speedup < GOODPUT_SPEEDUP_FLOOR:
        failures.append(
            f"goodput speedup {goodput_speedup:.2f}x under the "
            f"{GOODPUT_SPEEDUP_FLOOR:.1f}x floor"
        )
    if throughput_speedup < THROUGHPUT_SPEEDUP_FLOOR:
        failures.append(
            f"throughput speedup {throughput_speedup:.2f}x under the "
            f"{THROUGHPUT_SPEEDUP_FLOOR:.1f}x floor"
        )
    if spec_retraces > SPEC_RETRACE_CEILING:
        failures.append(
            f"{spec_retraces} steady-state recompiles in the front-door "
            "round loop (ceiling 0)"
        )
    if host_syncs_per_token > HOST_SYNCS_PER_TOKEN_CEILING:
        failures.append(
            f"{host_syncs_per_token} host syncs per token (ceiling "
            f"{HOST_SYNCS_PER_TOKEN_CEILING})"
        )

    return {
        "seed": seed,
        "streams": len(records),
        "max_slots": max_slots,
        "k": k,
        "max_new_tokens": max_new_tokens,
        "arrival": arrival,
        "tenants": tenants,
        "tenant_mix": tenant_mix,
        "prefix_rate": prefix_rate,
        "self_draft": True,
        "parity_spot_check": parity_ok,
        "slo": {
            "ttft_ms": round(ttft_slo_s * 1000.0, 1),
            "tpot_ms": round(tpot_slo_s * 1000.0, 2),
            "solo_ttft_ms": round(solo_ttft_s * 1000.0, 2),
            "solo_tpot_ms": round(solo_tpot_s * 1000.0, 3),
        },
        "sequential": sequential,
        "frontdoor": frontdoor,
        "frontdoor_tokens_per_sec": frontdoor["tokens_per_sec"],
        "frontdoor_goodput_speedup": round(goodput_speedup, 3),
        "frontdoor_throughput_speedup": round(throughput_speedup, 3),
        "frontdoor_ttft_p99_ms": frontdoor["ttft_p99_ms"],
        "frontdoor_tpot_p99_ms": frontdoor["tpot_p99_ms"],
        "spec_retrace_count": spec_retraces,
        "frontdoor_host_syncs_per_token": host_syncs_per_token,
        "burn_scenario": burn_scenario,
        "gates": {
            "goodput_speedup_floor": GOODPUT_SPEEDUP_FLOOR,
            "throughput_speedup_floor": THROUGHPUT_SPEEDUP_FLOOR,
            "spec_retrace_ceiling": SPEC_RETRACE_CEILING,
            "host_syncs_per_token_ceiling": HOST_SYNCS_PER_TOKEN_CEILING,
        },
        "failures": failures,
        "passed": not failures,
    }
