"""Serving scale-out gate: SLO-aware routing over N replicated front
doors, measured in virtual time (the port's copy of
``tpuslo/benchmark/router_bench.py``: the same phases, gates, report
keys and failure strings).

* **Scale-out**: the same loadgen burst (thousands of streams, multi-
  group prefixes) is served by an N=4 fleet under the
  :class:`~tpuslo_torch.models.router.SLORouter` and by a single
  identical engine; aggregate goodput (SLO-good tokens per unit of
  virtual time) must reach ≥ ``SCALEOUT_FLOOR_PER_ENGINE × N`` of the
  single engine's.

* **Affinity beats random**: an un-overloaded paced pass runs twice —
  prefix-affinity policy vs uniform-random placement — over the same
  records; affinity routing must win on TTFT p99 (cold prefix fills
  are bounded by the group count fleet-wide instead of recurring per
  engine, and power-of-two-choices keeps queues short).

* **Trace discipline**: every fleet pass runs under the audit of
  :mod:`tpuslo_torch.analysis.jitaudit`; any steady-state recapture in
  any engine's round loop fails the gate.

* **Rebalancing under failure**: a mid-run engine kill drains its
  running/parked slots onto siblings (paged parks materialize to
  dense snapshots, teacher-forced streams continue); ZERO requests
  are lost and every stream matches the uninterrupted single-engine
  reference bit-for-bit.

**Virtual time.**  N engines on one host cannot overlap wall-clock
compute, so the harness runs a discrete-event simulation: each engine
owns a virtual clock advanced by the REAL duration of its own steps
(an idle engine's clock snaps forward to the next arrival — idle
virtual time costs no wall time).  Every timestamp the engines record
comes from their injected clock, so TTFT/TPOT and makespans are
consistent per engine; wall-clock noise cancels the same way it does
for real replicas.  The parallelism claim this validates is the
placement layer's — per-engine compute is the front door's own.

What differs from the JAX bench: ``device`` (default the card) is where
the replicas serve.  Each replica captures its dispatch when it is
built, outside the virtual clocks.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from tpuslo_torch.benchmark.frontdoor_bench import (
    _latency_summary,
    _percentile,
    _prompt_text,
)
from tpuslo_torch.cli.loadgen import synthesize_requests

#: Gate floors/ceilings (the digest gates bench.py enforces).
SCALEOUT_FLOOR_PER_ENGINE = 0.8
SPEC_RETRACE_CEILING = 0
LOST_REQUEST_CEILING = 0

#: Target utilization for the paced (affinity-vs-random) and kill
#: phases, as a fraction of the fleet's measured saturated rate.
#: High enough that placement quality shows up in queue tails, low
#: enough that the fleet is not overloaded (TTFT must reflect
#: placement, not a full-fleet backlog).
PACED_UTILIZATION = 0.5
KILL_UTILIZATION = 0.8


def _prefix_text(group: str) -> str:
    # Long on purpose (byte-level tokenizer: ~1 token/char).  A cold
    # fill pays a full prefix prefill; a warm hit injects the cached
    # KV snapshot.  Engines cap their prefix cache (FIFO eviction), so
    # warmth is scarce: affinity keeps each engine's resident groups
    # within its cap while random placement cycles every group
    # through every engine's cache.  Sized so prefix + prompt +
    # max_new + per-step speculation slack fits the joint KV budget.
    return (
        f"[system:{group}] route replies tersely; "
        "cite shard ids; reuse cached plans."
    )


class _VirtualClock:
    """One engine's virtual clock: ``base`` accumulates the real
    duration of the engine's own steps; between ``begin``/``end`` the
    clock also sees the partial elapsed time, so timestamps recorded
    MID-step (admission, first token, completion) land inside the
    step's span — a cold prefix fill's prefill cost shows up in the
    TTFT it actually delays."""

    __slots__ = ("base", "_anchor")

    def __init__(self) -> None:
        self.base = 0.0
        self._anchor: float | None = None

    def begin(self) -> None:
        self._anchor = time.perf_counter()

    def end(self) -> None:
        self.base += time.perf_counter() - self._anchor
        self._anchor = None

    def advance_to(self, t: float) -> None:
        if self.base < t:
            self.base = t

    def __call__(self) -> float:
        if self._anchor is None:
            return self.base
        return self.base + (time.perf_counter() - self._anchor)


def _engine_busy(engine) -> bool:
    return engine.queue_depth > 0 or engine.busy_slots > 0


def _serve_fleet(
    router,
    clocks: list[_VirtualClock],
    records: list[dict],
    max_new_tokens: int,
    kill_engine: int | None = None,
    kill_after: int | None = None,
) -> dict[str, Any]:
    """Discrete-event drive: submit each request at its virtual
    arrival, always stepping the busy engine whose clock lags most;
    an engine only steps while its clock is behind the next arrival.
    Optionally kills ``kill_engine`` after ``kill_after`` arrivals.

    Returns routed/lost bookkeeping + the fleet makespan (max final
    virtual clock over engines that did work).
    """
    pending = sorted(records, key=lambda r: r["offset_ms"])
    routed: dict[int, dict] = {}
    shed = 0
    i = 0
    killed = False
    while True:
        if (
            kill_engine is not None
            and not killed
            and kill_after is not None
            and i >= kill_after
        ):
            victim = router.engine(kill_engine)
            # Wait for the victim to hold live work — a kill that
            # lands on an idle engine never exercises drain/adopt.
            if _engine_busy(victim) or i >= len(pending):
                router.kill_engine(kill_engine)
                killed = True
        live = router.live_engines()
        busy = [j for j in live if _engine_busy(router.engine(j))]
        next_arrival = (
            pending[i]["offset_ms"] / 1000.0
            if i < len(pending)
            else None
        )
        if busy:
            j = min(busy, key=lambda x: clocks[x].base)
            if next_arrival is None or clocks[j].base < next_arrival:
                clocks[j].begin()
                router.engine(j).step()
                clocks[j].end()
                continue
        if next_arrival is None:
            break
        record = pending[i]
        i += 1
        for j in live:
            if not _engine_busy(router.engine(j)):
                clocks[j].advance_to(next_arrival)
        prefix = record.get("prefix_group")
        gid = router.route(
            _prompt_text(record),
            tenant=record["tenant"],
            max_new_tokens=max_new_tokens,
            stop_at_eos=False,
            prefix=_prefix_text(prefix) if prefix else None,
        )
        if gid is None:
            shed += 1
            continue
        # The engine stamped submission at its own (possibly ahead)
        # clock; the request actually arrived at the loadgen offset —
        # queue wait must start there or overload would hide in TTFT.
        idx, lid = router._placements[gid]
        queue = router.engine(idx)._queue
        if queue and queue[-1].request_id == lid:
            queue[-1].submitted_s = next_arrival
        routed[gid] = record
    makespan = max(
        (c.base for c in clocks), default=0.0
    )
    return {
        "routed": routed,
        "shed": shed,
        "makespan_s": makespan,
    }


def run_router_bench(
    seed: int = 1337,
    engines: int = 4,
    streams: int = 1024,
    max_slots: int = 8,
    k: int = 3,
    max_new_tokens: int = 16,
    tenants: int = 4,
    prefix_groups: int = 8,
    prefix_rate: float = 0.9,
    kill_streams: int = 96,
    log: Callable[[str], None] = lambda msg: None,
    device: str = "cuda",
) -> dict[str, Any]:
    """Run the full gate; returns a report dict with ``passed`` /
    ``failures`` and every gated number.  ``device`` is where the
    replicas serve."""
    from tpuslo_torch.analysis import jitaudit
    from tpuslo_torch.models.frontdoor import FrontDoorEngine
    from tpuslo_torch.models.llama import llama_tiny
    from tpuslo_torch.models.router import SLORouter
    from tpuslo_torch.models.serve import ServeEngine
    from tpuslo_torch.models.speculative import SpeculativeEngine

    failures: list[str] = []
    cfg = llama_tiny(max_seq_len=160)
    block_size = 32
    rounds_per_step = 2

    def synth(n, offset, window_s, arrival):
        records = synthesize_requests(
            profile="chat_short",
            rps=n / max(window_s, 1e-3),
            duration_s=max(window_s, 1e-3),
            seed=seed + offset,
            arrival=arrival,
            tenants=tenants,
            prefix_rate=prefix_rate,
            prefix_groups=prefix_groups,
        )[:n]
        if window_s <= 0.0:
            records = [dict(r, offset_ms=0.0) for r in records]
        return records

    # Scale-out phase: a true burst — every stream is concurrent at
    # t=0, so makespan measures serving capacity, not arrival pacing.
    burst = synth(streams, 0, 0.0, "burst")

    def make_frontdoor(clock, paged=True, slots=max_slots):
        # Fresh ServeEngine pair per replica: prefix snapshot caches
        # are per-engine state — warmth must be engine-local or the
        # affinity-vs-random comparison measures nothing.  Each replica
        # captures its own dispatch when it is built, outside the
        # virtual clocks.
        target = ServeEngine(cfg=cfg, rng_seed=0, device=device)
        draft = ServeEngine(cfg=cfg, rng_seed=0, device=device)
        return FrontDoorEngine(
            target, draft, k=k, max_slots=slots,
            max_queue=max(streams, 64),
            rounds_per_step=rounds_per_step,
            paged=paged, block_size=block_size,
            clock=clock,
        )

    def make_fleet(n, policy, seed_offset=0):
        clocks = [_VirtualClock() for _ in range(n)]
        fleet = [make_frontdoor(clocks[j]) for j in range(n)]
        router = SLORouter(
            fleet, policy=policy, seed=seed + seed_offset
        )
        return router, clocks

    owned_audit = not jitaudit.installed()
    if owned_audit:
        jitaudit.install()
    audit = jitaudit.registry()
    try:
        # ---- warmup: run every shape the timed phases touch -------
        warm_target = ServeEngine(cfg=cfg, rng_seed=0, device=device)
        warm_draft = ServeEngine(cfg=cfg, rng_seed=0, device=device)
        spec = SpeculativeEngine(warm_target, warm_draft, k=k)
        warm = FrontDoorEngine(
            warm_target, warm_draft, k=k, max_slots=max_slots,
            rounds_per_step=rounds_per_step,
            paged=True, block_size=block_size,
        )
        for g in range(max(prefix_groups, 1)):
            warm.submit(
                _prompt_text(burst[g % len(burst)]),
                max_new_tokens=4, stop_at_eos=False,
                prefix=_prefix_text(f"grp-{g:02d}/sys"),
            )
        warm.run()
        # Second pass over the still-resident (non-evicted) groups
        # runs the warm snapshot-inject admission path too.
        n_groups = max(prefix_groups, 1)
        resident = range(
            max(0, n_groups - warm_target.prefix_cache_max), n_groups
        )
        for g in resident:
            warm.submit(
                _prompt_text(burst[g % len(burst)]),
                max_new_tokens=4, stop_at_eos=False,
                prefix=_prefix_text(f"grp-{g:02d}/sys"),
            )
        warm.run()
        for n in warm._admit_buckets:
            warm_n = FrontDoorEngine(
                warm_target, warm_draft, k=k, max_slots=max_slots,
                rounds_per_step=rounds_per_step,
                paged=True, block_size=block_size,
            )
            for j in range(n):
                warm_n.submit(
                    _prompt_text(burst[j % len(burst)]),
                    max_new_tokens=4, stop_at_eos=False,
                )
            warm_n.run()
        spec.generate(
            _prompt_text(burst[0]), max_new_tokens=4,
            stop_at_eos=False,
        )

        # ---- solo calibration (SLO thresholds transfer across hosts)
        probe_prompt = _prompt_text(burst[0])
        solo_total_s = solo_tpot_s = 1e30
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
            solo_total_s = min(solo_total_s, total)
            solo_tpot_s = min(
                solo_tpot_s, (total - ttft) / max(1, n_rest)
            )
        ttft_slo_s = max(10.0 * solo_total_s, 0.25)
        tpot_slo_s = max(30.0 * solo_tpot_s, 0.05)
        log(
            f"solo total {solo_total_s * 1e3:.1f}ms -> SLO ttft "
            f"{ttft_slo_s * 1e3:.0f}ms tpot {tpot_slo_s * 1e3:.1f}ms"
        )

        def fleet_pass(n, policy, recs, seed_offset=0,
                       kill_engine=None, kill_after=None):
            router, clocks = make_fleet(n, policy, seed_offset)
            retrace0 = audit.steady_compile_count()
            drive = _serve_fleet(
                router, clocks, recs, max_new_tokens,
                kill_engine=kill_engine, kill_after=kill_after,
            )
            retraces = audit.steady_compile_count() - retrace0
            timings = list(router.request_timings().values())
            summary = _latency_summary(timings, ttft_slo_s, tpot_slo_s)
            summary["elapsed_virtual_s"] = round(
                drive["makespan_s"], 3
            )
            denom = max(drive["makespan_s"], 1e-9)
            summary["tokens_per_sec"] = round(
                summary["tokens"] / denom, 2
            )
            summary["goodput_tokens_per_sec"] = round(
                summary["good_tokens"] / denom, 2
            )
            summary["shed"] = drive["shed"]
            summary["retraces"] = retraces
            summary["affinity_hit_rate"] = router.stats()[
                "affinity_hit_rate"
            ]
            return router, drive, summary

        # ---- phase 1: scale-out (burst; N engines vs one) -----------
        _r_n, _d_n, fleet_sum = fleet_pass(engines, "slo", burst)
        _r_1, _d_1, single_sum = fleet_pass(1, "slo", burst)
        goodput_ratio = fleet_sum["goodput_tokens_per_sec"] / max(
            single_sum["goodput_tokens_per_sec"], 1e-9
        )
        throughput_ratio = fleet_sum["tokens_per_sec"] / max(
            single_sum["tokens_per_sec"], 1e-9
        )
        scaling_floor = SCALEOUT_FLOOR_PER_ENGINE * engines
        log(
            f"scale-out: fleet {fleet_sum['goodput_tokens_per_sec']:.0f} "
            f"good tok/s vs single "
            f"{single_sum['goodput_tokens_per_sec']:.0f} -> "
            f"{goodput_ratio:.2f}x (floor {scaling_floor:.1f}x, "
            f"throughput {throughput_ratio:.2f}x)"
        )
        if goodput_ratio < scaling_floor:
            failures.append(
                f"aggregate goodput {goodput_ratio:.2f}x the single "
                f"engine, under the {scaling_floor:.1f}x "
                f"(= {SCALEOUT_FLOOR_PER_ENGINE} x N) floor"
            )
        retraces_total = fleet_sum["retraces"] + single_sum["retraces"]

        # ---- phase 2: affinity vs random (paced, un-overloaded) -----
        # Pace arrivals off the fleet's MEASURED saturated rate so the
        # comparison runs at a known utilization on any host: loaded
        # enough that placement quality shows up in queue tails, not
        # so loaded that a backlog drowns both policies equally.
        fleet_rate = max(fleet_sum["tokens_per_sec"], 1e-9)
        paced_window_s = (
            streams * (max_new_tokens + 1)
            / (PACED_UTILIZATION * fleet_rate)
        )
        paced = synth(streams, 1, paced_window_s, "steady")
        log(
            f"paced window {paced_window_s:.1f}s virtual "
            f"(~{PACED_UTILIZATION:.0%} of {fleet_rate:.0f} tok/s)"
        )
        _r_aff, _d_aff, affinity_sum = fleet_pass(
            engines, "slo", paced, seed_offset=11
        )
        _r_rnd, _d_rnd, random_sum = fleet_pass(
            engines, "random", paced, seed_offset=13
        )
        retraces_total += (
            affinity_sum["retraces"] + random_sum["retraces"]
        )
        log(
            f"affinity ttft p99 {affinity_sum['ttft_p99_ms']:.1f}ms "
            f"(hit rate {affinity_sum['affinity_hit_rate']:.2f}) vs "
            f"random {random_sum['ttft_p99_ms']:.1f}ms"
        )
        if (
            affinity_sum["ttft_p99_ms"]
            >= random_sum["ttft_p99_ms"]
        ):
            failures.append(
                f"prefix-affinity TTFT p99 "
                f"{affinity_sum['ttft_p99_ms']}ms did not beat random "
                f"routing's {random_sum['ttft_p99_ms']}ms"
            )

        # ---- phase 3: mid-run engine kill (zero lost, parity) -------
        # Arrivals paced near saturation so the victim engine is
        # mid-flight (running + queued work) when it dies.
        kill_window_s = (
            kill_streams * (max_new_tokens + 1)
            / (KILL_UTILIZATION * fleet_rate)
        )
        kill_records = sorted(
            synth(kill_streams, 2, kill_window_s, "steady"),
            key=lambda r: r["offset_ms"],
        )
        # Uninterrupted reference: ONE dense front door serving the
        # same prompts (its parity to the per-stream speculative
        # reference is pinned in the front-door tests).
        ref_engine = make_frontdoor(_VirtualClock(), paged=False)
        ref_ids = [
            ref_engine.submit(
                _prompt_text(r),
                tenant=r["tenant"],
                max_new_tokens=max_new_tokens,
                stop_at_eos=False,
                prefix=(
                    _prefix_text(r["prefix_group"])
                    if r.get("prefix_group")
                    else None
                ),
            )
            for r in kill_records
        ]
        ref_results = ref_engine.run()
        kill_router, kill_drive, kill_sum = fleet_pass(
            engines, "slo", kill_records, seed_offset=17,
            kill_engine=0, kill_after=max(2, kill_streams // 2),
        )
        retraces_total += kill_sum["retraces"]
        kill_results = kill_router.results()
        lost = [
            gid for gid in kill_drive["routed"]
            if gid not in kill_results
        ]
        mismatched = 0
        for (gid, record), rid in zip(
            kill_drive["routed"].items(), ref_ids
        ):
            if kill_results.get(gid) != ref_results.get(rid):
                mismatched += 1
        kill_scenario = {
            "streams": len(kill_records),
            "killed_engine": 0,
            "rebalanced": kill_router.rebalanced,
            "lost_requests": len(lost),
            "mismatched_streams": mismatched,
            "shed": kill_drive["shed"],
        }
        log(
            f"kill: rebalanced {kill_router.rebalanced}, lost "
            f"{len(lost)}, mismatched {mismatched}"
        )
        if kill_drive["shed"]:
            failures.append(
                f"kill phase shed {kill_drive['shed']} requests "
                "(queues must absorb a drain)"
            )
        if kill_router.rebalanced < 1:
            failures.append(
                "the kill interrupted no live work — drain/adopt "
                "was not exercised"
            )
        if len(lost) > LOST_REQUEST_CEILING:
            failures.append(
                f"{len(lost)} requests lost across the engine kill "
                "(ceiling 0)"
            )
        if mismatched:
            failures.append(
                f"{mismatched} streams diverged from the "
                "uninterrupted reference after the kill"
            )
        if retraces_total > SPEC_RETRACE_CEILING:
            failures.append(
                f"{retraces_total} steady-state recompiles across "
                "fleet passes (ceiling 0)"
            )
    finally:
        if owned_audit:
            jitaudit.uninstall()

    return {
        "seed": seed,
        "engines": engines,
        "streams": streams,
        "max_slots": max_slots,
        "k": k,
        "max_new_tokens": max_new_tokens,
        "tenants": tenants,
        "prefix_groups": prefix_groups,
        "prefix_rate": prefix_rate,
        "paged": True,
        "block_size": block_size,
        "self_draft": True,
        "slo": {
            "ttft_ms": round(ttft_slo_s * 1000.0, 1),
            "tpot_ms": round(tpot_slo_s * 1000.0, 2),
        },
        "paced_window_s": round(paced_window_s, 2),
        "kill_window_s": round(kill_window_s, 2),
        "fleet": fleet_sum,
        "single": single_sum,
        "router_goodput_ratio": round(goodput_ratio, 3),
        "router_throughput_ratio": round(throughput_ratio, 3),
        "router_scaling_floor": round(scaling_floor, 3),
        "affinity": affinity_sum,
        "random": random_sum,
        "router_affinity_ttft_p99_ms": affinity_sum["ttft_p99_ms"],
        "router_random_ttft_p99_ms": random_sum["ttft_p99_ms"],
        "router_affinity_hit_rate": affinity_sum["affinity_hit_rate"],
        "spec_retrace_count": retraces_total,
        "kill_scenario": kill_scenario,
        "router_lost_requests": len(lost),
        "gates": {
            "scaleout_floor_per_engine": SCALEOUT_FLOOR_PER_ENGINE,
            "spec_retrace_ceiling": SPEC_RETRACE_CEILING,
            "lost_request_ceiling": LOST_REQUEST_CEILING,
        },
        "failures": failures,
        "passed": not failures,
    }
