#!/usr/bin/env python
"""On-chip e2e incident session: live serve, real fault, real signals
(the port's own copy of ``scripts/demo/e2e_onchip_session.py``).

The loop the reference never closed (its agent main loop never consumed
real probes): the incident's signals are measured on the card while a
real serve runs, go through a ring into the live agent, and come out as
the agent's own probe events, which the matcher joins to the serve's
spans and the calibrated attributor reads.

Topology (one card; the agent opens no CUDA context):

    this script (torch, the card)
      ├─ creates a userspace ring, announces RING_READY
      ├─ ServeEngine(llama32_1b) is built and warmed on the card
      ├─ writes its own {bytes_in_use, bytes_limit} to a stats file
      ├─ spawns `python -m tpuslo_torch agent --probe-source ring` with
      │  TPUSLO_HBM_STATS_PATH naming that file, and waits for the
      │  agent's first row (its sampler's HBM reading from the file):
      │  the sampler re-creates the ring (O_TRUNC) when it opens it, so
      │  nothing is written before then
      ├─ serves requests on the card under `xla_spans.capture`
      ├─ induces an UNPRIVILEGED REAL FAULT: a recompile storm — prefill
      │  at non-bucket shapes, each a new shape's first call plus its
      │  CUDA graph capture (the engines' compile mechanism, recorded in
      │  `compile_events`), timed to a synchronize and written into the
      │  ring as SIG_XLA_COMPILE (F_TPU)
      ├─ writes the card's memory in use into the ring
      │  (SIG_HBM_UTILIZATION)
      ├─ stops the agent with SIGTERM once its JSONL holds every event
      │  written (the agent's drain path: exit 0, reason=signal_15)
      └─ then:
           correlation: agent-emitted probe events joined to the
             capture's launch spans through the matcher (slice_host
             tier — same slice/host identity + time window)
           attribution: an xla_compile-elevated FaultSample built from
             the agent's OWN emitted values -> calibrated attributor
             (no agent row, no attribution: nothing falls back to the
             storm's own times)

Where the JAX session had to change to fit the card: the stats file (so
the agent's sampler touches no device, and ``nvidia-smi`` is checked to
list, during the capture, no more compute apps than it listed before the
agent started and not the agent's pid), the handshake
on the agent's first row instead of a fixed sleep, the bounded end by
SIGTERM, no fallback to the storm's times, and the storm's mechanism (a
CUDA graph capture, not an XLA compile).  The ring is single-producer
(``native/ring.cc``), so once the handshake row is in, the session
empties the stats file and is the ring's only writer.

Writes the bundle (``session.json``, ``attribution.json``,
``agent_onchip.jsonl``, README.md) and exits 1 if any evidence bar
fails (2 without a card).  ``--device cpu`` is the rehearsal: it serves
``llama_tiny`` on the CPU to check the plumbing, and ``session.json``
and the README say so.

Usage: python -m tpuslo_torch.demo.e2e_onchip_session [--out DIR]
           [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent

STORM_COMPILES = 6
STORM_LENGTHS = tuple(range(33, 33 + 2 * STORM_COMPILES, 2))
SERVE_REQUESTS = 3
SERVE_TOKENS = 12
SLICE_ID = "onchip-slice-0"
PROGRAM_ID = "serve-onchip"
NODE = "onchip-host-0"
# The agent's cycle budget: a bound, not the end (the session stops it
# with SIGTERM); ~0.375 s a cycle.
AGENT_CYCLES = 1200
AGENT_FIRST_ROW_S = 90.0  # the agent's start and its first HBM row
AGENT_ROWS_S = 60.0  # every written event in the agent's JSONL
AGENT_DRAIN_S = 30.0  # SIGTERM to exit


def _posterior_context(prediction) -> dict:
    """Why a ~0.2 posterior over 13 domains is a decisive verdict (the
    port's own copy of ``scripts/demo/e2e_multihost_session.py``'s).

    The incident carries ONE elevated signal on an otherwise-baseline
    vector, so the calibrated posterior is deliberately conservative
    (the abstain machinery keeps single-spike incidents humble); the
    decision signals are top-1 identity, the margin over the runner-up,
    and the ratio to the uniform-over-13 floor.
    """
    top3 = [
        {"domain": h.domain, "posterior": round(h.posterior, 4)}
        for h in prediction.fault_hypotheses[:3]
    ]
    uniform = 1.0 / 13
    runner_up = top3[1]["posterior"] if len(top3) > 1 else 0.0
    return {
        "top3": top3,
        "uniform_over_13_domains": round(uniform, 4),
        "posterior_vs_uniform": round(prediction.confidence / uniform, 2),
        "margin_over_runner_up": round(
            prediction.confidence - runner_up, 4
        ),
        "abstained": prediction.predicted_fault_domain == "unknown",
        "note": (
            "single-elevated-signal incident: the calibrated posterior "
            "is deliberately conservative; top-1 identity + margin are "
            "the decision signals, and the slice-join confidences carry "
            "the correlation strength"
        ),
    }


def agent_argv(ring_path: Path, jsonl: Path, device: str) -> list[str]:
    return [
        sys.executable, "-m", "tpuslo_torch", "agent",
        "--probe-source", "ring",
        "--ring-path", str(ring_path),
        "--count", str(AGENT_CYCLES),
        "--interval-s", "0.25",
        "--output", "jsonl",
        "--jsonl-path", str(jsonl),
        "--node", NODE,
        "--slice-id", SLICE_ID,
        "--host-index", "0",
        "--xla-program-id", PROGRAM_ID,
        "--signal-set", "xla_compile_ms,hbm_utilization_pct",
        "--capability-mode", "cuda_full",
        "--metrics-port", "0",
        "--max-overhead-pct", "1000",
        "--device", device,
    ]


def read_rows(path: Path) -> list[dict]:
    """The complete JSON lines of an agent's JSONL (a line still being
    written is left for the next read)."""
    if not path.exists():
        return []
    rows = []
    for line in path.read_text().splitlines(keepends=True):
        if line.endswith("\n") and line.strip():
            rows.append(json.loads(line))
    return rows


def ring_rows(rows: list[dict], signal_name: str | None = None) -> list[dict]:
    """Ring-sourced probe events (the wire identity the producer stamped:
    kind=probe and a tpu block), of one signal when named."""
    return [
        r for r in rows
        if r.get("kind") == "probe" and r.get("tpu")
        and (signal_name is None or r.get("signal") == signal_name)
    ]


def _wait_rows(path: Path, done, timeout_s: float, agent) -> list[dict]:
    """Poll the agent's JSONL until ``done(rows)``, the agent exits or
    ``timeout_s`` passes; returns the last rows read."""
    deadline = time.monotonic() + timeout_s
    rows = read_rows(path)
    while not done(rows) and agent.poll() is None and time.monotonic() < deadline:
        time.sleep(0.05)
        rows = read_rows(path)
    return rows


def memory_reading(torch, device, engine) -> tuple[int, int, str]:
    """(bytes in use, bytes limit, source) of the serving device: the
    caching allocator's live bytes over the card's total memory (what the
    agent's live sampler reads), or on the CPU rehearsal the engine's
    tensors over the host's physical memory."""
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(torch.cuda.memory_allocated(device)), int(total), "cuda_allocator"
    in_use = sum(t.numel() * t.element_size()
                 for t in _tensors(engine.params))
    limit = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(in_use), int(limit), "cpu_rehearsal_params_over_host_memory"


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "element_size"):
        yield tree


def compute_apps() -> list[int] | None:
    """The pids ``nvidia-smi`` lists as compute apps on the card, or None
    where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def agent_added_no_app(before: list[int] | None, during: list[int] | None,
                       agent_pid: int) -> bool:
    """Whether the card held no more compute apps while the agent ran than
    before it started, and not the agent's pid; true where there is no
    ``nvidia-smi`` (the CPU).  Fewer is no fault: a process that ran
    earlier may still have been releasing its context at the first read.
    Where ``nvidia-smi`` sees another PID namespace (every app as pid 1),
    the pid test cannot bind and the count carries the check."""
    if before is None and during is None:
        return True
    if before is None or during is None:
        return False
    return len(during) <= len(before) and agent_pid not in during


def storm_step(torch, llama, graphs, engine, length: int) -> float:
    """One storm step: a prefill at a shape no bucket has, its first call
    plus (on the card) its CUDA graph capture, timed to a synchronize.
    On the card the capture goes into ``engine.compile_events``."""
    from tpuslo_torch.device import synchronize

    cfg, device = engine.cfg, engine.device
    tokens = torch.zeros((1, length), dtype=torch.long, device=device)
    cache = llama.init_kv_cache(cfg, 1, device=device)

    def body():
        return llama.prefill(engine.params, tokens, cache, cfg)

    synchronize(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        graphs.GraphedDispatch(body, "storm_prefill", (tokens,), device,
                               key=f"storm{length}", owner=engine,
                               compile_events=engine.compile_events)
    else:
        body()
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def attribute(compile_rows: list[dict]) -> dict:
    """The calibrated attributor over the agent's own emitted compile
    values (the largest, on an otherwise-baseline vector); without an
    emitted row there is nothing to attribute."""
    from datetime import datetime, timezone

    from tpuslo_torch.attribution.calibrate import calibrated_attributor
    from tpuslo_torch.attribution.mapper import FaultSample
    from tpuslo_torch.signals.generator import profile_for_fault

    measured = [float(e.get("value", 0.0)) for e in compile_rows]
    if not measured:
        return {"predicted_domain": "none", "confidence": 0.0,
                "calibration_context": {}, "measured_compile_ms": None,
                "from_agent_emitted_events": False}
    signals = dict(profile_for_fault("baseline"))
    signals["xla_compile_ms"] = max(measured)
    sample = FaultSample(
        incident_id="e2e-onchip-0001",
        timestamp=datetime.now(timezone.utc),
        cluster="local",
        namespace="llm",
        service="onchip-serve",
        fault_label="",
        expected_domain="",
        signals=signals,
        confidence=0.9,
        burn_rate=2.5,
        window_minutes=5,
        request_id="e2e-onchip-req-0001",
        trace_id="e2e-onchip-trace-0001",
    )
    prediction = calibrated_attributor().attribute_sample(sample)
    return {
        "predicted_domain": prediction.predicted_fault_domain,
        "confidence": round(prediction.confidence, 4),
        "posteriors": {h.domain: h.posterior for h in prediction.fault_hypotheses},
        "calibration_context": _posterior_context(prediction),
        "measured_compile_ms": round(max(measured), 1),
        "from_agent_emitted_events": True,
    }


def join_spans(compile_rows: list[dict], span_refs: list[dict]) -> list[dict]:
    """Each agent compile row's best match among the capture's spans."""
    from datetime import datetime, timezone

    from tpuslo_torch.correlation.matcher import SignalRef, SpanRef, match

    spans = [SpanRef.from_dict(r) for r in span_refs]
    joins = []
    for ev in compile_rows:
        ts_iso = datetime.fromtimestamp(
            ev["ts_unix_nano"] / 1e9, tz=timezone.utc
        ).isoformat()
        sig = SignalRef.from_dict(
            {
                "signal": ev["signal"],
                "timestamp": ts_iso,
                "node": ev.get("node", NODE),
                "slice_id": ev.get("tpu", {}).get("slice_id", SLICE_ID),
                "host_index": ev.get("tpu", {}).get("host_index", 0),
                "program_id": ev.get("tpu", {}).get("program_id", ""),
                "value": float(ev.get("value", 0.0)),
            }
        )
        best = None
        for span in spans:
            d = match(span, sig, window_ms=120_000)
            if d.matched and (best is None or d.confidence > best[0]):
                best = (d.confidence, d.tier)
        if best:
            joins.append({"confidence": best[0], "tier": best[1]})
    return joins


def _stop_agent(agent, err_path: Path) -> dict:
    """SIGTERM, then the agent's exit code and drain line; a kill (past
    ``AGENT_DRAIN_S``) is recorded as one."""
    killed = False
    if agent.poll() is None:
        agent.send_signal(signal.SIGTERM)
        try:
            agent.wait(timeout=AGENT_DRAIN_S)
        except subprocess.TimeoutExpired:
            agent.kill()
            agent.wait()
            killed = True
    err = err_path.read_text() if err_path.exists() else ""
    drain = next((ln for ln in err.splitlines() if ln.startswith("agent: drain:")), "")
    return {"exit_code": agent.returncode, "killed": killed, "drain": drain,
            "stopped_by_sigterm": "reason=signal_15" in drain and not killed}


def run(out: Path, device_name: str, params=None, cfg=None) -> dict:
    """The session; returns ``session.json``'s content.  ``cfg`` and
    ``params`` (a tree on the serving device) replace the model's config
    and its seeded weights."""
    import torch

    from tpuslo_torch.collector import native
    from tpuslo_torch.collector.ringbuf import RingWriter
    from tpuslo_torch.device import resolve_device
    from tpuslo_torch.models import graphs, llama
    from tpuslo_torch.models.serve import ServeEngine
    from tpuslo_torch.ops.launch_counts import kernel_launches
    from tpuslo_torch.otel import xla_spans

    t_session = time.perf_counter()
    parts: dict[str, float] = {}
    mark = [t_session]

    def lap(part: str) -> None:
        now = time.perf_counter()
        parts[part] = now - mark[0]
        mark[0] = now

    rehearsal = device_name == "cpu"
    out.mkdir(parents=True, exist_ok=True)
    device = resolve_device(device_name)
    ring_path = out / "onchip.ring"
    if ring_path.exists():
        ring_path.unlink()
    ring = RingWriter(str(ring_path))
    print(f"RING_READY:{ring_path}", flush=True)

    session: dict = {
        "platform": device.type,
        "device_kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                        else "cpu"),
        "backend": device.type,
        "rehearsal": rehearsal,
        "pid": os.getpid(),
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    print(f"backend: {session['backend']} ({session['device_kind']})", flush=True)

    cfg = cfg or (llama.llama_tiny(max_seq_len=256) if rehearsal
                  else llama.llama32_1b(max_seq_len=512))
    session["model"] = "llama_tiny" if rehearsal else "llama32_1b"
    # One decode chunk is a request's tokens: the JAX engine's default of
    # 64 decodes (and the capture traces) 52 tokens a request no one reads.
    engine = ServeEngine(cfg=cfg, params=params, rng_seed=0,
                         prefill_buckets=(32, 64, 128, 256),
                         decode_chunk_size=SERVE_TOKENS, device=device)
    engine.warmup()
    lap("engine")

    # The agent's sampler reads this file instead of the device.
    stats_path = out / "hbm_stats.json"
    in_use, limit, source = memory_reading(torch, device, engine)
    stats_path.write_text(json.dumps({"bytes_in_use": in_use, "bytes_limit": limit}))
    session["hbm_stats_source"] = source

    # Who holds the card before the agent starts: this process, and the
    # caller where it keeps a CUDA context of its own.
    apps_before = compute_apps() if device.type == "cuda" else None
    session["compute_apps_before_agent"] = apps_before

    agent_jsonl = out / "agent_onchip.jsonl"
    agent_err = agent_jsonl.with_suffix(".stderr.log")
    for stale in (agent_jsonl, agent_err):
        if stale.exists():
            stale.unlink()
    env = {**os.environ, "TPUSLO_HBM_STATS_PATH": str(stats_path),
           "PYTHONPATH": os.pathsep.join(
               p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}
    t0 = time.perf_counter()
    with open(agent_err, "w") as err_fh:
        agent = subprocess.Popen(agent_argv(ring_path, agent_jsonl, device_name),
                                 stdout=subprocess.DEVNULL, stderr=err_fh, cwd=REPO,
                                 env=env)
    try:
        # Handshake: the agent's first row is its sampler's HBM reading,
        # written after the sampler re-created the ring.
        rows = _wait_rows(agent_jsonl, bool, AGENT_FIRST_ROW_S, agent)
        lap("agent_first_row")
        if not rows:
            raise RuntimeError(
                f"the agent wrote no row in {AGENT_FIRST_ROW_S} s (exit "
                f"{agent.poll()}): {agent_err.read_text()[-800:]}")
        # From here on the session is the ring's only producer.
        stats_path.write_text("{}")

        trace_dir = str(out / "xprof")
        serve_tokens = 0
        streams: list[list[int]] = []
        requests: list[dict] = []
        storm: list[dict] = []
        written = {"xla_compile_ms": 0, "hbm_utilization_pct": 0}
        with xla_spans.capture(trace_dir) as cap:
            lap("capture_start")
            # The main path's launches: the serve and the storm, not the
            # warmup before them nor the reference generate after them.
            launches_before = kernel_launches()
            # --- the observed workload: a real serve on this device -----
            for i in range(SERVE_REQUESTS):
                t_req = time.perf_counter()
                events = list(engine.generate(
                    f"incident session request {i}",
                    max_new_tokens=SERVE_TOKENS, stop_at_eos=False,
                ))
                wall = time.perf_counter() - t_req
                streams.append([e.token_id for e in events])
                serve_tokens += len(events)
                requests.append({"ttft_ms": events[0].ttft_ms, "wall_s": wall,
                                 "tokens": len(events),
                                 "tokens_per_sec": len(events) / wall})
            lap("serve")

            # --- the real fault: a recompile storm ---------------------
            for launch, length in enumerate(STORM_LENGTHS):
                wall_ms = storm_step(torch, llama, graphs, engine, length)
                storm.append({"length": length, "wall_ms": round(wall_ms, 1)})
                ring.write_event(
                    signal=native.SIG_XLA_COMPILE,
                    value=int(wall_ms * 1e6),  # ns on the wire
                    ts_ns=time.time_ns(),
                    aux=launch,
                    pid=os.getpid(),
                    flags=native.F_TPU,
                    comm=b"serve-storm",
                )
                written["xla_compile_ms"] += 1
            launches_after = kernel_launches()
            lap("storm")

            # --- memory in use on the serving device --------------------
            in_use, limit, _ = memory_reading(torch, device, engine)
            session["hbm_bytes_in_use"] = in_use
            ring.write_event(
                signal=native.SIG_HBM_UTILIZATION,
                value=min(int(10000 * in_use / limit), 10000),
                ts_ns=time.time_ns(),
                pid=os.getpid(),
                flags=native.F_TPU,
                comm=b"serve-storm",
            )
            written["hbm_utilization_pct"] += 1
            # Who holds the card while the agent runs.
            apps = compute_apps() if device.type == "cuda" else None
        lap("capture_exit")
        session["capture_stages_ms"] = cap.stages_ms
        session["compute_apps"] = apps
        session["serve_tokens"] = serve_tokens
        session["requests"] = requests
        session["storm"] = storm
        session["storm_mechanism"] = "graph_capture" if device.type == "cuda" else "first_call"
        session["xprof_spans"] = len(cap.spans)
        session["capture_module_source"] = cap.module_source
        ring.close()

        # Every event written is in the agent's JSONL (the handshake row
        # already holds one HBM reading), then the drain path.
        def all_in(rows):
            return (len(ring_rows(rows, "xla_compile_ms")) >= written["xla_compile_ms"]
                    and len(ring_rows(rows, "hbm_utilization_pct"))
                    >= 1 + written["hbm_utilization_pct"])

        rows = _wait_rows(agent_jsonl, all_in, AGENT_ROWS_S, agent)
        session["agent_rows_complete"] = all_in(rows)
        lap("agent_rows")
    finally:
        stopped = _stop_agent(agent, agent_err)
    lap("agent_stop")
    session["agent"] = {**stopped, "pid": agent.pid,
                        "seconds": time.perf_counter() - t0}
    agent_events = read_rows(agent_jsonl)
    ring_events = ring_rows(agent_events)
    compile_events = ring_rows(agent_events, "xla_compile_ms")
    session["agent_events"] = len(agent_events)
    session["agent_ring_events"] = len(ring_events)
    session["agent_compile_events"] = len(compile_events)
    session["agent_rows_by_signal"] = {
        s: sum(1 for e in agent_events if e.get("signal") == s)
        for s in sorted({e.get("signal", "") for e in agent_events})
    }
    session["compile_events_recorded"] = sum(
        1 for e in engine.compile_events if e.get("module_name") == "storm_prefill")

    # --- what the capture served is what generate serves ----------------
    plain = [[e.token_id for e in engine.generate(
        f"incident session request {i}", max_new_tokens=SERVE_TOKENS, stop_at_eos=False)]
        for i in range(SERVE_REQUESTS)]
    session["streams"] = streams
    session["streams_equal_generate"] = streams == plain
    lap("generate")

    # --- correlation: agent events <-> capture spans -------------------
    span_refs = cap.span_refs(service="onchip-serve", node=NODE, slice_id=SLICE_ID,
                              host_index=0)
    joins = join_spans(compile_events, span_refs)
    session["span_joins"] = len(joins)
    session["join_top_confidence"] = max((j["confidence"] for j in joins), default=0.0)
    session["join_top_tier"] = (max(joins, key=lambda j: j["confidence"])["tier"]
                                if joins else "none")

    # --- attribution from the agent's OWN emitted values ---------------
    attribution = attribute(compile_events)
    (out / "attribution.json").write_text(json.dumps(attribution, indent=2))
    lap("join_and_attribute")

    verdicts = {
        "live_backend": session["platform"] == "cuda" or rehearsal,
        "agent_consumed_ring": session["agent_ring_events"] >= STORM_COMPILES,
        "storm_measured": len(storm) == STORM_COMPILES
        and all(s["wall_ms"] > 1.0 for s in storm),
        # CPU traces carry no device lanes, so the capture's verdicts bind
        # only on the card (the rehearsal validates the plumbing).
        "xprof_spans_captured": session["xprof_spans"] > 0 or rehearsal,
        "spans_joined": session["span_joins"] >= 1 or rehearsal,
        "attribution_top1_xla_compile": attribution["predicted_domain"] == "xla_compile",
    }
    checks = {
        "from_agent_emitted_events": attribution["from_agent_emitted_events"],
        "agent_exit_0_by_sigterm": stopped["exit_code"] == 0 and stopped["stopped_by_sigterm"],
        # The agent added no compute app (the pids nvidia-smi lists may be
        # another PID namespace's, so they are counted as well as matched).
        "agent_opened_no_cuda_context": agent_added_no_app(apps_before, apps, agent.pid),
        "streams_equal_generate": session["streams_equal_generate"],
    }
    session["attribution"] = attribution
    session["verdicts"] = verdicts
    session["checks"] = checks
    session["kernel_launches"] = {k: launches_after[k] - launches_before[k]
                                  for k in launches_after}
    session["parts_s"] = parts
    session["seconds"] = time.perf_counter() - t_session
    session["pass"] = all(verdicts.values()) and all(checks.values())
    (out / "session.json").write_text(json.dumps(session, indent=2))
    (out / "README.md").write_text(_readme(out, session, storm, attribution, verdicts, checks))
    return session


def _readme(out: Path, session: dict, storm, attribution, verdicts, checks) -> str:
    ctx = attribution.get("calibration_context") or {}
    return (
        f"# On-chip e2e incident session ({out.name})\n\n"
        "A live serve on the card with a real unprivileged fault "
        "(recompile storm via shape churn), observed end-to-end — the "
        "incident's signals were measured on the device, not produced by "
        "the synthetic generator:\n\n"
        "```\n"
        f"ServeEngine({session['model']}) on {session['device_kind']}"
        f" ({session['backend']})\n"
        "  -> recompile storm: non-bucket prefill shapes, each a first call "
        "plus its CUDA graph capture, timed on the wall\n"
        "  -> userspace ring (SIG_XLA_COMPILE, F_TPU)\n"
        "  -> live agent (python -m tpuslo_torch agent --probe-source ring) "
        "-> schema probe events\n"
        "  -> matcher join vs the serve's own spans\n"
        "  -> calibrated attributor\n"
        "```\n\n"
        f"- serve: {session['serve_tokens']} tokens over "
        f"{SERVE_REQUESTS} requests under the capture "
        f"({session['xprof_spans']} spans); TTFT "
        f"{[round(r['ttft_ms'], 2) for r in session['requests']]} ms\n"
        f"- storm: {len(storm)} steps ({session['storm_mechanism']}), walls "
        f"{[s['wall_ms'] for s in storm]} ms\n"
        f"- agent: {session['agent_ring_events']} ring-sourced events "
        f"({session['agent_compile_events']} xla_compile_ms); exit "
        f"{session['agent']['exit_code']} ({session['agent']['drain']})\n"
        f"- joins: {session['span_joins']} @ top "
        f"{session['join_top_confidence']:.2f}\n"
        f"- attribution: {attribution['predicted_domain']} @ "
        f"{attribution['confidence']} (measured "
        f"{attribution['measured_compile_ms']} ms; "
        f"{ctx.get('posterior_vs_uniform')}x uniform floor)\n"
        f"- verdicts: {json.dumps(verdicts)}\n"
        f"- checks: {json.dumps(checks)}\n"
        + (
            "\n**REHEARSAL RUN (CPU)** — not evidence; re-run without "
            "--device cpu on a card.\n"
            if session["rehearsal"]
            else ""
        )
        + "\nRegenerate: `python -m tpuslo_torch.demo.e2e_onchip_session`\n"
    )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="e2e_onchip_session", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--out", default=str(REPO / "build" / "e2e-onchip-session"))
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cpu = the rehearsal at llama_tiny (plumbing validation; NOT evidence)",
    )
    args = parser.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("e2e_onchip_session: no CUDA device; --device cpu runs the rehearsal",
                  file=sys.stderr)
            return 2
    session = run(Path(args.out), args.device)
    print(f"e2e_onchip_session: serve and storm kernel launches "
          f"{json.dumps(session['kernel_launches'])}", file=sys.stderr)
    print(json.dumps({"pass": session["pass"], **session["verdicts"], **session["checks"]},
                     indent=2))
    return 0 if session["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
