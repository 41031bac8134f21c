"""Real ICI-domain fault injection (the port of
``tpuslo/chaos/ici_contention.py``).

Two injection mechanisms, both producing *measured* (non-synthetic)
``tpu_ici``-domain evidence:

* **Contention** (one device per rank): a compute storm (bf16 matmuls
  dispatched by a background thread) queues work on the device the
  collective prober measures, so the prober's
  ``ici_collective_latency_ms`` readings degrade for real:
  device-queue contention, labelled as such (``mechanism:
  device_contention``).  The prober is the port's
  :class:`~tpuslo_torch.parallel.collectives.CollectiveSuite`, which runs
  inside an initialised process group: one NCCL rank on the card
  (:func:`run_contention` starts it, as ``icibench`` does), N gloo ranks
  on the CPU.  A one-rank NCCL group launches no kernel for all_reduce,
  all_gather or reduce_scatter, so on one card the prober's CUDA events
  bracket stream order only; the storm therefore runs on the prober's
  stream, the device's default stream, where its matmuls queue between
  the events.  JAX's one-device psum has the same property on its one
  device queue.  The report names the transport.

* **Delayed-host straggler** (multi-process barrier): N OS processes
  rendezvous over a localhost TCP barrier per launch; one host sleeps
  before arriving.  Each process measures its own barrier wait, the
  quantity a per-host collective-latency probe observes on a real slice
  (the straggler sails through, everyone else waits), and emits
  schema-valid per-host probe events that
  :class:`tpuslo_torch.correlation.multihost.SliceJoiner` joins into a
  straggler incident naming the delayed host.  Real IPC, real waiting,
  real skew; only the *cause* of the delay is simulated.  One addition
  to the JAX protocol: the coordinator releases the hosts together once
  all have connected (a start gate), so the hosts' start-up skew (an
  interpreter and its imports, seconds under load) is not read as a
  straggler in the first launch.  The events and the report are JAX's.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Any

_MSG = struct.Struct(">II")  # (host_index, launch_id)
_GO = 0xFFFFFFFF  # the start gate's launch id


# --------------------------------------------------------------------------
# Mode A: collective contention on a shared device
# --------------------------------------------------------------------------


class _ComputeStorm:
    """Background thread dispatching large bf16 matmuls at ``device``,
    on its default stream (the prober's)."""

    def __init__(self, size: int = 1024, device=None):
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.dispatched = 0
        self._size = size
        self._device = device

    def __enter__(self) -> "_ComputeStorm":
        import torch

        device = torch.device(self._device or "cpu")
        cuda = device.type == "cuda"

        def burn(x):
            for _ in range(4):
                x = x @ x
            return x

        def wait() -> None:
            if cuda:  # bound the queue depth: wait for the burns queued so far
                event = torch.cuda.Event()
                event.record(torch.cuda.default_stream(device))
                event.synchronize()

        x = torch.ones((self._size, self._size), dtype=torch.bfloat16, device=device)
        burn(x)  # cuBLAS handle and workspace set up outside the storm
        wait()

        def loop():
            # torch.cuda.stream(None) is a no-op: the CPU has no stream
            with torch.cuda.stream(torch.cuda.default_stream(device) if cuda else None):
                y = x
                while not self._stop.is_set():
                    y = burn(y)
                    self.dispatched += 1
                    if self.dispatched % 8 == 0:
                        wait()
                wait()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)


def measure_contention(
    mesh=None,
    payload_kb: int = 1024,
    reps: int = 10,
    storm_size: int = 1024,
    node: str = "",
    slice_id: str = "chaos-slice",
    host_index: int = 0,
) -> dict[str, Any]:
    """The measured half of :func:`contention_injection`: collective
    latency over ``mesh`` (every rank of the initialised group by
    default) with and without a co-located storm, and the contended
    phase's probe events.  Every rank of the group calls it."""
    from tpuslo_torch.parallel.collectives import CollectiveSuite, probes_to_events

    node = node or os.uname().nodename
    suite = CollectiveSuite(mesh=mesh, payload_bytes=payload_kb * 1024)
    baseline = suite.measure(reps=reps)
    with _ComputeStorm(size=storm_size, device=suite.mesh.device) as storm:
        contended = suite.measure(reps=reps)
    events = [
        e.to_dict()
        for e in probes_to_events(
            contended, node=node, slice_id=slice_id, host_index=host_index
        )
    ]
    base_p95 = max(p.p95_ms for p in baseline)
    cont_p95 = max(p.p95_ms for p in contended)
    n = suite.n_devices
    return {
        "injector": "ici_contention",
        "mechanism": "device_contention",
        "real": True,
        "n_devices": n,
        "transport": f"{suite.mesh.backend}, {'one rank' if n == 1 else f'{n} ranks'}",
        "device": str(suite.mesh.device),
        "storm_dispatches": storm.dispatched,
        "baseline_p95_ms": round(base_p95, 3),
        "contended_p95_ms": round(cont_p95, 3),
        "degradation": round(cont_p95 / max(base_p95, 1e-9), 2),
        "events": events,
    }


def contention_attribution(contended_p95_ms: float, attributor=None) -> dict[str, Any]:
    """Attribute a fault sample built from the measured contended p95
    alone (no synthetic profile), as the JAX injector does, with
    ``attributor`` (default: a fresh ``calibrated_attributor()``)."""
    from tpuslo_torch.attribution.calibrate import calibrated_attributor
    from tpuslo_torch.attribution.mapper import FaultSample

    sample = FaultSample(
        incident_id="chaos-ici-contention",
        timestamp=datetime.now(timezone.utc),
        cluster="local",
        namespace="llm",
        service="icibench",
        fault_label="ici_drop",
        expected_domain="tpu_ici",
        signals={"ici_collective_latency_ms": contended_p95_ms},
        confidence=0.9,
        burn_rate=2.0,
        window_minutes=5,
        request_id="chaos-req-ici",
        trace_id="chaos-trace-ici",
    )
    prediction = (attributor or calibrated_attributor()).attribute_sample(sample)
    return {
        "predicted_domain": prediction.predicted_fault_domain,
        "confidence": round(prediction.confidence, 4),
        "from_real_signals": True,
    }


def contention_injection(
    mesh=None,
    payload_kb: int = 1024,
    reps: int = 10,
    storm_size: int = 1024,
    node: str = "",
    slice_id: str = "chaos-slice",
    host_index: int = 0,
) -> dict[str, Any]:
    """Measure collective latency with and without a co-located storm.

    Returns a report with baseline/contended stats, the measured probe
    events (as dicts) from the contended phase, and an attribution of a
    fault sample built from the REAL contended measurements.  Runs inside
    an initialised process group (see :func:`run_contention`)."""
    report = measure_contention(mesh, payload_kb, reps, storm_size, node, slice_id,
                                host_index)
    report["attribution"] = contention_attribution(report["contended_p95_ms"])
    return report


def _contention_rank(rank: int, world: int, device: str, payload_kb: int, reps: int,
                     storm_size: int) -> dict[str, Any]:
    """One rank of :func:`run_contention`: the probe over every rank."""
    from tpuslo_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.tp_mesh(world, devices=[mesh_mod.rank_device(device, rank)])
    return measure_contention(mesh=mesh, payload_kb=payload_kb, reps=reps,
                              storm_size=storm_size)


def run_contention(
    payload_kb: int = 1024,
    reps: int = 10,
    storm_size: int = 1024,
    cpu_ranks: int = 0,
) -> dict[str, Any]:
    """:func:`contention_injection` in a group of its own: one NCCL rank
    on the card (``cpu_ranks=0``; raises without one), or ``cpu_ranks``
    gloo ranks on the CPU.  Rank 0's report, attributed here (the
    attributor is fitted, seconds of numpy, while the ranks measure)."""
    from concurrent.futures import ThreadPoolExecutor

    from tpuslo_torch.attribution.calibrate import calibrated_attributor
    from tpuslo_torch.parallel.mesh import run_ranks

    if cpu_ranks > 0:
        world, backend, device = cpu_ranks, "gloo", "cpu"
    else:
        from tpuslo_torch.device import resolve_device

        resolve_device("cuda")
        world, backend, device = 1, "nccl", "cuda"
    with ThreadPoolExecutor(1) as pool:
        fitted = pool.submit(calibrated_attributor)
        report = run_ranks(_contention_rank, world, backend, device,
                           args=(device, payload_kb, reps, storm_size))[0]
        report["attribution"] = contention_attribution(report["contended_p95_ms"],
                                                       fitted.result())
    return report


# --------------------------------------------------------------------------
# Mode B: delayed-host straggler over a real TCP barrier
# --------------------------------------------------------------------------


def _recv_exact(conn: socket.socket, n: int) -> bytes | None:
    """Read exactly ``n`` bytes or None on EOF.

    TCP recv() may return any prefix of the requested size; a short
    read of the 8-byte barrier message would make the coordinator
    return early (hosts then block forever at the rendezvous) or trip
    the host-side length check mid-injection.
    """
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


@dataclass
class BarrierHostResult:
    """One host's measured barrier waits, as probe-event dicts."""

    host_index: int
    events: list[dict] = field(default_factory=list)


def _barrier_coordinator(
    server: socket.socket, n_hosts: int, launches: int
) -> None:
    """Accept N hosts and release them together; per launch, wait for
    all arrivals then release."""
    conns = []
    for _ in range(n_hosts):
        conn, _addr = server.accept()
        conns.append(conn)
    try:
        for conn in conns:
            conn.sendall(_MSG.pack(0, _GO))
        for launch in range(launches):
            for conn in conns:
                raw = _recv_exact(conn, _MSG.size)
                if raw is None:
                    return
                _host, got = _MSG.unpack(raw)
                if got != launch:
                    raise RuntimeError(f"barrier out of step: launch {got}, expected {launch}")
            for conn in conns:
                conn.sendall(_MSG.pack(0, launch))
    finally:
        for conn in conns:
            conn.close()


def barrier_host(
    port: int,
    host_index: int,
    launches: int,
    delay_ms: float,
    delayed_host: int,
    slice_id: str = "chaos-slice",
    compute_ms: float = 2.0,
) -> BarrierHostResult:
    """One host's life: compute, (maybe) delay, barrier, measure wait.

    The measured wait is what a per-host collective probe sees: the
    delayed host arrives last and is released immediately (short wait);
    every other host queues at the rendezvous (long wait).
    """
    from tpuslo_torch.schema import ProbeEventV1, TPURef

    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    result = BarrierHostResult(host_index=host_index)
    try:
        if _recv_exact(sock, _MSG.size) != _MSG.pack(0, _GO):
            raise RuntimeError("coordinator closed before the start gate")
        for launch in range(launches):
            time.sleep(compute_ms / 1000.0)
            if host_index == delayed_host:
                time.sleep(delay_ms / 1000.0)
            t0 = time.perf_counter()
            sock.sendall(_MSG.pack(host_index, launch))
            raw = _recv_exact(sock, _MSG.size)
            if raw is None:
                raise RuntimeError("coordinator closed mid-barrier")
            wait_ms = (time.perf_counter() - t0) * 1000.0
            event = ProbeEventV1(
                ts_unix_nano=int(time.time() * 1e9),
                signal="ici_collective_latency_ms",
                node=f"chaos-host-{host_index}",
                namespace="llm",
                pod=f"agent-{host_index}",
                container="agent",
                pid=os.getpid(),
                tid=host_index,
                value=wait_ms,
                unit="ms",
                status="ok",
                tpu=TPURef(
                    chip="accel0",
                    slice_id=slice_id,
                    host_index=host_index,
                    ici_link=-1,
                    program_id="chaos_allreduce",
                    launch_id=launch,
                ),
            )
            result.events.append(event.to_dict())
    finally:
        sock.close()
    return result


def _worker_main(argv: list[str]) -> int:
    """Subprocess entry: run one barrier host, print events as JSONL."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host-index", type=int, required=True)
    p.add_argument("--launches", type=int, required=True)
    p.add_argument("--delay-ms", type=float, required=True)
    p.add_argument("--delayed-host", type=int, required=True)
    args = p.parse_args(argv)
    result = barrier_host(
        args.port, args.host_index, args.launches, args.delay_ms,
        args.delayed_host,
    )
    for event in result.events:
        print(json.dumps(event))
    return 0


def run_straggler_injection(
    n_hosts: int = 3,
    launches: int = 6,
    delay_ms: float = 150.0,
    delayed_host: int = 1,
    in_process: bool = False,
) -> dict[str, Any]:
    """Drive the full delayed-host injection and SliceJoiner attribution.

    ``in_process=False`` runs each host as a separate OS process (the
    real deployment shape: one agent per host); ``in_process=True``
    uses threads (fast unit tests).  Either way the barrier, the
    delays, and the measured waits are real.
    """
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(n_hosts)
    port = server.getsockname()[1]

    coord = threading.Thread(
        target=_barrier_coordinator, args=(server, n_hosts, launches),
        daemon=True,
    )
    coord.start()

    events: list[dict] = []
    if in_process:
        results: list[BarrierHostResult | None] = [None] * n_hosts
        threads = []
        for host in range(n_hosts):
            def run(h=host):
                results[h] = barrier_host(
                    port, h, launches, delay_ms, delayed_host
                )
            t = threading.Thread(target=run, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=120)
        for r in results:
            if r is not None:
                events.extend(r.events)
    else:
        procs = []
        for host in range(n_hosts):
            procs.append(
                subprocess.Popen(
                    [
                        sys.executable, "-m", "tpuslo_torch.chaos.ici_contention",
                        "--worker", "--port", str(port),
                        "--host-index", str(host),
                        "--launches", str(launches),
                        "--delay-ms", str(delay_ms),
                        "--delayed-host", str(delayed_host),
                    ],
                    stdout=subprocess.PIPE,
                    text=True,
                )
            )
        try:
            for proc in procs:
                out, _ = proc.communicate(timeout=300)
                for line in out.splitlines():
                    if line.strip():
                        events.append(json.loads(line))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    coord.join(timeout=30)
    server.close()

    from tpuslo_torch.correlation.multihost import SliceJoiner

    joiner = SliceJoiner(expected_hosts=n_hosts)
    joiner.add_all(events)
    incidents = [i.to_dict() for i in joiner.incidents(min_hosts=n_hosts)]
    attributed = [
        i for i in incidents if i["straggler_host"] == delayed_host
    ]
    return {
        "injector": "ici_straggler",
        "mechanism": "delayed_host_barrier",
        "real": True,
        "n_hosts": n_hosts,
        "launches": launches,
        "delay_ms": delay_ms,
        "delayed_host": delayed_host,
        "events_measured": len(events),
        "incidents": incidents,
        "correct_attributions": len(attributed),
        "top_confidence": max(
            (i["confidence"] for i in attributed), default=0.0
        ),
    }


if __name__ == "__main__":
    if "--worker" in sys.argv:
        argv = [a for a in sys.argv[1:] if a != "--worker"]
        raise SystemExit(_worker_main(argv))
    raise SystemExit(
        print(json.dumps(run_straggler_injection(), indent=2)) or 0
    )
