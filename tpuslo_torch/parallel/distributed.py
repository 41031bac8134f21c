"""Multi-process distributed collective prober (PyTorch port of
``tpuslo/parallel/distributed.py``).

N OS processes run ``python -m tpuslo_torch.parallel.distributed``, join
one ``torch.distributed`` gloo group on the CPU (a free localhost port,
as JAX's workers join one ``jax.distributed`` runtime with gloo CPU
collectives), run measured cross-process ``all_reduce`` launches and
print one ``ProbeEventV1`` JSON line per measurement carrying (slice,
host, program, launch) identity.

The straggler physics is real: a cross-process collective blocks every
participant until the last one arrives, so when one host is delayed the
punctual hosts' measured latency inflates by the delay while the
straggler sails through, which is the signature
:class:`tpuslo_torch.correlation.multihost.SliceJoiner` attributes.

With ``--n-slices S`` the hosts form S slices of contiguous process ids
(the layout of a mesh's dcn axis): each launch runs an intra-slice round
over the slice's own group, then a global round over every host, and the
global round's excess over the intra round is emitted as
``dcn_transfer_latency_ms``, the cross-slice component.

``python -m tpuslo_torch icibench --multiprocess N`` fronts this.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any

PROGRAM_ID = "dist_psum"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def worker_main(argv: list[str] | None = None) -> int:
    """One distributed host: join the group, measure collectives, print
    one ProbeEventV1 JSON per reading on stdout."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--launches", type=int, default=5)
    p.add_argument("--payload-kb", type=int, default=256)
    p.add_argument("--delay-ms", type=float, default=0.0)
    p.add_argument("--delayed-host", type=int, default=-1)
    p.add_argument("--slice-id", default="dist-slice")
    p.add_argument(
        "--n-slices", type=int, default=1,
        help="partition the hosts into this many slices: each launch "
        "then measures an intra-slice round AND a global round, and "
        "the difference is emitted as dcn_transfer_latency_ms",
    )
    p.add_argument(
        "--ring-path", default="",
        help="also write each measured event into this userspace ring "
        "(the host's agent consumes it)",
    )
    p.add_argument(
        "--hold-before-init-s", type=float, default=0.0,
        help="pause between ring creation and the group's init so an "
        "orchestrator can attach per-host consumers first",
    )
    args = p.parse_args(argv)

    ring = None
    if args.ring_path:
        # The consumer attaches at the writer's head, so the ring exists
        # (and is announced) before the first measured launch.
        from tpuslo_torch.collector.ringbuf import RingWriter

        ring = RingWriter(args.ring_path)
        print(f"RING_READY:{args.ring_path}", flush=True)
    if args.hold_before_init_s > 0:
        time.sleep(args.hold_before_init_s)

    n = args.num_processes
    n_slices = max(1, args.n_slices)
    if n % n_slices:
        raise SystemExit(
            f"--n-slices {n_slices} must divide --num-processes {n}: slices are "
            "process groups"
        )

    import torch
    import torch.distributed as dist

    from tpuslo_torch.collector import native
    from tpuslo_torch.schema import ProbeEventV1, TPURef

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.port}", world_size=n,
        rank=args.process_id,
    )
    me = args.process_id
    per_slice = n // n_slices
    my_slice = me // per_slice
    intra_group = None
    if n_slices > 1:
        # Every process creates every slice's group, in one order.
        for s in range(n_slices):
            g = dist.new_group(list(range(s * per_slice, (s + 1) * per_slice)))
            if s == my_slice:
                intra_group = g
    cols = 256
    rows = max(n, (args.payload_kb * 1024 // (4 * cols) // n) * n)
    x = torch.ones((rows // n, cols), dtype=torch.float32)

    def reduce(group=None) -> float:
        t = x.clone()
        t0 = time.perf_counter()
        dist.all_reduce(t, group=group)
        return (time.perf_counter() - t0) * 1000.0

    if intra_group is not None:
        reduce(intra_group)  # set-up round
    reduce()

    slice_id = f"{args.slice_id}-{my_slice}" if n_slices > 1 else args.slice_id

    def emit(signal_name: str, value_ms: float, native_sig: int, launch: int) -> None:
        """One measured reading: ProbeEventV1 on stdout (and the ring:
        ns value for _ms signals, the launch in aux, F_TPU so the consumer
        lifts it into a TPURef)."""
        event = ProbeEventV1(
            ts_unix_nano=time.time_ns(),
            signal=signal_name,
            node=f"dist-host-{me}",
            namespace="llm",
            pod=f"agent-{me}",
            container="agent",
            pid=os.getpid(),
            tid=me,
            value=value_ms,
            unit="ms",
            status="ok",
            tpu=TPURef(
                chip="accel0",
                slice_id=slice_id,
                host_index=me,
                ici_link=-1,
                program_id=PROGRAM_ID,
                launch_id=launch,
            ),
        )
        print(json.dumps(event.to_dict()), flush=True)
        if ring is not None:
            ring.write_event(
                signal=native_sig, value=int(value_ms * 1e6), ts_ns=event.ts_unix_nano,
                aux=launch, pid=os.getpid(), tid=me, flags=native.F_TPU,
            )

    for launch in range(args.launches):
        if me == args.delayed_host and args.delay_ms > 0:
            time.sleep(args.delay_ms / 1000.0)
        intra_ms = reduce(intra_group) if intra_group is not None else 0.0
        wait_ms = reduce()
        if intra_group is not None:
            # The global round's excess over the slice-local round is the
            # measured cross-slice component; the intra round is the
            # slice-local collective reading.
            emit("dcn_transfer_latency_ms", max(0.0, wait_ms - intra_ms),
                 native.SIG_DCN_TRANSFER, launch)
            wait_ms = intra_ms
        emit("ici_collective_latency_ms", wait_ms, native.SIG_ICI_COLLECTIVE, launch)
    if ring is not None:
        ring.close()
    dist.destroy_process_group()
    return 0


def run_distributed_probe(
    n_processes: int = 2,
    launches: int = 5,
    payload_kb: int = 256,
    delay_ms: float = 0.0,
    delayed_host: int = -1,
    timeout_s: float = 420.0,
    n_slices: int = 1,
) -> dict[str, Any]:
    """Spawn the workers, collect per-host events, join stragglers.

    Returns JAX's report: every measured event, the SliceJoiner incidents
    and, when a host was delayed, whether the join named it.  One deadline
    covers every worker, and the moment one exits non-zero the others are
    killed (they would wait in the collective forever)."""
    port = _free_port()
    procs = []
    for pid in range(n_processes):
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "tpuslo_torch.parallel.distributed",
                    "--process-id", str(pid),
                    "--num-processes", str(n_processes),
                    "--port", str(port),
                    "--launches", str(launches),
                    "--payload-kb", str(payload_kb),
                    "--delay-ms", str(delay_ms),
                    "--delayed-host", str(delayed_host),
                    "--n-slices", str(n_slices),
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    events: list[dict] = []
    errors: list[str] = []
    outputs: list[tuple[str, str]] = [("", "")] * len(procs)

    def _drain(i: int) -> None:
        outputs[i] = procs[i].communicate()

    drains = [threading.Thread(target=_drain, args=(i,), daemon=True)
              for i in range(len(procs))]
    for t in drains:
        t.start()
    deadline = time.monotonic() + timeout_s
    pending = set(range(len(procs)))
    peer_failed = False
    while pending and not peer_failed and time.monotonic() < deadline:
        for i in list(pending):
            if procs[i].poll() is None:
                continue
            pending.discard(i)
            if procs[i].returncode != 0:
                peer_failed = True
        if pending and not peer_failed:
            time.sleep(0.05)
    for i in list(pending):
        procs[i].kill()
        errors.append(
            "worker killed (peer exited nonzero)" if peer_failed else "worker timeout"
        )
    for t in drains:
        t.join(timeout=30.0)
    for proc, (out, err) in zip(procs, outputs):
        if proc.returncode is not None and proc.returncode != 0:
            errors.append((err or "")[-300:])
        for line in (out or "").splitlines():
            if line.strip().startswith("{"):
                events.append(json.loads(line))

    from tpuslo_torch.correlation.multihost import SliceJoiner

    joiner = SliceJoiner(expected_hosts=n_processes)
    joiner.add_all(events)
    # With slicing, an intra-slice group holds n_processes / n_slices hosts:
    # size the completeness guard to the smallest legitimate group.
    min_hosts = max(2, n_processes // n_slices)
    incidents = [i.to_dict() for i in joiner.incidents(min_hosts=min_hosts)]
    report: dict[str, Any] = {
        "mechanism": "torch_distributed_gloo",
        "real": True,
        "n_processes": n_processes,
        "n_slices": n_slices,
        "launches": launches,
        "events_measured": len(events),
        "events": events,
        "errors": errors,
        "incidents": incidents,
    }
    if n_slices > 1:
        dcn = [e["value"] for e in events if e.get("signal") == "dcn_transfer_latency_ms"]
        if dcn:
            report["dcn_transfer_ms_max"] = round(max(dcn), 2)
            report["dcn_events"] = len(dcn)
    if delayed_host >= 0:
        correct = [i for i in incidents if i["straggler_host"] == delayed_host]
        report["delayed_host"] = delayed_host
        report["correct_attributions"] = len(correct)
        report["top_confidence"] = max((i["confidence"] for i in correct), default=0.0)
    return report


if __name__ == "__main__":
    sys.exit(worker_main())
