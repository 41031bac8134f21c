"""`tpuslo_torch icibench`: active collective latency prober (the port of
``tpuslo/cli/icibench.py``, with the same flags and output).

Runs measured collectives over a mesh and emits schema-validated
``ici_collective_latency_ms`` probe events (JSONL), plus a human summary
on stderr.

    # the card: one NCCL rank (on a single rank NCCL moves no bytes
    # between devices; this times what a launch of each op costs)
    python -m tpuslo_torch icibench --reps 10

    # N gloo ranks on the CPU (tests, laptops)
    python -m tpuslo_torch icibench --force-cpu-devices 8

    # real cross-process collectives: N OS processes in one gloo group;
    # optionally delay one host and let SliceJoiner attribute it
    python -m tpuslo_torch icibench --multiprocess 3 --delay-host 1

Flags are validated before any process group starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

VALID_OPS = ("psum", "all_gather", "reduce_scatter", "ppermute")


def write_text_atomic(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a temporary file and an atomic
    rename: the file exists complete or not at all, with the permissions
    a plain ``open(path, "w")`` gives."""
    out_dir = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".tmp")
    try:
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
        os.replace(tmp, path)
        tmp = None
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _write_jsonl(lines: list[str], output: str) -> None:
    """'-' → stdout; else atomic write."""
    if output == "-":
        sys.stdout.writelines(lines)
        return
    write_text_atomic(output, "".join(lines))


def _probe_rank(rank: int, world: int, payload_bytes: int, reps: int, ops: tuple,
                device: str):
    """One rank of a probe over every rank of the group: its probes (each
    rank measures; rank 0's are reported)."""
    from tpuslo_torch.parallel import mesh as mesh_mod
    from tpuslo_torch.parallel.collectives import bench_collectives

    mesh = mesh_mod.tp_mesh(world, devices=[mesh_mod.rank_device(device, rank)])
    probes = bench_collectives(mesh=mesh, payload_bytes=payload_bytes, reps=reps, ops=ops)
    return [p.to_dict() for p in probes]


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="icibench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--payload-kb", type=int, default=1024)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument(
        "--ops", default="psum,all_gather,reduce_scatter,ppermute",
        help="comma-separated collective ops to probe "
        "(--multiprocess measures psum only)",
    )
    p.add_argument("--output", default="-", help="'-' for stdout or a JSONL path")
    p.add_argument("--node", default="tpu-vm-0")
    p.add_argument("--namespace", default="llm")
    p.add_argument("--slice-id", default="")
    p.add_argument("--host-index", type=int, default=-1)
    p.add_argument(
        "--force-cpu-devices", type=int, default=0,
        help="N>0 probes N gloo ranks on the CPU (no card touched)",
    )
    p.add_argument(
        "--multiprocess", type=int, default=0,
        help="N>1 probes REAL cross-process collectives: N OS processes join "
        "one gloo group and measure all_reduce launches over every host",
    )
    p.add_argument(
        "--delay-host", type=int, default=-1,
        help="with --multiprocess: delay this host per launch so the "
        "collective genuinely stalls the punctual hosts; SliceJoiner "
        "must attribute it",
    )
    p.add_argument("--delay-ms", type=float, default=150.0)
    p.add_argument(
        "--n-slices", type=int, default=1,
        help="with --multiprocess: partition hosts into slices; each launch "
        "measures intra-slice AND global rounds and emits the difference "
        "as dcn_transfer_latency_ms",
    )
    p.add_argument(
        "--report", default="",
        help="with --multiprocess: also write the straggler-join report "
        "(incidents, attribution verdicts) as JSON here",
    )
    args = p.parse_args(argv)

    ops = tuple(o.strip() for o in args.ops.split(",") if o.strip())
    unknown = [o for o in ops if o not in VALID_OPS]
    if unknown or not ops:
        print(
            f"icibench: unknown ops {unknown or '(none given)'}; "
            f"valid: {', '.join(VALID_OPS)}",
            file=sys.stderr,
        )
        return 2

    if args.multiprocess > 1:
        return _run_multiprocess(args, ops)

    from tpuslo_torch.parallel.collectives import CollectiveProbe, probes_to_events
    from tpuslo_torch.schema.fastpath import validate_probe_event
    from tpuslo_torch.parallel.mesh import run_ranks

    payload = args.payload_kb * 1024
    if args.force_cpu_devices > 0:
        world, backend, device = args.force_cpu_devices, "gloo", "cpu"
    else:
        import torch

        if not torch.cuda.is_available():
            print("icibench: no CUDA device; pass --force-cpu-devices N to probe N "
                  "gloo ranks on the CPU", file=sys.stderr)
            return 2
        world, backend, device = 1, "nccl", "cuda"
    results = run_ranks(_probe_rank, world, backend, device,
                        args=(payload, args.reps, ops, device))
    probes = [CollectiveProbe(**d) for d in results[0]]
    events = probes_to_events(
        probes,
        node=args.node,
        namespace=args.namespace,
        slice_id=args.slice_id,
        host_index=args.host_index,
    )
    # Validate every event before writing any output: a partial JSONL
    # would read as a complete capture downstream.
    lines = []
    for probe, event in zip(probes, events):
        if not validate_probe_event(event):
            print(f"icibench: schema-invalid event for {probe.op}; no output written",
                  file=sys.stderr)
            return 1
        lines.append(json.dumps(event.to_dict()) + "\n")
    _write_jsonl(lines, args.output)
    for probe in probes:
        print(
            f"icibench: {probe.op:>14} n={probe.n_devices} "
            f"payload={probe.payload_bytes_per_device >> 10}KiB/dev "
            f"p50={probe.p50_ms:.3f}ms p95={probe.p95_ms:.3f}ms ({backend})",
            file=sys.stderr,
        )
    return 0


def _run_multiprocess(args, ops) -> int:
    """Cross-process collective probe; the same output contract as the
    single-process path (schema-validated probe-event JSONL)."""
    from tpuslo_torch.schema.fastpath import validate_probe_payload

    if args.n_slices > 1 and args.multiprocess % args.n_slices:
        print(
            f"icibench: --n-slices {args.n_slices} must divide "
            f"--multiprocess {args.multiprocess} (slices are process groups)",
            file=sys.stderr,
        )
        return 2
    if args.delay_host >= args.multiprocess:
        print(
            f"icibench: --delay-host {args.delay_host} is out of range "
            f"for --multiprocess {args.multiprocess} (hosts are "
            f"0..{args.multiprocess - 1})",
            file=sys.stderr,
        )
        return 2
    if set(ops) != {"psum"} and tuple(ops) != VALID_OPS:
        print("icibench: --multiprocess measures psum only; other --ops are ignored",
              file=sys.stderr)

    from tpuslo_torch.parallel.distributed import run_distributed_probe

    report = run_distributed_probe(
        n_processes=args.multiprocess,
        launches=args.reps,
        payload_kb=args.payload_kb,
        delay_ms=args.delay_ms if args.delay_host >= 0 else 0.0,
        delayed_host=args.delay_host,
        n_slices=args.n_slices,
    )
    lines = []
    for event_dict in report["events"]:
        if not validate_probe_payload(event_dict):
            print("icibench: schema-invalid cross-process event; no output written",
                  file=sys.stderr)
            return 1
        lines.append(json.dumps(event_dict) + "\n")
    _write_jsonl(lines, args.output)
    if args.report:
        summary = {k: v for k, v in report.items() if k != "events"}
        _write_jsonl([json.dumps(summary) + "\n"], args.report)
    print(
        f"icibench: {report['events_measured']} cross-process events "
        f"over {args.multiprocess} hosts, "
        f"{len(report['incidents'])} straggler incidents",
        file=sys.stderr,
    )
    return 0 if not report["errors"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
