"""Real recompile-storm injector (the port of
``scripts/chaos/injectors/xla_recompile_storm.py``; the scenario keeps
its name, which the attribution mapper keys on).

JAX's storm jits a function and feeds it a new shape every step, so
every step pays a fresh XLA compilation.  The port has no XLA compile:
what its engines record as a compile is a CUDA graph capture
(:class:`tpuslo_torch.models.graphs.GraphedDispatch`, whose captures go
into an engine's ``compile_events``) or the first call of a new shape
(``ServeEngine._record_compile``).  So each step takes a never-repeating
``(n, n)`` bf16 input, runs ``tanh(x @ x.T).sum()`` once eagerly (on a
side stream, as the engines warm a body before capturing it) and then
captures it in a ``torch.cuda.CUDAGraph``; the pair is timed, up to a
synchronise.  ``torch.compile`` is not used: the engines never compile
that way, and it would time Inductor, not what the port calls a compile.

With ``--device cpu`` there is no graph: each step times the first
eager call of its shape and the report says ``mechanism: first_call``.
Without a card that answers it exits 2 with a ``"real": false`` report.
Run next to the serving demo on the same card to create genuine
capture-queue contention.

Usage: python -m tpuslo_torch.chaos.injectors.xla_recompile_storm
           [--steps 30] [--base 128] [--report out.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--base", type=int, default=128)
    p.add_argument("--report", default="")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    if args.device == "cuda":
        from tpuslo_torch.chaos.backend_guard import fail_fast_report

        guard = fail_fast_report("xla_recompile_storm", args.report)
        if guard is not None:
            print(json.dumps(guard))
            return 2

    import torch

    from tpuslo_torch.device import resolve_device

    device = resolve_device(args.device)
    cuda = device.type == "cuda"

    def step(x):
        return torch.tanh(x @ x.T).sum()

    compile_ms = []
    for i in range(args.steps):
        # A never-repeating shape: a new capture (or first call) every step.
        n = args.base + i
        x = torch.ones((n, n), dtype=torch.bfloat16, device=device)
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if cuda:
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                step(x)
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step(x)
            torch.cuda.synchronize(device)
        else:
            step(x)
        compile_ms.append((time.perf_counter() - t0) * 1000.0)

    report = {
        "injector": "xla_recompile_storm",
        "real": True,
        "steps": args.steps,
        "backend": device.type,
        "mechanism": "graph_capture" if cuda else "first_call",
        "compile_ms_p50": sorted(compile_ms)[len(compile_ms) // 2],
        "compile_ms_max": max(compile_ms),
    }
    if args.report:
        with open(args.report, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
