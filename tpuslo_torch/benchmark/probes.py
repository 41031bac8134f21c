"""Card probes behind two readings of the serving benches.

``exactness``: the front-door bench's spot check at one model's widths,
over several prompts and one dtype: the stream of a 2-slot front door
against :class:`~tpuslo_torch.models.speculative.SpeculativeEngine`'s
single stream, 96 greedy tokens each, as the bench checks it.  Prints
the first token where they part (``null``: identical)::

    python -m tpuslo_torch.benchmark.probes exactness --dtype bfloat16

``router``: the router bench at its defaults, several times, with each
front-door admission timed by the prefix state it met (a cold fill, a
warm snapshot, a plain prompt, a parked row)::

    python -m tpuslo_torch.benchmark.probes router --runs 3

Both print one JSON object per line and serve on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from tpuslo_torch.benchmark import frontdoor_bench, router_bench
from tpuslo_torch.cli.loadgen import synthesize_requests
from tpuslo_torch.models import frontdoor, llama, serve, speculative


def exactness(dtype: str, prompts: int, tokens: int, device: str) -> list[dict]:
    cfg = dataclasses.replace(llama.llama32_3b(max_seq_len=192), dtype=getattr(torch, dtype))
    target = serve.ServeEngine(cfg, rng_seed=0, device=device)
    draft = serve.ServeEngine(cfg, rng_seed=0, device=device)
    spec = speculative.SpeculativeEngine(target, draft, k=4)
    records = synthesize_requests(profile="chat_short", rps=prompts, duration_s=1.0, seed=1337,
                                  arrival="burst", tenants=4, tenant_mix="40,30,20,10")
    rows = []
    for record in records[:prompts]:
        prompt = frontdoor_bench._prompt_text(record)
        fd = frontdoor.FrontDoorEngine(target, draft, k=4, max_slots=2, rounds_per_step=3)
        rid = fd.submit(prompt, max_new_tokens=tokens, stop_at_eos=False)
        got = fd.run()[rid]
        want = spec.generate(prompt, max_new_tokens=tokens, stop_at_eos=False)
        parted = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        rows.append({"probe": "exactness", "dtype": dtype, "prompt": prompt,
                     "tokens": len(got), "parted_at": parted})
    return rows


def router(runs: int, device: str) -> list[dict]:
    costs: dict[str, list[float]] = {}
    admit = frontdoor.FrontDoorEngine._admit

    def timed(self, slot, req):
        if req.parked is not None:
            kind = "parked"
        elif not req.prefix:
            kind = "plain"
        else:
            kind = "warm" if self.target.prefix_warm(req.prefix) else "cold"
        t0 = time.perf_counter()
        try:
            return admit(self, slot, req)
        finally:
            costs.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)

    frontdoor.FrontDoorEngine._admit = timed
    rows = []
    try:
        for run in range(runs):
            costs.clear()
            t0 = time.perf_counter()
            report = router_bench.run_router_bench(device=device)
            admits = {kind: {"n": len(v), "median_ms": sorted(v)[len(v) // 2]}
                      for kind, v in costs.items()}
            rows.append({
                "probe": "router", "run": run, "seconds": time.perf_counter() - t0,
                "passed": report["passed"], "failures": report["failures"],
                **{f"{side}_ttft_{q}_ms": report[side][f"ttft_{q}_ms"]
                   for side in ("affinity", "random") for q in ("p50", "p99")},
                "affinity_hit_rate": report["router_affinity_hit_rate"], "admissions": admits,
            })
    finally:
        frontdoor.FrontDoorEngine._admit = admit
    return rows


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpuslo_torch.benchmark.probes",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="probe", required=True)
    ex = sub.add_parser("exactness")
    ex.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ex.add_argument("--prompts", type=int, default=4)
    ex.add_argument("--tokens", type=int, default=96)
    rt = sub.add_parser("router")
    rt.add_argument("--runs", type=int, default=3)
    for q in (ex, rt):
        q.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.probe == "exactness":
        rows = exactness(args.dtype, args.prompts, args.tokens, args.device)
    else:
        rows = router(args.runs, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
