"""Card probes behind two readings of the serving benches.

``exactness``: the front-door bench's spot check at one model's widths,
over several prompts and one dtype: the stream of a 2-slot front door
against :class:`~tpuslo_torch.models.speculative.SpeculativeEngine`'s
single stream, 96 greedy tokens each, as the bench checks it.  Prints
the first token where they part (``null``: identical)::

    python -m tpuslo_torch.benchmark.probes exactness --dtype bfloat16

``--first-diff`` then finds the op behind a parting.  At the first token
where a prompt's streams part (or at its stream's end where they never
do), the dispatch's target verify pass and draft pass run on identical
inputs for the row alone (B 1, the single stream's 0-d frontier) and as
row 0 of a batch of 2 and of 8 (per-row frontiers, the other rows other
prompts' caches and tokens), with every op's output recorded through
:func:`tpuslo_torch.models.llama.trace_ops`; one line per (prompt, pass,
batch) names the first op whose row-0 bits differ from the lone row's
(``null``: none)::

    python -m tpuslo_torch.benchmark.probes exactness --first-diff

``router``: the router bench at its defaults, several times, with each
front-door admission timed by the prefix state it met (a cold fill, a
warm snapshot, a plain prompt, a parked row), and the TTFT of the paced
affinity and random passes split by the state of the request's prefix
on its replica when it was routed and by that replica's queue depth
then, with each replica's share of the requests::

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
from tpuslo_torch.models import frontdoor, kv_cache, llama, serve, speculative
from tpuslo_torch.models import router as router_mod


def build_engines(dtype: str, device: str):
    """The probe's model: ``llama32_3b(max_seq_len=192)`` in ``dtype``,
    seed-0 weights, a self-draft (a second engine over the same seed), k 4."""
    cfg = dataclasses.replace(llama.llama32_3b(max_seq_len=192), dtype=getattr(torch, dtype))
    target = serve.ServeEngine(cfg, rng_seed=0, device=device)
    draft = serve.ServeEngine(cfg, rng_seed=0, device=device)
    return target, draft, speculative.SpeculativeEngine(target, draft, k=4)


def prompts_of(n: int) -> list[str]:
    """The front-door bench's first ``n`` prompt texts (its burst of
    four tenants, seed 1337)."""
    records = synthesize_requests(profile="chat_short", rps=n, duration_s=1.0, seed=1337,
                                  arrival="burst", tenants=4, tenant_mix="40,30,20,10")
    return [frontdoor_bench._prompt_text(r) for r in records[:n]]


def _parted(got: list[int], want: list[int]) -> int | None:
    return next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)


def exactness(dtype: str, prompts: int, tokens: int, device: str,
              first_diff: bool = False, engines=None) -> list[dict]:
    """Per prompt, a 2-slot front door with that one request against the
    single stream; with ``first_diff``, :func:`first_diff_rows` at the
    parting token (or the stream's end)."""
    target, draft, spec = engines or build_engines(dtype, device)
    texts = prompts_of(prompts)
    rows = []
    for i, prompt in enumerate(texts):
        fd = frontdoor.FrontDoorEngine(target, draft, k=spec.k, max_slots=2, rounds_per_step=3)
        rid = fd.submit(prompt, max_new_tokens=tokens, stop_at_eos=False)
        got = fd.run()[rid]
        want = spec.generate(prompt, max_new_tokens=tokens, stop_at_eos=False)
        parted = _parted(got, want)
        rows.append({"probe": "exactness", "dtype": dtype, "slots": 2, "prompt": prompt,
                     "tokens": len(got), "parted_at": parted})
        if first_diff:
            others = texts[:i] + texts[i + 1:]
            rows += first_diff_rows(spec, prompt, want, parted, others)
    return rows


def exactness_batched(dtype: str, slots: int, tokens: int, device: str,
                      engines=None) -> list[dict]:
    """``slots`` prompts submitted together to one front door of
    ``slots`` slots (one batched admission), each stream against the
    single stream of its prompt."""
    target, draft, spec = engines or build_engines(dtype, device)
    texts = prompts_of(slots)
    fd = frontdoor.FrontDoorEngine(target, draft, k=spec.k, max_slots=slots, rounds_per_step=3)
    rids = [fd.submit(p, max_new_tokens=tokens, stop_at_eos=False) for p in texts]
    results = fd.run()
    rows = []
    for prompt, rid in zip(texts, rids):
        want = spec.generate(prompt, max_new_tokens=tokens, stop_at_eos=False)
        rows.append({"probe": "exactness", "dtype": dtype, "slots": slots, "prompt": prompt,
                     "tokens": len(results[rid]), "parted_at": _parted(results[rid], want)})
    return rows


def _lone_caches(engine, ids: list[int]):
    """A single-row cache holding ``ids[:-1]`` (a lone prefill)."""
    _logits, cache = engine.prefill_ids(ids[:-1])
    return cache


def _stack(caches: list[dict]) -> dict:
    """Row caches (each ``(L, 1, T, ...)``) as one batch cache."""
    def cat(leaves):
        if isinstance(leaves[0], dict):
            return {key: torch.cat([x[key] for x in leaves], dim=1) for key in leaves[0]}
        return torch.cat(leaves, dim=1)

    return {side: cat([c[side] for c in caches]) for side in ("k", "v")}


def _traced_pass(run) -> list[tuple[str, int | None, torch.Tensor]]:
    """Every op's row-0 output of one pass, in order."""
    seen = []
    with llama.trace_ops(lambda op, layer, t: seen.append((op, layer, t[0].clone()))):
        run()
    return seen


def _first_op(lone, batched) -> dict:
    for (op, layer, a), (_op, _layer, b) in zip(lone, batched):
        if not torch.equal(a, b):
            diff = (a.float() - b.float()).abs().max().item()
            return {"first_op": op, "layer": layer, "max_abs_diff": diff}
    return {"first_op": None, "layer": None, "max_abs_diff": 0.0}


def first_diff_rows(spec, prompt: str, want: list[int], parted: int | None,
                    others: list[str], batches=(2, 8)) -> list[dict]:
    """At token ``parted`` of the single stream ``want`` (its end if
    None) the round's target verify pass and draft pass, row alone and
    as row 0 of each batch in ``batches``; one row per (pass, batch)."""
    t, d, k = spec.target, spec.draft, spec.k
    at = len(want) - 1 if parted is None else max(parted, 1)
    prefix_ids, suffix_ids = speculative.joint_prompt_ids(t, d, prompt)
    ctx = prefix_ids + suffix_ids + want[:at]
    chunk = [ctx[-1]] + (want[at:] + [ctx[-1]] * k)[:k]
    fill = [speculative.joint_prompt_ids(t, d, o) for o in others]
    fill = [p + s for p, s in fill] or [ctx]
    rows = []
    for n in batches:
        row_ids = [ctx] + [fill[j % len(fill)] for j in range(n - 1)]
        chunks = [chunk] + [(ids[-1:] + ids[: k])[: k + 1] for ids in row_ids[1:]]
        for name, engine in (("verify", t), ("draft", d)):
            per_row = [_lone_caches(engine, ids) for ids in row_ids]
            results = {}
            for label, caches in (("lone", per_row[:1]), ("batch", per_row)):
                B = len(caches)
                cache = _stack([{s: kv_cache.kv_map(torch.clone, c[s]) for s in ("k", "v")}
                                for c in caches])
                fronts = [len(ids) - 1 for ids in row_ids[:B]]
                dev = engine.device
                length = (torch.tensor(fronts[0], device=dev) if B == 1
                          else torch.tensor(fronts, device=dev))
                cache["length"] = length
                if name == "verify":
                    toks = torch.tensor(chunks[:B], device=dev)
                    results[label] = _traced_pass(
                        lambda: llama.verify_chunk(engine.params, toks, cache, engine.cfg))
                else:
                    toks = torch.tensor([c[0] for c in chunks[:B]], device=dev)
                    results[label] = _traced_pass(
                        lambda: llama.decode_step(engine.params, toks, cache, engine.cfg))
            rows.append({"probe": "first_diff", "prompt": prompt, "parted_at": parted,
                         "at": at, "pass": name, "batch": n,
                         **_first_op(results["lone"], results["batch"])})
    return rows


#: The router bench's fleet passes, in the order it serves them.
ROUTER_PASSES = ("scaleout_fleet", "scaleout_single", "affinity", "random", "kill")


def _ttft_split(routed: dict[int, dict], timings: dict[int, dict]) -> dict:
    """TTFT (ms: n, p50, p99) of one pass by the prefix state met at
    routing and by the replica's queue depth then (capped at 4), each
    replica's share of the requests, and what the slowest 1% met."""

    def summary(values: list[float]) -> dict:
        v = sorted(values)
        return {"n": len(v), "p50_ms": v[len(v) // 2] if v else None,
                "p99_ms": v[min(len(v) - 1, int(0.99 * len(v)))] if v else None}

    rows = [(routed[g], t["ttft_s"] * 1e3) for g, t in timings.items() if g in routed]
    by_state: dict[str, list[float]] = {}
    by_depth: dict[str, list[float]] = {}
    engines: dict[int, int] = {}
    for r, ttft in rows:
        by_state.setdefault(r["state"], []).append(ttft)
        by_depth.setdefault(str(min(r["depth"], 4)), []).append(ttft)
        engines[r["engine"]] = engines.get(r["engine"], 0) + 1
    slow = sorted(rows, key=lambda rt: rt[1])[-max(1, len(rows) // 100):]
    return {"ttft_by_state": {k: summary(v) for k, v in sorted(by_state.items())},
            "ttft_by_depth": {k: summary(v) for k, v in sorted(by_depth.items())},
            "requests_by_engine": [engines.get(j, 0) for j in range(max(engines) + 1)]
            if engines else [],
            "slowest_1pct": {"n": len(slow),
                             "states": {s: sum(r["state"] == s for r, _ in slow)
                                        for s in ("warm", "cold", "plain")},
                             "mean_depth": sum(r["depth"] for r, _ in slow) / len(slow)
                             if slow else None}}


def router(runs: int, device: str) -> list[dict]:
    costs: dict[str, list[float]] = {}
    admit = frontdoor.FrontDoorEngine._admit
    route = router_mod.SLORouter.route
    serve_fleet = router_bench._serve_fleet
    arrivals: dict[int, dict[int, dict]] = {}
    passes: list = []

    def routed(self, prompt, tenant="default", max_new_tokens=32, stop_at_eos=True,
               prefix=None):
        gid = route(self, prompt, tenant, max_new_tokens, stop_at_eos, prefix)
        if gid is not None:
            idx, _ = self._placements[gid]
            eng = self.engine(idx)
            state = ("plain" if not prefix else
                     "warm" if eng.target.prefix_warm(prefix) else "cold")
            arrivals.setdefault(id(self), {})[gid] = {
                "engine": idx, "depth": eng.queue_depth - 1, "state": state}
        return gid

    def fleet(router_, clocks, records, *args, **kwargs):
        out = serve_fleet(router_, clocks, records, *args, **kwargs)
        passes.append(router_)
        return out

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
    router_mod.SLORouter.route = routed
    router_bench._serve_fleet = fleet
    rows = []
    try:
        for run in range(runs):
            costs.clear()
            arrivals.clear()
            passes.clear()
            t0 = time.perf_counter()
            report = router_bench.run_router_bench(device=device)
            admits = {kind: {"n": len(v), "median_ms": sorted(v)[len(v) // 2]}
                      for kind, v in costs.items()}
            named = dict(zip(ROUTER_PASSES, passes))
            rows.append({
                "probe": "router", "run": run, "seconds": time.perf_counter() - t0,
                "passed": report["passed"], "failures": report["failures"],
                **{f"{side}_ttft_{q}_ms": report[side][f"ttft_{q}_ms"]
                   for side in ("affinity", "random") for q in ("p50", "p99")},
                "affinity_hit_rate": report["router_affinity_hit_rate"], "admissions": admits,
                "split": {side: _ttft_split(arrivals.get(id(named[side]), {}),
                                            named[side].request_timings())
                          for side in ("affinity", "random") if side in named},
            })
    finally:
        frontdoor.FrontDoorEngine._admit = admit
        router_mod.SLORouter.route = route
        router_bench._serve_fleet = serve_fleet
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
    ex.add_argument("--first-diff", action="store_true",
                    help="name the first op whose row-0 bits depend on the batch")
    rt = sub.add_parser("router")
    rt.add_argument("--runs", type=int, default=3)
    for q in (ex, rt):
        q.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.probe == "exactness":
        rows = exactness(args.dtype, args.prompts, args.tokens, args.device,
                         first_diff=args.first_diff)
    else:
        rows = router(args.runs, args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
