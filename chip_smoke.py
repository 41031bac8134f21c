#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpuslo_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure ends the run with a
non-zero exit and no result line:

1. device: the card's name and power limit (nvidia-smi), device count;
2. build: the flash-attention kernel from ``tpuslo_torch/ops/csrc`` with
   nvcc for sm_90a, its build seconds and ptxas report;
3. kernel vs plain: the kernel against ``flash_attention_reference``
   (f32 on the card) at Llama-3.2-3B's attention widths, at every
   shape the serve phase gives it and a few more, with kernel, plain
   and library (SDPA, a yardstick the port never calls) times and the
   card's lower bound for the same work;
4. serve: a full-depth, full-width ``llama32_3b`` ``ServeEngine`` with
   seeded random weights answers three ``generate`` requests and one
   ``generate_batch``; the kernel's launch count over this phase must
   be one per layer for every flash-eligible prefill;
5. parity: a 2-layer full-width model's prefill logits on the card
   (kernel path) against the same weights on the CPU (plain path);
6. the ``kernels`` JSON line, the card line, and the result line.

It needs one card and imports nothing of JAX or of the JAX package.
Every measurement also goes into one ``record:`` JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate and HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain, two bounds.  Absolute: the kernel rounds its output
# to bf16 (half an ulp is up to 2^-7 for |o| in [2, 4)) and rounds p to
# bf16 before the p.v product where the plain version keeps f32; the JAX
# package's own bf16 kernel test uses the same bound.  Row-scaled: the
# same two roundings are relative to each output row's size, so every
# (b, s, h) row's max error over D, divided by that row's RMS in the
# reference, stays near 2^-6 (a CPU model of the kernel's arithmetic
# gives 0.013-0.016 at these shapes).  Late rows of a long causal
# sequence have RMS ~ sqrt(e/S) (0.036 at S 2048), so the absolute bound
# alone would pass a kernel that drops a key tile there; the row-scaled
# bound fails it by two orders of magnitude.
KERNEL_TOL = 3e-2
KERNEL_ROW_TOL = 2.0**-5
# Card vs CPU logits of the 2-layer model: both run bf16 with f32
# accumulation, but in another summation order and through the kernel
# vs the plain attention; logits are rounded to bf16 by the output
# matmul, whose ulp is 2^-5 for |logit| in [4, 8): 4 ulps there.
PARITY_TOL = 0.125

# The issue's shapes, (B, S, causal) at llama32_3b's H=24, KV=8, D=128;
# the shapes the serve phase gives the kernel are added to these.
SHAPES = (
    (1, 128, True),
    (1, 256, True),
    (4, 256, True),
    (1, 2048, True),
    (1, 256, False),
)
LINE_SHAPE = (1, 256, True)  # the kernels line reports this main-path shape

BUCKETS = (32, 64, 128, 256)  # the engine's prefill buckets
BATCH_BUCKETS = (1, 2, 4, 8)  # generate_batch's default row buckets
# Each generate request's name says how its prompt ingests: a prefill
# at that bucket, or a head prefill at the largest bucket plus chunked
# appends (suffix prefills, plain attention).
PROMPTS = {
    "bucket128": "The quick brown fox jumps over the lazy dog while the "
    "service answers a question about caching and",
    "bucket256": "Retrieval-augmented generation pairs a language model with "
    "a document index: each request embeds the question, fetches the "
    "closest passages, and asks the model to answer from them.",
    "chunked": " ".join(["Service level objectives bound time to first token "
                         "and decode throughput for every tenant."] * 8),
}
BATCH_PROMPTS = [
    "Summarise the incident report in two sentences.",
    "Which fault domain explains a burst of DNS timeouts on one node?",
    "List three causes of high time to first token under load.",
    "Explain prefix caching to a new engineer on the serving team, "
    "with an example of a shared system prompt.",
]
NEW_TOKENS = 32


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def serve_prefills(serve, fa, cfg) -> list[tuple[int, int]]:
    """(B, S) of every flash-eligible prefill the serve phase makes, in
    order: each ``generate`` request's head prefill, then the batch's
    one lockstep chunk.  Suffix prefills run plain attention."""
    cap = cfg.max_seq_len - 2  # the engine's prompt cap
    routes = []
    for name, prompt in PROMPTS.items():
        n = len(serve.encode_bytes(prompt, cap))
        routes.append((name, 1, serve._bucket(min(n, BUCKETS[-1]), BUCKETS), n))
    longest = max(len(serve.encode_bytes(p, cap)) for p in BATCH_PROMPTS)
    routes.append(("batch", serve._bucket(len(BATCH_PROMPTS), BATCH_BUCKETS),
                   serve._bucket(longest, BUCKETS), longest))
    for name, _, bucket, n in routes:
        chunked = n > BUCKETS[-1]
        if (name == "chunked") != chunked or (
            name.startswith("bucket") and name != f"bucket{bucket}"
        ):
            _fail(f"request {name}: {n} prompt ids take bucket {bucket}"
                  f"{' plus chunked appends' if chunked else ''}")
    return [
        (B, S) for _, B, S, _ in routes
        if fa.flash_eligible((B, S, cfg.n_heads, cfg.head_dim), cfg.n_kv_heads)
    ]


def _time_ms(torch, fn, reps: int, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _per_call_ms(torch, fn, reps: int, what: str) -> tuple[float, float]:
    """(ms, back-to-back ms) per call of ``fn``.

    ms is the kernel time the profiler records (CUPTI), summed over
    every kernel ``fn`` launches; it does not include the host's time to
    queue them.  Back-to-back ms is CUDA-event time over ``reps`` calls
    queued in a row, which at small shapes is the host's queueing rate.
    A trace that holds no kernel is taken again, up to five times; after
    that the run fails rather than report another clock under ms.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    event_ms = _time_ms(torch, fn, reps)
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device_us = sum(
            e.self_device_time_total
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
        )
        if device_us > 0:
            return device_us / 1e3 / reps, event_ms
    _fail(f"{what}: five profiler traces held no kernel time")


def _attention_bound(B, S, H, KV, D, causal) -> tuple[float, str]:
    """Least time on the card: each input read once, the output written
    once (bf16), against the operations these inputs need (two products
    of 2*D per visible (query, key) pair; S(S+1)/2 pairs per head when
    causal)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * D * pairs
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KV * D)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_kernel(torch, fa, cfg, serve_shapes) -> dict:
    import torch.nn.functional as F

    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    on_path = {(B, S, True) for B, S in serve_shapes}
    rows = []
    for B, S, causal in sorted(set(SHAPES) | on_path):
        q = torch.randn(B, S, H, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, KV, D, generator=gen, device=dev).bfloat16()
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), causal)
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        ref_rms = ref.pow(2).mean(dim=-1, keepdim=True).sqrt()
        row_err = float((diff / ref_rms).max())
        if not torch.isfinite(out).all() or err > KERNEL_TOL or row_err > KERNEL_ROW_TOL:
            _fail(f"kernel vs plain at B={B} S={S} causal={causal}: max abs err "
                  f"{err} (tol {KERNEL_TOL}), row-scaled {row_err} "
                  f"(tol {KERNEL_ROW_TOL})")
        reps = 20 if S >= 2048 else 50
        what = f"B={B} S={S} causal={causal}"
        ms, ms_b2b = _per_call_ms(
            torch, lambda: fa.flash_attention(q, k, v, causal=causal), reps,
            f"kernel {what}",
        )
        plain_ms, _ = _per_call_ms(
            torch, lambda: fa.flash_attention_reference(q, k, v, causal), 10,
            f"plain {what}",
        )
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms, _ = _per_call_ms(
            torch,
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True
            ),
            reps, f"sdpa {what}",
        )
        bound_ms, bound_by = _attention_bound(B, S, H, KV, D, causal)
        row = {
            "B": B, "S": S, "H": H, "KV": KV, "D": D, "causal": causal,
            "serve_path": (B, S, causal) in on_path,
            "max_abs_err": err, "tol": KERNEL_TOL,
            "row_scaled_err": row_err, "row_tol": KERNEL_ROW_TOL, "ms": ms,
            "ms_back_to_back": ms_b2b, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        }
        rows.append(row)
        print(f"kernel: {what} serve path {row['serve_path']}: err={err:.3e} "
              f"(tol {KERNEL_TOL}) row-scaled={row_err:.3e} (tol {KERNEL_ROW_TOL}) "
              f"device: kernel={ms:.4f}ms plain={plain_ms:.4f}ms "
              f"sdpa={library_ms:.4f}ms bound={bound_ms * 1e3:.2f}us ({bound_by}); "
              f"kernel back-to-back={ms_b2b:.4f}ms", flush=True)
    return {"shapes": rows}


def _syncs(torch, fn) -> list[str]:
    """Where ``fn`` made synchronizing CUDA calls (PyTorch's sync debug
    mode), as file:line of the Python caller."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [
        f"{Path(w.filename).name}:{w.lineno}"
        for w in caught
        if "synchroniz" in str(w.message)
    ]


def _device_breakdown(torch, fn) -> dict:
    """Wall time of ``fn`` (ending in a synchronize) beside the device
    time of the kernels it launched, from one ``torch.profiler`` trace
    (the profiler's own overhead inflates ``profiled_wall_ms``; the
    unprofiled wall comes from a run just before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "wall_ms": wall_ms,
        "profiled_wall_ms": profiled_ms,
        "device_ms": device_ms if device_ms > 0 else None,  # None: not measured
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top},
    }


def phase_serve(torch, fa, llama, serve, cfg, serve_shapes) -> dict:
    t0 = time.perf_counter()
    engine = serve.ServeEngine(cfg, rng_seed=0, prefill_buckets=BUCKETS,
                               decode_chunk_size=NEW_TOKENS, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = llama.param_count(cfg)
    print(f"serve: llama32_3b L={cfg.n_layers} D={cfg.dim} H={cfg.n_heads} "
          f"KV={cfg.n_kv_heads} params={n_params} init={init_s:.2f}s", flush=True)
    warm_ms = engine.warmup()
    print(f"serve: warmup {warm_ms:.1f} ms", flush=True)

    # Host syncs inside one decode chunk, scalar (generate) and vector
    # (generate_batch) length paths: the chunk must queue without reads.
    # Each path runs once before it is counted (first calls set up
    # library state).
    _, cache = engine.prefill_ids(serve.encode_bytes("sync probe", 64))
    tok = torch.zeros((1,), dtype=torch.long, device=engine.device)
    _, bcache = engine._prefill_rows([[serve.BOS, 1, 2], [serve.BOS, 3]], 0)
    btok = torch.zeros((2,), dtype=torch.long, device=engine.device)
    syncs = {}
    for name, c, t in (("scalar", cache, tok), ("vector", bcache, btok)):
        first = _syncs(torch, lambda: llama.decode_chunk(engine.params, t, c, cfg, 4))
        syncs[name] = _syncs(torch, lambda: llama.decode_chunk(engine.params, t, c, cfg, 4))
        print(f"serve: host syncs in a 4-token {name}-length decode chunk: "
              f"first call {first}, steady {syncs[name]}", flush=True)
    torch.cuda.synchronize()
    if syncs["scalar"] or syncs["vector"]:
        _fail(f"a steady decode chunk synchronized with the host: {syncs}")

    # Where the time goes: one prefill at the 256 bucket and one 8-token
    # decode chunk, device kernel time against host wall time.
    ids256 = serve.encode_bytes(PROMPTS["bucket256"], engine.generation_prompt_cap())
    logits, cache = engine.prefill_ids(ids256)
    tok = logits.argmax(dim=-1)

    def run_prefill():
        engine.prefill_ids(ids256)
        torch.cuda.synchronize()

    def run_decode():
        llama.decode_chunk(engine.params, tok, engine._clone_cache(cache), cfg, 8)
        torch.cuda.synchronize()

    breakdown = {"prefill_256": _device_breakdown(torch, run_prefill),
                 "decode_8_tokens": _device_breakdown(torch, run_decode)}
    for name, b in breakdown.items():
        dev = "not measured" if b["device_ms"] is None else f"{b['device_ms']:.2f} ms"
        print(f"serve: {name}: wall {b['wall_ms']:.2f} ms, device kernels {dev}, "
              f"{b['kernel_launches']} launches; top "
              + ", ".join(f"{k} {v:.2f}" for k, v in b["top_kernels_ms"].items()),
              flush=True)

    torch.cuda.reset_peak_memory_stats()
    requests = []
    expected = cfg.n_layers * len(serve_shapes)
    fa.flash_attention.launches = 0  # count the main path only
    for name, prompt in PROMPTS.items():
        ids = serve.encode_bytes(prompt, engine.generation_prompt_cap())
        t_start = time.perf_counter()
        events = list(engine.generate(prompt, NEW_TOKENS, stop_at_eos=False))
        t_end = time.perf_counter()
        toks = [e.token_id for e in events]
        ttft_ms = events[0].ttft_ms
        decode_s = t_end - t_start - ttft_ms / 1e3
        rec = {
            "request": name, "prompt_ids": len(ids), "tokens": len(toks),
            "ttft_ms": ttft_ms, "decode_tok_s": (len(toks) - 1) / decode_s,
            "total_ms": (t_end - t_start) * 1e3,
        }
        if len(toks) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
            _fail(f"request {name}: bad token stream {toks}")
        requests.append(rec)
        print(f"serve: generate {name}: {len(ids)} prompt ids, {len(toks)} tokens, "
              f"TTFT {ttft_ms:.1f} ms, decode {rec['decode_tok_s']:.1f} tok/s", flush=True)

    t_start = time.perf_counter()
    outs = engine.generate_batch(BATCH_PROMPTS, NEW_TOKENS, stop_at_eos=False)
    batch_s = time.perf_counter() - t_start
    launches = fa.flash_attention.launches
    if len(outs) != len(BATCH_PROMPTS) or any(
        len(o) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in o) for o in outs
    ):
        _fail(f"generate_batch returned {[len(o) for o in outs]} tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch_tok_s = len(BATCH_PROMPTS) * NEW_TOKENS / batch_s
    print(f"serve: generate_batch x{len(BATCH_PROMPTS)}: {batch_s * 1e3:.1f} ms, "
          f"{batch_tok_s:.1f} tok/s; peak memory {peak_gb:.2f} GB", flush=True)
    print(f"serve: flash kernel launches {launches} (eligible prefills "
          f"(B, S) {serve_shapes} x {cfg.n_layers} layers need {expected})",
          flush=True)
    if expected == 0 or launches != expected:
        _fail(f"flash kernel launched {launches} times on the serve path, "
              f"its eligible prefills need {expected}")
    return {
        "config": "llama32_3b", "n_layers": cfg.n_layers, "params": n_params,
        "init_s": init_s, "warmup_ms": warm_ms, "requests": requests,
        "batch": {"rows": len(BATCH_PROMPTS), "ms": batch_s * 1e3,
                  "tok_s": batch_tok_s},
        "peak_memory_gb": peak_gb, "launches": launches,
        "launches_needed": expected, "prefill_shapes": serve_shapes,
        "syncs_per_chunk": {k: len(v) for k, v in syncs.items()},
        "breakdown": breakdown,
    }


def phase_parity(torch, fa, llama) -> dict:
    cfg = dataclasses.replace(llama.llama32_3b(max_seq_len=256), n_layers=2)
    S = 128
    params = llama.init_params(7, cfg, "cuda")
    params_cpu = {
        "embed": params["embed"].cpu(),
        "layers": {n: t.cpu() for n, t in params["layers"].items()},
        "final_norm": params["final_norm"].cpu(),
        "output": params["output"].cpu(),
    }
    gen = torch.Generator().manual_seed(11)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=gen)
    before = fa.flash_attention.launches
    gpu, _ = llama.prefill(
        params, tokens.cuda(), llama.init_kv_cache(cfg, 1, device="cuda"), cfg
    )
    gpu = gpu.cpu()
    kernel_launches = fa.flash_attention.launches - before
    cpu, _ = llama.prefill(
        params_cpu, tokens, llama.init_kv_cache(cfg, 1, device="cpu"), cfg
    )
    err = float((gpu - cpu).abs().max())
    top2 = torch.topk(cpu[0], 2).values
    margin = float(top2[0] - top2[1])
    same_token = int(gpu[0].argmax()) == int(cpu[0].argmax())
    print(f"parity: 2-layer llama32_3b widths, S={S}: card (kernel x{kernel_launches}) "
          f"vs CPU (plain) max abs logit err {err:.4f} (tol {PARITY_TOL}); "
          f"greedy token {'agrees' if same_token else 'differs'}, "
          f"CPU top-2 margin {margin:.4f}", flush=True)
    if kernel_launches != cfg.n_layers:
        _fail(f"parity prefill launched the kernel {kernel_launches} times")
    if not torch.isfinite(gpu).all() or err > PARITY_TOL:
        _fail(f"card vs CPU logits differ by {err} > {PARITY_TOL}")
    if not same_token and margin >= 2 * PARITY_TOL:
        _fail("greedy first token differs at a decisive margin")
    return {"S": S, "max_abs_err": err, "tol": PARITY_TOL,
            "same_token": same_token, "cpu_top2_margin": margin}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a GPU only",
              file=sys.stderr)
        return 2
    if not (ROOT / "tpuslo_torch" / "ops" / "csrc" / "flash_attention.cu").exists():
        print(f"chip_smoke: the port's sources are not beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import importlib

    from tpuslo_torch.models import llama, serve
    from tpuslo_torch.ops import _build

    # The module (the package re-exports its function under the same name).
    fa = importlib.import_module("tpuslo_torch.ops.flash_attention")

    # 1. device
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind} x{count}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    info = _build.build("flash_attention")
    print(f"build: {info.path.name} in {time.perf_counter() - t0:.2f}s "
          f"(nvcc {info.seconds:.2f}s; 0 means reused)", flush=True)
    for line in info.ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas: {line.strip()}", flush=True)

    # 3. kernel vs plain, at the issue's shapes and the serve path's
    cfg = llama.llama32_3b(max_seq_len=2048)
    serve_shapes = serve_prefills(serve, fa, cfg)
    kernel = phase_kernel(torch, fa, cfg, serve_shapes)
    # 4. serve
    served = phase_serve(torch, fa, llama, serve, cfg, serve_shapes)
    # 5. parity
    parity = phase_parity(torch, fa, llama)

    # 6. kernels line, card line, result line
    line_row = next(
        r for r in kernel["shapes"] if (r["B"], r["S"], r["causal"]) == LINE_SHAPE
    )
    kernels = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "tpuslo_torch/ops/csrc/flash_attention.cu",
        "replaces": "tpuslo/ops/flash_attention.py:41",
        "launches": served["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel["shapes"]),
        "ms": line_row["ms"],
        "plain_ms": line_row["plain_ms"],
        "bound_ms": line_row["bound_ms"],
        "bound_by": line_row["bound_by"],
        "library_ms": line_row["library_ms"],
        "shape": "B=1 S=256 H=24 KV=8 D=128 causal bf16",
    }]}
    record = {"card": card, "kind": kind, "count": count, "torch": torch.__version__,
              "build_s": info.seconds, "ptxas": info.ptxas, "kernel": kernel,
              "serve": served, "parity": parity, **kernels}
    print(f"record: {json.dumps(record)}")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
