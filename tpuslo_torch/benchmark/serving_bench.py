"""Single-card serving benchmark with MFU, runnable as a subprocess (the
port's counterpart of ``tpuslo/benchmark/serving_bench.py``).

The toolkit's own account of one card's serving speed:

* picks the **largest Llama config that fits the card's memory** in bf16
  (``llama32_3b`` at ``max_seq_len`` 1024 on an 80 GB H100), at full width
  and depth on seeded random weights;
* reports TTFT, decode tokens/s at batch 1 and batch 8, prefill
  tokens/s, **MFU** (``tokens/s x FLOPs_per_token / peak FLOP/s`` with
  ``FLOPs_per_token = 2 x n_params``) and the achieved share of the HBM
  roof, against the card's row of :data:`PEAK_BF16_FLOPS` and
  :data:`PEAK_HBM_BW`;
* the prefix, long-prompt, speculative, paged-vs-dense, int8-KV,
  shared-prefix, MoE (``mixtral_2b6``) and int8-weight lanes;
* proves the ``xla_launch`` correlation tier on a real capture: a
  ``torch.profiler`` capture over a serve recovers the dispatches' module
  spans and their kernels' device time, and the two streams are joined
  through :mod:`tpuslo_torch.correlation.matcher` on (program_id,
  launch_id) identity;
* the seeded device-plane and profiler lanes.

Run as ``python -m tpuslo_torch.benchmark.serving_bench [--platform
auto|cpu] [--model auto|llama3_8b|llama32_3b|llama32_1b|llama_tiny]
[--layers N]``; ``--layers`` cuts every model the bench builds to at most
N layers at its full widths (``n_layers`` in the report, beside each
lane's ``n_params``); prints one line ``SERVING_BENCH:{json}`` with the JAX bench's keys
wherever a lane has a counterpart.  ``auto`` serves on the CUDA device
and exits 2 without one; the CPU runs only under ``--platform cpu``.
``chip_smoke.py`` runs it as a subprocess with a timeout.

What differs from the JAX bench: the roofs and memory come from the
card (:data:`PEAK_BF16_FLOPS`, ``torch.cuda.mem_get_info``), every timed
window ends in a device read or a synchronize, the K2 arm of the batch
curve runs the hand-written kernel where JAX ran its Pallas kernel, and
the result carries the process's kernel launches (``kernel_launches``)
and each lane's own (``k1_launches`` / ``k2_launches``).  The measured
speculative lane trains its target and draft through the port's own
train step on the one device (:mod:`tpuslo_torch.models.train`).  The
persisted-capture fallback of ``bench.py`` is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import tempfile
import time
from datetime import datetime, timezone
from typing import Any

import torch

from tpuslo_torch.device import synchronize
from tpuslo_torch.deviceplane.roofline import H100_PEAK_BF16_FLOPS, H100_PEAK_HBM_BW, PEAKS

# Peak dense bf16 FLOP/s and HBM bytes/s per card, keyed by substrings of
# ``torch.cuda.get_device_name()`` (the H100 row is the device plane's
# roofline row: NVIDIA's data sheet, SXM part, at the 700 W limit).
PEAK_BF16_FLOPS = {name: flops for name, (_bw, flops) in PEAKS.items()}
PEAK_HBM_BW = {name: bw for name, (bw, _flops) in PEAKS.items()}

#: The ROADMAP items the lanes that are not ported wait for (none now).
NOT_PORTED: dict[str, str] = {}


def decode_step_hbm_bytes(
    n_params: float, kv_cache_total_bytes: float, *, param_bytes: float = 2.0
) -> float:
    """HBM bytes one decode step must stream.

    Weights are read once per step regardless of batch; the dense-cache
    attention reads the FULL allocated KV buffer every step (every
    ``max_seq_len`` position participates under mask, live or not), so
    the honest KV term is the allocation, not the live context.
    """
    return n_params * param_bytes + kv_cache_total_bytes


def bandwidth_report(
    tokens_per_sec: float,
    batch: int,
    step_bytes: float,
    peak_bw: float | None,
) -> dict[str, Any]:
    """Decode throughput through the bandwidth lens.

    ``achieved = steps/s x bytes/step``; on a card the report adds
    %%-of-roof against the card's HBM rate.  A low ``hbm_bw_pct`` at a
    bandwidth-bound operating point means real headroom (launch overhead,
    short kernels), not a compute wall.
    """
    steps_per_sec = tokens_per_sec / max(batch, 1)
    achieved = steps_per_sec * step_bytes
    report: dict[str, Any] = {
        "bytes_per_step": int(step_bytes),
        "achieved_gb_per_sec": round(achieved / 1e9, 2),
    }
    if peak_bw:
        report["peak_gb_per_sec"] = round(peak_bw / 1e9, 1)
        report["hbm_bw_pct"] = round(100.0 * achieved / peak_bw, 1)
    return report


def _additive_lane(fn, *, err_cap: int = 2000):
    """Run an additive bench lane; a failure becomes ``{"error": ...}``.

    The JAX bench retries once on a TPU relay's transport errors; a card
    in the same machine has no relay, so every error is the lane's own.
    Error strings keep up to ``err_cap`` characters.
    """
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - additive lane
        return {"error": f"{type(exc).__name__}: {exc}"[:err_cap]}


def _percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no numpy dependency)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


def _lookup(table: dict[str, float], *keys: str) -> float | None:
    for key in keys:
        key = (key or "").lower()
        for marker, value in table.items():
            if marker.lower() in key:
                return value
    return None


def _pick_model(bytes_limit: float | None, bytes_per_param: float = 2.0) -> str:
    """Largest config whose params + KV/workspace headroom fit.

    ``bytes_per_param=1`` (int8 weight-only quant) is the int8 lane's:
    on an 80 GB card it picks ``llama3_8b``.
    """
    from tpuslo_torch.models.llama import llama3_8b, llama32_1b, llama32_3b, param_count

    if not bytes_limit:
        return "llama_tiny"
    candidates = [("llama32_3b", llama32_3b()), ("llama32_1b", llama32_1b())]
    if bytes_per_param < 1.5:
        candidates.insert(0, ("llama3_8b", llama3_8b()))
    for name, cfg in candidates:
        # weights + KV/logits/workspace headroom
        need = param_count(cfg) * bytes_per_param * 1.15 + 2.5e9
        if need < bytes_limit:
            return name
    return "llama_tiny"


def _cut(cfg, layers: int | None):
    """``cfg`` at no more than ``layers`` layers (``None``: as it is)."""
    if layers is None or layers >= cfg.n_layers:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers)


def _make_config(name: str, layers: int | None = None):
    from tpuslo_torch.models import llama

    if name == "llama3_8b":
        cfg = dataclasses.replace(llama.llama3_8b(), max_seq_len=1024)
    elif name == "llama32_3b":
        cfg = llama.llama32_3b(max_seq_len=1024)
    elif name == "llama32_1b":
        cfg = llama.llama32_1b(max_seq_len=1024)
    else:
        cfg = llama.llama_tiny(max_seq_len=512)
    return _cut(cfg, layers)


def _free_device(device: torch.device) -> None:
    """Return the caching allocator's free blocks, so that the next
    engine finds the card's memory (the callers drop their references)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def kernel_launches() -> dict[str, int]:
    """The process's launches of each hand-written kernel so far (a graph
    replay credits what its capture recorded)."""
    from tpuslo_torch.ops import rms_norm
    from tpuslo_torch.ops.flash_attention import flash_attention
    from tpuslo_torch.ops.paged_attention import paged_decode_attention

    return {
        "flash_attention": flash_attention.launches,
        "flash_attention_f32": flash_attention.f32_launches,
        "paged_attention": paged_decode_attention.launches,
        "paged_attention_f32": paged_decode_attention.f32_launches,
        "rms_norm": rms_norm.rms_norm.launches,
        "add_rms_norm": rms_norm.add_rms_norm.launches,
    }


def _k1() -> int:
    launches = kernel_launches()
    return launches["flash_attention"] + launches["flash_attention_f32"]


def _k2() -> int:
    launches = kernel_launches()
    return launches["paged_attention"] + launches["paged_attention_f32"]


BENCH_PROMPT = "benchmark the tpu serving path with a stable prompt"


def _b1_latency(engine, n_tokens: int = 128) -> tuple[float, float]:
    """(ttft_ms, decode_tokens_per_sec) for the streaming batch-1 path.

    One measurement protocol for every lane (bf16, int8): warm with 8
    tokens, then time a full stream and subtract TTFT from the decode
    window.  Each token is read to the host as it streams.
    """
    list(engine.generate(BENCH_PROMPT, max_new_tokens=8, stop_at_eos=False))
    t0 = time.perf_counter()
    events = list(
        engine.generate(BENCH_PROMPT, max_new_tokens=n_tokens, stop_at_eos=False)
    )
    elapsed = time.perf_counter() - t0
    ttft_s = (events[0].ttft_ms or 0.0) / 1000.0
    tps = (len(events) - 1) / max(elapsed - ttft_s, 1e-9)
    return ttft_s * 1000.0, tps


def _decode_only_tps(engine, batch: int, chunk_calls: int = 2) -> float:
    """Aggregate decode tokens/s with prefill and host loops excluded.

    Synced by a device read of the last chunk's last tokens, as the JAX
    bench syncs through ``jax.device_get``: chained chunks serialize on
    the device, so the read waits for all of them.
    """
    from tpuslo_torch.models.llama import GREEDY, init_kv_cache, prefill

    cfg = engine.cfg
    dev = engine.device
    bucket = engine.prefill_buckets[0]
    chunk = engine.decode_chunk_size
    tokens = torch.zeros((batch, bucket), dtype=torch.long, device=dev)
    cache = init_kv_cache(cfg, batch, kv_dtype=engine.kv_dtype, device=dev)
    logits, cache = prefill(
        engine.params, tokens, cache, cfg,
        true_length=torch.full((batch,), bucket, dtype=torch.long, device=dev),
    )
    tok = logits.argmax(dim=-1)
    toks, tok, cache = engine._decode_chunk(tok, cache, chunk, GREEDY, None)  # warm
    toks[:, -1].tolist()
    t0 = time.perf_counter()
    produced = 0
    for _ in range(chunk_calls):
        toks, tok, cache = engine._decode_chunk(tok, cache, chunk, GREEDY, None)
        produced += toks.shape[1]
    toks[:, -1].tolist()
    elapsed = max(time.perf_counter() - t0, 1e-9)
    return batch * produced / elapsed


def _prefix_lane(engine) -> dict[str, Any]:
    """TTFT with and without the KV prefix cache, at a realistic prefix.

    The prefix is sized to >= 512 ids where KV capacity allows (chunked
    prefill ingests past the largest bucket); a batch-8 sub-lane runs
    through ``generate_batch(prefix=...)``, the single-shot path.
    """
    from tpuslo_torch.models.serve import _bucket, prefix_prompt_ids

    cap = engine.prefill_buckets[-1]
    # Leave room for the suffix bucket + decode: prefix targets 512+
    # ids (or what capacity allows on small configs).
    target = max(min(1024, engine.cfg.max_seq_len - cap - 64), 64)
    prefix = ("shared system preamble for the slo assistant. " * 40)[:target]
    user = "summarize the incident"

    def ttft(prompt: str, **kw) -> float:
        events = list(
            engine.generate(prompt, max_new_tokens=8, stop_at_eos=False, **kw)
        )
        return events[0].ttft_ms or 0.0

    ttft(prefix + user)  # warm the full prompt's chunk shapes
    full_ms = min(ttft(prefix + user) for _ in range(3))
    engine.cache_prefix(prefix)
    ttft(user, prefix=prefix)  # warm the suffix bucket
    cached_ms = min(ttft(user, prefix=prefix) for _ in range(3))
    out = {
        "prefix_bytes": len(prefix),
        "prefix_ids": len(prefix) + 1,
        "ttft_full_ms": round(full_ms, 2),
        "ttft_cached_prefix_ms": round(cached_ms, 2),
        "ttft_speedup": round(full_ms / max(cached_ms, 1e-9), 2),
    }

    # --- b1 decomposition: where does TTFT go? --------------------------
    # Time the INGEST alone (prefill/append, ended by a synchronize) for
    # both paths, so the report can say whether TTFT is ingest-bound
    # (prefix caching must show) or overhead-bound (a fixed per-request
    # cost swallows the saved ingest).
    _, suffix_ids = prefix_prompt_ids(prefix, user, engine.cfg.max_seq_len)
    out["suffix_ids"] = len(suffix_ids)
    out["suffix_bucket"] = _bucket(len(suffix_ids), engine.prefill_buckets)
    out["full_bucket"] = _bucket(len(prefix + user) + 1, engine.prefill_buckets)

    def ingest_only_ms(fn) -> float:
        t0 = time.perf_counter()
        fn()
        synchronize(engine.device)
        return (time.perf_counter() - t0) * 1000.0

    compiles0 = len(engine.compile_events)
    ingest_full = min(
        ingest_only_ms(lambda: engine.ingest_prompt(prefix + user))
        for _ in range(3)
    )
    ingest_cached = min(
        ingest_only_ms(lambda: engine.ingest_prompt(user, prefix=prefix))
        for _ in range(3)
    )
    out["ingest_full_ms"] = round(ingest_full, 2)
    out["ingest_cached_ms"] = round(ingest_cached, 2)
    out["lane_compile_events"] = len(engine.compile_events) - compiles0
    overhead = full_ms - ingest_full
    out["ttft_fixed_overhead_ms"] = round(overhead, 2)
    saved = ingest_full - ingest_cached
    if saved <= 0.15 * full_ms:
        out["b1_verdict"] = (
            f"overhead-bound: ingest saves only {saved:.0f} ms while "
            f"~{overhead:.0f} ms of TTFT is fixed per-request cost, so "
            "no prefix-cache b1 speedup is arithmetically possible at "
            "this operating point; the feature's b1 value needs longer "
            "prefixes or lower launch latency, and its measured value "
            "is batched (batch8_speedup)"
        )
    elif cached_ms <= full_ms - 0.5 * saved:
        out["b1_verdict"] = (
            f"ingest-bound and delivering: {saved:.0f} ms saved ingest "
            f"shows up in TTFT ({full_ms:.0f} -> {cached_ms:.0f} ms)"
        )
    else:
        out["b1_verdict"] = (
            f"anomaly: ingest saves {saved:.0f} ms but TTFT moved only "
            f"{full_ms - cached_ms:.0f} ms — overhead between ingest "
            "and first token is absorbing the win; profile the decode "
            "step + stream setup on this card"
        )

    # Batch-8 single-shot: shared-prefix prefill vs full-prompt prefill
    # (generate_batch reads its tokens, so each call ends on the host).
    users = [f"{user} #{i}" for i in range(8)]
    fulls = [prefix + u for u in users]
    engine.generate_batch(fulls, max_new_tokens=1, stop_at_eos=False)  # warm
    t0 = time.perf_counter()
    engine.generate_batch(fulls, max_new_tokens=1, stop_at_eos=False)
    full_b8_ms = (time.perf_counter() - t0) * 1000.0
    engine.generate_batch(users, max_new_tokens=1, stop_at_eos=False, prefix=prefix)  # warm
    t0 = time.perf_counter()
    engine.generate_batch(users, max_new_tokens=1, stop_at_eos=False, prefix=prefix)
    cached_b8_ms = (time.perf_counter() - t0) * 1000.0
    out["batch8_full_ms"] = round(full_b8_ms, 2)
    out["batch8_cached_prefix_ms"] = round(cached_b8_ms, 2)
    out["batch8_speedup"] = round(full_b8_ms / max(cached_b8_ms, 1e-9), 2)
    return out


def _long_prompt_lane(engine) -> dict[str, Any]:
    """TTFT for a prompt at full KV capacity via chunked prefill: the
    head prefill plus bucket-chunk appends, so the capacity ceiling is
    the KV cache, not the bucket set."""
    cap = engine.cfg.max_seq_len - 2
    prompt = ("long context filler sentence about tpu serving. " * 40)[:cap]
    compiles_before = len(engine.compile_events)
    events = list(engine.generate(prompt, max_new_tokens=4, stop_at_eos=False))
    warm_ttft = events[0].ttft_ms or 0.0
    best = min(
        (
            list(engine.generate(prompt, max_new_tokens=4, stop_at_eos=False))[0].ttft_ms
            or 0.0
        )
        for _ in range(2)
    )
    return {
        "prompt_ids": min(len(prompt) + 1, cap),
        "first_ttft_ms": round(warm_ttft, 2),  # includes the first use of each shape
        "ttft_ms": round(best, 2),
        # Delta over this lane only: chunked ingestion's own new shapes.
        "compile_events": len(engine.compile_events) - compiles_before,
    }


def _paged_cpu_config():
    """Weight-bandwidth-bound config for the CPU paged lane.

    The paged engine's capacity win converts to throughput only where
    stepping 2B rows costs less than 2x stepping B, the regime card
    decode always lives in (weights stream from HBM once per step
    regardless of batch).  llama_tiny's weights fit in cache, so on the
    CPU it is compute-bound and batch scaling is linear; ~100M params in
    f32 (394 MB, far past the last-level cache) reproduces the
    bandwidth-bound regime there.
    """
    from tpuslo_torch.models.llama import LlamaConfig

    return LlamaConfig(
        vocab_size=2048, dim=1024, n_layers=6, n_heads=8, n_kv_heads=4,
        ffn_dim=4096, max_seq_len=512, rope_theta=10000.0,
        dtype=torch.float32,
    )


def _speculative_lane(
    cfg, params, device: torch.device, k: int = 4, timed_steps: int = 12
) -> dict[str, Any]:
    """Speculative-decoding mechanics on the current device.

    Random weights make draft/target agreement chance-level, so an
    acceptance-driven speedup would be noise here (the exactness
    guarantee and acceptance accounting are tested in
    ``tests/test_torch_speculative.py``).  What this lane measures are
    the three per-round costs the speculative speedup formula is built
    from:

    * ``t_decode_ms``: one sequential decode step on the target;
    * ``t_verify_ms``: ONE ``verify_chunk`` pass scoring k+1 positions;
    * ``t_draft_chunk_ms``: k draft tokens in one chunk from a
      depth-pruned self-speculative draft (the target config with half
      the layers).

    Derived: ``verify_speedup`` = (k+1)*t_decode/t_verify,
    ``breakeven_acceptance`` where round cost equals plain decode, and
    ``projected_speedup`` at acceptance 0.6/0.8/1.0:
    speedup(a) = (1 + a*k) * t_decode / (t_draft_chunk + t_verify).
    """
    from tpuslo_torch.models.llama import (
        decode_chunk,
        decode_step,
        init_kv_cache,
        init_params,
        param_count,
        verify_chunk,
    )

    start_len = min(64, cfg.max_seq_len // 2)

    def mid_cache(p_cfg):
        cache = init_kv_cache(p_cfg, 1, device=device)
        return {**cache, "length": torch.tensor(start_len, dtype=torch.long, device=device)}

    B8 = 8  # the serving lanes' operating batch

    def mid_cache_b(p_cfg):
        cache = init_kv_cache(p_cfg, B8, device=device)
        return {**cache, "length": torch.full((B8,), start_len, dtype=torch.long,
                                              device=device)}

    def time_loop(fn, first_args) -> float:
        """ms per call; ``fn`` returns the cache last."""
        out = fn(*first_args)  # first use
        synchronize(device)
        cache = out[-1]
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            out = fn(*first_args[:-1], cache)
            cache = out[-1]
        synchronize(device)
        return (time.perf_counter() - t0) / timed_steps * 1e3

    tok = torch.zeros((1,), dtype=torch.long, device=device)
    chunk = torch.zeros((1, k + 1), dtype=torch.long, device=device)
    tok_b = torch.zeros((B8,), dtype=torch.long, device=device)
    chunk_b = torch.zeros((B8, k + 1), dtype=torch.long, device=device)

    def step(c, p):
        return lambda t, cache: decode_step(p, t, cache, c)

    def verify(t, cache):
        # verify_chunk leaves ``length`` unchanged, so looping re-scores
        # the same k+1 window every iteration.
        return verify_chunk(params, t, cache, cfg)

    t_decode = time_loop(step(cfg, params), (tok, mid_cache(cfg)))
    t_verify = time_loop(verify, (chunk, mid_cache(cfg)))
    # Batched round costs (generate_batch's operating point), timed
    # before the draft weights exist.
    t_decode_b8 = time_loop(step(cfg, params), (tok_b, mid_cache_b(cfg)))
    t_verify_b8 = time_loop(verify, (chunk_b, mid_cache_b(cfg)))

    draft_cfg = dataclasses.replace(cfg, n_layers=max(1, cfg.n_layers // 2))
    draft_params = init_params(11, draft_cfg, device)

    def draft(t, cache):
        return decode_chunk(draft_params, t, cache, draft_cfg, k)

    try:
        t_draft = time_loop(draft, (tok, mid_cache(draft_cfg)))
        t_draft_b8 = time_loop(draft, (tok_b, mid_cache_b(draft_cfg)))
        # generate_batch additionally pays ONE batched draft decode step
        # per round (the unconditional full-accept KV fill).
        t_fill_b8 = time_loop(step(draft_cfg, draft_params), (tok_b, mid_cache_b(draft_cfg)))
    finally:
        del draft_params
        _free_device(device)

    round_cost = t_draft + t_verify
    projected = {
        str(a): round((1 + a * k) * t_decode / round_cost, 3) for a in (0.6, 0.8, 1.0)
    }
    round_cost_b8 = t_draft_b8 + t_verify_b8 + t_fill_b8
    projected_b8 = {
        str(a): round((1 + a * k) * t_decode_b8 / round_cost_b8, 3) for a in (0.6, 0.8, 1.0)
    }
    return {
        "k": k,
        "draft": f"self-speculative: target with n_layers="
        f"{draft_cfg.n_layers} of {cfg.n_layers}",
        "draft_n_params": param_count(draft_cfg),
        "t_decode_ms": round(t_decode, 3),
        "t_verify_ms": round(t_verify, 3),
        "t_draft_chunk_ms": round(t_draft, 3),
        "t_decode_b8_ms": round(t_decode_b8, 3),
        "t_verify_b8_ms": round(t_verify_b8, 3),
        "t_draft_chunk_b8_ms": round(t_draft_b8, 3),
        "t_draft_fill_b8_ms": round(t_fill_b8, 3),
        "projected_speedup_b8": projected_b8,
        "verify_speedup": round((k + 1) * t_decode / t_verify, 3),
        "breakeven_acceptance": round((round_cost / t_decode - 1) / k, 3),
        "projected_speedup": projected,
        "exactness": "emitted stream identical to target-only greedy "
        "(tested: tests/test_torch_speculative.py)",
    }


#: The measured speculative lane's target (the JAX lane's): dim 192, 4
#: layers, 8 heads of 24 over 4 kv heads.
MEASURED_TARGET = dict(vocab_size=512, dim=192, n_layers=4, n_heads=8, n_kv_heads=4,
                       ffn_dim=384, max_seq_len=256, rope_theta=10000.0)


def _speculative_measured_lane(
    k: int = 4,
    target_steps: int = 100,
    draft_steps: int = 600,
    n_tokens: int = 48,
    target_cfg=None,
    draft_cfg=None,
    device: torch.device | str = "cuda",
) -> dict[str, Any]:
    """Speculative speedup MEASURED on trained weights (the JAX lane's
    recipe, configs, corpus, prompts and keys).

    It trains a target (dim 192, 4 layers, 8 heads of 24 over 4 kv heads)
    and a much cheaper draft
    (``llama_tiny``) on the same predictable corpus through the port's
    train step (:func:`tpuslo_torch.models.train.build_sharded_train_step`
    on the one device: 100 steps at 3e-4 and 600 at 1e-3, batch 8, seq 64,
    seed 0), then measures acceptance and end-to-end tokens/s through
    :class:`~tpuslo_torch.models.speculative.SpeculativeEngine` against
    target-only greedy decoding of the same prompts.  ``parity_ok`` says
    whether the emitted streams are identical (the engine's exactness
    guarantee).  The timed runs are audited by
    :mod:`tpuslo_torch.analysis.jitaudit` (recaptures, host syncs).
    """
    from tpuslo_torch.analysis import jitaudit
    from tpuslo_torch.models.data import corpus_stream
    from tpuslo_torch.models.llama import LlamaConfig, llama_tiny, param_count
    from tpuslo_torch.models.serve import ServeEngine
    from tpuslo_torch.models.speculative import SpeculativeEngine
    from tpuslo_torch.models.train import build_sharded_train_step, frozen, make_optimizer
    from tpuslo_torch.parallel.mesh import make_mesh, plan_for_devices

    mesh = make_mesh(plan_for_devices(1), devices=[device])
    device = mesh.device
    target_cfg = target_cfg or LlamaConfig(**MEASURED_TARGET)
    draft_cfg = draft_cfg or llama_tiny(max_seq_len=256)  # dim 64, 2 layers

    # A predictable byte-level corpus: templates whose completion is
    # deterministic given a short prefix, where a trained draft agrees
    # with a trained target.
    templates = [
        "the five boxing wizards jump quickly over the lazy brown dog",
        "pack my box with five dozen liquor jugs before the dawn run",
        "how vexingly quick daft zebras jump across the frozen river",
    ]
    texts = [f"doc {i % 3}: {templates[i % 3]}" for i in range(60)]

    lane: dict[str, Any] = {
        "k": k,
        "train_steps": {"target": target_steps, "draft": draft_steps},
    }
    trained = {}
    # The draft must be nearly as converged as the target for high
    # acceptance; its steps are ~10x cheaper, so it trains longer and
    # hotter (the JAX lane's recipes).
    recipes = (
        ("target", target_cfg, target_steps, 3e-4),
        ("draft", draft_cfg, draft_steps, 1e-3),
    )
    for name, cfg_i, steps, lr in recipes:
        step_fn, init_fn = build_sharded_train_step(mesh, cfg_i, optimizer=make_optimizer(lr))
        params, opt_state = init_fn(0)
        stream = corpus_stream(texts, batch=8, seq_len=64, device=device, seed=0,
                               epochs=10_000)
        first = last = None
        try:
            # Losses stay on the device inside the loop: a read per step
            # would wait for the card at every step.
            for i, (tokens, targets) in enumerate(stream):
                if i >= steps:
                    break
                params, opt_state, loss = step_fn(params, opt_state, tokens, targets)
                if first is None:
                    first = loss
                last = loss
        finally:
            stream.close()
        del opt_state
        trained[name] = frozen(params)
        lane[name] = {
            "n_params": param_count(cfg_i),
            "loss_first": round(float(first), 4),
            "loss_last": round(float(last), 4),
        }
    lane["cost_ratio"] = round(lane["target"]["n_params"] / lane["draft"]["n_params"], 1)

    owned_audit = not jitaudit.installed()
    if owned_audit:
        jitaudit.install()
    audit = jitaudit.registry()
    try:
        target = ServeEngine(cfg=target_cfg, params=trained["target"], device=device)
        draft = ServeEngine(cfg=draft_cfg, params=trained["draft"], device=device)
        spec = SpeculativeEngine(target, draft, k=k)
        prompts = [f"doc {i}: {templates[i][:20]}" for i in range(3)]

        # Warm every path (prefill buckets, decode, verify, draft chunk,
        # the graph captures) before timing.
        [e.token_id for e in target.generate(prompts[0], max_new_tokens=4, stop_at_eos=False)]
        spec.generate(prompts[0], max_new_tokens=4, stop_at_eos=False)

        syncs0 = audit.host_sync_count()
        t0 = time.perf_counter()
        plain_streams = [
            [e.token_id for e in target.generate(p, max_new_tokens=n_tokens, stop_at_eos=False)]
            for p in prompts
        ]
        t_plain = time.perf_counter() - t0
        plain_syncs = audit.host_sync_count() - syncs0

        rounds0 = spec.rounds
        accepted0 = spec.accepted_draft_tokens
        retrace0 = audit.steady_compile_count()
        syncs0 = audit.host_sync_count()
        t0 = time.perf_counter()
        spec_streams = [spec.generate(p, max_new_tokens=n_tokens, stop_at_eos=False)
                        for p in prompts]
        t_spec = time.perf_counter() - t0
        spec_retraces = audit.steady_compile_count() - retrace0
        spec_syncs = audit.host_sync_count() - syncs0
    finally:
        if owned_audit:
            jitaudit.uninstall()

    total = sum(len(s) for s in plain_streams)
    spec_total = sum(len(s) for s in spec_streams)
    proposed = (spec.rounds - rounds0) * k
    lane["parity_ok"] = spec_streams == plain_streams
    lane["acceptance_rate"] = round(
        (spec.accepted_draft_tokens - accepted0) / max(proposed, 1), 4)
    lane["target_tokens_per_sec"] = round(total / max(t_plain, 1e-9), 2)
    lane["speculative_tokens_per_sec"] = round(spec_total / max(t_spec, 1e-9), 2)
    lane["measured_speedup"] = round(t_plain / max(t_spec, 1e-9), 3)
    lane["spec_retrace_count"] = spec_retraces
    lane["decode_host_syncs_per_token"] = round(plain_syncs / max(total, 1), 3)
    lane["spec_host_syncs_per_token"] = round(spec_syncs / max(spec_total, 1), 3)
    if lane["measured_speedup"] < 1.0:
        lane["note"] = (
            "speedup < 1: a round (k draft steps and one verify of k + 1 "
            "positions) cost more here than the plain decode steps it replaced"
        )
    return lane


def _pallas_decision(curve: list, ctx: int) -> str:
    """Verdict on the paged decode attention route.

    Where the curve carries measured ``*_pallas`` points (the K2 arm on
    a card: ``tpuslo_torch/ops/csrc/paged_attention.cu``), the verdict is
    the measured crossover against the plain masked-pool attention
    (``paged_kv._pool_attention``); otherwise it states that the K2 arm
    runs on a card only."""
    measured = [p for p in curve if "tokens_per_sec_pallas" in p]
    failed = [p for p in curve if "pallas_error" in p]
    if failed and not measured:
        return (
            "K2 FAILED on this card at every measured batch "
            f"({[p['batch'] for p in failed]}; first error: "
            f"{failed[0]['pallas_error']}): the plain masked-pool path "
            "stands until the kernel is repaired"
        )
    if not measured:
        return (
            "plain masked-pool attention measured only: K2 "
            "(tpuslo_torch/ops/csrc/paged_attention.cu, "
            "PagedBatchingEngine(pallas_attention=True) or "
            "TPUSLO_PAGED_PALLAS=1) runs on a CUDA card, and its CPU "
            "route is the plain version, which is a correctness harness, "
            "not a timing one"
        )
    wins = [
        p["batch"] for p in measured if p["tokens_per_sec_pallas"] > p["tokens_per_sec"]
    ]
    caveat = (
        f"; K2 FAILED at batches {[p['batch'] for p in failed]} "
        f"(first error: {failed[0]['pallas_error']})"
        if failed
        else ""
    )
    if wins:
        return (
            "MEASURED on this card (see curve's *_pallas fields): K2 beats "
            "the plain masked-pool attention at batches "
            f"{wins} of {[p['batch'] for p in measured]}; the port's main "
            "path reads its caches through K2 on the card, and the paged "
            "engine takes it with PagedBatchingEngine(pallas_attention=True) "
            "or TPUSLO_PAGED_PALLAS=1" + caveat
        )
    return (
        "MEASURED on this card (see curve's *_pallas fields): the plain "
        "masked-pool attention wins at every measured batch; K2 stays "
        "opt-in for the paged engine at contexts up to this lane's "
        f"{ctx}-token pool" + caveat
    )


def _batch_saturation_lane(
    cfg, params, device: torch.device, batches: tuple[int, ...] = (1, 8, 16, 32),
    block_size: int = 64, timed_steps: int = 12,
) -> dict[str, Any]:
    """Decode tokens/s vs batch through the paged + int8-KV pool, with
    the plain masked-pool attention and, on a card, K2, plus the
    bandwidth arithmetic of a fused decode-attention kernel: it can only
    save the KV read traffic, so its ceiling is the KV fraction of
    per-step bytes, computed for the measured config and for the
    flagship (llama32_3b @ 1024 ctx)."""
    from tpuslo_torch.models.llama import llama32_3b, param_count
    from tpuslo_torch.models.paged_kv import (
        init_paged_pool,
        paged_decode_step,
        paged_pool_bytes,
    )

    ctx = min(cfg.max_seq_len, 512)
    blocks_per_slot = ctx // block_size
    plain_step = functools.partial(paged_decode_step, cfg=cfg, block_size=block_size)
    # The same curve through K2 on a card (its CPU route is the plain
    # version: a correctness harness, not a timing one).
    k2_step = (
        functools.partial(paged_decode_step, cfg=cfg, block_size=block_size, pallas=True)
        if device.type == "cuda"
        else None
    )
    flops_per_token = 2.0 * param_count(cfg)

    def kv_pool_bytes(n_blocks: int) -> int:
        return paged_pool_bytes(cfg, n_blocks, block_size, kv_dtype="int8")

    weight_bytes = int(param_count(cfg) * torch.finfo(cfg.dtype).bits // 8)

    def time_path(fn, batch: int, n_blocks: int) -> float:
        """ms/step for one attention route (a fresh pool)."""
        state = init_paged_pool(cfg, n_blocks, block_size, batch, kv_dtype="int8",
                                device=device)
        # Slot i on its own block run, mid-stream at ctx-8 so the
        # attention read covers (nearly) the whole pool each step.
        state["page_table"] = torch.arange(
            1, 1 + batch * blocks_per_slot, dtype=torch.int32, device=device
        ).reshape(batch, blocks_per_slot)
        state["length"] = torch.full((batch,), ctx - 8, dtype=torch.long, device=device)
        token = torch.zeros((batch,), dtype=torch.long, device=device)
        start = dict(state)
        logits, state = fn(params, token, state)  # first use
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            # Every step from the same frontier: the pool's own blocks.
            logits, state = fn(params, token, {**state, "length": start["length"]})
        synchronize(device)
        del state, start
        return (time.perf_counter() - t0) / timed_steps * 1e3

    curve = []
    k2_before = _k2()
    for batch in batches:
        n_blocks = 1 + batch * blocks_per_slot
        ms = time_path(plain_step, batch, n_blocks)
        point = {
            "batch": batch,
            "ms_per_step": round(ms, 2),
            "tokens_per_sec": round(batch / (ms / 1e3), 2),
            "kv_read_fraction": round(
                kv_pool_bytes(n_blocks) / (kv_pool_bytes(n_blocks) + weight_bytes), 4
            ),
        }
        if k2_step is not None:
            pms = _additive_lane(lambda: {"ms": time_path(k2_step, batch, n_blocks)})
            if "error" in pms:
                point["pallas_error"] = pms["error"]
            else:
                point["ms_per_step_pallas"] = round(pms["ms"], 2)
                point["tokens_per_sec_pallas"] = round(batch / (pms["ms"] / 1e3), 2)
        curve.append(point)
        _free_device(device)

    # Analytic terms on the flagship config: (a) HBM: a fused kernel
    # removes the KV read's round trip, ceiling = KV fraction of per-step
    # bytes; (b) FLOPs: the masked physical-pool form scores O(B*pool)
    # rows, and its cost grows quadratically with batch.
    flagship = llama32_3b(max_seq_len=1024)
    f_blocks = 1 + batches[-1] * (flagship.max_seq_len // block_size)
    f_kv = paged_pool_bytes(flagship, f_blocks, block_size, kv_dtype="int8")
    f_weights = int(param_count(flagship) * 2)
    f_fraction = f_kv / (f_kv + f_weights)

    def attn_vs_weight_macs(c, batch: int) -> float:
        pool_rows = batch * c.max_seq_len
        attn = 2 * batch * pool_rows * c.n_heads * c.head_dim * c.n_layers
        weight = batch * param_count(c)
        return attn / weight

    serving_batch = 8  # the operating point of every serving lane
    top_batch = batches[-1]
    return {
        "kv_dtype": "int8",
        "context": ctx,
        "curve": curve,
        "k2_launches": _k2() - k2_before,
        "flops_per_token": flops_per_token,
        f"flagship_kv_read_fraction_b{top_batch}": round(f_fraction, 4),
        "flagship_attn_vs_weight_macs": {
            str(b): round(attn_vs_weight_macs(flagship, b), 3) for b in batches
        },
        "pallas_decode_attention_decision": _pallas_decision(curve, ctx),
        "decision_arithmetic": (
            f"two terms: (a) KV HBM reads a fused kernel could hide "
            f"are {f_fraction:.0%} of per-step bytes on the flagship "
            f"(llama32_3b@1024, int8 KV, b={top_batch}); (b) masked "
            f"physical-pool attention scores O(B*pool) rows, so its MACs "
            f"vs the weight matmuls are "
            f"{attn_vs_weight_macs(flagship, serving_batch):.0%} at the "
            f"b={serving_batch} operating point and "
            f"{attn_vs_weight_macs(flagship, top_batch):.0%} at "
            f"b={top_batch}. K2 reads each lane's own blocks (O(B*ctx)), "
            f"which is what serving at batch >= 16 or ctx >= 4k needs"
        ),
    }


def _bench_kv_lanes(
    cfg, params, buckets, mfu, device: torch.device, peak_bw=None,
    paged_cfg=None, paged_params=None, paged_buckets=None,
) -> dict[str, Any]:
    """int8-KV decode and paged-vs-dense continuous batching lanes.

    * ``int8_kv``: batch-8 decode-only tokens/s over the quantized KV
      cache, plus the capacity arithmetic;
    * ``paged``: the paged continuous-batching engine at 2x the slots of
      the dense engine **at equal KV memory** (the pool is sized to the
      dense engine's reservation), on a queue-bound workload: aggregate
      tokens/s and admission-queue delay p50/p95.  On a card the paged
      engine reads its pool through K2 and the dense engine its caches
      through K2's lanes, as the main path does.  The lane may run
      another (bandwidth-bound) config than the main model on the CPU
      (``_paged_cpu_config``), recorded in the ``model`` fields.
    """
    from tpuslo_torch.models.batching import ContinuousBatchingEngine
    from tpuslo_torch.models.llama import kv_cache_bytes, param_count
    from tpuslo_torch.models.paged_kv import PagedBatchingEngine, paged_pool_bytes
    from tpuslo_torch.models.serve import ServeEngine

    out: dict[str, Any] = {}
    k2 = device.type == "cuda"
    t_lane = time.perf_counter()

    engine8 = ServeEngine(
        cfg=cfg, params=params, prefill_buckets=buckets, kv_dtype="int8", device=device
    )
    engine8.warmup()
    k2_before = _k2()
    b8 = _decode_only_tps(engine8, batch=8)
    out["int8_kv"] = {
        "batch8_decode_tokens_per_sec": round(b8, 2),
        "mfu_decode_b8": mfu(b8),
        "bw_decode_b8": bandwidth_report(
            b8, 8,
            decode_step_hbm_bytes(param_count(cfg), kv_cache_bytes(cfg, 8, kv_dtype="int8")),
            peak_bw,
        ),
        "kv_bytes_vs_bf16": round(
            kv_cache_bytes(cfg, 8, kv_dtype="int8") / kv_cache_bytes(cfg, 8), 4
        ),
        "k2_launches": _k2() - k2_before,
        "seconds": round(time.perf_counter() - t_lane, 2),
    }
    del engine8
    _free_device(device)

    pcfg = paged_cfg if paged_cfg is not None else cfg
    pparams = paged_params if paged_params is not None else params
    pbuckets = paged_buckets if paged_buckets is not None else buckets

    # Queue-bound workload: 4x more requests than the dense engine has
    # slots, mixed prompt and decode lengths.
    dense_slots, bs = 4, 64
    n_req = 4 * dense_slots
    new_tokens = [(24, 48, 72)[i % 3] for i in range(n_req)]
    prompts = [
        f"{BENCH_PROMPT} request {i}" + " ctx" * ((i * 5) % 20) for i in range(n_req)
    ]

    def drive(engine) -> dict[str, float]:
        for p, m in zip(prompts, new_tokens):
            engine.submit(p, max_new_tokens=m, stop_at_eos=False)
        k2_at = _k2()
        t0 = time.perf_counter()
        results = engine.run()
        elapsed = max(time.perf_counter() - t0, 1e-9)
        total = sum(len(v) for v in results.values())
        timings = engine.request_timings().values()
        queue = [t["queue_delay_s"] * 1e3 for t in timings]
        e2e = [t["e2e_s"] * 1e3 for t in timings if "e2e_s" in t]
        return {
            "tokens_per_sec": total / elapsed,
            "queue_delay_p50_ms": _percentile(queue, 0.50),
            "queue_delay_p95_ms": _percentile(queue, 0.95),
            "e2e_p95_ms": _percentile(e2e, 0.95),
            "k2_launches": _k2() - k2_at,
        }

    t_lane = time.perf_counter()
    out["batch_curve"] = _additive_lane(lambda: _batch_saturation_lane(pcfg, pparams, device))
    out["batch_curve"]["seconds"] = round(time.perf_counter() - t_lane, 2)
    t_lane = time.perf_counter()

    dense = ContinuousBatchingEngine(
        cfg=pcfg, params=pparams, max_slots=dense_slots, prefill_buckets=pbuckets,
        device=device,
    )
    d = drive(dense)
    dense_bytes = kv_cache_bytes(pcfg, dense_slots)
    del dense
    _free_device(device)

    # Paged pool sized to the DENSE engine's KV reservation, double the
    # slots: same memory, twice the concurrency.
    n_blocks = 1 + dense_slots * (-(-pcfg.max_seq_len // bs))
    paged = PagedBatchingEngine(
        cfg=pcfg, params=pparams, max_slots=2 * dense_slots, n_blocks=n_blocks,
        block_size=bs, prefill_buckets=pbuckets, pallas_attention=k2, device=device,
    )
    p = drive(paged)
    out["paged"] = {
        "model_n_params": param_count(pcfg),
        "model_dtype": str(pcfg.dtype).replace("torch.", ""),
        "dense_slots": dense_slots,
        "paged_slots": 2 * dense_slots,
        "n_requests": n_req,
        "new_tokens_mix": sorted(set(new_tokens)),
        "kv_hbm_bytes": dense_bytes,
        "paged_pool_bytes": paged_pool_bytes(pcfg, n_blocks, bs),
        "dense_tokens_per_sec": round(d["tokens_per_sec"], 2),
        "paged_tokens_per_sec": round(p["tokens_per_sec"], 2),
        "throughput_ratio": round(p["tokens_per_sec"] / max(d["tokens_per_sec"], 1e-9), 2),
        "dense_queue_delay_p50_ms": round(d["queue_delay_p50_ms"], 1),
        "dense_queue_delay_p95_ms": round(d["queue_delay_p95_ms"], 1),
        "paged_queue_delay_p50_ms": round(p["queue_delay_p50_ms"], 1),
        "paged_queue_delay_p95_ms": round(p["queue_delay_p95_ms"], 1),
        "queue_delay_p95_ratio": round(
            d["queue_delay_p95_ms"] / max(p["queue_delay_p95_ms"], 1e-9), 2
        ),
        "dense_e2e_p95_ms": round(d["e2e_p95_ms"], 1),
        "paged_e2e_p95_ms": round(p["e2e_p95_ms"], 1),
        "dense_k2_launches": d["k2_launches"],
        "k2_launches": p["k2_launches"],
        "seconds": round(time.perf_counter() - t_lane, 2),
    }
    del paged
    _free_device(device)

    # Shared-prefix blocks: every request names the same long system
    # prompt; sharing its full blocks read-only multiplies the pool's
    # effective concurrency.
    t_lane = time.perf_counter()
    out["shared_prefix"] = _additive_lane(
        lambda: _shared_prefix_lane(pcfg, pparams, pbuckets, device)
    )
    out["shared_prefix"]["seconds"] = round(time.perf_counter() - t_lane, 2)
    return out


def _shared_prefix_lane(cfg, params, buckets, device: torch.device) -> dict[str, Any]:
    """Paged serving with vs without shared prefix blocks, equal pool.

    Geometry: a 256-id prefix spans 4 full blocks of 64; each request
    adds ~1 private block (suffix + decode budget).  A 12-block pool
    therefore fits 2 unshared requests (5 blocks each) but all 8 slots
    once the 4 prefix blocks are shared: concurrency 2 vs 8 at equal KV
    memory.  On a card both engines read the pool through K2.
    """
    from tpuslo_torch.models.paged_kv import PagedBatchingEngine

    prefix = ("tpu serving system preamble. " * 10)[:255]  # BOS + 255 = 256 ids
    n_req, bs, slots = 8, 64, 8
    n_blocks = 1 + 12
    new_tokens = [(16, 32)[i % 2] for i in range(n_req)]
    suffixes = [f"user request {i}" for i in range(n_req)]
    k2 = device.type == "cuda"

    def engine_for(share: bool):
        return PagedBatchingEngine(
            cfg=cfg, params=params, max_slots=slots, n_blocks=n_blocks, block_size=bs,
            prefill_buckets=buckets, share_prefixes=share, pallas_attention=k2,
            device=device,
        )

    def drive(share: bool) -> dict[str, float]:
        engine = engine_for(share)
        for s, m in zip(suffixes, new_tokens):
            engine.submit(s, max_new_tokens=m, stop_at_eos=False, prefix=prefix)
        k2_at = _k2()
        t0 = time.perf_counter()
        results = engine.run()
        elapsed = max(time.perf_counter() - t0, 1e-9)
        total = sum(len(v) for v in results.values())
        queue = [t["queue_delay_s"] * 1e3 for t in engine.request_timings().values()]
        stats = engine.stats()
        return {
            "tokens_per_sec": total / elapsed,
            "queue_delay_p95_ms": _percentile(queue, 0.95),
            "prefix_reuse_hits": stats["prefix_reuse_hits"],
            "shared_prefix_blocks": stats["shared_prefix_blocks"],
            "k2_launches": _k2() - k2_at,
        }

    # A throwaway short run first, so that neither timed drive pays the
    # first use of the lane's shapes alone.
    warm = engine_for(False)
    warm.submit(suffixes[0], max_new_tokens=2, stop_at_eos=False, prefix=prefix)
    warm.run()
    del warm

    unshared = drive(share=False)
    shared = drive(share=True)
    return {
        "prefix_ids": 256,
        "n_requests": n_req,
        "pool_blocks": n_blocks - 1,
        "block_size": bs,
        "unshared_tokens_per_sec": round(unshared["tokens_per_sec"], 2),
        "shared_tokens_per_sec": round(shared["tokens_per_sec"], 2),
        "throughput_ratio": round(
            shared["tokens_per_sec"] / max(unshared["tokens_per_sec"], 1e-9), 2
        ),
        "unshared_queue_delay_p95_ms": round(unshared["queue_delay_p95_ms"], 1),
        "shared_queue_delay_p95_ms": round(shared["queue_delay_p95_ms"], 1),
        "queue_delay_p95_ratio": round(
            unshared["queue_delay_p95_ms"] / max(shared["queue_delay_p95_ms"], 1e-9), 2
        ),
        "prefix_reuse_hits": shared["prefix_reuse_hits"],
        "shared_prefix_blocks": shared["shared_prefix_blocks"],
        "k2_launches": unshared["k2_launches"] + shared["k2_launches"],
    }


def _signal_ref_from_probe(event: dict[str, Any]):
    """Flatten a probe event's nested ``tpu`` block for the matcher."""
    from tpuslo_torch.correlation.matcher import SignalRef
    from tpuslo_torch.schema import rfc3339

    tpu = event.get("tpu") or {}
    return SignalRef.from_dict(
        {
            "signal": event.get("signal", ""),
            "timestamp": rfc3339(
                datetime.fromtimestamp(event.get("ts_unix_nano", 0) / 1e9, tz=timezone.utc)
            ),
            "node": event.get("node", ""),
            "pod": event.get("pod", ""),
            "pid": event.get("pid", 0),
            "value": event.get("value", 0.0),
            "slice_id": tpu.get("slice_id", ""),
            "host_index": tpu.get("host_index", -1),
            "program_id": tpu.get("program_id", ""),
            "launch_id": tpu.get("launch_id", -1),
        }
    )


def _xla_launch_join(engine, prompt: str, node: str) -> dict[str, Any]:
    """Capture a serve with the profiler and join its dispatches to their
    device-time signals through the ``xla_launch`` matcher tier."""
    from tpuslo_torch.correlation.matcher import TIER_XLA_LAUNCH, SpanRef, match
    from tpuslo_torch.deviceplane.ledger import build_ledger, dispatch_count
    from tpuslo_torch.otel import xla_spans

    with tempfile.TemporaryDirectory() as td:
        with xla_spans.capture(td, include_ops=True) as cap:
            list(engine.generate(prompt, max_new_tokens=32, stop_at_eos=False))
        launches = list(cap.launches())
        spans = cap.spans
        if cap.module_source == "cpu_annotation":
            # On the CPU, PyTorch runs each operator as it is called: a
            # dispatch range's extent is its execution, and stands in for
            # the ops lane that a card's kernels fill.
            spans = sorted(
                spans + [dataclasses.replace(s, lane=xla_spans.OPS_LANE,
                                             hlo_category="cpu_op", args={})
                         for s in launches],
                key=lambda s: s.start_us,
            )
        out: dict[str, Any] = {
            "xprof_launch_spans": len(launches),
            "xprof_programs": len({s.program_id for s in launches}),
            "capture_module_source": cap.module_source,
        }
        if not launches:
            return out
        # One span per launch, as the JAX capture has: a card's trace cuts
        # each dispatch into one module span per run of its kernels, all
        # with the dispatch's identity.
        firsts: dict[tuple[str, int], dict] = {}
        for ref in cap.span_refs(service="serving-bench", node=node):
            firsts.setdefault((ref["program_id"], ref["launch_id"]), ref)
        span_refs = [SpanRef.from_dict(r) for r in firsts.values()]
        signals = [
            _signal_ref_from_probe(e)
            for e in xla_spans.extract_device_time_signals(
                spans, cap.anchor_unix_ns, node=node
            )
        ]
        out["device_time_signals"] = len(signals)
        # Matcher proof: the xla_launch tier joins these streams on
        # identity (the RATES below come from the ledger, the one source).
        by_identity = {(s.program_id, s.launch_id): s for s in signals}
        matched = 0
        for span in span_refs:
            signal = by_identity.get((span.program_id, span.launch_id))
            if signal is None:
                continue
            decision = match(span, signal)
            if decision.matched and decision.tier == TIER_XLA_LAUNCH:
                matched += 1
        out["xla_launch_matches"] = matched

        # ONE source for every join-rate number: the device-plane ledger.
        # The raw rate is reported only; the substantive (tiered) rate is
        # the one a gate reads.
        ledger = build_ledger(spans)
        out["xprof_dispatches"] = dispatch_count(ledger)
        out["xla_launch_join_rate"] = round(ledger.raw_join_rate, 4)
        out["xla_launch_join_rate_substantive"] = round(ledger.substantive_join_rate, 4)
        breakdown = xla_spans.launch_match_breakdown(spans, ledger=ledger)
        out["xla_launch_join_rate_exact_substantive"] = breakdown["substantive_join_rate"]
        out["xla_launch_unmatched"] = {
            "count": breakdown["unmatched_count"],
            "reasons": breakdown["reasons"],
            "examples": breakdown["unmatched"][:6],
        }
        out["device_ledger"] = {
            "buckets_ms": ledger.to_dict()["buckets_ms"],
            "unexplained_share": round(ledger.unexplained_share, 4),
            "tier_counts": dict(ledger.tier_counts),
        }
        return out


def _deviceplane_lane(seed: int = 1337) -> dict[str, Any]:
    """Seeded synthetic-capture device-plane lane (device-independent).

    Synthesizes a capture with every join pathology the real captures
    showed (lane splits, anonymous warmups, helpers, idle gaps), parses
    it through the real trace path and publishes the ledger numbers the
    bars hold: substantive join rate >= 0.9, bucket sum == total device
    time, unexplained share <= 0.1.
    """
    from tpuslo_torch.deviceplane.ledger import build_ledger
    from tpuslo_torch.deviceplane.synthetic import synthesize_xprof_trace
    from tpuslo_torch.otel import xla_spans

    doc, compiles, truth = synthesize_xprof_trace(seed=seed)
    spans = xla_spans.parse_trace_events(doc, include_ops=True)
    ledger = build_ledger(spans, compiles)
    summary = ledger.to_dict(example_cap=4)
    summary["seed"] = seed
    summary["truth_steps"] = truth["steps"]
    summary["bucket_sum_matches_total"] = (
        abs(ledger.bucket_sum_us - ledger.total_us) <= 1e-6 * max(ledger.total_us, 1.0)
    )
    return summary


def _profiler_lane(
    seed: int = 1337, cycles: int = 8, roofs: tuple[float, float] | None = None
) -> dict[str, Any]:
    """Seeded continuous-profiler lane (device-independent).

    Ticks a stride-1 profiler over the seeded synthetic capture stream
    and publishes the bars: the measured capture overhead EMA (<= 3% of
    the cycle budget) and the per-window substantive join rate (>= 0.9),
    with the raw exact-identity rate beside it off the same ledger.
    ``roofs`` (HBM bytes/s, bf16 FLOP/s) size the seeded cost model: the
    card's row, the H100's where none is given.
    """
    from tpuslo_torch.deviceplane.profiler import ContinuousProfiler, seeded_cost_model

    peak_bw, peak_flops = roofs or (H100_PEAK_HBM_BW, H100_PEAK_BF16_FLOPS)
    step_bytes, step_flops, step_dur = seeded_cost_model(peak_bw=peak_bw)
    prof = ContinuousProfiler(
        source="synthetic",
        seed=seed,
        stride_cycles=1,
        window_steps=8,
        history=cycles,
        bytes_per_step=step_bytes,
        flops_per_step=step_flops,
        step_dur_us=step_dur,
        node="bench-host",
        peak_bw=peak_bw,
        peak_flops=peak_flops,
    )
    windows = [w for _ in range(cycles) if (w := prof.tick()) is not None]
    return {
        "seed": seed,
        "windows": len(windows),
        "overhead_ema_pct": round(prof.overhead_ema_pct, 4),
        "overhead_budget_pct": prof.overhead_budget_pct,
        "mean_capture_cost_ms": round(
            sum(w.capture_cost_ms for w in windows) / max(len(windows), 1), 3
        ),
        "min_substantive_join_rate": round(
            min((w.substantive_join_rate for w in windows), default=0.0), 4
        ),
        "mean_raw_join_rate": round(
            sum(w.raw_join_rate for w in windows) / max(len(windows), 1), 4
        ),
        "degradations": prof.degradations,
        "mean_idle_gap_ms": round(
            sum(w.idle_gap_ms for w in windows) / max(len(windows), 1), 3
        ),
    }


def _resolve(platform: str) -> torch.device:
    """``cpu`` serves on the CPU; ``auto`` on the CUDA device, and raises
    without one (a measurement never falls back to the CPU)."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "serving_bench: no CUDA device (--platform auto serves on the card; "
            "--platform cpu runs the plain path on the CPU)"
        )
    return torch.device("cuda", torch.cuda.current_device())


def run(platform: str = "auto", model: str = "auto",
        layers: int | None = None) -> dict[str, Any]:
    t_bench = time.perf_counter()
    device = _resolve(platform)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    out: dict[str, Any] = {
        "backend": device.type,
        "device_kind": kind,
        "platform": "gpu" if on_card else "cpu",
    }
    launches_at_start = kernel_launches()
    seconds: dict[str, float] = {}

    def lane(name: str, fn):
        """An additive lane, its wall seconds kept in ``lane_seconds``."""
        t_lane = time.perf_counter()
        try:
            return _additive_lane(fn)
        finally:
            seconds[name] = round(time.perf_counter() - t_lane, 2)

    bytes_limit: float | None = None
    if on_card:
        bytes_limit = float(torch.cuda.mem_get_info(device)[1])
        out["hbm_bytes_limit"] = int(bytes_limit)
    peak_flops = _lookup(PEAK_BF16_FLOPS, kind) if on_card else None
    if peak_flops:
        out["peak_bf16_flops"] = peak_flops
    peak_bw = _lookup(PEAK_HBM_BW, kind) if on_card else None
    if peak_bw:
        out["peak_hbm_bytes_per_sec"] = peak_bw

    if model == "auto":
        model = _pick_model(bytes_limit) if on_card else "llama_tiny"
    out["model"] = model
    cfg = _make_config(model, layers)
    out["n_layers"] = cfg.n_layers

    from tpuslo_torch.models.llama import init_kv_cache, init_params, kv_cache_bytes
    from tpuslo_torch.models.llama import param_count, prefill
    from tpuslo_torch.models.serve import ServeEngine
    from tpuslo_torch.ops.flash_attention import flash_eligible

    n_params = param_count(cfg)
    out["n_params"] = n_params
    flops_per_token = 2.0 * n_params
    out["flash_attention"] = flash_eligible((8, 256, cfg.n_heads, cfg.head_dim), cfg.n_kv_heads)

    t0 = time.perf_counter()
    params = init_params(0, cfg, device)
    synchronize(device)
    out["init_params_s"] = round(time.perf_counter() - t0, 2)

    # A 512 bucket on the card lets prefill MFU be measured at a shape
    # that fills the tensor cores better and gives the prefix-cache lane a
    # prefix long enough to dominate TTFT.
    buckets = (32, 64, 128, 256, 512) if on_card else (32, 64, 128, 256)
    buckets = tuple(b for b in buckets if b <= cfg.max_seq_len)
    engine = ServeEngine(cfg=cfg, params=params, prefill_buckets=buckets, device=device)
    out["warmup_compile_ms"] = round(engine.warmup(), 1)

    def mfu(tokens_per_sec: float) -> float | None:
        if not peak_flops:
            return None
        return round(tokens_per_sec * flops_per_token / peak_flops, 5)

    # --- batch-1 latency path ------------------------------------------
    prompt = BENCH_PROMPT
    ttft_ms, b1_tps = _b1_latency(engine)
    out["ttft_ms"] = round(ttft_ms, 2)
    out["decode_tokens_per_sec"] = round(b1_tps, 2)
    out["mfu_decode_b1"] = mfu(b1_tps)
    out["bw_decode_b1"] = bandwidth_report(
        b1_tps, 1, decode_step_hbm_bytes(n_params, kv_cache_bytes(cfg, 1)), peak_bw
    )

    # --- prefix caching: TTFT with a cached shared prefix --------------
    out["prefix_cache"] = lane("prefix_cache", lambda: _prefix_lane(engine))

    # --- long-prompt ingestion (chunked prefill to full KV capacity) ---
    out["long_prompt"] = lane("long_prompt", lambda: _long_prompt_lane(engine))

    # --- batch-8 throughput path ---------------------------------------
    prompts = [f"{prompt} #{i}" for i in range(8)]
    engine.generate_batch(prompts, max_new_tokens=8, stop_at_eos=False)
    n_b8 = 64
    t0 = time.perf_counter()
    rows = engine.generate_batch(prompts, max_new_tokens=n_b8, stop_at_eos=False)
    batch_elapsed = max(time.perf_counter() - t0, 1e-9)
    b8_tps = sum(len(r) for r in rows) / batch_elapsed
    out["batch8_aggregate_tokens_per_sec"] = round(b8_tps, 2)
    # The aggregate above includes prefill and host-side stream
    # unpacking (the end-to-end number); this one is pure decode.
    b8_decode = _decode_only_tps(engine, batch=8)
    out["batch8_decode_tokens_per_sec"] = round(b8_decode, 2)
    out["mfu_decode_b8"] = mfu(b8_decode)
    out["bw_decode_b8"] = bandwidth_report(
        b8_decode, 8, decode_step_hbm_bytes(n_params, kv_cache_bytes(cfg, 8)), peak_bw
    )

    # --- prefill throughput (compute-bound: the MFU of the tensor cores) -
    bucket = engine.prefill_buckets[-1]
    tokens = torch.zeros((8, bucket), dtype=torch.long, device=device)
    k1_before = _k1()
    logits, cache = prefill(params, tokens, init_kv_cache(cfg, 8, device=device), cfg)
    synchronize(device)
    # Time only the prefill computation: each rep needs a fresh cache,
    # but its allocation and zero fill are not prefill work and stay
    # outside the timed window.
    reps = 3
    prefill_elapsed = 0.0
    for _ in range(reps):
        del logits, cache
        cache = init_kv_cache(cfg, 8, device=device)
        synchronize(device)
        t0 = time.perf_counter()
        logits, cache = prefill(params, tokens, cache, cfg)
        synchronize(device)
        prefill_elapsed += time.perf_counter() - t0
    prefill_elapsed = max(prefill_elapsed, 1e-9)
    prefill_tps = reps * 8 * bucket / prefill_elapsed
    out["prefill_bucket"] = bucket
    out["prefill_tokens_per_sec"] = round(prefill_tps, 1)
    out["mfu_prefill"] = mfu(prefill_tps)
    out["prefill_k1_launches"] = _k1() - k1_before
    del logits, cache, tokens
    _free_device(device)

    # --- speculative decoding mechanics ---------------------------------
    out["speculative"] = lane("speculative", lambda: _speculative_lane(cfg, params, device))

    # --- speculative decoding MEASURED on trained weights ---------------
    out["speculative_measured"] = lane(
        "speculative_measured", lambda: _speculative_measured_lane(device=device))

    # --- KV representations: int8 KV + paged pool ----------------------
    paged_kw: dict[str, Any] = {}

    def kv_lane() -> dict[str, Any]:
        if not on_card and not paged_kw:
            # llama_tiny fits in cache -> compute-bound -> batch scaling
            # is linear and the paged comparison measures nothing on the
            # CPU; run it on a weight-bandwidth-bound config there.
            pcfg = _paged_cpu_config()
            paged_kw.update(
                paged_cfg=pcfg, paged_params=init_params(0, pcfg, device),
                paged_buckets=(64,),
            )
        return _bench_kv_lanes(cfg, params, buckets, mfu, device, peak_bw=peak_bw, **paged_kw)

    try:
        out["kv"] = lane("kv", kv_lane)
    finally:
        paged_kw.clear()
        _free_device(device)

    # --- xla_launch tier on a real capture -----------------------------
    joined = lane("xla_launch", lambda: _xla_launch_join(engine, prompt, node=os.uname().nodename))
    if isinstance(joined, dict) and "error" in joined:
        out["xprof_error"] = joined["error"]
    else:
        out.update(joined)

    # --- device-plane ledger on the seeded synthetic lane --------------
    out["deviceplane"] = lane("deviceplane", _deviceplane_lane)

    # --- continuous profiler on the same seeded lane -------------------
    roofs = (peak_bw, peak_flops) if peak_bw and peak_flops else None
    out["profiler"] = lane("profiler", lambda: _profiler_lane(roofs=roofs))

    if on_card:
        out["hbm_bytes_in_use"] = int(torch.cuda.memory_allocated(device))

    # --- MoE + int8 lanes ----------------------------------------------
    if on_card:
        # Drop the bf16 lanes' weights first (7.2 GB on the 3B config):
        # the MoE and int8 lanes build models of their own.
        del engine, params
        _free_device(device)
        out["moe"] = lane("moe", lambda: _bench_moe(peak_flops, peak_bw, device, layers))
        out["int8"] = lane(
            "int8", lambda: _bench_int8(bytes_limit, peak_flops, peak_bw, device, layers)
        )

    now = kernel_launches()
    out["kernel_launches"] = {k: now[k] - launches_at_start[k] for k in now}
    out["lane_seconds"] = seconds
    out["elapsed_s"] = round(time.perf_counter() - t_bench, 1)
    return out


def _bench_moe(peak_flops, peak_bw, device: torch.device,
               layers: int | None = None) -> dict[str, Any]:
    """Measured MoE serving: ``mixtral_2b6`` (drop-free routing) at full
    width and depth in bf16, batch-1 TTFT and decode tokens/s, the second
    model family's datum on the card.

    A decoded token computes through its top-k experts only, so MFU and
    the bytes a step must move count the active (routed) parameters."""
    from tpuslo_torch.models.llama import kv_cache_bytes
    from tpuslo_torch.models.mixtral import (
        MoEServeEngine,
        active_param_count,
        mixtral_2b6,
        param_count,
    )

    cfg = _cut(mixtral_2b6(), layers)
    res: dict[str, Any] = {
        "model": "mixtral_2b6",
        "n_layers": cfg.n_layers,
        "n_params": param_count(cfg),
        "n_params_active": active_param_count(cfg),
        "n_experts": cfg.n_experts,
        "top_k": cfg.top_k,
    }
    k1_at, k2_at = _k1(), _k2()
    t0 = time.perf_counter()
    engine = MoEServeEngine(cfg=cfg, prefill_buckets=(32, 64, 128, 256), device=device)
    try:
        synchronize(device)
        res["init_params_s"] = round(time.perf_counter() - t0, 2)
        res["warmup_compile_ms"] = round(engine.warmup(), 1)
        ttft_ms, b1_tps = _b1_latency(engine, n_tokens=96)
        res["ttft_ms"] = round(ttft_ms, 2)
        res["decode_tokens_per_sec"] = round(b1_tps, 2)
        if peak_flops:
            res["mfu_decode_b1"] = round(b1_tps * 2.0 * res["n_params_active"] / peak_flops, 5)
        # A b1 step streams the attention and shared weights, top_k experts
        # a layer, and the whole KV buffer.
        res["bw_decode_b1"] = bandwidth_report(
            b1_tps, 1,
            decode_step_hbm_bytes(res["n_params_active"], kv_cache_bytes(cfg, 1)),
            peak_bw,
        )
        res["k1_launches"] = _k1() - k1_at
        res["k2_launches"] = _k2() - k2_at
    finally:
        # Free the ~5 GB of MoE weights even when a stage raises: the int8
        # 8B lane that follows needs the card's headroom.
        del engine
        _free_device(device)
    return res


def _bench_int8(bytes_limit, peak_flops, peak_bw, device: torch.device,
                layers: int | None = None) -> dict[str, Any]:
    """int8 weight-only lane: decode reads half the weight bytes, and
    llama3-8b fits the card."""
    from tpuslo_torch.models.llama import kv_cache_bytes, param_count
    from tpuslo_torch.models.serve import ServeEngine

    name = _pick_model(bytes_limit, bytes_per_param=1.0)
    cfg = _make_config(name, layers)
    res: dict[str, Any] = {"model": name, "n_layers": cfg.n_layers,
                           "n_params": param_count(cfg)}
    flops_per_token = 2.0 * param_count(cfg)

    t0 = time.perf_counter()
    engine = ServeEngine(cfg=cfg, quantize=True, device=device)
    synchronize(device)
    res["init_quantized_s"] = round(time.perf_counter() - t0, 2)
    _free_device(device)  # the bf16 weights the quantization read
    res["warmup_compile_ms"] = round(engine.warmup(), 1)

    ttft_ms, b1_tps = _b1_latency(engine)
    res["ttft_ms"] = round(ttft_ms, 2)
    res["decode_tokens_per_sec"] = round(b1_tps, 2)

    b8_decode = _decode_only_tps(engine, batch=8)
    res["batch8_decode_tokens_per_sec"] = round(b8_decode, 2)
    if peak_flops:
        res["mfu_decode_b1"] = round(b1_tps * flops_per_token / peak_flops, 5)
        res["mfu_decode_b8"] = round(b8_decode * flops_per_token / peak_flops, 5)
    # int8 weights: 1 byte/param is the 2x decode-bandwidth lever.
    res["bw_decode_b1"] = bandwidth_report(
        b1_tps, 1,
        decode_step_hbm_bytes(param_count(cfg), kv_cache_bytes(cfg, 1), param_bytes=1.0),
        peak_bw,
    )
    res["bw_decode_b8"] = bandwidth_report(
        b8_decode, 8,
        decode_step_hbm_bytes(param_count(cfg), kv_cache_bytes(cfg, 8), param_bytes=1.0),
        peak_bw,
    )
    if device.type == "cuda":
        res["hbm_bytes_in_use"] = int(torch.cuda.memory_allocated(device))
    del engine
    _free_device(device)
    return res


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpuslo_torch.benchmark.serving_bench",
                                     description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--platform", choices=("auto", "cpu"), default="auto")
    parser.add_argument(
        "--model",
        choices=("auto", "llama3_8b", "llama32_3b", "llama32_1b", "llama_tiny"),
        default="auto",
    )
    parser.add_argument("--layers", type=int, default=None,
                        help="cut every model to at most this many layers (widths stay)")
    args = parser.parse_args(argv)
    if args.layers is not None and args.layers < 1:
        parser.error("--layers must be at least 1")
    try:
        result = run(platform=args.platform, model=args.model, layers=args.layers)
    except RuntimeError as exc:
        if torch.cuda.is_available() or args.platform == "cpu":
            raise
        print(str(exc), file=sys.stderr)
        return 2
    print("SERVING_BENCH:" + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
